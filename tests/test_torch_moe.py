"""The port's Mixture-of-Experts FFN (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` on the same NumPy inputs.

Params are the reference's ``moe_init`` at the smoke widths of qwen2-moe
(8 routed experts + 4 padded ones masked out of routing, 2 shared experts,
top-2) and olmoe (8 experts, top-2, no shared experts), at S = 1 (a decode
token) and S = 64 (a prefill). The routing tables (``idx_table``,
``slot_of``) must be equal, element for element: the top-k order on ties,
the stable expert-id sort and the capacity cut are integer decisions.
Output, aux loss, the router weights and the gradients are held at 1e-5 in
float32 (the same math in another order); bf16 compute on equal bf16
inputs at 2e-2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCHS = ["qwen2-moe-a2.7b", "olmoe-1b-7b"]
B, TOL = 2, 1e-5


def _setup(arch, S, seed=0, zero_x=False):
    cfg = jsmoke(jget_config(arch))
    p = jax.tree.map(np.asarray, jmoe.moe_init(
        jax.random.PRNGKey(seed), cfg.d_model, cfg.num_experts, cfg.moe_d_ff,
        cfg.num_shared_experts, jnp.float32, expert_pad=cfg.expert_pad))
    x = np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    if zero_x:
        x[:] = 0.0
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    return cfg, p, x, tp


def _capacity(cfg, S, cf):
    return max(1, int(cf * cfg.top_k * S / cfg.num_experts + 0.5))


def _logits(cfg, p, x):
    lg = x @ p["router"]
    E = p["router"].shape[1]
    return np.where(np.arange(E) >= cfg.num_experts, np.float32(-1e30),
                    lg).astype(np.float32)


def _apply_both(cfg, p, x, tp, cf, norm_topk):
    kw = dict(top_k=cfg.top_k, capacity_factor=cf,
              num_real_experts=cfg.num_experts, norm_topk=norm_topk)
    jo, ja = jmoe.moe_apply(p, jnp.asarray(x), dtype=jnp.float32, **kw)
    to, ta = moe.moe_apply(tp, torch.from_numpy(x), dtype=torch.float32, **kw)
    return (jo, ja), (to, ta)


@pytest.mark.parametrize("S", [1, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_tables_output_and_aux_match_reference(arch, S):
    cfg, p, x, tp = _setup(arch, S)
    if arch.startswith("qwen2"):
        assert (cfg.expert_pad, cfg.num_shared_experts) == (4, 2)
        assert p["router"].shape[1] == cfg.num_experts + 4
        assert "shared_gate" in tp
    C = _capacity(cfg, S, cfg.capacity_factor)
    lg = _logits(cfg, p, x)
    jt = jmoe._route(jnp.asarray(lg), cfg.top_k, C)
    tt = moe._route(torch.from_numpy(lg), cfg.top_k, C)
    for name, a, b in zip(("idx_table", "slot_of"), jt[:2], tt[:2]):
        assert b.dtype == torch.int32, name
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    for a, b in zip(jt[2:], tt[2:]):          # router weights, probs
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=TOL, atol=TOL)
    # No padded expert is ever chosen or fed.
    E = p["router"].shape[1]
    slot_of = tt[1].numpy()
    chosen = slot_of[slot_of < E * C] // C
    assert (chosen < cfg.num_experts).all()
    (jo, ja), (to, ta) = _apply_both(cfg, p, x, tp, cfg.capacity_factor, False)
    assert to.shape == (B, S, cfg.d_model) and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_follow_the_reference(arch):
    # capacity_factor 0.5 at S = 64: 8 slots an expert for 128 choices a
    # row, so many choices are dropped; earlier tokens must win the slots
    # and the dropped choices give zeros, as in the reference.
    cfg, p, x, tp = _setup(arch, 64, seed=1)
    C = _capacity(cfg, 64, 0.5)
    lg = _logits(cfg, p, x)
    jt = jmoe._route(jnp.asarray(lg), cfg.top_k, C)
    tt = moe._route(torch.from_numpy(lg), cfg.top_k, C)
    E = p["router"].shape[1]
    dropped = int((np.asarray(jt[1]) == E * C).sum())
    assert dropped > 0
    for a, b in zip(jt[:2], tt[:2]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    (jo, ja), (to, ta) = _apply_both(cfg, p, x, tp, 0.5, False)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_norm_topk_matches_reference(arch):
    cfg, p, x, tp = _setup(arch, 64, seed=2)
    (jo, ja), (to, ta) = _apply_both(cfg, p, x, tp, cfg.capacity_factor, True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_ties_break_to_the_lower_expert_as_the_reference(arch):
    # x = 0 gives equal logits for every real expert: top-k must take the
    # lowest expert ids in order (jax.lax.top_k), and every token then
    # queues on the same experts, so capacity drops the later tokens.
    cfg, p, x, tp = _setup(arch, 64, zero_x=True)
    C = _capacity(cfg, 64, cfg.capacity_factor)
    lg = _logits(cfg, p, x)
    jt = jmoe._route(jnp.asarray(lg), cfg.top_k, C)
    tt = moe._route(torch.from_numpy(lg), cfg.top_k, C)
    for a, b in zip(jt[:2], tt[:2]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    E = p["router"].shape[1]
    kept = tt[1].numpy()[0, 0]
    assert (kept // C).tolist() == list(range(cfg.top_k))
    assert (tt[1].numpy()[:, C:] == E * C).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_reference(arch):
    cfg, p, x, tp = _setup(arch, 64, seed=3)
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
              num_real_experts=cfg.num_experts)
    w = np.random.default_rng(4).standard_normal(
        (B, 64, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        o, a = jmoe.moe_apply(p, x, dtype=jnp.float32, **kw)
        return jnp.sum(o * w) + a

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    tx = torch.from_numpy(x.copy()).requires_grad_()
    for t in tp.values():
        t.requires_grad_()
    o, a = moe.moe_apply(tp, tx, dtype=torch.float32, **kw)
    ((o * torch.from_numpy(w)).sum() + a).backward()
    for k, t in tp.items():
        ref = np.asarray(jg[k])
        np.testing.assert_allclose(t.grad.numpy(), ref, rtol=0,
                                   atol=TOL * np.abs(ref).max(), err_msg=k)
    ref = np.asarray(jgx)
    np.testing.assert_allclose(tx.grad.numpy(), ref, rtol=0,
                               atol=TOL * np.abs(ref).max())


def test_moe_init_has_reference_shapes():
    cfg = jsmoke(jget_config("qwen2-moe-a2.7b"))
    gen = torch.Generator().manual_seed(0)
    own = moe.moe_init(gen, cfg.d_model, cfg.num_experts, cfg.moe_d_ff,
                       cfg.num_shared_experts, torch.float32, "cpu",
                       expert_pad=cfg.expert_pad)
    ref = jmoe.moe_init(jax.random.PRNGKey(0), cfg.d_model, cfg.num_experts,
                        cfg.moe_d_ff, cfg.num_shared_experts, jnp.float32,
                        expert_pad=cfg.expert_pad)
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    # fan-in scaling, as the reference's fan_in_init
    assert abs(float(own["down"].std()) - cfg.moe_d_ff ** -0.5) < 0.02


@pytest.mark.parametrize("S", [1, 64])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_compute_matches_reference_on_equal_inputs(arch, S):
    # The served path: bf16 activations, fp32 params cast at use. Given the
    # same bf16 input, both route on the same fp32 logits, so the tables
    # are equal; the output is held at the bf16 tolerance 2e-2 of
    # tests/test_kernels.py, the aux loss (fp32) at 1e-5.
    cfg, p, x, tp = _setup(arch, S, seed=5)
    xb = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16()
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
              num_real_experts=cfg.num_experts)
    jo, ja = jmoe.moe_apply(p, xb, dtype=jnp.bfloat16, **kw)
    to, ta = moe.moe_apply(tp, tx, dtype=torch.bfloat16, **kw)
    assert to.dtype == torch.bfloat16 and to.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(ta), float(ja), rtol=TOL, atol=TOL)
