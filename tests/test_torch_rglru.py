"""The port's recurrentgemma slice against the reference, on the same inputs.

* ``ops.rglru_scan`` on CPU tensors (the plain loop of ``kernels/ref.py``)
  against the reference's ``rglru_scan_pallas`` in interpret mode and its
  ``lru_scan_ref`` on the three sweep cases of ``tests/test_kernels.py`` at
  that sweep's 1e-5, on a ragged case the Pallas kernel cannot take (oracle
  only), and as a decode step (S = 1 from ``h0``).
* GeGLU (``mlp_apply``, act ``gelu_glu``) at 1e-6 in float32: the tanh
  GeLU of ``jax.nn.gelu``.
* ``smoke_config(recurrentgemma-2b)`` (8 layers: 2 blocks of RG-LRU,
  RG-LRU, local attention with window 16, then 2 RG-LRU) with the
  reference's params converted: prefill logits and loss (float32 1e-5: the
  same math in another order; bfloat16 2e-2: rounding at other places), 40
  decode steps that wrap every local ring with the logits and every layer's
  state after each step, a wrapped reference state converted and decoded
  on, decode against the port's own forward (teacher forcing past the
  window), one train step, greedy serving tokens (float32, equal), both
  drivers on the CPU, the config and the converter.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serve as jserve  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.data.tokenfile import read_meta, write_token_file  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.rglru_scan import rglru_scan_pallas  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.layers import mlp_apply as jmlp_apply  # noqa: E402
from repro.models.layers import mlp_init as jmlp_init  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import init_opt_state as jinit_opt  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs.base import ATTN_LOCAL, RGLRU  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.rglru_scan import FORWARD_ONLY  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    decode_state_from_reference,
    from_reference,
    to_reference,
)
from repro_torch.models.layers import mlp_apply  # noqa: E402
from repro_torch.models.rglru import RGLRUState  # noqa: E402
from repro_torch.train import OptConfig, init_opt_state, make_train_step  # noqa: E402

ARCH = "recurrentgemma-2b"
SWEEP = [  # (B, S, W, chunk, block_w) of tests/test_kernels.py
    (1, 32, 16, 8, 8),
    (2, 64, 64, 16, 32),
    (1, 256, 32, 64, 32),
]
B, STEPS, BUDGET = 2, 40, 48        # 40 decode steps wrap the 16-slot rings


def _scan_inputs(B, S, W, seed=0):
    rng = np.random.default_rng(seed)
    a = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, W))))
    b = rng.standard_normal((B, S, W)) * 0.1
    h0 = rng.standard_normal((B, W)) * 0.5
    return [x.astype(np.float32) for x in (a, b, h0)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("B_,S,W,chunk,block_w", SWEEP)
def test_lru_scan_matches_pallas_interpret_and_oracle(B_, S, W, chunk, block_w):
    a, b, h0 = _scan_inputs(B_, S, W, seed=S + W)
    got = ops.rglru_scan(*_t(a, b))
    assert got.shape == (B_, S, W) and got.dtype == torch.float32
    pallas = rglru_scan_pallas(jnp.asarray(a), jnp.asarray(b), chunk=chunk,
                               block_w=block_w, interpret=True)
    _close(got, pallas, 1e-5)
    _close(got, jref.lru_scan_ref(jnp.asarray(a), jnp.asarray(b)), 1e-5)
    got = ops.rglru_scan(*_t(a, b), h0=torch.from_numpy(h0))
    _close(got, jref.lru_scan_ref(*map(jnp.asarray, (a, b, h0))), 1e-5)


@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_ragged_shape_matches_oracle(with_h0):
    # S % chunk and W % block_w are not 0: the Pallas kernel refuses this
    # shape, so the reference's oracle is the only yardstick.
    a, b, h0 = _scan_inputs(3, 37, 50, seed=7)
    h0_t = torch.from_numpy(h0) if with_h0 else None
    got = ops.rglru_scan(*_t(a, b), h0=h0_t)
    want = jref.lru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(h0) if with_h0 else None)
    assert got.shape == (3, 37, 50)
    _close(got, want, 1e-5)


def test_lru_scan_is_a_decode_step_with_s1():
    a, b, h0 = _scan_inputs(2, 5, 8, seed=3)
    one = ops.rglru_scan(*_t(a[:, :1], b[:, :1]), h0=torch.from_numpy(h0))
    assert one.shape == (2, 1, 8)
    assert torch.equal(one[:, 0], torch.from_numpy(a[:, 0] * h0 + b[:, 0]))
    h = torch.from_numpy(h0)
    steps = []
    for t in range(5):
        h = ops.rglru_scan(*_t(a[:, t:t + 1], b[:, t:t + 1]), h0=h)[:, 0]
        steps.append(h)
    whole = ops.rglru_scan(*_t(a, b), h0=torch.from_numpy(h0))
    assert torch.equal(torch.stack(steps, 1), whole)


def test_gelu_glu_mlp_matches_reference():
    rng = np.random.default_rng(11)
    jp = jax.tree.map(np.asarray, jmlp_init(jax.random.PRNGKey(3), 32, 96,
                                            "gelu_glu", jnp.float32))
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    want = jmlp_apply(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                      "gelu_glu", jnp.float32)
    tp = {k: torch.tensor(v) for k, v in jp.items()}
    got = mlp_apply(tp, torch.from_numpy(x), "gelu_glu", torch.float32)
    _close(got, want, 1e-6)


# -- model ---------------------------------------------------------------------
def _cfgs(**kw):
    return (jsmoke(jget_config(ARCH)).replace(**kw),
            smoke_config(get_config(ARCH)).replace(**kw))


@pytest.fixture(scope="module")
def ref_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(
        np.int32)


def test_config_and_param_counts_match_reference():
    for jcfg, tcfg in ((jget_config(ARCH), get_config(ARCH)), _cfgs()):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert tcfg.param_counts() == jcfg.param_counts()
    assert get_config(ARCH).param_counts()["total"] == 2_894_479_360
    _, tcfg = _cfgs()
    assert tcfg.num_layers == 8 and tcfg.block_pattern[2].window == 16
    assert [s.mixer for s in tcfg.layer_schedule()].count(ATTN_LOCAL) == 2


def test_converter_round_trips_exactly(ref_params):
    _, tcfg = _cfgs()
    tp = from_reference(ref_params, tcfg, device="cpu")
    assert len(tp["layers"]) == tcfg.num_layers and "lm_head" not in tp
    assert set(tp["layers"][0]["mixer"]) == {
        "wx", "wy", "conv_w", "conv_b", "w_r", "w_i", "b_r", "b_i", "lam",
        "wo"}
    back = to_reference(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(ref_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # The port's own init has the reference's shapes and dtypes, and the
    # same deterministic Lambda (to 3e-6 relative: torch's and JAX's
    # linspace, log and expm1 round differently, and log(expm1(x)) of a
    # small x magnifies that).
    own = to_reference(build_model(tcfg).init(0, device="cpu"), tcfg)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(ref_params)):
        assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_allclose(own["tail"][0]["mixer"]["lam"],
                               ref_params["tail"][0]["mixer"]["lam"],
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_prefill_logits_and_loss_match_reference(ref_params, dtype, tol):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = from_reference(ref_params, tcfg, device="cpu")
    # 40 tokens: past the window of 16, so the local mask bites.
    toks, labels = _tokens((B, 40), 1), _tokens((B, 40), 2)
    jl = jm.prefill_logits(ref_params, {"tokens": jnp.asarray(toks)})
    tl = tm.prefill_logits(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (B, 1, 256) and tl.dtype == getattr(torch, dtype)
    _close(tl, jl, tol)
    jloss = jm.loss(ref_params, {"tokens": jnp.asarray(toks),
                                 "labels": jnp.asarray(labels)})[0]
    with torch.no_grad():
        tloss = tm.loss(tp, {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labels)})[0]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol, atol=tol)


def _ref_states(state, cfg):
    """The reference's per-layer states unstacked into schedule order, as
    dicts of NumPy arrays."""
    pattern, nb, _ = cfg.scan_split()

    def grab(st, bi):
        return {k: (np.asarray(v) if bi is None else np.asarray(v)[bi])
                for k, v in st._asdict().items()}

    out = [grab(state.blocks[i], bi) for bi in range(nb)
           for i in range(len(pattern))]
    return out + [grab(s, None) for s in state.tail]


def _layer_tensors(ts, js, jcfg, tcfg):
    """(name, port tensor, reference array) for every layer state."""
    want = _ref_states(js, jcfg)
    assert len(ts.layers) == len(want) == tcfg.num_layers
    out = []
    for i, (st, spec, w) in enumerate(zip(ts.layers, tcfg.layer_schedule(),
                                          want)):
        if spec.mixer == RGLRU:
            assert isinstance(st, RGLRUState) and st.h.dtype == torch.float32
        else:
            assert isinstance(st, KVCache)
            assert st.k.shape[1] == w["k"].shape[1] == 16
        out += [(f"layer {i} {name}", t, w[name])
                for name, t in st._asdict().items()]
    return out


def _decode_run(ref_params, dtype, tcfg=None):
    """The reference's decode for STEPS tokens: (logits, states) per step."""
    jcfg, _ = _cfgs(dtype=dtype)
    jm = jbuild(jcfg)
    decode = jax.jit(jm.decode)
    js = jm.init_decode_state(ref_params, B, BUDGET)
    toks = _tokens((B, STEPS))
    for t in range(STEPS):
        jl, js = decode(ref_params, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        yield toks[:, t:t + 1], jl, js


# bfloat16 decode through 40 steps of this random-weight model: the
# reference's own bf16 logits and states stray up to 8.3e-2 of their scale
# from its fp32 ones (CPU run), and the port's bf16 ones from the
# reference's bf16 ones by as much (8.4e-2): rounding at other places (the
# kernel keeps the probabilities in fp32; torch rounds GeLU and each bf16
# product once), fed back through the conv tails and the recurrence. So in
# bf16 each quantity is held to the exact (fp32) answer: over the 40
# steps, the port strays from it no further than the reference in bf16
# does, plus 2e-2 of the quantity's scale.
BF16_ADDED = 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_through_wrapped_rings_matches_reference(ref_params, dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    tm = build_model(tcfg)
    tp = from_reference(ref_params, tcfg, device="cpu")
    ts = tm.init_decode_state(tp, B, BUDGET)
    exact = _decode_run(ref_params, "float32")
    same = _decode_run(ref_params, dtype)
    worst = {}                       # name -> [port's, reference's] stray
    for t, ((tok, l32, s32), (_, lref, sref)) in enumerate(zip(exact, same)):
        tl, ts = tm.decode(tp, ts, {"tokens": torch.from_numpy(tok)})
        assert tl.shape == (B, 1, 256) and tl.dtype == getattr(torch, dtype)
        got = [("logits", tl, None)] + _layer_tensors(ts, s32, jcfg, tcfg)
        ref = [np.asarray(lref)] + [w for _, _, w in _layer_tensors(
            ts, sref, jcfg, tcfg)]
        ex = [np.asarray(l32)] + [w for _, _, w in _layer_tensors(
            ts, s32, jcfg, tcfg)]
        for (name, g, _), r, e in zip(got, ref, ex):
            g = g.detach().float().numpy()
            r, e = np.asarray(r, np.float32), np.asarray(e, np.float32)
            assert g.shape == e.shape, name
            if dtype == "float32":
                np.testing.assert_allclose(g, e, rtol=1e-5, atol=1e-5,
                                           err_msg=f"step {t} {name}")
                continue
            scale = np.abs(e).max()
            w = worst.setdefault(name, [0.0, 0.0])
            w[0] = max(w[0], np.abs(g - e).max() / scale)
            w[1] = max(w[1], np.abs(r - e).max() / scale)
    for name, (port, reference) in worst.items():
        assert port <= reference + BF16_ADDED, (name, port, reference)
    assert ts.pos == STEPS


def test_converted_wrapped_reference_state_decodes_on(ref_params):
    jcfg, tcfg = _cfgs(dtype="float32")
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = from_reference(ref_params, tcfg, device="cpu")
    toks = _tokens((B, 30), 1)
    decode = jax.jit(jm.decode)
    js = jm.init_decode_state(ref_params, B, BUDGET)
    for t in range(21):                  # the rings have wrapped at 16
        _, js = decode(ref_params, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
    np_state = jax.tree.map(np.asarray, js)
    ts = decode_state_from_reference(np_state, tcfg, device="cpu")
    assert ts.pos == 21
    for st, w in zip(ts.layers, _ref_states(js, jcfg)):
        for name, value in st._asdict().items():
            np.testing.assert_array_equal(value.numpy(), w[name])
    for t in range(21, 30):
        jl, js = decode(ref_params, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        tl, ts = tm.decode(tp, ts, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        _close(tl, jl, 1e-5)
    # A ring whose slots are not where pos % C puts them still raises.
    kv = np_state.blocks[2]
    rolled = kv._replace(slot_pos=np.roll(kv.slot_pos, 1, axis=-1))
    bad = np_state._replace(blocks=(*np_state.blocks[:2], rolled))
    with pytest.raises(NotImplementedError, match="slot p % 16"):
        decode_state_from_reference(bad, tcfg, device="cpu")


def test_decode_matches_teacher_forcing_past_the_window(ref_params):
    # As tests/test_models.py holds the reference: token-by-token decode
    # (wrapped rings, carried RG-LRU states) against the port's own
    # full-sequence forward, T = 24 > window 16.
    _, tcfg = _cfgs(dtype="float32")
    tm = build_model(tcfg)
    tp = from_reference(ref_params, tcfg, device="cpu")
    T = 24
    toks = torch.from_numpy(_tokens((B, T), 4))
    from repro_torch.models import transformer

    with torch.no_grad():
        full = transformer.forward_logits(tp, tcfg, {"tokens": toks},
                                          last_only=False)
        state = tm.init_decode_state(tp, B, 2 * T)
        dec = []
        for t in range(T):
            lg, state = tm.decode(tp, state, {"tokens": toks[:, t:t + 1]})
            dec.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(), full.numpy(),
                               atol=2e-3, rtol=2e-3)


# Adam's first steps move an entry by about lr * g / (|g| + eps), a sign
# function of its gradient g. The two packages' gradients agree to 5.5e-6
# of each leaf's largest magnitude (CPU run: the associative scan against
# the loop, JAX's GeLU derivative against torch's), so an entry whose
# gradient lies that close to 0 moves differently: up to 3.0e-5 in two
# steps, 2 % of the 1.5e-3 that an entry moves. Gradients are held at 1e-5
# of their scale, the loss and gradient norm at 1e-5, the entries at 5e-5.
PARAM_ATOL = 5e-5


def test_train_step_matches_reference(ref_params):
    opt = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
    jcfg, tcfg = _cfgs(dtype="float32")
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jax.tree.map(jnp.asarray, ref_params)
    tp = from_reference(ref_params, tcfg, device="cpu")
    toks, labels = _tokens((4, 24), 3), _tokens((4, 24), 4)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks),
              "labels": torch.from_numpy(labels)}
    jgrads = jax.grad(lambda p: jm.loss(p, jbatch)[0])(jp)
    tg = from_reference(ref_params, tcfg, device="cpu")
    for t in jax.tree.leaves(tg):
        t.requires_grad_()
    tm.loss(tg, tbatch)[0].backward()
    grads = to_reference(jax.tree.map(lambda t: t.grad, tg), tcfg)
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(jgrads)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    jstep = jax.jit(jmake_train_step(jm, JOptConfig(**opt)))
    tstep = make_train_step(tm, OptConfig(**opt))
    jopt, topt = jinit_opt(jp), init_opt_state(tp)
    for _ in range(2):
        jp, jopt, jm_ = jstep(jp, jopt, jbatch)
        tp, topt, tm_ = tstep(tp, topt, tbatch)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree.leaves(to_reference(tp, tcfg)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                   atol=PARAM_ATOL)


# -- serving -------------------------------------------------------------------
@pytest.fixture(scope="module")
def models(ref_params):
    jcfg, tcfg = _cfgs(dtype="float32")
    return {"ref": (jbuild(jcfg), ref_params),
            "port": (build_model(tcfg),
                     from_reference(ref_params, tcfg, device="cpu"))}


def test_continuous_tokens_equal_reference_greedy(tmp_path, models):
    # 14-token prompts and up to 6 new tokens: the 16-slot rings wrap.
    n, L, max_new = 3, 14, [4, 6, 5]
    arr = _tokens((n * L,), 5)
    path = str(tmp_path / "prompts.bin")
    write_token_file(path, arr)
    tm, tp = models["port"]
    ck = tcore.CkIO(num_pes=2)
    fh = ck.open_sync(path, tcore.FileOptions(num_readers=1))
    metrics = tcore.ServeMetrics()
    ing = tserve.RequestIngester(ck, fh, read_meta(path), metrics,
                                 max_pending=n)
    engine = tserve.ModelEngine(tm, tp, slots=2, seq_budget=L + 6)
    for i in range(n):
        ing.submit(tserve.ServeRequest(rid=i, row_start=i * L, num_rows=L,
                                       max_new_tokens=max_new[i]))
    got = {r.rid: r.result for r in tserve.ContinuousBatcher(engine, ing).run()}
    ck.close_sync(fh)
    jm, jp = models["ref"]
    for i in range(n):
        want = jserve.greedy_generate(jm, jp, jnp.asarray(arr[None, i * L:(i + 1) * L]),
                                      max_new[i])
        assert got[i] == np.asarray(want)[0].tolist()


def test_batch_server_tokens_equal_reference(models):
    # Padded to 16 or 32 tokens, so the second batch's rings wrap.
    prompts = [_tokens((s,), 10 + s) for s in (5, 20, 9)]
    out = {}
    for pkg, serve in (("ref", jserve), ("port", tserve)):
        m, p = models[pkg]
        reqs = [serve.Request(rid=i, prompt=prompts[i], max_new_tokens=3 + i)
                for i in range(3)]
        done = serve.BatchServer(m, p, batch_size=2, bucket=16).serve(reqs)
        out[pkg] = [np.asarray(r.result).tolist() for r in done]
    assert out["port"] == out["ref"]
    assert [len(x) for x in out["port"]] == [3, 4, 5]


@pytest.mark.parametrize("mode", [[], ["--continuous", "--arrival-rate", "200"]])
def test_launch_serve_runs_on_cpu(tmp_path, mode):
    # 20 prompt tokens and 3 new ones: past the smoke window of 16.
    run = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--batch", "2", "--prompt-len", "20",
                        "--max-new", "3", "--data", str(tmp_path / "p.bin"),
                        *mode])
    assert run.summary["all_completed"] and run.summary["new_tokens"] == 9
    assert all(len(r.result) == 3 and all(0 <= t < 256 for t in r.result)
               for r in run.requests)


# -- training ------------------------------------------------------------------
def test_train_driver_trains_on_cpu(tmp_path):
    out = port_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "2", "--global-batch", "2", "--seq", "32",
                           "--microbatches", "1", "--data",
                           str(tmp_path / "t.bin")])
    assert out["steps"] == 2
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["final_loss"])


def test_train_driver_refuses_the_card_at_once(tmp_path):
    # Raised before the device is resolved or the corpus written, so the
    # same error shows here without a card.
    with pytest.raises(NotImplementedError) as e:
        port_train.main(["--arch", ARCH, "--smoke", "--device", "cuda",
                         "--data", str(tmp_path / "t.bin")])
    assert str(e.value) == FORWARD_ONLY and "forward-only" in FORWARD_ONLY
    assert not (tmp_path / "t.bin").exists()
