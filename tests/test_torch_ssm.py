"""The port's falcon-mamba slice against the reference, on the same inputs.

* ``ops.mamba_scan`` on CPU tensors (the plain loop of ``kernels/ref.py``)
  against the reference's ``mamba_scan_pallas`` in interpret mode and its
  ``ssm_scan_ref`` on the four sweep cases of ``tests/test_kernels.py``, at
  that sweep's 1e-4; with an initial state, and with the final state
  against the reference's ``_chunked_scan``.
* ``smoke_config(falcon-mamba-7b)`` with the reference's params converted:
  prefill logits and loss for both ``ssm_impl`` values (float32 1e-5: the
  same math in another order; bfloat16 2e-2: rounding at other places),
  decode logits and the ``MambaState`` after every step, a reference state
  converted mid-prompt, one train step, greedy serving tokens (float32,
  equal), the serve and train drivers on the CPU, the config and the
  converter.
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
from repro.kernels.mamba_scan import mamba_scan_pallas  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models.ssm import _chunked_scan  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import init_opt_state as jinit_opt  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.mamba_scan import FORWARD_ONLY  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    decode_state_from_reference,
    from_reference,
    to_reference,
)
from repro_torch.models.ssm import MambaState  # noqa: E402
from repro_torch.train import OptConfig, init_opt_state, make_train_step  # noqa: E402

ARCH = "falcon-mamba-7b"
SWEEP = [  # (B, S, D, N, chunk, block_d) of tests/test_kernels.py
    (1, 32, 16, 4, 8, 8),
    (2, 64, 32, 8, 16, 16),
    (1, 128, 64, 16, 128, 32),
    (2, 96, 16, 4, 32, 16),
]
B, STEPS = 2, 6
# bf16 SSM state against the reference's, as a share of its largest
# magnitude. dt is softplus of a bf16 pre-activation near dt_bias = -4.6,
# where one bf16 step (2^-5) moves dt by 3 %, and h is dt·B·x: the two
# packages' states differ by up to 2.8 % of their scale (CPU run) while the
# logits and conv tails stay within 2e-2.
H_TOL_BF16 = 5e-2


def _scan_inputs(B, S, D, N, seed=0):
    rng = np.random.default_rng(seed)
    A = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, S, D, N))))
    Bx = rng.standard_normal((B, S, D, N)) * 0.1
    C = rng.standard_normal((B, S, N))
    h0 = rng.standard_normal((B, D, N)) * 0.5
    return [a.astype(np.float32) for a in (A, Bx, C, h0)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("B_,S,D,N,chunk,block_d", SWEEP)
def test_scan_matches_pallas_interpret_and_oracle(B_, S, D, N, chunk, block_d):
    A, Bx, C, h0 = _scan_inputs(B_, S, D, N, seed=S + D)
    got = ops.mamba_scan(*_t(A, Bx, C))
    assert got.shape == (B_, S, D) and got.dtype == torch.float32
    pallas = mamba_scan_pallas(jnp.asarray(A), jnp.asarray(Bx), jnp.asarray(C),
                               chunk=chunk, block_d=block_d, interpret=True)
    _close(got, pallas, 1e-4)
    _close(got, jref.ssm_scan_ref(jnp.asarray(A), jnp.asarray(Bx),
                                  jnp.asarray(C)), 1e-4)
    # From a carried state: y against the oracle, h_S against the
    # reference model's chunked scan.
    y, h = ops.mamba_scan(*_t(A, Bx, C), h0=torch.from_numpy(h0),
                          return_state=True)
    _close(y, jref.ssm_scan_ref(*map(jnp.asarray, (A, Bx, C, h0))), 1e-4)
    _, h_final = _chunked_scan(jnp.asarray(A), jnp.asarray(Bx), chunk,
                               jnp.asarray(h0))
    _close(h, h_final, 1e-4)


def test_scan_is_a_decode_step_with_s1():
    A, Bx, C, h0 = _scan_inputs(2, 5, 8, 4, seed=3)
    h = torch.from_numpy(h0)
    ys = []
    for t in range(5):
        y, h = ops.mamba_scan(*_t(A[:, t:t + 1], Bx[:, t:t + 1], C[:, t:t + 1]),
                              h0=h, return_state=True)
        ys.append(y)
    whole, h_whole = ops.mamba_scan(*_t(A, Bx, C), h0=torch.from_numpy(h0),
                                    return_state=True)
    assert torch.equal(torch.cat(ys, 1), whole) and torch.equal(h, h_whole)


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
    assert get_config(ARCH).param_counts()["total"] == 7_272_398_848


def test_converter_round_trips_exactly(ref_params):
    _, tcfg = _cfgs()
    tp = from_reference(ref_params, tcfg, device="cpu")
    assert len(tp["layers"]) == tcfg.num_layers and "lm_head" in tp
    assert set(tp["layers"][0]) == {"norm1", "mixer"}
    back = to_reference(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(ref_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_params)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # The port's own init has the reference's shapes and dtypes.
    own = build_model(tcfg).init(0, device="cpu")
    for a, b in zip(jax.tree.leaves(to_reference(own, tcfg)),
                    jax.tree.leaves(ref_params)):
        assert a.dtype == b.dtype and a.shape == b.shape


@pytest.mark.parametrize("impl", ["materialized", "fused"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_prefill_logits_and_loss_match_reference(ref_params, impl, dtype, tol):
    jcfg, tcfg = _cfgs(dtype=dtype, ssm_impl=impl)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = from_reference(ref_params, tcfg, device="cpu")
    toks, labels = _tokens((B, 32), 1), _tokens((B, 32), 2)
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
    """The reference's MambaStates unstacked into schedule order (NumPy)."""
    pattern, nb, _ = cfg.scan_split()
    out = [(np.asarray(state.blocks[i].h)[bi], np.asarray(state.blocks[i].conv)[bi])
           for bi in range(nb) for i in range(len(pattern))]
    return out + [(np.asarray(s.h), np.asarray(s.conv)) for s in state.tail]


def _close_to_scale(got, want, dtype, tol):
    """float32: elementwise at ``tol``. bfloat16: the largest difference
    within ``tol`` of the largest magnitude. The untied fan-in head gives
    logits of a few units, and an element near zero can differ by a few
    bf16 steps of its neighbours (one Mamba layer's decode output already
    differs by 0.4 % of its scale between the two packages' roundings)."""
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        _close(got, want, tol)
        return
    err = np.abs(got.detach().float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), err


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_decode_steps_match_reference_logits_and_state(ref_params, dtype, tol):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = from_reference(ref_params, tcfg, device="cpu")
    toks = _tokens((B, STEPS))
    js = jm.init_decode_state(ref_params, B, STEPS)
    ts = tm.init_decode_state(tp, B, STEPS)
    for t in range(STEPS):
        jl, js = jm.decode(ref_params, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        tl, ts = tm.decode(tp, ts, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        assert tl.shape == (B, 1, 256) and tl.dtype == getattr(torch, dtype)
        _close_to_scale(tl, jl, dtype, tol)
        want = _ref_states(js, jcfg)
        assert len(ts.layers) == len(want) == tcfg.num_layers
        for st, (h, conv) in zip(ts.layers, want):
            assert isinstance(st, MambaState)
            assert st.h.dtype == torch.float32 and st.conv.dtype == getattr(
                torch, dtype)
            _close_to_scale(st.conv, conv, dtype, tol)
            _close_to_scale(st.h, h, dtype,
                            tol if dtype == "float32" else H_TOL_BF16)
    assert ts.pos == int(js.pos) == STEPS


def test_converted_reference_state_decodes_on(ref_params):
    jcfg, tcfg = _cfgs(dtype="float32")
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = from_reference(ref_params, tcfg, device="cpu")
    toks = _tokens((B, STEPS), 1)
    js = jm.init_decode_state(ref_params, B, STEPS)
    for t in range(3):
        _, js = jm.decode(ref_params, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
    ts = decode_state_from_reference(jax.tree.map(np.asarray, js), tcfg,
                                     device="cpu")
    assert ts.pos == 3
    for st, (h, conv) in zip(ts.layers, _ref_states(js, jcfg)):
        np.testing.assert_array_equal(st.h.numpy(), h)
        np.testing.assert_array_equal(st.conv.numpy(), conv)
    for t in range(3, STEPS):
        jl, js = jm.decode(ref_params, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        tl, ts = tm.decode(tp, ts, {"tokens": torch.from_numpy(toks[:, t:t + 1])})
        _close(tl, jl, 1e-5)


def test_train_step_matches_reference(ref_params):
    opt = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
    jcfg, tcfg = _cfgs(dtype="float32")
    jm = jbuild(jcfg)
    jp = jax.tree.map(jnp.asarray, ref_params)
    tp = from_reference(ref_params, tcfg, device="cpu")
    toks, labels = _tokens((4, 16), 3), _tokens((4, 16), 4)
    jstep = jax.jit(jmake_train_step(jm, JOptConfig(**opt)))
    tstep = make_train_step(build_model(tcfg), OptConfig(**opt))
    jopt, topt = jinit_opt(jp), init_opt_state(tp)
    for _ in range(2):
        jp, jopt, jm_ = jstep(jp, jopt, {"tokens": jnp.asarray(toks),
                                         "labels": jnp.asarray(labels)})
        tp, topt, tm_ = tstep(tp, topt, {"tokens": torch.from_numpy(toks),
                                         "labels": torch.from_numpy(labels)})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree.leaves(to_reference(tp, tcfg)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


# -- serving -------------------------------------------------------------------
@pytest.fixture(scope="module")
def models(ref_params):
    jcfg, tcfg = _cfgs(dtype="float32")
    return {"ref": (jbuild(jcfg), ref_params),
            "port": (build_model(tcfg),
                     from_reference(ref_params, tcfg, device="cpu"))}


def test_continuous_tokens_equal_reference_greedy(tmp_path, models):
    n, L, max_new = 3, 7, [4, 2, 5]
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
    prompts = [_tokens((s,), 10 + s) for s in (5, 9, 7)]
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
    run = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "3", "--batch", "2", "--prompt-len", "6",
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
