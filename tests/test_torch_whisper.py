"""whisper-medium against the reference, on the same inputs: the
encoder-decoder backbone (``repro_torch/models/encdec.py``) with pre-LN
LayerNorm, GELU MLPs with biases, learned positions, a bidirectional
encoder, decoder self-attention over KV rings and cross-attention over
precomputed encoder keys and values. The audio frontend is a stub in both
packages: frames are random embeddings from a NumPy seed.

At ``smoke_config`` size (2 encoder and 2 decoder layers, 32 frames) with
the reference's params converted by ``repro_torch.models.convert``: the
config field by field, the converter both ways, ``layernorm`` and the GELU
MLP, ``encode``, ``forward_logits`` and the loss with its gradients,
``init_decode_state``'s cross keys and values, decode logits at each of 20
steps, a converted reference ``EncDecState`` decoded on, greedy tokens of
``greedy_generate(frames=)`` and of a ``ContinuousBatcher`` over a CkIO
``RequestIngester`` with ``ModelEngine(frames=)`` equal to the
reference's and to the port's sequential oracle, where the kernel entry
runs (the encoder at admission, self- and cross-attention in decode, none
in the loss), the forward-only kernel's refusal of autograd and both
serving paths admitting params that require a gradient, and the drivers'
refusals.

Tolerances are those of tests/test_torch_families.py: float32 at 1e-5,
gradients at 1e-5 of each leaf's largest magnitude, bf16 logits held to
the exact (float32) answer by its ``BF16_ADDED`` rule; tokens are
compared in float32 only.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.data.tokenfile import read_meta, write_token_file  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs.registry import ARCHS as PORT_ARCHS  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.data import make_embedding_file  # noqa: E402
from repro_torch.data.tokenfile import decode_rows  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import build_model, encdec, layers  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    decode_state_from_reference,
    from_reference,
    to_reference,
)
from repro_torch.models.encdec import EncDecState  # noqa: E402

ARCH = "whisper-medium"
B, STEPS, BUDGET, D, S_ENC = 2, 20, 24, 64, 32
PKGS = {"ref": (jcore, jserve), "port": (tcore, tserve)}
# See tests/test_torch_families.py: the port's bf16 logits stray from the
# exact answer no further than the reference's, plus 2e-2 of their scale.
BF16_ADDED = 2e-2
DTYPES = ["float32", "bfloat16"]


def _cfgs(**kw):
    return (jsmoke(jget_config(ARCH)).replace(**kw),
            smoke_config(get_config(ARCH)).replace(**kw))


@functools.lru_cache(maxsize=None)
def _ref_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))


def _port_params(tcfg):
    return from_reference(_ref_params(), tcfg, device="cpu")


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(
        np.int32)


def _frames(b, seed=0):
    return (np.random.default_rng(seed).standard_normal((b, S_ENC, D))
            * 0.5).astype(np.float32)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _stray(got, want, exact) -> tuple:
    """(port's, reference's) largest distance from the exact logits, over
    the exact logits' largest magnitude."""
    e = np.asarray(exact, np.float32)
    scale = np.abs(e).max()
    return (np.abs(got.detach().float().numpy() - e).max() / scale,
            np.abs(np.asarray(want, np.float32) - e).max() / scale)


def _kernel_calls(monkeypatch):
    """Count the calls of ``ops.flash_attention`` (the kernel entry: the
    hand-written kernel on CUDA tensors, its plain version here), with
    ``causal`` of each."""
    calls = []
    real = ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append(kw.get("causal", True))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", counting)
    return calls


def _as_if_on_the_card(monkeypatch):
    """Send ``ops.flash_attention`` down its CUDA branch with CPU tensors,
    the launch replaced by the plain version; returns the list of the
    launches' ``causal``."""
    launched = []

    def launch(q, k, v, *, causal, window, softcap):
        launched.append(causal)
        return kref.attention_ref(q, k, v, causal=causal, window=window,
                                  softcap=softcap)

    monkeypatch.setattr(ops, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(FA, "flash_attention_cuda", launch)
    return launched


# -- config, converter, layers -----------------------------------------------------
def test_config_equals_reference_field_by_field():
    assert ARCH in PORT_ARCHS
    for jcfg, tcfg in ((jget_config(ARCH), get_config(ARCH)), _cfgs()):
        jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
        assert sorted(td) == sorted(jd)
        for field in jd:
            assert td[field] == jd[field], field
        assert tcfg.param_counts() == jcfg.param_counts()
    full = get_config(ARCH)
    assert full.is_encdec and not full.use_rope and full.act == "gelu"
    assert (full.encoder_layers, full.encoder_seq, full.num_layers,
            full.max_position) == (24, 1500, 24, 40_960)
    small = _cfgs()[1]
    assert (small.encoder_layers, small.encoder_seq, small.num_layers) == (
        2, S_ENC, 2)


def test_converter_round_trips_and_init_has_reference_layout():
    jcfg, tcfg = _cfgs()
    ref = _ref_params()
    tp = from_reference(ref, tcfg, device="cpu")
    assert len(tp["enc_blocks"]) == 2 and len(tp["dec_blocks"]) == 2
    dec = tp["dec_blocks"][1]
    assert sorted(dec) == ["cross_attn", "ffn", "norm1", "norm2", "norm3",
                           "self_attn"]
    assert sorted(dec["ffn"]) == ["fc1", "fc1_b", "fc2", "fc2_b"]
    assert sorted(dec["norm3"]) == ["bias", "scale"]
    assert {"bq", "bk", "bv"} <= set(dec["cross_attn"])
    np.testing.assert_array_equal(dec["ffn"]["fc2"].numpy(),
                                  ref["dec_blocks"]["ffn"]["fc2"][1])
    back = to_reference(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                          jbuild(jcfg).abstract_params())
    own = to_reference(build_model(tcfg).init(3, device="cpu"), tcfg)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), own) == shapes
    with pytest.raises(ValueError, match="enc_blocks holds 2 layers"):
        from_reference(ref, tcfg.replace(encoder_layers=3), device="cpu")


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_and_gelu_mlp_match_reference(dtype):
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 7, D)) * 2 + 0.5).astype(np.float32)
    norm = {"scale": (1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(D)).astype(np.float32)}
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    tol = 1e-5 if dtype == "float32" else 2e-2
    want = jlayers.layernorm(jax.tree.map(jnp.asarray, norm), jx, 1e-5)
    got = layers.layernorm({k: torch.from_numpy(v) for k, v in norm.items()},
                           tx, 1e-5)
    assert got.dtype == tx.dtype
    _close(got, np.asarray(want.astype(jnp.float32)), tol)
    mlp = jax.tree.map(np.array, jlayers.mlp_init(
        jax.random.PRNGKey(1), D, 128, "gelu", jnp.float32))
    mlp["fc1_b"] = (0.1 * rng.standard_normal(128)).astype(np.float32)
    mlp["fc2_b"] = (0.1 * rng.standard_normal(D)).astype(np.float32)
    assert sorted(layers.mlp_init(torch.Generator(), D, 128, "gelu",
                                  torch.float32, "cpu")) == sorted(mlp)
    want = jlayers.mlp_apply(jax.tree.map(jnp.asarray, mlp), jx, "gelu",
                             jnp.dtype(dtype))
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in mlp.items()},
                           tx, "gelu", getattr(torch, dtype))
    assert got.dtype == tx.dtype
    _close(got, np.asarray(want.astype(jnp.float32)), tol)
    with pytest.raises(ValueError, match="unknown MLP activation"):
        layers.mlp_apply(mlp, tx, "relu", torch.float32)


# -- encode, prefill, loss, gradients ----------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_encode_forward_logits_and_loss_match_reference(dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    ref = _ref_params()
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = _port_params(tcfg)
    frames, toks, labels = _frames(B, 1), _tokens((B, 20), 2), _tokens(
        (B, 20), 3)
    jb = {"embeds": jnp.asarray(frames), "tokens": jnp.asarray(toks)}
    tb = {"embeds": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)}
    jenc = jencdec.encode(ref, jcfg, jb["embeds"])
    jl = jm.prefill_logits(ref, jb)
    jloss, _ = jm.loss(ref, {**jb, "labels": jnp.asarray(labels)})
    with torch.no_grad():
        tenc = encdec.encode(tp, tcfg, tb["embeds"])
        tl = tm.prefill_logits(tp, tb)
        tloss, tmet = tm.loss(tp, {**tb, "labels": torch.from_numpy(labels)})
    assert tenc.shape == (B, S_ENC, D) and tl.shape == (B, 1, 256)
    assert tl.dtype == getattr(torch, dtype)
    if dtype == "float32":
        tol = 1e-5
        _close(tenc, jenc, tol)
        _close(tl, jl, tol)
        full = tm._m.forward_logits(tp, tcfg, tb, last_only=False)
        _close(full, jencdec.forward_logits(ref, jcfg, jb, last_only=False),
               tol)
    else:
        tol = 2e-2
        exact = jbuild(jcfg.replace(dtype="float32")).prefill_logits(ref, jb)
        port, reference = _stray(tl, jl, exact)
        assert port <= reference + BF16_ADDED, (port, reference)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol, atol=tol)
    assert float(tmet["aux"]) == 0.0


def test_loss_gradients_match_reference(monkeypatch):
    jcfg, tcfg = _cfgs(dtype="float32")
    ref = _ref_params()
    jm, tm = jbuild(jcfg), build_model(tcfg)
    frames, toks, labels = _frames(3, 4), _tokens((3, 16), 5), _tokens(
        (3, 16), 6)
    jbatch = {"embeds": jnp.asarray(frames), "tokens": jnp.asarray(toks),
              "labels": jnp.asarray(labels)}
    jgrads = jax.grad(lambda p: jm.loss(p, jbatch)[0])(
        jax.tree.map(jnp.asarray, ref))
    tg = _port_params(tcfg)
    for t in jax.tree.leaves(tg):
        t.requires_grad_()
    calls = _kernel_calls(monkeypatch)
    tm.loss(tg, {"embeds": torch.from_numpy(frames),
                 "tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labels)})[0].backward()
    assert calls == []              # the loss runs the plain attention
    grads = to_reference(jax.tree.map(lambda t: t.grad, tg), tcfg)
    scale = max(np.abs(np.asarray(b)).max() for b in jax.tree.leaves(jgrads))
    for (path, b), a in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                            jax.tree.leaves(grads)):
        b = np.asarray(b)
        if path[-1].key == "bk":
            # A key bias adds the same q.b to every score of a query, which
            # the softmax cancels: its exact gradient is 0, and both
            # packages give rounding noise.
            assert np.abs(a).max() <= 1e-6 * scale
            assert np.abs(b).max() <= 1e-6 * scale
            continue
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


# -- decode -------------------------------------------------------------------------
def test_init_decode_state_runs_the_encoder_through_the_kernel_entry(
        monkeypatch):
    jcfg, tcfg = _cfgs(dtype="float32")
    ref = _ref_params()
    tm = build_model(tcfg)
    tp = _port_params(tcfg)
    frames = _frames(B, 7)
    js = jbuild(jcfg).init_decode_state(ref, B, BUDGET,
                                        frames=jnp.asarray(frames))
    calls = _kernel_calls(monkeypatch)
    ts = tm.init_decode_state(tp, B, BUDGET, frames=frames)   # NumPy frames
    assert calls == [False] * tcfg.encoder_layers
    assert isinstance(ts, EncDecState) and ts.pos == 0
    assert len(ts.cross_kv) == len(ts.self_caches) == tcfg.num_layers
    for li, (k, v) in enumerate(ts.cross_kv):
        assert k.shape == (B, S_ENC, 2, 16)
        _close(k, np.asarray(js.cross_kv[0])[li], 1e-5, f"k {li}")
        _close(v, np.asarray(js.cross_kv[1])[li], 1e-5, f"v {li}")
    for c in ts.self_caches:
        assert c.k.shape == (B, BUDGET, 2, 16) and not c.k.any()
    # One decode step: each layer's self- and cross-attention through it.
    calls.clear()
    with torch.no_grad():
        tm.decode(tp, ts, {"tokens": torch.from_numpy(_tokens((B, 1)))})
    assert calls == [True, False] * tcfg.num_layers
    # Params that require a gradient take the kernel entry too: on the
    # card the forward-only kernel then refuses autograd before it launches.
    calls.clear()
    tg = _port_params(tcfg)
    for t in jax.tree.leaves(tg):
        t.requires_grad_()
    tg_state = tm.init_decode_state(tg, B, BUDGET, frames=frames)
    assert calls == [False] * tcfg.encoder_layers
    for (k, _), (k2, _) in zip(ts.cross_kv, tg_state.cross_kv):
        _close(k2, k.numpy(), 1e-5)
    launched = _as_if_on_the_card(monkeypatch)
    with pytest.raises(NotImplementedError) as e:
        tm.init_decode_state(tg, B, BUDGET, frames=frames)
    assert str(e.value) == FA.FORWARD_ONLY and launched == []
    with torch.no_grad():
        tm.init_decode_state(tg, B, BUDGET, frames=frames)
    assert launched == [False] * tcfg.encoder_layers
    with pytest.raises(ValueError, match="frames hold 2 sequences"):
        tm.init_decode_state(tp, 3, BUDGET, frames=frames)
    with pytest.raises(ValueError, match="needs encoder frames"):
        tm.init_decode_state(tp, B, BUDGET)


def _ref_decode(dtype, frames, toks, steps=STEPS):
    jcfg, _ = _cfgs(dtype=dtype)
    jm, ref = jbuild(jcfg), _ref_params()
    decode = jax.jit(jm.decode)
    js = jm.init_decode_state(ref, B, BUDGET, frames=jnp.asarray(frames))
    out = []
    for t in range(steps):
        jl, js = decode(ref, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        out.append(jl)
    return out, js


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_logits_match_reference_at_every_step(dtype):
    _, tcfg = _cfgs(dtype=dtype)
    tm = build_model(tcfg)
    tp = _port_params(tcfg)
    frames, toks = _frames(B, 8), _tokens((B, STEPS), 9)
    ts = tm.init_decode_state(tp, B, BUDGET,
                              frames=torch.from_numpy(frames))
    want, js = _ref_decode(dtype, frames, toks)
    exact = (want if dtype == "float32"
             else _ref_decode("float32", frames, toks)[0])
    worst = [0.0, 0.0]
    for t in range(STEPS):
        with torch.no_grad():
            tl, ts = tm.decode(tp, ts, {"tokens": torch.from_numpy(
                toks[:, t:t + 1])})
        assert tl.shape == (B, 1, 256) and tl.dtype == getattr(torch, dtype)
        if dtype == "float32":
            _close(tl, want[t], 1e-5, f"step {t}")
        else:
            worst = np.maximum(worst, _stray(tl, want[t], exact[t]))
    assert worst[0] <= worst[1] + BF16_ADDED, worst
    assert ts.pos == int(js.pos) == STEPS


def test_decode_replay_equals_forward_logits():
    # The prompt replayed through decode (the kernel entry) gives the last
    # logits of the teacher-forced forward (the plain attention).
    _, tcfg = _cfgs(dtype="float32")
    tm = build_model(tcfg)
    tp = _port_params(tcfg)
    frames = torch.from_numpy(_frames(B, 10))
    toks = torch.from_numpy(_tokens((B, 12), 11))
    with torch.no_grad():
        ts = tm.init_decode_state(tp, B, 16, frames=frames)
        for t in range(12):
            tl, ts = tm.decode(tp, ts, {"tokens": toks[:, t:t + 1]})
        pre = tm.prefill_logits(tp, {"embeds": frames, "tokens": toks})
    _close(tl, pre.numpy(), 1e-5)


def test_converted_reference_state_decodes_on():
    jcfg, tcfg = _cfgs(dtype="float32")
    ref = _ref_params()
    tm = build_model(tcfg)
    tp = _port_params(tcfg)
    frames, toks = _frames(B, 12), _tokens((B, STEPS), 13)
    _, js = _ref_decode("float32", frames, toks, steps=15)
    ts = decode_state_from_reference(jax.tree.map(np.asarray, js), tcfg,
                                     device="cpu")
    assert isinstance(ts, EncDecState) and ts.pos == 15
    for li in range(tcfg.num_layers):
        np.testing.assert_array_equal(ts.self_caches[li].k.numpy(),
                                      np.asarray(js.self_caches.k)[li])
        np.testing.assert_array_equal(ts.self_caches[li].v.numpy(),
                                      np.asarray(js.self_caches.v)[li])
        np.testing.assert_array_equal(ts.cross_kv[li][1].numpy(),
                                      np.asarray(js.cross_kv[1])[li])
    decode = jax.jit(jbuild(jcfg).decode)
    for t in range(15, STEPS):
        jl, js = decode(ref, js, {"tokens": jnp.asarray(toks[:, t:t + 1])})
        with torch.no_grad():
            tl, ts = tm.decode(tp, ts, {"tokens": torch.from_numpy(
                toks[:, t:t + 1])})
        _close(tl, jl, 1e-5, f"step {t}")
    # A ring whose slots do not hold what the port reads from pos raises.
    bad = jax.tree.map(np.asarray, js)
    sp = bad.self_caches.slot_pos.copy()
    sp[:, 0] = 99
    bad = bad._replace(self_caches=bad.self_caches._replace(slot_pos=sp))
    with pytest.raises(NotImplementedError, match="slot p % 24"):
        decode_state_from_reference(bad, tcfg, device="cpu")


# -- serving -------------------------------------------------------------------------
def _models():
    jcfg, tcfg = _cfgs(dtype="float32")
    ref = _ref_params()
    return {"ref": (jbuild(jcfg), ref),
            "port": (build_model(tcfg), _port_params(tcfg))}


def test_greedy_generate_with_frames_equals_reference():
    models = _models()
    frames, prompt = _frames(3, 14), _tokens((3, 9), 15)
    jm, jp = models["ref"]
    want = jserve.greedy_generate(jm, jp, jnp.asarray(prompt), 6,
                                  frames=jnp.asarray(frames))
    tm, tp = models["port"]
    got = tserve.greedy_generate(tm, tp, torch.from_numpy(prompt), 6,
                                 frames=frames)
    assert got.shape == (3, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serving_admits_params_that_require_grad(monkeypatch):
    # A trainer's params require a gradient. Both serving paths admit
    # under torch.no_grad(), so on the card the forward-only kernel runs the
    # encoder, and the decode state holds no autograd graph.
    _, tcfg = _cfgs(dtype="float32")
    tm, tp = build_model(tcfg), _port_params(tcfg)
    for t in jax.tree.leaves(tp):
        t.requires_grad_()
    frames, prompt = _frames(1, 17), _tokens((1, 7), 18)
    want = tserve.greedy_generate(tm, tp, torch.from_numpy(prompt), 5,
                                  frames=frames)
    launched = _as_if_on_the_card(monkeypatch)
    got = tserve.greedy_generate(tm, tp, torch.from_numpy(prompt), 5,
                                 frames=frames)
    enc = [False] * tcfg.encoder_layers
    assert launched[:len(enc)] == enc
    assert launched[len(enc):] == [True, False] * tcfg.num_layers * (7 + 5)
    engine = tserve.ModelEngine(tm, tp, slots=1, seq_budget=12,
                                frames=frames)
    launched.clear()
    engine.admit(0, prompt[0])
    assert launched[:len(enc)] == enc
    assert not any(k.requires_grad or v.requires_grad
                   for k, v in engine._state[0].cross_kv)
    engine.evict(0)
    oracle = tserve.sequential_oracle(engine, [prompt[0]], [5])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert oracle == [list(got[0].tolist())]


def test_continuous_batcher_with_frames_equals_reference_and_oracle(
        tmp_path, monkeypatch):
    # The frames come from an embedding file read through a CkIO session
    # (as the served audio would); prompts through a RequestIngester.
    n, L, max_new = 3, 10, [4, 6, 5]
    fpath = str(tmp_path / "frames.bin")
    meta = make_embedding_file(fpath, S_ENC, D, seed=3)
    ck = tcore.CkIO(num_pes=2)
    fh = ck.open_sync(fpath, tcore.FileOptions(num_readers=2))
    off, nbytes = meta.byte_range_for_rows(0, S_ENC)
    sess = ck.start_read_session_sync(fh, nbytes, off)
    frames = decode_rows(meta, ck.read_sync(sess, nbytes, off), 0,
                         S_ENC)[None].copy()
    ck.close_read_session_sync(sess)
    ck.close_sync(fh)
    assert frames.shape == (1, S_ENC, D) and frames.dtype == np.float32
    arr = _tokens((n * L,), 16)
    path = str(tmp_path / "prompts.bin")
    write_token_file(path, arr)
    models = _models()
    calls = _kernel_calls(monkeypatch)
    got = {}
    for pkg, (core, serve) in PKGS.items():
        m, p = models[pkg]
        ckio = core.CkIO(num_pes=2)
        fh = ckio.open_sync(path, core.FileOptions(num_readers=1))
        ing = serve.RequestIngester(ckio, fh, read_meta(path),
                                    core.ServeMetrics(), max_pending=n)
        fr = jnp.asarray(frames) if pkg == "ref" else frames
        engine = serve.ModelEngine(m, p, slots=2, seq_budget=L + 6, frames=fr)
        bat = serve.ContinuousBatcher(engine, ing)
        for i in range(n):
            ing.submit(serve.ServeRequest(rid=i, row_start=i * L, num_rows=L,
                                          max_new_tokens=max_new[i]))
        got[pkg] = {r.rid: r.result for r in bat.run()}
        ckio.close_sync(fh)
        if pkg == "port":
            assert isinstance(engine.frames, torch.Tensor)
            # Every admission ran the encoder once (2 layers); each of a
            # request's L + max_new decode calls (its prompt, then a call a
            # token) ran each of the 2 layers' self- and cross-attention.
            n_calls = sum(L + m_ for m_ in max_new)
            assert calls.count(True) == 2 * n_calls
            assert calls.count(False) == 2 * n_calls + 2 * n
            oracle = tserve.sequential_oracle(
                engine, [arr[i * L:(i + 1) * L] for i in range(n)], max_new)
    assert got["port"] == got["ref"]
    assert [got["port"][i] for i in range(n)] == oracle
    assert [len(got["port"][i]) for i in range(n)] == max_new


# -- drivers -------------------------------------------------------------------------
def test_serve_driver_refuses_the_arch_as_the_reference_does(tmp_path):
    with pytest.raises(SystemExit, match="token-input archs"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--data", str(tmp_path / "p.bin")])


def test_train_driver_refuses_the_arch(tmp_path):
    with pytest.raises(SystemExit, match="needs encoder frames"):
        port_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                         "--steps", "1", "--data", str(tmp_path / "t.bin")])
