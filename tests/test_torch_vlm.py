"""qwen2-vl-2b against the reference, on the same inputs: M-RoPE (the
rotary pairs cut into (t, h, w) sections, each rotated by its coordinate of
a 3-D position) and the patch-embedding input (``{"embeds",
"positions"}``, the vision frontend a stub in both packages), beside the
token input that the drivers and serving use.

At ``smoke_config`` size (sections (2, 3, 3)) with the reference's params
converted by ``repro_torch.models.convert``: the config field by field,
the converter both ways, ``rope_angles`` at distinct (t, h, w)
coordinates, prefill logits and the loss with embeddings and with tokens,
gradients and one AdamW step, decode logits at each of 20 steps fed tokens
and fed embeddings, greedy tokens under ``BatchServer`` and the continuous
batcher equal to the reference's and to the port's sequential oracle, and
the drivers (the train driver trains on tokens; the serve driver refuses
the arch, as the reference's does).

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
from repro.models.layers import rope_angles as jrope_angles  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import init_opt_state as jinit_opt  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs.registry import ARCHS as PORT_ARCHS  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_reference, to_reference  # noqa: E402
from repro_torch.models.layers import rope_angles  # noqa: E402
from repro_torch.train import OptConfig, init_opt_state, make_train_step  # noqa: E402

ARCH = "qwen2-vl-2b"
B, STEPS, BUDGET = 2, 20, 24
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)
PKGS = {"ref": (jcore, jserve), "port": (tcore, tserve)}
# See tests/test_torch_families.py: the port's bf16 logits stray from the
# exact answer no further than the reference's, plus 2e-2 of their scale.
BF16_ADDED = 2e-2
PARAM_ATOL = 5e-5       # Adam's first step; tests/test_torch_families.py
DTYPES = ["float32", "bfloat16"]


def _cfgs(**kw):
    return (jsmoke(jget_config(ARCH)).replace(**kw),
            smoke_config(get_config(ARCH)).replace(**kw))


@functools.lru_cache(maxsize=None)
def _ref_params():
    jcfg, _ = _cfgs()
    return jax.tree.map(np.asarray, jbuild(jcfg).init(jax.random.PRNGKey(0)))


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape).astype(
        np.int32)


def _embeds(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(
        np.float32)


def _mrope_positions(b, s, seed=0):
    """Distinct (t, h, w) coordinates: a patch grid's rows and columns at a
    time step, as the vision frontend lays them out, shuffled by batch."""
    rng = np.random.default_rng(seed)
    i = np.arange(s)
    t, h, w = i // 6, (i // 3) % 2 + 2, i % 3 + 7
    pos = np.stack([t, h, w], axis=-1)[None].repeat(b, 0)
    pos[1:] += rng.integers(0, 5, size=(b - 1, 1, 3))
    return pos.astype(np.int32)


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


def _batches(kind, b, s, seed):
    """The same batch for both packages: tokens, or patch embeddings with
    3-D positions."""
    if kind == "tokens":
        np_batch = {"tokens": _tokens((b, s), seed)}
    else:
        np_batch = {"embeds": _embeds((b, s, 64), seed),
                    "positions": _mrope_positions(b, s, seed)}
    return ({k: jnp.asarray(v) for k, v in np_batch.items()},
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


# -- config, converter, M-RoPE ---------------------------------------------------
def test_config_equals_reference_field_by_field():
    assert ARCH in PORT_ARCHS
    for jcfg, tcfg in ((jget_config(ARCH), get_config(ARCH)), _cfgs()):
        jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
        assert sorted(td) == sorted(jd)
        for field in jd:
            assert td[field] == jd[field], field
        assert tcfg.param_counts() == jcfg.param_counts()
    full = get_config(ARCH)
    assert (full.input_mode, full.mrope_sections, full.num_layers) == (
        "embeddings", (16, 24, 24), 28)
    assert _cfgs()[1].mrope_sections == (2, 3, 3)


def test_converter_round_trips_and_init_has_reference_layout():
    jcfg, tcfg = _cfgs()
    ref = _ref_params()
    tp = from_reference(ref, tcfg, device="cpu")
    assert len(tp["layers"]) == tcfg.num_layers
    assert {"bq", "bk", "bv"} <= set(tp["layers"][0]["mixer"])
    back = to_reference(tp, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    shapes = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                          jbuild(jcfg).abstract_params())
    own = to_reference(build_model(tcfg).init(3, device="cpu"), tcfg)
    assert jax.tree.map(lambda a: (a.shape, str(a.dtype)), own) == shapes


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_rope_angles_match_reference_at_distinct_coordinates(sections, hd):
    pos = _mrope_positions(3, 17, seed=4) * 37      # far from 0: big angles
    assert len({tuple(p) for p in pos.reshape(-1, 3)}) > 17
    jc, js = jrope_angles(jnp.asarray(pos), hd, 1e6, sections)
    tc, ts = rope_angles(torch.from_numpy(pos), hd, 1e6, sections)
    assert tc.shape == (3, 17, hd // 2) and tc.dtype == torch.float32
    _close(tc, jc, 1e-5)
    _close(ts, js, 1e-5)
    # Each section follows its own coordinate: (t, h, w) differ, so do the
    # sections' angles from the 1-D rotation of any one of them.
    plain_c, _ = rope_angles(torch.from_numpy(pos[..., 0]), hd, 1e6)
    assert torch.equal(tc[..., :sections[0]], plain_c[..., :sections[0]])
    assert not torch.equal(tc, plain_c)
    # (B, S) positions rotate as the same positions broadcast to 3-D.
    flat = torch.from_numpy(pos[..., 1])
    b3 = flat[..., None].expand(3, 17, 3)
    assert torch.equal(rope_angles(flat, hd, 1e6, sections)[0],
                       rope_angles(b3, hd, 1e6, sections)[0])
    with pytest.raises(ValueError, match="mrope sections"):
        rope_angles(torch.from_numpy(pos), hd, 1e6, (1, 2, 3))


# -- prefill, loss, gradients, train step ------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["embeds", "tokens"])
def test_prefill_logits_and_loss_match_reference(kind, dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    ref = _ref_params()
    jm, tm = jbuild(jcfg), build_model(tcfg)
    tp = from_reference(ref, tcfg, device="cpu")
    jb, tb = _batches(kind, B, 24, 1)
    labels = _tokens((B, 24), 2)
    jl = jm.prefill_logits(ref, jb)
    with torch.no_grad():
        tl = tm.prefill_logits(tp, tb)
        tloss, tmet = tm.loss(tp, {**tb, "labels": torch.from_numpy(labels)})
    assert tl.shape == (B, 1, 256) and tl.dtype == getattr(torch, dtype)
    jloss, _ = jm.loss(ref, {**jb, "labels": jnp.asarray(labels)})
    tol = 1e-5
    if dtype == "float32":
        _close(tl, jl, tol)
    else:
        tol = 2e-2
        exact = jbuild(jcfg.replace(dtype="float32")).prefill_logits(ref, jb)
        port, reference = _stray(tl, jl, exact)
        assert port <= reference + BF16_ADDED, (port, reference)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=tol, atol=tol)
    assert float(tmet["aux"]) == 0.0


def test_embeds_prefill_with_broadcast_positions_equals_token_prefill():
    # Embeddings that are the table's rows of some tokens, at the default
    # (broadcast) positions, give the tokens' logits bit for bit.
    _, tcfg = _cfgs(dtype="float32")
    tm = build_model(tcfg)
    tp = from_reference(_ref_params(), tcfg, device="cpu")
    toks = torch.from_numpy(_tokens((B, 20), 8))
    emb = tp["embed"]["table"][toks.long()]
    with torch.no_grad():
        a = tm.prefill_logits(tp, {"tokens": toks})
        b = tm.prefill_logits(tp, {"embeds": emb})
    assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["embeds", "tokens"])
def test_gradients_and_train_step_match_reference(kind):
    jcfg, tcfg = _cfgs(dtype="float32")
    ref = _ref_params()
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jb, tb = _batches(kind, 4, 24, 3)
    labels = _tokens((4, 24), 4)
    jbatch = {**jb, "labels": jnp.asarray(labels)}
    tbatch = {**tb, "labels": torch.from_numpy(labels)}
    jp = jax.tree.map(jnp.asarray, ref)
    jgrads = jax.grad(lambda p: jm.loss(p, jbatch)[0])(jp)
    tg = from_reference(ref, tcfg, device="cpu")
    for t in jax.tree.leaves(tg):
        t.requires_grad_()
    tm.loss(tg, tbatch)[0].backward()
    grads = to_reference(jax.tree.map(lambda t: t.grad, tg), tcfg)
    for a, b in zip(jax.tree.leaves(grads), jax.tree.leaves(jgrads)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())
    jstep = jax.jit(jmake_train_step(jm, JOptConfig(**OPT)))
    tstep = make_train_step(tm, OptConfig(**OPT))
    tp = from_reference(ref, tcfg, device="cpu")
    jp, jopt, jmet = jstep(jp, jinit_opt(jp), jbatch)
    tp, topt, tmet = tstep(tp, init_opt_state(tp), tbatch)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                   rtol=1e-5, atol=1e-5)
    for a, b in zip(jax.tree.leaves(to_reference(tp, tcfg)),
                    jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5,
                                   atol=PARAM_ATOL)


# -- decode -------------------------------------------------------------------------
def _feeds(kind):
    """Per-step decode batches, NumPy: (B, 1) tokens or (B, 1, d) embeds."""
    if kind == "tokens":
        toks = _tokens((B, STEPS), 5)
        return [{"tokens": toks[:, t:t + 1]} for t in range(STEPS)]
    emb = _embeds((B, STEPS, 64), 5)
    return [{"embeds": emb[:, t:t + 1]} for t in range(STEPS)]


def _ref_decode(dtype, feeds):
    jcfg, _ = _cfgs(dtype=dtype)
    jm, ref = jbuild(jcfg), _ref_params()
    decode = jax.jit(jm.decode)
    js = jm.init_decode_state(ref, B, BUDGET)
    out = []
    for f in feeds:
        jl, js = decode(ref, js, {k: jnp.asarray(v) for k, v in f.items()})
        out.append(jl)
    return out, js


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["tokens", "embeds"])
def test_decode_logits_match_reference_at_every_step(kind, dtype):
    _, tcfg = _cfgs(dtype=dtype)
    tm = build_model(tcfg)
    tp = from_reference(_ref_params(), tcfg, device="cpu")
    ts = tm.init_decode_state(tp, B, BUDGET)
    feeds = _feeds(kind)
    want, js = _ref_decode(dtype, feeds)
    exact = want if dtype == "float32" else _ref_decode("float32", feeds)[0]
    worst = [0.0, 0.0]
    for t, f in enumerate(feeds):
        with torch.no_grad():
            tl, ts = tm.decode(tp, ts, {k: torch.from_numpy(v)
                                        for k, v in f.items()})
        assert tl.shape == (B, 1, 256) and tl.dtype == getattr(torch, dtype)
        if dtype == "float32":
            _close(tl, want[t], 1e-5, f"step {t}")
        else:
            worst = np.maximum(worst, _stray(tl, want[t], exact[t]))
    assert worst[0] <= worst[1] + BF16_ADDED, worst
    assert ts.pos == int(js.pos) == STEPS


def test_embeds_decode_replay_equals_embeds_prefill():
    # Patch embeddings replayed through decode (positions broadcast) give
    # the prefill forward's last logits over the same embeddings.
    _, tcfg = _cfgs(dtype="float32")
    tm = build_model(tcfg)
    tp = from_reference(_ref_params(), tcfg, device="cpu")
    emb = torch.from_numpy(_embeds((B, 12, 64), 9))
    with torch.no_grad():
        ts = tm.init_decode_state(tp, B, 16)
        for t in range(12):
            tl, ts = tm.decode(tp, ts, {"embeds": emb[:, t:t + 1]})
        pre = tm.prefill_logits(tp, {"embeds": emb})
    _close(tl, pre.numpy(), 1e-5)


# -- serving -------------------------------------------------------------------------
def _models():
    jcfg, tcfg = _cfgs(dtype="float32")
    ref = _ref_params()
    return {"ref": (jbuild(jcfg), ref),
            "port": (build_model(tcfg), from_reference(ref, tcfg,
                                                       device="cpu"))}


def test_continuous_tokens_equal_reference_and_oracle(tmp_path):
    n, L, max_new = 3, 14, [4, 6, 5]
    arr = _tokens((n * L,), 6)
    path = str(tmp_path / "prompts.bin")
    write_token_file(path, arr)
    models = _models()
    got = {}
    for pkg, (core, serve) in PKGS.items():
        m, p = models[pkg]
        ck = core.CkIO(num_pes=2)
        fh = ck.open_sync(path, core.FileOptions(num_readers=1))
        ing = serve.RequestIngester(ck, fh, read_meta(path),
                                    core.ServeMetrics(), max_pending=n)
        engine = serve.ModelEngine(m, p, slots=2, seq_budget=L + 6)
        bat = serve.ContinuousBatcher(engine, ing)
        for i in range(n):
            ing.submit(serve.ServeRequest(rid=i, row_start=i * L, num_rows=L,
                                          max_new_tokens=max_new[i]))
        got[pkg] = {r.rid: r.result for r in bat.run()}
        ck.close_sync(fh)
        if pkg == "port":
            oracle = tserve.sequential_oracle(
                engine, [arr[i * L:(i + 1) * L] for i in range(n)], max_new)
    assert got["port"] == got["ref"]
    assert [got["port"][i] for i in range(n)] == oracle
    assert [len(got["port"][i]) for i in range(n)] == max_new


def test_batch_server_tokens_equal_reference():
    prompts = [_tokens((s,), 10 + s) for s in (5, 20, 9)]
    models = _models()
    out = {}
    for pkg, (_, serve) in PKGS.items():
        m, p = models[pkg]
        reqs = [serve.Request(rid=i, prompt=prompts[i], max_new_tokens=3 + i)
                for i in range(3)]
        done = serve.BatchServer(m, p, batch_size=2, bucket=16).serve(reqs)
        out[pkg] = [np.asarray(r.result).tolist() for r in done]
    assert out["port"] == out["ref"]
    assert [len(x) for x in out["port"]] == [3, 4, 5]


# -- drivers -------------------------------------------------------------------------
def test_train_driver_trains_qwen2_vl_on_tokens_on_cpu(tmp_path):
    out = port_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                           "--steps", "2", "--global-batch", "2", "--seq", "32",
                           "--microbatches", "1", "--data",
                           str(tmp_path / "t.bin")])
    assert out["steps"] == 2
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["final_loss"])


def test_serve_driver_refuses_the_arch_as_the_reference_does(tmp_path):
    with pytest.raises(SystemExit, match="token-input archs"):
        tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--data", str(tmp_path / "p.bin")])
