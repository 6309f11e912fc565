"""The port's train substrate and driver against the reference's.

One microbatched AdamW step from the same (converted) params and batch
gives the same loss and new params in float32 to rtol/atol 1e-5: the same
math, summed in another order. The drivers run the smoke config on the
same corpus; their ``ingest`` blocks must be identical (losses differ,
since each driver initializes its own params)."""
import contextlib
import io
import json
import os
import shutil
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import smoke_config as jsmoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.train import OptConfig as JOptConfig  # noqa: E402
from repro.train import init_opt_state as jinit_opt  # noqa: E402
from repro.train import lr_at as jlr_at  # noqa: E402
from repro.train import grad_compress as grad_compress_ref  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    from_reference,
    reference_leaf_groups,
    to_reference,
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.train import (  # noqa: E402
    OptConfig,
    grad_compress,
    init_opt_state,
    leaves,
    lr_at,
    make_train_step,
    restore_tree,
)

OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=10)


def test_lr_schedule_matches_reference():
    for step in range(0, 14):
        np.testing.assert_allclose(
            lr_at(OptConfig(**OPT), step),
            float(jlr_at(JOptConfig(**OPT), jnp.asarray(step))), rtol=1e-6)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    jcfg = jsmoke(jget_config("phi4-mini-3.8b")).replace(dtype="float32")
    tcfg = smoke_config(get_config("phi4-mini-3.8b")).replace(dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_reference(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, size=(4, 32)).astype(np.int32)
    labels = rng.integers(0, 256, size=(4, 32)).astype(np.int32)
    jstep = jax.jit(jmake_train_step(jm, JOptConfig(**OPT),
                                     num_microbatches=microbatches))
    jopt = jinit_opt(jp)
    tstep = make_train_step(build_model(tcfg), OptConfig(**OPT),
                            num_microbatches=microbatches)
    topt = init_opt_state(tp)
    for _ in range(2):
        jp, jopt, jm_ = jstep(jp, jopt, {"tokens": jnp.asarray(tokens),
                                         "labels": jnp.asarray(labels)})
        tp, topt, tm_ = tstep(tp, topt, {"tokens": torch.from_numpy(tokens),
                                         "labels": torch.from_numpy(labels)})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=1e-5, atol=1e-5)
    assert topt["step"] == int(jopt["step"]) == 2
    got = to_reference(tp, tcfg)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)
    mu = to_reference(topt["mu"], tcfg)
    for a, b in zip(jax.tree.leaves(mu), jax.tree.leaves(jopt["mu"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


def _as_tree(like, flat):
    """``flat`` (tensors in ``leaves(like)`` order) in ``like``'s structure."""
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [go(v) for v in t]
        return next(it)

    return go(like)


@pytest.mark.parametrize("variant", ["bf16", "int8_ef", "master"])
def test_train_step_variants_match_reference(variant):
    """Gradient compression and master weights from the same params and
    batch, at the step test's tolerance (rtol/atol 1e-5), two steps.
    ``int8_ef`` takes one: a grad at a rounding tie of the quantizer (the
    packages sum in other orders) may round either way, which moves its
    residual by one scale, from +s/2 to -s/2; such ties are told apart and
    counted."""
    rtol, atol = 1e-5, 1e-5
    jcfg = jsmoke(jget_config("phi4-mini-3.8b")).replace(dtype="float32")
    tcfg = smoke_config(get_config("phi4-mini-3.8b")).replace(dtype="float32")
    master = variant == "master"
    compression = None if master else variant
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = from_reference(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, size=(4, 32)).astype(np.int32)
    labels = rng.integers(0, 256, size=(4, 32)).astype(np.int32)
    jstep = jax.jit(jmake_train_step(jm, JOptConfig(**OPT),
                                     compression=compression))
    tstep = make_train_step(build_model(tcfg), OptConfig(**OPT),
                            compression=compression)
    jopt = jinit_opt(jp, master_weights=master)
    topt = init_opt_state(tp, master_weights=master)
    jef = grad_compress_ref.init_ef_state(jp)
    tef = grad_compress.init_ef_state(leaves(tp))
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "labels": torch.from_numpy(labels)}
    for _ in range(1 if compression == "int8_ef" else 2):
        if compression == "int8_ef":
            jp, jopt, jm_, jef = jstep(jp, jopt, jbatch, jef)
            tp, topt, tm_, tef = tstep(tp, topt, tbatch, tef)
        else:
            jp, jopt, jm_ = jstep(jp, jopt, jbatch)
            tp, topt, tm_ = tstep(tp, topt, tbatch)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm_[key]), float(jm_[key]),
                                       rtol=rtol, atol=atol)
    f32 = lambda tree: [np.asarray(a) for a in jax.tree.leaves(tree)]  # noqa: E731
    port = lambda tree: jax.tree.leaves(to_reference(tree, tcfg))  # noqa: E731
    trees = [(topt["mu"], jopt["mu"]), (topt["nu"], jopt["nu"]), (tp, jp)]
    if master:
        trees.append((topt["master"], jopt["master"]))
        assert set(topt) == set(jopt) == {"mu", "nu", "master", "step"}
        for p, m in zip(leaves(tp), leaves(topt["master"])):
            assert torch.equal(p, m) and p.data_ptr() != m.data_ptr()
    for a_tree, b_tree in trees:
        for a, b in zip(port(a_tree), f32(b_tree)):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    if compression == "int8_ef":
        groups = reference_leaf_groups(tp, tcfg)
        assert grad_compress.compressed_bytes(leaves(tp), "int8", groups) == \
            grad_compress_ref.compressed_bytes(jp, "int8")
        ties = 0
        for a, b in zip(port(_as_tree(tp, tef)), f32(jef)):
            off = ~np.isclose(a, b, rtol=rtol, atol=atol)
            # a tie: the residual is at the half-scale, with its sign flipped
            np.testing.assert_allclose(a[off], -b[off], rtol=1e-3)
            assert (np.abs(b[off]) >= 0.99 * np.abs(b).max()).all()
            ties += int(off.sum())
        assert ties <= 1e-3 * sum(x.size for x in f32(jef))


def test_master_weights_beat_bf16_drift_as_the_reference():
    """bf16 params with fp32 masters (the reference's test): the masters
    accumulate 50 small updates that bf16 params alone would round away;
    both packages give the same masters and the same bf16 params."""
    from repro.train import adamw_update as jadamw

    from repro_torch.train import adamw_update

    cfg = dict(peak_lr=1e-3, warmup_steps=1, decay_steps=10**6,
               weight_decay=0.0, grad_clip=0)
    jw = {"w": jnp.full((8,), 100.0, jnp.bfloat16)}
    js_ = jinit_opt(jw, master_weights=True)
    tw = {"w": torch.full((8,), 100.0, dtype=torch.bfloat16)}
    ts = init_opt_state(tw, master_weights=True)
    plain = {"w": torch.full((8,), 100.0, dtype=torch.bfloat16)}
    ps = init_opt_state(plain)
    for _ in range(50):
        jw, js_, _ = jadamw({"w": jnp.ones((8,), jnp.float32)}, js_, jw,
                            JOptConfig(**cfg))
        tw, ts, _ = adamw_update([torch.ones(8)], ts, tw, OptConfig(**cfg))
        plain, ps, _ = adamw_update([torch.ones(8)], ps, plain, OptConfig(**cfg))
    drift = float((ts["master"]["w"] - 100.0).abs().mean())
    assert drift > 0.04                      # ~50 * 1e-3 kept by the master
    assert torch.equal(plain["w"], torch.full((8,), 100.0,
                                              dtype=torch.bfloat16))
    np.testing.assert_allclose(ts["master"]["w"].numpy(),
                               np.asarray(js_["master"]["w"]), rtol=1e-6)
    assert tw["w"].dtype == torch.bfloat16
    assert np.array_equal(tw["w"].float().numpy(),
                          np.asarray(jw["w"], np.float32))


def test_grad_compress_matches_reference():
    rng = np.random.default_rng(4)
    shapes = [(256,), (7, 33), (3, 5, 64), (1,)]
    gs = [rng.standard_normal(s).astype(np.float32) * 10.0 ** -i
          for i, s in enumerate(shapes)]
    gs.append(np.zeros((9,), np.float32))              # scale floor 1e-12
    gs.append(np.array([0.5, -1.5, 2.5, 127.0], np.float32) / 127.0 * 3)
    for g in gs:
        q, s = grad_compress.quantize_int8(torch.from_numpy(g))
        jq, js = grad_compress_ref.quantize_int8(jnp.asarray(g))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(),
                                                        np.asarray(jq))
        assert abs(float(s) - float(js)) <= np.spacing(np.float32(js))
        np.testing.assert_array_equal(
            grad_compress.dequantize_int8(q, s).numpy(),
            np.asarray(grad_compress_ref.dequantize_int8(jq, js)))
    # error feedback over steps, and its residual bounded as the reference's
    tg = [torch.from_numpy(g) for g in gs]
    jg = {str(i): jnp.asarray(g) for i, g in enumerate(gs)}
    tef = grad_compress.init_ef_state(tg)
    jef = grad_compress_ref.init_ef_state(jg)
    applied = [torch.zeros_like(g) for g in tg]
    for _ in range(20):
        tqs, tdeq, tef = grad_compress.ef_compress(tg, tef)
        jqs, jdeq, jef = grad_compress_ref.ef_compress(jg, jef)
        for i, ((q, _), d) in enumerate(zip(tqs, tdeq)):
            applied[i] += d
            assert np.array_equal(q.numpy(), np.asarray(jqs[str(i)][0]))
            np.testing.assert_allclose(d.numpy(), np.asarray(jdeq[str(i)]),
                                       rtol=1e-6, atol=1e-12)
    for g, a in zip(tg, applied):
        assert float((a - 20 * g).abs().max()) <= float(g.abs().max())
    for scheme in ("fp32", "bf16", "int8"):
        assert grad_compress.compressed_bytes(tg, scheme) == \
            grad_compress_ref.compressed_bytes(jg, scheme)
    with pytest.raises(ValueError):
        grad_compress.compressed_bytes(tg, "fp8")
    bf = grad_compress.from_bf16(grad_compress.to_bf16(tg))
    for a, g in zip(bf, gs):
        b = np.asarray(grad_compress_ref.from_bf16(
            grad_compress_ref.to_bf16(jnp.asarray(g))))
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)


def _reference_driver(argv):
    from repro.launch import train as jtrain

    out = io.StringIO()
    old = sys.argv
    sys.argv = ["repro.launch.train", *argv]
    try:
        with contextlib.redirect_stdout(out):
            jtrain.main()
    finally:
        sys.argv = old
    text = out.getvalue()
    return json.loads(text[text.rindex("\n{\n") + 1:])


@pytest.mark.parametrize("mode", ["--device-ingest", "--streaming"])
def test_driver_ingest_block_matches_reference(tmp_path, mode):
    data = str(tmp_path / "tokens.bin")
    common = ["--smoke", "--steps", "3", "--global-batch", "2", "--seq", "32",
              "--microbatches", "1", "--num-readers", "2", mode,
              "--data", data]
    port = port_train.main([*common, "--device", "cpu",
                            "--ckpt-dir", str(tmp_path / "port_ckpt")])
    ref = _reference_driver([*common, "--ckpt-dir", str(tmp_path / "ckpt")])
    assert port["steps"] == ref["steps"] == 3
    assert port["failures"] == ref["failures"] == 0
    assert port["ingest"] == ref["ingest"]
    assert port["ingest"]["host_permute_bytes"] == 0
    assert np.isfinite(port["first_loss"]) and np.isfinite(port["final_loss"])
    assert (port["stream"] is None) == (ref["stream"] is None)
    if port["stream"] is not None:
        for key in ("splinters_staged", "bytes_staged", "stage_chunks"):
            assert port["stream"][key] == ref["stream"][key]


def test_driver_resume_from_step_4_equals_an_unbroken_run(tmp_path):
    """A 6-step run cut after its step-4 checkpoint, resumed with
    ``--resume``, ends where the unbroken run ends: the same final loss
    and a byte-identical step-6 checkpoint (params, both moments, step).
    The reference reads that file as ``train_state_to_reference`` of the
    port's state."""
    common = ["--smoke", "--steps", "6", "--global-batch", "2", "--seq", "32",
              "--microbatches", "1", "--num-readers", "2", "--device-ingest",
              "--device", "cpu", "--ckpt-every", "2",
              "--data", str(tmp_path / "tokens.bin")]
    full_dir, cut_dir = tmp_path / "full", tmp_path / "cut"
    full = port_train.main([*common, "--ckpt-dir", str(full_dir)])
    assert sorted(os.listdir(full_dir)) == [
        f"step_0000000{s}.ckpt" for s in (2, 4, 6)]
    cut_dir.mkdir()
    shutil.copy(full_dir / "step_00000004.ckpt", cut_dir)
    resumed = port_train.main([*common, "--ckpt-dir", str(cut_dir),
                               "--resume"])
    assert (full["steps"], resumed["steps"]) == (6, 2)
    assert resumed["failures"] == 0
    assert resumed["final_loss"] == full["final_loss"]
    final = (full_dir / "step_00000006.ckpt").read_bytes()
    assert (cut_dir / "step_00000006.ckpt").read_bytes() == final

    from repro.train import restore_tree as jrestore_tree

    tcfg = smoke_config(get_config("phi4-mini-3.8b"))
    params = build_model(tcfg).init(0, device="cpu")
    like = train_state_to_reference(
        {"params": params, "opt": init_opt_state(params)}, tcfg)
    tree, step = restore_tree(str(full_dir / "step_00000006.ckpt"), like)
    state = train_state_from_reference(tree, tcfg, device="cpu")
    jm = jbuild(jsmoke(jget_config("phi4-mini-3.8b")))
    jp = jm.init(jax.random.PRNGKey(0))
    jtree, jstep = jrestore_tree(str(full_dir / "step_00000006.ckpt"),
                                 {"params": jp, "opt": jinit_opt(jp)})
    assert step == jstep == state["opt"]["step"] == 6
    got = jax.tree.leaves(train_state_to_reference(state, tcfg))
    want = jax.tree.leaves(jtree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a = np.asarray(a, np.int32) if isinstance(a, int) else a.numpy()
        assert a.dtype == b.dtype and a.tobytes() == np.asarray(b).tobytes()


def test_driver_layers_cuts_the_depth(tmp_path, capsys):
    out = port_train.main(["--smoke", "--layers", "1", "--steps", "1",
                           "--global-batch", "2", "--seq", "32",
                           "--microbatches", "1", "--device", "cpu",
                           "--data", str(tmp_path / "tokens.bin"),
                           "--ckpt-dir", str(tmp_path / "ckpt")])
    smoke = smoke_config(get_config("phi4-mini-3.8b"))
    assert smoke.num_layers != 1
    assert f"layers=1 d={smoke.d_model} " in capsys.readouterr().out
    assert out["steps"] == 1 and np.isfinite(out["final_loss"])


def test_driver_bf16_compression_runs(tmp_path):
    out = port_train.main(["--smoke", "--steps", "2", "--global-batch", "2",
                           "--seq", "32", "--microbatches", "1",
                           "--device", "cpu", "--compression", "bf16",
                           "--data", str(tmp_path / "tokens.bin"),
                           "--ckpt-dir", str(tmp_path / "ckpt")])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])


class _Exec(Exception):
    pass


@pytest.mark.parametrize("flag", [["--tuned-env"]])
def test_driver_flags_of_later_slices_raise(flag, monkeypatch):
    """``--tuned-env`` is carried now: the driver re-executes itself once
    through ``scripts/env.sh`` as ``-m repro_torch.launch.train`` with the
    same arguments (the exec is intercepted here and raises), and runs on
    where ``CKIO_TUNED_ENV`` says the environment is already applied."""
    seen = []

    def execvpe(file, args, env):
        seen.append((file, args, env))
        raise _Exec

    monkeypatch.setattr(port_train.os, "execvpe", execvpe)
    monkeypatch.delenv("CKIO_TUNED_ENV", raising=False)
    argv = ["--smoke", "--device", "cpu", *flag]
    with pytest.raises(_Exec):
        port_train.main(argv)
    (file, args, env), = seen
    assert file == "bash" and args[:2] == ["bash", "-c"]
    assert args[2].startswith('source "') and "scripts/env.sh" in args[2]
    assert args[3:] == [sys.executable, "-m", "repro_torch.launch.train",
                        *argv]
    assert env["PYTHONPATH"].split(":")[0].endswith("src")
    monkeypatch.setenv("CKIO_TUNED_ENV", "1")
    with pytest.raises(SystemExit):      # no exec: on to the parser's checks
        port_train.main([*argv, "--numa-pin"])
    assert len(seen) == 1


def test_driver_service_runs_on_the_pool(tmp_path):
    """``--service`` runs (it raised before the reader service slice): it
    implies the process backend, every session that read bytes ran on the
    pool, and the summary carries the service's counters
    (tests/test_torch_service.py holds batches and losses against the
    thread backend)."""
    out = port_train.main(["--smoke", "--steps", "2", "--global-batch", "2",
                           "--seq", "32", "--microbatches", "1", "--device",
                           "cpu", "--device-ingest", "--num-readers", "2",
                           "--max-workers", "2", "--service",
                           "--pool-workers", "2",
                           "--data", str(tmp_path / "tokens.bin"),
                           "--ckpt-dir", str(tmp_path / "ck")])
    assert out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert out["read"]["pooled_sessions"] >= 2
    assert out["read"]["workers"][1] == 2
    svc = out["service"]
    assert svc["workers_spawned"] == 2 and svc["completed"] >= 2
    assert svc["sessions_failed"] == 0 and svc["rejected"] == 0


@pytest.mark.parametrize("flags", [
    ["--topology", "auto"],
    ["--topology", "auto", "--numa-pin", "--placement", "domain_spread"],
    ["--topology", "2", "--placement", "near_consumers"],
])
def test_driver_numa_flags_run(tmp_path, flags):
    """``--topology`` / ``--numa-pin`` run (they raised before the NUMA
    slice): the batches are the plain run's, and the summary's locality
    block counts every delivered byte as same- or cross-domain."""
    argv = ["--smoke", "--steps", "2", "--global-batch", "2", "--seq", "32",
            "--microbatches", "1", "--device", "cpu", "--device-ingest",
            "--num-readers", "2", "--data", str(tmp_path / "tokens.bin"),
            "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "100"]
    plain, want = _driver_batches(argv)
    out, got = _driver_batches([*argv, *flags])
    assert plain["locality"] is None
    for (xg, yg), (xw, yw) in zip(got, want, strict=True):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)
    loc = out["locality"]
    assert loc["same_domain_bytes"] + loc["cross_domain_bytes"] > 0
    assert loc["prefault_pages"] > 0
    if "--numa-pin" in flags:
        assert loc["pinned_threads"] + loc["pin_failures"] > 0


def test_driver_numa_pin_needs_a_topology(capsys):
    with pytest.raises(SystemExit):
        port_train.main(["--smoke", "--device", "cpu", "--numa-pin"])
    assert "--numa-pin requires --topology" in capsys.readouterr().err


def _driver_batches(argv):
    """The driver's summary and the batches ``get_batch_device`` gave it."""
    from repro_torch.data import pipeline as tpipeline

    batches = []
    orig = tpipeline.CkIOPipeline.get_batch_device

    def recorded(self, step, *a, **kw):
        x, y = orig(self, step, *a, **kw)
        batches.append((x.numpy().copy(), y.numpy().copy()))
        return x, y

    tpipeline.CkIOPipeline.get_batch_device = recorded
    try:
        return port_train.main(argv), batches
    finally:
        tpipeline.CkIOPipeline.get_batch_device = orig


def test_driver_adaptive_splinters_runs(tmp_path):
    """``--adaptive-splinters`` sizes each session's splinters through the
    Director's SplinterSizer; the batches are the plain run's."""
    common = ["--smoke", "--steps", "4", "--global-batch", "2", "--seq", "32",
              "--microbatches", "1", "--num-readers", "2", "--device", "cpu",
              "--streaming", "--data", str(tmp_path / "tokens.bin")]
    plain, want = _driver_batches([*common, "--ckpt-dir",
                                   str(tmp_path / "a")])
    out, got = _driver_batches([*common, "--adaptive-splinters",
                                "--ckpt-dir", str(tmp_path / "b")])
    assert out["steps"] == 4 and np.isfinite(out["final_loss"])
    assert len(got) == len(want) == 4
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)
    assert out["read"]["submit_backend"] == ["blocking"]
    assert out["read"]["bytes_read"] == plain["read"]["bytes_read"]


def test_driver_direct_io_runs(tmp_path):
    """``--direct-io`` on the driver's single-file corpus: windows of 66
    tokens start off the block grid, so each session starts at the block
    below its window; the batches are the buffered run's."""
    from repro_torch.io.posix import supports_direct_io

    data = str(tmp_path / "tokens.bin")
    common = ["--smoke", "--steps", "3", "--global-batch", "2", "--seq", "32",
              "--microbatches", "1", "--num-readers", "2", "--device", "cpu",
              "--device-ingest", "--data", data]
    _, want = _driver_batches([*common, "--ckpt-dir", str(tmp_path / "a")])
    if not supports_direct_io(data):
        pytest.skip("the filesystem under the test's tmp dir refuses O_DIRECT")
    out, got = _driver_batches([*common, "--direct-io", "--queue-depth", "4",
                                "--ckpt-dir", str(tmp_path / "b")])
    assert out["steps"] == 3 and np.isfinite(out["final_loss"])
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)
    read = out["read"]
    assert read["direct_io"] == [True] and read["direct_tail_reads"] > 0
    assert read["inflight_hwm"][1] <= 4
