"""The port's train substrate and driver against the reference's.

One microbatched AdamW step from the same (converted) params and batch
gives the same loss and new params in float32 to rtol/atol 1e-5: the same
math, summed in another order. The drivers run the smoke config on the
same corpus; their ``ingest`` blocks must be identical (losses differ,
since each driver initializes its own params)."""
import contextlib
import io
import json
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
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import from_reference, to_reference  # noqa: E402
from repro_torch.train import OptConfig, init_opt_state, lr_at, make_train_step  # noqa: E402

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


def test_compression_raises():
    with pytest.raises(NotImplementedError):
        make_train_step(build_model(smoke_config(get_config("phi4-mini-3.8b"))),
                        OptConfig(), compression="bf16")


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
    port = port_train.main([*common, "--device", "cpu"])
    ref = _reference_driver([*common, "--ckpt-dir", str(tmp_path / "ckpt")])
    assert port["steps"] == ref["steps"] == 3
    assert port["ingest"] == ref["ingest"]
    assert port["ingest"]["host_permute_bytes"] == 0
    assert np.isfinite(port["first_loss"]) and np.isfinite(port["final_loss"])
    assert (port["stream"] is None) == (ref["stream"] is None)
    if port["stream"] is not None:
        for key in ("splinters_staged", "bytes_staged", "stage_chunks"):
            assert port["stream"][key] == ref["stream"][key]


@pytest.mark.parametrize("flag", [["--resume"], ["--ckpt-every", "5"],
                                  ["--compression", "bf16"], ["--service"],
                                  ["--topology", "auto"], ["--direct-io"]])
def test_driver_flags_of_later_slices_raise(flag):
    with pytest.raises(NotImplementedError):
        port_train.main(["--smoke", "--device", "cpu", *flag])
