"""``correct`` comes out false when the timed path is broken underneath
(the harness's look for a card skipped, the rest of a run driven on the
CPU at a smoke size): a step that leaves the state unchanged, half of each
microbatch left out with the mean over the rest, a token altered where
the pipeline produces it. One chip, so there is no exchange to leave out.
And the control, the reference in float8 in the program's place, fails
the cell's limits."""
import pytest
import torch

import compare
import control
import harness
import smokecell

CELLS = ["phi4-mini.train.b8s2048", "falcon-mamba.train.b8s2048",
         "falcon-mamba.train.b8s2048.shards3-pool"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with smokecell.few_threads():
        yield smokecell.make_root(str(tmp_path_factory.mktemp("smoke")))


def _state_unchanged(monkeypatch):
    import repro_torch.train.train_step as ts

    def frozen(grads, opt_state, params, cfg):
        return params, opt_state, {"lr": 0.0, "grad_norm": torch.zeros(())}
    monkeypatch.setattr(ts, "adamw_update", frozen)


def _half_batch(monkeypatch):
    from repro_torch.models.model_zoo import Model

    orig = Model.loss

    def half(self, params, batch):
        return orig(self, params, {k: v[:v.shape[0] // 2]
                                   for k, v in batch.items()})
    monkeypatch.setattr(Model, "loss", half)


def _token_altered(monkeypatch):
    from repro_torch.data.pipeline import CkIOPipeline

    orig = CkIOPipeline.get_batch_device

    def altered(self, step, *a, **kw):
        x, y = orig(self, step, *a, **kw)
        x = x.clone()
        x[0, 0] = (x[0, 0] + 1) % 256
        return x, y
    monkeypatch.setattr(CkIOPipeline, "get_batch_device", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    r = harness.run(cell, 2**31 + 3, 0.1, False, device="cpu", root=root)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", CELLS[:2])
def test_the_control_is_not_correct(root, cell):
    spec = harness.load_spec(cell, root)
    for seed in (1, 2, 2**31 + 5):
        got = {r["run"]: r for r in control.readings(cell, seed, "cpu", root)}
        read = {k: {"value": got["control"][k]} for k in compare.NAMES}
        ok, checks = compare.judge(read, spec.limits)
        assert not ok, checks
