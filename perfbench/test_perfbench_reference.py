"""The plain reference against the port at a smoke size, in fp32: the
loss, every leaf's gradient and one AdamW step on the same weights and
batch, in each cell and in a configuration whose layers mix kinds; and its
scan's gradient by finite differences. The test imports both; the
reference itself imports nothing of the port."""
import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import harness
import smokecell
import traffic as traffic_gen
import weights
from reference import model as ref_model

EXISTING = ["phi4-mini.train.b8s2048", "falcon-mamba.train.b8s2048"]
CELLS = EXISTING + [f"{smokecell.HYBRID}.train"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The smoke root with the mixed configuration added as files; the
    registry knows it while the module's tests run."""
    from repro_torch.configs import registry

    with smokecell.few_threads(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(registry, "get_config",
                   smokecell.with_hybrid(registry.get_config))
        root = smokecell.make_root(str(tmp_path_factory.mktemp("smoke")))
        smokecell.add_hybrid_cell(root)
        yield root


def _setup(root, cell, seed=5):
    from repro_torch.models import build_model
    from repro_torch.train import OptConfig, make_train_step

    spec = harness.load_spec(cell, root)
    cfg = harness.port_config(spec).replace(dtype="float32")
    model = build_model(cfg)
    harness.check_layout(spec, model)
    m = harness.reference_model(spec)
    params, _ = weights.make(harness.shape_tree(spec), spec.config["init"],
                             seed, "cpu")
    toks = traffic_gen.make_tokens(spec.traffic, m["vocab_size"], seed)
    x, y = traffic_gen.expected_batch(toks, spec.traffic, 0)
    batch = {"tokens": torch.as_tensor(x), "labels": torch.as_tensor(y)}
    step = make_train_step(model, OptConfig(**spec.traffic["optimizer"]),
                           num_microbatches=spec.traffic["microbatches"])
    return spec, model, m, params, batch, step


@pytest.mark.parametrize("cell", CELLS)
def test_loss_and_gradients_match_the_port(root, cell):
    spec, model, m, params, batch, _ = _setup(root, cell)
    mine = copy.deepcopy(params)
    leaves = [v for _, v in weights.leaf_paths(params)]
    ref_leaves = [v for _, v in weights.leaf_paths(mine)]
    for p in leaves + ref_leaves:
        p.requires_grad_(True)
    port_loss = model.loss(params, batch)[0]
    ref_loss = ref_model.loss_fn(mine, m, batch["tokens"].long(),
                                 batch["labels"].long(), torch.matmul)
    assert float(ref_loss.detach()) == pytest.approx(
        float(port_loss.detach()), rel=1e-5)
    g_port = torch.autograd.grad(port_loss, leaves)
    g_ref = torch.autograd.grad(ref_loss, ref_leaves)
    for (path, _), a, b in zip(weights.leaf_paths(params), g_port, g_ref):
        scale = float(b.abs().max()) or 1.0
        assert float((a - b).abs().max()) <= 1e-4 * scale, path


@pytest.mark.parametrize("cell", CELLS)
def test_adamw_steps_match_the_port(root, cell):
    spec, model, m, params, batch, step = _setup(root, cell)
    from repro_torch.train import init_opt_state

    mine = copy.deepcopy(params)
    paths = [k for k, _ in weights.leaf_paths(params)]
    start = {k: v.clone() for k, v in weights.leaf_paths(params)}
    opt = init_opt_state(params)
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    out = ref_model.train(mine, paths, m, spec.traffic["optimizer"],
                          [(batch["tokens"].long(), batch["labels"].long())] * 2,
                          spec.traffic["microbatches"])
    for k, v in weights.leaf_paths(params):
        change = float((v - start[k]).norm())
        assert out["change"][k] == pytest.approx(change, rel=1e-3, abs=1e-7), k


def test_scan_gradient_by_finite_differences():
    g = torch.Generator().manual_seed(0)
    a = torch.rand(2, 9, 3, 2, generator=g, dtype=torch.float64) * 0.9
    b = torch.randn(2, 9, 3, 2, generator=g, dtype=torch.float64)
    a.requires_grad_(True)
    b.requires_grad_(True)
    assert torch.autograd.gradcheck(ref_model.LinearScan.apply, (a, b))


def test_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(1)
    a = torch.rand(2, 37, 4, 3, generator=g)
    b = torch.randn(2, 37, 4, 3, generator=g)
    h, want = torch.zeros(2, 4, 3), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = ref_model.LinearScan.apply(a, b)
    assert torch.allclose(got, torch.stack(want, 1), rtol=1e-5, atol=1e-6)


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3, 3, 1001)
    q = ref_model._fp8(x)
    rel = ((q - x).abs() / x.abs().clamp_min(1e-3))[x.abs() > 0.05]
    assert 0.01 < float(rel.max()) <= 2.0 ** -4 + 1e-6
    assert np.isclose(float(q.abs().max()), 3.0)


@pytest.mark.parametrize("cell", CELLS)
def test_layer_recompute_changes_no_bit(root, cell, monkeypatch):
    """The reference recomputes each layer in the backward pass to fit a
    deep stack; the loss and every gradient are those of the plain pass."""
    spec, _, m, params, batch, _ = _setup(root, cell)
    leaves = [v for _, v in weights.leaf_paths(params)]
    for p in leaves:
        p.requires_grad_(True)
    tok, lab = batch["tokens"].long(), batch["labels"].long()

    def loss_and_grads():
        loss = ref_model.loss_fn(params, m, tok, lab, torch.matmul)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss, grads = loss_and_grads()
    monkeypatch.setattr(ref_model, "checkpoint",
                        lambda fn, *a, use_reentrant: fn(*a))
    plain_loss, plain_grads = loss_and_grads()
    assert torch.equal(loss, plain_loss)
    for a, b in zip(grads, plain_grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell", EXISTING)
def test_a_kind_reads_as_its_one_entry_schedule(root, cell):
    """A file's single ``kind`` and the same file with ``schedule`` giving
    that kind alone: the same tree and the same loss and gradients, bit
    for bit."""
    spec = harness.load_spec(cell, root)
    other = SimpleNamespace(**vars(spec))
    other.config = copy.deepcopy(spec.config)
    m = other.config["model"]
    m["schedule"] = [m.pop("kind")]
    assert spec.reference.param_shapes(harness.reference_model(spec)) == \
        other.reference.param_shapes(harness.reference_model(other))
    toks = traffic_gen.make_tokens(spec.traffic,
                                   harness.reference_model(spec)["vocab_size"],
                                   3)
    x, y = traffic_gen.expected_batch(toks, spec.traffic, 0)
    tok, lab = torch.as_tensor(x).long(), torch.as_tensor(y).long()
    got = []
    for s in (spec, other):
        params, _ = weights.make(harness.shape_tree(s), s.config["init"], 3,
                                 "cpu")
        leaves = [v.requires_grad_(True)
                  for _, v in weights.leaf_paths(params)]
        loss = s.reference.loss_fn(params, harness.reference_model(s), tok,
                                   lab, torch.matmul)
        got.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    (loss_a, grads_a), (loss_b, grads_b) = got
    assert torch.equal(loss_a, loss_b)
    assert len(grads_a) == len(grads_b)
    for a, b in zip(grads_a, grads_b):
        assert torch.equal(a, b)
