"""The benchmark's frozen counts: model FLOPs a step and the fused scan's
bounds at the cells' shapes."""
import json
import os

import pytest

import harness

HERE = os.path.dirname(os.path.abspath(__file__))


def _spec(cell):
    return harness.load_spec(cell)


@pytest.mark.parametrize("cell,flops", [
    ("phi4-mini.train.b8s2048", 1.0495e14),
    ("falcon-mamba.train.b8s2048", 6.75e13),
])
def test_step_flops(cell, flops):
    """The formulas at 4 layers, the depth their numbers were first
    worked out at."""
    spec = _spec(cell)
    got = harness.counts_module(spec, spec.config["name"]).step_flops(
        _at_depth(spec, 4), spec.traffic)
    assert got == pytest.approx(flops, rel=5e-4)


@pytest.mark.parametrize("cell,layers,flops", [
    ("phi4-mini.train.b8s2048", 16, 2.38538e14),
    ("falcon-mamba.train.b8s2048", 20, 2.32856e14),
])
def test_step_flops_at_the_cells_depth(cell, layers, flops):
    spec = _spec(cell)
    m = harness.reference_model(spec)
    assert m["num_layers"] == layers
    got = harness.counts_module(spec, spec.config["name"]).step_flops(
        m, spec.traffic)
    assert got == pytest.approx(flops, rel=1e-5)


def _at_depth(spec, layers):
    return dict(harness.reference_model(spec), num_layers=layers)


def test_falcon_matmul_params():
    spec = _spec("falcon-mamba.train.b8s2048")
    mod = harness.counts_module(spec, "falcon-mamba-7b")
    assert mod.matmul_params(_at_depth(spec, 4)) == 686_817_280
    assert mod.matmul_params(harness.reference_model(spec)) == 2_368_733_184


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_fused_scan_bound(direction):
    spec = _spec("falcon-mamba.train.b8s2048")
    mod = harness.counts_module(spec, "mamba_scan_fused")
    b = mod.bound(direction, 2, 2048, 8192, 16, 256, 2, spec.hw)
    assert b["results"] == pytest.approx(6.71e8, rel=1e-3)
    assert b["bound_ms"] == pytest.approx(0.1605, rel=2e-3)
    assert b["bound_by"] == "operations"
    if direction == "bwd":
        assert b["bytes"] == pytest.approx(0.476e9, rel=2e-3)
        assert b["bytes_ms"] == pytest.approx(0.142, rel=5e-3)
    assert mod.microbatch_bound(direction, harness.reference_model(spec),
                                spec.traffic, spec.hw) == b["bound_ms"]


def test_peaks_are_the_data_sheet():
    with open(os.path.join(HERE, "counts", "h100.json")) as f:
        hw = json.load(f)
    assert hw["bf16_flops_per_s"] == 989e12
    assert hw["hbm_bytes_per_s"] == 3.35e12
    assert hw["sfu_results_per_sm_clock"] * hw["sms"] * hw["sm_clock_hz"] \
        == pytest.approx(4.181e12, rel=1e-3)
