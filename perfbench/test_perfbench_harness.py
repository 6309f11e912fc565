"""The harness on the CPU at a smoke size: each cell runs end to end with
its metrics and checks; a cell, a traffic mix and a metric added as files
are found by name, and so are a configuration whose layers mix kinds and
one that brings its own reference; the trace reader's arithmetic on a
made-up trace."""
import json
import os
import shutil

import pytest

import control
import harness
import smokecell
import tracereader

CELLS = ["phi4-mini.train.b8s2048", "falcon-mamba.train.b8s2048",
         "falcon-mamba.train.b8s2048.shards3-pool"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    with smokecell.few_threads():
        yield smokecell.make_root(str(tmp_path_factory.mktemp("smoke")))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_cpu(root, cell):
    r = harness.run(cell, 2**31 + 11, 0.3, False, device="cpu", root=root)
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"setup_s", "train_tokens_per_s",
                                 "step_ms_p90"}
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert r["checks"]["input_tokens_wrong"] == {"value": 0, "limit": 0}
    for c in r["checks"].values():
        assert c["value"] == c["value"]          # a number, not NaN


def test_traced_run_reads_its_per_layer_metrics(root):
    cell = "falcon-mamba.train.b8s2048.shards3-pool"
    r = harness.run(cell, 7, 0.3, True, device="cpu", root=root)
    # no device here: the device readings find nothing and are left out
    assert {"input_wait_ms", "ckio_session_ms", "service_checkout_ms",
            "mfu"} <= set(r["metrics"])
    assert not {"device_idle", "scan_fwd_roofline"} & set(r["metrics"])
    assert r["device"]["busy_s"] == 0.0


def test_a_cell_and_a_metric_added_as_files_are_found(root, tmp_path):
    new = str(tmp_path / "added")
    shutil.copytree(root, new, ignore=shutil.ignore_patterns("build"))
    data = os.path.join(new, "perfbench")
    with open(os.path.join(data, "traffic", "train.b8s2048.json")) as f:
        t = json.load(f)
    t["seq_len"] = 16
    with open(os.path.join(data, "traffic", "train.short.json"), "w") as f:
        json.dump(t, f)
    with open(os.path.join(data, "metrics", "steps_seen.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.steps)\n")
    shutil.copy(os.path.join(data, "limits", "phi4-mini.train.b8s2048.json"),
                os.path.join(data, "limits", "phi4-mini.train.short.json"))
    with open(os.path.join(new, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "phi4-mini.train.short",
                               "config": "phi4-mini-3.8b",
                               "traffic": "train.short", "chips": 1,
                               "why": "added by a test"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "pipeline",
                               "moves": "train_tokens_per_s",
                               "workloads": ["phi4-mini.train.short"]})
    with open(os.path.join(new, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    spec = harness.load_spec("phi4-mini.train.short", new)
    assert spec.traffic["seq_len"] == 16
    r = harness.run("phi4-mini.train.short", 3, 0.2, True, device="cpu",
                    root=new)
    assert r["metrics"]["steps_seen"]["value"] == r["attempted"]


def _copy_with_hybrid(root, tmp_path, monkeypatch, port=None):
    """A copy of ``root`` whose registry knows the mixed configuration
    (``port``: its port config, by default ``hybrid_port_config()``)."""
    from repro_torch.configs import registry

    monkeypatch.setattr(registry, "get_config",
                        smokecell.with_hybrid(registry.get_config, port))
    new = str(tmp_path / "added")
    shutil.copytree(root, new, ignore=shutil.ignore_patterns("build"))
    return new


def test_a_mixed_configuration_added_as_files_runs_correct(
        root, tmp_path, monkeypatch):
    new = _copy_with_hybrid(root, tmp_path, monkeypatch)
    cell = smokecell.add_hybrid_cell(new)
    spec = harness.load_spec(cell, new)
    m = spec.config["model"]
    assert [k["mixer"] for k in m["schedule"]] == ["mamba"] * 3 + ["attn"]
    # the smoke cut reaches both families' widths with no list of them
    assert (m["widths"]["d_model"], m["widths"]["d_inner"],
            m["widths"]["num_kv_heads"]) == (64, 128, 1)
    kinds = [(k["mixer"], k["ffn"])
             for k in harness.reference_model(spec)["schedule"]]
    assert kinds == ([("mamba", "dense")] * 3 + [("attn", "dense")]) * 2
    r = harness.run(cell, 2**31 + 13, 0.3, False, device="cpu", root=new)
    assert r["correct"] is True, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0


COUNTED = '''"""model.py's reference, each call written to calls.log."""
import os

from reference import model

LOG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "calls.log")


def _count(name):
    with open(LOG, "a") as f:
        f.write(name + "\\n")


def param_shapes(m):
    _count("param_shapes")
    return model.param_shapes(m)


def loss_fn(*a):
    _count("loss_fn")
    return model.loss_fn(*a)


def train(*a, **kw):
    _count("train")
    return model.train(*a, loss_fn=loss_fn, **kw)
'''


def test_a_configurations_own_reference_is_the_one_used(
        root, tmp_path, monkeypatch):
    new = _copy_with_hybrid(root, tmp_path, monkeypatch)
    ref_dir = os.path.join(new, "perfbench", "reference")
    with open(os.path.join(ref_dir, "counted.py"), "w") as f:
        f.write(COUNTED)
    conf = dict(smokecell.hybrid_file(), name="hybrid-counted",
                reference="counted")
    cell = smokecell.add_hybrid_cell(new, conf)
    log = os.path.join(ref_dir, "calls.log")

    def calls():
        with open(log) as f:
            names = f.read().split()
        return {k: names.count(k) for k in ("param_shapes", "train",
                                            "loss_fn")}

    spec = harness.load_spec(cell, new)
    assert spec.reference.__file__ == os.path.join(ref_dir, "counted.py")
    r = harness.run(cell, 2**31 + 17, 0.2, False, device="cpu", root=new)
    assert r["correct"] is True, r["checks"]
    # the program's tree, its layout check and the reference's own tree;
    # one reference run of compared_steps x microbatches losses
    steps, micro = spec.compared_steps, spec.traffic["microbatches"]
    assert calls() == {"param_shapes": 3, "train": 1,
                       "loss_fn": steps * micro}
    # the control's readings: the reference, the control, the half batch
    control.readings(cell, 2**31 + 17, "cpu", new)
    assert calls() == {"param_shapes": 6, "train": 4,
                       "loss_fn": 4 * steps * micro}


def test_a_layer_schedule_that_differs_is_refused_and_named(
        root, tmp_path, monkeypatch):
    from repro_torch.configs.base import ATTN, DENSE, MAMBA, LayerSpec

    ssm, attn = LayerSpec(mixer=MAMBA, ffn=DENSE), LayerSpec(mixer=ATTN,
                                                             ffn=DENSE)
    port = smokecell.hybrid_port_config().replace(
        block_pattern=(ssm, attn, ssm, ssm))
    new = _copy_with_hybrid(root, tmp_path, monkeypatch, port)
    spec = harness.load_spec(smokecell.add_hybrid_cell(new), new)
    with pytest.raises(SystemExit) as e:
        harness.port_config(spec)
    assert "'layer 1': ('attn+dense', 'mamba+dense')" in str(e.value)
    assert "layer 3" not in str(e.value)


def test_unknown_cell_is_refused(root):
    with pytest.raises(SystemExit):
        harness.load_spec("no-such.cell", root)


def test_a_width_that_differs_from_the_file_is_refused(root, tmp_path):
    spec = harness.load_spec("phi4-mini.train.b8s2048", root)
    spec.config["model"]["widths"]["d_model"] += 1
    with pytest.raises(SystemExit, match="differs from the file"):
        harness.port_config(spec)


def _made_up_trace():
    step = tracereader.STEP
    host = [(0, 100, step), (100, 200, step), (200, 300, step),
            (100, 130, "perfbench.input"), (130, 190, "perfbench.compute"),
            (190, 200, "perfbench.loss_read"),
            (200, 240, "perfbench.input"), (240, 290, "perfbench.compute"),
            (290, 300, "perfbench.loss_read"),
            (140, 150, "perfbench.scan_fwd")]
    device = [(0, 90, "warm"), (135, 180, "gemm"), (170, 185, "add"),
              (245, 280, "gemm"), (281, 290, "copy")]
    return {"device": device, "host": host,
            "calls": {"perfbench.scan_fwd": [(140, 7000.0), (50, 9000.0)]}}


def test_trace_reader_busy_window_and_gaps():
    r = tracereader.reduce(_made_up_trace(), skip_steps=1)
    assert r["window_s"] == pytest.approx(200e-6)
    # union of [135,185], [245,280], [281,290] within [100, 300]
    assert r["busy_s"] == pytest.approx((50 + 35 + 9) * 1e-6)
    gaps = r["breakdown"]["idle_gaps"]
    # 185 .. 245: mostly the next step's input (200 .. 240)
    assert gaps[0] == ["input", pytest.approx(60e-6)]
    assert gaps[1] == ["input", pytest.approx(35e-6)]     # 100 .. 135
    assert gaps[2] == ["loss_read", pytest.approx(10e-6)]  # 290 .. 300
    assert gaps[3] == ["compute", pytest.approx(1e-6)]    # 280 .. 281
    ops = dict(r["breakdown"]["device_ops"])
    assert ops["gemm"] == pytest.approx(80e-6) and "warm" not in ops
    assert r["range_ms"]["perfbench.scan_fwd"] == [7.0]   # the skipped step's call left out


def test_extract_keeps_range_annotations_out_of_the_device_ops():
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, dev, s, e):
        return NS(name=name, device_type=dev, time_range=NS(start=s, end=e))

    prof = NS(events=lambda: [
        ev("perfbench.step", DeviceType.CPU, 0, 100),
        ev("perfbench.compute", DeviceType.CUDA, 5, 95),
        ev("perfbench.scan_fwd", DeviceType.CUDA, 10, 40),
        ev("perfbench.scan_fwd", DeviceType.CPU, 8, 9),
        ev("scan_kernel", DeviceType.CUDA, 12, 40),
        ev("aten::mm", DeviceType.CPU, 50, 60),
    ])
    ex = tracereader.extract(prof, ["perfbench.scan_fwd"])
    assert ex["device"] == [(12, 40, "scan_kernel")]
    assert ex["calls"] == {"perfbench.scan_fwd": [(10, 30)]}
    assert sorted(ex["host"]) == [(0, 100, "perfbench.step"),
                                  (8, 9, "perfbench.scan_fwd")]


def test_trace_reader_without_device_work_reads_nothing():
    ex = _made_up_trace()
    ex["device"] = []
    assert tracereader.reduce(ex) is None


def test_compared_steps_come_from_the_cells_limits(root):
    assert harness.load_spec("phi4-mini.train.b8s2048", root) \
        .compared_steps == harness.COMPARED_STEPS == 3
    assert harness.load_spec("falcon-mamba.train.b8s2048", root) \
        .compared_steps == 2


def test_sets_summary_reads_spreads_and_the_largest_checks():
    import sets

    assert sets.spread([10.0, 10.0, 11.0, 12.0, 12.0]) == pytest.approx(
        (12.0 - 10.0) / 11.0)

    def row(label, trace, rate, gap):
        return {"set": label, "trace": trace, "result": {
            "metrics": {"train_tokens_per_s": {"value": rate}},
            "checks": {"loss_gap": {"value": gap, "limit": 1e-4}},
            "device": {"memory_peak_bytes": int(rate)}}}

    rows = [row("A", 0, 100.0, 1e-5), row("A", 0, 102.0, 3e-5),
            row("B", 0, 101.0, 2e-5), row("B", 0, 103.0, 1e-5),
            row("T", 1, 50.0, 4e-5)]
    out = sets.summary(rows)
    assert any(line.startswith("A train_tokens_per_s: median 101.0")
               for line in out)
    assert "largest loss_gap: 4e-05 (limit 0.0001)" in out
    assert "memory_peak_bytes: largest 103" in out
