"""The harness on the CPU at a smoke size: each cell runs end to end with
its metrics and checks; a cell, a traffic mix and a metric added as files
are found by name; the trace reader's arithmetic on a made-up trace."""
import json
import os

import pytest

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
    import shutil

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
