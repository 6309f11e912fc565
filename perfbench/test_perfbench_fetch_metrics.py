"""The input path's per-layer readers (``session_queue_ms``,
``fetch_io_wait_ms``, ``fetch_tasks_ms``, ``fetch_stage_ms``) on hand-made
``SessionMetrics``, on sessions that carry none of the stamps (a program
without them reads nothing, and nothing raises), and in a traced run of a
cell at a smoke size on the CPU."""
import os
from types import SimpleNamespace

import pytest

import harness
import smokecell

HERE = os.path.dirname(os.path.abspath(__file__))
NAMES = ("session_queue_ms", "fetch_io_wait_ms", "fetch_tasks_ms",
         "fetch_stage_ms")


def reader(name):
    return harness.load_module(os.path.join(HERE, "metrics", f"{name}.py"))


def session(t_requested=0.0, t_start=0.0, fetch=None):
    """A ``SessionMetrics`` with the given stamps; ``fetch`` is
    ``(t0, fetch_s, pump_s, parked_s, tasks)``."""
    from repro_torch.core.metrics import SessionMetrics

    m = SessionMetrics()
    m.t_start = t_start
    if t_requested:
        m.record_requested(t_requested)
    if fetch:
        m.record_fetch(*fetch)
    return m


def test_readers_on_made_sessions():
    sessions = [
        session(10.0, 11.5, (12.0, 0.010, 0.008, 0.002, 80)),
        session(10.5, 11.5, (13.0, 0.002, 0.0005, 0.0, 5)),
        session(11.0, 13.0, (14.0, 0.006, 0.003, 0.001, 40)),
        session(12.0, 14.0),      # requested and started, never fetched
        session(),                # not a pipeline session
    ]
    ctx = SimpleNamespace(sessions=sessions)
    got = {n: reader(n).read(ctx) for n in NAMES}
    assert got["session_queue_ms"] == pytest.approx(
        (1.5 + 1.0 + 2.0 + 2.0) / 4 * 1e3)
    assert got["fetch_io_wait_ms"] == pytest.approx((2 + 0 + 1) / 3)
    assert got["fetch_tasks_ms"] == pytest.approx((6 + 0.5 + 2) / 3)
    assert got["fetch_stage_ms"] == pytest.approx((2 + 1.5 + 3) / 3)
    # the three parts of a fetch add up to the mean fetch
    assert (got["fetch_io_wait_ms"] + got["fetch_tasks_ms"]
            + got["fetch_stage_ms"]) == pytest.approx((10 + 2 + 6) / 3)


@pytest.mark.parametrize("sessions", [
    [],
    "unstamped",
    "older",
], ids=["no sessions", "sessions without stamps", "a program without them"])
def test_readers_read_nothing_without_stamps(sessions):
    if sessions == "unstamped":
        sessions = [session(t_start=3.0), session()]
    elif sessions == "older":
        # a session counter of a program that has no such stamps at all
        sessions = [SimpleNamespace(t_start=3.0, t_last_read=3.1,
                                    pooled=False)]
    ctx = SimpleNamespace(sessions=sessions)
    for n in NAMES:
        assert reader(n).read(ctx) is None, n


def test_traced_run_reports_the_fetch_metrics(tmp_path):
    with smokecell.few_threads():
        root = smokecell.make_root(str(tmp_path))
        r = harness.run("phi4-mini.train.b8s2048", 2**31 + 5, 0.5, True,
                        device="cpu", root=root)
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NAMES) <= set(m)
    assert all(m[n] >= 0 for n in NAMES)
    assert r["failed"] == 0
    assert r["checks"]["input_tokens_wrong"] == {"value": 0, "limit": 0}
