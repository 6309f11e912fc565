"""The port's input path traced from inside (``data/pipeline.py``, "The input
path's own trace"): each step session's phases on its ``SessionMetrics``
(requested, started, last byte read, ready, and the one fetch that consumed
it), the scheduler's parked time, and the profiler-only ``ckio.fetch*`` and
``train.*`` host ranges. Port only: the reference package has none of
these. The ``fetch`` block of ``launch/train.py``'s summary is checked
in ``test_torch_train.py``."""
import contextlib
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.distributed.device_mesh import DeviceMesh  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs.registry import get_config, smoke_config  # noqa: E402
from repro_torch.core import CkIO, FileOptions  # noqa: E402
from repro_torch.core.scheduler import TaskScheduler  # noqa: E402
from repro_torch.data import CkIOPipeline, make_token_file  # noqa: E402
from repro_torch.data import pipeline as pipeline_mod  # noqa: E402
from repro_torch.launch.dryrun import fake_process_group  # noqa: E402
from repro_torch.launch.sharding import NamedSharding, P  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train import OptConfig, init_opt_state, make_train_step  # noqa: E402

B, S = 4, 255
FETCH_RANGES = ("ckio.fetch", "ckio.fetch.pump", "ckio.fetch.stage")
PATHS = ["whole", "streamed", "sharded_whole", "sharded_streamed", "host"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "tokens.bin")
    make_token_file(path, B * (S + 1) * 10, vocab_size=200064, seed=31)
    return path


@contextlib.contextmanager
def _pipe(path, *, streaming=False, sharded=False, delay_model=None):
    """A pipeline over ``path`` and the list its Director's observer fills;
    closed after the block. ``sharded``: a one-rank batch sharding over a
    fake process group."""
    sessions = []
    ck = CkIO(num_pes=2, pes_per_node=2)
    ck.director.add_observer(sessions.append)
    opts = FileOptions(num_readers=2, splinter_bytes=4096,
                       delay_model=delay_model)
    with contextlib.ExitStack() as stack:
        sharding = None
        if sharded:
            stack.enter_context(fake_process_group(1, rank=0))
            mesh = DeviceMesh("cpu", torch.arange(1), mesh_dim_names=("data",))
            sharding = NamedSharding(mesh, P("data", None))
        pipe = CkIOPipeline(path, B, S, ckio=ck, num_consumers=6,
                            file_opts=opts, streaming=streaming,
                            sharding=sharding, device="cpu")
        try:
            yield pipe, sessions
        finally:
            pipe.close()


def _fetch(pipe, kind, step):
    if kind == "host":
        return pipe.get_batch(step)
    return pipe.get_batch_device(step)


def _fetched(sessions):
    """The sessions a fetch consumed, in fetch order."""
    return sorted((m for m in sessions if m.fetch_s), key=lambda m: m.fetch_t0)


@pytest.mark.parametrize("kind", PATHS)
def test_every_fetch_path_stamps_its_session(corpus, kind):
    with _pipe(corpus, streaming="streamed" in kind,
               sharded=kind.startswith("sharded")) as (pipe, sessions):
        for step in range(4):
            _fetch(pipe, kind, step)
    got = _fetched(sessions)
    assert len(got) == 4                       # one fetch a session
    for m in got:
        assert 0 < m.t_requested <= m.t_start <= m.t_last_read <= m.t_ready
        assert m.fetch_t0 + m.fetch_s >= m.t_ready
        assert 0 <= m.fetch_parked_s <= m.fetch_pump_s <= m.fetch_s
        assert m.fetch_tasks >= 0
    for a, b in zip(got, got[1:]):
        assert a.fetch_t0 + a.fetch_s <= b.fetch_t0


def test_sleeping_loop_queues_each_session_to_the_next_fetch(corpus):
    """The scheduler is cooperative and only a fetch pumps it in this loop,
    so a session requested by ``start_step`` (the constructor's, or a
    fetch's lookahead) starts only inside a later fetch, after the 0.2 s of
    "compute" between them. This asserts the behaviour as it is now: a
    change that pumps the scheduler during compute will change it."""
    with _pipe(corpus) as (pipe, sessions):
        for step in range(6):
            time.sleep(0.2)
            pipe.get_batch_device(step)
    got = _fetched(sessions)
    assert len(got) == 6
    queue = [m.t_start - m.t_requested for m in got]
    assert sum(queue) / len(queue) >= 0.2


def test_slow_reader_shows_as_parked_time(corpus):
    with _pipe(corpus, delay_model=lambda reader, sp: 0.02) as (pipe,
                                                                sessions):
        for step in range(2):
            pipe.get_batch_device(step)
    got = _fetched(sessions)
    assert len(got) == 2
    assert got[0].fetch_parked_s > 0


def test_scheduler_counts_parked_time_and_tasks():
    sched = TaskScheduler(num_pes=2)
    done = []
    sched.enqueue(1, done.append, 1)

    def later():
        time.sleep(0.05)
        sched.enqueue(0, done.append, 2)

    t = threading.Thread(target=later)
    t.start()
    sched.run_until(lambda: len(done) == 2, timeout=10)
    t.join(timeout=10)
    assert not t.is_alive()
    assert sched.stats["executed"] == 2
    assert 0.03 <= sched.parked_s <= 5


def test_fetch_ranges_under_the_profiler(corpus):
    """Under ``torch.profiler``, each fetch opens one ``ckio.fetch``, one
    ``ckio.fetch.pump`` and one ``ckio.fetch.stage`` range, the last two
    inside the first; each ``ckio.fetch`` starts at its session's
    ``fetch_t0`` less one offset, constant to 0.2 ms over 8 fetches."""
    with _pipe(corpus) as (pipe, sessions):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for step in range(8):
                pipe.get_batch_device(step)
    ranges = {n: sorted((e.time_range.start, e.time_range.end)
                        for e in prof.events() if e.name == n)
              for n in FETCH_RANGES}
    assert [len(ranges[n]) for n in FETCH_RANGES] == [8, 8, 8]
    for (f0, f1), (p0, p1), (s0, s1) in zip(*ranges.values()):
        assert f0 <= p0 <= p1 <= s0 <= s1 <= f1
    got = _fetched(sessions)
    assert len(got) == 8
    offsets = [m.fetch_t0 * 1e6 - f0
               for m, (f0, _) in zip(got, ranges["ckio.fetch"])]
    assert max(offsets) - min(offsets) <= 200.0        # microseconds


def test_no_range_is_opened_without_a_profiler(corpus, monkeypatch):
    def refuse(name):
        raise AssertionError(f"range {name!r} opened with no profiler")

    monkeypatch.setattr(pipeline_mod, "open_range", refuse)
    with _pipe(corpus, streaming=True) as (pipe, sessions):
        x, _ = pipe.get_batch_device(0)
        pipe.get_batch(1)
    assert x.shape == (B, S)
    assert len(_fetched(sessions)) == 2


def test_train_step_ranges_under_the_profiler():
    cfg = smoke_config(get_config("phi4-mini-3.8b")).replace(dtype="float32")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    opt = init_opt_state(params)
    step = make_train_step(model, OptConfig(peak_lr=1e-3, warmup_steps=2,
                                            decay_steps=10),
                           num_microbatches=4)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, 256, (4, 16)).astype(np.int32))
             for k in ("tokens", "labels")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, opt, batch)
    names = [e.name for e in prof.events()]
    assert names.count("train.microbatch") == 4
    assert names.count("train.update") == 1
