"""The port's process backend (``FileOptions(backend="process")``: reader
worker processes over a shared-memory arena) held against its own thread
backend, bit for bit, and arena bytes against the reference's thread
backend: sessions over a single file and a 3-shard ``FileSet``, blocking
and at queue depth 4, ``O_DIRECT`` where the filesystem allows it;
``CkIOPipeline`` batches in every mode; respawn and reissue after a seeded
crash; ``recovery="none"``, a killed worker and a spawn failure; the opt-in
thread fallback; NUMA placement of the workers; a spawned worker's
imports; the train supervisor and the driver. Every wait is bounded, and
each test leaves none of its own ``ckiot-`` segments behind."""
import os
import re
import signal
import sys
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import CkIO as JCkIO  # noqa: E402
from repro.core import FileOptions as JFileOptions  # noqa: E402
from repro.data import FileSet as JFileSet  # noqa: E402
from repro_torch.core import CkIO, FileOptions, Topology, WorkerCrashed  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.data import CkIOPipeline, FileSet, make_token_file, write_token_shards  # noqa: E402
from repro_torch.io.posix import DirectIOError, supports_direct_io, write_file  # noqa: E402
from repro_torch.ipc.shm import PREFIX, shm_dir  # noqa: E402
from repro_torch.ipc.worker import ExitAfter, StallReader  # noqa: E402

SPLINTER = 128 * 1024
WAIT = 120.0


def _own_segments():
    mark = f"-{os.getpid()}-"
    return sorted(n for n in os.listdir(shm_dir())
                  if n.startswith(PREFIX) and mark in n)


@pytest.fixture(autouse=True)
def no_leftover_segments():
    before = _own_segments()
    yield
    deadline = time.monotonic() + 10
    while _own_segments() != before and time.monotonic() < deadline:
        time.sleep(0.05)             # a supervisor finishing its teardown
    assert _own_segments() == before


@pytest.fixture
def data_file(tmp_path):
    data = np.random.default_rng(20261017).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    path = str(tmp_path / "blob.bin")
    write_file(path, data)
    return path, data


def _proc(**kw):
    base = dict(num_readers=2, splinter_bytes=SPLINTER, backend="process",
                max_workers=2)
    base.update(kw)
    return FileOptions(**base)


def _session_bytes(ck_cls, opts, source, nbytes, offset):
    """One session's bytes through the package's CkIO, and its metrics."""
    ck = ck_cls(num_pes=4)
    if isinstance(source, str):
        fh = ck.open_sync(source, opts)
    else:
        fh = ck.open_fileset_sync(source, opts)
    try:
        sess = ck.start_read_session_sync(fh, nbytes, offset, timeout=WAIT)
        got = bytes(ck.read_view_sync(sess, nbytes, offset, timeout=WAIT))
        m = sess.metrics
        ck.close_read_session_sync(sess)
    finally:
        ck.close_sync(fh)
    return got, m


# -- arena bytes -------------------------------------------------------------------
@pytest.mark.parametrize("direct", [False, True], ids=["buffered", "direct"])
@pytest.mark.parametrize("depth", [0, 4])
@pytest.mark.parametrize("layout", ["file", "shards"])
def test_session_bytes_match_thread_and_reference(tmp_path, data_file,
                                                  layout, depth, direct):
    path, data = data_file
    if layout == "file":
        src, jsrc, want = path, path, data
    else:
        arr = np.frombuffer(data, dtype=np.uint32)
        shards = write_token_shards(str(tmp_path / "sh"), arr,
                                    [65_536, 131_072, 65_536])
        src, jsrc, want = (FileSet.build(shards), JFileSet.build(shards),
                           arr.tobytes())
    kw = dict(num_readers=3, splinter_bytes=SPLINTER, queue_depth=depth,
              direct_io=direct)
    if direct and not supports_direct_io(path):
        for backend in ("thread", "process"):
            with pytest.raises(DirectIOError):
                _session_bytes(CkIO, FileOptions(backend=backend, **kw),
                               src, len(want), 0)
        return
    off, n = 4096, len(want) - 4096 - 17          # a block-aligned start
    got, m = _session_bytes(CkIO, FileOptions(backend="process",
                                              max_workers=2, **kw),
                            src, n, off)
    thread, _ = _session_bytes(CkIO, FileOptions(**kw), src, n, off)
    ref, _ = _session_bytes(JCkIO, JFileOptions(**{
        k: v for k, v in kw.items() if k != "direct_io" or v}), jsrc, n, off)
    assert got == thread == ref == want[off:off + n]
    assert m.workers == 2 and len(set(m.worker_pids)) == 2
    assert os.getpid() not in m.worker_pids and m.worker_attach_s > 0
    assert 0 < m.worker_boot_s < m.worker_attach_s
    assert 0 < m.worker_import_s < m.worker_attach_s
    assert m.bytes_copied == 0 and m.bytes_read == n
    assert not m.recovery.degraded_mode
    if depth:
        # the workers' own report: backend and in-flight high-water mark
        assert m.submit_backend in ("io_uring", "threads")
        assert 1 <= m.inflight_hwm <= depth
    if layout == "shards":
        assert sum(m.shard_bytes.values()) == n and len(m.shard_bytes) == 3
    if direct:
        # the window ends 17 B short of a block: one tail, read buffered
        assert m.direct_io and m.recovery.direct_tail_reads == 1
        assert m.recovery.direct_tail_bytes == 4096 - 17


# -- the pipeline --------------------------------------------------------------------
@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ptok") / "tokens.bin")
    make_token_file(path, 3 * 4 * 257 + 11, vocab_size=200064, seed=3)
    return path


@pytest.mark.parametrize("mode", ["host", "window", "streamed"])
def test_pipeline_batches_match_thread_backend(token_file, mode):
    batches, sessions = {}, {}
    for backend in ("thread", "process"):
        pipe = CkIOPipeline(
            token_file, 4, 256, num_pes=2, num_consumers=6, device="cpu",
            streaming=mode == "streamed",
            file_opts=FileOptions(num_readers=3, splinter_bytes=4096,
                                  backend=backend, max_workers=2))
        seen = []
        pipe.ck.director.add_observer(seen.append)
        out = []
        for step in range(pipe.num_steps):
            if mode == "host":
                x, y = pipe.get_batch(step)
                out.append((np.array(x), np.array(y)))
            else:
                x, y = pipe.get_batch_device(step)
                out.append((x.numpy().copy(), y.numpy().copy()))
        pipe.close()
        batches[backend], sessions[backend] = out, seen
    assert len(batches["process"]) == 3
    for (xp, yp), (xt, yt) in zip(batches["process"], batches["thread"],
                                  strict=True):
        np.testing.assert_array_equal(xp, xt)
        np.testing.assert_array_equal(yp, yt)
    read = [m for m in sessions["process"] if m.bytes_read]
    assert read and all(m.workers and m.bytes_copied == 0 for m in read)


# -- recovery ------------------------------------------------------------------------
SEED = 4          # FaultPlan(4): reader 0 crashes after 2 of its 4 splinters


@pytest.mark.parametrize("mode", ["respawn", "reissue"])
def test_seeded_crash_recovers_bit_equal(data_file, mode):
    path, data = data_file
    plan = FaultPlan(SEED, num_readers=2, num_splinters=8)
    assert (plan.crash_reader, plan.crash_after) == (0, 2)
    got, m = _session_bytes(CkIO, _proc(recovery=mode, fault_plan=plan),
                            path, len(data), 0)
    assert got == data
    r = m.recovery
    assert (r.respawns, r.reissues) == ((1, 0) if mode == "respawn"
                                        else (0, 1))
    assert r.reissued_splinters == 2 and r.reissued_bytes == 2 * SPLINTER
    assert r.recovery_latency_s > 0 and m.bytes_copied == 0


def test_recovery_none_surfaces_worker_crashed(data_file):
    path, data = data_file
    plan = FaultPlan(SEED, num_readers=2, num_splinters=8)
    t0 = time.monotonic()
    with pytest.raises(WorkerCrashed, match=r"reader worker 0 \(pid \d+\) "
                       rf"exited with code {plan.crash_code} before"):
        _session_bytes(CkIO, _proc(fault_plan=plan), path, len(data), 0)
    assert time.monotonic() - t0 < 60


def test_killed_worker_is_named_and_watchdog_recovers(data_file):
    """A worker killed from outside fails the session with a WorkerCrashed
    that names the signal; a stalled one is killed by the watchdog and its
    splinters re-read (recovery="reissue")."""
    path, data = data_file
    ck = CkIO(num_pes=4)
    fh = ck.open_sync(path, _proc(delay_model=StallReader(0, 30.0)))
    try:
        sess = ck.start_read_session_sync(fh, len(data), 0, timeout=WAIT)
        assert sess.readers.wait_attached(timeout=WAIT)
        pids = sess.readers.worker_pids()
        assert len(pids) == 2
        os.kill(pids[0], signal.SIGKILL)
        with pytest.raises(WorkerCrashed, match="signal SIGKILL"):
            ck.read_sync(sess, len(data), 0, timeout=WAIT)
    finally:
        ck.close_sync(fh)
    t0 = time.monotonic()
    got, m = _session_bytes(CkIO, _proc(
        recovery="reissue", worker_watchdog_s=1.0,
        delay_model=StallReader(0, 30.0)), path, len(data), 0)
    assert got == data and time.monotonic() - t0 < 25
    assert m.recovery.watchdog_kills >= 1 and m.recovery.reissues >= 1


def test_pipeline_crash_close_finishes_its_teardown(token_file):
    """A crash in every session of a pipeline: get_batch raises, close
    still stops every session, unmaps the arenas and closes the file, and
    then re-raises a prefetched session's error."""
    pipe = CkIOPipeline(token_file, 4, 256, num_pes=2, device="cpu",
                        file_opts=_proc(splinter_bytes=4096,
                                        worker_fault=ExitAfter(0, code=45)))
    with pytest.raises(WorkerCrashed, match="exited with code 45"):
        pipe.get_batch(0)
    try:
        pipe.close()
    except WorkerCrashed:
        pass
    assert pipe.file.posix.closed


# -- spawn failure and the fallback ------------------------------------------------------
PICKLE_ERROR = r"[Pp]ickl|Can't get local object"


def test_unpicklable_hook_fails_the_start_and_cleans_up(data_file):
    path, data = data_file
    ck = CkIO(num_pes=2)
    fh = ck.open_sync(path, _proc(delay_model=lambda r, sp: 0.0))
    try:
        with pytest.raises(Exception, match=PICKLE_ERROR):
            ck.start_read_session_sync(fh, len(data), 0, timeout=WAIT)
        assert not ck.director.sessions
    finally:
        ck.close_sync(fh)


def test_thread_fallback_is_opt_in_and_warns_once(data_file):
    path, data = data_file
    ck = CkIO(num_pes=2)
    fh = ck.open_sync(path, _proc(fallback_backend="thread",
                                  delay_model=lambda r, sp: 0.0))
    try:
        with warnings.catch_warnings(record=True) as wlog:
            warnings.simplefilter("always")
            for _ in range(2):
                sess = ck.start_read_session_sync(fh, len(data), 0,
                                                  timeout=WAIT)
                assert bytes(ck.read_sync(sess, len(data), 0,
                                          timeout=WAIT)) == data
                assert sess.metrics.recovery.degraded_mode
                assert sess.metrics.workers == 0
                ck.close_read_session_sync(sess)
        msgs = [str(w.message) for w in wlog
                if issubclass(w.category, RuntimeWarning)]
        assert len(msgs) == 1 and "degraded mode" in msgs[0]
        assert re.search(PICKLE_ERROR, msgs[0])
        assert ck.director.recovery.degraded_mode
    finally:
        ck.close_sync(fh)


# -- NUMA placement of the workers ----------------------------------------------------------
def test_workers_pin_and_first_touch_their_stripes(data_file):
    path, data = data_file
    topo = Topology.with_host_cpus(4, pes_per_node=4, domains_per_node=2)
    got, m = _session_bytes(CkIO, _proc(
        num_readers=4, placement="domain_spread", topology=topo,
        numa_pin=True, prefault_arena=True), path, len(data), 0)
    assert got == data
    ck = CkIO(num_pes=4)
    fh = ck.open_sync(path, _proc(num_readers=4, placement="domain_spread",
                                  topology=topo, numa_pin=True,
                                  prefault_arena=True))
    try:
        sess = ck.start_read_session_sync(fh, len(data), 0, timeout=WAIT)
        assert bytes(ck.read_view_sync(sess, len(data), 0,
                                       timeout=WAIT)) == data
        ck.close_read_session_sync(sess)
        loc = ck.director.locality.summary()
    finally:
        ck.close_sync(fh)
    # one pin record and one touch report per worker process
    assert loc["pinned_threads"] + loc["pin_failures"] == 2
    assert loc["prefault_pages"] >= len(data) // 4096
    assert loc["same_domain_bytes"] + loc["cross_domain_bytes"] == len(data)


# -- what a worker imports ----------------------------------------------------------------
PROBE = '''
import sys


class Probe:
    """worker_fault hook: records which top-level packages the worker
    process has loaded when it reads its first splinter."""

    def __init__(self, out):
        self.out = out

    def __call__(self, reader, index):
        with open(self.out, "a") as f:
            f.write(repr(sorted({m.split(".")[0] for m in sys.modules
                                 if m.split(".")[0] in
                                 ("torch", "jax", "repro", "repro_torch")}))
                    + "\\n")
'''


def test_spawned_worker_imports_no_torch(tmp_path, data_file, monkeypatch):
    path, data = data_file
    (tmp_path / "probe_mod.py").write_text(PROBE)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), os.environ.get("PYTHONPATH", "")]))
    import probe_mod

    out = tmp_path / "probe.txt"
    assert "torch" in sys.modules                # the parent has it
    got, m = _session_bytes(CkIO, _proc(worker_fault=probe_mod.Probe(
        str(out))), path, len(data), 0)
    assert got == data and m.workers == 2
    lines = set(out.read_text().split("\n")) - {""}
    assert lines == {"['repro_torch']"}


# -- the supervisor and the driver ------------------------------------------------------------
def test_supervisor_replays_a_terminal_worker_crash(tmp_path, token_file):
    """recovery="none": the WorkerCrashed that get_batch_device raises
    reaches the train supervisor as a reader failure; its input_recover
    hook rebuilds the pipeline and the replay reads the same batch."""
    from repro_torch.train import AsyncCheckpointer, StepSupervisor

    def pipeline(fault):
        return CkIOPipeline(token_file, 4, 256, num_pes=2, device="cpu",
                            file_opts=_proc(num_readers=2, splinter_bytes=4096,
                                            worker_fault=fault))

    pipes = [pipeline(ExitAfter(0))]
    want = CkIOPipeline(token_file, 4, 256, num_pes=2, device="cpu")
    expect = [want.get_batch_device(s)[0].sum().item() for s in range(3)]
    want.close()

    def recover(step):
        try:
            pipes[-1].close()
        except WorkerCrashed:        # the prefetched session's, after close
            pass
        assert pipes[-1].file.posix.closed
        pipes.append(pipeline(None))

    ck = AsyncCheckpointer(str(tmp_path / "ck"), keep=2)
    sup = StepSupervisor(
        lambda st, b: ({"x": st["x"] + b}, {}), ck, ckpt_every=1,
        max_retries=2, input_recover=recover)
    try:
        state = sup.run({"x": torch.zeros((), dtype=torch.int64)},
                        lambda s: pipes[-1].get_batch_device(s)[0].sum(), 3)
    finally:
        pipes[-1].close()
        ck.shutdown()
    assert sup.stats.reader_failures == sup.stats.failures == 1
    assert len(pipes) == 2
    assert state["x"].item() == sum(expect)


def test_driver_process_backend_gives_thread_batches(tmp_path):
    from repro_torch.data import pipeline as tpipeline
    from repro_torch.launch import train as port_train

    def run(extra):
        got = []
        orig = tpipeline.CkIOPipeline.get_batch_device

        def recorded(self, step, *a, **kw):
            x, y = orig(self, step, *a, **kw)
            got.append((x.numpy().copy(), y.numpy().copy()))
            return x, y

        tpipeline.CkIOPipeline.get_batch_device = recorded
        try:
            out = port_train.main([
                "--smoke", "--steps", "2", "--global-batch", "2", "--seq",
                "32", "--microbatches", "1", "--device", "cpu",
                "--device-ingest", "--num-readers", "2",
                "--data", str(tmp_path / "tokens.bin"),
                "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "100",
                *extra])
        finally:
            tpipeline.CkIOPipeline.get_batch_device = orig
        return out, got

    thread, want = run([])
    proc, got = run(["--backend", "process", "--max-workers", "2"])
    assert len(got) == len(want) == 2
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)
    assert proc["read"]["workers"][1] == 2
    assert proc["read"]["degraded_sessions"] == 0
    assert thread["read"]["workers"] == [0, 0]
