"""The port's persistent reader service (``repro_torch.ipc.service``) held
bit for bit against the port's own thread and process backends and the
reference's thread backend, the mailbox and the re-arm words byte for byte
against the reference's.

The cases mirror the reference's ``tests/test_service.py``: the arena
pool's size classes, generation stamp, quarantine and bound; the
``CommandRing`` and epoch words across packages; back-to-back sessions on
one pool on both substrates; concurrent sessions and the per-tenant fair
share; ``FileSet`` shards; a seeded crash under ``respawn``, ``reissue``
and ``none`` (a sibling session completes, one worker is evicted, the pool
serves on); a stale-epoch event; admission (``ServiceBusy``, the fallback
to spawn, ``use_service=False``); what a pooled worker imports and
reports; the pipeline; both drivers. The thread substrate carries the
matrix; the process substrate (fresh interpreters) is used where process
death or a worker's interpreter is the subject, each such test under its
own time limit and with the service shut down in ``finally``. Each test
leaves none of its own ``ckiot-`` segments behind.
"""
import os
import signal
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import CkIO as JCkIO  # noqa: E402
from repro.core import FileOptions as JFileOptions  # noqa: E402
from repro.data.pipeline import CkIOPipeline as JCkIOPipeline  # noqa: E402
from repro.ipc import ring as jring  # noqa: E402
from repro_torch.core import CkIO, FileOptions, WorkerCrashed  # noqa: E402
from repro_torch.core.faults import CrashReader, FaultPlan  # noqa: E402
from repro_torch.data import CkIOPipeline, FileSet, make_token_file, write_token_shards  # noqa: E402
from repro_torch.io.posix import write_file  # noqa: E402
from repro_torch.ipc import ring  # noqa: E402
from repro_torch.ipc.ring import RingEvent, ring_bytes  # noqa: E402
from repro_torch.ipc.service import (  # noqa: E402
    ArenaPool,
    ReaderService,
    ServiceBusy,
    ServiceOptions,
    _size_class,
)
from repro_torch.ipc.shm import PREFIX, StaleArenaView, shm_dir  # noqa: E402

SPLINTER = 128 * 1024
WAIT = 60.0
PROCESS_LIMIT_S = 90          # each process-substrate test's own limit


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
        time.sleep(0.05)
    assert _own_segments() == before


@pytest.fixture
def time_limit():
    """The test's own time limit: SIGALRM raises in the test's thread."""
    def expired(signum, frame):
        raise TimeoutError(f"test exceeded its {PROCESS_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(PROCESS_LIMIT_S)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)


@pytest.fixture
def data_file(tmp_path):
    data = np.random.default_rng(20261017).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    path = str(tmp_path / "blob.bin")
    write_file(path, data)
    return path, data


def _opts(**kw):
    base = dict(num_readers=2, splinter_bytes=SPLINTER, backend="process",
                max_workers=2)
    base.update(kw)
    return FileOptions(**base)


def _service(ck, **kw):
    base = dict(pool_workers=2, backend="thread")
    base.update(kw)
    svc = ReaderService(ServiceOptions(**base))
    ck.director.attach_service(svc)
    return svc


def _drain(ck, fh, nbytes, offset=0):
    """One session's bytes and metrics."""
    sess = ck.start_read_session_sync(fh, nbytes, offset, timeout=WAIT)
    got = bytes(ck.read_view_sync(sess, nbytes, offset, timeout=WAIT))
    m = sess.metrics
    ck.close_read_session_sync(sess)
    return got, m


def _thread_bytes(ck_cls, opts_cls, path, nbytes, offset=0):
    ck = ck_cls(num_pes=4)
    fh = ck.open_sync(path, opts_cls(num_readers=2, splinter_bytes=SPLINTER))
    try:
        return _drain(ck, fh, nbytes, offset)[0]
    finally:
        ck.close_sync(fh)


# -- the arena pool ------------------------------------------------------------------
def test_size_class_pow2_buckets():
    q = 1 << 20
    assert [_size_class(n, q) for n in (1, q, q + 1, 3 * q)] == \
        [q, q, 2 * q, 4 * q]


def test_arena_pool_recycles_and_bumps_generation():
    pool = ArenaPool(max_segments=4, quantum=1 << 16)
    try:
        a1, recycled = pool.acquire(10_000)
        assert not recycled and a1.generation == 1
        assert a1.nbytes == 1 << 16                # the class, not the request
        assert os.path.basename(a1.path).startswith(f"{PREFIX}svc-")
        name = a1.path
        pool.release(a1)
        assert pool.free_segments() == 1
        a2, recycled = pool.acquire(50_000)        # fits the same class
        assert recycled and a2 is a1 and a2.generation == 2
        with pytest.raises(StaleArenaView):        # a generation-1 view
            a2.check_generation(1)
        a2.check_generation(2)
        assert a2.path == name
        pool.release(a2)
    finally:
        pool.shutdown()
    with pytest.raises(StaleArenaView):            # torn down entirely
        a2.check_generation(2)


def test_arena_pool_quarantine_unlinks_instead_of_recycling():
    pool = ArenaPool(max_segments=4, quantum=1 << 16)
    try:
        a, _ = pool.acquire(1 << 16)
        pinned = np.frombuffer(a.buf, dtype=np.uint8)   # a live export
        pool.release(a, quarantine=True)
        assert pool.free_segments() == 0 and a.closed
        assert not os.path.exists(os.path.join(shm_dir(),
                                               os.path.basename(a.path or "x")))
        assert pinned.size == 1 << 16              # the exporter's pages live
    finally:
        pool.shutdown()


def test_arena_pool_free_list_is_bounded():
    pool = ArenaPool(max_segments=1, quantum=1 << 16)
    try:
        a, _ = pool.acquire(1 << 16)
        b, _ = pool.acquire(1 << 16)
        pool.release(a)
        pool.release(b)                            # over capacity: unlinked
        assert pool.free_segments() == 1
        assert b.closed and not a.closed
    finally:
        pool.shutdown()


# -- the mailbox and the re-arm words against the reference's -------------------------
def test_command_ring_and_epoch_words_match_reference():
    for name in ("CMD_HDR_BYTES", "_CMD_OFF_EPOCH", "_CMD_OFF_ACK",
                 "_CMD_OFF_STOP", "_CMD_OFF_LEN", "_CMD_OFF_CRC",
                 "_CMD_OFF_PID", "_OFF_EPOCH", "_OFF_EPOCH_DONE"):
        assert getattr(ring, name) == getattr(jring, name), name
    bufs = {}
    for mod in (ring, jring):
        buf = memoryview(bytearray(4096))
        cmd = mod.CommandRing(buf, create=True)
        cmd.set_pid(4242)
        cmd.send(3, b"spec-3")
        cmd.ack(3)
        cmd.send(9, b"a longer spec, epoch 9")
        cmd.request_stop()
        bufs[mod.__name__] = bytes(buf)
    assert bufs["repro_torch.ipc.ring"] == bufs["repro.ipc.ring"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_command_written_by_one_package_read_by_the_other(writer):
    wmod, rmod = (ring, jring) if writer == "port" else (jring, ring)
    buf = memoryview(bytearray(1024))
    parent = wmod.CommandRing(buf, create=True)
    worker = rmod.CommandRing(buf)
    assert worker.capacity == parent.capacity == 1024 - ring.CMD_HDR_BYTES
    parent.send(5, b"\x80\x04pickled-spec")
    assert worker.wait_command(0) == (5, b"\x80\x04pickled-spec")
    with pytest.raises(RuntimeError, match="not yet acked"):
        parent.send(6, b"x")
    worker.ack(5)
    worker.set_pid(77)
    assert parent.acked(5) and parent.pid() == 77
    parent.send(6, b"next")
    assert worker.wait_command(5) == (6, b"next")
    buf[ring.CMD_HDR_BYTES] ^= 0xFF                # a torn payload: no command
    assert worker.wait_command(5, should_abort=lambda: True) is None
    with pytest.raises(ValueError, match="exceeds mailbox"):
        parent.send(7, b"x" * 2048)
    parent.request_stop()
    assert worker.wait_command(6) is None


def test_rearm_reset_keeps_head_and_tail_like_reference():
    slots = 8
    out = {}
    for mod in (ring, jring):
        buf = memoryview(bytearray(ring_bytes(slots)))
        prod = mod.EventRing(buf, slots, create=True)
        prod.set_pid(11)
        prod.set_epoch(4)
        for i in range(5):
            assert prod.publish(mod.RingEvent(i, 0, i * 64, 64, i * 64, 0.5,
                                              0.25, epoch=4))
        prod.set_touch(3, mod.PIN_OK)
        prod.set_io(1, 2)
        prod.set_state(mod.ST_DONE)
        prod.set_done_epoch(4)
        cons = mod.EventRing(buf, slots)
        assert [e.epoch for e in cons.consume()] == [4] * 5
        cons.open_gate()
        cons.request_stop()
        assert (cons.epoch(), cons.done_epoch()) == (4, 4)
        cons.rearm_reset()
        assert (cons.state(), cons.pending(), cons.pid()) == (mod.ST_INIT, 0,
                                                              11)
        assert cons.touch_report() == (0, mod.PIN_NONE)
        assert cons.io_report() == (0, 0) and not cons.stop_requested()
        assert prod.publish(mod.RingEvent(5, 0, 0, 64, 0, 0.5, 0.25, 5))
        assert [e.index for e in cons.consume()] == [5]   # seq kept rising
        out[mod.__name__] = bytes(buf)
    assert out["repro_torch.ipc.ring"] == out["repro.ipc.ring"]


def test_rearm_reset_truncates_the_report():
    slots = 4
    r = ring.EventRing(memoryview(bytearray(ring_bytes(slots))), slots,
                       create=True)
    r.set_report({"submit": "threads", "hwm": 3, "tails": 1})
    assert r.report() == {"submit": "threads", "hwm": "3", "tails": "1"}
    r.rearm_reset()
    assert r.report() == {}


# -- back-to-back sessions on one pool ----------------------------------------------------
@pytest.mark.parametrize("substrate", ["thread", "process"])
def test_back_to_back_sessions_rearm_one_pool(data_file, substrate,
                                              time_limit):
    """Three sessions through one pool: each one's bytes are the port's
    thread backend's and the reference's; epochs rise, sessions 2..3
    recycle the arena, and the service counters reconcile."""
    path, data = data_file
    off, n = 4096, len(data) - 4096 - 17
    want = _thread_bytes(CkIO, FileOptions, path, n, off)
    assert want == _thread_bytes(JCkIO, JFileOptions, path, n, off) \
        == data[off:off + n]
    ck = CkIO(num_pes=4)
    svc = _service(ck, backend=substrate)
    try:
        fh = ck.open_sync(path, _opts())
        epochs = []
        for i in range(3):
            got, m = _drain(ck, fh, n, off)
            assert got == want
            assert m.pooled and m.bytes_copied == 0 and m.bytes_read == n
            assert m.arena_recycled == (i > 0)
            assert m.workers == 2 and m.worker_attach_s == \
                m.service_checkout_s > 0
            if substrate == "process":
                assert os.getpid() not in m.worker_pids
            epochs.append(m.service_epoch)
        ck.close_sync(fh)
        assert epochs == sorted(epochs) and len(set(epochs)) == 3
        sm = svc.metrics
        assert (sm.admitted, sm.checkout_count, sm.completed) == (3, 3, 3)
        assert sm.rearms == 6                      # 3 sessions x 2 workers
        assert (sm.arena_hits, sm.arena_misses) == (2, 1)
        assert (sm.workers_spawned, sm.workers_evicted) == (2, 0)
        assert svc.pool_size() == 2 and svc.idle_workers() == 2
    finally:
        svc.shutdown()


# -- sharing the pool ---------------------------------------------------------------------
def test_concurrent_sessions_share_one_pool(data_file):
    path, data = data_file
    ck = CkIO(num_pes=4)
    svc = _service(ck, max_sessions=4)
    try:
        fh = ck.open_sync(path, _opts(num_readers=1, max_workers=1))
        win = len(data) // 4
        sessions = [ck.start_read_session_sync(fh, win, i * win, timeout=WAIT)
                    for i in range(4)]
        for i, sess in enumerate(sessions):
            view = ck.read_view_sync(sess, win, i * win, timeout=WAIT)
            assert bytes(view) == data[i * win:(i + 1) * win]
            del view
            assert sess.metrics.pooled and sess.metrics.bytes_copied == 0
        for sess in sessions:
            ck.close_read_session_sync(sess)
        ck.close_sync(fh)
        assert svc.metrics.stale_events == 0
        assert svc.metrics.occupancy_hwm <= 2      # never more than the pool
    finally:
        svc.shutdown()


def test_tenant_fair_share_skips_a_tenant_at_its_share(data_file):
    """A 2-worker pool: tenant A's stalled session holds one worker; with a
    second A session queued ahead of a B session, one dispatch arms B on
    the idle worker (A is at its share of 2 // 2 while B waits), and A's
    second session runs once a worker checks back in."""
    from repro_torch.ipc.service import ServiceReaderSet, _SessionState
    from repro_torch.ipc.worker import StallReader

    path, data = data_file
    ck = CkIO(num_pes=4)
    svc = _service(ck, pool_workers=2, max_sessions=3)
    try:
        slow = ck.open_sync(path, _opts(num_readers=1, max_workers=1,
                                        tenant="A",
                                        delay_model=StallReader(0, 0.1)))
        s1 = ck.start_read_session_sync(slow, len(data), 0, timeout=WAIT)
        assert len(s1.readers._svc_state.workers) == 1
        queued = []
        with svc._lock:
            for tenant in ("A", "B"):
                rs = ServiceReaderSet(slow.posix, s1.plan, ck.sched,
                                      list(range(4)), _opts().reader_options(),
                                      service=svc, tenant=tenant)
                st = _SessionState(set_=rs, tenant=tenant, want=2,
                                   t_submit=time.monotonic())
                rs._svc_state = st
                svc._waitq.append(st)
                queued.append((tenant, st, rs))
            svc._dispatch_locked()
            armed = [(t, len(st.workers)) for t, st, _ in queued if st.armed]
        assert armed == [("B", 1)]
        assert bytes(ck.read_view_sync(s1, len(data), 0,
                                       timeout=WAIT)) == data
        ck.close_read_session_sync(s1)
        for tenant, st, rs in queued:
            assert rs.join(WAIT), tenant
            assert bytes(rs.view(0, len(data))) == data
            rs.release()
        assert queued[0][1].armed and queued[0][1].epochs[0] > \
            queued[1][1].epochs[0]                 # A's second ran after B
        ck.close_sync(slow)
    finally:
        svc.shutdown()


def test_fileset_shards_through_service(tmp_path):
    rows = 32 * 1024                               # 128 KiB a shard (uint32)
    arr = np.random.default_rng(7).integers(0, 2**31, size=2 * rows,
                                            dtype=np.uint32)
    fs = FileSet.build(write_token_shards(str(tmp_path), arr, [rows, rows]))
    ck = CkIO(num_pes=4)
    svc = _service(ck)
    try:
        fh = ck.open_fileset_sync(fs, _opts(splinter_bytes=64 * 1024))
        for i in range(2):
            got, m = _drain(ck, fh, fs.data_bytes)
            assert got == arr.tobytes()
            assert m.pooled and m.bytes_copied == 0 and m.arena_recycled == i
            assert m.shard_bytes == {0: rows * 4, 1: rows * 4}
        ck.close_sync(fh)
    finally:
        svc.shutdown()


# -- faults on the pool (process substrate: the crash hooks os._exit) ---------------------
SEED = 4          # FaultPlan(4): reader 0 crashes after 2 of its 4 splinters


@pytest.mark.parametrize("mode", ["respawn", "reissue"])
def test_seeded_crash_on_the_pool_recovers_bit_equal(data_file, mode,
                                                     time_limit):
    path, data = data_file
    plan = FaultPlan(SEED, num_readers=2, num_splinters=8)
    assert (plan.crash_reader, plan.crash_after) == (0, 2)
    ck = CkIO(num_pes=4)
    svc = _service(ck, backend="process")
    try:
        fh = ck.open_sync(path, _opts(recovery=mode, fault_plan=plan))
        got, m = _drain(ck, fh, len(data))
        assert got == data and m.pooled and m.bytes_copied == 0
        r = m.recovery
        assert (r.respawns, r.reissues) == ((1, 0) if mode == "respawn"
                                            else (0, 1))
        assert r.reissued_splinters == 2 and r.reissued_bytes == 2 * SPLINTER
        assert svc.metrics.workers_evicted == 1
        assert svc.metrics.sessions_failed == 0
        # the pool serves on, back at full size
        fh2 = ck.open_sync(path, _opts())
        got, m2 = _drain(ck, fh2, len(data))
        assert got == data and m2.pooled and m2.recovery.respawns == 0
        assert svc.pool_size() == 2
        ck.close_sync(fh)
        ck.close_sync(fh2)
    finally:
        svc.shutdown()


def test_crash_under_none_fails_its_session_alone(data_file, time_limit):
    path, data = data_file
    ck = CkIO(num_pes=4)
    svc = _service(ck, backend="process", pool_workers=4, max_sessions=2)
    try:
        fh_bad = ck.open_sync(path, _opts(
            worker_fault=CrashReader(reader=0, after=0, code=67)))
        fh_ok = ck.open_sync(path, _opts())
        sess_a = ck.start_read_session_sync(fh_bad, len(data), 0,
                                            timeout=WAIT)
        sess_b = ck.start_read_session_sync(fh_ok, len(data), 0,
                                            timeout=WAIT)
        with pytest.raises(WorkerCrashed, match="pooled reader worker"):
            ck.read_sync(sess_a, len(data), 0, timeout=WAIT)
        view = ck.read_view_sync(sess_b, len(data), 0, timeout=WAIT)
        assert bytes(view) == data                 # the sibling is unharmed
        del view
        assert sess_b.metrics.bytes_copied == 0
        ck.close_read_session_sync(sess_a)
        ck.close_read_session_sync(sess_b)
        assert svc.metrics.sessions_failed == 1
        assert svc.metrics.workers_evicted == 1    # only the dead one
        got, m = _drain(ck, fh_ok, len(data))      # lazily replaced pool
        assert got == data and m.pooled and m.workers == 2
        assert svc.pool_size() == 4
        ck.close_sync(fh_bad)
        ck.close_sync(fh_ok)
    finally:
        svc.shutdown()


def test_stale_epoch_event_dropped_and_counted(data_file):
    path, data = data_file
    ck = CkIO(num_pes=4)
    svc = _service(ck)
    try:
        fh = ck.open_sync(path, _opts())
        assert _drain(ck, fh, len(data))[0] == data
        with svc._lock:
            parked = svc._idle[0].ring
        assert parked.publish(RingEvent(
            index=0, reader=0, offset=0, nbytes=4096, arena_off=0,
            t_arrival=0.0, read_dt=0.0, epoch=9999), timeout=5.0)
        deadline = time.monotonic() + 10.0
        while svc.metrics.stale_events < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert svc.metrics.stale_events == 1
        assert _drain(ck, fh, len(data))[0] == data
        ck.close_sync(fh)
        assert svc.metrics.stale_events == 1       # counted once
    finally:
        svc.shutdown()


# -- admission ----------------------------------------------------------------------------
def test_admission_rejects_with_servicebusy(data_file):
    path, data = data_file
    ck = CkIO(num_pes=2)
    svc = _service(ck, pool_workers=1, max_sessions=1, max_queue=0)
    try:
        fh = ck.open_sync(path, _opts(num_readers=1, max_workers=1,
                                      use_service=True))
        sess = ck.start_read_session_sync(fh, len(data), 0, timeout=WAIT)
        with pytest.raises(ServiceBusy, match="saturated"):
            ck.start_read_session_sync(fh, len(data), 0, timeout=WAIT)
        assert svc.metrics.rejected == 1
        assert bytes(ck.read_view_sync(sess, len(data), 0,
                                       timeout=WAIT)) == data
        ck.close_read_session_sync(sess)
        assert _drain(ck, fh, len(data))[0] == data   # capacity freed
        ck.close_sync(fh)
    finally:
        svc.shutdown()


@pytest.mark.parametrize("use_service", [None, False], ids=["auto", "off"])
def test_saturated_or_opted_out_sessions_spawn(data_file, use_service,
                                               time_limit):
    """Auto routing falls back to per-session spawn when the pool is
    saturated (and pools again, not sticky, once it has room);
    ``use_service=False`` always spawns."""
    path, data = data_file
    ck = CkIO(num_pes=2)
    svc = _service(ck, pool_workers=1, max_sessions=1, max_queue=0)
    try:
        fh = ck.open_sync(path, _opts(num_readers=1, max_workers=1,
                                      use_service=use_service))
        if use_service is None:
            sess_a = ck.start_read_session_sync(fh, len(data), 0,
                                                timeout=WAIT)
            assert sess_a.readers.wait_attached(WAIT)
            assert sess_a.metrics.pooled
        got, m = _drain(ck, fh, len(data))
        assert got == data and not m.pooled and m.bytes_copied == 0
        assert m.workers == 1 and os.getpid() not in m.worker_pids
        if use_service is None:
            assert bytes(ck.read_view_sync(sess_a, len(data), 0,
                                           timeout=WAIT)) == data
            ck.close_read_session_sync(sess_a)
            assert svc.metrics.rejected == 1
            assert _drain(ck, fh, len(data))[1].pooled    # not sticky
        else:
            assert svc.metrics.admitted == 0       # never touched the pool
        ck.close_sync(fh)
        assert svc.metrics.sessions_failed == 0
    finally:
        svc.shutdown()


# -- what a pooled worker loads and reports -----------------------------------------------
PROBE = '''
import sys


class Probe:
    """worker_fault hook: records which top-level packages the worker
    process has loaded when it reads a splinter."""

    def __init__(self, out):
        self.out = out

    def __call__(self, reader, index):
        with open(self.out, "a") as f:
            f.write(repr(sorted({m.split(".")[0] for m in sys.modules
                                 if m.split(".")[0] in
                                 ("torch", "jax", "repro", "repro_torch")}))
                    + "\\n")
'''


def test_pooled_worker_loads_no_torch_and_reports_its_session(
        tmp_path, data_file, monkeypatch, time_limit):
    """A pooled worker is a fresh interpreter that loads no torch; its
    first session's report carries its start-up times and a queue-depth
    session's submit kind, a re-armed blocking session's report none of
    them."""
    path, data = data_file
    (tmp_path / "probe_mod.py").write_text(PROBE)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(tmp_path), os.environ.get("PYTHONPATH", "")]))
    import probe_mod

    out = tmp_path / "probe.txt"
    assert "torch" in sys.modules                 # the parent has it
    ck = CkIO(num_pes=4)
    svc = _service(ck, backend="process", pool_workers=1)
    try:
        deep = ck.open_sync(path, _opts(num_readers=1, max_workers=1,
                                        queue_depth=4, submit_mode="threads",
                                        worker_fault=probe_mod.Probe(
                                            str(out))))
        got, m1 = _drain(ck, deep, len(data))
        assert got == data
        assert m1.submit_backend == "threads" and 1 <= m1.inflight_hwm <= 4
        assert 0 < m1.worker_boot_s and 0 < m1.worker_import_s
        plain = ck.open_sync(path, _opts(num_readers=1, max_workers=1))
        got, m2 = _drain(ck, plain, len(data))
        assert got == data and m2.worker_pids == m1.worker_pids
        assert m2.service_epoch > m1.service_epoch and m2.arena_recycled
        assert (m2.submit_backend, m2.inflight_hwm) == ("", 0)
        assert (m2.worker_boot_s, m2.worker_import_s) == (0.0, 0.0)
        assert m2.worker_attach_s == m2.service_checkout_s
        ck.close_sync(deep)
        ck.close_sync(plain)
    finally:
        svc.shutdown()
    lines = set(out.read_text().split("\n")) - {""}
    assert lines == {"['repro_torch']"}


# -- the pipeline --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("stok") / "tokens.bin")
    make_token_file(path, 3 * 4 * 257 + 11, vocab_size=200064, seed=3)
    return path


@pytest.mark.parametrize("mode", ["host", "window", "streamed"])
def test_pipeline_on_the_service_gives_thread_batches(token_file, mode):
    def batches(pipe):
        # Two rounds over the 3 step windows, as the train driver's ``step
        # % num_steps`` reads them, so the second round's sessions can take
        # recycled arenas.
        out = []
        for step in range(2 * pipe.num_steps):
            if mode == "host":
                x, y = pipe.get_batch(step % pipe.num_steps)
            else:
                x, y = pipe.get_batch_device(step % pipe.num_steps)
            out.append((np.array(x), np.array(y)))
            x = y = None             # a host batch aliases the arena
        return out

    kw = dict(num_pes=2, num_consumers=6, device="cpu",
              streaming=mode == "streamed")
    fo = dict(num_readers=3, splinter_bytes=4096)
    pipe = CkIOPipeline(token_file, 4, 256, file_opts=FileOptions(**fo), **kw)
    want = batches(pipe)
    pipe.close()
    ck = CkIO(num_pes=2)
    svc = ReaderService(ServiceOptions(pool_workers=2, backend="thread"))
    seen = []
    ck.director.add_observer(seen.append)
    try:
        pipe = CkIOPipeline(token_file, 4, 256, ckio=ck, service=svc,
                            file_opts=FileOptions(backend="process",
                                                  max_workers=2, **fo), **kw)
        got = batches(pipe)
        pipe.close()
    finally:
        svc.shutdown()
    assert len(got) == 6
    for (xg, yg), (xw, yw) in zip(got, want, strict=True):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)
    read = [m for m in seen if m.bytes_read]
    assert read and all(m.pooled and m.bytes_copied == 0 for m in read)
    # No view outlived its step, so no segment was quarantined: every
    # session of the second round took a recycled arena.
    assert (svc.metrics.arena_hits, svc.metrics.arena_misses) == (3, 3)
    if mode == "host":
        ref = JCkIOPipeline(token_file, 4, 256, num_pes=2, num_consumers=6,
                            file_opts=JFileOptions(**fo))
        for step, (xg, yg) in enumerate(got[:3]):
            xr, yr = ref.get_batch(step)
            np.testing.assert_array_equal(xg, np.asarray(xr))
            np.testing.assert_array_equal(yg, np.asarray(yr))
        ref.close()


# -- the drivers ---------------------------------------------------------------------------
def test_train_driver_service_gives_thread_losses(tmp_path, time_limit):
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
                "--smoke", "--steps", "3", "--global-batch", "2", "--seq",
                "32", "--microbatches", "1", "--device", "cpu",
                "--device-ingest", "--num-readers", "2",
                "--data", str(tmp_path / "tokens.bin"),
                "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "100",
                *extra])
        finally:
            tpipeline.CkIOPipeline.get_batch_device = orig
        return out, got

    thread, want = run([])
    pooled, got = run(["--service", "--pool-workers", "2", "--max-workers",
                       "2"])
    assert len(got) == len(want) == 3
    for (xg, yg), (xw, yw) in zip(got, want):
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)
    # Same batches, so the same losses up to the run-to-run rounding of
    # CPU GEMMs (seen at 6e-6 relative between two thread-backend runs);
    # the card holds the losses bit-equal (chip_smoke.py, phase service).
    np.testing.assert_allclose(
        [pooled["first_loss"], pooled["final_loss"]],
        [thread["first_loss"], thread["final_loss"]], rtol=1e-4)
    svc, read = pooled["service"], pooled["read"]
    assert read["pooled_sessions"] >= 3 and read["workers"][1] == 2
    assert svc["workers_spawned"] == 2 and svc["workers_evicted"] == 0
    assert svc["sessions_failed"] == 0 and thread["service"] is None


def test_serve_driver_continuous_service_gives_oracle_tokens(tmp_path,
                                                             time_limit):
    from repro_torch.launch import serve as tlaunch
    from repro_torch.serve import sequential_oracle

    run = tlaunch.main(["--smoke", "--device", "cpu", "--continuous",
                        "--service", "--pool-workers", "2", "--requests",
                        "4", "--max-new", "3", "--data",
                        str(tmp_path / "p.bin")])
    by_rid = sorted(run.requests, key=lambda r: r.rid)
    oracle = sequential_oracle(
        run.engine, [run.corpus[r.row_start:r.row_start + r.num_rows]
                     for r in by_rid], [3] * len(by_rid))
    assert [r.result for r in by_rid] == oracle
    assert run.summary["all_completed"]
    assert run.summary["pooled_sessions"] == run.metrics.pooled_sessions == 4
    assert run.metrics.ingest_bytes_copied == 0
