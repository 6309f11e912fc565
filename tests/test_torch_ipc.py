"""The port's multi-process substrate against the reference's: the
shared-memory arena under the port's own ``ckiot-`` prefix, the event ring
(byte layout identical: a ring one package writes, the other reads), and
``worker_main`` run inline on the same spec fields as the reference's
inline worker (same arena bytes, same events). A fresh interpreter that
imports the worker module loads no torch."""
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.io.layout import plan_session as jplan_session  # noqa: E402
from repro.ipc import ring as jring  # noqa: E402
from repro.ipc.shm import SharedArena as JSharedArena  # noqa: E402
from repro.ipc.worker import WorkerSpec as JWorkerSpec  # noqa: E402
from repro.ipc.worker import worker_main as jworker_main  # noqa: E402
from repro_torch.core.faults import TornSlot  # noqa: E402
from repro_torch.data import write_token_shards  # noqa: E402
from repro_torch.data.fileset import FileSet  # noqa: E402
from repro_torch.io.layout import plan_session  # noqa: E402
from repro_torch.io.posix import write_file  # noqa: E402
from repro_torch.ipc import ring  # noqa: E402
from repro_torch.ipc.ring import (  # noqa: E402
    HDR_BYTES,
    MSG_BYTES,
    PIN_OK,
    ST_DONE,
    ST_ERROR,
    EventRing,
    ring_bytes,
)
from repro_torch.ipc.shm import PREFIX, SharedArena, shm_dir  # noqa: E402
from repro_torch.ipc.worker import RaiseAfter, WorkerSpec, worker_main  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _own_segments():
    """This process's ``ckiot-`` segments (never the reference's
    ``ckio-`` ones, which the reference's tests own)."""
    mark = f"-{os.getpid()}-"
    return sorted(n for n in os.listdir(shm_dir())
                  if n.startswith(PREFIX) and mark in n)


@pytest.fixture
def data_file(tmp_path):
    data = np.random.default_rng(5).integers(0, 256, 700_001,
                                             dtype=np.uint8).tobytes()
    path = str(tmp_path / "blob.bin")
    write_file(path, data)
    return path, data


# -- SharedArena -----------------------------------------------------------------
def test_shared_arena_create_attach_close_unlink_under_port_prefix():
    before = _own_segments()
    a = SharedArena.create(8192, tag="t")
    assert os.path.basename(a.path).startswith(f"{PREFIX}t-{os.getpid()}-")
    assert _own_segments() == sorted(before + [os.path.basename(a.path)])
    arr = a.ndarray()
    arr[:] = np.arange(8192) % 251
    b = SharedArena.attach(a.path, 8192)         # a second mapping, own fd
    assert bytes(b.buf) == arr.tobytes()
    b.ndarray()[100] = 77                        # writes are shared
    assert arr[100] == 77
    path = a.path
    a.unlink()                                   # the name goes ...
    assert not os.path.exists(path) and a.path == ""
    b.ndarray()[0] = 9                           # ... the mapping stays
    assert arr[0] == 9
    b.detach()
    assert b.closed
    a.close()                                    # arr's export pins it
    assert a.closed and arr[0] == 9
    a.close()                                    # idempotent
    assert _own_segments() == before
    with pytest.raises(ValueError):
        SharedArena.create(-1)


def test_reference_attaches_a_port_arena():
    a = SharedArena.create(4096)
    try:
        a.ndarray()[:3] = [1, 2, 3]
        j = JSharedArena.attach(a.path, 4096)
        assert list(j.ndarray()[:3]) == [1, 2, 3]
        j.ndarray()[3] = 4
        assert a.ndarray()[3] == 4
        j.close()
    finally:
        a.close()


# -- EventRing -------------------------------------------------------------------
def _ev(mod, i, nbytes=64):
    return mod.RingEvent(index=i, reader=i % 3, offset=i * nbytes,
                         nbytes=nbytes, arena_off=i * nbytes,
                         t_arrival=float(i) / 7, read_dt=0.25)


def _drive(mod, slots, buf):
    """The same producer/consumer script on either package's ring."""
    prod = mod.EventRing(buf, slots, create=True)
    cons = mod.EventRing(buf, slots)
    prod.set_pid(4242)
    prod.set_touch(17, mod.PIN_OK)
    prod.set_io(3, 1)
    prod.set_state(mod.ST_ATTACHED)
    cons.open_gate()
    out = []
    for i in range(3 * slots + 1):
        assert prod.publish(_ev(mod, i), timeout=5.0)
        if i % 2 or slots == 1:
            out += cons.consume()
    out += cons.consume()
    prod.set_state(mod.ST_DONE)
    return out


@pytest.mark.parametrize("slots", [1, 4, 64])
def test_ring_bytes_identical_to_reference(slots):
    assert ring_bytes(slots) == jring.ring_bytes(slots)
    for name in ("HDR_BYTES", "MSG_BYTES", "SLOT_BYTES", "ST_INIT",
                 "ST_ATTACHED", "ST_DONE", "ST_ERROR", "PIN_NONE", "PIN_OK",
                 "PIN_FAILED", "_OFF_EPOCH", "_OFF_EPOCH_DONE"):
        assert getattr(ring, name) == getattr(jring, name), name
    pb, jb = bytearray(ring_bytes(slots)), bytearray(ring_bytes(slots))
    got = _drive(ring, slots, memoryview(pb))
    want = _drive(jring, slots, memoryview(jb))
    assert pb == jb
    assert [tuple(vars(e).values()) for e in got] == \
        [tuple(vars(e).values()) for e in want]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_ring_written_by_one_package_read_by_the_other(writer):
    slots = 8
    buf = memoryview(bytearray(ring_bytes(slots)))
    wmod, rmod = (ring, jring) if writer == "port" else (jring, ring)
    prod = wmod.EventRing(buf, slots, create=True)
    cons = rmod.EventRing(buf, slots)
    prod.set_pid(99)
    prod.set_touch(5, wmod.PIN_FAILED)
    prod.set_io(2, 7)
    for i in range(5):
        assert prod.publish(_ev(wmod, i))
    got = cons.consume()
    assert [(e.index, e.reader, e.offset, e.nbytes, e.arena_off, e.t_arrival,
             e.read_dt, e.epoch) for e in got] == [
        (i, i % 3, i * 64, 64, i * 64, i / 7, 0.25, 0) for i in range(5)]
    assert (cons.pid(), cons.touch_report(), cons.io_report()) == (
        99, (5, rmod.PIN_FAILED), (2, 7))
    cons.open_gate()
    cons.request_stop()
    assert prod.wait_go() is True and prod.stop_requested()
    prod.set_error("boom: ünïcode")
    assert cons.state() == rmod.ST_ERROR
    assert cons.error_message() == "boom: ünïcode"


def test_ring_report_rides_the_message_area():
    buf = memoryview(bytearray(ring_bytes(2)))
    prod = EventRing(buf, 2, create=True)
    prod.set_report({"submit": "threads", "hwm": 3, "tails": 1,
                     "tail_bytes": 32})
    prod.set_state(ST_DONE)
    cons = EventRing(buf, 2)
    assert cons.report() == {"submit": "threads", "hwm": "3", "tails": "1",
                             "tail_bytes": "32"}
    assert jring.EventRing(buf, 2).state() == jring.ST_DONE
    prod.set_error("failed")                     # an error overwrites it
    assert cons.report() == {} and cons.error_message() == "failed"


def test_torn_slot_is_detected_and_never_consumed():
    buf = memoryview(bytearray(ring_bytes(4)))
    prod = EventRing(buf, 4, create=True)
    cons = EventRing(buf, 4)
    assert prod.publish(_ev(ring, 7))
    payload = HDR_BYTES + MSG_BYTES + 8          # slot 0, past the stamp
    byte = buf[payload]
    buf[payload] = byte ^ 0xFF                   # payload not visible yet
    assert cons.consume() == []
    assert jring.EventRing(buf, 4).consume() == []
    buf[payload] = byte                          # the stores land
    assert [e.index for e in cons.consume()] == [7]


def test_torn_publication_hook_retried_never_delivered():
    """Stamp-first publication (``TornSlot``): the consumer re-reads the
    slot until the payload lands — in order, once each, never torn."""
    slots, n = 4, 48
    buf = memoryview(bytearray(ring_bytes(slots)))
    prod = EventRing(buf, slots, create=True)
    prod.fault = TornSlot(every=3, delay_s=0.003)
    cons = EventRing(buf, slots)
    errs = []

    def producer():
        try:
            for i in range(n):
                assert prod.publish(_ev(ring, i, 100), timeout=30.0)
        except BaseException as e:               # surfaced below
            errs.append(e)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    got, deadline = [], time.monotonic() + 30.0
    while len(got) < n:
        assert time.monotonic() < deadline, "consumer deadlocked"
        got.extend(cons.consume())
    th.join(10.0)
    assert not th.is_alive() and not errs
    assert [e.index for e in got] == list(range(n))
    assert all(e.offset == e.index * 100 for e in got)


def test_full_ring_throttles_and_stop_releases_the_producer():
    buf = memoryview(bytearray(ring_bytes(2)))
    prod = EventRing(buf, 2, create=True)
    cons = EventRing(buf, 2)
    assert prod.publish(_ev(ring, 0)) and prod.publish(_ev(ring, 1))
    assert prod.publish(_ev(ring, 2), timeout=0.01) is False   # full
    cons.request_stop()
    assert prod.publish(_ev(ring, 3)) is False  # stop wins, no hang
    assert [e.index for e in cons.consume()] == [0, 1]
    with pytest.raises(ValueError):
        EventRing(buf, 3)                        # capacity mismatch
    with pytest.raises(ValueError):
        EventRing(memoryview(bytearray(10)), 2, create=True)


# -- worker_main, inline ---------------------------------------------------------
def _inline(pkg, path, nbytes, *, queue_depth=0, shards=None, base=0,
            fault=None, stop_first=False):
    """Run ``pkg``'s worker_main inline (``parent_pid=0``) on one spec of
    the given fields; returns the arena bytes, the events, the ring and
    its segments."""
    arena_cls, spec_cls, main, rmod, plan_fn = {
        "port": (SharedArena, WorkerSpec, worker_main, ring, plan_session),
        "reference": (JSharedArena, JWorkerSpec, jworker_main, jring,
                      jplan_session),
    }[pkg]
    plan = plan_fn(base, nbytes, 2, splinter_bytes=64 * 1024)
    arena = arena_cls.create(plan.nbytes, tag="ti")
    rings = arena_cls.create(rmod.ring_bytes(64), tag="tr")
    r = rmod.EventRing(rings.buf[:rmod.ring_bytes(64)], 64, create=True)
    spec = spec_cls(
        worker_id=0, file_path=path, arena_path=arena.path,
        arena_bytes=plan.nbytes, base_offset=plan.offset,
        ring_path=rings.path, ring_region_bytes=rmod.ring_bytes(64),
        ring_offset=0, ring_slots=64, splinters=plan.splinters,
        stripe_bounds=plan.stripe_bounds, prefault=True, fault=fault,
        shards=shards, queue_depth=queue_depth)
    if stop_first:
        r.request_stop()
    else:
        r.open_gate()
    err = None
    try:
        main(spec)
    except SystemExit as e:
        err = e
    events = sorted((e.index, e.reader, e.offset, e.nbytes, e.arena_off,
                     e.epoch) for e in r.consume())
    out = bytes(arena.ndarray())
    return out, events, r, (arena, rings), err


@pytest.mark.parametrize("queue_depth", [0, 4], ids=["blocking", "depth4"])
@pytest.mark.parametrize("layout", ["file", "shards"])
def test_inline_worker_matches_reference(data_file, tmp_path, queue_depth,
                                         layout):
    path, data = data_file
    shards = None
    base, n = 4096, len(data) - 4096 - 3
    if layout == "shards":
        arr = np.frombuffer(data[:700_000], dtype=np.uint32)
        paths = write_token_shards(str(tmp_path / "sh"), arr,
                                   [40_000, 65_536, 69_464])
        shards = FileSet.build(paths).sharded_file().worker_segments
        base, n = 0, arr.nbytes
        data = arr.tobytes()
    got = _inline("port", path, n, queue_depth=queue_depth, shards=shards,
                  base=base)
    want = _inline("reference", path, n, queue_depth=queue_depth,
                   shards=shards, base=base)
    try:
        assert got[0] == want[0] == data[base:base + n]
        assert got[1] == want[1] and len(got[1]) == 12
        for r in (got[2], want[2]):
            assert r.state() == ST_DONE and r.pid() == os.getpid()
        assert got[2].touch_report() == want[2].touch_report()
        assert got[2].touch_report()[0] > 0      # stripes first-touched
        assert got[2].io_report() == want[2].io_report()
        rep = got[2].report()
        assert int(rep["tails"]) == 0
        if queue_depth:
            assert rep["submit"] in ("io_uring", "threads")
            assert 1 <= int(rep["hwm"]) <= queue_depth
        else:
            assert "submit" not in rep
    finally:
        for res in (got, want):
            for seg in res[3]:
                seg.close()


def test_inline_worker_error_path_matches_reference(data_file):
    path, data = data_file
    got = _inline("port", path, len(data), fault=RaiseAfter(1, "synthetic"))
    from repro.ipc.worker import RaiseAfter as JRaiseAfter
    want = _inline("reference", path, len(data),
                   fault=JRaiseAfter(1, "synthetic"))
    try:
        for res in (got, want):
            assert res[4] is not None and res[4].code == 1
            assert res[2].state() == ST_ERROR
            assert "synthetic" in res[2].error_message()
        assert got[1] == want[1] and len(got[1]) == 1
    finally:
        for res in (got, want):
            for seg in res[3]:
                seg.close()


def test_inline_worker_stop_before_go_exits_clean(data_file):
    path, data = data_file
    out, events, r, segs, err = _inline("port", path, len(data),
                                        stop_first=True)
    try:
        assert err is None and r.state() == ST_DONE and events == []
        assert r.touch_report()[0] > 0 and r.touch_report()[1] != PIN_OK
    finally:
        for seg in segs:
            seg.close()


def test_worker_module_imports_no_torch():
    """A fresh interpreter that imports the worker module — and the fault
    hooks a spec may carry — loads no torch."""
    code = ("import sys\n"
            "import repro_torch.ipc.worker, repro_torch.core.faults\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
