"""Cross-process splinter-event ring: fixed slots, sequence numbers, no futex.

The thread backend's per-splinter completion stream is a plain in-process
callback list (``BufferReaderSet._mark_done`` → subscribers). Worker
*processes* cannot call back into the parent, so the process backend replaces
that edge with a shared-memory event ring per worker: the worker publishes
one fixed-size record per completed splinter read, and a supervisor thread
in the consumer process polls the rings and re-enters the exact same
``_mark_done`` machinery — waiters, subscribers, ``read_stream`` and the
streaming pipeline all consume cross-process events transparently.

Design (one ring per worker — SPSC, which keeps the protocol lock- and
futex-free):

* **fixed sequence-numbered slots, self-validating**: slot
  ``seq % capacity`` carries record ``seq``; the producer writes the
  payload first and the slot's stamp word last. The stamp packs the
  sequence (low 32 bits, ``seq + 1``; 0 = never written) together with a
  CRC32 of the payload bytes keyed by ``seq`` (high 32 bits). Publication
  therefore does not rely on cross-process store ordering at all: on
  total-store-order hardware (x86-64) the stamp-last protocol alone is
  sufficient, and on weakly-ordered hosts (aarch64) a stamp that becomes
  visible before its payload fails the CRC check and the consumer simply
  retries the slot on its next poll — a torn or stale payload can never
  be consumed (a stale lap's payload carries the previous lap's
  seq-keyed CRC, so it cannot collide).
* **flow control without futexes**: the producer parks with exponential
  backoff (``time.sleep``) while ``head - tail >= capacity``; the consumer
  writes back ``tail`` as it drains, which is what re-opens the window. A
  slow consumer therefore *throttles* the producer — wraparound can never
  overwrite an unconsumed record (tested in ``tests/test_torch_ipc.py``).
* **handshake header**: each ring carries its worker's lifecycle state
  (INIT → ATTACHED → DONE / ERROR), pid, a parent-owned ``go`` gate (the
  start barrier: workers attach + first-touch their stripes, then wait for
  ``go`` so stripe placement is complete before any read), a parent-owned
  ``stop`` flag (graceful drain request), first-touch/pin outcome counters,
  and a short UTF-8 error message area. The supervisor reads the header to
  detect dead children (process gone while state < DONE) and to surface a
  worker's own error message.
* **the worker's report**: a worker that finishes writes a short report
  (``submit=threads hwm=3 tails=1 tail_bytes=32``: its submit backend,
  in-flight high-water mark and direct tails) into the same message area
  before it reports DONE (:meth:`EventRing.set_report`). An ERROR message
  overwrites it.

* **the re-arm words** (pooled workers of ``ipc/service.py``): the session
  epoch a worker is armed with and the last epoch whose drain it finished
  (written strictly last, after DONE), so the service can tell "drained
  and parked" from "still publishing". :meth:`EventRing.rearm_reset` returns
  a drained ring to its pre-session state for the next session; it
  truncates the message area, so the service reads a worker's report
  before it resets the ring.

:class:`CommandRing` is the single-slot mailbox a parked pooled worker
receives its next session's pickled ``WorkerSpec`` through (same
stamp-last, CRC-checked discipline).

All fields are 8-byte little-endian words written with ``struct`` into an
``mmap`` — no third-party deps, no locks shared across processes. The byte
layout of both is the reference package's (``src/repro/ipc/ring.py``), so a
ring or mailbox one package writes, the other reads.
"""
from __future__ import annotations

import struct
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

# -- layout -------------------------------------------------------------------
HDR_BYTES = 96           # 12 u64 fields
MSG_BYTES = 192          # worker error message (UTF-8, truncated)
SLOT_BYTES = 72          # stamp + 8 payload words
_WORD = struct.Struct("<Q")
_SLOT = struct.Struct("<QQQQQQddQ")  # stamp, index, reader, offset, nbytes,
#                                      arena_off, t_arrival, read_dt, epoch
_PAYLOAD = struct.Struct("<QQQQQddQ")  # the slot minus its stamp word

# header word offsets (bytes)
_OFF_CAP = 0
_OFF_HEAD = 8            # producer-owned: next sequence to publish
_OFF_TAIL = 16           # consumer-owned: next sequence to consume
_OFF_STATE = 24          # worker lifecycle state
_OFF_PID = 32
_OFF_GO = 40             # parent-owned: start gate
_OFF_STOP = 48           # parent-owned: drain request
_OFF_PAGES = 56          # worker-reported: first-touched pages << 2 | pin
_OFF_IO_RETRIES = 64     # worker-reported: transient preads retried
_OFF_IO_SUPPRESSED = 72  # worker-reported: advisory errors suppressed
# Pooled-worker re-arm protocol (ipc/service.py): the session generation a
# pooled worker is currently armed with, and the last generation whose
# drain it finished. Per-session workers leave both at 0.
_OFF_EPOCH = 80          # worker-owned: currently-armed session epoch
_OFF_EPOCH_DONE = 88     # worker-owned: last epoch fully drained

# worker lifecycle states (_OFF_STATE)
ST_INIT = 0
ST_ATTACHED = 1
ST_DONE = 2
ST_ERROR = 3

# pin outcome bits packed into _OFF_PAGES (low 2 bits)
PIN_NONE = 0
PIN_OK = 1
PIN_FAILED = 2


def ring_bytes(slots: int) -> int:
    """Total bytes one ring occupies in its shm block."""
    return HDR_BYTES + MSG_BYTES + slots * SLOT_BYTES


def _stamp(seq: int, payload: bytes) -> int:
    """Slot stamp word: ``seq + 1`` (low 32) | seq-keyed payload CRC32
    (high 32). The seq key makes a stale lap's payload un-consumable and
    bounds sequences to 32 bits (4e9 splinters per ring — far beyond any
    session)."""
    return ((zlib.crc32(payload, seq & 0xFFFFFFFF) << 32)
            | ((seq + 1) & 0xFFFFFFFF))


@dataclass(frozen=True)
class RingEvent:
    """One published splinter-read completion (the cross-process analog of
    ``core.buffers.SplinterEvent``, plus the worker-measured read time)."""

    index: int
    reader: int
    offset: int
    nbytes: int
    arena_off: int
    t_arrival: float     # worker-side perf_counter (CLOCK_MONOTONIC —
    #                      comparable across processes on Linux)
    read_dt: float       # wall seconds inside the worker's pread loop
    epoch: int = 0       # session generation that produced this event
    #                      (pooled workers only; 0 = per-session worker)


class EventRing:
    """One SPSC ring over a ``memoryview`` slice of a shared segment.

    The parent constructs with ``create=True`` (zeroes the header, sets the
    capacity); the worker attaches to the same bytes with ``create=False``.
    Producer methods (``publish``, ``set_state``, …) are worker-side;
    consumer methods (``consume``, ``request_stop``, …) are parent-side.
    """

    def __init__(self, buf: memoryview, slots: int, create: bool = False):
        need = ring_bytes(slots)
        if len(buf) < need:
            raise ValueError(f"ring needs {need} bytes, got {len(buf)}")
        if slots < 1:
            raise ValueError("ring needs at least one slot")
        self._buf = buf
        self.slots = slots
        # Producer-side fault hook (``seq -> bool``): when truthy for a
        # sequence, publish() inverts its store order — stamp first, then a
        # ``delay_s`` pause, then the payload — so the consumer observes a
        # stamped slot whose CRC does not match. This is the deterministic
        # torn/stale-slot injector (core/faults.py TornSlot): the consumer
        # must retry the slot, never deliver it torn, never deadlock.
        self.fault: Optional[Callable[[int], bool]] = None
        if create:
            buf[:need] = b"\x00" * need
            _WORD.pack_into(buf, _OFF_CAP, slots)
        else:
            cap = _WORD.unpack_from(buf, _OFF_CAP)[0]
            if cap != slots:
                raise ValueError(
                    f"ring capacity mismatch: header says {cap}, "
                    f"caller expects {slots}")

    # -- word helpers --------------------------------------------------------
    def _get(self, off: int) -> int:
        return _WORD.unpack_from(self._buf, off)[0]

    def _set(self, off: int, val: int) -> None:
        _WORD.pack_into(self._buf, off, val)

    def _slot_off(self, seq: int) -> int:
        return HDR_BYTES + MSG_BYTES + (seq % self.slots) * SLOT_BYTES

    # -- producer side (worker process) --------------------------------------
    def publish(
        self,
        ev: RingEvent,
        *,
        timeout: Optional[float] = None,
        should_abort: Optional[Callable[[], bool]] = None,
    ) -> bool:
        """Publish one record; park with backoff while the ring is full.

        Returns False without publishing when a stop was requested (the
        consumer is tearing the session down and will not drain us — the
        event is intentionally dropped), when ``timeout`` elapses, or when
        ``should_abort()`` turns true (the worker's orphan check: a
        consumer that was SIGKILLed will never drain the ring or set the
        stop flag, so the producer must notice on its own).
        """
        seq = self._get(_OFF_HEAD)
        deadline = None if timeout is None else time.monotonic() + timeout
        pause = 50e-6
        while seq - self._get(_OFF_TAIL) >= self.slots:
            if self.stop_requested():
                return False
            if should_abort is not None and should_abort():
                return False
            if deadline is not None and time.monotonic() > deadline:
                return False
            time.sleep(pause)
            pause = min(pause * 2, 2e-3)     # exponential backoff, 2ms cap
        off = self._slot_off(seq)
        record = _SLOT.pack(
            0,                               # stamp written LAST (below)
            ev.index, ev.reader, ev.offset, ev.nbytes, ev.arena_off,
            ev.t_arrival, ev.read_dt, ev.epoch,
        )
        payload = record[8:]
        if self.fault is not None and self.fault(seq):
            # Injected torn publication: make the stamp visible while the
            # slot still holds the previous lap's payload (what a weakly-
            # ordered host could expose). The stamp's seq-keyed CRC cannot
            # match until the payload store below lands, so a correct
            # consumer retries the slot across the delay window.
            _WORD.pack_into(self._buf, off, _stamp(seq, payload))
            time.sleep(getattr(self.fault, "delay_s", 2e-3))
            self._buf[off + 8: off + SLOT_BYTES] = payload
            self._set(_OFF_HEAD, seq + 1)
            return True
        self._buf[off + 8: off + SLOT_BYTES] = payload
        # Publication point: the stamp (seq | seq-keyed payload CRC) makes
        # the record consumable. The consumer re-derives the CRC from the
        # payload it actually observes, so no cross-process store-ordering
        # assumption is needed (see module docstring).
        _WORD.pack_into(self._buf, off, _stamp(seq, payload))
        self._set(_OFF_HEAD, seq + 1)
        return True

    def set_state(self, state: int) -> None:
        self._set(_OFF_STATE, state)

    def set_pid(self, pid: int) -> None:
        self._set(_OFF_PID, pid)

    def set_touch(self, pages: int, pin: int = PIN_NONE) -> None:
        """Report first-touch page count + pin outcome (packed word)."""
        self._set(_OFF_PAGES, (pages << 2) | (pin & 3))

    def set_io(self, retries: int, suppressed: int) -> None:
        """Report the worker's transient-I/O counters (retried preads,
        suppressed advisory errors). Written after every splinter and on
        the error path, so the parent's fold-in sees the latest values
        even across a crash."""
        self._set(_OFF_IO_RETRIES, retries)
        self._set(_OFF_IO_SUPPRESSED, suppressed)

    def _set_message(self, message: str) -> None:
        raw = message.encode("utf-8", "replace")[: MSG_BYTES - 1]
        self._buf[HDR_BYTES : HDR_BYTES + len(raw)] = raw
        self._buf[HDR_BYTES + len(raw)] = 0

    def set_epoch(self, epoch: int) -> None:
        """Worker-side: record the session generation this worker is now
        armed with. Written before the worker enters the drain loop for a
        pooled session, so the supervisor can attribute ring events."""
        self._set(_OFF_EPOCH, epoch)

    def set_done_epoch(self, epoch: int) -> None:
        """Worker-side: mark ``epoch``'s drain finished. Written LAST in the
        pooled session lifecycle — after ``set_io``, the report and
        ``set_state(DONE)`` — so a supervisor observing ``done_epoch() ==
        epoch`` knows every event of that generation is already published
        and may safely re-arm the ring after one final drain."""
        self._set(_OFF_EPOCH_DONE, epoch)

    def set_error(self, message: str) -> None:
        self._set_message(message)
        self._set(_OFF_STATE, ST_ERROR)

    def set_report(self, fields: Dict[str, object]) -> None:
        """Worker-side: leave ``fields`` as ``key=value`` words in the
        message area (state unchanged; written before DONE)."""
        self._set_message(" ".join(f"{k}={v}" for k, v in fields.items()))

    def wait_go(
        self,
        poll_s: float = 100e-6,
        should_abort: Optional[Callable[[], bool]] = None,
    ) -> bool:
        """Worker-side start barrier: park until the parent opens the gate.
        Returns False if a stop arrives first (session cancelled during
        spawn) or ``should_abort()`` turns true (parent death — the gate
        would never open)."""
        pause = poll_s
        while not self._get(_OFF_GO):
            if self.stop_requested():
                return False
            if should_abort is not None and should_abort():
                return False
            time.sleep(pause)
            pause = min(pause * 2, 2e-3)
        return True

    def stop_requested(self) -> bool:
        return bool(self._get(_OFF_STOP))

    # -- consumer side (parent supervisor) -----------------------------------
    def consume(self, limit: int = 0) -> List[RingEvent]:
        """Drain published records in sequence order (≤ ``limit`` when >0).

        A slot whose stamp sequence matches but whose payload CRC does not
        is a record whose stores are not all visible yet (weakly-ordered
        host) — left in place for the next poll, never consumed torn."""
        out: List[RingEvent] = []
        tail = self._get(_OFF_TAIL)
        while not limit or len(out) < limit:
            off = self._slot_off(tail)
            stamp = _WORD.unpack_from(self._buf, off)[0]
            if (stamp & 0xFFFFFFFF) != (tail + 1) & 0xFFFFFFFF:
                break                        # next record not published yet
            payload = bytes(self._buf[off + 8: off + SLOT_BYTES])
            if _stamp(tail, payload) != stamp:
                break                        # payload not fully visible yet
            rec = _PAYLOAD.unpack(payload)
            out.append(RingEvent(
                index=rec[0], reader=rec[1], offset=rec[2], nbytes=rec[3],
                arena_off=rec[4], t_arrival=rec[5], read_dt=rec[6],
                epoch=rec[7],
            ))
            tail += 1
            # Write back per record (not per batch): each write re-opens a
            # slot for a producer parked on a full ring.
            self._set(_OFF_TAIL, tail)
        return out

    def open_gate(self) -> None:
        self._set(_OFF_GO, 1)

    def request_stop(self) -> None:
        self._set(_OFF_STOP, 1)

    def state(self) -> int:
        return self._get(_OFF_STATE)

    def pid(self) -> int:
        return self._get(_OFF_PID)

    def touch_report(self) -> "tuple[int, int]":
        """(first-touched pages, pin outcome) as reported by the worker."""
        word = self._get(_OFF_PAGES)
        return word >> 2, word & 3

    def error_message(self) -> str:
        raw = bytes(self._buf[HDR_BYTES : HDR_BYTES + MSG_BYTES])
        return raw.split(b"\x00", 1)[0].decode("utf-8", "replace")

    def report(self) -> Dict[str, str]:
        """The ``key=value`` words of a DONE worker's report (empty when it
        wrote none)."""
        return dict(w.split("=", 1) for w in self.error_message().split()
                    if "=" in w)

    def io_report(self) -> "tuple[int, int]":
        """(retried preads, suppressed advisory errors) as last reported by
        the worker — folded into the session's RecoveryMetrics exactly once,
        at supervisor shutdown."""
        return self._get(_OFF_IO_RETRIES), self._get(_OFF_IO_SUPPRESSED)

    def pending(self) -> int:
        """Published-but-unconsumed record count (supervisor diagnostics)."""
        return self._get(_OFF_HEAD) - self._get(_OFF_TAIL)

    def epoch(self) -> int:
        return self._get(_OFF_EPOCH)

    def done_epoch(self) -> int:
        return self._get(_OFF_EPOCH_DONE)

    def rearm_reset(self) -> None:
        """Supervisor-side: return a drained ring to its pre-session state
        so a parked pooled worker can run another session through it.

        Only called while the worker is parked (state DONE, done_epoch
        caught up, nothing in flight), so no producer races the reset.
        Head/tail/capacity/pid survive — sequences keep increasing across
        sessions, which is what makes a stale slot from a previous lap
        un-consumable. Lifecycle words (state, go, stop, touch/pin, io
        counters) and the message area are zeroed so the next session's
        attach barrier and metric fold-in start clean: the caller reads the
        worker's report first."""
        self._set(_OFF_STATE, ST_INIT)
        self._set(_OFF_GO, 0)
        self._set(_OFF_STOP, 0)
        self._set(_OFF_PAGES, 0)
        self._set(_OFF_IO_RETRIES, 0)
        self._set(_OFF_IO_SUPPRESSED, 0)
        self._buf[HDR_BYTES] = 0             # truncate message / report


# -- command mailbox (parent -> parked pooled worker) --------------------------
# One fixed-size single-slot mailbox per pooled worker, carrying the pickled
# WorkerSpec for the next session. Same self-validating discipline as the
# event ring: the parent writes payload + length first and the epoch word
# last (with a CRC keyed by the epoch), the worker CRC-checks before acting
# and acknowledges by echoing the epoch into the ack word. SPSC by
# construction — exactly one parent thread sends, one worker receives.

_CMD_OFF_EPOCH = 0       # parent-owned, written LAST: command generation
_CMD_OFF_ACK = 8         # worker-owned: last epoch read and accepted
_CMD_OFF_STOP = 16       # parent-owned: retire request (worker exits)
_CMD_OFF_LEN = 24        # parent-owned: payload byte length
_CMD_OFF_CRC = 32        # parent-owned: epoch-keyed payload CRC32
_CMD_OFF_PID = 40        # worker-owned: pid heartbeat for diagnostics
CMD_HDR_BYTES = 48


class CommandRing:
    """Single-slot command mailbox over a ``memoryview`` of shared memory.

    ``send`` hands a parked worker its next session spec; ``wait_command``
    is the worker's park loop. The mailbox holds ONE command: a worker must
    ack epoch N before the parent may send N+1, which the service
    guarantees by never re-arming a worker whose previous session has not
    checked back in. A command sent to a worker that is still booting
    waits here until the worker's first ``wait_command``.
    """

    def __init__(self, buf: memoryview, create: bool = False):
        if len(buf) <= CMD_HDR_BYTES:
            raise ValueError("command ring needs payload capacity")
        self._buf = buf
        self.capacity = len(buf) - CMD_HDR_BYTES
        if create:
            buf[:CMD_HDR_BYTES] = b"\x00" * CMD_HDR_BYTES

    def _get(self, off: int) -> int:
        return _WORD.unpack_from(self._buf, off)[0]

    def _set(self, off: int, val: int) -> None:
        _WORD.pack_into(self._buf, off, val)

    # -- parent side ----------------------------------------------------------
    def send(self, epoch: int, payload: bytes) -> None:
        """Publish one command. Caller must ensure the worker is parked
        (previous command acked); enforced here as a fail-fast check."""
        if epoch <= 0:
            raise ValueError("command epoch must be positive")
        if len(payload) > self.capacity:
            raise ValueError(
                f"command payload {len(payload)} bytes exceeds mailbox "
                f"capacity {self.capacity}")
        prev = self._get(_CMD_OFF_EPOCH)
        if prev and self._get(_CMD_OFF_ACK) != prev:
            raise RuntimeError(
                f"command epoch {prev} not yet acked; worker not parked")
        self._buf[CMD_HDR_BYTES: CMD_HDR_BYTES + len(payload)] = payload
        self._set(_CMD_OFF_LEN, len(payload))
        self._set(_CMD_OFF_CRC, zlib.crc32(payload, epoch & 0xFFFFFFFF))
        # Publication point (same stamp-last discipline as EventRing).
        self._set(_CMD_OFF_EPOCH, epoch)

    def request_stop(self) -> None:
        self._set(_CMD_OFF_STOP, 1)

    def acked(self, epoch: int) -> bool:
        return self._get(_CMD_OFF_ACK) == epoch

    def pid(self) -> int:
        return self._get(_CMD_OFF_PID)

    # -- worker side ----------------------------------------------------------
    def set_pid(self, pid: int) -> None:
        self._set(_CMD_OFF_PID, pid)

    def wait_command(
        self,
        last_epoch: int,
        poll_s: float = 100e-6,
        should_abort: Optional[Callable[[], bool]] = None,
    ) -> "Optional[tuple[int, bytes]]":
        """Park until a command newer than ``last_epoch`` arrives.

        Returns ``(epoch, payload)``, or None on a retire request or when
        ``should_abort()`` turns true (orphaned worker). A CRC mismatch
        means the payload stores are not all visible yet on a weakly-
        ordered host — treated exactly like "no command yet" and retried.
        """
        pause = poll_s
        while True:
            if self._get(_CMD_OFF_STOP):
                return None
            if should_abort is not None and should_abort():
                return None
            epoch = self._get(_CMD_OFF_EPOCH)
            if epoch > last_epoch:
                n = self._get(_CMD_OFF_LEN)
                payload = bytes(
                    self._buf[CMD_HDR_BYTES: CMD_HDR_BYTES + n])
                if (zlib.crc32(payload, epoch & 0xFFFFFFFF)
                        == self._get(_CMD_OFF_CRC)):
                    return epoch, payload
                # torn publication — retry without acking
            time.sleep(pause)
            pause = min(pause * 2, 2e-3)

    def ack(self, epoch: int) -> None:
        """Worker-side: acknowledge ``epoch`` — the spec has been read and
        arming has begun; the mailbox slot is free for the next send."""
        self._set(_CMD_OFF_ACK, epoch)
