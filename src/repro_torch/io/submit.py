"""Queue-depth-managed asynchronous read submission (the cold-cache engine).

The synchronous reader loop (`core/buffers.py`) issues one
blocking ``pread`` per splinter: on a warm cache that is a DRAM copy and the
loop is delivery-bound, but on a *cold* cache every splinter pays the full
storage round trip serially — the paper's whole point is that reader tasks
must be tuned to the file system, and a parallel FS (or even one NVMe queue)
wants many requests in flight. This module converts the blocking loop into
depth-managed submission, TASIO-style (Roca Nonell et al., PAPERS.md):

* :class:`IoUringSubmitter` — a ctypes ``io_uring`` ring (Linux 5.1+). SQEs
  carry ``IORING_OP_READ`` straight into the arena views; one
  ``io_uring_enter`` submits a batch and reaps completions. No libaio, no
  third-party package — raw syscalls 425/426.
* :class:`ThreadPoolSubmitter` — the portable fallback: a small worker pool
  draining a submit queue through ``PosixFile.pread_into`` (so the
  ``RetryPolicy``/fault hooks and the O_DIRECT tail accounting are reused
  verbatim), with ``fadvise(WILLNEED)`` issued at submit time so the kernel
  readahead pipeline runs ahead of the pool.

:func:`make_submitter` picks between them (``mode="auto"|"io_uring"|
"threads"``) and :class:`AsyncReadEngine` wraps either in the drain-loop
shape the reader threads run: keep ``queue_depth`` splinters in flight,
advise a ``readahead_bytes`` window ahead of the submission frontier, hand
completions to the caller as they land. Queue-depth is an *invariant*, not a
hint: the engine never has more than ``depth`` reads outstanding, and
``close()`` drains every outstanding read before returning.

Error/fault semantics match the synchronous path: transient errnos
(``RetryPolicy.errnos``) are retried (counted via ``record_io_retry`` on the
stats sink), fault hooks are consulted at submission with the same
``(offset, nbytes) -> Optional[cap]`` contract, short reads continue from
where they stopped, and EOF completes short. O_DIRECT files submit the
block-aligned body through the ring and finish sub-block tails through the
buffered descriptor — counted, never silent (``record_direct_tail``).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import errno
import mmap
import os
import queue
import struct
import threading
import time
from typing import Callable, List, Optional, Tuple

from repro_torch.io.posix import (
    IO_EVENTS,
    DirectIOError,
    PosixFile,
    _buf_addr,
)

# -- io_uring ABI (validated on this kernel: features 0x3ffff) ---------------
_SYS_io_uring_setup = 425
_SYS_io_uring_enter = 426
_IORING_OP_READ = 22
_IORING_ENTER_GETEVENTS = 1
_IORING_OFF_SQ_RING = 0
_IORING_OFF_CQ_RING = 0x8000000
_IORING_OFF_SQES = 0x10000000
_IORING_FEAT_SINGLE_MMAP = 0x1

# struct io_uring_params: 7 config u32 + resv[3] + sq_off (10 u32) +
# cq_off (10 u32) = 120 bytes.
_PARAMS_LEN = 120
# sq_off u32 indices within its block: head,tail,ring_mask,ring_entries,
# flags,dropped,array; cq_off: head,tail,ring_mask,ring_entries,overflow,cqes.
_SQ_OFF_BASE = 40
_CQ_OFF_BASE = 80
# First 40 bytes of an SQE: opcode,flags,ioprio,fd,off,addr,len,rw_flags,
# user_data; the remaining 24 are zero for plain reads.
_SQE_PACK = "<BBHiQQIIQ"
_SQE_SIZE = 64
_CQE_PACK = "<QiI"
_CQE_SIZE = 16

_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        _libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                            use_errno=True)
    return _libc


_uring_probe: Optional[bool] = None
_uring_probe_lock = threading.Lock()


def io_uring_supported() -> bool:
    """One-shot probe: can this kernel/sandbox set up an io_uring?

    Seccomp policies commonly block the syscall (EPERM/ENOSYS), so the
    probe actually performs a tiny setup and closes it. Cached; the
    ``CKIO_NO_IOURING`` env var forces False (CI determinism)."""
    global _uring_probe
    if os.environ.get("CKIO_NO_IOURING"):
        return False
    with _uring_probe_lock:
        if _uring_probe is None:
            try:
                libc = _get_libc()
                params = ctypes.create_string_buffer(_PARAMS_LEN)
                fd = libc.syscall(_SYS_io_uring_setup, 2,
                                  ctypes.byref(params))
                if fd < 0:
                    _uring_probe = False
                else:
                    os.close(fd)
                    _uring_probe = True
            except Exception:
                _uring_probe = False
        return _uring_probe


class Completion:
    """One finished read: ``token`` is whatever the caller submitted with."""

    __slots__ = ("token", "nbytes", "error", "dt")

    def __init__(self, token, nbytes: int, error: Optional[BaseException],
                 dt: float):
        self.token = token
        self.nbytes = nbytes
        self.error = error
        self.dt = dt


class _SubmitterBase:
    """Shared bookkeeping: inflight count + high-water mark."""

    kind = "base"

    def __init__(self, file, depth: int, *, stats=None, fault=None):
        if depth < 1:
            raise ValueError(f"queue depth must be >= 1, got {depth}")
        self.file = file
        self.depth = int(depth)
        self.stats = stats if stats is not None else IO_EVENTS
        self.fault = fault
        self.max_inflight = 0
        self._inflight = 0
        self._lock = threading.Lock()

    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def can_submit(self) -> bool:
        with self._lock:
            return self._inflight < self.depth

    def _inc(self) -> None:
        with self._lock:
            # Reject BEFORE counting: a refused submit must not poison the
            # inflight ledger (close(drain=True) would wait on a phantom op).
            if self._inflight + 1 > self.depth:
                raise RuntimeError(
                    f"queue-depth invariant violated: {self._inflight + 1} "
                    f"> {self.depth}")
            self._inflight += 1
            if self._inflight > self.max_inflight:
                self.max_inflight = self._inflight

    def _dec(self, n: int = 1) -> None:
        with self._lock:
            self._inflight -= n

    def submit(self, token, offset: int, view: memoryview) -> None:
        raise NotImplementedError

    def wait(self, timeout: float) -> List[Completion]:
        raise NotImplementedError

    def close(self, drain: bool = True) -> None:
        raise NotImplementedError


class ThreadPoolSubmitter(_SubmitterBase):
    """preadv worker-pool fallback with WILLNEED pipelining.

    ``submit`` advises ``WILLNEED`` on the request range (kernel readahead
    starts fetching while the pool is busy on earlier splinters) and queues
    the read; pool threads run ``file.pread_into`` — which releases the GIL
    per syscall, so ``min(depth, 8)`` threads give real I/O concurrency and
    every retry/fault/direct-tail behaviour of the synchronous path is
    inherited unchanged. A pool thread starts when the reads in flight first
    outnumber the threads, so a session of a few splinters starts a few
    threads, not eight. Optional ``delay`` (the benchmark cost model) runs
    ON the pool thread, so modeled request latencies overlap exactly like
    real ones."""

    kind = "threads"

    def __init__(self, file, depth: int, *, stats=None, fault=None,
                 delay: Optional[Callable[[object, int], None]] = None):
        super().__init__(file, depth, stats=stats, fault=fault)
        self._delay = delay
        self._work: "queue.Queue" = queue.Queue()
        self._done: "queue.Queue" = queue.Queue()
        self._stop = False
        self._max_threads = max(1, min(self.depth, 8))
        self._threads: List[threading.Thread] = []

    def _worker(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            token, off, view, t0 = item
            nbytes, err = 0, None
            try:
                if self._delay is not None:
                    self._delay(token, len(view))
                nbytes = self.file.pread_into(
                    off, view, stats=self.stats, fault=self.fault)
            except BaseException as e:     # delivered, not swallowed
                err = e
            self._done.put(Completion(token, nbytes, err,
                                      time.perf_counter() - t0))

    def submit(self, token, offset: int, view: memoryview) -> None:
        self._inc()
        if len(self._threads) < min(self.inflight(), self._max_threads):
            t = threading.Thread(target=self._worker, daemon=True,
                                 name=f"ckio-submit-{len(self._threads)}")
            self._threads.append(t)
            t.start()
        if not getattr(self.file, "direct_io", False):
            try:
                self.file.advise_sequential(offset, len(view),
                                            stats=self.stats)
            except OSError:
                pass                       # advisory only
        self._work.put((token, offset, view, time.perf_counter()))

    def wait(self, timeout: float) -> List[Completion]:
        out: List[Completion] = []
        try:
            out.append(self._done.get(timeout=timeout))
        except queue.Empty:
            return out
        while True:                        # opportunistic batch drain
            try:
                out.append(self._done.get_nowait())
            except queue.Empty:
                break
        self._dec(len(out))
        return out

    def close(self, drain: bool = True) -> None:
        if self._stop:
            return
        if drain:
            deadline = time.monotonic() + 60.0
            while self.inflight() > 0 and time.monotonic() < deadline:
                self.wait(0.05)
        self._stop = True
        for _ in self._threads:
            self._work.put(None)
        for t in self._threads:
            t.join(timeout=10.0)


class _Pending:
    """In-flight io_uring op: tracks continuation + retry state."""

    __slots__ = ("token", "offset", "view", "done", "attempts",
                 "deadline", "t0")

    def __init__(self, token, offset: int, view: memoryview, t0: float):
        self.token = token
        self.offset = offset               # file offset of view[0]
        self.view = view
        self.done = 0                      # bytes completed so far
        self.attempts = 0
        self.deadline: Optional[float] = None
        self.t0 = t0


class IoUringSubmitter(_SubmitterBase):
    """ctypes io_uring: batched async reads straight into arena views.

    Single-threaded by design — ``submit``/``wait`` must be called from one
    thread (each reader owns its own ring, mirroring "each buffer chare
    owns its section"). The kernel only reads the SQ during
    ``io_uring_enter`` (no SQPOLL), so the syscall doubles as the memory
    barrier and plain struct writes into the mapped rings are safe.

    Semantics parity with ``pread_into``: the fault hook is consulted at
    each (re)submission and may cap the length or raise; transient CQE
    errnos are resubmitted under the file's ``RetryPolicy`` budget (counted
    via ``record_io_retry``); short completions resubmit the remainder;
    ``res == 0`` is EOF. For O_DIRECT files the ring carries the
    block-aligned body (on ``direct_fd``) and the sub-block tail finishes
    through the buffered descriptor via ``file.pread_into`` — counted."""

    kind = "io_uring"

    def __init__(self, file, depth: int, *, stats=None, fault=None):
        super().__init__(file, depth, stats=stats, fault=fault)
        if not isinstance(file, PosixFile):
            raise ValueError(
                f"io_uring submitter needs a plain PosixFile (one fd per "
                f"ring); got {type(file).__name__} — use mode='threads'")
        self._direct = file.direct_io and file.direct_fd >= 0
        self._fd = file.direct_fd if self._direct else file.fd
        self._bs = file.block_size
        libc = _get_libc()
        entries = 1
        while entries < depth:
            entries <<= 1
        params = ctypes.create_string_buffer(_PARAMS_LEN)
        ring_fd = libc.syscall(_SYS_io_uring_setup, entries,
                               ctypes.byref(params))
        if ring_fd < 0:
            e = ctypes.get_errno()
            raise OSError(e, f"io_uring_setup failed: {os.strerror(e)}")
        self._ring_fd = ring_fd
        p = struct.unpack("<30I", params.raw)
        sq_entries, cq_entries, features = p[0], p[1], p[5]
        sq = p[_SQ_OFF_BASE // 4: _SQ_OFF_BASE // 4 + 10]
        cq = p[_CQ_OFF_BASE // 4: _CQ_OFF_BASE // 4 + 10]
        self._sq_head_off, self._sq_tail_off = sq[0], sq[1]
        self._sq_mask = None
        self._sq_array_off = sq[6]
        self._cq_head_off, self._cq_tail_off = cq[0], cq[1]
        self._cqes_off = cq[5]
        sq_sz = self._sq_array_off + sq_entries * 4
        cq_sz = self._cqes_off + cq_entries * _CQE_SIZE
        try:
            if features & _IORING_FEAT_SINGLE_MMAP:
                sz = max(sq_sz, cq_sz)
                self._sq_ring = mmap.mmap(ring_fd, sz,
                                          offset=_IORING_OFF_SQ_RING)
                self._cq_ring = self._sq_ring
            else:
                self._sq_ring = mmap.mmap(ring_fd, sq_sz,
                                          offset=_IORING_OFF_SQ_RING)
                self._cq_ring = mmap.mmap(ring_fd, cq_sz,
                                          offset=_IORING_OFF_CQ_RING)
            self._sqes = mmap.mmap(ring_fd, sq_entries * _SQE_SIZE,
                                   offset=_IORING_OFF_SQES)
        except OSError:
            os.close(ring_fd)
            raise
        self._sq_entries = sq_entries
        self._sq_mask = struct.unpack_from(
            "<I", self._sq_ring, sq[2])[0]
        self._cq_mask = struct.unpack_from(
            "<I", self._cq_ring, cq[2])[0]
        self._libc = libc
        self._pending: dict = {}           # id -> _Pending
        self._next_id = 1
        self._retry_q: List[_Pending] = []  # transient failures to resubmit
        self._closed = False

    # -- ring plumbing ----------------------------------------------------
    def _push_sqe(self, op_id: int, fd: int, off: int, addr: int,
                  nbytes: int) -> None:
        tail = struct.unpack_from("<I", self._sq_ring, self._sq_tail_off)[0]
        idx = tail & self._sq_mask
        sqe = struct.pack(_SQE_PACK, _IORING_OP_READ, 0, 0, fd,
                          off, addr, nbytes, 0, op_id)
        self._sqes[idx * _SQE_SIZE: idx * _SQE_SIZE + len(sqe)] = sqe
        self._sqes[idx * _SQE_SIZE + len(sqe):
                   (idx + 1) * _SQE_SIZE] = b"\x00" * (_SQE_SIZE - len(sqe))
        struct.pack_into("<I", self._sq_ring,
                         self._sq_array_off + idx * 4, idx)
        struct.pack_into("<I", self._sq_ring, self._sq_tail_off, tail + 1)

    def _enter(self, to_submit: int, min_complete: int, flags: int) -> int:
        while True:
            r = self._libc.syscall(_SYS_io_uring_enter, self._ring_fd,
                                   to_submit, min_complete, flags, None, 0)
            if r >= 0:
                return r
            e = ctypes.get_errno()
            if e != errno.EINTR:
                raise OSError(e, f"io_uring_enter: {os.strerror(e)}")

    def _issue(self, pend: _Pending) -> Optional[Completion]:
        """Push the next slice of ``pend`` onto the ring (fault hook applied).

        Returns a Completion when the op finishes synchronously instead
        (fault error past retry budget, or an all-tail direct read)."""
        remaining = len(pend.view) - pend.done
        pos = pend.offset + pend.done
        cap = remaining
        if self.fault is not None:
            try:
                c = self.fault(pos, cap)
                if c is not None:
                    cap = max(1, min(cap, int(c)))
            except OSError as e:
                comp = self._op_error(pend, e.errno)
                if comp is not None:
                    return comp
                self._retry_q.append(pend)   # resubmit on next wait()
                return None
        if self._direct:
            if pos % self._bs == 0 and cap >= self._bs:
                cap = (cap // self._bs) * self._bs
            else:
                # Sub-block fragment: finish synchronously through the
                # buffered fd (pread_into counts it via record_direct_tail).
                frag = min(cap, remaining)
                got = self.file.pread_into(
                    pos, pend.view[pend.done: pend.done + frag],
                    stats=self.stats)
                pend.done += got
                if got < frag or pend.done >= len(pend.view):
                    return Completion(pend.token, pend.done, None,
                                      time.perf_counter() - pend.t0)
                return self._issue(pend)
        op_id = self._next_id
        self._next_id += 1
        self._pending[op_id] = pend
        addr = _buf_addr(pend.view) + pend.done
        self._push_sqe(op_id, self._fd, pos, addr, cap)
        self._enter(1, 0, 0)
        return None

    def _op_error(self, pend: _Pending, err: Optional[int]
                  ) -> Optional[Completion]:
        """Retry-budget accounting for one failed slice. None = retry OK."""
        pol = self.file.retry
        if err not in pol.errnos:
            return Completion(
                pend.token, pend.done,
                OSError(err or 0, os.strerror(err or 0)),
                time.perf_counter() - pend.t0)
        if pend.deadline is None:
            pend.deadline = time.monotonic() + pol.deadline_s
        pend.attempts += 1
        if pend.attempts > pol.max_retries or \
                time.monotonic() > pend.deadline:
            return Completion(
                pend.token, pend.done, OSError(err, os.strerror(err)),
                time.perf_counter() - pend.t0)
        self.stats.record_io_retry(err)
        return None

    # -- submitter surface -------------------------------------------------
    def submit(self, token, offset: int, view: memoryview) -> None:
        if self._direct and len(view) > 0:
            if offset % self._bs:
                raise DirectIOError(
                    f"direct async read at offset {offset} is off the "
                    f"{self._bs}-byte block grid of {self.file.path!r}")
            if _buf_addr(view) % self._bs:
                raise DirectIOError(
                    f"direct async read destination is not {self._bs}-byte "
                    f"aligned for {self.file.path!r}")
        self._inc()
        pend = _Pending(token, offset, view, time.perf_counter())
        comp = self._issue(pend)
        if comp is not None:
            self._retry_q.append(comp)     # deliver via next wait()

    def wait(self, timeout: float) -> List[Completion]:
        out: List[Completion] = []
        # Synchronously-finished ops and transient resubmissions first.
        # (_issue may append to _retry_q again — a fault hook raising on the
        # resubmission — so iterate a snapshot.)
        retries, self._retry_q = self._retry_q, []
        for item in retries:
            if isinstance(item, Completion):
                out.append(item)
            else:
                comp = self._issue(item)
                if comp is not None:
                    out.append(comp)
        if self._pending:
            # Reap; block for at least one CQE only when there is nothing
            # to deliver yet (enter returns at once if CQEs are ready).
            block = not out and timeout > 0
            self._enter(0, 1 if block else 0,
                        _IORING_ENTER_GETEVENTS if block else 0)
        head = struct.unpack_from("<I", self._cq_ring, self._cq_head_off)[0]
        tail = struct.unpack_from("<I", self._cq_ring, self._cq_tail_off)[0]
        while head != tail:
            idx = head & self._cq_mask
            user_data, res, _ = struct.unpack_from(
                _CQE_PACK, self._cq_ring, self._cqes_off + idx * _CQE_SIZE)
            head += 1
            pend = self._pending.pop(user_data, None)
            if pend is None:
                continue                   # stale (op already errored out)
            if res < 0:
                comp = self._op_error(pend, -res)
                if comp is not None:
                    out.append(comp)
                else:
                    comp = self._issue(pend)
                    if comp is not None:
                        out.append(comp)
            elif res == 0:                 # EOF — complete short
                out.append(Completion(pend.token, pend.done, None,
                                      time.perf_counter() - pend.t0))
            else:
                pend.done += res
                pend.attempts = 0
                pend.deadline = None
                if pend.done >= len(pend.view):
                    out.append(Completion(pend.token, pend.done, None,
                                          time.perf_counter() - pend.t0))
                else:
                    comp = self._issue(pend)
                    if comp is not None:
                        out.append(comp)
        struct.pack_into("<I", self._cq_ring, self._cq_head_off, head)
        if out:
            self._dec(len(out))
        return out

    def close(self, drain: bool = True) -> None:
        if self._closed:
            return
        if drain:
            deadline = time.monotonic() + 60.0
            while self.inflight() > 0 and time.monotonic() < deadline:
                self.wait(0.05)
        self._closed = True
        try:
            self._sqes.close()
            if self._cq_ring is not self._sq_ring:
                self._cq_ring.close()
            self._sq_ring.close()
        except BufferError:
            pass                           # pending exports; kernel fd close
        os.close(self._ring_fd)


def ring_selected(file, mode: str = "auto",
                  delay: Optional[Callable[[object, int], None]] = None
                  ) -> bool:
    """Whether :func:`make_submitter` takes the io_uring ring for ``file``.

    ``mode="io_uring"`` demands the ring (raises with the reason when the
    kernel/sandbox or the file type cannot support it); ``"threads"`` forces
    the worker pool; ``"auto"`` uses the ring when supported for a plain
    ``PosixFile`` with no delay model, else the pool. Reader sets call this
    at session start, so a forced mode that cannot run fails the start."""
    if mode not in ("auto", "io_uring", "threads"):
        raise ValueError(f"unknown submit mode {mode!r}")
    if mode == "io_uring":
        if not isinstance(file, PosixFile):
            raise ValueError(
                f"submit_mode='io_uring' needs a plain PosixFile, got "
                f"{type(file).__name__} (sharded handles use 'threads')")
        if delay is not None:
            raise ValueError(
                "submit_mode='io_uring' cannot host a delay model "
                "(modeled latencies need pool threads to overlap)")
        if not io_uring_supported():
            raise ValueError(
                "submit_mode='io_uring' but io_uring_setup is unavailable "
                "here (old kernel or seccomp) — use 'auto' or 'threads'")
        return True
    return (mode == "auto" and isinstance(file, PosixFile) and delay is None
            and io_uring_supported())


def make_submitter(file, depth: int, *, mode: str = "auto", stats=None,
                   fault=None,
                   delay: Optional[Callable[[object, int], None]] = None
                   ) -> _SubmitterBase:
    """Pick a submission backend by :func:`ring_selected`. The chosen
    backend is visible to callers as ``.kind`` (recorded into
    ``SessionMetrics`` as ``submit_backend`` — selection is observable,
    never silent)."""
    if ring_selected(file, mode, delay):
        return IoUringSubmitter(file, depth, stats=stats, fault=fault)
    return ThreadPoolSubmitter(file, depth, stats=stats, fault=fault,
                               delay=delay)


class AsyncReadEngine:
    """The depth-managed drain loop of the reader threads.

    ``run(next_item, on_complete, stop)`` pulls ``(token, offset, view)``
    tuples from ``next_item`` (None = source exhausted), keeps up to
    ``depth`` in flight, advises a ``readahead_bytes`` WILLNEED window ahead
    of the submission frontier (buffered files only — O_DIRECT bypasses the
    page cache, where queue depth IS the readahead), and calls
    ``on_complete(token, nbytes, dt)`` as reads land. A completion error is
    raised in the caller's thread after the engine stops submitting, exactly
    like a synchronous pread failure. ``stop()`` returning True drains
    what is in flight and returns early (splinters never marked done twice).
    """

    def __init__(self, file, depth: int, *, readahead_bytes: int = 0,
                 mode: str = "auto", stats=None, fault=None,
                 delay: Optional[Callable[[object, int], None]] = None):
        self.sub = make_submitter(file, depth, mode=mode, stats=stats,
                                  fault=fault, delay=delay)
        self.file = file
        self.readahead_bytes = max(0, int(readahead_bytes))
        self.stats = stats
        self._advised_to = -1

    @property
    def kind(self) -> str:
        return self.sub.kind

    @property
    def max_inflight(self) -> int:
        return self.sub.max_inflight

    def _advise_ahead(self, offset: int, nbytes: int) -> None:
        if self.readahead_bytes <= 0 or getattr(self.file, "direct_io",
                                                False):
            return
        lo = max(offset + nbytes, self._advised_to)
        hi = offset + nbytes + self.readahead_bytes
        size = getattr(self.file, "size", None)
        if size is not None:
            hi = min(hi, size)
        if hi > lo:
            try:
                self.file.advise_sequential(lo, hi - lo, stats=self.stats)
            except OSError:
                pass
            self._advised_to = hi

    def run(self,
            next_item: Callable[[], Optional[Tuple[object, int, memoryview]]],
            on_complete: Callable[[object, int, float], None],
            stop: Optional[Callable[[], bool]] = None,
            poll_s: float = 0.05) -> int:
        """Drain the source; returns the number of completed reads."""
        done = 0
        exhausted = False
        error: Optional[BaseException] = None
        try:
            while True:
                if stop is not None and stop():
                    break
                while not exhausted and error is None \
                        and self.sub.can_submit():
                    item = next_item()
                    if item is None:
                        exhausted = True
                        break
                    token, off, view = item
                    self._advise_ahead(off, len(view))
                    self.sub.submit(token, off, view)
                if self.sub.inflight() == 0:
                    if exhausted or error is not None:
                        break
                for comp in self.sub.wait(poll_s):
                    if comp.error is not None and error is None:
                        error = comp.error
                        continue
                    on_complete(comp.token, comp.nbytes, comp.dt)
                    done += 1
        finally:
            # The main loop only exits with inflight == 0 on clean/error
            # paths; this drain matters on the stop() path, where the
            # still-outstanding reads complete but are deliberately NOT
            # marked done (the session is being cancelled).
            self.sub.close(drain=True)
        if error is not None:
            raise error
        return done
