"""Thin POSIX I/O wrapper used by CkIO buffer readers.

All reads are positional (``os.pread``) so a single file descriptor can be
shared by many reader threads without seek races — this mirrors the paper's
buffer chares each reading a disjoint section of one shared file. ``os.pread``
releases the GIL for the duration of the syscall, which is what lets helper
I/O threads overlap with host-side compute (paper §III-C.4).

Transient-error handling (the recovery layer's lowest rung)
-----------------------------------------------------------
At scale the dominant failure class is *transient* device/FS errors —
``EINTR``/``EAGAIN`` from signal/async plumbing and sporadic ``EIO`` from a
flaky path to storage. Every pread here therefore runs under a
:class:`RetryPolicy`: a failed syscall whose errno is in the policy's set is
retried with exponential backoff, capped both by a retry count and a
per-call wall-clock deadline, so a *persistently* failing device still
surfaces its error promptly instead of spinning. Retries are **counted,
never silent**: each call takes a ``stats`` sink (duck-typed —
``record_io_retry(errno)`` / ``record_suppressed(errno)``; the reader layer
passes its session's ``RecoveryMetrics``) falling back to the module-level
:data:`IO_EVENTS` aggregate so no suppression is ever dropped on the floor.

Fault injection: ``pread_into``/``pread`` consult an optional ``fault``
hook (``(offset, nbytes) -> Optional[int]``, may raise ``OSError``) before
each syscall — the deterministic short-read / flaky-EIO injection point
used by ``core/faults.py`` (picklable, so it also ships to reader worker
processes through ``WorkerSpec.io_fault``).

Direct I/O mode (the cold-cache contract)
-----------------------------------------
``PosixFile.open(path, direct_io=True)`` opens a second ``O_DIRECT``
descriptor next to the buffered one. Direct reads bypass the page cache
entirely — the kernel DMAs straight into the session arena — which is the
honest way to measure (and serve) the storage path the paper targets:
``drop_page_cache``-based eviction is advisory, but an O_DIRECT read can
never be satisfied from DRAM in the first place.

The price is alignment: file offset, request length, and the destination
buffer address must all be multiples of the filesystem block size (probed
per path via :func:`fs_block_size` — ``os.statvfs``, falling back to
:data:`DEFAULT_ALIGN`). The splinter grid already provides aligned offsets
(``aligned_floor`` over the probed block size) and the session arena is
placed on the block grid (``core/buffers.py`` over-allocates one block),
so the steady-state read path satisfies this for free. The
two legal violations are handled, **counted, never silent**:

* a *tail* shorter than one block (end of a stripe/file) is read through
  the buffered descriptor and counted via ``record_direct_tail`` on the
  stats sink (falling back to :data:`IO_EVENTS`);
* anything structurally misaligned (arena base, session offset, shard
  ``file_base``) raises :class:`DirectIOError` with a descriptive message
  at open/start time — there is no silent fallback to buffered mode.

When to expect O_DIRECT to *lose*: warm-cache re-reads (buffered reads are
DRAM copies), tiny requests (per-request DMA setup dominates), and FSes
where the kernel's own readahead pipelines better than the submitted queue
depth. It wins on genuinely cold data, on memory-pressured nodes (no cache
pollution: a training epoch's worth of token shards never evicts the
model's pages), and wherever tail latency from page-cache writeback
interference matters.

``ShardedFile`` presents the shards of a FileSet as one byte space.
"""
from __future__ import annotations

import ctypes
import errno
import os
import threading
import time
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# Typical FS block size; stripe/splinter boundaries are aligned to this when
# possible to avoid read-modify-write amplification on the storage side.
# Prefer :func:`fs_block_size` (statvfs probe) wherever a path is in hand —
# this constant is only the probe's fallback and the no-path default.
DEFAULT_ALIGN = 4096


def aligned_floor(nbytes: int, align: int = DEFAULT_ALIGN) -> int:
    """Largest multiple of ``align`` that is <= ``nbytes`` — but never below
    ``align`` itself. The zero-copy read path plans preadv offsets on
    splinter boundaries, so every dynamically-chosen splinter size must pass
    through this floor (a sub-block size would put read offsets off the FS
    block grid and re-introduce read-modify-write amplification)."""
    return max(align, (nbytes // align) * align)


def fs_block_size(path: str, fallback: int = DEFAULT_ALIGN) -> int:
    """Probe the filesystem block size backing ``path`` via ``os.statvfs``.

    Returns ``f_bsize`` (the preferred I/O block size — this is also the
    O_DIRECT alignment requirement on Linux for every mainstream FS) when it
    is a sane power of two in ``[512, 1 MiB]``; otherwise ``fallback``.
    A missing path is probed through its parent directory so callers can
    plan before the file exists."""
    p = path
    for _ in range(2):
        try:
            bs = int(os.statvfs(p).f_bsize)
            if 512 <= bs <= (1 << 20) and (bs & (bs - 1)) == 0:
                return bs
            return fallback
        except (OSError, AttributeError):
            p = os.path.dirname(p) or "."
    return fallback


class DirectIOError(OSError):
    """Raised when ``direct_io=True`` cannot be honoured.

    Deliberately an error, not a warning: the direct-I/O contract is
    "runs end-to-end or fails fast with the reason" — a silent fallback to
    buffered reads would report cold-cache numbers that are really DRAM."""


def _buf_addr(view: memoryview) -> int:
    """Virtual address of a writable buffer (for O_DIRECT alignment checks)."""
    return ctypes.addressof(ctypes.c_char.from_buffer(view))


def supports_direct_io(path: str) -> bool:
    """True when ``path``'s filesystem accepts ``O_DIRECT`` opens."""
    try:
        fd = os.open(path, os.O_RDONLY | os.O_DIRECT)
    except (OSError, AttributeError):
        return False
    os.close(fd)
    return True

# os.preadv reads straight into a caller-provided buffer (no intermediate
# bytes object); available on Linux/BSD since Python 3.7. When absent we fall
# back to the allocate-then-copy pread path (also used by benchmarks to
# measure the cost of that extra copy).
HAVE_PREADV = hasattr(os, "preadv")

# fadvise errnos that mean "this file/FS does not support the hint" — the
# only OSErrors the advisory helpers may swallow (counted, see IO_EVENTS).
# Anything else (EBADF — a closed/reused descriptor — above all) is a bug
# in the caller and propagates.
_FADVISE_SUPPRESS = (
    errno.EINVAL,
    errno.ESPIPE,
    errno.ENOSYS,
    errno.EOPNOTSUPP,
    getattr(errno, "ENOTSUP", errno.EOPNOTSUPP),
)


@dataclass(frozen=True)
class RetryPolicy:
    """Deadline-capped exponential backoff for transient I/O errors.

    A syscall failing with an errno in ``errnos`` is retried up to
    ``max_retries`` times, sleeping ``base_backoff_s`` doubled per attempt
    (capped at ``max_backoff_s``), but never past ``deadline_s`` of total
    wall time for one logical call — a dead device fails fast, a blip is
    absorbed. ``EINTR`` is included for completeness (Python retries it
    itself since PEP 475, but a custom signal handler raising keeps it
    reachable); ``EAGAIN`` covers O_NONBLOCK-ish paths; ``EIO`` is the
    transient-media class Cloud's survey names dominant at scale."""

    max_retries: int = 4
    base_backoff_s: float = 0.5e-3
    max_backoff_s: float = 20e-3
    deadline_s: float = 2.0
    errnos: Tuple[int, ...] = (errno.EINTR, errno.EAGAIN, errno.EIO)


class IOEventCounts:
    """Process-wide fallback sink for retry/suppression counts.

    Callers that have a session context pass their own sink (the session's
    ``RecoveryMetrics``); everything else lands here so no suppressed error
    or retry is ever silently dropped. Thread-safe."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.retries = 0
        self.suppressed = 0
        self.direct_tail_reads = 0
        self.direct_tail_bytes = 0
        self.by_errno: Dict[int, int] = {}

    def record_io_retry(self, err: Optional[int] = None) -> None:
        with self._lock:
            self.retries += 1
            if err is not None:
                self.by_errno[err] = self.by_errno.get(err, 0) + 1

    def record_suppressed(self, err: Optional[int] = None) -> None:
        with self._lock:
            self.suppressed += 1
            if err is not None:
                self.by_errno[err] = self.by_errno.get(err, 0) + 1

    def record_direct_tail(self, nbytes: int = 0) -> None:
        with self._lock:
            self.direct_tail_reads += 1
            self.direct_tail_bytes += int(nbytes)


IO_EVENTS = IOEventCounts()


@dataclass
class PosixFile:
    """A shared, positionally-read file handle.

    One instance is shared by every BufferReader of every session on this
    "node" — matching the paper's model where chares on a node share the file
    opened by the runtime.

    Within a process, the rule stays: every sharer that outlives the
    opener must ``addref()`` and balance it with ``close()``; the last
    ``close`` releases the descriptor.
    """

    path: str
    fd: int = -1
    size: int = 0
    # When False (or when the platform lacks os.preadv) pread_into uses the
    # allocate-then-copy fallback; benchmarks flip this to quantify the copy.
    use_preadv: bool = True
    # Transient-error retry policy for every pread through this handle.
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    # Test/bench fault hook consulted before each syscall:
    # ``(abs_offset, nbytes) -> Optional[int]`` — return a byte cap to force
    # a short read, raise OSError to inject a (possibly transient) failure.
    # Per-call ``fault=`` overrides this; reader workers set it from
    # ``WorkerSpec.io_fault`` (core/faults.py hooks are picklable).
    fault: Optional[object] = None
    # Direct-I/O mode: ``direct_fd`` is the O_DIRECT descriptor (body reads),
    # ``fd`` stays buffered (sub-block tails, advisory hints). ``block_size``
    # is the probed alignment every direct read must honour.
    direct_io: bool = False
    direct_fd: int = -1
    block_size: int = DEFAULT_ALIGN
    _refcount: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    @classmethod
    def open(cls, path: str, *, direct_io: bool = False) -> "PosixFile":
        fd = os.open(path, os.O_RDONLY)
        size = os.fstat(fd).st_size
        bs = fs_block_size(path)
        direct_fd = -1
        if direct_io:
            if not HAVE_PREADV:
                os.close(fd)
                raise DirectIOError(
                    f"direct_io=True needs os.preadv (read straight into an "
                    f"aligned arena view); this platform lacks it — cannot "
                    f"open {path!r} in direct mode")
            flag = getattr(os, "O_DIRECT", 0)
            if not flag:
                os.close(fd)
                raise DirectIOError(
                    f"direct_io=True: os.O_DIRECT is not available on this "
                    f"platform — cannot open {path!r} in direct mode")
            try:
                direct_fd = os.open(path, os.O_RDONLY | flag)
            except OSError as e:
                os.close(fd)
                raise DirectIOError(
                    f"direct_io=True: O_DIRECT open of {path!r} failed with "
                    f"errno {e.errno} ({os.strerror(e.errno or 0)}) — the "
                    f"filesystem does not support direct I/O") from e
        f = cls(path=path, fd=fd, size=size, direct_io=direct_io,
                direct_fd=direct_fd, block_size=bs)
        f._refcount = 1
        return f

    def addref(self) -> None:
        with self._lock:
            self._refcount += 1

    def pread(self, offset: int, nbytes: int, *, stats=None) -> bytes:
        """Positional read; safe from any thread; releases the GIL.
        Transient errors retry under ``self.retry`` (counted in ``stats``,
        default the module aggregate)."""
        if nbytes <= 0:
            return b""
        sink = stats if stats is not None else IO_EVENTS
        pol = self.retry
        attempts, pause, deadline = 0, pol.base_backoff_s, None
        while True:
            try:
                return os.pread(self.fd, nbytes, offset)
            except OSError as e:
                if e.errno not in pol.errnos:
                    raise
                if deadline is None:
                    deadline = time.monotonic() + pol.deadline_s
                attempts += 1
                if attempts > pol.max_retries or time.monotonic() > deadline:
                    raise
                sink.record_io_retry(e.errno)
                time.sleep(pause)
                pause = min(pause * 2.0, pol.max_backoff_s)

    def pread_into(self, offset: int, view: memoryview, *,
                   stats=None, fault=None) -> int:
        """Positional read into a caller-provided buffer — zero intermediate
        copies on the preadv path.

        Loops on short reads (the kernel may return fewer bytes than asked,
        e.g. across page-cache/readahead boundaries) and stops at EOF, so the
        return value is only < len(view) when the file genuinely ends inside
        the range. Safe from any thread; releases the GIL per syscall.

        Transient errors (``self.retry.errnos``) are retried per syscall
        with deadline-capped exponential backoff; each retry is counted in
        ``stats`` (``record_io_retry``), defaulting to :data:`IO_EVENTS`.
        ``fault`` (default ``self.fault``) is the injection hook — it may
        cap a syscall's length (short read) or raise ``OSError`` (which
        then flows through the same retry machinery a real error would).

        Direct mode: the aligned body of the request goes through the
        O_DIRECT descriptor; any sub-block fragment (a tail shorter than
        one block, or a grid re-sync after an injected/EOF short read)
        goes through the buffered descriptor and is counted via
        ``record_direct_tail`` on the stats sink. A structurally
        misaligned call (offset or buffer address off the probed block
        grid) raises :class:`DirectIOError` — never a silent fallback.
        """
        want = len(view)
        total = 0
        sink = stats if stats is not None else IO_EVENTS
        hook = fault if fault is not None else self.fault
        pol = self.retry
        use_v = self.use_preadv and HAVE_PREADV
        direct = self.direct_io and self.direct_fd >= 0
        bs = self.block_size
        if direct and want > 0:
            if offset % bs:
                raise DirectIOError(
                    f"direct read at offset {offset} is off the {bs}-byte "
                    f"block grid of {self.path!r} (offset % {bs} == "
                    f"{offset % bs}); plan splinters with "
                    f"align=fs_block_size(path)")
            addr = _buf_addr(view)
            if addr % bs:
                raise DirectIOError(
                    f"direct read destination buffer at 0x{addr:x} is not "
                    f"{bs}-byte aligned for {self.path!r}; the session "
                    f"arena must be allocated on the block grid")
        while total < want:
            attempts, pause, deadline = 0, pol.base_backoff_s, None
            tail_frag = False
            while True:
                cap = want - total
                try:
                    if hook is not None:
                        c = hook(offset + total, cap)
                        if c is not None:
                            cap = max(1, min(cap, int(c)))
                    pos = offset + total
                    tail_frag = False
                    if direct and pos % bs == 0 and cap >= bs:
                        # Aligned body — DMA straight into the arena view.
                        dcap = (cap // bs) * bs
                        got = os.preadv(
                            self.direct_fd, [view[total: total + dcap]], pos
                        )
                    elif direct:
                        # Sub-block fragment (tail, or re-sync to the grid
                        # after a short return) — buffered fd, counted.
                        frag = pos % bs
                        bcap = min(cap, bs - frag) if frag else cap
                        got = os.preadv(
                            self.fd, [view[total: total + bcap]], pos
                        )
                        tail_frag = True
                    elif use_v:
                        got = os.preadv(
                            self.fd, [view[total: total + cap]], offset + total
                        )
                    else:
                        # Fallback: os.pread allocates a bytes object we
                        # must copy out of.
                        data = os.pread(self.fd, cap, offset + total)
                        got = len(data)
                        if got:
                            view[total: total + got] = data
                    break
                except OSError as e:
                    if e.errno not in pol.errnos:
                        raise
                    if deadline is None:
                        deadline = time.monotonic() + pol.deadline_s
                    attempts += 1
                    if attempts > pol.max_retries or \
                            time.monotonic() > deadline:
                        raise
                    sink.record_io_retry(e.errno)
                    time.sleep(pause)
                    pause = min(pause * 2.0, pol.max_backoff_s)
            if got <= 0:              # EOF (preadv never returns <0 in py)
                break
            if tail_frag:
                rec = getattr(sink, "record_direct_tail", None)
                (rec if rec is not None else IO_EVENTS.record_direct_tail)(got)
            total += got
        return total

    def advise_sequential(self, offset: int, nbytes: int, *,
                          stats=None) -> bool:
        """Hint the kernel that ``[offset, offset+nbytes)`` will be read
        sequentially and soon (``POSIX_FADV_SEQUENTIAL`` doubles readahead,
        ``WILLNEED`` starts it). Called once per reader stripe on session
        start; best-effort — returns False where unsupported.

        Only the *intended* gaps are swallowed: a platform without
        ``posix_fadvise`` (AttributeError) and the does-not-support-hints
        errnos (counted in ``stats``/:data:`IO_EVENTS`, never silent).
        Anything else — ``EBADF`` above all — propagates: it means a bug,
        not an unsupported FS."""
        try:
            fadvise = os.posix_fadvise
        except AttributeError:        # platform gap — nothing to count
            return False
        sink = stats if stats is not None else IO_EVENTS
        try:
            fadvise(self.fd, offset, nbytes, os.POSIX_FADV_SEQUENTIAL)
            fadvise(self.fd, offset, nbytes, os.POSIX_FADV_WILLNEED)
            return True
        except OSError as e:
            if e.errno in _FADVISE_SUPPRESS:
                sink.record_suppressed(e.errno)
                return False
            raise

    def close(self) -> None:
        with self._lock:
            self._refcount -= 1
            if self._refcount <= 0 and self.fd >= 0:
                os.close(self.fd)
                self.fd = -1
                if self.direct_fd >= 0:
                    os.close(self.direct_fd)
                    self.direct_fd = -1

    @property
    def closed(self) -> bool:
        return self.fd < 0


class ShardedFile:
    """A ``PosixFile``-compatible handle over an ordered set of shard files.

    Presents N on-disk shards as ONE contiguous byte space so every layer
    above (stripe planning, buffer readers, borrowed views) works unchanged
    over a multi-file corpus. The byte space is whatever the segment table
    says it is — for token-file sets it is the concatenation of each shard's
    *data* region (headers excluded), built by ``data/fileset.py``.

    ``segments`` is a tuple of ``(path, global_start, file_base, nbytes,
    shard_id)``: bytes ``[global_start, global_start + nbytes)`` of the
    global space live at file offset ``file_base`` of ``path``. Segments
    must be ascending and contiguous (no gaps); zero-byte shards are simply
    omitted from the table (their ``shard_id``s stay reserved). The table is
    a plain tuple of primitives, so reader worker processes receive it in
    their spec (``worker_segments``) and open their own descriptors by path
    (``from_segments``) — never an inherited fd.

    It carries the ``PosixFile`` surface the reader runtime uses
    (``pread_into``, ``pread``, ``advise_sequential``, ``block_size``,
    ``size``, ``path``, ``direct_io``, ``fault``, refcounted
    ``addref``/``close``), with ``PosixFile``'s semantics: positional reads
    from any thread, short-read/EOF behaviour (a torn shard body returns
    short, it does not raise), per-shard transient-error retry (each
    underlying handle keeps its own ``RetryPolicy``). Session plans pin
    interior shard starts as hard stripe bounds (``bounds_in``), so no
    splinter spans a shard; a read that crosses one anyway is split at it.
    The ``fault`` injection hook (per call, else the handle's) is forwarded
    to the per-shard reads and observes *shard-file* offsets.

    ``direct_io=True`` opens every shard ``O_DIRECT``; a shard whose data
    region (``file_base``) or, for interior shards, whose ``global_start``
    is off the block grid is rejected at open, by name.
    """

    def __init__(self, segments: Sequence[Tuple[str, int, int, int, int]],
                 *, direct_io: bool = False):
        segs = tuple(
            (str(p), int(g), int(b), int(n), int(sid))
            for (p, g, b, n, sid) in segments
        )
        if not segs:
            raise ValueError("ShardedFile needs at least one segment")
        for i, (p, g, b, n, sid) in enumerate(segs):
            if n <= 0:
                raise ValueError(f"segment {i} ({p}): non-positive length {n}")
            if i and g != segs[i - 1][1] + segs[i - 1][3]:
                raise ValueError(
                    f"segment {i} ({p}): global space has a gap "
                    f"({segs[i - 1][1] + segs[i - 1][3]} != {g})")
        self.segments = segs
        self._starts = tuple(g for (_, g, _, _, _) in segs)
        self.offset = segs[0][1]
        self.size = segs[-1][1] + segs[-1][3]   # end of the global space
        self.path = (f"fileset[{len(segs)} shards: {segs[0][0]} .. "
                     f"{segs[-1][0]}]")
        self.direct_io = bool(direct_io)
        self.fault: Optional[object] = None
        self._lock = threading.Lock()
        self._refcount = 1
        # One descriptor per unique path (a path may legally back several
        # segments); opened here, owned by this handle alone.
        self._by_path: Dict[str, PosixFile] = {}
        try:
            for p, *_ in segs:
                if p not in self._by_path:
                    self._by_path[p] = PosixFile.open(p, direct_io=direct_io)
        except OSError:
            for f in self._by_path.values():
                f.close()
            raise
        self._files = tuple(self._by_path[p] for (p, *_ ) in segs)
        self.block_size = max(f.block_size for f in self._by_path.values())
        if direct_io:
            # A shard whose data region starts off the block grid would put
            # every global-aligned read at an unaligned file offset — reject
            # up front with the offender list, per the direct-I/O contract.
            bad = [(p, "file_base", b) for (p, g, b, n, sid) in segs
                   if b % self._by_path[p].block_size]
            # Interior shard starts become hard stripe bounds; if one is off
            # the grid, every splinter of that shard lands at an unaligned
            # arena position (buffer-address check would fail at read time).
            bad += [(p, "global_start", g) for (p, g, b, n, sid) in segs[1:]
                    if g % self.block_size]
            if bad:
                for f in self._by_path.values():
                    f.close()
                raise DirectIOError(
                    f"direct_io=True: {len(bad)} shard segment field(s) off "
                    f"the block grid (first: {bad[0][0]!r} {bad[0][1]}="
                    f"{bad[0][2]}); direct sharded sessions need "
                    f"block-aligned shard data regions and block-multiple "
                    f"shard sizes")

    @classmethod
    def from_segments(cls, segments, *, direct_io: bool = False
                      ) -> "ShardedFile":
        """Rebuild from a pickled segment table (worker-process side)."""
        return cls(segments, direct_io=direct_io)

    @property
    def worker_segments(self) -> Tuple[Tuple[str, int, int, int, int], ...]:
        """The picklable table a reader worker rebuilds this handle from."""
        return self.segments

    # -- shard resolution -------------------------------------------------
    def _seg_at(self, global_off: int) -> int:
        i = bisect_right(self._starts, global_off) - 1
        if i < 0:
            raise ValueError(
                f"offset {global_off} before global space start {self.offset}")
        return i

    def shard_of(self, global_off: int) -> int:
        """Shard id owning the byte at ``global_off`` (end maps to last)."""
        return self.segments[self._seg_at(min(global_off, self.size - 1))][4]

    def bounds_in(self, offset: int, nbytes: int) -> List[int]:
        """Interior shard-start offsets strictly inside
        ``(offset, offset + nbytes)`` — the hard stripe bounds a session
        plan over this handle must not let any stripe span."""
        end = offset + nbytes
        return [g for g in self._starts[1:] if offset < g < end]

    # -- PosixFile surface -------------------------------------------------
    def addref(self) -> None:
        with self._lock:
            self._refcount += 1

    def pread_into(self, offset: int, view: memoryview, *,
                   stats=None, fault=None) -> int:
        """Positional read of the global space into ``view``; loops across
        shard boundaries. Returns short only at genuine end-of-space or a
        torn shard body (per-shard EOF), mirroring ``PosixFile``."""
        want = len(view)
        if want <= 0:
            return 0
        hook = fault if fault is not None else self.fault
        total = 0
        i = self._seg_at(offset)
        while total < want and i < len(self.segments):
            _, g, b, n, _ = self.segments[i]
            seg_off = offset + total - g
            if seg_off >= n:            # past this segment: next one
                i += 1
                continue
            take = min(want - total, n - seg_off)
            got = self._files[i].pread_into(
                b + seg_off, view[total: total + take],
                stats=stats, fault=hook)
            total += got
            if got < take:              # torn shard body — stop short
                break
            i += 1
        return total

    def pread(self, offset: int, nbytes: int, *, stats=None) -> bytes:
        if nbytes <= 0:
            return b""
        buf = bytearray(min(nbytes, max(0, self.size - offset)))
        got = self.pread_into(offset, memoryview(buf), stats=stats)
        return bytes(buf[:got])

    def advise_sequential(self, offset: int, nbytes: int, *,
                          stats=None) -> bool:
        """Per-shard sequential/willneed hints over the intersected ranges."""
        ok = False
        end = offset + nbytes
        for (_, g, b, n, _), f in zip(self.segments, self._files):
            s, e = max(offset, g), min(end, g + n)
            if s < e:
                ok = f.advise_sequential(b + (s - g), e - s, stats=stats) or ok
        return ok

    def close(self) -> None:
        with self._lock:
            self._refcount -= 1
            if self._refcount > 0:
                return
        for f in self._by_path.values():
            f.close()
        self._by_path = {}
        self._files = ()

    @property
    def closed(self) -> bool:
        return not self._files


def write_file(path: str, data: bytes, *, sync: bool = False) -> None:
    """Write a file in one shot (used by benchmarks / data generators)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
        if sync:
            f.flush()
            os.fsync(f.fileno())


def drop_page_cache(path: str, *, stats=None) -> bool:
    """Best-effort eviction of a file from the OS page cache.

    Benchmarks call this between trials so that throughput numbers measure the
    storage path rather than DRAM. Uses ``posix_fadvise(DONTNEED)``; returns
    False when unsupported (results then measure warm-cache behaviour, which
    the benchmark records). Suppressed errors are counted (``stats`` /
    :data:`IO_EVENTS`): the swallowed set is the fadvise
    unsupported-hint errnos plus a missing/unreadable path — an unexpected
    errno propagates instead of masquerading as "cache not dropped".
    """
    sink = stats if stats is not None else IO_EVENTS
    try:
        fadvise = os.posix_fadvise
    except AttributeError:            # platform gap — nothing to count
        return False
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError as e:
        if e.errno in (errno.ENOENT, errno.EACCES, errno.EPERM, errno.EISDIR):
            sink.record_suppressed(e.errno)
            return False
        raise
    try:
        try:
            # DONTNEED cannot evict DIRTY pages — a file written moments
            # ago (every benchmark fixture) would silently stay resident.
            # fsync on a read-only fd is legal on Linux and flushes the
            # inode's dirty pages first; failure is advisory, not fatal.
            os.fsync(fd)
        except OSError as e:
            sink.record_suppressed(e.errno)
        try:
            fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        except OSError as e:
            if e.errno in _FADVISE_SUPPRESS:
                sink.record_suppressed(e.errno)
                return False
            raise
    finally:
        os.close(fd)
    return True
