"""CkIO-backed training input pipeline, with its device half in PyTorch.

Over-decomposed consumers (feeder clients, many per PE) collectively read
each training step's token window through a CkIO read session while the
device runs the previous step: a double-buffered, split-phase pipeline that
implements the paper's compute/input overlap at the training-loop level.
The consumer count is the application's choice, decoupled from
``num_readers`` (paper §III-B); one read session covers one step window;
``resize()`` re-registers consumers and leaves the reader layer untouched.

Delivery modes:
  * ``zero_copy=True`` (default): ``get_batch`` materializes the step's
    tokens as a NumPy array *aliasing the session arena*.
  * ``zero_copy=False``: consumer reads land in a per-step NumPy arena (one
    host copy, counted).

Device ingest (``get_batch_device``)
------------------------------------
The borrowed whole-window arena view is copied to the pipeline's device
once (the step's only host→device transfer), and batch-major ``(inputs,
labels)`` — label shift and remainder padding included — are produced on
the device by the reassembly kernels (``kernels/ops.py``). Host code touches
file metadata only: ``ingest.host_permute_bytes`` stays 0 and
``ingest.h2d_transfers`` advances by exactly 1 per step.

Streamed staging (``streaming=True``)
-------------------------------------
The pipeline subscribes to each step session's per-splinter completion
stream and copies splinters to the device as they arrive, one chunk per
splinter (``h2d_transfers`` advances once per splinter) within a bounded
in-flight budget (``max_inflight_stage_bytes``: the oldest outstanding
transfer is awaited first). ``get_batch_device`` then stages the tail,
sorts the chunk *handles* into file order and hands the list to
``ops.ingest_chunks_window``, whose kernel reads the chunks in place
through a pointer table — no concatenation. Splinters whose events were
dropped (a delivery racing ``resize()``) are staged from the session's
event log at finalize. Batches are bit-identical to the whole-window path.

Lifetime rules:
  * the returned ``(inputs, labels)`` are ordinary tensors that own their
    storage;
  * the staged host view (and its session) stays alive until the **next**
    ``get_batch*``/``close`` call, which waits for the step's transfers and
    reassembly, drops the host references and retires the session; a later
    access to the old borrowed view raises ``ValueError``;
  * streamed chunk views are pinned from staging until their step retires,
    under the same rule.

Multi-file corpora and the cold-path read engine
------------------------------------------------
``path`` may be a ``data.fileset.FileSet`` manifest: the shard list opens as
one logical byte space (``CkIO.open_fileset``; shard data regions
concatenated, headers excluded), interior shard starts become hard stripe
bounds in every session plan, so no physical read spans two shard files,
and per-shard read bytes land in ``ck.director.shards``. ``file_opts``
carries the read engine of ``io/submit.py``: ``queue_depth >= 2`` keeps
that many reads in flight per reader (io_uring where the kernel allows,
else a preadv pool), ``readahead_bytes`` advises ahead of the submission
frontier, and ``direct_io`` opens the corpus ``O_DIRECT``. An ``O_DIRECT``
session must start on the block grid, so with ``direct_io`` each step's
session starts at the block boundary at or below its window (the
reference package raises ``DirectIOError`` for a window off the grid
instead); the batch, the staged chunks and the counters cover the window
alone. Batches are bit-identical in every mode.

Reader worker processes and NUMA placement
-------------------------------------------
With ``FileOptions(backend="process")`` each step session's arena is a
shared-memory segment (``ipc/shm.py``) that reader worker processes fill
(``preadv`` straight into the mapping) and this process consumes through
the same borrowed views: every mode above (host zero-copy, whole-window
device ingest, streamed staging) runs unchanged, with splinter events
arriving over cross-process rings. ``bytes_copied`` stays 0 in this
process. A view into the segment is valid until its session closes, as on
the thread backend; ``_host_tensor`` aliases the mapping, and a staged
step's references keep its pages alive until the next ``get_batch*``
(closing the segment tolerates the live export). The arena is pageable, so
the rule in ``_to_device`` holds unchanged. Workers open the corpus, each
shard of a ``FileSet`` included, by path; an ``O_DIRECT`` step session
starts at the block below its window on this backend too. A worker that
dies after the start gate is replaced (``recovery="respawn"``) or its
unread splinters are read here (``"reissue"``), bit-identically; with
``recovery="none"`` (the default) ``get_batch*`` raises the
``WorkerCrashed`` that names it, which ``train/fault.py``'s supervisor
counts as a reader failure and replays.

``FileOptions(topology=..., numa_pin=..., prefault_arena=True)`` places
each stripe's pages on its reader's NUMA domain by first touch (on the
reader thread or worker process, pinned to the domain's CPUs with
``numa_pin``); pieces coalesce per domain and every delivered byte is
classified same- or cross-domain in ``LocalityMetrics``
(``pipe.ck.director.locality`` after the sessions close). Batches are
bit-identical on either backend, under every placement.

Persistent reader service (constructor ``service=``)
----------------------------------------------------
Passing a ``repro_torch.ipc.service.ReaderService`` attaches it to this
pipeline's Director before any step session starts: every
``backend="process"`` step session then checks its workers out of the
service's persistent pool and its arena out of the recycled-arena pool,
instead of starting worker interpreters and creating a fresh shm segment
per step — the per-step setup drops from a worker start to one mailbox
write and an attach barrier. Every delivery contract above holds (the
pooled arena is the same kind of mapped segment: zero-copy views,
streamed chunk staging, ``bytes_copied == 0``), with these amendments:

  * **View lifetime across arena recycling**: borrowed views still die at
    step retirement (``ValueError`` on access), but the pages behind them
    outlive the session — the segment returns to the pool and is recycled
    into a later session. A view kept alive through invalidation by a live
    export (an ``np.frombuffer`` array, or a CPU tensor ``torch.from_numpy``
    made of one) QUARANTINES the segment: the service unlinks it instead of
    recycling it, so the export can never alias a later step's bytes. Code
    that keeps views across sessions re-validates with
    ``SharedArena.check_generation(gen)`` (raises ``StaleArenaView``; the
    session's generation is ``ServiceReaderSet.arena_generation``). The
    device copy in ``_to_device`` returns once its pageable source has been
    consumed, so releasing the session after it is safe; page-locking a
    pooled segment would need the hold-until-event rule first.
  * **When ``ServiceBusy`` is raised**: admission rejects a session only
    when both the inflight cap (``ServiceOptions.max_sessions``) and the
    FIFO queue (``max_queue``) are full. With ``FileOptions.use_service``
    left at auto (``None``) the Director catches it and falls back to the
    per-session spawn path — the step runs and pays the spawn;
    ``use_service=True`` pins the step to the pool and surfaces
    ``ServiceBusy`` from the step's futures; ``use_service=False`` (or no
    service) keeps the per-session path.
  * **The fallback to spawn** is per session and not sticky — unlike the
    ``fallback_backend="thread"`` downgrade, the next step tries the pool
    again.
  * **Failure containment**: a pooled worker crash evicts that worker
    only; the step recovers per its own ``FileOptions.recovery`` (or fails
    alone), and other steps or pipelines sharing the pool are untouched.
  * **Ownership**: the pipeline never shuts the service down — call
    ``service.shutdown()`` after the last pipeline using it closes
    (``/dev/shm`` holds nothing of it only after that).

Not carried by this slice (raises ``NotImplementedError``): ``sharding``.
"""
from __future__ import annotations

import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import CkIO, Client, FileOptions, Session, WorkerCrashed
from repro_torch.core.buffers import SplinterEvent
from repro_torch.core.futures import CkCallback, CkFuture
from repro_torch.core.metrics import IngestMetrics, StreamMetrics
from repro_torch.data.packing import batch_from_tokens, window_rows
from repro_torch.data.tokenfile import read_meta
from repro_torch.device import resolve_device


def _later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not carried by this port yet: it comes with the "
        f"{slice_name} slice (ROADMAP.md, Queue A)")


def _host_tensor(tokens: np.ndarray) -> torch.Tensor:
    """CPU tensor aliasing ``tokens`` (a read-only arena view). PyTorch warns
    that it cannot mark the tensor read-only; the pipeline only ever reads
    it, so exactly that warning is silenced."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="The given NumPy array is not writable",
            category=UserWarning)
        return torch.from_numpy(tokens)


@dataclass
class _StreamState:
    """Per-step streamed-staging state (``streaming=True`` device path)."""

    session: Optional[Session] = None
    token: Optional[int] = None            # read_stream subscription token
    window: Tuple[int, int] = (0, 0)       # [start, end) of the step's bytes
    pending: List[SplinterEvent] = field(default_factory=list)
    events: List[SplinterEvent] = field(default_factory=list)  # staged order
    pieces: List[Tuple[int, int]] = field(default_factory=list)  # (off, n)
    chunks: List[torch.Tensor] = field(default_factory=list)   # device chunks
    chunk_hosts: List[tuple] = field(default_factory=list)     # (np, view)
    t_first_stage: float = 0.0
    t_last_stage: float = 0.0
    stagers: int = 0                       # _stage_group calls in flight
    retired: bool = False


@dataclass
class _StepBuffer:
    step: int
    abs_off: int = 0
    nbytes: int = 0
    num_rows: int = 0                  # actual rows (< full for remainder)
    session: Optional[Session] = None
    arena: Optional[np.ndarray] = None
    outstanding: int = 0
    stream: Optional[_StreamState] = None
    ready: CkFuture = field(default_factory=CkFuture)


@dataclass
class _StagedStep:
    """Host-side references pinning one device-ingested step (see module
    docstring lifetime rules): released by the next ``get_batch*``."""

    staged: object                     # the staged tensor(s) or the outputs
    host_tokens: object                # np view(s) aliasing the arena
    host_view: Optional[memoryview]    # the borrowed arena view
    done: Optional[torch.cuda.Event] = None   # recorded after the step's work


class CkIOPipeline:
    """Double-buffered LM batch pipeline over a flat token file."""

    def __init__(
        self,
        path,
        global_batch: int,
        seq_len: int,
        *,
        ckio: Optional[CkIO] = None,
        num_pes: int = 4,
        num_consumers: Optional[int] = None,
        consumer_pes: Optional[List[int]] = None,
        file_opts: Optional[FileOptions] = None,
        service=None,
        prefetch_depth: int = 2,
        start_step: int = 0,
        drop_remainder: bool = True,
        zero_copy: bool = True,
        streaming: bool = False,
        sharding=None,
        stage_chunk_bytes: int = 0,
        max_inflight_stage_bytes: int = 32 << 20,
        pad_id: int = 0,
        device="cuda",
    ):
        if sharding is not None:
            raise _later("sharding=", "sharding")
        self.device = resolve_device(device)
        # ``path``: a filesystem path (single token file) or a
        # ``data.fileset.FileSet`` manifest (duck-typed — it carries the
        # same meta surface with ``data_offset == 0``, so every offset in
        # this pipeline is a global data-space byte either way).
        is_fileset = hasattr(path, "sharded_file")
        self.meta = path if is_fileset else read_meta(path)
        if len(self.meta.shape) != 1:
            raise ValueError("LM pipeline expects a flat token file")
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.ck = ckio or CkIO(num_pes=num_pes)
        self.file_opts = file_opts or FileOptions()
        # Attach BEFORE any step session starts, so every process-backend
        # session checks its workers and arena out of the pool. The caller
        # keeps ownership of the service and its shutdown.
        if service is not None:
            self.ck.director.attach_service(service)
        if is_fileset:
            self.file = self.ck.open_fileset_sync(path, self.file_opts)
        else:
            self.file = self.ck.open_sync(path, self.file_opts)
        self.prefetch_depth = max(1, prefetch_depth)
        self.drop_remainder = drop_remainder
        self.pad_id = pad_id
        rows_per_step = global_batch * (seq_len + 1)
        self.num_steps = self.meta.num_rows // rows_per_step
        if not drop_remainder and self.meta.num_rows % rows_per_step:
            self.num_steps += 1
        # Over-decomposition: consumers default to 4 per PE.
        self.num_consumers = num_consumers or 4 * self.ck.sched.num_pes
        if consumer_pes:
            bad = [p for p in consumer_pes
                   if not 0 <= p < self.ck.sched.num_pes]
            if bad:
                raise ValueError(
                    f"consumer_pes {bad} out of range "
                    f"[0,{self.ck.sched.num_pes})")
            pe_of = lambda i: consumer_pes[i % len(consumer_pes)]  # noqa: E731
        else:
            pe_of = lambda i: i % self.ck.sched.num_pes            # noqa: E731
        self._consumer_pe_of = pe_of
        self.consumers: List[Client] = [
            self.ck.make_client(pe=pe_of(i))
            for i in range(self.num_consumers)
        ]
        self.zero_copy = zero_copy
        if streaming and not zero_copy:
            raise ValueError(
                "streaming=True stages borrowed arena views and requires "
                "zero_copy=True")
        if streaming and self.file_opts.splinter_bytes % self.meta.itemsize:
            raise ValueError(
                f"streaming=True requires splinter_bytes "
                f"({self.file_opts.splinter_bytes}) to be a multiple of the "
                f"token itemsize ({self.meta.itemsize})")
        self.streaming = streaming
        # 0 (default) ships every splinter the moment its event lands.
        self.stage_chunk_bytes = max(1, stage_chunk_bytes)
        self.max_inflight_stage_bytes = max(
            self.stage_chunk_bytes, max_inflight_stage_bytes)
        self.ingest = IngestMetrics()
        self.stream = StreamMetrics()
        self._t_last_step = time.perf_counter()
        self._bufs: Dict[int, _StepBuffer] = {}
        self._retired: List[Session] = []   # zero-copy sessions pending close
        self._staged: List[_StagedStep] = []  # device steps pending release
        # Staged-but-not-awaited transfers across all step streams
        # (st, done_event, nbytes): the in-flight budget is global.
        self._stage_outstanding: Deque[tuple] = deque()
        # Condition, not bare Lock: _finalize_stream waits on it for
        # concurrent _stage_group calls to drain.
        self._lock = threading.Condition()
        self._next_step = start_step
        for s in range(start_step, min(start_step + self.prefetch_depth, self.num_steps)):
            self.start_step(s)

    # -- elastic scaling -------------------------------------------------------
    def resize(self, num_consumers: int) -> None:
        """Elastically change the consumer decomposition (readers untouched)."""
        cur = len(self.consumers)
        if num_consumers > cur:
            self.consumers.extend(
                self.ck.make_client(pe=self._consumer_pe_of(i))
                for i in range(cur, num_consumers)
            )
        else:
            for c in self.consumers[num_consumers:]:
                c.deregister()
            del self.consumers[num_consumers:]
        self.num_consumers = num_consumers

    def migrate_consumer(self, idx: int, new_pe: int) -> None:
        self.consumers[idx].migrate(new_pe)

    def reset_stream_metrics(self) -> StreamMetrics:
        """Open a fresh ``StreamMetrics`` window and return the old one; the
        in-flight balance carries over (see the reference pipeline)."""
        with self._lock:
            old, new = self.stream, StreamMetrics()
            new.inflight_bytes = old.inflight_bytes
            new.inflight_bytes_hwm = old.inflight_bytes
            self.stream = new
            self._t_last_step = time.perf_counter()
        return old

    # -- split-phase step input --------------------------------------------------
    def start_step(self, step: int) -> None:
        """Kick off the read session + consumer reads for ``step`` (async)."""
        with self._lock:
            if step in self._bufs or step >= self.num_steps:
                return
            buf = _StepBuffer(step=step)
            self._bufs[step] = buf

        start_row, num_rows = window_rows(step, self.global_batch, self.seq_len)
        # Remainder final window (drop_remainder=False): clamp to the file.
        num_rows = min(num_rows, self.meta.num_rows - start_row)
        abs_off, nbytes = self.meta.byte_range_for_rows(start_row, num_rows)
        buf.abs_off, buf.nbytes, buf.num_rows = abs_off, nbytes, num_rows
        mv: Optional[memoryview] = None
        if not self.zero_copy:
            buf.arena = np.empty(num_rows, dtype=self.meta.dtype)
            mv = memoryview(buf.arena).cast("B")

        def on_session(session: Session) -> None:
            buf.session = session
            if self.streaming:
                # The splinter stream drives staging; completeness is one
                # whole-window residency waiter.
                self._subscribe_stream(buf, session)
                buf.outstanding = 1

                def window_resident(_msg) -> None:
                    with self._lock:
                        buf.outstanding = 0
                    buf.ready.set(buf)

                self.ck.read_notify(
                    session, nbytes, abs_off,
                    CkCallback(window_resident, pe=0),
                    # The splinter stream classifies this window's bytes
                    # per event (against the routed consumer's domain);
                    # the residency probe must not classify them again.
                    classify_locality=False)
                return
            # Consumers collectively read disjoint slices of the window.
            n = self.num_consumers
            per = (nbytes + n - 1) // n
            itemsize = self.meta.itemsize
            per -= per % itemsize  # keep element alignment
            per = max(per, itemsize)
            plans = []
            pos = 0
            while pos < nbytes:
                take = min(per, nbytes - pos)
                plans.append((pos, take))
                pos += take
            buf.outstanding = len(plans)

            def make_done():
                def done(_msg) -> None:
                    with self._lock:
                        buf.outstanding -= 1
                        if buf.outstanding == 0:
                            buf.ready.set(buf)

                return done

            for i, (rel_off, take) in enumerate(plans):
                client = self.consumers[i % len(self.consumers)]
                if mv is None:
                    # zero-copy mode: residency signal only — get_batch
                    # takes one whole-window arena view itself.
                    self.ck.read_notify(
                        session, take, abs_off + rel_off,
                        client.callback(make_done()), client=client)
                else:
                    self.ck.read(
                        session, take, abs_off + rel_off,
                        mv[rel_off : rel_off + take],
                        client.callback(make_done()), client=client)

        # An O_DIRECT session starts on the block grid: read from the block
        # boundary at or below the window (the head is read, never handed
        # out); the tail past the last whole block goes buffered, counted.
        head = (abs_off % self.file.posix.block_size
                if self.file_opts.direct_io else 0)
        self.ck.start_read_session(
            self.file,
            nbytes + head,
            abs_off - head,
            CkCallback(on_session, inline=True),
            consumer_pes=[c.pe for c in self.consumers],
        )

    # -- streamed staging (the event-driven device path) ----------------------
    def _subscribe_stream(self, buf: _StepBuffer, session: Session) -> None:
        """Attach the per-splinter staging loop to ``session``'s stream."""
        st = _StreamState(session=session,
                          window=(buf.abs_off, buf.abs_off + buf.nbytes))
        buf.stream = st

        def route(ev: SplinterEvent) -> Optional[Client]:
            # Deliver through a consumer's virtual proxy (drop-stale for a
            # consumer retired by resize()); copy the list, since resize()
            # mutates it from another thread.
            cons = list(self.consumers)
            return cons[ev.index % len(cons)] if cons else None

        def on_splinter(ev: SplinterEvent) -> None:
            self._on_stream_event(buf, st, ev)

        st.token = self.ck.read_stream(session, on_splinter, route=route)

    def _on_stream_event(
        self, buf: _StepBuffer, st: _StreamState, ev: SplinterEvent
    ) -> None:
        """Scheduler task per streamed splinter arrival: accumulate until a
        chunk's worth of bytes is pending, then ship it."""
        with self._lock:
            if st.retired:
                # Late event racing finalize/resize: drop and count — the
                # splinter was (or will be) staged from the event log.
                self.stream.record_stale_event()
                self.ck.locations.count_stale()
                return
            st.pending.append(ev)
            if (sum(e.nbytes for e in st.pending) < self.stage_chunk_bytes
                    and not buf.ready.done):
                return                 # accumulate; tail staged at finalize
            group, st.pending = st.pending, []
            st.stagers += 1            # claimed: finalize must wait for us
        try:
            self._stage_group(st, group)
        finally:
            with self._lock:
                st.stagers -= 1
                self._lock.notify_all()

    def _to_device(self, tokens: np.ndarray) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """One host→device transfer of ``tokens`` (an arena view): returns the
        device tensor and, on CUDA, an event recorded after the copy.

        The arena is pageable ``np.empty`` memory, and a copy from pageable
        memory returns only once the source has been consumed, so the arena
        may be released as soon as this returns. A later change that
        page-locks the arena (``cudaHostRegister``) makes the copy truly
        asynchronous: it must then hold each session until that session's
        chunk events have completed."""
        chunk = _host_tensor(tokens).to(self.device, non_blocking=True,
                                        copy=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        return chunk, done

    def _stage_group(self, st: _StreamState, group: List[SplinterEvent]) -> None:
        """Copy a group of arrived splinters to the device, one chunk per
        splinter, within the in-flight staging budget. Runs on the pumping
        thread while reader threads are still filling the session."""
        if not group:
            return
        sess = st.session
        assert sess is not None
        for ev in group:
            # The splinter's bytes inside the step window: a direct-I/O
            # session also holds the head below it, which lies inside the
            # first splinter (splinters are whole blocks, the head less).
            off = max(ev.offset, st.window[0])
            nb = min(ev.offset + ev.nbytes, st.window[1]) - off
            self._evict_for(nb)
            view = sess.readers.borrow_view(off, nb)
            tokens = np.frombuffer(view, dtype=self.meta.dtype)
            if tokens.dtype == np.uint32:
                tokens = tokens.view(np.int32)
            t0 = time.perf_counter()
            self.stream.stage_inflight(nb)
            try:
                chunk, done = self._to_device(tokens)
            except BaseException:
                # A failed transfer never reaches _stage_outstanding, so its
                # budget charge is rolled back here.
                self.stream.stage_inflight(-nb)
                raise
            t1 = time.perf_counter()
            if st.t_first_stage == 0.0:
                st.t_first_stage = t0
            st.t_last_stage = t1
            with self._lock:
                st.chunks.append(chunk)
                st.chunk_hosts.append((tokens, view))
                st.events.append(ev)
                st.pieces.append((off, nb))
                self._stage_outstanding.append((st, done, nb))
            self.stream.record_chunk(nb, 1, t1 - t0, [t1 - ev.t_arrival])

    def _evict_for(self, nbytes: int) -> None:
        """Bounded in-flight budget: make room for an ``nbytes`` transfer by
        awaiting the oldest outstanding transfer(s) — from whichever step
        stream issued them — before the caller issues another one."""
        while True:
            with self._lock:
                if (self.stream.inflight_bytes + nbytes
                        <= self.max_inflight_stage_bytes
                        or not self._stage_outstanding):
                    return
                _, old_done, old_n = self._stage_outstanding.popleft()
            if old_done is not None:
                old_done.synchronize()
            self.stream.stage_inflight(-old_n)

    def _finalize_stream(self, buf: _StepBuffer):
        """All reads are resident (``buf.ready``): stop the stream, stage the
        pending tail plus any splinters whose events were dropped, and return
        the arrival-order device chunks + their piece layout."""
        st = buf.stream
        assert st is not None and st.session is not None
        sess = st.session
        # No pipeline lock held here: end_stream takes the reader stream
        # lock (lock order is stream lock -> pipeline lock, never inverse).
        self.ck.end_stream(sess, st.token)
        with self._lock:
            # Retire first, so that event tasks popped from here on drop +
            # count instead of staging; then drain claimed stagers.
            st.retired = True
            group, st.pending = st.pending, []
            while st.stagers:
                self._lock.wait()
        self._stage_group(st, group)
        # Completeness from the authoritative event log.
        with self._lock:
            seen = {e.index for e in st.events}
        missing = [ev for ev in sess.splinter_events if ev.index not in seen]
        self._stage_group(st, missing)
        with self._lock:
            own = [e for e in self._stage_outstanding if e[0] is st]
            self._stage_outstanding = deque(
                e for e in self._stage_outstanding if e[0] is not st)
        # The consuming kernel is ordered after every chunk copy on the
        # stream; this stream's transfers leave the in-flight budget.
        self.stream.stage_inflight(-sum(n for _, _, n in own))
        return list(st.chunks), list(st.pieces), st

    def _abort_stream(self, buf: _StepBuffer) -> None:
        """Tear down a step's stream without consuming it (host-path fetch,
        or pipeline close)."""
        st = buf.stream
        if st is None:
            return
        buf.stream = None
        if st.session is not None and st.token is not None:
            self.ck.end_stream(st.session, st.token)
        with self._lock:
            st.retired = True
            st.pending = []
            while st.stagers:          # drain in-flight _stage_group calls
                self._lock.wait()
            st.chunks = []
            st.chunk_hosts = []
            own = [e for e in self._stage_outstanding if e[0] is st]
            self._stage_outstanding = deque(
                e for e in self._stage_outstanding if e[0] is not st)
        for _, done, _ in own:
            if done is not None:
                done.synchronize()
        self.stream.stage_inflight(-sum(n for _, _, n in own))

    def _close_retired(self) -> None:
        with self._lock:
            retired, self._retired = self._retired, []
            staged, self._staged = self._staged, []
        for st in staged:
            # Wait for the step's transfers and reassembly, then drop the
            # host references so the borrows can be released. A CUDA fault
            # raised by the wait propagates; the refs are dropped either way.
            try:
                if st.done is not None:
                    st.done.synchronize()
            finally:
                st.host_tokens = None
                st.staged = None
        for sess in retired:
            # Invalidate borrows inline, so the contract is "valid until the
            # next get_batch*"; the session close itself stays split-phase.
            sess.readers.invalidate_borrows()
            self.ck.close_read_session(sess)

    def _wait_step(self, step: int, timeout: float) -> _StepBuffer:
        if step >= self.num_steps:
            raise IndexError(f"step {step} >= {self.num_steps}")
        self.start_step(step)  # no-op if already started
        buf = self._bufs[step]
        buf.ready.wait(self.ck.sched, timeout=timeout)
        # Launch the lookahead before handing the batch to the trainer.
        self.start_step(step + self.prefetch_depth)
        with self._lock:
            self._bufs.pop(step, None)
        return buf

    def _window_tokens(self, buf: _StepBuffer):
        """Whole-window tokens (and the borrowed arena view backing them,
        zero-copy mode only). Retires the *previous* step first."""
        if buf.stream is not None:
            self._abort_stream(buf)
        view: Optional[memoryview] = None
        if self.zero_copy:
            self._close_retired()
            assert buf.session is not None
            view = buf.session.readers.borrow_view(buf.abs_off, buf.nbytes)
            tokens = np.frombuffer(view, dtype=self.meta.dtype)
            with self._lock:
                self._retired.append(buf.session)
        else:
            self._close_retired()
            if buf.session is not None:
                self.ck.close_read_session(buf.session)
            tokens = buf.arena
            assert tokens is not None
        if tokens.dtype == np.uint32:
            # Zero-copy reinterpret: vocab 200,064 needs uint32 on disk, and
            # every id fits in int32.
            tokens = tokens.view(np.int32)
        return tokens, view

    def get_batch(self, step: int, timeout: float = 300.0) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking (scheduler-pumping) host fetch of step ``step``;
        prefetches ``step + prefetch_depth`` before returning.

        In zero-copy mode the returned arrays alias the step's session arena
        and remain valid until the next ``get_batch*``/``close`` call."""
        buf = self._wait_step(step, timeout)
        tokens, _ = self._window_tokens(buf)
        inputs, labels = batch_from_tokens(
            tokens, self.global_batch, self.seq_len,
            allow_partial=not self.drop_remainder, pad_id=self.pad_id,
        )
        self.ingest.record_host_step(buf.nbytes)
        self._t_last_step = time.perf_counter()
        return inputs, labels

    def get_batch_device(self, step: int, sharding=None, *,
                         timeout: float = 300.0):
        """Device-ingest fetch: one transfer of the whole-window arena view,
        then on-device batch-major reassembly (fused label shift + remainder
        padding). Returns int32 tensors ``(inputs, labels)`` on the
        pipeline's device. With ``streaming=True`` the window was staged
        splinter by splinter while its reads were in flight; this call ships
        the tail and reassembles from the chunk list."""
        from repro_torch.kernels import ops

        if sharding is not None:
            raise _later("get_batch_device(sharding=...)", "sharding")
        buf = self._wait_step(step, timeout)
        if buf.stream is not None:
            return self._get_batch_device_streamed(buf)
        tokens, view = self._window_tokens(buf)
        valid_tokens = buf.nbytes // self.meta.itemsize
        staged, _ = self._to_device(tokens)   # the step's single transfer
        inputs, labels = ops.device_ingest(
            staged,
            None,                       # arena view is file-order
            global_batch=self.global_batch,
            seq_len=self.seq_len,
            valid_tokens=valid_tokens,
            pad_id=self.pad_id,
        )
        if self.zero_copy:
            with self._lock:
                # _window_tokens queued the session for retirement; the
                # staged refs pin arena + transfer until the next call.
                self._staged.append(_StagedStep(
                    staged=staged, host_tokens=tokens, host_view=view,
                    done=self._record_done()))
        # Copy mode still pays the session→step-arena host copy.
        self.ingest.record_device_step(
            buf.nbytes, host_bytes=0 if self.zero_copy else buf.nbytes)
        self._t_last_step = time.perf_counter()
        return inputs, labels

    def _record_done(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _get_batch_device_streamed(self, buf: _StepBuffer):
        """Streamed tail of ``get_batch_device``: finalize the step's chunk
        stream and reassemble on device from the file-ordered chunk list."""
        from repro_torch.kernels import ops

        self._close_retired()          # release the previous step's refs
        chunks, pieces, st = self._finalize_stream(buf)
        sess = st.session
        valid_tokens = buf.nbytes // self.meta.itemsize
        abs_off = buf.abs_off
        # The arrival-order→file-order permutation is applied to the chunk
        # handles (host metadata); the kernel reads the chunks in place.
        order = sorted(range(len(pieces)), key=lambda i: pieces[i][0])
        pieces = [pieces[i] for i in order]
        chunks = [chunks[i] for i in order]
        pos = abs_off
        for off, nb in pieces:        # exactly-once coverage, cheap to prove
            if off != pos:
                raise RuntimeError(
                    f"streamed pieces corrupt: expected offset {pos}, "
                    f"got {off}")
            pos += nb
        if pos != abs_off + buf.nbytes:
            raise RuntimeError("streamed pieces do not cover the window")
        inputs, labels = ops.ingest_chunks_window(
            chunks, global_batch=self.global_batch, seq_len=self.seq_len,
            valid_limit=valid_tokens, pad_id=self.pad_id)
        with self._lock:
            self._retired.append(sess)
            # Pin the chunk views + chunks until the next step.
            self._staged.append(_StagedStep(
                staged=chunks, host_tokens=st.chunk_hosts, host_view=None,
                done=self._record_done()))
            nchunks = len(st.chunks)
            st.chunks = []
            st.chunk_hosts = []
        buf.stream = None
        self.ingest.record_device_step(
            buf.nbytes, transfers=nchunks, host_bytes=0)
        now = time.perf_counter()
        self.stream.record_step(
            (sess.metrics.t_start, sess.metrics.t_last_read),
            (st.t_first_stage, st.t_last_stage),
            now - self._t_last_step,
        )
        self._t_last_step = now
        return inputs, labels

    @staticmethod
    def _shift(window: torch.Tensor):
        """Label shift over an assembled ``(B, S+1)`` window: the
        ``(w[:, :-1], w[:, 1:])`` split of ``batch_from_tokens``."""
        return window[:, :-1], window[:, 1:]

    def idle(self, seconds: float) -> int:
        """Pump pipeline tasks for ``seconds`` (call while the device step
        runs). Returns tasks processed."""
        return self.ck.sched.pump_until_deadline(time.monotonic() + seconds)

    def __iter__(self):
        for s in range(self._next_step, self.num_steps):
            yield self.get_batch(s)

    # -- device hand-off ---------------------------------------------------------
    def to_device(self, inputs: np.ndarray, labels: np.ndarray, sharding=None):
        """Host-path batch → tensors on the pipeline's device."""
        if sharding is not None:
            raise _later("to_device(sharding=...)", "sharding")
        return (torch.as_tensor(np.ascontiguousarray(inputs), device=self.device),
                torch.as_tensor(np.ascontiguousarray(labels), device=self.device))

    def close(self) -> None:
        # A crashed reader worker in a *prefetched* session surfaces as a
        # raising task the moment anything pumps the scheduler. Teardown
        # still runs to completion (sessions stopped, shm unmapped, the
        # file closed): close catches those, finishes, and re-raises the
        # first one at the end.
        surfaced: List[BaseException] = []

        def pump_all() -> None:
            while True:
                try:
                    self.ck.pump()
                    return
                except WorkerCrashed as e:   # finite: <= 1 task a session
                    surfaced.append(e)

        # Flush queued session starts before tearing down streams: a
        # prefetch session that starts during this pump subscribes (and may
        # stage) then. Every reader thread of this file is joined before the
        # fd goes away.
        pump_all()
        for buf in list(self._bufs.values()):
            if buf.stream is not None:
                self._abort_stream(buf)
        self._close_retired()
        stopped = True
        for sess in list(self.ck.director.sessions.values()):
            if sess.file is self.file:
                stopped &= sess.readers.stop()
        for buf in list(self._bufs.values()):
            if buf.session is not None:
                self.ck.close_read_session(buf.session)
        if not stopped:
            raise RuntimeError(
                "pipeline close: reader thread(s) still running after stop "
                "timeout; file left open")
        while True:
            try:
                self.ck.close_sync(self.file)
                break
            except WorkerCrashed as e:
                surfaced.append(e)
        if surfaced:
            raise surfaced[0]
