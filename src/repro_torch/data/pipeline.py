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

Sharded staging (constructor ``sharding=``)
-------------------------------------------
A constructor ``sharding`` (a ``launch.sharding.NamedSharding``: a spec
over a ``torch.distributed`` ``DeviceMesh``, one rank a process) composes
with both device paths. Its device blocks over the ``(global_batch,
seq_len+1)`` window grid are resolved ONCE into contiguous flat-token
spans (``device_token_spans``: batch-dim shardings only; one that splits
the sequence dimension raises at construction). With ``streaming=True``
every arriving splinter is routed to the span(s) it meets by interval
intersection: the piece inside this rank's span is copied to its device
straight from the borrowed arena view (``host_permute_bytes`` stays 0),
and pieces inside another rank's span are *counted*
(``ShardMetrics.cross_host``) and skipped, so each rank stages its block
of the window and nothing else. ``get_batch_device`` then proves coverage
from the event log and runs ``ops.ingest_chunks_window`` over the block's
token-ordered pieces with the block's rows as the batch and its valid
tokens as the limit: one window-kernel launch gives the block's ``(inputs,
labels)``, the remainder pad included (a block is whole rows, and the label
shift is per row). Each is then bound into a global DTensor
(``NamedSharding.global_tensor``, ``DTensor.from_local``: metadata only).
``streaming=False`` with a constructor sharding copies this rank's span of
the resident window in one transfer and assembles it the same way.
Batches are bit-identical to the unsharded paths; a caller that trains on
the local batch calls ``.to_local()``.

A **per-call** ``sharding`` must equal the constructor's (else
``ValueError``). Without a constructor sharding, a per-call one runs the
whole-window sharded path for that call; on a streaming pipeline that
throws away the step's streamed chunks (placed before the sharding was
known) and so forfeits the read/stage overlap, which the first such call
says once per pipeline with a ``RuntimeWarning``: pass the sharding at
construction instead. ``ShardMetrics`` (``pipe.ck.director.shards``)
carries both sides of the ledger: the read side (bytes a FileSet shard) and
the stage side (``record_stage`` / ``record_window`` /
``record_cross_host``, written here).

The input path's own trace
--------------------------
Each step session carries its phases on its ``SessionMetrics``, through
the Director's observer path like every other session counter:
``t_requested`` (``start_step``), ``t_start`` and ``t_last_read`` (the
readers), ``t_ready`` (the window's last consumer callback, or the
streamed window's residency callback), and the one ``get_batch*`` call
that consumed it (``record_fetch``): its entry, its length, the time in
the scheduler pump waiting for the window, the part of that parked on the
scheduler's condition variable (``TaskScheduler.parked_s``: waiting for
reader threads) and the tasks the pump ran (CkIO's task code on the
caller's thread). The rest of the call is the stage: retiring the previous
step, the borrow, the host→device copy, the reassembly launch and the
lookahead request. The scheduler is cooperative: a session that
``start_step`` requests starts only when some thread pumps, which in a
loop of ``get_batch*`` and compute is the next fetch. While a
``torch.profiler`` records, each call also opens the host ranges
``ckio.fetch``, ``ckio.fetch.pump`` and ``ckio.fetch.stage``
(``repro_torch/profiling.py``) on the trace's clock; ``ckio.fetch`` starts
at the session's ``fetch_t0`` less a constant offset, which maps every
stamp above onto the trace.
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
from repro_torch.profiling import close_range, open_range, recording


def device_token_spans(indices_map, global_batch: int, width: int) -> Dict:
    """Resolve a sharding's ``devices_indices_map`` over the ``(batch,
    width)`` window grid into contiguous flat-token spans.

    Returns ``{device: (tok_start, tok_end)}`` in the window's flat token
    space. Raises ``ValueError`` unless every device block is a contiguous
    row range × the FULL width — the only layouts whose blocks are
    contiguous token spans, which is what lets an arriving chunk be routed
    to its destination device(s) by pure interval intersection (no host
    permutation). A pure function of the plain ``{device: (row_slice,
    col_slice)}`` map."""
    spans: Dict = {}
    for dev, idx in indices_map.items():
        if len(idx) != 2:
            raise ValueError(
                f"sharded pipeline expects a 2-d (batch, seq+1) sharding; "
                f"device {dev} has a {len(idx)}-d index")
        rows, cols = idx
        r0, r1, rstep = rows.indices(global_batch)
        c0, c1, cstep = cols.indices(width)
        if rstep != 1 or cstep != 1:
            raise ValueError(
                f"sharded pipeline needs unit-stride device blocks; "
                f"device {dev} has strides ({rstep}, {cstep})")
        if (c0, c1) != (0, width):
            raise ValueError(
                f"sharding splits the sequence dimension (device {dev} "
                f"covers columns [{c0},{c1}) of {width}); only batch-dim "
                f"shardings map to contiguous token spans")
        spans[dev] = (r0 * width, max(r0, r1) * width)
    return spans


def _resolve_sharding(sharding, global_batch: int, seq_len: int):
    """``(spans, this rank's key)`` of ``sharding`` over the window grid;
    this process must drive exactly one of its devices."""
    if not (hasattr(sharding, "devices_indices_map")
            and hasattr(sharding, "addressable_devices")
            and hasattr(sharding, "global_tensor")):
        raise TypeError(
            f"sharding of type {type(sharding).__name__}: expected a "
            f"launch.sharding.NamedSharding (devices_indices_map, "
            f"addressable_devices, global_tensor)")
    spans = device_token_spans(
        sharding.devices_indices_map((global_batch, seq_len + 1)),
        global_batch, seq_len + 1)
    addr = list(sharding.addressable_devices)
    if len(addr) != 1:
        raise ValueError(f"sharded pipeline: this process addresses "
                         f"{len(addr)} devices of the sharding; it drives "
                         f"exactly one (one rank a device)")
    return spans, addr[0]


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
    # Constructor-sharding mode: pieces are routed per device span at stage
    # time; dev_pieces collects this rank's [(tok_start, chunk), ...].
    dev_pieces: List[tuple] = field(default_factory=list)


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
    t_requested: float = 0.0           # start_step's perf_counter stamp


class _Fetch:
    """One ``get_batch*`` call, stamped with ``perf_counter``: entry
    (``t0``), the scheduler pump inside it (its length, the part parked,
    the tasks run) and the length of the whole call; then written onto the
    session it consumed (``SessionMetrics.record_fetch``). While a profiler
    records, the call also opens ``ckio.fetch`` around itself,
    ``ckio.fetch.pump`` around the pump and ``ckio.fetch.stage`` around the
    rest; ``ckio.fetch`` opens just before ``t0`` is taken, so the two
    differ by the constant offset between the trace's clock and
    ``perf_counter``."""

    __slots__ = ("ranges", "t0", "fetch_s", "pump_s", "parked_s", "tasks",
                 "buf")

    def __init__(self):
        self.ranges = [open_range("ckio.fetch")] if recording() else None
        self.t0 = time.perf_counter()
        self.fetch_s = self.pump_s = self.parked_s = 0.0
        self.tasks = 0
        self.buf: Optional[_StepBuffer] = None

    def pump(self, buf: _StepBuffer, sched, timeout: float) -> None:
        """Wait for ``buf``'s window, pumping ``sched``; the stage range
        opens as the wait ends."""
        rs = self.ranges
        if rs is not None:
            rs.append(open_range("ckio.fetch.pump"))
        tasks, parked = sched.stats["executed"], sched.parked_s
        t = time.perf_counter()
        try:
            buf.ready.wait(sched, timeout=timeout)
        finally:
            self.pump_s = time.perf_counter() - t
            self.parked_s = sched.parked_s - parked
            self.tasks = sched.stats["executed"] - tasks
            if rs is not None:
                close_range(rs.pop())
                rs.append(open_range("ckio.fetch.stage"))
        self.buf = buf

    def close(self) -> None:
        self.fetch_s = time.perf_counter() - self.t0
        while self.ranges:
            close_range(self.ranges.pop())

    def record(self) -> None:
        """Write the stamps onto the consumed session (one fetch a
        session; the session closes at a later fetch's pump)."""
        self.buf.session.metrics.record_fetch(
            self.t0, self.fetch_s, self.pump_s, self.parked_s, self.tasks)


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
        # Constructor sharding: the device blocks over the (B, S+1) window
        # grid resolve into contiguous token spans ONCE, before anything is
        # opened (ValueError unless the sharding is batch-dim only).
        self.sharding = sharding
        self._dev_spans: Optional[Dict] = None
        self._key = None                   # this rank's device key
        if sharding is not None:
            self._dev_spans, self._key = _resolve_sharding(
                sharding, global_batch, seq_len)
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
        self._warned_stream_sharding = False
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
            buf = _StepBuffer(step=step, t_requested=time.perf_counter())
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
            session.metrics.record_requested(buf.t_requested)
            if self.streaming:
                # The splinter stream drives staging; completeness is one
                # whole-window residency waiter.
                self._subscribe_stream(buf, session)
                buf.outstanding = 1

                def window_resident(_msg) -> None:
                    session.metrics.record_ready()
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
                            session.metrics.record_ready()
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

    def _to_device(self, tokens: np.ndarray, device=None
                   ) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
        """One host→device transfer of ``tokens`` (an arena view) to
        ``device`` (default: the pipeline's): returns the device tensor and,
        on CUDA, an event recorded after the copy.

        The arena is pageable ``np.empty`` memory, and a copy from pageable
        memory returns only once the source has been consumed, so the arena
        may be released as soon as this returns. A later change that
        page-locks the arena (``cudaHostRegister``) makes the copy truly
        asynchronous: it must then hold each session until that session's
        chunk events have completed."""
        device = self.device if device is None else device
        chunk = _host_tensor(tokens).to(device, non_blocking=True, copy=True)
        return chunk, self._record_done(device)

    def _stage_group(self, st: _StreamState, group: List[SplinterEvent]) -> None:
        """Copy a group of arrived splinters to the device, one chunk per
        splinter, within the in-flight staging budget. Runs on the pumping
        thread while reader threads are still filling the session."""
        if not group:
            return
        if self.sharding is not None:
            return self._stage_group_sharded(st, group)
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

    def _stage_group_sharded(
        self, st: _StreamState, group: List[SplinterEvent]
    ) -> None:
        """Sharded streamed staging: route each arrived splinter's tokens to
        the device span(s) they meet by interval intersection and copy the
        piece inside this rank's span to its device, straight from the
        arena view (``host_permute_bytes`` stays 0). Pieces inside another
        rank's span are counted (``ShardMetrics.cross_host``) and skipped."""
        sess = st.session
        assert sess is not None
        itemsize = self.meta.itemsize
        shards = self.ck.director.shards
        for ev in group:
            off = max(ev.offset, st.window[0])
            nb = min(ev.offset + ev.nbytes, st.window[1]) - off
            view = sess.readers.borrow_view(off, nb)
            tokens = np.frombuffer(view, dtype=self.meta.dtype)
            if tokens.dtype == np.uint32:
                tokens = tokens.view(np.int32)
            tok0 = (off - st.window[0]) // itemsize
            ntok = nb // itemsize
            t0 = time.perf_counter()
            staged_bytes = 0
            npieces = 0
            for key, (s0, s1) in self._dev_spans.items():
                lo, hi = max(tok0, s0), min(tok0 + ntok, s1)
                if lo >= hi:
                    continue
                nbk = (hi - lo) * itemsize
                if key != self._key:
                    shards.record_cross_host(nbk)
                    continue
                self._evict_for(nbk)
                self.stream.stage_inflight(nbk)
                try:
                    chunk, done = self._to_device(tokens[lo - tok0:hi - tok0],
                                                  key.device)
                except BaseException:
                    self.stream.stage_inflight(-nbk)
                    raise
                with self._lock:
                    st.dev_pieces.append((lo, chunk))
                    self._stage_outstanding.append((st, done, nbk))
                shards.record_stage(str(key), nbk)
                staged_bytes += nbk
                npieces += 1
            t1 = time.perf_counter()
            if st.t_first_stage == 0.0:
                st.t_first_stage = t0
            st.t_last_stage = t1
            with self._lock:
                # The event (and its pinning host refs) is recorded even if
                # every span it met was another rank's: the coverage proof
                # at finalize runs over the event log, not the pieces.
                st.chunk_hosts.append((tokens, view))
                st.events.append(ev)
                st.pieces.append((off, nb))
            if npieces:
                self.stream.record_chunk(
                    staged_bytes, npieces, t1 - t0, [t1 - ev.t_arrival])

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
        a per-call sharding, or pipeline close)."""
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
            st.dev_pieces = []
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

    def _fetch(self, body, *args):
        """One ``get_batch*`` call: ``body(fetch, *args)`` under a
        ``_Fetch``, whose stamps go onto the consumed session once the body
        has returned."""
        fetch = _Fetch()
        try:
            out = body(fetch, *args)
        finally:
            fetch.close()
        fetch.record()
        return out

    def _wait_step(self, step: int, timeout: float,
                   fetch: _Fetch) -> _StepBuffer:
        if step >= self.num_steps:
            raise IndexError(f"step {step} >= {self.num_steps}")
        self.start_step(step)  # no-op if already started
        buf = self._bufs[step]
        fetch.pump(buf, self.ck.sched, timeout)
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
        return self._fetch(self._host_batch, step, timeout)

    def _host_batch(self, fetch: _Fetch, step: int, timeout: float):
        buf = self._wait_step(step, timeout, fetch)
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
        the tail and reassembles from the chunk list.

        With a constructor sharding (or a per-call one) the two are global
        DTensors of shape ``(B, S)`` whose local blocks hold this rank's
        rows; see "Sharded staging" in the module docstring."""
        return self._fetch(self._device_batch, step, sharding, timeout)

    def _device_batch(self, fetch: _Fetch, step: int, sharding,
                      timeout: float):
        from repro_torch.kernels import ops

        if self.sharding is not None:
            # The spans were resolved, and streamed pieces placed, against
            # the constructor's sharding: a per-call one must agree.
            if sharding is not None and sharding != self.sharding:
                raise ValueError(
                    "get_batch_device(sharding=...) differs from the "
                    "pipeline's constructor sharding; streamed pieces are "
                    "already placed against the constructor's spans")
            buf = self._wait_step(step, timeout, fetch)
            if buf.stream is not None:
                return self._get_batch_device_streamed_sharded(buf)
            return self._get_batch_device_window_sharded(
                buf, self.sharding, self._dev_spans, self._key)
        if sharding is not None:
            spans, key = _resolve_sharding(sharding, self.global_batch,
                                           self.seq_len)
            buf = self._wait_step(step, timeout, fetch)
            if buf.stream is not None and not self._warned_stream_sharding:
                # Explicit, not silent: streamed chunks were placed before
                # this call-site sharding existed, so the step falls back to
                # the whole-window path and its chunks are discarded.
                self._warned_stream_sharding = True
                warnings.warn(
                    "get_batch_device(sharding=...) on a streaming pipeline: "
                    "streamed chunks are placed before a per-call sharding "
                    "is known; falling back to the whole-window staging "
                    "path (overlap lost) for every sharded call. Pass the "
                    "sharding to the constructor instead.",
                    RuntimeWarning, stacklevel=4)
            return self._get_batch_device_window_sharded(buf, sharding, spans,
                                                         key)
        buf = self._wait_step(step, timeout, fetch)
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
                    done=self._record_done(self.device)))
        # Copy mode still pays the session→step-arena host copy.
        self.ingest.record_device_step(
            buf.nbytes, host_bytes=0 if self.zero_copy else buf.nbytes)
        self._t_last_step = time.perf_counter()
        return inputs, labels

    @staticmethod
    def _prove_coverage(buf: _StepBuffer, pieces) -> None:
        """Exactly-once coverage of the step window by ``pieces`` (``(off,
        nbytes)`` in file order), cheap to prove."""
        pos = buf.abs_off
        for off, nb in pieces:
            if off != pos:
                raise RuntimeError(
                    f"streamed pieces corrupt: expected offset {pos}, "
                    f"got {off}")
            pos += nb
        if pos != buf.abs_off + buf.nbytes:
            raise RuntimeError("streamed pieces do not cover the window")

    @staticmethod
    def _record_done(device: torch.device) -> Optional[torch.cuda.Event]:
        """An event recorded on ``device``'s current stream (None off CUDA)."""
        if device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        return ev

    def _get_batch_device_streamed(self, buf: _StepBuffer):
        """Streamed tail of ``get_batch_device``: finalize the step's chunk
        stream and reassemble on device from the file-ordered chunk list."""
        from repro_torch.kernels import ops

        self._close_retired()          # release the previous step's refs
        chunks, pieces, st = self._finalize_stream(buf)
        sess = st.session
        valid_tokens = buf.nbytes // self.meta.itemsize
        # The arrival-order→file-order permutation is applied to the chunk
        # handles (host metadata); the kernel reads the chunks in place.
        order = sorted(range(len(pieces)), key=lambda i: pieces[i][0])
        self._prove_coverage(buf, [pieces[i] for i in order])
        chunks = [chunks[i] for i in order]
        inputs, labels = ops.ingest_chunks_window(
            chunks, global_batch=self.global_batch, seq_len=self.seq_len,
            valid_limit=valid_tokens, pad_id=self.pad_id)
        with self._lock:
            self._retired.append(sess)
            # Pin the chunk views + chunks until the next step.
            self._staged.append(_StagedStep(
                staged=chunks, host_tokens=st.chunk_hosts, host_view=None,
                done=self._record_done(self.device)))
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

    # -- sharded device path ---------------------------------------------------
    def _assemble_sharded(self, sharding, pieces: List, span: Tuple[int, int],
                          device: torch.device, valid_tokens: int):
        """This rank's block of the window from its pieces ``(tok_start,
        chunk)`` (already on ``device``): sort by token offset, prove the
        ``span`` is exactly covered, then one ``ops.ingest_chunks_window``
        over the pieces with the block's rows as the batch and its valid
        tokens as the limit (remainder pad included), and bind ``(inputs,
        labels)`` into global DTensors (metadata only). Returns them and
        the chunks."""
        from repro_torch.kernels import ops

        s0, s1 = span
        pieces = sorted(pieces, key=lambda p: p[0])
        pos = s0
        for t0, c in pieces:
            if t0 != pos:
                raise RuntimeError(
                    f"sharded pieces corrupt on {device}: expected token "
                    f"{pos}, got {t0}")
            pos += c.numel()
        expected = max(0, min(s1, valid_tokens) - s0)
        if pos - s0 != expected:
            raise RuntimeError(
                f"sharded pieces do not cover {device}'s span: {pos - s0} of "
                f"{expected} tokens")
        chunks = [c for _, c in pieces] or [
            torch.empty(0, dtype=torch.int32, device=device)]
        x, y = ops.ingest_chunks_window(
            chunks, global_batch=(s1 - s0) // (self.seq_len + 1),
            seq_len=self.seq_len, valid_limit=expected, pad_id=self.pad_id)
        shape = (self.global_batch, self.seq_len)
        return (sharding.global_tensor(x, shape),
                sharding.global_tensor(y, shape), chunks)

    def _addressable_window_bytes(self, span: Tuple[int, int],
                                  valid_tokens: int) -> int:
        """Bytes of this step's *valid* window in this rank's ``span`` (the
        staged-bytes ledger's addressable side)."""
        s0, s1 = span
        return (max(0, min(s1, valid_tokens) - min(s0, valid_tokens))
                * self.meta.itemsize)

    def _get_batch_device_streamed_sharded(self, buf: _StepBuffer):
        """Sharded streamed tail: finalize the chunk stream (this rank's
        pieces were copied as their splinters arrived), prove window
        coverage from the event log, assemble the block — no whole-window
        restage, no ``RuntimeWarning``."""
        self._close_retired()          # release the previous step's refs
        _, pieces, st = self._finalize_stream(buf)
        sess = st.session
        valid_tokens = buf.nbytes // self.meta.itemsize
        # From the event log: this rank's pieces are a strict subset of the
        # window with more than one rank.
        self._prove_coverage(buf, sorted(pieces))
        key, span = self._key, self._dev_spans[self._key]
        inputs, labels, chunks = self._assemble_sharded(
            self.sharding, st.dev_pieces, span, key.device,
            valid_tokens)
        self.ck.director.shards.record_window(
            buf.nbytes, self._addressable_window_bytes(span, valid_tokens))
        with self._lock:
            self._retired.append(sess)
            # Pin the chunk views + pieces until the next step.
            self._staged.append(_StagedStep(
                staged=chunks, host_tokens=st.chunk_hosts, host_view=None,
                done=self._record_done(key.device)))
            npieces = len(st.dev_pieces)
            st.dev_pieces = []
            st.chunk_hosts = []
        buf.stream = None
        self.ingest.record_device_step(
            buf.nbytes, transfers=npieces, host_bytes=0)
        now = time.perf_counter()
        self.stream.record_step(
            (sess.metrics.t_start, sess.metrics.t_last_read),
            (st.t_first_stage, st.t_last_stage),
            now - self._t_last_step,
        )
        self._t_last_step = now
        return inputs, labels

    def _get_batch_device_window_sharded(self, buf: _StepBuffer, sharding,
                                         spans: Dict, key):
        """Whole-window sharded path: copy this rank's span of the resident
        window (an arena view, no host copy in zero-copy mode) to its device
        in one transfer, count the other ranks' spans, then the same
        assembly as the streamed path."""
        tokens, view = self._window_tokens(buf)
        itemsize = self.meta.itemsize
        valid_tokens = buf.nbytes // itemsize
        shards = self.ck.director.shards
        pieces = []
        for k, (s0, s1) in spans.items():
            lo, hi = min(s0, valid_tokens), min(s1, valid_tokens)
            if k != key:
                shards.record_cross_host((hi - lo) * itemsize)
            elif hi > lo:
                chunk, _ = self._to_device(tokens[lo:hi], key.device)
                pieces.append((lo, chunk))
                shards.record_stage(str(key), (hi - lo) * itemsize)
        shards.record_window(
            buf.nbytes, self._addressable_window_bytes(spans[key],
                                                       valid_tokens))
        inputs, labels, chunks = self._assemble_sharded(
            sharding, pieces, spans[key], key.device, valid_tokens)
        if self.zero_copy:
            with self._lock:
                # _window_tokens queued the session for retirement; the
                # staged refs pin arena + transfer until the next call.
                self._staged.append(_StagedStep(
                    staged=chunks, host_tokens=tokens, host_view=view,
                    done=self._record_done(key.device)))
        self.ingest.record_device_step(
            buf.nbytes, transfers=len(pieces),
            host_bytes=0 if self.zero_copy else buf.nbytes)
        self._t_last_step = time.perf_counter()
        return inputs, labels

    def idle(self, seconds: float) -> int:
        """Pump pipeline tasks for ``seconds`` (call while the device step
        runs). Returns tasks processed."""
        return self.ck.sched.pump_until_deadline(time.monotonic() + seconds)

    def __iter__(self):
        for s in range(self._next_step, self.num_steps):
            yield self.get_batch(s)

    # -- device hand-off ---------------------------------------------------------
    def to_device(self, inputs: np.ndarray, labels: np.ndarray, sharding=None):
        """Host-path batch → tensors on the pipeline's device, or, with a
        ``sharding``, global DTensors of which this rank's block alone is
        copied to its device."""
        if sharding is not None:
            return tuple(sharding.put(torch.as_tensor(np.ascontiguousarray(a)))
                         for a in (inputs, labels))
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
