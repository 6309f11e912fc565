"""Instrumentation for CkIO: per-session counters and timings.

Everything the paper's evaluation plots (throughput, overlap fraction,
permutation cost, cross-node traffic) is derived from these counters.
Thread-safe; negligible overhead (integer adds under a lock). This copy
keeps the session, recovery, locality, ingest, stream and per-shard
counters the training path fills on either reader backend, the reader
service's ``ServiceMetrics`` and the serving subsystem's ``ServeMetrics``.

A session read by ``data/pipeline.py`` also carries its phases there:
when its window was requested, when the window's last consumer callback
ran, and the one fetch that consumed it, split into the scheduler pump
(the part parked waiting for readers, the tasks it ran) and the staging
after it (``SessionMetrics.record_fetch``).
``bytes_copied`` counts bytes physically memcpy'd into a client destination
buffer; the borrowed-view path leaves it untouched, which is how benchmarks
and tests *prove* zero-copy delivery rather than assume it.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class RecoveryMetrics:
    """Fault-recovery accounting for the reader runtime.

    One instance per reader set (``SessionMetrics.recovery``), merged into
    a Director-lifetime aggregate on session close — the observables of the
    recovery layer, proving what it absorbed instead of letting faults pass
    silently:

    * ``respawns`` / ``reissues`` — recovery events by kind: a dead or
      watchdog-killed worker replaced by a fresh process attached to the
      *same* arena, vs its unfinished splinters re-read supervisor-side.
      ``reissued_splinters`` / ``reissued_bytes`` total the re-routed work
      for both kinds (a respawn also re-issues the unfinished tail, just
      to a new process).
    * ``io_retries`` / ``retried_errnos`` — transient pread errors absorbed
      by the posix backoff layer *in this process*; ``worker_io_retries`` /
      ``worker_suppressed`` — the same counters folded in from reader
      worker processes through their ring headers.
    * ``suppressed_errors`` — advisory (fadvise-class) errors swallowed by
      design but counted, never silent.
    * ``watchdog_kills`` — hung workers killed by the supervisor's
      no-progress watchdog (each then flows through respawn/reissue).
    * ``recovery_latency_s`` — summed seconds from failure detection to
      restored read capacity (replacement gate-open, or the re-issued tail
      fully landed).
    * ``degraded_mode`` — this session ran on the thread backend because
      ``backend="process"`` setup failed and ``fallback_backend`` allowed
      the downgrade.

    Duck-typing: ``record_io_retry``/``record_suppressed`` match the stats
    protocol of ``io/posix.py``, so a session's RecoveryMetrics can be
    passed directly as a pread ``stats`` sink.
    """

    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    respawns: int = 0
    reissues: int = 0
    reissued_splinters: int = 0
    reissued_bytes: int = 0
    io_retries: int = 0
    retried_errnos: Dict[int, int] = field(default_factory=dict)
    suppressed_errors: int = 0
    worker_io_retries: int = 0
    worker_suppressed: int = 0
    watchdog_kills: int = 0
    recovery_latency_s: float = 0.0
    degraded_mode: bool = False
    # Direct-I/O tail accounting: sub-block fragments a direct-mode read had
    # to finish through the buffered descriptor (the only legal buffered
    # bytes in an O_DIRECT session — counted, never silent).
    direct_tail_reads: int = 0
    direct_tail_bytes: int = 0
    # FileSet sessions: re-issued bytes attributed to the shard whose file
    # they live in (splinters never span shards, so attribution is exact) —
    # proving a recovery re-read the RIGHT shard, not just the right amount.
    reissued_bytes_by_shard: Dict[int, int] = field(default_factory=dict)

    def record_io_retry(self, err: Optional[int] = None) -> None:
        with self.lock:
            self.io_retries += 1
            if err is not None:
                self.retried_errnos[err] = self.retried_errnos.get(err, 0) + 1

    def record_direct_tail(self, nbytes: int = 0) -> None:
        """One sub-block fragment of a direct read served buffered."""
        with self.lock:
            self.direct_tail_reads += 1
            self.direct_tail_bytes += int(nbytes)

    def record_suppressed(self, err: Optional[int] = None) -> None:
        with self.lock:
            self.suppressed_errors += 1

    def record_respawn(self, nsplinters: int, nbytes: int,
                       by_shard: Optional[Dict[int, int]] = None) -> None:
        with self.lock:
            self.respawns += 1
            self.reissued_splinters += nsplinters
            self.reissued_bytes += nbytes
            self._fold_shards(by_shard)

    def record_reissue(self, nsplinters: int, nbytes: int,
                       by_shard: Optional[Dict[int, int]] = None) -> None:
        with self.lock:
            self.reissues += 1
            self.reissued_splinters += nsplinters
            self.reissued_bytes += nbytes
            self._fold_shards(by_shard)

    def _fold_shards(self, by_shard: Optional[Dict[int, int]]) -> None:
        """Caller holds ``self.lock``."""
        if by_shard:
            for sh, nb in by_shard.items():
                self.reissued_bytes_by_shard[sh] = (
                    self.reissued_bytes_by_shard.get(sh, 0) + nb)

    def record_watchdog_kill(self) -> None:
        with self.lock:
            self.watchdog_kills += 1

    def record_recovery_latency(self, seconds: float) -> None:
        with self.lock:
            self.recovery_latency_s += max(seconds, 0.0)

    def add_worker_io(self, retries: int, suppressed: int,
                      tail_reads: int = 0, tail_bytes: int = 0) -> None:
        """Fold one worker ring's header counters in (once per ring), with
        the direct tails its report names."""
        with self.lock:
            self.worker_io_retries += retries
            self.worker_suppressed += suppressed
            self.direct_tail_reads += tail_reads
            self.direct_tail_bytes += tail_bytes

    def mark_degraded(self) -> None:
        with self.lock:
            self.degraded_mode = True

    def recoveries(self) -> int:
        with self.lock:
            return self.respawns + self.reissues

    def merge(self, other: "RecoveryMetrics") -> None:
        """Fold ``other`` (a finished session's counters) into this one."""
        with other.lock:
            snap = (
                other.respawns, other.reissues, other.reissued_splinters,
                other.reissued_bytes, other.io_retries,
                dict(other.retried_errnos), other.suppressed_errors,
                other.worker_io_retries, other.worker_suppressed,
                other.watchdog_kills, other.recovery_latency_s,
                other.degraded_mode,
                dict(other.reissued_bytes_by_shard),
                other.direct_tail_reads, other.direct_tail_bytes,
            )
        with self.lock:
            self.respawns += snap[0]
            self.reissues += snap[1]
            self.reissued_splinters += snap[2]
            self.reissued_bytes += snap[3]
            self.io_retries += snap[4]
            for err, c in snap[5].items():
                self.retried_errnos[err] = self.retried_errnos.get(err, 0) + c
            self.suppressed_errors += snap[6]
            self.worker_io_retries += snap[7]
            self.worker_suppressed += snap[8]
            self.watchdog_kills += snap[9]
            self.recovery_latency_s += snap[10]
            self.degraded_mode = self.degraded_mode or snap[11]
            self._fold_shards(snap[12])
            self.direct_tail_reads += snap[13]
            self.direct_tail_bytes += snap[14]

    def summary(self) -> Dict[str, float]:
        with self.lock:
            return {
                "respawns": float(self.respawns),
                "reissues": float(self.reissues),
                "recoveries": float(self.respawns + self.reissues),
                "reissued_splinters": float(self.reissued_splinters),
                "reissued_bytes": float(self.reissued_bytes),
                "io_retries": float(self.io_retries),
                "worker_io_retries": float(self.worker_io_retries),
                "suppressed_errors": float(self.suppressed_errors),
                "worker_suppressed": float(self.worker_suppressed),
                "watchdog_kills": float(self.watchdog_kills),
                "recovery_latency_s": self.recovery_latency_s,
                "degraded_mode": float(self.degraded_mode),
                "shards_reissued": float(len(self.reissued_bytes_by_shard)),
                "direct_tail_reads": float(self.direct_tail_reads),
                "direct_tail_bytes": float(self.direct_tail_bytes),
            }


@dataclass
class SessionMetrics:
    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    session_bytes: int = 0
    num_readers: int = 0
    t_start: float = 0.0
    t_last_read: float = 0.0
    read_calls: int = 0
    bytes_read: int = 0
    read_time_s: float = 0.0          # summed per-call wall time (across threads)
    bytes_per_reader: Dict[int, int] = field(default_factory=dict)
    # per-reader breakdowns (keyed by *planned owner*, i.e. stripe index):
    # the straggler signals the per-reader SplinterSizer consumes.
    read_time_per_reader: Dict[int, float] = field(default_factory=dict)
    reads_per_reader: Dict[int, int] = field(default_factory=dict)
    steals_from_reader: Dict[int, int] = field(default_factory=dict)
    steals: int = 0
    # phase-2 (permutation/delivery) accounting
    pieces_served: int = 0
    bytes_served: int = 0
    bytes_copied: int = 0             # memcpy'd to client buffers (0 = zero-copy)
    # Cross-node accounting is split by delivery kind so a piece is never
    # double-counted as both a transfer and a zero-copy delivery:
    # ``cross_node_bytes`` counts pieces physically copied to a client on
    # another node (the NetworkModel-modeled transfer); a piece delivered
    # as a borrowed view — same address space, or the mapped shm arena of
    # the process backend — moves no bytes and lands in
    # ``cross_node_view_bytes`` instead (the locality signal survives, the
    # phantom transfer does not).
    cross_node_bytes: int = 0
    cross_node_view_bytes: int = 0
    requests: int = 0
    # I/O retry observables; travels the same Director observer path as the
    # rest of the session counters. Has its own lock.
    recovery: RecoveryMetrics = field(default_factory=RecoveryMetrics)
    # FileSet sessions: physically-read bytes per shard id (splinters never
    # span shards, so every pread lands wholly in one shard file). Empty
    # for single-file sessions.
    shard_bytes: Dict[int, int] = field(default_factory=dict)
    # Submission-layer config + observables for this session — what the
    # QueueTuner consumes through the Director observer path. queue_depth 0
    # means the blocking (synchronous) loop; submit_backend is the backend
    # make_submitter actually chose ("io_uring"/"threads"/"" for blocking),
    # so an auto-mode fallback is observable, never silent.
    queue_depth: int = 0
    readahead_bytes: int = 0
    submit_backend: str = ""
    direct_io: bool = False
    inflight_hwm: int = 0
    # Process backend: worker processes spawned at session start, the pids
    # their rings reported at the attach barrier, and the seconds from the
    # first spawn to the opened start gates (all 0 / empty for threads).
    workers: int = 0
    worker_pids: List[int] = field(default_factory=list)
    worker_attach_s: float = 0.0
    # ... and, from the workers' reports at shutdown, the longest exec ->
    # interpreter's first line, and first line -> imports and spec read.
    worker_boot_s: float = 0.0
    worker_import_s: float = 0.0
    # Pooled-service sessions (ipc/service.py): this session ran on checked-
    # out pool workers (pooled), under service generation service_epoch,
    # with submit → all-workers-attached latency service_checkout_s (then
    # also its worker_attach_s; the boot and import times are a worker's
    # first session's only); arena_recycled marks a recycled arena-pool
    # segment against a fresh one.
    pooled: bool = False
    service_epoch: int = 0
    service_checkout_s: float = 0.0
    arena_recycled: bool = False
    # The training pipeline's phases of this session (``perf_counter``, the
    # clock of t_start; 0 where no pipeline stamped them): its window
    # requested (``start_step``), the window's last consumer callback run,
    # and the one fetch (``get_batch*``) that consumed it — entry, length,
    # the scheduler pump inside it, the part of the pump parked on the
    # scheduler's condition variable (waiting for readers), and the tasks
    # the pump ran. The fetch's stage time is fetch_s - fetch_pump_s.
    t_requested: float = 0.0
    t_ready: float = 0.0
    fetch_t0: float = 0.0
    fetch_s: float = 0.0
    fetch_pump_s: float = 0.0
    fetch_parked_s: float = 0.0
    fetch_tasks: int = 0

    def session_started(self, nbytes: int, num_readers: int) -> None:
        with self.lock:
            self.session_bytes = nbytes
            self.num_readers = num_readers
            self.t_start = time.perf_counter()

    def record_submit_config(self, queue_depth: int, readahead_bytes: int,
                             backend: str, direct_io: bool) -> None:
        """The submission shape this session ran with (reader-set start)."""
        with self.lock:
            self.queue_depth = int(queue_depth)
            self.readahead_bytes = int(readahead_bytes)
            self.submit_backend = backend
            self.direct_io = bool(direct_io)

    def record_workers_attached(self, pids: List[int],
                                attach_s: float) -> None:
        """Process backend: every worker attached and its gate opened."""
        with self.lock:
            self.workers = len(pids)
            self.worker_pids = list(pids)
            self.worker_attach_s = float(attach_s)

    def record_inflight_hwm(self, hwm: int) -> None:
        """Fold one reader's in-flight high-water mark in (max across)."""
        with self.lock:
            if hwm > self.inflight_hwm:
                self.inflight_hwm = hwm

    def record_worker_boot(self, boot_s: float, import_s: float) -> None:
        """Fold one worker's start-up times in (the slowest worker's)."""
        with self.lock:
            self.worker_boot_s = max(self.worker_boot_s, float(boot_s))
            self.worker_import_s = max(self.worker_import_s, float(import_s))

    def record_service_checkout(self, epoch: int, checkout_s: float,
                                arena_recycled: bool) -> None:
        """This session ran on the pooled reader service (one call, at
        reader-set start): the service generation it was armed as, the
        submit → all-workers-attached latency, and whether its arena came
        recycled from the pool."""
        with self.lock:
            self.pooled = True
            self.service_epoch = int(epoch)
            self.service_checkout_s = float(checkout_s)
            self.arena_recycled = bool(arena_recycled)

    def record_read(self, reader: int, nbytes: int, dt: float) -> None:
        with self.lock:
            self.read_calls += 1
            self.bytes_read += nbytes
            self.read_time_s += dt
            self.t_last_read = time.perf_counter()
            self.bytes_per_reader[reader] = (
                self.bytes_per_reader.get(reader, 0) + nbytes
            )
            self.read_time_per_reader[reader] = (
                self.read_time_per_reader.get(reader, 0.0) + dt
            )
            self.reads_per_reader[reader] = (
                self.reads_per_reader.get(reader, 0) + 1
            )

    def record_shard_read(self, shard: int, nbytes: int) -> None:
        """One physical read attributed to FileSet shard ``shard``."""
        with self.lock:
            self.shard_bytes[shard] = self.shard_bytes.get(shard, 0) + nbytes

    def record_steal(self, victim: int) -> None:
        """One splinter stolen from reader ``victim``'s pending queue —
        the per-reader straggler-pressure signal."""
        with self.lock:
            self.steals += 1
            self.steals_from_reader[victim] = (
                self.steals_from_reader.get(victim, 0) + 1
            )

    def record_piece(
        self,
        nbytes: int,
        cross_node: bool,
        copied: int = 0,
        borrowed: bool = False,
    ) -> None:
        """``borrowed=True`` marks a zero-copy (view) delivery: cross-node
        bytes then count as ``cross_node_view_bytes`` (no transfer
        happened), never ``cross_node_bytes``."""
        with self.lock:
            self.pieces_served += 1
            self.bytes_served += nbytes
            self.bytes_copied += copied
            if cross_node:
                if borrowed:
                    self.cross_node_view_bytes += nbytes
                else:
                    self.cross_node_bytes += nbytes

    def record_request(self) -> None:
        with self.lock:
            self.requests += 1

    def record_requested(self, t: float) -> None:
        """When the pipeline asked for this session's window."""
        with self.lock:
            self.t_requested = t

    def record_ready(self) -> None:
        """The window's last consumer callback ran (now)."""
        t = time.perf_counter()
        with self.lock:
            self.t_ready = t

    def record_fetch(self, t0: float, fetch_s: float, pump_s: float,
                     parked_s: float, tasks: int) -> None:
        """The fetch that consumed this session: entered at ``t0``, took
        ``fetch_s``, ``pump_s`` of it pumping the scheduler (``parked_s``
        of that parked), which ran ``tasks`` tasks."""
        with self.lock:
            self.fetch_t0 = t0
            self.fetch_s = fetch_s
            self.fetch_pump_s = pump_s
            self.fetch_parked_s = parked_s
            self.fetch_tasks = tasks

    # -- derived -------------------------------------------------------------
    def ingest_seconds(self) -> float:
        """Wall time from session start to last byte read."""
        if self.t_last_read == 0.0:
            return 0.0
        return self.t_last_read - self.t_start

    def throughput_bytes_per_s(self) -> float:
        t = self.ingest_seconds()
        return self.bytes_read / t if t > 0 else 0.0

    def imbalance(self) -> float:
        """max/mean bytes per reader — straggler indicator."""
        if not self.bytes_per_reader:
            return 0.0
        vals = list(self.bytes_per_reader.values())
        mean = sum(vals) / len(vals)
        return max(vals) / mean if mean else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "session_bytes": float(self.session_bytes),
            "num_readers": float(self.num_readers),
            "read_calls": float(self.read_calls),
            "bytes_read": float(self.bytes_read),
            "ingest_s": self.ingest_seconds(),
            "throughput_MBps": self.throughput_bytes_per_s() / 1e6,
            "steals": float(self.steals),
            "pieces_served": float(self.pieces_served),
            "bytes_served": float(self.bytes_served),
            "bytes_copied": float(self.bytes_copied),
            "cross_node_bytes": float(self.cross_node_bytes),
            "cross_node_view_bytes": float(self.cross_node_view_bytes),
            "requests": float(self.requests),
            "imbalance": self.imbalance(),
            "shards_read": float(len(self.shard_bytes)),
            "queue_depth": float(self.queue_depth),
            "readahead_bytes": float(self.readahead_bytes),
            "inflight_hwm": float(self.inflight_hwm),
            "direct_io": float(self.direct_io),
            "workers": float(self.workers),
            "worker_attach_s": self.worker_attach_s,
            "worker_boot_s": self.worker_boot_s,
            "worker_import_s": self.worker_import_s,
            "pooled": float(self.pooled),
            "service_epoch": float(self.service_epoch),
            "service_checkout_s": self.service_checkout_s,
            "arena_recycled": float(self.arena_recycled),
        }


@dataclass
class ServiceMetrics:
    """Reader-service observables (``ipc/service.py ReaderService``).

    One instance per service, fed from two directions: the service itself
    (admission, checkout, arena pool, worker lifecycle — recorded when each
    event happens) and the Director observer path (``record_session`` —
    per-session roll-ups at close).

    * ``admitted`` / ``queued`` / ``rejected`` / ``completed`` — admission
      outcomes; ``rejected`` counts ``ServiceBusy`` errors raised at submit.
    * checkout latency — submit → all-workers-attached per session; the
      steady-state number the pool exists to shrink (against a per-session
      worker start).
    * ``arena_hits`` / ``arena_misses`` — arena-pool recycling: a hit
      reused a prefaulted segment (no ftruncate, no page faults).
    * ``stale_events`` — ring events whose epoch matched no live session;
      dropped, counted, never delivered.
    * ``workers_spawned`` / ``workers_evicted`` — pool churn; an eviction
      removes a crashed or errored worker without touching its siblings.
    * ``rearms`` — park → re-arm transitions (sessions × workers granted).
    * ``queue_depth_hwm`` / ``occupancy_hwm`` — admission queue and busy
      workers, high-water marks.
    """

    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    admitted: int = 0
    queued: int = 0
    rejected: int = 0
    completed: int = 0
    sessions_failed: int = 0
    checkout_count: int = 0
    checkout_latency_s: float = 0.0
    checkout_latency_max_s: float = 0.0
    arena_hits: int = 0
    arena_misses: int = 0
    stale_events: int = 0
    workers_spawned: int = 0
    workers_evicted: int = 0
    rearms: int = 0
    queue_depth_hwm: int = 0
    occupancy_hwm: int = 0

    def record_admitted(self) -> None:
        with self.lock:
            self.admitted += 1

    def record_queued(self, depth: int) -> None:
        with self.lock:
            self.queued += 1
            if depth > self.queue_depth_hwm:
                self.queue_depth_hwm = depth

    def record_rejected(self) -> None:
        with self.lock:
            self.rejected += 1

    def record_checkout(self, latency_s: float) -> None:
        with self.lock:
            self.checkout_count += 1
            self.checkout_latency_s += max(latency_s, 0.0)
            if latency_s > self.checkout_latency_max_s:
                self.checkout_latency_max_s = latency_s

    def record_arena(self, recycled: bool) -> None:
        with self.lock:
            if recycled:
                self.arena_hits += 1
            else:
                self.arena_misses += 1

    def record_stale_event(self) -> None:
        with self.lock:
            self.stale_events += 1

    def record_worker_spawned(self, n: int = 1) -> None:
        with self.lock:
            self.workers_spawned += n

    def record_worker_evicted(self) -> None:
        with self.lock:
            self.workers_evicted += 1

    def record_rearm(self, nworkers: int) -> None:
        with self.lock:
            self.rearms += nworkers

    def record_occupancy(self, busy: int) -> None:
        with self.lock:
            if busy > self.occupancy_hwm:
                self.occupancy_hwm = busy

    def record_session(self, m: "SessionMetrics") -> None:
        """Director observer hook: fold one closing session's outcome in.
        Non-pooled sessions (a spawn fallback on a service-attached
        Director) never touched the pool and are ignored."""
        if not m.pooled:
            return
        with self.lock:
            self.completed += 1

    def record_session_failed(self) -> None:
        with self.lock:
            self.sessions_failed += 1

    def arena_hit_rate(self) -> float:
        with self.lock:
            total = self.arena_hits + self.arena_misses
            return self.arena_hits / total if total else 0.0

    def mean_checkout_s(self) -> float:
        with self.lock:
            return (self.checkout_latency_s / self.checkout_count
                    if self.checkout_count else 0.0)

    def summary(self) -> Dict[str, float]:
        hit_rate = self.arena_hit_rate()
        mean_checkout = self.mean_checkout_s()
        with self.lock:
            return {
                "admitted": float(self.admitted),
                "queued": float(self.queued),
                "rejected": float(self.rejected),
                "completed": float(self.completed),
                "sessions_failed": float(self.sessions_failed),
                "checkout_count": float(self.checkout_count),
                "checkout_mean_s": mean_checkout,
                "checkout_max_s": self.checkout_latency_max_s,
                "arena_hits": float(self.arena_hits),
                "arena_misses": float(self.arena_misses),
                "arena_hit_rate": hit_rate,
                "stale_events": float(self.stale_events),
                "workers_spawned": float(self.workers_spawned),
                "workers_evicted": float(self.workers_evicted),
                "rearms": float(self.rearms),
                "queue_depth_hwm": float(self.queue_depth_hwm),
                "occupancy_hwm": float(self.occupancy_hwm),
            }


@dataclass
class ShardMetrics:
    """FileSet / sharded-staging accounting.

    Two feeds, one aggregate:

    * **read side** — ``merge_session`` rides the Director observer path
      (``Director.add_observer``): each closing session's
      ``SessionMetrics.shard_bytes`` (physical bytes per FileSet shard)
      folds in here, so drivers read one object after many sessions.
    * **stage side** — the constructor-sharded pipeline records every
      host→device copy it issues (``record_stage``, keyed by the device
      key's ``str()``) plus, per step, the whole window size against the
      bytes this rank staged (``record_window``). ``addressable_bytes <
      window_bytes`` with ``cross_host_placements > 0`` is the multi-rank
      proof: pieces bound for another rank's device were *placed*
      (counted) but never staged here. With one rank the two are equal and
      cross-host stays 0.
    """

    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    sessions: int = 0
    shard_bytes: Dict[int, int] = field(default_factory=dict)
    device_put_calls: int = 0
    device_bytes: Dict[str, int] = field(default_factory=dict)
    window_bytes: int = 0             # full (B, S+1) windows, summed
    addressable_bytes: int = 0        # what THIS rank staged, summed
    cross_host_placements: int = 0
    cross_host_bytes: int = 0

    def merge_session(self, sm: "SessionMetrics") -> None:
        """Director observer: fold one finished session's per-shard reads."""
        with sm.lock:
            snap = dict(sm.shard_bytes)
        with self.lock:
            self.sessions += 1
            for sh, nb in snap.items():
                self.shard_bytes[sh] = self.shard_bytes.get(sh, 0) + nb

    def record_stage(self, device_key: str, nbytes: int) -> None:
        """One host→device copy of ``nbytes`` to this rank's device."""
        with self.lock:
            self.device_put_calls += 1
            self.device_bytes[device_key] = (
                self.device_bytes.get(device_key, 0) + nbytes)

    def record_window(self, window_bytes: int, addressable_bytes: int) -> None:
        with self.lock:
            self.window_bytes += window_bytes
            self.addressable_bytes += addressable_bytes

    def record_cross_host(self, nbytes: int) -> None:
        """A piece bound for another rank's device: placed, counted, NOT
        staged here."""
        with self.lock:
            self.cross_host_placements += 1
            self.cross_host_bytes += nbytes

    def summary(self) -> Dict[str, float]:
        with self.lock:
            max_dev = max(self.device_bytes.values(), default=0)
            return {
                "sessions": float(self.sessions),
                "shards_read": float(len(self.shard_bytes)),
                "shard_read_bytes": float(sum(self.shard_bytes.values())),
                "device_put_calls": float(self.device_put_calls),
                "devices_staged": float(len(self.device_bytes)),
                "max_device_bytes": float(max_dev),
                "window_bytes": float(self.window_bytes),
                "addressable_bytes": float(self.addressable_bytes),
                "cross_host_placements": float(self.cross_host_placements),
                "cross_host_bytes": float(self.cross_host_bytes),
            }


@dataclass
class StreamMetrics:
    """Per-pipeline streamed-staging accounting (the overlap proof).

    The streaming delivery path ships splinter groups host→device *while the
    session's reads are still in flight*; these counters exist so benchmarks
    and tests can prove the overlap instead of assuming it:

    * ``stage_latency_s`` / ``max_stage_latency_s`` — per-splinter
      arrival→staged latency (read completion to the end of the ``device_put``
      that shipped it);
    * ``inflight_bytes_hwm`` — high-water mark of bytes handed to
      ``device_put`` whose transfers have not been awaited yet (the staging
      budget's observable);
    * overlap fraction — per step, the staging span (first chunk's
      ``device_put`` start → last chunk's end) is intersected with the read
      span (session start → last byte read); the summed intersection over the
      summed step wall time is ``overlap_fraction()``. The whole-window path
      stages strictly after the last read, so it scores 0 by construction;
      a streaming run whose staging rides inside the read window approaches
      the read span / step time ratio.
    * ``stale_events`` — late splinter events dropped because their step was
      already finalized/retired (e.g. delivery racing ``resize()``).
    """

    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    splinters_staged: int = 0
    bytes_staged: int = 0
    stage_chunks: int = 0             # device_put calls issued by the stager
    stage_time_s: float = 0.0         # summed wall time inside device_put
    stage_latency_s: float = 0.0      # summed arrival->staged latency
    max_stage_latency_s: float = 0.0
    inflight_bytes: int = 0
    inflight_bytes_hwm: int = 0
    stale_events: int = 0
    steps: int = 0
    overlap_s: float = 0.0            # read-span ∩ stage-span, summed
    step_time_s: float = 0.0
    read_time_s: float = 0.0          # summed read spans (denominator cap)

    def record_chunk(
        self, nbytes: int, nsplinters: int, dt: float, latencies_s: List[float]
    ) -> None:
        with self.lock:
            self.stage_chunks += 1
            self.splinters_staged += nsplinters
            self.bytes_staged += nbytes
            self.stage_time_s += dt
            for lat in latencies_s:
                self.stage_latency_s += lat
                if lat > self.max_stage_latency_s:
                    self.max_stage_latency_s = lat

    def stage_inflight(self, delta_bytes: int) -> None:
        """Track bytes staged-but-not-awaited (+ on device_put, - on wait)."""
        with self.lock:
            self.inflight_bytes += delta_bytes
            if self.inflight_bytes > self.inflight_bytes_hwm:
                self.inflight_bytes_hwm = self.inflight_bytes

    def record_stale_event(self) -> None:
        with self.lock:
            self.stale_events += 1

    def record_step(
        self,
        read_span: "tuple[float, float]",
        stage_span: "tuple[float, float]",
        step_time_s: float,
    ) -> None:
        """Fold one step's spans into the overlap accounting.

        Spans are absolute ``perf_counter`` intervals; the concurrent time is
        their intersection, clamped to the step wall time (prefetched steps
        can have spans that predate the step's own wall interval)."""
        r0, r1 = read_span
        s0, s1 = stage_span
        ov = max(0.0, min(r1, s1) - max(r0, s0))
        with self.lock:
            self.steps += 1
            self.step_time_s += max(step_time_s, 0.0)
            self.read_time_s += max(r1 - r0, 0.0)
            self.overlap_s += min(ov, max(step_time_s, 0.0))

    # -- derived -------------------------------------------------------------
    def overlap_fraction(self) -> float:
        """Concurrent read+staging time / total step time (0 when no steps)."""
        with self.lock:
            return self.overlap_s / self.step_time_s if self.step_time_s else 0.0

    def mean_stage_latency_s(self) -> float:
        with self.lock:
            return (self.stage_latency_s / self.splinters_staged
                    if self.splinters_staged else 0.0)

    def summary(self) -> Dict[str, float]:
        with self.lock:
            frac = self.overlap_s / self.step_time_s if self.step_time_s else 0.0
            mean_lat = (self.stage_latency_s / self.splinters_staged
                        if self.splinters_staged else 0.0)
            return {
                "splinters_staged": float(self.splinters_staged),
                "bytes_staged": float(self.bytes_staged),
                "stage_chunks": float(self.stage_chunks),
                "stage_time_s": self.stage_time_s,
                "mean_stage_latency_s": mean_lat,
                "max_stage_latency_s": self.max_stage_latency_s,
                "inflight_bytes_hwm": float(self.inflight_bytes_hwm),
                "stale_events": float(self.stale_events),
                "steps": float(self.steps),
                "overlap_s": self.overlap_s,
                "step_time_s": self.step_time_s,
                "read_time_s": self.read_time_s,
                "overlap_fraction": frac,
            }


@dataclass
class IngestMetrics:
    """Per-pipeline step-ingest accounting (host vs device reassembly).

    ``host_permute_bytes`` counts bytes the *host* handles past the session
    arena to build a training batch — the paper's phase-2 permutation cost.
    The host path pays the window once per step; the device path
    (``get_batch_device``) must keep it at **0**: its only per-step host
    work is one ``device_put`` of the borrowed arena view, accounted
    separately as ``h2d_transfers`` / ``h2d_bytes``. Benchmarks assert on
    these counters rather than assuming the permutation moved.
    """

    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    steps: int = 0
    host_steps: int = 0
    device_steps: int = 0
    host_permute_bytes: int = 0
    h2d_transfers: int = 0
    h2d_bytes: int = 0

    def record_host_step(self, permute_bytes: int) -> None:
        with self.lock:
            self.steps += 1
            self.host_steps += 1
            self.host_permute_bytes += permute_bytes

    def record_device_step(
        self, staged_bytes: int, transfers: int = 1, host_bytes: int = 0
    ) -> None:
        """``host_bytes`` covers host-side copies the staging still pays
        (e.g. the copy-mode session→step-arena copy); the zero-copy device
        path passes 0."""
        with self.lock:
            self.steps += 1
            self.device_steps += 1
            self.h2d_transfers += transfers
            self.h2d_bytes += staged_bytes
            self.host_permute_bytes += host_bytes

    def summary(self) -> Dict[str, float]:
        with self.lock:
            return {
                "steps": float(self.steps),
                "host_steps": float(self.host_steps),
                "device_steps": float(self.device_steps),
                "host_permute_bytes": float(self.host_permute_bytes),
                "h2d_transfers": float(self.h2d_transfers),
                "h2d_bytes": float(self.h2d_bytes),
            }


# -- serving ------------------------------------------------------------------
def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) — monotone in q by
    construction: rank = ceil(q/100 * n) indexes a *sorted* copy, so a
    larger q can never select a smaller order statistic. Empty input folds
    to 0.0 (a histogram with no samples has no tail)."""
    if not values:
        return 0.0
    s = sorted(values)
    if q <= 0.0:
        return s[0]
    rank = math.ceil(q / 100.0 * len(s))
    return s[min(len(s), max(1, rank)) - 1]


@dataclass
class ServeMetrics:
    """Serving-subsystem observables (``serve/``): request-latency
    histograms, slot occupancy, session churn rate, and the ingest
    backpressure state machine.

    Rides the Director observer path like every other metrics sink:
    ``director.add_observer(serve_metrics.record_session)`` folds each
    closing prompt-ingest session's byte counters in (a serving CkIO
    instance carries only ingest sessions, so no filtering is needed), and
    the proof obligation ``ingest_bytes_copied == 0`` is how the benchmark
    shows prompts ride the borrowed-view path end to end.

    Latency histograms are raw sample lists folded by nearest-rank
    :func:`percentile` at ``summary()`` time — p50/p99/p999 are monotone in
    q by construction. Three clocks per request, all measured from
    *arrival* (``submit``), not batch formation:

      * ``ingest``       arrival -> prompt bytes readable (view delivered)
      * ``first_token``  arrival -> first generated token
      * ``e2e``          arrival -> eviction (EOS / max-tokens)

    Backpressure is an explicit three-state machine owned by the
    ``RequestIngester`` and *recorded* here (``set_state`` counts every
    transition): ``open`` (admit immediately) -> ``queueing`` (``ServiceBusy``
    or the inflight-ingest-byte budget tripped; bounded FIFO) ->
    ``shedding`` (queue full; new submits raise ``ServeOverloaded``). A
    request that reached the queue is *admitted* and is never dropped —
    ``shed`` counts only rejected submits.
    """

    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    slots: int = 0                    # decode slots (set by the batcher)
    # request lifecycle counters
    submitted: int = 0
    admitted: int = 0                 # accepted: started or queued (never dropped)
    shed: int = 0                     # rejected with ServeOverloaded at submit
    completed: int = 0
    failed: int = 0                   # terminal ingest errors (surfaced, not lost)
    generated_tokens: int = 0
    # backpressure state machine + triggers
    state: str = "open"
    transitions: Dict[str, int] = field(default_factory=dict)
    busy_events: int = 0              # ServiceBusy absorbed into the queue
    over_budget_events: int = 0       # inflight ingest bytes > budget
    queue_depth_hwm: int = 0
    inflight_bytes_hwm: int = 0
    # latency histograms (seconds, measured from arrival)
    ingest_lat_s: List[float] = field(default_factory=list)
    first_token_lat_s: List[float] = field(default_factory=list)
    e2e_lat_s: List[float] = field(default_factory=list)
    # decode-loop occupancy
    steps: int = 0
    occupied_slot_steps: int = 0
    admissions: int = 0
    evictions: int = 0
    # ingest-session fold (Director observer path)
    ingest_sessions: int = 0
    ingest_bytes: int = 0
    ingest_bytes_copied: int = 0
    pooled_sessions: int = 0
    t_first_submit: float = 0.0
    t_last_done: float = 0.0

    # -- lifecycle ------------------------------------------------------------
    def record_submitted(self, now: float) -> None:
        with self.lock:
            self.submitted += 1
            if self.t_first_submit == 0.0:
                self.t_first_submit = now

    def record_accepted(self) -> None:
        with self.lock:
            self.admitted += 1

    def record_shed(self) -> None:
        with self.lock:
            self.shed += 1

    def record_failed(self) -> None:
        with self.lock:
            self.failed += 1

    def record_ingested(self, latency_s: float) -> None:
        with self.lock:
            self.ingest_lat_s.append(latency_s)

    def record_first_token(self, latency_s: float) -> None:
        with self.lock:
            self.first_token_lat_s.append(latency_s)

    def record_completed(self, latency_s: float, new_tokens: int,
                         now: float) -> None:
        with self.lock:
            self.completed += 1
            self.generated_tokens += new_tokens
            self.e2e_lat_s.append(latency_s)
            self.t_last_done = max(self.t_last_done, now)

    # -- backpressure ----------------------------------------------------------
    def set_state(self, new: str) -> None:
        with self.lock:
            if new == self.state:
                return
            key = f"{self.state}->{new}"
            self.transitions[key] = self.transitions.get(key, 0) + 1
            self.state = new

    def record_busy(self) -> None:
        with self.lock:
            self.busy_events += 1

    def record_over_budget(self) -> None:
        with self.lock:
            self.over_budget_events += 1

    def record_queue_depth(self, depth: int) -> None:
        with self.lock:
            self.queue_depth_hwm = max(self.queue_depth_hwm, depth)

    def record_inflight_bytes(self, nbytes: int) -> None:
        with self.lock:
            self.inflight_bytes_hwm = max(self.inflight_bytes_hwm, nbytes)

    # -- decode loop -----------------------------------------------------------
    def record_step(self, occupied: int) -> None:
        with self.lock:
            self.steps += 1
            self.occupied_slot_steps += occupied

    def record_admission(self) -> None:
        with self.lock:
            self.admissions += 1

    def record_eviction(self) -> None:
        with self.lock:
            self.evictions += 1

    # -- Director observer -----------------------------------------------------
    def record_session(self, m: "SessionMetrics") -> None:
        with self.lock:
            self.ingest_sessions += 1
            self.ingest_bytes += m.bytes_read
            self.ingest_bytes_copied += m.bytes_copied
            if m.pooled:
                self.pooled_sessions += 1

    # -- folds -----------------------------------------------------------------
    def latency_percentiles(self, which: str) -> Dict[str, float]:
        with self.lock:
            vals = list(getattr(self, f"{which}_lat_s"))
        return {
            "p50": percentile(vals, 50.0),
            "p99": percentile(vals, 99.0),
            "p999": percentile(vals, 99.9),
        }

    def sessions_per_s(self) -> float:
        with self.lock:
            span = self.t_last_done - self.t_first_submit
            n = self.ingest_sessions
        return n / span if span > 0 else 0.0

    def mean_occupancy(self) -> float:
        with self.lock:
            if self.steps == 0 or self.slots == 0:
                return 0.0
            return self.occupied_slot_steps / (self.steps * self.slots)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for which in ("ingest", "first_token", "e2e"):
            for k, v in self.latency_percentiles(which).items():
                out[f"{which}_{k}_s"] = v
        with self.lock:
            out.update({
                "submitted": float(self.submitted),
                "admitted": float(self.admitted),
                "completed": float(self.completed),
                "shed": float(self.shed),
                "failed": float(self.failed),
                "generated_tokens": float(self.generated_tokens),
                "busy_events": float(self.busy_events),
                "over_budget_events": float(self.over_budget_events),
                "queue_depth_hwm": float(self.queue_depth_hwm),
                "inflight_bytes_hwm": float(self.inflight_bytes_hwm),
                "bp_transitions": float(sum(self.transitions.values())),
                "steps": float(self.steps),
                "admissions": float(self.admissions),
                "evictions": float(self.evictions),
                "ingest_sessions": float(self.ingest_sessions),
                "ingest_bytes": float(self.ingest_bytes),
                "ingest_bytes_copied": float(self.ingest_bytes_copied),
                "pooled_sessions": float(self.pooled_sessions),
            })
        out["sessions_per_s"] = self.sessions_per_s()
        out["mean_occupancy"] = self.mean_occupancy()
        return out


@dataclass
class LocalityMetrics:
    """Memory-locality accounting for the topology-aware reader runtime.

    One instance per ``BufferReaderSet`` (merged into a Director-lifetime
    aggregate on session close), proving — not assuming — the locality
    levers:

    * ``same_domain_bytes`` / ``cross_domain_bytes`` — delivered piece
      bytes split by whether the owning reader's NUMA domain matches the
      consuming PE's domain. Recorded **only when a Topology is
      configured** — topology-less runs keep their locality signal in
      ``SessionMetrics.cross_node_bytes`` (node granularity), and these
      counters stay 0. Cross-domain bytes are what NUMA-aware placement
      (``near_consumers``/``domain_spread`` + domain-coalesced pieces)
      exists to reduce; ``benchmarks/perf_numa.py`` gates on them.
    * per-reader splinter histograms — splinter-size → count per reader,
      the observable of per-reader adaptive sizing (a straggling stripe
      alone showing fine splinters).
    * ``prefault_pages`` — arena pages first-touch-faulted by reader
      threads on their own domain (the ``prefault_arena`` NUMA hook);
      ``pinned_threads`` / ``pin_failures`` — ``numa_pin`` outcomes.
    """

    lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    same_domain_bytes: int = 0
    cross_domain_bytes: int = 0
    pieces_same_domain: int = 0
    pieces_cross_domain: int = 0
    prefault_pages: int = 0
    pinned_threads: int = 0
    pin_failures: int = 0
    # reader -> {splinter_bytes: count}
    splinter_hist: Dict[int, Dict[int, int]] = field(default_factory=dict)

    def record_delivery(self, nbytes: int, same_domain: bool) -> None:
        with self.lock:
            if same_domain:
                self.same_domain_bytes += nbytes
                self.pieces_same_domain += 1
            else:
                self.cross_domain_bytes += nbytes
                self.pieces_cross_domain += 1

    def record_splinter(self, reader: int, nbytes: int) -> None:
        with self.lock:
            hist = self.splinter_hist.setdefault(reader, {})
            hist[nbytes] = hist.get(nbytes, 0) + 1

    def record_prefault(self, pages: int) -> None:
        with self.lock:
            self.prefault_pages += pages

    def record_pin(self, ok: bool) -> None:
        with self.lock:
            if ok:
                self.pinned_threads += 1
            else:
                self.pin_failures += 1

    def merge(self, other: "LocalityMetrics") -> None:
        """Fold ``other`` (a finished session's counters) into this one."""
        with other.lock:
            snap = (
                other.same_domain_bytes, other.cross_domain_bytes,
                other.pieces_same_domain, other.pieces_cross_domain,
                other.prefault_pages, other.pinned_threads,
                other.pin_failures,
                {r: dict(h) for r, h in other.splinter_hist.items()},
            )
        with self.lock:
            self.same_domain_bytes += snap[0]
            self.cross_domain_bytes += snap[1]
            self.pieces_same_domain += snap[2]
            self.pieces_cross_domain += snap[3]
            self.prefault_pages += snap[4]
            self.pinned_threads += snap[5]
            self.pin_failures += snap[6]
            for r, h in snap[7].items():
                hist = self.splinter_hist.setdefault(r, {})
                for n, c in h.items():
                    hist[n] = hist.get(n, 0) + c

    # -- derived -------------------------------------------------------------
    def cross_domain_fraction(self) -> float:
        with self.lock:
            total = self.same_domain_bytes + self.cross_domain_bytes
            return self.cross_domain_bytes / total if total else 0.0

    def reader_splinter_sizes(self) -> Dict[int, List[int]]:
        """Distinct splinter sizes seen per reader (sorted)."""
        with self.lock:
            return {r: sorted(h) for r, h in self.splinter_hist.items()}

    def summary(self) -> Dict[str, float]:
        frac = self.cross_domain_fraction()
        with self.lock:
            return {
                "same_domain_bytes": float(self.same_domain_bytes),
                "cross_domain_bytes": float(self.cross_domain_bytes),
                "pieces_same_domain": float(self.pieces_same_domain),
                "pieces_cross_domain": float(self.pieces_cross_domain),
                "cross_domain_fraction": frac,
                "prefault_pages": float(self.prefault_pages),
                "pinned_threads": float(self.pinned_threads),
                "pin_failures": float(self.pin_failures),
                "readers_observed": float(len(self.splinter_hist)),
            }
