"""Online tuning of the reader layer (paper future-work §VI-A, implemented).

Three pieces:

* ``suggest_num_readers`` — a closed-form heuristic from file size and
  machine shape. The paper's Figs. 1/4 show a U-curve: too few readers miss
  disk parallelism, too many congest the FS with small requests. The
  heuristic targets a fixed bytes-per-reader chunk (large enough for
  streaming bandwidth) bounded by [1 per node, 2 per PE].
* ``AutoTuner`` — online refinement: records (num_readers → throughput)
  observations across sessions and explores the power-of-two neighbourhood
  of the current best (the search-based approach of Behzad et al. [4] that
  the paper cites, restricted to a single knob).
* ``SplinterSizer`` — dynamic splinter sizing for the streaming delivery
  path: sizes the unit of physical I/O from observed per-reader throughput
  (large splinters on fast streaming stripes — fewer syscalls, better
  sequential bandwidth) shrunk under steal pressure (small splinters near
  straggler-stolen tails — finer-grained stealing, tighter completion
  bound).

* ``QueueTuner`` — the cold-path controller: a deterministic hill-climb
  over the 2-D (queue depth, readahead window) space of the async
  submission layer (``io/submit.py``). Depth trades request concurrency
  against FS congestion (TASIO's central knob); the readahead window
  trades kernel prefetch reach against cache churn. Both knobs move
  multiplicatively (the response curves are log-shaped: doubling depth
  matters at 2, not at 62), observations are keyed by the exact
  (depth, readahead) pair, and exploration follows a fixed neighbour
  order — same-history determinism like ``AutoTuner``.

``AutoTuner``, ``SplinterSizer`` and ``QueueTuner`` share one observation
path: ``record_session(metrics)`` takes the ``SessionMetrics`` every
session already collects — the Director feeds all three on session close,
so any controller added later observes for free.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.metrics import SessionMetrics
from repro_torch.io.posix import DEFAULT_ALIGN, aligned_floor


def suggest_num_readers(
    file_bytes: int,
    num_pes: int,
    num_nodes: int = 1,
    target_chunk_bytes: int = 64 * 1024 * 1024,
) -> int:
    """Reader count for a session of ``file_bytes`` when ``num_readers`` is
    unset: one reader per ``target_chunk_bytes``, at least one per node,
    at most two per PE (paper Fig. 4: beyond ~2/PE only adds contention)."""
    if file_bytes <= 0:
        return 1
    by_chunk = max(1, (file_bytes + target_chunk_bytes - 1) // target_chunk_bytes)
    lo = max(1, num_nodes)            # at least one independent path per node
    hi = max(lo, 2 * num_pes)         # paper Fig. 4: beyond ~2/PE only adds contention
    return int(min(max(by_chunk, lo), hi))


@dataclass
class AutoTuner:
    """Online power-of-two hillclimb over the reader count.

    Exploration is **deterministic**: given the same observation history,
    ``suggest`` returns the same value. The candidate order is fixed —
    current best, then its half, then its double — and the first candidate
    without observations (and within the ``4 * num_pes`` contention cap) is
    explored; with the whole neighbourhood observed, the best is exploited.
    Ties in ``best()`` break toward the reader count observed first
    (dict insertion order), which is itself deterministic per history.
    """

    num_pes: int
    num_nodes: int = 1
    observations: Dict[int, List[float]] = field(default_factory=dict)

    def record(self, num_readers: int, throughput: float) -> None:
        self.observations.setdefault(num_readers, []).append(throughput)

    def record_session(self, metrics: SessionMetrics) -> None:
        """Shared observation hook: fold one finished session's metrics in.

        Sessions that never read a byte (e.g. cancelled before any splinter
        landed) carry no throughput signal and are skipped."""
        bps = metrics.throughput_bytes_per_s()
        if metrics.num_readers > 0 and bps > 0:
            self.record(metrics.num_readers, bps)

    def _score(self, r: int) -> float:
        obs = self.observations.get(r, [])
        return sum(obs) / len(obs) if obs else float("-inf")

    def best(self) -> Optional[int]:
        if not self.observations:
            return None
        return max(self.observations, key=self._score)

    def suggest(self, file_bytes: int) -> int:
        seed = suggest_num_readers(file_bytes, self.num_pes, self.num_nodes)
        if not self.observations:
            return seed
        best = self.best()
        assert best is not None
        # Fixed exploration order: best, half, double — first untried wins.
        for cand in (best, max(1, best // 2), best * 2):
            if cand not in self.observations and cand <= 4 * self.num_pes:
                return cand
        return best


@dataclass
class QueueTuner:
    """Deterministic 2-D hillclimb over (queue depth, readahead window).

    Observations are mean throughput per exact ``(depth, readahead)`` pair,
    folded in through the shared ``record_session`` hook (sessions that ran
    the blocking loop — ``queue_depth == 0`` — or read nothing carry no
    signal and are skipped). ``suggest`` explores the fixed-order
    multiplicative neighbourhood of the current best — depth doubled,
    halved, then readahead doubled, halved, then the diagonal — first
    unobserved candidate wins; a fully-observed neighbourhood exploits the
    best. Readahead is quantized to ``readahead_quantum`` so float jitter
    cannot mint spurious grid points; depth clamps to
    ``[min_depth, max_depth]``.
    """

    min_depth: int = 1
    max_depth: int = 64
    max_readahead: int = 64 * 1024 * 1024
    readahead_quantum: int = 1024 * 1024
    observations: Dict[Tuple[int, int], List[float]] = field(
        default_factory=dict)

    def _quant(self, readahead: int) -> int:
        q = self.readahead_quantum
        r = (max(0, int(readahead)) // q) * q
        return min(r, self.max_readahead)

    def _clamp(self, depth: int, readahead: int) -> Tuple[int, int]:
        return (min(max(int(depth), self.min_depth), self.max_depth),
                self._quant(readahead))

    def record(self, depth: int, readahead: int, throughput: float) -> None:
        key = self._clamp(depth, readahead)
        self.observations.setdefault(key, []).append(throughput)

    def record_session(self, metrics: SessionMetrics) -> None:
        """Shared observation hook (Director feeds this on session close)."""
        bps = metrics.throughput_bytes_per_s()
        if metrics.queue_depth > 0 and bps > 0:
            self.record(metrics.queue_depth, metrics.readahead_bytes, bps)

    def _score(self, key: Tuple[int, int]) -> float:
        obs = self.observations.get(key, [])
        return sum(obs) / len(obs) if obs else float("-inf")

    def best(self) -> Optional[Tuple[int, int]]:
        if not self.observations:
            return None
        return max(self.observations, key=self._score)

    def best_throughput(self) -> float:
        b = self.best()
        return self._score(b) if b is not None else 0.0

    def _neighbourhood(self, d: int, r: int) -> List[Tuple[int, int]]:
        q = self.readahead_quantum
        raw = [
            (d, r),
            (d * 2, r),
            (max(self.min_depth, d // 2), r),
            (d, r * 2 if r else q),
            (d, r // 2 if r >= 2 * q else 0),
            (d * 2, r * 2 if r else q),
        ]
        out: List[Tuple[int, int]] = []
        for cand in raw:
            c = self._clamp(*cand)
            if c not in out:
                out.append(c)
        return out

    def suggest(self, default_depth: int,
                default_readahead: int = 0) -> Tuple[int, int]:
        """(queue_depth, readahead_bytes) for the next session."""
        if not self.observations:
            return self._clamp(default_depth, default_readahead)
        best = self.best()
        assert best is not None
        for cand in self._neighbourhood(*best):
            if cand not in self.observations:
                return cand
        return best


@dataclass
class _ReaderEMA:
    """Per-reader (stripe-index) smoothed observations."""

    bps: float = 0.0
    steal_frac: float = 0.0
    sessions: int = 0


@dataclass
class SplinterSizer:
    """Observation-driven splinter sizing (streaming controller).

    Targets ``target_splinter_s`` seconds of I/O per splinter at the
    observed per-reader-thread bandwidth, then shrinks under steal pressure:
    a session where many splinters were stolen is straggler-bound, and
    smaller splinters bound its completion tighter (steal granularity).
    Both signals are EMA-smoothed so one outlier session cannot whipsaw the
    size; the result is clamped to ``[min_bytes, max_bytes]``, rounded
    down to a 256 KiB multiple (stable across jitter), and finally floored
    to the FS block alignment (``io.posix.aligned_floor``) — shrink under
    steal pressure can never produce a sub-block size that would put preadv
    offsets off the block grid and break the zero-copy alignment contract.
    The smoothing + quantization also bound a side effect on the streamed
    device path: every size change alters the per-splinter chunks a window
    is staged in, so suggestions must converge rather than wander (see
    data/pipeline.py).

    Sizing is tracked at two granularities sharing one observation hook:

    * **session-level** (``suggest``) — the EMA over all readers;
    * **per-reader** (``suggest_per_reader``) — one EMA per stripe index,
      keyed by the per-reader breakdowns ``SessionMetrics`` records (bytes,
      wall time, splinters stolen *from* that reader). A straggling stripe
      alone gets fine splinters (tight steal granularity where it matters)
      while healthy stripes keep large streaming reads; readers without
      enough signal fall back to the session-level size.
    """

    min_bytes: int = 256 * 1024
    max_bytes: int = 64 * 1024 * 1024
    target_splinter_s: float = 0.05
    alpha: float = 0.5                 # EMA weight of the newest session
    align: int = DEFAULT_ALIGN         # FS block floor for every suggestion
    sessions_observed: int = 0
    ema_reader_bps: float = 0.0
    ema_steal_frac: float = 0.0
    per_reader: Dict[int, _ReaderEMA] = field(default_factory=dict)

    def record_session(self, metrics: SessionMetrics) -> None:
        """Same shared hook as ``AutoTuner.record_session``."""
        if metrics.read_calls <= 0 or metrics.read_time_s <= 0:
            return
        # read_time_s is summed across reader threads, so this is per-thread
        # (per-stripe) bandwidth — exactly the rate one splinter is read at.
        bps = metrics.bytes_read / metrics.read_time_s
        steal_frac = metrics.steals / metrics.read_calls
        a = self.alpha if self.sessions_observed else 1.0
        self.ema_reader_bps += a * (bps - self.ema_reader_bps)
        self.ema_steal_frac += a * (steal_frac - self.ema_steal_frac)
        self.sessions_observed += 1
        # Per-reader fold: bytes/time/steals attributed to the planned
        # stripe owner (stolen splinters count against their owner — the
        # straggler — not the thief).
        for r, nbytes in metrics.bytes_per_reader.items():
            dt = metrics.read_time_per_reader.get(r, 0.0)
            calls = metrics.reads_per_reader.get(r, 0)
            if dt <= 0 or calls <= 0:
                continue
            st = self.per_reader.setdefault(r, _ReaderEMA())
            ar = self.alpha if st.sessions else 1.0
            st.bps += ar * (nbytes / dt - st.bps)
            st.steal_frac += ar * (
                metrics.steals_from_reader.get(r, 0) / calls - st.steal_frac)
            st.sessions += 1

    def _size_from(self, bps: float, steal_frac: float) -> int:
        size = bps * self.target_splinter_s
        # Steal pressure shrinks the unit: at >=50% stolen splinters the
        # size bottoms out at a quarter of the throughput-derived target.
        shrink = 1.0 - 1.5 * min(steal_frac, 0.5)
        size = int(size * shrink)
        size = max(self.min_bytes, min(self.max_bytes, size))
        size = max(self.min_bytes, (size // (256 * 1024)) * (256 * 1024))
        # Alignment floor LAST: whatever min_bytes the caller configured,
        # the emitted size is a whole number of FS blocks.
        return aligned_floor(size, self.align)

    def suggest(self, default: int) -> int:
        """Splinter size for the next session; ``default`` until observed."""
        if not self.sessions_observed or self.ema_reader_bps <= 0:
            return default
        return self._size_from(self.ema_reader_bps, self.ema_steal_frac)

    def suggest_per_reader(
        self, num_readers: int, default: int
    ) -> Optional[List[int]]:
        """Per-stripe splinter sizes for the next ``num_readers``-reader
        session, or ``None`` before any per-reader signal exists (the plan
        then uses the scalar ``suggest`` size everywhere)."""
        if not self.sessions_observed or not self.per_reader:
            return None
        base = self.suggest(default)
        out: List[int] = []
        for r in range(num_readers):
            st = self.per_reader.get(r)
            if st is None or st.bps <= 0:
                out.append(base)
            else:
                out.append(self._size_from(st.bps, st.steal_frac))
        return out
