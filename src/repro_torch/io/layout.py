"""Stripe / splinter layout math for read sessions.

A read session covers ``[offset, offset+nbytes)`` of one file. The session is
decomposed twice, mirroring the paper:

* **stripes** — one contiguous disjoint stripe per buffer reader (paper §III-C.4:
  "Each buffer chare reads a disjoint section of the file").
* **splinters** — fixed-size sub-chunks *within* a stripe (paper §VI-C,
  "Splintered I/O", implemented here): the unit of actual pread calls, early
  request fulfilment, and work stealing.

All functions here are pure and unit-tested (including hypothesis properties:
stripes partition the session; every byte belongs to exactly one splinter).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from repro_torch.io.posix import DEFAULT_ALIGN, aligned_floor


@dataclass(frozen=True)
class Splinter:
    """One unit of physical I/O within a reader's stripe."""

    reader: int        # owning reader index
    index: int         # splinter index within the session (global)
    offset: int        # absolute file offset
    nbytes: int

    @property
    def end(self) -> int:
        return self.offset + self.nbytes


@dataclass(frozen=True)
class StripePlan:
    """Full decomposition of a session across readers."""

    offset: int                      # session start (absolute)
    nbytes: int                      # session length
    num_readers: int
    splinter_bytes: int
    stripe_bounds: Tuple[Tuple[int, int], ...]   # per reader: (abs_start, abs_end)
    splinters: Tuple[Splinter, ...]              # global splinter list
    # Per-reader adaptive sizing: when set, reader r's stripe was cut into
    # reader_splinter_bytes[r]-sized splinters (splinter_bytes then only
    # records the session-level base size). None = uniform splinter_bytes.
    reader_splinter_bytes: Optional[Tuple[int, ...]] = None
    # Hard segmentation offsets the plan honoured (FileSet shard starts):
    # no stripe — hence no splinter, hence no single pread — spans one.
    hard_bounds: Optional[Tuple[int, ...]] = None

    @property
    def end(self) -> int:
        return self.offset + self.nbytes

    def reader_for(self, abs_off: int) -> int:
        """Reader owning the byte at ``abs_off`` (binary search over stripes)."""
        lo, hi = 0, self.num_readers - 1
        while lo < hi:
            mid = (lo + hi) // 2
            if self.stripe_bounds[mid][1] <= abs_off:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def splinters_for_reader(self, r: int) -> List[Splinter]:
        return [s for s in self.splinters if s.reader == r]


def _align_up(x: int, a: int) -> int:
    return ((x + a - 1) // a) * a


def _cut_stripes(
    offset: int, nbytes: int, num_readers: int, align: int
) -> List[Tuple[int, int]]:
    """The classic stripe cut of ``[offset, offset+nbytes)`` over
    ``num_readers``: interior boundaries aligned up to ``align``, the final
    stripe absorbs the remainder, trailing readers may get empty stripes."""
    base = nbytes // num_readers
    stripe_len = _align_up(max(base, 1), align) if nbytes else 0
    bounds: List[Tuple[int, int]] = []
    cur = offset
    end = offset + nbytes
    for r in range(num_readers):
        if r == num_readers - 1:
            s, e = cur, end
        else:
            s, e = cur, min(cur + stripe_len, end)
        bounds.append((s, e))
        cur = e
    return bounds


def _readers_per_segment(
    seg_bytes: Sequence[int], num_readers: int
) -> List[int]:
    """Largest-remainder allocation of readers to segments: every segment
    gets >= 1 reader (a shard is never co-owned with its neighbour), extras
    go by byte share, deterministic tie-break on segment order."""
    nsegs = len(seg_bytes)
    alloc = [1] * nsegs
    extra = num_readers - nsegs
    total = sum(seg_bytes)
    if extra <= 0 or total == 0:
        return alloc
    shares = [extra * b / total for b in seg_bytes]
    floors = [int(sh) for sh in shares]
    for i, fl in enumerate(floors):
        alloc[i] += fl
    rest = extra - sum(floors)
    order = sorted(range(nsegs), key=lambda i: (-(shares[i] - floors[i]), i))
    for i in order[:rest]:
        alloc[i] += 1
    return alloc


def plan_session(
    offset: int,
    nbytes: int,
    num_readers: int,
    splinter_bytes: int = 8 * 1024 * 1024,
    align: int = DEFAULT_ALIGN,
    reader_splinter_bytes: Optional[Sequence[int]] = None,
    hard_bounds: Optional[Sequence[int]] = None,
) -> StripePlan:
    """Partition ``[offset, offset+nbytes)`` into stripes and splinters.

    Stripe boundaries are aligned to ``align`` (FS block size) except at the
    session edges; splinters are capped at ``splinter_bytes``. Degenerate
    cases (more readers than bytes) collapse gracefully: trailing readers get
    empty stripes.

    ``reader_splinter_bytes`` (per-reader adaptive sizing) overrides the
    splinter size per stripe: reader ``r`` reads in
    ``reader_splinter_bytes[r]`` units — a straggling stripe can run fine
    splinters (tight steal granularity) while healthy stripes stream large
    reads. Stripe *bounds* stay a function of ``num_readers`` alone, so
    per-reader sizes never change which reader owns a byte.

    ``hard_bounds`` (FileSet shard starts, in session byte-space) are
    offsets NO stripe may span: the session is first segmented at every
    hard bound strictly inside it, readers are distributed over segments by
    byte share (>= 1 each, largest-remainder), and each segment is striped
    independently. Since a splinter lives inside one stripe, no physical
    read ever crosses a shard boundary — each lands wholly in one shard
    file. Requires ``num_readers >= number of segments`` (the Director
    bumps the reader count before planning a FileSet session).
    """
    if nbytes < 0:
        raise ValueError(f"negative session length {nbytes}")
    num_readers = max(1, num_readers)
    # Floor every splinter size to an ``align`` multiple (not just a
    # minimum): a non-multiple size would put every subsequent splinter
    # offset in the stripe off the FS block grid — the read-modify-write
    # amplification the alignment contract exists to prevent. Enforced
    # here so every caller is covered, not only the SplinterSizer.
    splinter_bytes = aligned_floor(splinter_bytes, align)
    if reader_splinter_bytes is not None:
        if len(reader_splinter_bytes) != num_readers:
            raise ValueError(
                f"reader_splinter_bytes has {len(reader_splinter_bytes)} "
                f"entries for {num_readers} readers")
        reader_splinter_bytes = tuple(
            aligned_floor(int(s), align) for s in reader_splinter_bytes)

    end = offset + nbytes
    cuts = (sorted({int(b) for b in hard_bounds if offset < int(b) < end})
            if hard_bounds else [])

    if not cuts:
        bounds = _cut_stripes(offset, nbytes, num_readers, align)
    else:
        edges = [offset] + cuts + [end]
        segs = list(zip(edges[:-1], edges[1:]))
        if num_readers < len(segs):
            raise ValueError(
                f"{num_readers} readers cannot honour {len(segs)} hard "
                f"segments (need >= one reader per segment)")
        alloc = _readers_per_segment([e - s for s, e in segs], num_readers)
        bounds = []
        for (s, e), k in zip(segs, alloc):
            bounds.extend(_cut_stripes(s, e - s, k, align))

    splinters: List[Splinter] = []
    gidx = 0
    for r, (s, e) in enumerate(bounds):
        sb = (reader_splinter_bytes[r] if reader_splinter_bytes is not None
              else splinter_bytes)
        pos = s
        while pos < e:
            n = min(sb, e - pos)
            splinters.append(Splinter(reader=r, index=gidx, offset=pos, nbytes=n))
            gidx += 1
            pos += n

    return StripePlan(
        offset=offset,
        nbytes=nbytes,
        num_readers=num_readers,
        splinter_bytes=splinter_bytes,
        stripe_bounds=tuple(bounds),
        splinters=tuple(splinters),
        reader_splinter_bytes=reader_splinter_bytes,
        hard_bounds=tuple(cuts) if cuts else None,
    )


def pieces_for_range(
    plan: StripePlan,
    abs_off: int,
    nbytes: int,
    coalesce_key: Optional[Callable[[int], object]] = None,
) -> List[Tuple[int, int, int]]:
    """Split a client read ``[abs_off, abs_off+nbytes)`` into per-reader pieces.

    Returns ``[(reader, piece_abs_off, piece_nbytes), ...]`` in file order.
    The paper notes that given realistic over-decomposition each request
    touches 1–2 consecutive readers; this handles the general case.

    ``coalesce_key`` enables piece coalescing (Thakur-style request merging):
    contiguous pieces whose readers map to the same key — typically the
    reader's node, since the whole arena is addressable within a node — are
    merged into one piece attributed to the first reader of the run. A
    request spanning K stripes of co-located readers then costs one waiter,
    one scheduled task and one copy (or zero copies on the borrowed-view
    path) instead of K of each. ``None`` keeps the exact per-stripe split.
    """
    if abs_off < plan.offset or abs_off + nbytes > plan.end:
        raise ValueError(
            f"read [{abs_off}, {abs_off + nbytes}) outside session "
            f"[{plan.offset}, {plan.end})"
        )
    pieces: List[Tuple[int, int, int]] = []
    pos = abs_off
    end = abs_off + nbytes
    while pos < end:
        r = plan.reader_for(pos)
        _, stripe_end = plan.stripe_bounds[r]
        take = min(end, stripe_end) - pos
        if take <= 0:  # pragma: no cover - guarded by reader_for correctness
            raise RuntimeError("layout error: zero-length piece")
        if (
            coalesce_key is not None
            and pieces
            and coalesce_key(pieces[-1][0]) == coalesce_key(r)
        ):
            pr, po, pn = pieces[-1]
            pieces[-1] = (pr, po, pn + take)   # pieces are contiguous in file order
        else:
            pieces.append((r, pos, take))
        pos += take
    return pieces


def splinters_covering(
    plan: StripePlan, abs_off: int, nbytes: int
) -> List[Splinter]:
    """All splinters intersecting ``[abs_off, abs_off+nbytes)``."""
    end = abs_off + nbytes
    return [s for s in plan.splinters if s.offset < end and s.end > abs_off]
