"""Multi-file sharded corpora: the ``FileSet`` manifest.

Production corpora are thousands of token-file shards, not one large file.
A ``FileSet`` is an ordered manifest over N ``tokenfile.py`` shards that
presents them as ONE logical token file with **global row addressing**:

* the global *row* space is the concatenation of the shards' leading
  dimensions (shard k's rows follow shard k-1's);
* the global *byte* space is the concatenation of the shards' data regions
  — header pages excluded — starting at offset 0. Because manifest
  validation pins one dtype and one inner shape across every shard, a row
  is ``row_bytes`` everywhere and global byte offset = row * row_bytes with
  no per-shard arithmetic. Windows freely straddle shard boundaries;
  :meth:`FileSet.shard_ranges_for_rows` resolves them to per-shard file
  ranges (the NumPy-concat oracle the property tests check against).

The byte space is made physical by ``io/posix.py``'s ``ShardedFile`` (built
via :meth:`FileSet.sharded_file`): a ``PosixFile``-compatible handle whose
``pread`` dispatches global offsets to the right shard fd. Everything above
— stripe planning (with ``hard_bounds`` pinned to shard starts so no stripe
spans a shard), buffer readers, borrowed views — works unchanged;
``CkIO.open_fileset`` / ``CkIOPipeline(FileSet(...))`` are the entry
points.

Validation happens at manifest build time, not at first read: mismatched
dtype or inner shape, a torn header (``read_meta`` raises a descriptive
``ValueError`` naming the path) and a truncated shard *body* (file shorter
than header + data bytes) all fail ``FileSet.build`` immediately. Empty
shards (zero rows) are legal and occupy no byte space.
"""
from __future__ import annotations

import os
from bisect import bisect_right
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.tokenfile import (
    HEADER_BYTES,
    TokenFileMeta,
    read_meta,
    write_token_file,
)
from repro_torch.io.posix import ShardedFile


@dataclass(frozen=True)
class ShardInfo:
    """One shard's position in the global row / byte spaces."""

    index: int            # position in the manifest (stable shard id)
    path: str
    meta: TokenFileMeta
    row_start: int        # first global row this shard holds
    byte_start: int       # first global *data* byte this shard holds

    @property
    def num_rows(self) -> int:
        return self.meta.num_rows

    @property
    def row_end(self) -> int:
        return self.row_start + self.meta.num_rows

    @property
    def data_bytes(self) -> int:
        return self.meta.data_bytes

    @property
    def byte_end(self) -> int:
        return self.byte_start + self.meta.data_bytes


class FileSet:
    """Ordered manifest over N token-file shards, addressable as one file.

    Exposes the ``TokenFileMeta`` surface (``dtype``, ``shape``,
    ``itemsize``, ``row_bytes``, ``num_rows``, ``data_bytes``,
    ``byte_range_for_rows``) so callers like ``CkIOPipeline`` treat a
    FileSet exactly like a single file's meta — except offsets live in the
    global data byte space (``data_offset == 0``; there is no header page
    in the logical file).
    """

    def __init__(self, shards: Sequence[ShardInfo]):
        if not shards:
            raise ValueError("FileSet needs at least one shard")
        self.shards: Tuple[ShardInfo, ...] = tuple(shards)
        first = self.shards[0].meta
        self._dtype = first.dtype
        self._inner = tuple(first.shape[1:])
        self._row_starts = tuple(s.row_start for s in self.shards)
        last = self.shards[-1]
        self._total_rows = last.row_end
        self._total_bytes = last.byte_end

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, paths: Sequence[str]) -> "FileSet":
        """Read every shard's header, validate consistency, build the manifest.

        Raises ``ValueError`` naming the offending path on: torn/corrupt
        header (via ``read_meta``), dtype or inner-shape mismatch vs shard
        0, or a shard file too short to hold its declared data region.
        """
        if not paths:
            raise ValueError("FileSet.build: empty path list")
        shards: List[ShardInfo] = []
        row, byte = 0, 0
        ref: Optional[TokenFileMeta] = None
        for i, p in enumerate(paths):
            meta = read_meta(p)
            if ref is None:
                ref = meta
            else:
                if meta.dtype != ref.dtype:
                    raise ValueError(
                        f"{p}: shard dtype {meta.dtype} != fileset dtype "
                        f"{ref.dtype} (from {paths[0]})")
                if tuple(meta.shape[1:]) != tuple(ref.shape[1:]):
                    raise ValueError(
                        f"{p}: shard inner shape {tuple(meta.shape[1:])} != "
                        f"fileset inner shape {tuple(ref.shape[1:])} "
                        f"(from {paths[0]})")
            need = HEADER_BYTES + meta.data_bytes
            have = os.path.getsize(p)
            if have < need:
                raise ValueError(
                    f"{p}: truncated shard body ({have} bytes on disk, "
                    f"header declares {need})")
            shards.append(ShardInfo(
                index=i, path=str(p), meta=meta,
                row_start=row, byte_start=byte))
            row += meta.num_rows
            byte += meta.data_bytes
        return cls(shards)

    # -- TokenFileMeta-compatible surface ---------------------------------
    @property
    def dtype(self) -> np.dtype:
        return self._dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self._total_rows,) + self._inner

    @property
    def itemsize(self) -> int:
        return self._dtype.itemsize

    @property
    def row_bytes(self) -> int:
        inner = int(np.prod(self._inner, dtype=np.int64)) if self._inner else 1
        return inner * self.itemsize

    @property
    def num_rows(self) -> int:
        return self._total_rows

    @property
    def data_offset(self) -> int:
        """The logical file has no header page: global byte 0 is row 0."""
        return 0

    @property
    def data_bytes(self) -> int:
        return self._total_bytes

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def paths(self) -> Tuple[str, ...]:
        return tuple(s.path for s in self.shards)

    def byte_range_for_rows(self, start_row: int, num_rows: int) -> Tuple[int, int]:
        """(global_offset, nbytes) covering rows [start_row, start_row+num_rows).

        Offsets are in the global data byte space — uniform ``row_bytes``
        makes this pure arithmetic even across shard boundaries.
        """
        if start_row < 0 or start_row + num_rows > self._total_rows:
            raise ValueError(
                f"rows [{start_row}, {start_row + num_rows}) out of bounds "
                f"(fileset has {self._total_rows})")
        return (start_row * self.row_bytes, num_rows * self.row_bytes)

    # -- shard resolution --------------------------------------------------
    def shard_of_row(self, row: int) -> int:
        """Shard index holding global ``row`` (skips empty shards)."""
        if row < 0 or row >= self._total_rows:
            raise ValueError(f"row {row} out of bounds ({self._total_rows})")
        i = bisect_right(self._row_starts, row) - 1
        # row_starts repeat across empty shards; walk to the holder.
        while self.shards[i].num_rows == 0:
            i += 1
        return i

    def shard_of_byte(self, global_off: int) -> int:
        """Shard index holding global data byte ``global_off``."""
        if global_off < 0 or global_off >= self._total_bytes:
            raise ValueError(
                f"byte {global_off} out of bounds ({self._total_bytes})")
        return self.shard_of_row(global_off // self.row_bytes)

    def shard_ranges_for_rows(
        self, start_row: int, num_rows: int
    ) -> List[Tuple[int, int, int]]:
        """Resolve a (possibly shard-straddling) row window to per-shard
        file ranges: ``[(shard_index, file_offset, nbytes), ...]`` in global
        row order — what a reader actually preads from each shard file.
        """
        self.byte_range_for_rows(start_row, num_rows)   # bounds check
        out: List[Tuple[int, int, int]] = []
        row, end = start_row, start_row + num_rows
        while row < end:
            i = self.shard_of_row(row)
            sh = self.shards[i]
            take = min(end, sh.row_end) - row
            off, nb = sh.meta.byte_range_for_rows(row - sh.row_start, take)
            out.append((i, off, nb))
            row += take
        return out

    def shard_bounds_in(self, offset: int, nbytes: int) -> List[int]:
        """Interior shard-start byte offsets strictly inside
        ``(offset, offset + nbytes)`` of the global space."""
        end = offset + nbytes
        return [s.byte_start for s in self.shards[1:]
                if s.meta.num_rows and offset < s.byte_start < end]

    # -- physical handle ---------------------------------------------------
    def segments(self) -> Tuple[Tuple[str, int, int, int, int], ...]:
        """``ShardedFile`` segment table (empty shards omitted, their
        indices reserved): (path, global_start, file_base, nbytes,
        shard_id)."""
        return tuple(
            (s.path, s.byte_start, HEADER_BYTES, s.data_bytes, s.index)
            for s in self.shards if s.data_bytes > 0)

    def sharded_file(self, *, direct_io: bool = False) -> ShardedFile:
        """Open one ``ShardedFile`` over the manifest's byte space.

        ``direct_io`` opens every shard O_DIRECT (io/posix.py: shard data
        regions must sit on the filesystem block grid or this raises
        ``DirectIOError`` naming the offenders — never a silent fallback)."""
        return ShardedFile(self.segments(), direct_io=direct_io)

    def describe(self) -> str:
        return (f"fileset[{self.num_shards} shards, {self._total_rows} rows, "
                f"{self._total_bytes} B]: {self.shards[0].path} .. "
                f"{self.shards[-1].path}")

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return f"FileSet({self.describe()})"


def write_token_shards(
    directory: str,
    array: np.ndarray,
    row_counts: Sequence[int],
    prefix: str = "shard",
) -> List[str]:
    """Split ``array`` row-wise into shard files (tests / benchmarks).

    ``row_counts`` must sum to ``len(array)``; zero counts produce legal
    empty shards. Returns the ordered shard paths.
    """
    if sum(int(c) for c in row_counts) != len(array):
        raise ValueError(
            f"row_counts sum {sum(row_counts)} != array rows {len(array)}")
    os.makedirs(directory, exist_ok=True)
    paths: List[str] = []
    row = 0
    for i, c in enumerate(int(c) for c in row_counts):
        p = os.path.join(directory, f"{prefix}_{i:05d}.bin")
        write_token_file(p, array[row: row + c])
        paths.append(p)
        row += c
    return paths
