"""Binary token / embedding file format.

One header page (4096 B, JSON + padding) followed by raw row-major array
bytes. Sequential data layout, as the paper assumes ("a sequential
organization of data in the file, which is typical for ... computational
astronomy and graph algorithms") — here: flat token streams for LMs and flat
frame/patch embedding matrices for the audio/VLM frontend stubs.

The format is deliberately seek-friendly: element i lives at
``DATA_OFFSET + i * itemsize`` so read sessions can map element ranges to
byte ranges with pure arithmetic.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np

MAGIC = "CKIO-TOKENS-v1"
HEADER_BYTES = 4096


@dataclass(frozen=True)
class TokenFileMeta:
    dtype: np.dtype
    shape: Tuple[int, ...]

    @property
    def itemsize(self) -> int:
        return self.dtype.itemsize

    @property
    def row_bytes(self) -> int:
        """Bytes per leading-dim element (token or embedding row)."""
        inner = int(np.prod(self.shape[1:], dtype=np.int64)) if len(self.shape) > 1 else 1
        return inner * self.itemsize

    @property
    def num_rows(self) -> int:
        return self.shape[0]

    @property
    def data_offset(self) -> int:
        return HEADER_BYTES

    @property
    def data_bytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * self.itemsize

    def byte_range_for_rows(self, start_row: int, num_rows: int) -> Tuple[int, int]:
        """(absolute_offset, nbytes) covering rows [start_row, start_row+num_rows)."""
        if start_row < 0 or start_row + num_rows > self.num_rows:
            raise ValueError(
                f"rows [{start_row}, {start_row+num_rows}) out of bounds "
                f"(file has {self.num_rows})"
            )
        return (
            self.data_offset + start_row * self.row_bytes,
            num_rows * self.row_bytes,
        )


def write_token_file(path: str, array: np.ndarray) -> TokenFileMeta:
    meta = {
        "magic": MAGIC,
        "dtype": array.dtype.str,
        "shape": list(array.shape),
    }
    blob = json.dumps(meta).encode()
    if len(blob) > HEADER_BYTES - 1:
        raise ValueError("header too large")
    header = blob + b"\x00" * (HEADER_BYTES - len(blob))
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(array).tobytes())
    return TokenFileMeta(dtype=array.dtype, shape=tuple(array.shape))


def read_meta(path: str) -> TokenFileMeta:
    """Parse the 4096-byte header page; every corruption mode raises a
    descriptive ``ValueError`` naming the path (a torn header must not
    surface as a raw ``json``/``KeyError`` deep inside a session open)."""
    with open(path, "rb") as f:
        head = f.read(HEADER_BYTES)
    if len(head) < HEADER_BYTES:
        raise ValueError(
            f"{path}: truncated token-file header "
            f"({len(head)} of {HEADER_BYTES} bytes)")
    blob = head.split(b"\x00", 1)[0]
    try:
        meta = json.loads(blob)
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(
            f"{path}: corrupt token-file header (not parseable JSON: {e})"
        ) from e
    if not isinstance(meta, dict) or meta.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a {MAGIC} file")
    try:
        dtype = np.dtype(meta["dtype"])
        shape = tuple(int(d) for d in meta["shape"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(
            f"{path}: corrupt token-file header (bad dtype/shape field: {e})"
        ) from e
    if not shape or any(d < 0 for d in shape):
        raise ValueError(f"{path}: corrupt token-file header (shape {shape})")
    return TokenFileMeta(dtype=dtype, shape=shape)


def decode_rows(meta: TokenFileMeta, buf, start_row: int, num_rows: int) -> np.ndarray:
    """Reinterpret raw session bytes as rows (zero-copy ``np.frombuffer``)."""
    arr = np.frombuffer(buf, dtype=meta.dtype, count=num_rows * (meta.row_bytes // meta.itemsize))
    if len(meta.shape) > 1:
        arr = arr.reshape((num_rows,) + meta.shape[1:])
    return arr
