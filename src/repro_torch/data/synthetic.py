"""Synthetic dataset generators for examples, tests, and benchmarks."""
from __future__ import annotations

import os

import numpy as np

from repro_torch.data.tokenfile import TokenFileMeta, write_token_file


def make_opaque_file(path: str, nbytes: int, seed: int = 0) -> None:
    """Raw bytes for the I/O microbenchmarks (paper Figs. 1/2/4/7), written
    16 MiB at a time."""
    rng = np.random.default_rng(seed)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    chunk = 16 * 1024 * 1024
    with open(path, "wb") as f:
        left = nbytes
        while left > 0:
            n = min(chunk, left)
            f.write(rng.integers(0, 256, size=n, dtype=np.uint8).tobytes())
            left -= n


def make_token_file(
    path: str, num_tokens: int, vocab_size: int, seed: int = 0,
    dtype=np.uint32,
) -> TokenFileMeta:
    """Deterministic flat token stream (the LM training corpus)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab_size, size=(num_tokens,), dtype=np.uint32)
    return write_token_file(path, toks.astype(dtype))


def make_embedding_file(
    path: str, num_rows: int, d_model: int, seed: int = 0, dtype=np.float32
) -> TokenFileMeta:
    """Precomputed frame/patch embeddings (the VLM/audio frontend stubs)."""
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((num_rows, d_model)).astype(dtype) * 0.02
    return write_token_file(path, emb)
