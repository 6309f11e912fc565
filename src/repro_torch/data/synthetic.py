"""Synthetic dataset generators for examples, tests, and benchmarks."""
from __future__ import annotations

import numpy as np

from repro_torch.data.tokenfile import TokenFileMeta, write_token_file


def make_token_file(
    path: str, num_tokens: int, vocab_size: int, seed: int = 0,
    dtype=np.uint32,
) -> TokenFileMeta:
    """Deterministic flat token stream (the LM training corpus)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab_size, size=(num_tokens,), dtype=np.uint32)
    return write_token_file(path, toks.astype(dtype))
