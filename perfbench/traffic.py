"""The general generator of training traffic: a corpus of token windows.

A traffic file (``perfbench/traffic/<name>.json``) gives the step's shape
(``global_batch`` rows of ``seq_len + 1`` tokens, split into
``microbatches``), how many step windows the corpus holds, how it is laid
out on disk (one file, or ``shards`` files cut on the filesystem's block
grid) and how the CkIO pipeline reads it (``reader``). The tokens are
uniform over the configuration's vocabulary, drawn from the seed; every
seed gives the same sizes and layout.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

HEADER_BYTES = 4096          # the token file's header page


def window_tokens(traffic: Dict) -> int:
    return traffic["global_batch"] * (traffic["seq_len"] + 1)


def make_tokens(traffic: Dict, vocab: int, seed: int) -> np.ndarray:
    n = traffic["corpus_windows"] * window_tokens(traffic)
    rng = np.random.default_rng(seed % (1 << 63))
    return rng.integers(0, vocab, size=n, dtype=np.uint32)


def shard_counts(n: int, shards: int, block_bytes: int) -> List[int]:
    """Token counts of ``shards`` shards of ``n`` tokens, each interior
    start on the ``block_bytes`` grid, so that O_DIRECT reads stay
    aligned."""
    unit = max(1, block_bytes // 4)
    cuts = [(n * i // shards) // unit * unit for i in range(1, shards)]
    bounds = [0, *cuts, n]
    counts = [b - a for a, b in zip(bounds, bounds[1:])]
    if min(counts) <= 0:
        raise ValueError(f"{n} tokens do not make {shards} shards on a "
                         f"{block_bytes}-byte grid")
    return counts


def write(directory: str, tokens: np.ndarray, shards: int) -> List[str]:
    """Write ``tokens`` as one token file or as ``shards`` shard files
    under ``directory`` (replacing what is there); returns the paths."""
    from repro_torch.data import write_token_file, write_token_shards

    os.makedirs(directory, exist_ok=True)
    for old in os.listdir(directory):
        os.remove(os.path.join(directory, old))
    if shards == 1:
        path = os.path.join(directory, "corpus.bin")
        write_token_file(path, tokens)
        return [path]
    counts = shard_counts(len(tokens), shards,
                          os.statvfs(directory).f_bsize)
    return write_token_shards(directory, tokens, counts)


def read_back(paths: List[str]) -> np.ndarray:
    """The tokens of the files, read past each header page."""
    return np.concatenate([np.fromfile(p, dtype=np.uint32,
                                       offset=HEADER_BYTES) for p in paths])


def expected_batch(tokens: np.ndarray, traffic: Dict, window: int):
    """(inputs, labels) of step window ``window``: rows of ``seq_len + 1``
    tokens, the labels shifted by one."""
    B, S = traffic["global_batch"], traffic["seq_len"]
    w = window_tokens(traffic)
    rows = tokens[window * w:(window + 1) * w].astype(np.int64).reshape(B, S + 1)
    return rows[:, :-1], rows[:, 1:]
