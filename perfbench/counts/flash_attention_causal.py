"""The bound of one call of causal attention's training forward
(``ops.flash_attention_train`` on the card: the tensor-core forward with
its log-sum-exp) and of its backward, at a microbatch of B rows of S
tokens, H query heads of hd dims: operations, over the bf16 tensor-core
peak. P is the (query, key) pairs a head keeps: S(S+1)/2 under the causal
mask, fewer under a sliding window. Forward 4 B H hd P FLOPs (S = QK^T and
PV); backward 10 B H hd P (S recomputed, dP = dO V^T, dV, dK and dQ)."""

FLOPS_PER_PAIR = {"fwd": 4, "bwd": 10}


def kept_pairs(S: int, window: int = 0) -> int:
    """(query, key) pairs of S positions that the causal mask keeps, and
    with ``window`` > 0 only those with ``q - k < window``: row i keeps
    min(i + 1, window) keys."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def bound(direction: str, B: int, S: int, H: int, hd: int, window: int,
          hw) -> dict:
    pairs = kept_pairs(S, window)
    flops = FLOPS_PER_PAIR[direction] * B * H * hd * pairs
    return {"pairs": pairs, "flops": flops,
            "bound_ms": flops / hw["bf16_flops_per_s"] * 1e3,
            "bound_by": "operations"}


def microbatch_bound(direction: str, m, t, hw) -> float:
    return bound(direction, t["global_batch"] // t["microbatches"],
                 t["seq_len"], m["num_heads"], m["head_dim"],
                 m.get("window", 0), hw)["bound_ms"]
