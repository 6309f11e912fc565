"""The numbers that decide ``correct``, and their limits.

A training cell compares the program's first steps with the plain
reference's on the same weights and batches:

* ``input_tokens_wrong``: tokens of the window's batches that differ
  from the corpus rows the benchmark wrote (limit 0);
* ``loss_gap``: the largest relative gap of a step's loss, over the
  first steps;
* ``grad_norm_gap``: the first gradient as the optimizer gets it (after
  clipping), by leaf: the gap between the program's norm and the
  reference's, over the larger of that leaf's reference norm and the
  median leaf's; the worst leaf;
* ``param_change_gap``: the same for each leaf's change over the first
  steps, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (Adam moves them by round-off alone).
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

NAMES = ("input_tokens_wrong", "loss_gap", "grad_norm_gap",
         "param_change_gap")
QUIET = 1e-3        # a leaf's gradient under this share of the median's


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   skip=()) -> Tuple[float, str]:
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys)
    worst, at = 0.0, ""
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def quiet_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v < QUIET * med]


def readings(prog: Dict, ref: Dict, tokens_wrong: int) -> Dict[str, Dict]:
    """Each number with the leaf or step it was read at."""
    loss = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        raise ValueError("program and reference ran different step counts")
    quiet = quiet_leaves(ref["grad_norm"])
    g, g_at = worst_leaf_gap(prog["grad_norm"], ref["grad_norm"])
    c, c_at = worst_leaf_gap(prog["change"], ref["change"], skip=quiet)
    return {
        "input_tokens_wrong": {"value": tokens_wrong},
        "loss_gap": {"value": max(loss), "at": f"step {loss.index(max(loss)) + 1}"},
        "grad_norm_gap": {"value": g, "at": g_at},
        "param_change_gap": {"value": c, "at": c_at,
                             "quiet_leaves": len(quiet)},
    }


def judge(read: Dict[str, Dict], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """``(correct, checks)``: every number at or under its limit; a number
    that is not finite fails."""
    checks, ok = {}, True
    for name in NAMES:
        v = read[name]["value"]
        lim = limits[name]
        good = v == v and v <= lim        # NaN fails
        ok &= good
        checks[name] = {"value": v, "limit": lim}
    return ok, checks
