"""Reader placement policies (paper §III-C.4).

Maps each buffer reader of a session to a PE. Policies:

* ``round_robin`` — readers cycle over PEs in index order.
* ``node_spread`` — spread readers across *nodes* first, then PEs within a
  node; maximizes independent I/O paths when each node has its own storage
  connection (the common Lustre-router topology the paper runs on).
  Readers beyond ``num_pes`` wrap around the spread order — every PE is
  used exactly once before any PE is reused (no duplicate placement on
  uneven topologies).

The NUMA-aware policies (``domain_spread``, ``near_consumers``) and the
``Topology`` model come with the port's NUMA slice.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.scheduler import TaskScheduler


def _bucket_pes(num_pes: int, key, num_groups: int) -> List[List[int]]:
    """Group PEs by ``key(pe)`` in one O(num_pes) pass (session starts run
    this per step — no per-group rescans)."""
    groups: List[List[int]] = [[] for _ in range(num_groups)]
    for pe in range(num_pes):
        groups[key(pe)].append(pe)
    return groups


def _interleave(groups: Sequence[Sequence[int]]) -> List[int]:
    """Merge PE groups round-robin: one PE from each group per pass.

    The result is a permutation of every PE in ``groups`` — the spread
    order policies index with ``r % len(perm)``, which is what guarantees
    no PE repeats before all PEs have been used (the old ``node_spread``
    clamped overflow onto the last PE instead, silently stacking readers).
    """
    out: List[int] = []
    idx = [0] * len(groups)
    total = sum(len(g) for g in groups)
    while len(out) < total:
        for g, group in enumerate(groups):
            if idx[g] < len(group):
                out.append(group[idx[g]])
                idx[g] += 1
    return out


def place_readers(
    policy: str,
    num_readers: int,
    sched: TaskScheduler,
    consumer_pes: Optional[Sequence[int]] = None,
) -> List[int]:
    """``consumer_pes`` is accepted for the policies that use it (the NUMA
    slice's ``near_consumers``); the two policies here ignore it."""
    if num_readers < 1:
        raise ValueError("num_readers must be >= 1")
    if policy == "round_robin":
        return [r % sched.num_pes for r in range(num_readers)]
    if policy == "node_spread":
        groups = _bucket_pes(sched.num_pes, sched.node_of, sched.num_nodes)
        perm = _interleave(groups)
        return [perm[r % len(perm)] for r in range(num_readers)]
    if policy in ("domain_spread", "near_consumers"):
        raise NotImplementedError(
            f"placement {policy!r} is not carried by this port yet: it "
            f"comes with the NUMA slice (ROADMAP.md, Queue A)")
    raise ValueError(f"unknown placement policy: {policy!r}")
