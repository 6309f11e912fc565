"""Reader placement policies + NUMA topology model (paper §III-C.4, §VI-B).

Maps each buffer reader of a session to a PE. Policies:

* ``round_robin`` — readers cycle over PEs in index order.
* ``node_spread`` — spread readers across *nodes* first, then PEs within a
  node; maximizes independent I/O paths when each node has its own storage
  connection (the common Lustre-router topology the paper runs on).
  Readers beyond ``num_pes`` wrap around the spread order — every PE is
  used exactly once before any PE is reused (no duplicate placement on
  uneven topologies).
* ``domain_spread`` — like ``node_spread`` but over NUMA *domains*: one
  reader per memory domain before doubling up, so each domain's memory
  controller serves one arena stripe (requires a ``Topology``; defaults to
  one domain per node).
* ``near_consumers`` — co-locate readers with a provided consumer PE list,
  minimizing phase-2 cross-node traffic (the locality play of paper
  Fig. 10–12, from the reader side instead of migrating the client). With a
  ``Topology``, readers spread over all PEs of the *consumers' NUMA
  domains* instead of stacking on the exact consumer PEs — same-domain
  delivery stays zero-copy-local while the readers keep independent PEs.

``Topology`` is the memory-locality model the scheduler lacks: the
scheduler knows nodes (address spaces); ``Topology`` subdivides each node
into NUMA domains and optionally carries the host CPU set backing each
domain (from ``io/numa.py`` detection) so reader I/O threads can be pinned
where their arena stripe's memory lives.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.scheduler import TaskScheduler


@dataclass(frozen=True)
class Topology:
    """PE → NUMA-domain map layered on the scheduler's node grid.

    ``domains_per_node`` subdivides each node's PEs into equal contiguous
    domains (the way cores split across sockets/CCDs). ``domain_cpus``
    optionally maps each *global* domain id to the host CPUs backing it —
    required only for ``numa_pin`` (reader-thread affinity); the logical
    model works without it.
    """

    num_pes: int
    pes_per_node: int = 1
    domains_per_node: int = 1
    domain_cpus: Optional[Tuple[Tuple[int, ...], ...]] = None

    def __post_init__(self) -> None:
        if self.num_pes < 1:
            raise ValueError("num_pes must be >= 1")
        if self.pes_per_node < 1:
            raise ValueError("pes_per_node must be >= 1")
        if not 1 <= self.domains_per_node <= self.pes_per_node:
            raise ValueError(
                f"domains_per_node must be in [1, {self.pes_per_node}] "
                f"(pes_per_node), got {self.domains_per_node}")
        if (self.domain_cpus is not None
                and len(self.domain_cpus) != self.num_domains):
            # A short map would silently pin high domains' reader threads
            # to the wrong domain's CPUs (defeating first-touch placement
            # while reporting pin success).
            raise ValueError(
                f"domain_cpus has {len(self.domain_cpus)} entries for "
                f"{self.num_domains} domains")

    # -- shape ---------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return (self.num_pes + self.pes_per_node - 1) // self.pes_per_node

    @property
    def num_domains(self) -> int:
        return self.num_nodes * self.domains_per_node

    @property
    def pes_per_domain(self) -> int:
        return (self.pes_per_node + self.domains_per_node - 1) \
            // self.domains_per_node

    def node_of(self, pe: int) -> int:
        return pe // self.pes_per_node

    def domain_of(self, pe: int) -> int:
        """Global NUMA-domain id of ``pe``."""
        if not 0 <= pe < self.num_pes:
            raise ValueError(f"PE {pe} out of range [0,{self.num_pes})")
        within = pe % self.pes_per_node
        local = min(within // self.pes_per_domain, self.domains_per_node - 1)
        return self.node_of(pe) * self.domains_per_node + local

    def pes_in_domain(self, domain: int) -> List[int]:
        return [pe for pe in range(self.num_pes)
                if self.domain_of(pe) == domain]

    def cpus_of_domain(self, domain: int) -> Optional[Tuple[int, ...]]:
        """Host CPUs backing ``domain`` (None when no CPU map was given)."""
        if self.domain_cpus is None:
            return None
        if not 0 <= domain < self.num_domains:
            raise ValueError(
                f"domain {domain} out of range [0,{self.num_domains})")
        return self.domain_cpus[domain]

    # -- constructors --------------------------------------------------------
    @classmethod
    def from_sched(
        cls, sched: TaskScheduler, domains_per_node: int = 1,
        domain_cpus: Optional[Sequence[Sequence[int]]] = None,
    ) -> "Topology":
        return cls(
            num_pes=sched.num_pes,
            pes_per_node=sched.pes_per_node,
            domains_per_node=min(max(1, domains_per_node),
                                 sched.pes_per_node),
            domain_cpus=(tuple(tuple(c) for c in domain_cpus)
                         if domain_cpus else None),
        )

    @classmethod
    def with_host_cpus(
        cls, num_pes: int, pes_per_node: int = 1, domains_per_node: int = 1
    ) -> "Topology":
        """Topology of the given logical shape with the host's NUMA CPU
        sets (sysfs) cycled over the global domains — the CPU map
        ``numa_pin`` needs, whatever the logical domain count."""
        from repro_torch.io.numa import detect_numa_domains

        host = detect_numa_domains()
        shape = cls(num_pes=num_pes, pes_per_node=pes_per_node,
                    domains_per_node=domains_per_node)
        cpus = tuple(host[d % len(host)] for d in range(shape.num_domains))
        return cls(num_pes=num_pes, pes_per_node=pes_per_node,
                   domains_per_node=domains_per_node, domain_cpus=cpus)

    @classmethod
    def detect(cls, num_pes: int, pes_per_node: int = 1) -> "Topology":
        """Topology with domains taken from the host's NUMA nodes (sysfs).

        The detected domains are spread over the logical nodes (clamped to
        ``pes_per_node`` — a 1-PE-per-node grid cannot subdivide further)
        and each global domain carries its host CPU set for ``numa_pin``.
        """
        from repro_torch.io.numa import detect_numa_domains

        host = detect_numa_domains()
        num_nodes = (num_pes + pes_per_node - 1) // pes_per_node
        per_node = min(max(1, len(host) // max(1, num_nodes)), pes_per_node)
        return cls.with_host_cpus(num_pes, pes_per_node, per_node)

    @classmethod
    def from_spec(
        cls, spec: str, num_pes: int, pes_per_node: int = 1
    ) -> "Topology":
        """Parse a CLI topology spec: ``"auto"`` (detect from the host) or
        an integer number of domains per node (clamped to ``pes_per_node``).
        """
        if spec == "auto":
            return cls.detect(num_pes, pes_per_node)
        try:
            per_node = int(spec)
        except ValueError:
            raise ValueError(
                f"bad --topology spec {spec!r}: expected 'auto' or an "
                f"integer domains-per-node") from None
        return cls(num_pes=num_pes, pes_per_node=pes_per_node,
                   domains_per_node=min(max(1, per_node), pes_per_node))


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
    topology: Optional[Topology] = None,
) -> List[int]:
    if num_readers < 1:
        raise ValueError("num_readers must be >= 1")
    if topology is not None and topology.num_pes != sched.num_pes:
        # A topology over a different PE grid would emit reader PEs that
        # index nonexistent scheduler queues (or mis-map domains). The
        # domain subdivision may differ from the scheduler's node grid;
        # the PE count may not. Every session start passes through here,
        # so a mismatched FileOptions.topology fails fast.
        raise ValueError(
            f"topology covers {topology.num_pes} PEs but the scheduler "
            f"has {sched.num_pes}")
    if policy == "round_robin":
        return [r % sched.num_pes for r in range(num_readers)]
    if policy == "node_spread":
        groups = _bucket_pes(sched.num_pes, sched.node_of, sched.num_nodes)
        perm = _interleave(groups)
        return [perm[r % len(perm)] for r in range(num_readers)]
    if policy == "domain_spread":
        topo = topology or Topology.from_sched(sched)
        groups = _bucket_pes(topo.num_pes, topo.domain_of, topo.num_domains)
        perm = _interleave([g for g in groups if g])
        return [perm[r % len(perm)] for r in range(num_readers)]
    if policy == "near_consumers":
        if not consumer_pes:
            return place_readers(
                "node_spread", num_readers, sched, topology=topology)
        bad = [p for p in consumer_pes if not 0 <= p < sched.num_pes]
        if bad:
            raise ValueError(
                f"near_consumers: consumer PE(s) {bad} out of range "
                f"[0,{sched.num_pes}) — a reader placed there would index "
                f"a nonexistent scheduler queue")
        if topology is None:
            return [consumer_pes[r % len(consumer_pes)]
                    for r in range(num_readers)]
        # Topology-aware: readers spread over every PE of the consumers'
        # NUMA domains (deliveries stay same-domain without stacking all
        # readers on the handful of consumer PEs).
        doms: List[int] = []
        for p in consumer_pes:
            d = topology.domain_of(p)
            if d not in doms:
                doms.append(d)
        by_domain = _bucket_pes(
            topology.num_pes, topology.domain_of, topology.num_domains)
        perm = _interleave([by_domain[d] for d in doms])
        return [perm[r % len(perm)] for r in range(num_readers)]
    raise ValueError(f"unknown placement policy: {policy!r}")
