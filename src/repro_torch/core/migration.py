"""Migratable clients: LocationManager + VirtualProxy.

Charm++ chares migrate between PEs under RTS control while holding open file
and session handles; CkIO keeps their reads working by addressing callbacks to
the *virtual* chare proxy rather than a physical PE (paper §IV-A.3). We
reproduce that: consumers register with a ``LocationManager`` under a virtual
id; a ``VirtualProxy`` resolves the id to the current PE at *delivery* time.
``migrate()`` just updates the table — in-flight reads complete at the new
location, which the migration test and benchmark (paper Fig. 10–12) verify.

The same mechanism backs *elastic scaling* in the training pipeline: when the
consumer count or host set changes, consumers are re-registered (migrated)
and the reader layer is untouched.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from repro_torch.core.scheduler import TaskScheduler


class LocationManager:
    """Virtual-id → current-PE table (thread-safe)."""

    def __init__(self, sched: TaskScheduler):
        self.sched = sched
        self._lock = threading.Lock()
        self._where: Dict[int, int] = {}
        self._next_vid = 0
        self.migrations = 0
        self.stale_deliveries = 0

    def register(self, pe: int, vid: Optional[int] = None) -> int:
        with self._lock:
            if vid is None:
                vid = self._next_vid
                self._next_vid += 1
            if not (0 <= pe < self.sched.num_pes):
                raise ValueError(f"PE {pe} out of range")
            self._where[vid] = pe
            self._next_vid = max(self._next_vid, vid + 1)
            return vid

    def migrate(self, vid: int, new_pe: int) -> None:
        with self._lock:
            if vid not in self._where:
                raise KeyError(f"unknown virtual id {vid}")
            if not (0 <= new_pe < self.sched.num_pes):
                raise ValueError(f"PE {new_pe} out of range")
            self._where[vid] = new_pe
            self.migrations += 1

    def deregister(self, vid: int) -> None:
        """Retire a virtual id (consumer destruction / elastic shrink).

        Later ``lookup``/``migrate`` on the id raise ``KeyError`` — a retired
        consumer must not silently resolve to a stale PE. Idempotent."""
        with self._lock:
            self._where.pop(vid, None)

    def count(self) -> int:
        """Currently registered virtual ids (leak detector for tests)."""
        with self._lock:
            return len(self._where)

    def count_stale(self) -> None:
        """Fold an externally-detected stale delivery into the counter (a
        streamed splinter event reaching a step that already finalized —
        same observability channel as the routing-level drops)."""
        with self._lock:
            self.stale_deliveries += 1

    def lookup(self, vid: int) -> int:
        with self._lock:
            return self._where[vid]

    def lookup_or_home(self, vid: int) -> int:
        """PE for delivery: current location, or the home PE (0) when the id
        has been deregistered — completions racing an elastic shrink must
        still land somewhere (Charm++: messages to a destroyed chare are
        delivered via its home location manager). Counted for observability."""
        with self._lock:
            pe = self._where.get(vid)
            if pe is None:
                self.stale_deliveries += 1
                return 0
            return pe

    def lookup_or_drop(self, vid: int) -> Optional[int]:
        """PE for delivery, or ``None`` when the id has been deregistered.

        The drop-capable variant of ``lookup_or_home`` for *streamed splinter
        deliveries*: a request completion racing an elastic shrink must land
        somewhere (home PE — the data was asked for), but a splinter event
        addressed to a retired consumer must be **dropped**, never rerouted —
        rerouting could deliver it to a consumer slot reused by a later
        ``resize()`` grow, staging the same bytes twice. Drops are counted in
        ``stale_deliveries`` alongside the home-PE fallbacks."""
        with self._lock:
            pe = self._where.get(vid)
            if pe is None:
                self.stale_deliveries += 1
                return None
            return pe

    def proxy(self, vid: int) -> "VirtualProxy":
        return VirtualProxy(self, vid)


class VirtualProxy:
    """Late-binding handle to a migratable consumer."""

    __slots__ = ("loc", "vid")

    def __init__(self, loc: LocationManager, vid: int):
        self.loc = loc
        self.vid = vid

    def current_pe(self) -> int:
        return self.loc.lookup(self.vid)

    def delivery_pe(self) -> int:
        """Current PE, falling back to the home PE for deregistered ids."""
        return self.loc.lookup_or_home(self.vid)

    def delivery_pe_or_drop(self) -> Optional[int]:
        """Current PE, or ``None`` (drop, counted) for deregistered ids."""
        return self.loc.lookup_or_drop(self.vid)

    def current_node(self) -> int:
        return self.loc.sched.node_of(self.current_pe())


class Client:
    """Base class for migratable data consumers (the paper's client chares).

    Holds a virtual id; exposes ``callback(fn)`` which builds a CkCallback
    routed through the proxy, so continuations chase the client across
    migrations.
    """

    def __init__(self, loc: LocationManager, pe: int):
        self.loc = loc
        self.vid = loc.register(pe)

    @property
    def pe(self) -> int:
        return self.loc.lookup(self.vid)

    @property
    def node(self) -> int:
        return self.loc.sched.node_of(self.pe)

    def migrate(self, new_pe: int) -> None:
        self.loc.migrate(self.vid, new_pe)

    def deregister(self) -> None:
        """Drop this client from the location table (idempotent)."""
        self.loc.deregister(self.vid)

    def callback(self, fn: Callable, drop_stale: bool = False) -> "CkCallback":
        """Continuation routed through the virtual proxy.

        ``drop_stale=True`` selects drop-and-count delivery for retired ids
        (streamed splinter events) instead of the home-PE fallback (request
        completions) — see ``LocationManager.lookup_or_drop``."""
        from repro_torch.core.futures import CkCallback

        return CkCallback(fn, proxy=self.loc.proxy(self.vid),
                          drop_stale=drop_stale)
