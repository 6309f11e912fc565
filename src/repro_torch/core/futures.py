"""Split-phase primitives: CkCallback and CkFuture.

The paper's API is callback-centric (§III-D): every CkIO operation takes a
``CkCallback`` which the runtime *enqueues as a task* on a target PE when the
operation completes. ``CkCallback`` here supports three target kinds:

  * a fixed PE (paper: callback to a processor),
  * a *virtual proxy* (paper: callback to a migratable chare — resolved to the
    chare's **current** PE at delivery time, which is what makes reads survive
    migration, §IV-A.3),
  * inline (tests only).

``CkFuture`` is a thin completion handle built on CkCallback for pythonic
call-sites (examples, data pipeline); `.wait(sched)` pumps the scheduler, it
never blocks a PE.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional, TYPE_CHECKING

from repro_torch.core.scheduler import TaskScheduler

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.migration import LocationManager, VirtualProxy


class CkCallback:
    """A continuation delivered as a scheduled task."""

    def __init__(
        self,
        fn: Callable[..., Any],
        *,
        pe: Optional[int] = None,
        proxy: Optional["VirtualProxy"] = None,
        inline: bool = False,
        drop_stale: bool = False,
    ):
        if sum(x is not None for x in (pe, proxy)) + int(inline) != 1:
            raise ValueError("exactly one of pe=, proxy=, inline=True required")
        if drop_stale and proxy is None:
            raise ValueError("drop_stale requires proxy routing")
        self.fn = fn
        self.pe = pe
        self.proxy = proxy
        self.inline = inline
        # Proxy-routed only: a deregistered target drops the delivery
        # (counted) instead of falling back to the home PE — the contract
        # for streamed splinter events, which must never chase a retired
        # consumer onto a reused slot.
        self.drop_stale = drop_stale

    def send(self, sched: TaskScheduler, *args: Any) -> None:
        """Deliver the callback (enqueue, never call inline unless asked)."""
        if self.inline:
            self.fn(*args)
            return
        if self.proxy is not None:
            # Late-bound: route to wherever the chare lives *now* (home-PE
            # fallback — or a counted drop for drop_stale callbacks — if it
            # was deregistered by an elastic shrink mid-read).
            if self.drop_stale:
                pe = self.proxy.delivery_pe_or_drop()
                if pe is None:
                    return
            else:
                pe = self.proxy.delivery_pe()
            sched.enqueue(pe, self.fn, *args, label="cb@proxy")
        else:
            sched.enqueue(self.pe, self.fn, *args, label="cb@pe")


class CkFuture:
    """Completion handle; thread-safe set(), scheduler-pumping wait()."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self) -> None:
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    def set(self, value: Any = None) -> None:
        self._value = value
        self._event.set()

    def set_error(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def value(self) -> Any:
        if not self._event.is_set():
            raise RuntimeError("future not ready")
        if self._error is not None:
            raise self._error
        return self._value

    def wait(self, sched: TaskScheduler, *, timeout: float = 60.0) -> Any:
        """Pump the scheduler until this future resolves."""
        sched.run_until(lambda: self._event.is_set(), timeout=timeout)
        return self.value()

    def as_callback(self) -> CkCallback:
        return CkCallback(lambda v=None: self.set(v), inline=True)
