"""The reader worker's error type and its picklable fault hooks.

The process backend (reader worker processes over a shared-memory arena)
comes with the process backend and service slice (ROADMAP.md, Queue A).
This module carries only what the train supervisor and the fault plan use
before it: :class:`WorkerCrashed`, which the supervisor counts as a
reader failure, and the hooks :class:`StallReader`, :class:`ExitAfter`
and :class:`RaiseAfter`, which ``core/faults.py`` re-exports.
``StallReader`` also acts as a thread-backend ``delay_model``; the other
two act only inside a worker process.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

from repro_torch.io.layout import Splinter


class WorkerCrashed(RuntimeError):
    """A reader worker process died (or errored) before finishing its
    stripe; the owning session is failed fast with this error."""


@dataclass
class StallReader:
    """``delay_model``: delay every splinter of ``reader`` by ``seconds``
    (the straggler injector, picklable for spawn)."""

    reader: int
    seconds: float

    def __call__(self, reader: int, sp: Splinter) -> float:
        return self.seconds if reader == self.reader else 0.0


@dataclass
class ExitAfter:
    """Hard-crash fault hook: ``os._exit(code)`` before reading the
    (``after``+1)-th splinter — no ERROR state, no cleanup, exactly what a
    segfault/OOM-kill looks like to the supervisor."""

    after: int
    code: int = 42

    def __call__(self, reader: int, index: int) -> None:
        self.after -= 1
        if self.after < 0:
            os._exit(self.code)


@dataclass
class RaiseAfter:
    """Soft-failure fault hook: raise before reading the (``after``+1)-th
    splinter — exercises the worker's ERROR-state reporting path."""

    after: int
    message: str = "injected worker fault"

    def __call__(self, reader: int, index: int) -> None:
        self.after -= 1
        if self.after < 0:
            raise RuntimeError(self.message)
