"""Deterministic fault injection for the reader runtime.

The recovery layer (worker respawn, splinter re-issue, I/O retry, ring
CRC-retry) is only trustworthy if its failure paths are *reproducibly*
exercisable. This module provides:

* picklable injector hooks for every layer the runtime exposes a seam at —
  worker crash (``CrashReader`` / ``CrashSplinter``), syscall faults
  (``FlakyEIO`` / ``ShortRead`` plug into ``PosixFile.pread_into``), and
  torn ring publications (``TornSlot`` plugs into ``EventRing.publish``).
  All are plain dataclasses so ``spawn`` can ship them to reader worker
  processes through ``WorkerSpec``;
* :class:`FaultPlan` — a *seeded* schedule over those hooks: the same seed
  always derives the same injection points (which reader crashes after how
  many splinters, which syscalls fail, which slots publish torn), so a
  failing fault run is replayable from nothing but its seed
  (``CKIO_FAULT_SEED`` in CI's fault-matrix leg).

Hooks with per-process counters (``CrashReader``, ``FlakyEIO``, …) reset in
a respawned worker — deliberately: a *transient* fault clears on respawn.
``CrashSplinter`` is the persistent variant (keyed on the global splinter
index, it fires in every generation) for driving respawn-budget exhaustion.

On the thread backend ``FlakyEIO``, ``ShortRead`` (``io_fault``) and
``DelayEach`` / ``StallReader`` (``delay_model``) act; the worker and ring
hooks (``CrashReader``, ``CrashSplinter``, ``TornSlot``) act inside reader
worker processes (``FileOptions(backend="process")``), where the others act
too. A worker process is a fresh interpreter that unpickles its hooks by
import path, so this module loads no torch.
"""
from __future__ import annotations

import errno
import os
import random
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from repro_torch.io.layout import Splinter
from repro_torch.ipc.worker import ExitAfter, RaiseAfter, StallReader  # noqa: F401
#   re-exported: a FaultPlan user gets every injector from one module


# -- worker-level injectors ----------------------------------------------------
@dataclass
class CrashReader:
    """Hard-crash the worker right after it has read ``after`` splinters of
    reader ``reader`` (``os._exit`` — no cleanup, like a segfault). The
    counter is per-process, so a respawned worker with fewer than ``after``
    of that reader's splinters left completes — the "transient crash"
    injector a successful respawn needs."""

    reader: int
    after: int
    code: int = 66
    _seen: int = 0

    def __call__(self, reader: int, index: int) -> None:
        if reader != self.reader:
            return
        if self._seen >= self.after:
            os._exit(self.code)
        self._seen += 1


@dataclass
class CrashSplinter:
    """Hard-crash any worker generation that attempts the given *global*
    splinter index — a persistently poisonous splinter. Every respawn dies
    at the same point, which is how respawn-budget exhaustion is driven
    deterministically."""

    index: int
    code: int = 71

    def __call__(self, reader: int, index: int) -> None:
        if index == self.index:
            os._exit(self.code)


@dataclass
class DelayEach:
    """delay_model: stretch every splinter read by ``seconds`` (all
    readers). Benchmarks use it to give a drain a controlled duration so a
    mid-drain kill reliably lands mid-drain."""

    seconds: float

    def __call__(self, reader: int, sp: Splinter) -> float:
        return self.seconds


# -- io-level injectors (PosixFile.pread_into ``fault`` hook) ------------------
@dataclass
class FlakyEIO:
    """Raise a transient ``OSError`` on every ``every``-th syscall — the
    blip the posix retry/backoff layer must absorb. ``every=1`` makes the
    fault persistent (retry-exhaustion tests)."""

    every: int
    err: int = errno.EIO
    _n: int = 0

    def __call__(self, offset: int, nbytes: int) -> Optional[int]:
        self._n += 1
        if self.every and self._n % self.every == 0:
            raise OSError(self.err, "injected transient I/O error")
        return None


@dataclass
class ShortRead:
    """Cap every ``every``-th syscall at ``max_bytes`` — deterministic
    short reads, exercising the pread_into resume loop."""

    every: int
    max_bytes: int = 4096
    _n: int = 0

    def __call__(self, offset: int, nbytes: int) -> Optional[int]:
        self._n += 1
        if self.every and self._n % self.every == 0:
            return min(self.max_bytes, nbytes)
        return None


@dataclass
class ComposedIOFault:
    """Apply several io-fault hooks to one syscall: the first raiser wins;
    otherwise the smallest returned cap applies."""

    hooks: Tuple[object, ...]

    def __call__(self, offset: int, nbytes: int) -> Optional[int]:
        cap: Optional[int] = None
        for h in self.hooks:
            c = h(offset, nbytes)
            if c is not None:
                cap = c if cap is None else min(cap, c)
        return cap


# -- ring-level injector (EventRing.publish ``fault`` hook) --------------------
@dataclass
class TornSlot:
    """Publish every ``every``-th ring slot stamp-first with ``delay_s``
    before the payload lands — the simulated weakly-ordered host. The
    consumer's seq-keyed CRC must reject the slot until the payload is
    visible (re-read, never delivered torn, never deadlocked)."""

    every: int
    delay_s: float = 2e-3

    def __call__(self, seq: int) -> bool:
        return bool(self.every) and (seq + 1) % self.every == 0


# -- the seeded schedule -------------------------------------------------------
@dataclass
class FaultPlan:
    """A deterministic, seed-derived fault schedule.

    Toggle the fault classes on (``crash`` / ``stall`` / ``short_reads`` /
    ``flaky_io`` / ``torn_slots``); *where* each fires — which reader, after
    how many splinters, every how many syscalls/slots — is derived from
    ``seed`` alone (given the same ``num_readers``/``num_splinters`` layout
    hints), so two runs with one seed inject identically and a CI failure
    replays from the seed in its log.

    ``FileOptions(fault_plan=...)`` expands the plan into the per-layer
    hooks (worker_fault / delay_model / io_fault / ring_fault) unless a
    hook is also set explicitly (explicit wins).
    """

    seed: int
    crash: bool = True
    stall: bool = False
    short_reads: bool = False
    flaky_io: bool = False
    torn_slots: bool = False
    # layout hints the schedule derives injection points from
    num_readers: int = 2
    num_splinters: int = 16
    stall_seconds: float = 0.05
    # derived (filled by __post_init__ — do not pass)
    crash_reader: int = field(init=False, default=0)
    crash_after: int = field(init=False, default=1)
    crash_code: int = field(init=False, default=64)
    stall_reader: int = field(init=False, default=0)
    short_every: int = field(init=False, default=0)
    short_max_bytes: int = field(init=False, default=4096)
    eio_every: int = field(init=False, default=0)
    torn_every: int = field(init=False, default=0)

    def __post_init__(self) -> None:
        rng = random.Random(self.seed)
        per_reader = max(1, self.num_splinters // max(1, self.num_readers))
        self.crash_reader = rng.randrange(self.num_readers)
        # Crash strictly inside the reader's stripe (at least one splinter
        # read, at least one left) so recovery always has work to re-route.
        self.crash_after = 1 + rng.randrange(max(1, per_reader - 1))
        self.crash_code = 64 + rng.randrange(32)
        self.stall_reader = rng.randrange(self.num_readers)
        self.short_every = 2 + rng.randrange(3)
        self.short_max_bytes = 4096 * (1 + rng.randrange(4))
        self.eio_every = 3 + rng.randrange(4)
        self.torn_every = 2 + rng.randrange(3)

    # -- hook factories (None when that fault class is off) -------------------
    def worker_fault(self) -> Optional[object]:
        if not self.crash:
            return None
        return CrashReader(
            reader=self.crash_reader, after=self.crash_after,
            code=self.crash_code)

    def delay_model(self) -> Optional[object]:
        if not self.stall:
            return None
        return StallReader(self.stall_reader, self.stall_seconds)

    def io_fault(self) -> Optional[object]:
        hooks = []
        if self.short_reads:
            hooks.append(ShortRead(self.short_every, self.short_max_bytes))
        if self.flaky_io:
            hooks.append(FlakyEIO(self.eio_every))
        if not hooks:
            return None
        if len(hooks) == 1:
            return hooks[0]
        return ComposedIOFault(tuple(hooks))

    def ring_fault(self) -> Optional[object]:
        if not self.torn_slots:
            return None
        return TornSlot(self.torn_every)

    def describe(self) -> Dict[str, object]:
        """The concrete injection points — equal for equal seeds (the
        determinism contract tests and CI assert on)."""
        return {
            "seed": self.seed,
            "crash": (self.crash, self.crash_reader, self.crash_after,
                      self.crash_code),
            "stall": (self.stall, self.stall_reader, self.stall_seconds),
            "short_reads": (self.short_reads, self.short_every,
                            self.short_max_bytes),
            "flaky_io": (self.flaky_io, self.eio_every),
            "torn_slots": (self.torn_slots, self.torn_every),
        }
