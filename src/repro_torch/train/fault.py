"""Fault tolerance: a supervised training loop with checkpoint/restart.

``StepSupervisor`` wraps the train step: it checkpoints every
``ckpt_every`` steps (async), and on a step failure (an injected fault, an
``OSError``, a ``RuntimeError`` such as a reader's ``WorkerCrashed``)
restores the latest checkpoint and replays from there, bounded by
``max_retries`` consecutive failures. Slow-step detection (EMA +
threshold) counts stragglers.

Two kinds of ``RuntimeError`` are not retried: a :class:`KernelError`
(a kernel of the port failed to build or launch) and a CUDA error raised
by torch (an illegal address, a failed launch, an out-of-memory). A
sticky CUDA error fails every replay, and a wrong kernel must not be
replayed as if a node had died, so both propagate at once, with no
restore. The reference catches every ``RuntimeError``.

A reader-layer ``WorkerCrashed`` escaping ``batches(step)`` is counted in
``stats.reader_failures``; the optional ``input_recover`` hook (step ->
None) lets the caller rebuild its input pipeline before the replay
re-reads the same deterministic window.

``to_tree`` maps the state to the tree that is saved, as host copies
that nothing else writes (the checkpointer writes them as they are; the
driver passes ``models.convert.train_state_to_reference``, which stacks
the layers on the host, not on the device). Restore reads the file into
host memory, in the file's own structure, and ``from_tree(tree, state)``
gives the state to go on from. It may write the live tensors in place
(the default, ``checkpoint.load_into``, does), so that the device never
holds two copies of the state; every value comes from the file, none
from the live tensors, which an aborted in-place step may have half
written.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.ipc.worker import WorkerCrashed
from repro_torch.kernels.reassemble import KernelError
from repro_torch.train.checkpoint import (
    AsyncCheckpointer,
    host_copy,
    load_into,
    restore_tree,
)


class FaultInjected(RuntimeError):
    """Raised by test hooks to simulate a node failure."""


@dataclass
class SupervisorStats:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    straggler_steps: int = 0
    # Step failures caused by the input layer (WorkerCrashed from
    # get_batch*) — a subset of ``failures``.
    reader_failures: int = 0
    step_times: List[float] = field(default_factory=list)
    restore_times: List[float] = field(default_factory=list)


def _device_error(e: BaseException) -> bool:
    """A failure of the device or of a kernel, which a replay cannot cure."""
    if isinstance(e, (KernelError, torch.cuda.OutOfMemoryError)):
        return True
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(e, accelerator_error):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


class StepSupervisor:
    def __init__(
        self,
        step_fn: Callable,               # (state, batch) -> (state, metrics)
        checkpointer: AsyncCheckpointer,
        *,
        ckpt_every: int = 50,
        max_retries: int = 3,
        straggler_factor: float = 3.0,
        input_recover: Optional[Callable[[int], None]] = None,
        to_tree: Callable[[Any], Any] = host_copy,
        from_tree: Callable[[Any, Any], Any] = load_into,
    ):
        self.step_fn = step_fn
        self.ckpt = checkpointer
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.input_recover = input_recover
        self.to_tree = to_tree
        self.from_tree = from_tree
        self.stats = SupervisorStats()
        self._ema: Optional[float] = None
        self._saved: Optional[int] = None   # the step the last save holds

    def _maybe_checkpoint(self, state: Any, step: int, force: bool = False) -> None:
        # A second save of the step just saved would write the same file.
        due = force or (step > 0 and step % self.ckpt_every == 0)
        if due and step != self._saved:
            self.ckpt.save(state, step, to_host=self.to_tree)
            self._saved = step

    def _restore(self, state: Any) -> tuple:
        # Drain pending saves (and their retention GC) BEFORE picking the
        # latest path: globbing first can return a checkpoint the async GC
        # deletes while we wait, turning the restore into FileNotFoundError.
        self.ckpt.wait()
        path = self.ckpt.latest()
        if path is None:
            raise RuntimeError("failure before any checkpoint exists")
        t0 = time.perf_counter()
        tree, step = restore_tree(path)
        state = self.from_tree(tree, state)
        self.stats.restore_times.append(time.perf_counter() - t0)
        self.stats.restores += 1
        self._saved = step
        return state, step

    def run(
        self,
        state: Any,
        batches: Callable[[int], Any],   # step -> batch (replayable!)
        num_steps: int,
        *,
        start_step: int = 0,
        fault_hook: Optional[Callable[[int], None]] = None,
        on_metrics: Optional[Callable[[int, Dict], None]] = None,
    ) -> Any:
        """Run steps ``start_step .. num_steps - 1`` with checkpoint/restart
        semantics. ``batches`` must be addressable by step (the CkIO
        pipeline is: step N maps to a deterministic file window), so that a
        replay after a restore sees the same batches."""
        # initial checkpoint so step-0 failures are recoverable
        self._saved = None
        self._maybe_checkpoint(state, start_step, force=True)
        self.ckpt.wait()
        step = start_step
        retries = 0
        while step < num_steps:
            failed = False
            try:
                if fault_hook is not None:
                    fault_hook(step)
                t0 = time.perf_counter()
                state, metrics = self.step_fn(state, batches(step))
                dt = time.perf_counter() - t0
                self.stats.step_times.append(dt)
                if self._ema is None:
                    self._ema = dt
                else:
                    if dt > self.straggler_factor * self._ema:
                        self.stats.straggler_steps += 1
                    self._ema = 0.9 * self._ema + 0.1 * dt
                self.stats.steps_run += 1
                retries = 0
                step += 1
                self._maybe_checkpoint(state, step)
                if on_metrics is not None:
                    on_metrics(step, metrics)
            except (FaultInjected, RuntimeError, OSError) as e:
                if _device_error(e):
                    raise
                self.stats.failures += 1
                retries += 1
                if isinstance(e, WorkerCrashed):
                    # The input layer died: let the caller rebuild the
                    # input path before the replay re-reads step data.
                    self.stats.reader_failures += 1
                    if self.input_recover is not None:
                        self.input_recover(step)
                if retries > self.max_retries:
                    raise RuntimeError(
                        f"step {step}: {retries - 1} consecutive retries exhausted"
                    ) from e
                failed = True
            # Restore after the except block, so that the traceback (and
            # the tensors its frames hold) is gone first.
            if failed:
                state, step = self._restore(state)
        self._maybe_checkpoint(state, step, force=True)
        self.ckpt.wait()
        return state
