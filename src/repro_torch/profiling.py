"""Host ranges on a ``torch.profiler`` trace, opened only while one records.

The port's own ranges (``ckio.fetch``, ``ckio.fetch.pump`` and
``ckio.fetch.stage`` in ``data/pipeline.py``; ``train.microbatch`` and
``train.update`` in ``train/train_step.py``) are function-scope records
(``_RecordFunctionFast``), not ``record_function`` user annotations. They
sit on the trace's host timeline, on the same clock as the kernels and
copies the code inside them launches, but the profiler projects none of
them onto the device's timeline: a kernel launched inside one still counts
for the innermost user annotation around it, so a reading of the device's
intervals, or of a caller's own annotated ranges there, is the same with
these ranges as without. With no profiler recording, a range costs the
flag read of :func:`recording`.
"""
from __future__ import annotations

import torch

recording = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast


def open_range(name: str):
    """Open a host range named ``name`` (call only while :func:`recording`);
    close it with :func:`close_range`, innermost first."""
    r = _Range(name)
    r.__enter__()
    return r


def close_range(r) -> None:
    r.__exit__(None, None, None)


class host_range:
    """``with host_range(name):`` a host range while a profiler records,
    nothing otherwise."""

    __slots__ = ("_name", "_r")

    def __init__(self, name: str):
        self._name = name
        self._r = None

    def __enter__(self) -> "host_range":
        if recording():
            self._r = open_range(self._name)
        return self

    def __exit__(self, *exc) -> None:
        if self._r is not None:
            close_range(self._r)
            self._r = None
