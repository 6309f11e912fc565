"""Readings of a ``torch.profiler`` trace of the profiled steps.

``extract`` reduces the profiler's events to plain tuples: the device's
operations (kernels, copies, sets) as ``(start_us, end_us, name)``, the
benchmark's own host spans (``perfbench.*`` ranges) the same way, and for
each range that the per-layer metrics asked for, each call's span on the
device: the profiler projects a ``record_function`` range onto the
device's timeline (a user annotation from the first to the last kernel
launched inside it), which also covers kernels that a library launches
through its own CUDA runtime, where the host-side op tree links none.
Kernels are not matched by name. ``reduce`` works on those tuples alone,
so it is tested without a card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

PREFIX = "perfbench."
STEP = PREFIX + "step"

Span = Tuple[float, float, str]


def extract(prof, range_labels) -> Dict:
    from torch.autograd import DeviceType

    device: List[Span] = []
    host: List[Span] = []
    calls: Dict[str, List[Tuple[float, float]]] = {k: [] for k in range_labels}
    for e in prof.events():
        tr = e.time_range
        on_device = e.device_type == DeviceType.CUDA
        if not e.name.startswith(PREFIX):
            if on_device:
                device.append((tr.start, tr.end, e.name))
        elif not on_device:
            host.append((tr.start, tr.end, e.name))
        elif e.name in calls:
            calls[e.name].append((tr.start, tr.end - tr.start))
    return {"device": device, "host": host, "calls": calls}


def merge(spans: List[Span], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of ``spans`` clipped to [lo, hi], as sorted intervals."""
    out: List[List[float]] = []
    for s, e, _ in sorted(spans):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _host_at(host: List[Span], s: float, e: float) -> str:
    """The benchmark span that covers most of [s, e], innermost first."""
    best, best_cover = "outside the benchmark's spans", 0.0
    for hs, he, name in sorted(host, key=lambda h: h[1] - h[0]):
        if name == STEP:
            continue
        cover = min(e, he) - max(s, hs)
        if cover > best_cover * 1.0001:
            best, best_cover = name[len(PREFIX):], cover
    return best


def reduce(ex: Dict, skip_steps: int = 1, top: int = 10) -> Optional[Dict]:
    """Busy time, window and breakdown over the profiled steps after the
    first ``skip_steps`` (the profiler's start-up); None when no device
    operation ran in that window."""
    steps = sorted((s, e) for s, e, n in ex["host"] if n == STEP)
    steps = steps[skip_steps:]
    if not steps:
        return None
    lo, hi = steps[0][0], steps[-1][1]
    busy = merge(ex["device"], lo, hi)
    busy_us = sum(e - s for s, e in busy)
    if busy_us <= 0:
        return None
    gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])]
    if busy[0][0] > lo:
        gaps.append((busy[0][0] - lo, lo, busy[0][0]))
    if busy[-1][1] < hi:
        gaps.append((hi - busy[-1][1], busy[-1][1], hi))
    gaps.sort(reverse=True)
    by_op: Dict[str, float] = {}
    for s, e, name in ex["device"]:
        s, e = max(s, lo), min(e, hi)
        if e > s:
            by_op[name] = by_op.get(name, 0.0) + (e - s)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    calls = {}
    for label, got in ex["calls"].items():
        inside = [t for start, t in got if lo <= start <= hi]
        calls[label] = [t / 1e3 for t in inside]        # ms a call
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (hi - lo) / 1e6,
        "steps": len(steps),
        "range_ms": calls,
        "breakdown": {
            "device_ops": [[n, t / 1e6] for n, t in ops],
            "idle_gaps": [[_host_at(ex["host"], s, e), g / 1e6]
                          for g, s, e in gaps[:top]],
        },
    }
