"""Host NUMA helpers: domain detection, thread pinning, first-touch faulting.

Pure OS-level utilities (no dependency on the core runtime) used by the
topology-aware reader layer:

* ``detect_numa_domains`` parses ``/sys/devices/system/node/node*/cpulist``
  into per-domain CPU sets, falling back to one domain spanning every CPU
  when the sysfs tree is absent (non-Linux, containers with masked /sys).
* ``pin_thread_to_cpus`` pins the *calling thread* (``sched_setaffinity``
  with pid 0 targets the caller on Linux) to a domain's CPUs — best-effort,
  returns False where unsupported so callers degrade instead of failing.
* ``first_touch`` faults every page of a buffer from the calling thread by
  writing one byte per page. Under Linux's first-touch policy the faulting
  thread's NUMA node gets the page, so a reader thread pinned to its domain
  and first-touching its own arena stripe places that stripe's memory
  locally — **without** the full zero-fill pass that would defeat the
  non-zero-filled ``np.empty`` session arena (every byte is overwritten by
  ``preadv`` anyway; only 1/page_size of the bytes are written here, and on
  the reader's own thread rather than the session-start critical path).
"""
from __future__ import annotations

import glob
import os
import re
from typing import List, Sequence, Set, Tuple

import numpy as np

_SYS_NODE_GLOB = "/sys/devices/system/node/node[0-9]*"

try:
    PAGE_BYTES = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, ValueError, OSError):  # pragma: no cover - non-posix
    PAGE_BYTES = 4096


def parse_cpulist(text: str) -> Set[int]:
    """Parse a kernel cpulist (``"0-3,8,10-11"``) into a set of CPU ids."""
    cpus: Set[int] = set()
    for part in text.strip().split(","):
        part = part.strip()
        if not part:
            continue
        m = re.fullmatch(r"(\d+)(?:-(\d+))?", part)
        if not m:
            raise ValueError(f"bad cpulist component: {part!r}")
        lo = int(m.group(1))
        hi = int(m.group(2)) if m.group(2) else lo
        if hi < lo:
            raise ValueError(f"bad cpulist range: {part!r}")
        cpus.update(range(lo, hi + 1))
    return cpus


def detect_numa_domains() -> List[Tuple[int, ...]]:
    """CPU sets of the host's NUMA nodes, in node-id order.

    Always returns at least one domain: hosts without a sysfs NUMA tree
    (or non-Linux platforms) report a single domain spanning every CPU.
    """
    domains: List[Tuple[int, ...]] = []
    for node_dir in sorted(
        glob.glob(_SYS_NODE_GLOB),
        key=lambda p: int(re.search(r"node(\d+)$", p).group(1)),
    ):
        try:
            with open(os.path.join(node_dir, "cpulist")) as f:
                cpus = parse_cpulist(f.read())
        except (OSError, ValueError):
            continue
        if cpus:
            domains.append(tuple(sorted(cpus)))
    if not domains:
        domains.append(tuple(range(os.cpu_count() or 1)))
    return domains


def current_cpus() -> Set[int]:
    """Calling thread's CPU affinity (all CPUs where unsupported)."""
    try:
        return set(os.sched_getaffinity(0))
    except (AttributeError, OSError):  # pragma: no cover - non-linux
        return set(range(os.cpu_count() or 1))


def pin_thread_to_cpus(cpus: Sequence[int]) -> bool:
    """Pin the calling thread to ``cpus``. Best-effort: False on platforms
    without ``sched_setaffinity`` or when the mask is rejected (e.g. cgroup
    cpuset excludes them) — callers must treat pinning as advisory."""
    if not cpus:
        return False
    try:
        os.sched_setaffinity(0, set(cpus))
        return True
    except (AttributeError, OSError, ValueError):
        return False


def first_touch(buf, page_bytes: int = 0) -> int:
    """Fault every page of ``buf`` from the calling thread; returns pages.

    Writes a single byte per page (stride ``page_bytes``): enough to fault
    the page in — and, with the caller pinned to its NUMA domain, to place
    it there under first-touch — without a full memset of the buffer. The
    written bytes are scratch (the arena is filled by ``preadv`` afterwards).
    """
    page = page_bytes or PAGE_BYTES
    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(
        buf, np.ndarray) else buf.view(np.uint8)
    if arr.size == 0:
        return 0
    touch = arr[::page]
    touch[:] = 0
    return int(touch.size)
