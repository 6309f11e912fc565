"""Multi-process reader substrate: the shared-memory session arena
(``shm.py``), the cross-process splinter-event ring (``ring.py``) and the
reader worker process (``worker.py``). The reader service comes with that
slice."""
from repro_torch.ipc.ring import EventRing, RingEvent, ring_bytes
from repro_torch.ipc.shm import SharedArena, shm_dir
from repro_torch.ipc.worker import (
    ExitAfter,
    RaiseAfter,
    StallReader,
    WorkerCrashed,
    WorkerProcess,
    WorkerSpec,
    worker_main,
)

__all__ = [
    "EventRing",
    "RingEvent",
    "ring_bytes",
    "SharedArena",
    "shm_dir",
    "ExitAfter",
    "RaiseAfter",
    "StallReader",
    "WorkerCrashed",
    "WorkerProcess",
    "WorkerSpec",
    "worker_main",
]
