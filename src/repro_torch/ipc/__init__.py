"""Multi-process reader substrate, bottom up:

* ``shm`` — :class:`SharedArena`: a named shared-memory segment mapped into
  reader worker processes and the consumer process (the session arena and
  the ring blocks), with the reader service's generation stamp
  (:class:`StaleArenaView`);
* ``ring`` — :class:`EventRing`: the fixed-slot SPSC splinter-event ring per
  worker with its attach/go/stop/error header and the pooled re-arm words;
  :class:`CommandRing`: the single-slot mailbox a parked pooled worker
  receives its next session's spec through;
* ``worker`` — :func:`worker_main` (a per-session worker, a fresh
  interpreter started by :class:`WorkerProcess`) and
  :func:`service_worker_main` (the pooled variant: park on the mailbox,
  run a session, park again);
* ``service`` — :class:`ReaderService`: pooled workers, recycled arenas
  (:class:`ArenaPool`), admission with a per-tenant fair share, and one
  demux poller; :class:`ServiceReaderSet` is its session. Imported lazily:
  the service sits on top of ``core/buffers.py``, which imports the layers
  above.
"""
from repro_torch.ipc.ring import CommandRing, EventRing, RingEvent, ring_bytes
from repro_torch.ipc.shm import SharedArena, StaleArenaView, shm_dir
from repro_torch.ipc.worker import (
    ExitAfter,
    RaiseAfter,
    ServiceWorkerBoot,
    SpecSpill,
    StallReader,
    WorkerCrashed,
    WorkerProcess,
    WorkerSpec,
    service_worker_main,
    worker_main,
)

_SERVICE_EXPORTS = (
    "ReaderService",
    "ServiceBusy",
    "ServiceOptions",
    "ServiceReaderSet",
    "ArenaPool",
)

__all__ = [
    "CommandRing",
    "EventRing",
    "RingEvent",
    "ring_bytes",
    "SharedArena",
    "StaleArenaView",
    "shm_dir",
    "ExitAfter",
    "RaiseAfter",
    "ServiceWorkerBoot",
    "SpecSpill",
    "StallReader",
    "WorkerCrashed",
    "WorkerProcess",
    "WorkerSpec",
    "service_worker_main",
    "worker_main",
    *_SERVICE_EXPORTS,
]


def __getattr__(name: str):
    # repro_torch.ipc.service imports repro_torch.core.buffers, which
    # imports the ring/shm/worker layers above — loading it eagerly here
    # would be a cycle.
    if name in _SERVICE_EXPORTS:
        from repro_torch.ipc import service
        return getattr(service, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
