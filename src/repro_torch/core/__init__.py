"""CkIO core: two-phase, split-phase parallel file input with
reader/consumer decomposition independence, greedy read sessions,
splintered I/O, work-stealing straggler mitigation, migratable consumers,
reader worker processes over a shared-memory arena with respawn/reissue
recovery, the pooled reader service (``ipc/service.py``, attached with
``Director.attach_service``; its ``ServiceMetrics`` are exported here), and
NUMA-aware reader placement."""
from repro_torch.core.api import CkIO
from repro_torch.core.assembler import ReadComplete
from repro_torch.core.buffers import BufferReaderSet, NetworkModel, ProcessReaderSet, ReaderOptions, SplinterEvent
from repro_torch.core.faults import FaultPlan
from repro_torch.core.futures import CkCallback, CkFuture
from repro_torch.core.metrics import (
    IngestMetrics,
    LocalityMetrics,
    RecoveryMetrics,
    ServeMetrics,
    ServiceMetrics,
    SessionMetrics,
    StreamMetrics,
    percentile,
)
from repro_torch.core.migration import Client, LocationManager, VirtualProxy
from repro_torch.core.placement import Topology, place_readers
from repro_torch.core.scheduler import BackgroundWorker, TaskScheduler
from repro_torch.core.session import FileHandle, FileOptions, Session
from repro_torch.ipc.worker import WorkerCrashed

__all__ = [
    "CkIO",
    "ReadComplete",
    "BufferReaderSet",
    "NetworkModel",
    "ProcessReaderSet",
    "ReaderOptions",
    "SplinterEvent",
    "FaultPlan",
    "CkCallback",
    "CkFuture",
    "IngestMetrics",
    "LocalityMetrics",
    "RecoveryMetrics",
    "ServeMetrics",
    "ServiceMetrics",
    "percentile",
    "SessionMetrics",
    "StreamMetrics",
    "Client",
    "LocationManager",
    "VirtualProxy",
    "Topology",
    "place_readers",
    "BackgroundWorker",
    "TaskScheduler",
    "FileHandle",
    "FileOptions",
    "Session",
    "WorkerCrashed",
]
