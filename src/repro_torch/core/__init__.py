"""CkIO core, thread backend: two-phase, split-phase parallel file input
with reader/consumer decomposition independence, greedy read sessions,
splintered I/O, work-stealing straggler mitigation and migratable
consumers."""
from repro_torch.core.api import CkIO
from repro_torch.core.assembler import ReadComplete
from repro_torch.core.buffers import BufferReaderSet, NetworkModel, ReaderOptions, SplinterEvent
from repro_torch.core.futures import CkCallback, CkFuture
from repro_torch.core.metrics import IngestMetrics, ServeMetrics, SessionMetrics, StreamMetrics, percentile
from repro_torch.core.migration import Client, LocationManager, VirtualProxy
from repro_torch.core.placement import place_readers
from repro_torch.core.scheduler import BackgroundWorker, TaskScheduler
from repro_torch.core.session import FileHandle, FileOptions, Session

__all__ = [
    "CkIO",
    "ReadComplete",
    "BufferReaderSet",
    "NetworkModel",
    "ReaderOptions",
    "SplinterEvent",
    "CkCallback",
    "CkFuture",
    "IngestMetrics",
    "ServeMetrics",
    "percentile",
    "SessionMetrics",
    "StreamMetrics",
    "Client",
    "LocationManager",
    "VirtualProxy",
    "place_readers",
    "BackgroundWorker",
    "TaskScheduler",
    "FileHandle",
    "FileOptions",
    "Session",
]
