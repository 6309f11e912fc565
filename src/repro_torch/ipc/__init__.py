"""Reader-worker types of the process backend that the port needs before
the backend itself (see ``worker.py``)."""
from repro_torch.ipc.worker import ExitAfter, RaiseAfter, StallReader, WorkerCrashed

__all__ = ["ExitAfter", "RaiseAfter", "StallReader", "WorkerCrashed"]
