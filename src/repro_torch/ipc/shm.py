"""Shared-memory session arena for the multi-process reader backend.

The thread backend's session arena is a private ``np.empty`` buffer — readers
fill it, consumers get zero-copy ``memoryview``s out of it, and nothing ever
crosses an address space. A multi-process backend needs the same arena to be
*mapped* into every reader worker process AND the consumer process, so the
paper's zero-copy buffer→client hand-off survives the process boundary:
workers ``preadv`` file bytes straight into their stripe of the mapping, and
the consumer's borrowed views alias the very same physical pages
(``bytes_copied == 0`` in the consumer process).

``SharedArena`` is that mapping. It is backed by a **named** segment —
a file under ``/dev/shm`` (tmpfs: pages, not disk) with a tempdir fallback —
rather than an inherited ``memfd``, deliberately: worker processes are
fresh interpreters (no fork of the parent's threads or CUDA context), and a
*name* travels in the worker's spec while a file descriptor would rely on
fd inheritance. Each process opens its **own** fd, maps, and closes the fd
immediately (the mapping keeps the segment alive) — the same per-process fd
hygiene the data file gets (``io/posix.py``).

Segment names start with ``ckiot-``, never the reference package's
``ckio-``: the reference's tests count and remove ``ckio-*`` entries of
``/dev/shm``, and both packages' tests run side by side.

NUMA striping carries over from the thread runtime: the segment is created
lazily (``ftruncate`` — no page is faulted at creation), so the *first
touch* of each stripe's pages happens in the worker process that owns the
stripe (``ipc/worker.py`` runs the page-stride touch after optionally
``sched_setaffinity``-pinning itself to its stripe's domain CPUs). Under
Linux first-touch, domain placement therefore survives the multi-process
split. On a host whose ``/dev/shm`` is smaller than the arena, ``ftruncate``
still succeeds and the first touch past the capacity kills the worker with
``SIGBUS``; the supervisor then fails the session with a ``WorkerCrashed``
that names the worker.

Lifetime contract (mirrors the borrowed-view rules in ``core/api.py``):
views of ``SharedArena.ndarray()`` are valid until the owning session
closes; ``close()`` releases the parent mapping best-effort (a live buffer
export pins the pages — Python keeps them alive for the exporter, so this
stays memory-safe) and ``unlink()`` removes the name so the segment dies
with its last mapping.

The reader service (``ipc/service.py``) amends that contract:

* **Recycling**: its ``ArenaPool`` reuses segments across sessions, so a
  steady-state session faults no page and runs no ``ftruncate``; a
  recycled segment keeps its first-touch placement. A session hands its
  pooled arena back to the pool at close instead of unlinking it; the pool
  quarantines (unlinks) a segment whose borrowed views are still pinned by
  a live export, such as a CPU tensor made with ``torch.from_numpy``.
* **Generation stamp**: every pool checkout bumps ``generation``. A view
  captured under generation G would alias a newer session's bytes once the
  segment is recycled into G+1; code that keeps views across sessions
  re-validates with :meth:`SharedArena.check_generation`, which raises
  :class:`StaleArenaView` instead.
* **Detach vs close**: a pooled worker releases its mapping with
  :meth:`SharedArena.detach` (the segment outlives it); ``close()`` stays
  the owner's teardown.

Pooled segments keep the ``ckiot-`` prefix: ``ckiot-svc-*`` (arenas),
``ckiot-svc-cmd-*`` (mailboxes) and ``ckiot-svc-ring-*`` (event rings).
"""
from __future__ import annotations

import mmap
import os
import secrets
import tempfile
from typing import Optional

import numpy as np

_SHM_DIR = "/dev/shm"
PREFIX = "ckiot-"


class StaleArenaView(RuntimeError):
    """A borrowed view's arena generation no longer matches the segment —
    the segment was recycled into a newer session and the view would alias
    that session's data. Raised by ``SharedArena.check_generation``."""


def shm_dir() -> str:
    """Directory backing arena segments: tmpfs when the host has one."""
    if os.path.isdir(_SHM_DIR) and os.access(_SHM_DIR, os.W_OK):
        return _SHM_DIR
    return tempfile.gettempdir()


class SharedArena:
    """A named, mmap-shared byte arena (one per read session / ring block).

    Create in the parent with :meth:`create`; attach from a worker process
    with :meth:`attach` (by name — never by inherited fd). Both sides hold
    only the mapping; the backing fd is closed immediately after ``mmap``.
    """

    def __init__(self, path: str, mm: mmap.mmap, nbytes: int, owner: bool):
        self.path = path
        self.nbytes = nbytes
        self._mm: Optional[mmap.mmap] = mm
        self._owner = owner        # creator: responsible for unlink
        self._arr: Optional[np.ndarray] = None
        # Pool-recycling generation: bumped by ArenaPool on every checkout.
        # 0 = never pooled (per-session arena).
        self.generation = 0

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, nbytes: int, tag: str = "arena") -> "SharedArena":
        """Create a new segment of ``nbytes`` (lazily allocated — ftruncate
        faults no page, so stripe placement is decided by first touch in
        the worker that owns the stripe)."""
        if nbytes < 0:
            raise ValueError(f"negative arena size {nbytes}")
        name = f"{PREFIX}{tag}-{os.getpid()}-{secrets.token_hex(6)}"
        path = os.path.join(shm_dir(), name)
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
        try:
            os.ftruncate(fd, max(nbytes, 1))   # mmap rejects length 0
            mm = mmap.mmap(fd, max(nbytes, 1))
        except BaseException:
            os.close(fd)
            os.unlink(path)
            raise
        os.close(fd)                           # the mapping keeps it alive
        return cls(path, mm, nbytes, owner=True)

    @classmethod
    def attach(cls, path: str, nbytes: int) -> "SharedArena":
        """Map an existing segment by name — each process opens its OWN fd
        (no fd inheritance across spawn) and closes it after mapping."""
        fd = os.open(path, os.O_RDWR)
        try:
            mm = mmap.mmap(fd, max(nbytes, 1))
        finally:
            os.close(fd)
        return cls(path, mm, nbytes, owner=False)

    # -- access --------------------------------------------------------------
    @property
    def buf(self) -> memoryview:
        assert self._mm is not None, "arena is closed"
        return memoryview(self._mm)[: self.nbytes]

    def ndarray(self) -> np.ndarray:
        """uint8 view of the whole arena (cached — the session's ``_arena``).

        The array aliases the mapping: slices/views of it are zero-copy and
        shared with every attached process."""
        if self._arr is None:
            assert self._mm is not None, "arena is closed"
            self._arr = np.frombuffer(self._mm, dtype=np.uint8,
                                      count=self.nbytes)
        return self._arr

    def check_generation(self, expected: int) -> None:
        """Fail fast if the arena has been recycled since ``expected`` was
        captured (or torn down entirely) — a stale view must never alias a
        newer session's bytes."""
        if self._mm is None or self.generation != expected:
            raise StaleArenaView(
                f"arena {self.path or '<unlinked>'} is at generation "
                f"{self.generation if self._mm is not None else '<closed>'}"
                f", view was captured at generation {expected}")

    # -- teardown ------------------------------------------------------------
    def detach(self) -> None:
        """Release this process's mapping WITHOUT unlinking the name (a
        worker's teardown). A live export pins the mapping: tolerated, as
        in ``close()``."""
        self._arr = None
        if self._mm is not None:
            try:
                self._mm.close()
            except BufferError:      # live export pins the mapping; safe
                pass
            self._mm = None

    def unlink(self) -> None:
        """Remove the segment's name (idempotent). Existing mappings — ours
        and the workers' — stay valid; the memory dies with the last one."""
        if self._owner and self.path:
            try:
                os.unlink(self.path)
            except OSError:
                pass
            self.path = ""

    def close(self) -> None:
        """Release this process's mapping (and unlink when owner).

        Best-effort: a live buffer export (e.g. an ``np.frombuffer`` array or
        a CPU tensor a client still holds) pins the mapping — Python keeps
        the pages alive for the exporter, so we drop our reference and let
        GC finish the job instead of invalidating memory under the
        exporter's feet."""
        self.unlink()
        self.detach()

    @property
    def closed(self) -> bool:
        return self._mm is None
