"""Hopper kernels for CkIO's phase-2 data permutation: build, bind, launch.

``csrc/reassemble.cu`` holds three CUDA kernels with a plain C interface.
Every ``csrc/*.cu`` of the package is compiled at first use with ``nvcc``
for ``sm_90a`` into ``build/repro_torch/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides it), one shared library per source,
and loaded with ``ctypes``: no PyTorch headers, so a build takes seconds.
The builder here serves every kernel module of the package
(``kernels/flash_attention.py`` too). Each wrapper checks device, dtype,
shape and contiguity, allocates the outputs with ``torch.empty``, launches
on the current stream, raises :class:`KernelError` if the launcher
reports a CUDA error (as a failed build does), and adds one to its entry
in :data:`LAUNCHES`. The window wrapper passes a chunk table of up to
:func:`max_param_chunks` entries by value and uploads a longer one
(:func:`window_table` decides; :data:`TABLE_UPLOADS` counts the uploads).

What each kernel replaces, what bounds it and how its design meets the
bound is noted at the top of the CUDA source. The plain PyTorch versions
of the same functions are in ``kernels/ref.py``; ``kernels/ops.py`` picks
between the two by the device of the tensors it is given.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "reassemble.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# Kernel launches per wrapper, counted where the wrapper launches its kernel.
LAUNCHES: Dict[str, int] = {
    "reassemble_window": 0,
    "reassemble": 0,
    "reassemble_tokens": 0,
}

_lock = threading.Lock()
_libs: Dict[Path, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel of the port failed to build or to launch. Not a transient
    fault: the train supervisor lets it propagate instead of restoring and
    replaying the step."""


# Chunk tables the window wrapper uploaded (tables too long to pass by
# value); the main path's tables make none.
TABLE_UPLOADS = 0


class WindowTable(NamedTuple):
    by_value: bool           # in the launch's parameters, or uploaded
    table: np.ndarray        # int64: the pointers, then the prefix offsets
    total: int               # tokens in the chunks


def reset_launch_counts() -> None:
    global TABLE_UPLOADS
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    TABLE_UPLOADS = 0


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "toolkit is needed to build the port's kernels")


def _library_path(source: Path) -> Path:
    return build_dir() / f"libckio_{source.stem}.so"


def build(*sources: Path, verbose: bool = False) -> List[Path]:
    """Compile each CUDA source (default: every ``csrc/*.cu``) into the
    build directory unless an up-to-date library is already there. One
    ``nvcc`` per source, all started together; returns the libraries'
    paths in the order of ``sources``."""
    sources = tuple(sources) or tuple(sorted(CSRC.glob("*.cu")))
    outs = [_library_path(s) for s in sources]
    # A source is stale when it or a shared header is newer than its library.
    headers = max((h.stat().st_mtime for h in CSRC.glob("*.cuh")), default=0.0)
    jobs = []
    for src, out in zip(sources, outs):
        if out.exists() and out.stat().st_mtime >= max(src.stat().st_mtime,
                                                       headers):
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(src)]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, out, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
            continue
        if verbose and err:
            print(err, end="")
        os.replace(tmp, out)
    if failed:
        raise KernelError("\n".join(failed))
    return outs


def load_library(source: Path, bind: Callable[[ctypes.CDLL], None]
                 ) -> ctypes.CDLL:
    """The library built from ``source`` (built at first use), with
    ``bind`` called once to declare its functions' argument types."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)[0]))
            bind(lib)
            _libs[source] = lib
        return lib


def _bind(lib: ctypes.CDLL) -> None:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ckio_reassemble_window.argtypes = [P, I, I, L, P, P, I, I, L, I, P]
    lib.ckio_reassemble.argtypes = [P, P, P, L, L, I, P]
    lib.ckio_reassemble_tokens.argtypes = [P, L, P, P, P, L, I, I, P]
    lib.ckio_window_param_chunks.argtypes = []
    for fn in (lib.ckio_reassemble_window, lib.ckio_reassemble,
               lib.ckio_reassemble_tokens, lib.ckio_window_param_chunks):
        fn.restype = ctypes.c_int


def _library():
    return load_library(SOURCE, _bind)


def check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise KernelError(f"{name}: CUDA error {rc} at launch")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: all tensors must be on one CUDA device "
                             f"(got {[str(x.device) for x in tensors]})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


@functools.cache
def max_param_chunks() -> int:
    """The longest chunk table the window kernel takes by value
    (``kMaxParamChunks``, read from the built library)."""
    return _library().ckio_window_param_chunks()


def window_table(ptrs: Sequence[int], sizes: Sequence[int], cap: int
                 ) -> WindowTable:
    """Where a window kernel's chunk table goes, and its bytes.

    ``ptrs`` are the chunks' device addresses and ``sizes`` their token
    counts, in file order. ``table`` is the ``n`` pointers, then the
    ``n + 1`` prefix token offsets. A table of at most ``cap`` chunks goes
    in the kernel's parameters (the launcher copies it there); a longer
    one is uploaded and read from device memory."""
    n = len(ptrs)
    if n != len(sizes) or n == 0:
        raise ValueError(f"window_table: {n} pointers, {len(sizes)} sizes")
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.asarray(sizes, dtype=np.int64), out=starts[1:])
    table = np.concatenate([np.asarray(ptrs, dtype=np.int64), starts])
    return WindowTable(n <= cap, table, int(starts[-1]))


def reassemble_window_cuda(
    chunks: Sequence[torch.Tensor],
    *,
    global_batch: int,
    seq_len: int,
    window_tok_off: int = 0,
    valid_limit: int | None = None,
    pad_id: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """File-order int32 chunks (concatenated, the window's token buffer) ->
    batch-major ``(inputs, labels)`` of shape ``(B, S)``. The chunks are
    read in place through a pointer table; nothing is concatenated. A table
    of up to :func:`max_param_chunks` chunks is passed by value; a longer
    one is uploaded (counted in :data:`TABLE_UPLOADS`)."""
    global TABLE_UPLOADS
    chunks = list(chunks)
    if not chunks:
        raise ValueError("reassemble_window: no chunks")
    B, S, w0 = int(global_batch), int(seq_len), int(window_tok_off)
    if B < 0 or S < 1 or w0 < 0:
        raise ValueError(f"reassemble_window: bad shape B={B} S={S} "
                         f"window_tok_off={w0}")
    dev = _require_cuda("reassemble_window", *chunks)
    for c in chunks:
        if c.dtype != torch.int32 or c.dim() != 1:
            raise ValueError("reassemble_window: chunks must be 1-D int32")
    inputs = torch.empty((B, S), dtype=torch.int32, device=dev)
    labels = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B == 0:
        return inputs, labels
    tab = window_table([c.data_ptr() for c in chunks],
                       [c.numel() for c in chunks], max_param_chunks())
    limit = B * (S + 1) + w0 if valid_limit is None else valid_limit
    limit = min(limit, tab.total)
    if not tab.by_value:
        # Uploaded from page-locked memory, so the copy is queued on the
        # stream and does not wait for the work already there (PyTorch's
        # host allocator keeps the pinned block until the copy has run).
        table = torch.from_numpy(tab.table).pin_memory().to(
            dev, non_blocking=True)
        TABLE_UPLOADS += 1
        ptr, on_device = table.data_ptr(), 1
    else:
        ptr, on_device = tab.table.ctypes.data, 0
    rc = _library().ckio_reassemble_window(
        ptr, on_device, len(chunks), limit, inputs.data_ptr(),
        labels.data_ptr(), B, S, w0, int(pad_id), stream_of(inputs))
    check_rc(rc, "reassemble_window")
    LAUNCHES["reassemble_window"] += 1
    return inputs, labels


def reassemble_cuda(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Block gather ``out[i] = src[idx[i]]`` over the leading axis of an
    N-D ``src`` (any dtype; rows are copied as bytes). ``idx`` is int32 on
    the same device, every value in ``[0, src.shape[0])``."""
    if src.dim() < 2:
        raise ValueError(f"src must have >= 2 dims (got shape {tuple(src.shape)})")
    dev = _require_cuda("reassemble", src, idx)
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError("reassemble: idx must be 1-D int32")
    out = torch.empty((idx.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=dev)
    row_bytes = src[0].numel() * src.element_size()
    if out.numel() == 0:
        return out
    if row_bytes // 16384 >= 65535:
        raise ValueError("reassemble: rows above 1 GiB are not supported")
    unit = 16
    while unit > 1 and (row_bytes % unit or src.data_ptr() % unit
                        or out.data_ptr() % unit):
        unit //= 2 if unit != 16 else 4
    rc = _library().ckio_reassemble(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        row_bytes, unit, stream_of(out))
    check_rc(rc, "reassemble")
    LAUNCHES["reassemble"] += 1
    return out


def reassemble_tokens_cuda(
    staged: torch.Tensor, row_idx: torch.Tensor, *, pad_id: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token gather: row ``b`` of the window is ``staged[row_idx[b]]``
    (``row_idx (B, S+1)`` int32; negative entries pad, others clip to
    ``[0, L-1]``). Inputs take columns ``[:S]``, labels ``[1:]``."""
    dev = _require_cuda("reassemble_tokens", staged, row_idx)
    if staged.dtype != torch.int32 or staged.dim() != 1:
        raise ValueError("reassemble_tokens: staged must be 1-D int32")
    if row_idx.dtype != torch.int32 or row_idx.dim() != 2:
        raise ValueError("reassemble_tokens: row_idx must be 2-D int32")
    if staged.numel() == 0:
        raise ValueError("reassemble_tokens: empty staged buffer")
    B, S = row_idx.shape[0], row_idx.shape[1] - 1
    inputs = torch.empty((B, S), dtype=torch.int32, device=dev)
    labels = torch.empty((B, S), dtype=torch.int32, device=dev)
    if B * S == 0:
        return inputs, labels
    rc = _library().ckio_reassemble_tokens(
        staged.data_ptr(), staged.numel(), row_idx.data_ptr(),
        inputs.data_ptr(), labels.data_ptr(), B, S, int(pad_id),
        stream_of(inputs))
    check_rc(rc, "reassemble_tokens")
    LAUNCHES["reassemble_tokens"] += 1
    return inputs, labels
