"""Device selection for the port's entry points.

Every entry point takes ``device`` and defaults to ``"cuda"``. Asking for
CUDA where PyTorch sees no card raises: nothing falls back to the CPU
unless the caller passes ``device="cpu"`` (the plain PyTorch path, which
is what the CPU tests run).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False; pass "
                "device='cpu' to run the plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (expected cuda or cpu)")
    return dev
