"""Hand-written Hopper kernels of the port.

reassemble — the three gathers of CkIO's phase-2 data permutation
(``csrc/reassemble.cu``); flash_attention — the attention forward
(``csrc/flash_attention.cu``); mamba_scan — the Mamba-1 selective scan,
literal and fused, forward and backward (``csrc/mamba_scan.cu``, the
literal backward in ``csrc/mamba_scan_bwd.cu``);
rglru_scan — the RG-LRU recurrence, forward, and the gated entry's backward
(``csrc/rglru_scan.cu``). Plain PyTorch versions are in ``ref.py``, the
device-dispatching entry points in ``ops.py``.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
