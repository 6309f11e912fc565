"""Hand-written Hopper kernels of the port.

reassemble — the three gathers of CkIO's phase-2 data permutation
(``csrc/reassemble.cu``); flash_attention — the attention forward
(``csrc/flash_attention.cu``); mamba_scan — the Mamba-1 selective scan,
forward (``csrc/mamba_scan.cu``); rglru_scan — the RG-LRU recurrence,
forward (``csrc/rglru_scan.cu``). Plain PyTorch versions are in ``ref.py``,
the device-dispatching entry points in ``ops.py``.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
