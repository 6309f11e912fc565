"""Hand-written Hopper kernels for CkIO's on-device batch reassembly.

reassemble — the three gathers of the phase-2 data permutation (CUDA C++,
``csrc/reassemble.cu``), with plain PyTorch versions in ``ref.py`` and the
device-dispatching entry points in ``ops.py``.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
