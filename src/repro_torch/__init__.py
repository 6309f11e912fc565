"""PyTorch/CUDA port of the CkIO reproduction (``src/repro`` is the JAX
reference). Imports torch, numpy and the standard library only."""
