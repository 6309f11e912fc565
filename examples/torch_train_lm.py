"""End-to-end driver on the PyTorch port: train a reduced qwen2-moe through
the CkIO pipeline with checkpoints and the fault-tolerant supervisor.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]

(A thin preset over ``python -m repro_torch.launch.train``, the port's
counterpart of ``examples/train_lm.py``; runs on the card unless given
``--device cpu``.)
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

if __name__ == "__main__":
    from repro_torch.launch.train import main

    main([
        "--arch", "qwen2-moe-a2.7b",
        "--smoke",
        "--steps", "200",
        "--global-batch", "8",
        "--seq", "128",
        "--microbatches", "2",
        "--num-readers", "4",
        "--num-consumers", "32",
        "--ckpt-every", "50",
        "--device-ingest",   # one transfer a step + on-device reassembly
    ] + sys.argv[1:])
