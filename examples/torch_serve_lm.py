"""Serving example on the PyTorch port: greedy decoding of CkIO-loaded
prompts on a reduced recurrentgemma (hybrid RG-LRU + local attention; on
the card its decode runs the gated RG-LRU and flash-attention kernels).

Static batching is the default. Extra flags pass straight through to
``repro_torch.launch.serve``:

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]
    PYTHONPATH=src python examples/torch_serve_lm.py --continuous --arrival-rate 50
    PYTHONPATH=src python examples/torch_serve_lm.py --continuous --service \\
        --pool-workers 2 --max-inflight-mb 16

(The port's counterpart of ``examples/serve_lm.py``; runs on the card
unless given ``--device cpu``.)
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

if __name__ == "__main__":
    from repro_torch.launch.serve import main

    main([
        "--arch", "recurrentgemma-2b",
        "--smoke",
        "--requests", "12",
        "--batch", "4",
        "--prompt-len", "24",
        "--max-new", "8",
    ] + sys.argv[1:])
