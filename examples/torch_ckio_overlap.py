"""Compute/input overlap demo on the PyTorch port (paper Figs. 8–9
mechanism, minimal form).

Background chares keep executing on every PE while a read session ingests a
file on helper I/O threads; the printed fraction is the share of the input
window spent doing useful background compute. The window is then copied to
the device and checked there.

    PYTHONPATH=src python examples/torch_ckio_overlap.py [--device cpu]

(The port's counterpart of ``examples/ckio_overlap.py``; runs on the card
unless given ``--device cpu``.)
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import BackgroundWorker, CkFuture, CkIO, FileOptions
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)

path = os.path.join(tempfile.gettempdir(), f"ckio_torch_overlap_{os.getpid()}.bin")
data = np.random.default_rng(0).integers(0, 256, 96 << 20, dtype=np.uint8)
with open(path, "wb") as f:
    f.write(data.tobytes())

try:
    ck = CkIO(num_pes=4)
    workers = [BackgroundWorker(ck.sched, pe, grain_us=10) for pe in range(4)]
    fh = ck.open_sync(path, FileOptions(num_readers=4))

    t0 = time.perf_counter()
    sess = ck.start_read_session_sync(fh, fh.size, 0)
    for w in workers:
        w.start()

    done = CkFuture()
    buf = bytearray(fh.size)
    ck.read(sess, fh.size, 0, buf, done)
    done.wait(ck.sched, timeout=120)
    wall = time.perf_counter() - t0
    for w in workers:
        w.stop()

    busy = sum(w.busy_s for w in workers)
    iters = sum(w.iterations for w in workers)
    print(f"input window: {wall*1e3:.1f} ms for {fh.size >> 20} MB "
          f"({fh.size/wall/1e6:.0f} MB/s)")
    print(f"background work done during input: {iters} iterations, "
          f"{busy*1e3:.1f} ms busy -> overlap fraction {100*busy/wall:.1f}%")
    ck.close_read_session_sync(sess)
    ck.close_sync(fh)
finally:
    os.remove(path)
ok = torch.equal(torch.frombuffer(buf, dtype=torch.uint8).to(dev),
                 torch.from_numpy(data).to(dev))
print(f"window on {dev}: {'OK' if ok else 'CORRUPT'}")
assert ok
