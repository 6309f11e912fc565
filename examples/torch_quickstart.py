"""CkIO quickstart on the PyTorch port: the paper's five-call API in one
file, the bytes read then checked on the device.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

(The port's counterpart of ``examples/quickstart.py``; runs on the card
unless given ``--device cpu``.)
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.core import CkIO, FileOptions
from repro_torch.device import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)

# 1. a "large shared input file" (64 MB of bytes)
path = os.path.join(tempfile.gettempdir(), f"ckio_torch_quickstart_{os.getpid()}.bin")
rng = np.random.default_rng(0)
data = rng.integers(0, 256, size=64 << 20, dtype=np.uint8).tobytes()
with open(path, "wb") as f:
    f.write(data)

try:
    # 2. a CkIO instance: 8 logical PEs on 2 "nodes"
    ck = CkIO(num_pes=8, pes_per_node=4)

    # 3. open -> startReadSession -> read -> closeReadSession -> close,
    #    every completion delivered as a scheduled task (split-phase).
    fh = ck.open_sync(path, FileOptions(num_readers=4, splinter_bytes=4 << 20))
    print(f"opened {fh.path} ({fh.size >> 20} MB), 4 buffer readers")

    sess = ck.start_read_session_sync(fh, nbytes=32 << 20, offset=8 << 20)
    print(f"session #{sess.id}: greedy prefetch started "
          f"({len(sess.plan.splinters)} splinters)")

    # split-phase read from a migratable client
    client = ck.make_client(pe=1)
    done = []

    def after_read(msg):
        # The bytes go to the device and are compared there.
        got = torch.frombuffer(bytearray(msg.data), dtype=torch.uint8).to(dev)
        want = torch.frombuffer(
            bytearray(data[msg.offset: msg.offset + msg.nbytes]),
            dtype=torch.uint8).to(dev)
        ok = bool(torch.equal(got, want))
        print(f"  read [{msg.offset}, +{msg.nbytes}) on PE {client.pe}: "
              f"{'OK' if ok else 'CORRUPT'} on {dev} "
              f"({msg.latency_s * 1e3:.2f} ms)")
        done.append(ok)

    buf = bytearray(1 << 20)
    ck.read(sess, 1 << 20, 10 << 20, buf, client.callback(after_read),
            client=client)
    ck.run_until(lambda: len(done) == 1)

    # 4. migrate the client mid-session; reads keep working at the new location
    client.migrate(6)
    buf2 = bytearray(1 << 20)
    ck.read(sess, 1 << 20, 24 << 20, buf2, client.callback(after_read),
            client=client)
    ck.run_until(lambda: len(done) == 2)

    print("metrics:", {k: round(v, 2) for k, v in sess.metrics.summary().items()
                       if k in ("throughput_MBps", "read_calls", "steals",
                                "requests", "bytes_read")})
    ck.close_read_session_sync(sess)
    ck.close_sync(fh)
finally:
    os.remove(path)
assert all(done)
print("quickstart OK")
