import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
# NB: no XLA_FLAGS here — tests must see 1 device; only the dry-run forces 512.

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips where torch sees none")
