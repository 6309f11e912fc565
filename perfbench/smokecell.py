"""A copy of the benchmark's data at a size a CPU test run holds.

``make_root(dest)`` writes ``dest/BENCHMARK.json`` and ``dest/perfbench``
with every cell of the real benchmark: each configuration cut to the
port's smoke sizes of its family (``configs.registry.smoke_config``), each
traffic mix to 4 rows of 32 tokens in 2 microbatches over 64 windows, the
metrics, counts and limits as they are. ``harness.run(..., root=dest,
device="cpu")`` then drives the whole run on the CPU.

The root also holds the pooled, sharded traffic mix
(``traffic/train.b8s2048.shards3-pool.json``) as a cell of its own, with
the falcon-mamba limits and the ``service_checkout_ms`` reader, as a later
benchmark PR would add it: it has no cell in ``BENCHMARK.json`` yet (its
runs on the H100 lost seconds of some windows to stalls not yet explained,
``PERF.md`` section 7), and the tests keep its path driven.

``add_hybrid_cell(root)`` adds, as new files and entries only, a
configuration of no published model whose period mixes three Mamba-1
layers and one attention layer, each with a SwiGLU MLP, computed in fp32:
the tests put its port config into the registry (``with_hybrid``) and
drive it as a later ``model_config`` PR would add a mixed configuration.
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
POOL_CELL = {"name": "falcon-mamba.train.b8s2048.shards3-pool",
             "config": "falcon-mamba-7b",
             "traffic": "train.b8s2048.shards3-pool", "chips": 1,
             "why": "a 3-shard corpus, O_DIRECT, pooled reader-service "
                    "workers, streamed"}
POOL_METRIC = {"name": "service_checkout_ms", "unit": "ms", "better": "lower",
               "source": "program_counter", "layer": "reader service",
               "moves": "train_tokens_per_s",
               "workloads": [POOL_CELL["name"]]}
HYBRID = "hybrid-test"


def _smoke_config(conf: dict) -> dict:
    """Every width of the file that the port's smoke config has, and the
    depth, cut to the port's smoke sizes of its family."""
    from repro_torch.configs.registry import get_config, smoke_config

    m = conf["model"]
    cfg = smoke_config(get_config(m["registry"]))
    m["smoke"] = True
    m["run"] = dict(m["run"], num_layers=cfg.num_layers)
    for k in m["widths"]:
        if hasattr(cfg, k):
            m["widths"][k] = getattr(cfg, k)
    return conf


def _smoke_traffic(t: dict, direct_ok: bool) -> dict:
    t.update(global_batch=4, seq_len=32, microbatches=2, corpus_windows=64,
             profiled_steps=2)
    t["reader"] = dict(t["reader"], num_readers=2, num_consumers=4,
                       max_workers=2,
                       pool_workers=min(2, t["reader"]["pool_workers"]),
                       direct_io=t["reader"]["direct_io"] and direct_ok)
    return t


def direct_io_ok(directory: str) -> bool:
    probe = os.path.join(directory, "probe.bin")
    with open(probe, "wb") as f:
        f.write(b"\0" * 4096)
    try:
        fd = os.open(probe, os.O_RDONLY | os.O_DIRECT)
    except OSError:
        return False
    else:
        os.close(fd)
        return True
    finally:
        os.remove(probe)


def make_root(dest: str) -> str:
    data = os.path.join(dest, "perfbench")
    for sub in ("counts", "metrics", "limits", "reference"):
        shutil.copytree(os.path.join(HERE, sub), os.path.join(data, sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    direct_ok = direct_io_ok(dest)
    for sub, fix in (("configs", _smoke_config),
                     ("traffic", lambda t: _smoke_traffic(t, direct_ok))):
        os.makedirs(os.path.join(data, sub))
        for name in os.listdir(os.path.join(HERE, sub)):
            with open(os.path.join(HERE, sub, name)) as f:
                obj = fix(json.load(f))
            with open(os.path.join(data, sub, name), "w") as f:
                json.dump(obj, f, indent=1)
    add_pool_cell(dest)
    return dest


def add_pool_cell(root: str) -> None:
    """``POOL_CELL`` and ``POOL_METRIC`` added to ``root``'s benchmark as
    files, the per-layer metrics of the single-file falcon cell with them."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    twin = "falcon-mamba.train.b8s2048"
    bench["workloads"].append(POOL_CELL)
    for m in bench["per_layer"]:
        if twin in m.get("workloads", []):
            m["workloads"].append(POOL_CELL["name"])
    bench["per_layer"].append(POOL_METRIC)
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    limits = os.path.join(root, "perfbench", "limits")
    shutil.copy(os.path.join(limits, f"{twin}.json"),
                os.path.join(limits, f"{POOL_CELL['name']}.json"))


def hybrid_port_config():
    """The port's ``ModelConfig`` of the mixed configuration at full size
    (``smoke_config`` cuts it): periods of three ``mamba``+``dense``
    layers and one ``attn``+``dense`` (MQA, RoPE), fp32 compute."""
    from repro_torch.configs.base import (ATTN, DENSE, MAMBA, LayerSpec,
                                          ModelConfig)

    ssm, attn = LayerSpec(mixer=MAMBA, ffn=DENSE), LayerSpec(mixer=ATTN,
                                                             ffn=DENSE)
    return ModelConfig(
        name=HYBRID, family="hybrid", num_layers=8, d_model=1024,
        num_heads=8, num_kv_heads=1, head_dim=128, d_ff=2816,
        vocab_size=32000, block_pattern=(ssm, ssm, ssm, attn),
        ssm_state=16, d_inner=2048, dt_rank=64, conv_width=4,
        ssm_chunk=256, rope_theta=10_000.0, tie_embeddings=True,
        dtype="float32", source="a test configuration")


def with_hybrid(get_config, port=None):
    """``get_config`` that also knows ``HYBRID``: ``port``, by default
    ``hybrid_port_config()``."""
    def get(name):
        if name == HYBRID:
            return port or hybrid_port_config()
        return get_config(name)
    return get


def hybrid_file() -> dict:
    """The mixed configuration's file at full size, ``model.schedule``
    giving one period of its layer kinds."""
    cfg = hybrid_port_config()
    widths = ("d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "d_inner", "ssm_state", "dt_rank", "conv_width",
              "tie_embeddings", "rope_theta", "norm_eps", "act", "dtype",
              "param_dtype")
    return {
        "name": HYBRID,
        "model": {
            "registry": HYBRID,
            "run": {"num_layers": cfg.num_layers, "ssm_impl": "fused"},
            "schedule": [{"mixer": s.mixer, "ffn": s.ffn}
                         for s in cfg.block_pattern],
            "widths": {k: getattr(cfg, k) for k in widths}},
        "init": {"table": ["normal", 0.02], "scale": ["zeros"],
                 "wo": ["fan_in", 2], "conv_b": ["zeros"],
                 "A_log": ["s4d_real"], "D": ["ones"],
                 "dt_bias": ["dt_log_uniform", 0.001, 0.1],
                 "*": ["fan_in", 1]}}


def add_hybrid_cell(root: str, conf: dict = None) -> str:
    """A cell of the mixed configuration added to ``root`` as files and
    one entry; returns its name. The configuration (``conf``, by default
    ``hybrid_file()``) cut by ``_smoke_config`` (the registry has to know
    ``HYBRID``), its own traffic (the smoke mix) and limits (phi4-mini's)."""
    data = os.path.join(root, "perfbench")
    conf = _smoke_config(conf or hybrid_file())
    cell = {"name": f"{conf['name']}.train", "config": conf["name"],
            "traffic": "train.hybrid", "chips": 1,
            "why": "a mixed period, three mamba+dense layers and one "
                   "attn+dense, added as files"}
    with open(os.path.join(data, "configs", f"{conf['name']}.json"),
              "w") as f:
        json.dump(conf, f, indent=1)
    shutil.copy(os.path.join(data, "traffic", "train.b8s2048.json"),
                os.path.join(data, "traffic", f"{cell['traffic']}.json"))
    shutil.copy(os.path.join(data, "limits", "phi4-mini.train.b8s2048.json"),
                os.path.join(data, "limits", f"{cell['name']}.json"))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)
    return cell["name"]


@contextlib.contextmanager
def few_threads(n: int = 2):
    """torch's intra-op threads held to ``n`` (test runs share the host's
    cores with other test workers), restored on exit."""
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(prev)
