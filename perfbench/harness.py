"""One benchmark run of one cell: set-up, the measured window, the traced
steps, the comparison with the plain reference, and the result line.

Everything that belongs to one cell is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``perfbench/configs/<name>.json``)
and its traffic (``perfbench/traffic/<name>.json``); each metric is read by
``perfbench/metrics/<name>.py``; counts of operations and bounds live in
``perfbench/counts/``; the limits of the comparison in
``perfbench/limits/<cell>.json``.

A configuration file gives its layers as ``model.schedule``, one period of
``{"mixer": ..., "ffn": ...}`` kinds cycled to ``run.num_layers``, or as a
single ``model.kind`` that every layer has. Its plain reference is
``perfbench/reference/model.py``, or the module under
``perfbench/reference/`` that the file names as ``"reference"``; either
gives ``param_shapes(m)`` and ``train(...)`` with ``model.py``'s
signatures.

The window drives the port's train loop as ``repro_torch.launch.train``
builds it: ``CkIOPipeline.get_batch_device(step % num_steps)``, then the
``make_train_step`` step under ``StepSupervisor`` (checkpoints off), then
the loss read on the host. Set-up runs the first steps through the same
call; the reference follows them on the same weights and batches: as many
as the cell's limits file says under ``compared_steps`` (three if it says
nothing).
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

import compare
import tracereader
import traffic as traffic_gen
import weights
from reference import model as ref_model

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
COMPARED_STEPS = 3          # the reference follows the program this far,
                            # unless the cell's limits say otherwise


# -- spec ---------------------------------------------------------------------
def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str):
    name = "perfbench_" + os.path.splitext(os.path.basename(path))[0] \
        .replace("-", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(cell: str, root: str = REPO) -> SimpleNamespace:
    """The cell's entry, configuration, traffic, limits, metrics and plain
    reference, read from ``root/BENCHMARK.json`` and the files under
    ``root/perfbench``."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    data = os.path.join(root, "perfbench")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"unknown workload {cell!r}; known: {sorted(cells)}")
    w = cells[cell]

    def mine(m: Dict, reported: List[str]) -> bool:
        if "workloads" in m:
            return cell in m["workloads"]
        return m.get("moves") is None or m["moves"] in reported

    limits = _json(os.path.join(data, "limits", f"{cell}.json"))
    e2e = [m for m in bench["end_to_end"] if mine(m, [])]
    names = [m["name"] for m in e2e]
    layer = [m for m in bench["per_layer"] if mine(m, names)]
    config = _json(os.path.join(data, "configs", f"{w['config']}.json"))
    reference = (load_module(os.path.join(data, "reference",
                                          f"{config['reference']}.py"))
                 if "reference" in config else ref_model)
    return SimpleNamespace(
        cell=cell, root=root, data=data, entry=w, config=config,
        reference=reference,
        traffic=_json(os.path.join(data, "traffic", f"{w['traffic']}.json")),
        limits=limits,
        compared_steps=limits.get("compared_steps", COMPARED_STEPS),
        hw=_json(os.path.join(data, "counts", "h100.json")),
        end_to_end=e2e, per_layer=layer)


def metric_module(spec, name: str):
    return load_module(os.path.join(spec.data, "metrics", f"{name}.py"))


def counts_module(spec, name: str):
    return load_module(os.path.join(spec.data, "counts", f"{name}.py"))


def layer_schedule(m: Dict) -> List[Dict[str, str]]:
    """Each layer's ``{"mixer", "ffn"}`` kinds: the file's ``schedule`` (or
    its single ``kind``) cycled to ``run.num_layers``, as the port's
    ``ModelConfig.layer_schedule()`` cycles its ``block_pattern``."""
    period = [{"mixer": k["mixer"], "ffn": k["ffn"]}
              for k in (m["schedule"] if "schedule" in m else [m["kind"]])]
    return [period[i % len(period)] for i in range(m["run"]["num_layers"])]


# -- the program --------------------------------------------------------------
def port_config(spec):
    """The port's ``ModelConfig`` from the registry, cut as the file says;
    refuses to run where a width or a layer's kinds differ from the file,
    naming the first layer that differs."""
    from repro_torch.configs.registry import get_config, smoke_config

    m = spec.config["model"]
    cfg = get_config(m["registry"])
    if m.get("smoke"):
        cfg = smoke_config(cfg)
    cfg = cfg.replace(**m["run"])
    wrong = {k: (getattr(cfg, k), v) for k, v in m["widths"].items()
             if getattr(cfg, k) != v}
    port = [f"{s.mixer}+{s.ffn}" for s in cfg.layer_schedule()]
    want = [f"{k['mixer']}+{k['ffn']}" for k in layer_schedule(m)]
    for i, (a, b) in enumerate(zip(port, want)):
        if a != b:
            wrong[f"layer {i}"] = (a, b)
            break
    if wrong:
        raise SystemExit(f"{spec.config['name']}: the port's config differs "
                         f"from the file (port, file): {wrong}")
    return cfg


def reference_model(spec) -> Dict:
    """The reference's ``m``: the file's widths and run, and each layer's
    kinds as ``schedule``."""
    m = spec.config["model"]
    return dict(m["widths"], **m["run"], schedule=layer_schedule(m))


def shape_tree(spec):
    """The parameter tree's shapes in the reference's layout."""
    return weights.tree_from_shapes(
        spec.reference.param_shapes(reference_model(spec)))


def check_layout(spec, model) -> None:
    """Refuses to run where the port's parameter tree is not the
    reference's leaf for leaf."""
    port = {k: tuple(v.shape)
            for k, v in weights.leaf_paths(model.abstract_params())}
    ref = spec.reference.param_shapes(reference_model(spec))
    if port != ref:
        diff = sorted(set(port.items()) ^ set(ref.items()))
        raise SystemExit(f"{spec.config['name']}: the port's parameter tree "
                         f"differs from the reference's: {diff[:8]}")


class _NoSave:
    """The supervisor's checkpointer with checkpoints off: nothing is
    written, and there is never a checkpoint to restore."""

    def save(self, tree, step, **kw):
        return None

    def wait(self):
        return None

    def latest(self):
        return None

    def shutdown(self):
        return None


class Program:
    """The system under test, built as the train driver builds it."""

    def __init__(self, spec, seed: int, device, paths: List[str],
                 record: Callable):
        from repro_torch.core import CkIO, FileOptions
        from repro_torch.data import CkIOPipeline, FileSet
        from repro_torch.ipc.service import ReaderService, ServiceOptions
        from repro_torch.models import build_model
        from repro_torch.train import (OptConfig, StepSupervisor,
                                       init_opt_state, make_train_step)

        t, r = spec.traffic, spec.traffic["reader"]
        self.dev, self.spec = device, spec
        self.model = build_model(port_config(spec))
        check_layout(spec, self.model)
        self.sessions: List = []
        self.service = None
        self.pipe = None
        self.ckio = CkIO(num_pes=4, pes_per_node=4)
        self.ckio.director.add_observer(self.sessions.append)
        try:
            if r["service"]:
                self.service = ReaderService(ServiceOptions(
                    pool_workers=r["pool_workers"]))
            source = FileSet.build(paths) if len(paths) > 1 else paths[0]
            backend = "process" if r["service"] else r["backend"]
            self.pipe = CkIOPipeline(
                source, t["global_batch"], t["seq_len"], ckio=self.ckio,
                num_consumers=r["num_consumers"],
                file_opts=FileOptions(
                    num_readers=r["num_readers"], backend=backend,
                    max_workers=r["max_workers"],
                    prefault_arena=backend == "process",
                    direct_io=r["direct_io"], queue_depth=r["queue_depth"],
                    use_service=True if r["service"] else None),
                service=self.service, streaming=r["streaming"], device=device)
            self.windows = self.pipe.num_steps
            self.shapes = shape_tree(spec)
            self.rules = spec.config["init"]
            params, self.flat = weights.make(self.shapes, self.rules, seed,
                                             device)
            self.state = {"params": params, "opt": init_opt_state(params)}
        except BaseException:
            self.close()
            raise
        o = t["optimizer"]
        self.b1 = o["b1"]
        step = make_train_step(
            self.model, OptConfig(**o), num_microbatches=t["microbatches"])

        def step_fn(state, batch):
            with torch.profiler.record_function("perfbench.compute"):
                p, opt, metrics = step(state["params"], state["opt"], batch)
            return {"params": p, "opt": opt}, metrics

        self.sup = StepSupervisor(step_fn, _NoSave(), ckpt_every=1 << 62)
        self.record = record
        self.loss: Optional[float] = None
        self.step_no = 0

    def _batch(self, step: int):
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench.input"):
            x, y = self.pipe.get_batch_device(step % self.windows)
        self.record(step, x, y, time.perf_counter() - t0)
        return {"tokens": x, "labels": y}

    def _on_metrics(self, step: int, m: Dict) -> None:
        with torch.profiler.record_function("perfbench.loss_read"):
            self.loss = float(m["loss"])

    def step(self) -> float:
        """One whole step, timed from the batch fetch to the loss read."""
        s = self.step_no
        t0 = time.perf_counter()
        with torch.profiler.record_function("perfbench.step"):
            self.state = self.sup.run(self.state, self._batch, s + 1,
                                      start_step=s,
                                      on_metrics=self._on_metrics)
        dt = time.perf_counter() - t0
        self.step_no += 1
        return dt

    def leaf_norms(self, tree, scale: float = 1.0) -> Dict[str, float]:
        return {k: float(v.norm()) * scale for k, v in weights.leaf_paths(tree)}

    def change_norms(self, seed: int) -> Dict[str, float]:
        """Each leaf's change since the weights were made (made again from
        the seed)."""
        start, flat = weights.make(self.shapes, self.rules, seed, self.dev)
        now = dict(weights.leaf_paths(self.state["params"]))
        out = {k: float((now[k] - v).norm())
               for k, v in weights.leaf_paths(start)}
        del start, flat
        return out

    def close(self) -> None:
        try:
            if self.pipe is not None:
                self.pipe.close()
        finally:
            self.pipe = None
            if self.service is not None:
                self.service.shutdown()
                self.service = None


# -- one run ------------------------------------------------------------------
def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def forbidden_loaded() -> List[str]:
    """Top-level names of JAX and of the JAX package that this process has
    loaded (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in sys.modules
                   if n.split(".")[0] in FORBIDDEN})


def _fs_type(path: str) -> str:
    path = os.path.realpath(path)
    best, kind = "", "unknown"
    try:
        with open("/proc/mounts") as f:
            for line in f:
                _, mnt, typ = line.split()[:3]
                if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                        and len(mnt) > len(best):
                    best, kind = mnt, typ
    except OSError:
        pass
    return f"{kind} at {best or '?'}"


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def run(cell: str, seed: int, seconds: float, trace: bool, *, device="cuda",
        root: str = REPO, t_start: Optional[float] = None) -> Dict:
    """One run; returns the result line's object, ``checks`` last."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(cell, root)
    dev = torch.device(device)
    t = spec.traffic
    corpus_dir = os.path.join(root, "build", "perfbench", "corpus", cell)
    tokens = traffic_gen.make_tokens(
        t, spec.config["model"]["widths"]["vocab_size"], seed)
    paths = traffic_gen.write(corpus_dir, tokens, t["shards"])
    on_disk = traffic_gen.read_back(paths)
    if not np.array_equal(on_disk, tokens):
        raise RuntimeError("the corpus read back differs from what was written")
    del tokens
    if t["reader"]["direct_io"]:
        log(f"corpus: {len(paths)} files on {_fs_type(corpus_dir)}, "
            f"O_DIRECT, block {os.statvfs(corpus_dir).f_bsize} B")
    batches: Dict[int, tuple] = {}
    input_s: Dict[int, float] = {}

    def record(step, x, y, dt):
        batches[step] = (x, y)
        input_s[step] = dt

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prog = Program(spec, seed, dev, paths, record)
    try:
        out = _drive(spec, prog, seed, seconds, trace, dev, t_start, input_s)
    finally:
        prog.close()
    # -- after the window: every batch against the corpus, then the reference
    windows = prog.windows
    wrong_by_step = {}
    for step, (x, y) in batches.items():
        want_x, want_y = traffic_gen.expected_batch(on_disk, t, step % windows)
        wrong_by_step[step] = int((x.cpu().numpy() != want_x).sum()
                                  + (y.cpu().numpy() != want_y).sum())
    del batches, prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = reference_run(spec, seed, dev, on_disk, "fp32")
    log(f"reference: {spec.compared_steps} steps in "
        f"{time.perf_counter() - t_ref:.1f} s"
        + (f"; the process's peak since set-up "
           f"{torch.cuda.max_memory_allocated(dev)} B"
           if dev.type == "cuda" else ""))
    read = compare.readings(out["program"], ref, sum(wrong_by_step.values()))
    ok, checks = compare.judge(read, spec.limits)
    failed = out["failed"] + sum(1 for s in out["window_steps"]
                                 if wrong_by_step[s])
    result = {"correct": bool(ok) and failed == 0,
              "attempted": len(out["window_steps"]), "failed": failed,
              "metrics": out["metrics"], "device": out["device"]}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["where"] = {k: v["at"] for k, v in read.items() if "at" in v}
    result["checks"] = checks
    return result


def _drive(spec, prog: Program, seed: int, seconds: float, trace: bool, dev,
           t_start: float, input_s: Dict[int, float]) -> Dict:
    t = spec.traffic
    # -- set-up: the first steps, which the reference follows ---------------
    losses = []
    for i in range(spec.compared_steps):
        prog.step()
        losses.append(prog.loss)
        if i == 0:
            grad = prog.leaf_norms(prog.state["opt"]["mu"], 1 / (1 - prog.b1))
    change = prog.change_norms(seed)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    failures0 = prog.sup.stats.failures
    # -- the measured window ------------------------------------------------
    n_sessions = len(prog.sessions)
    first = prog.step_no
    step_s: List[float] = []
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        step_s.append(prog.step())
    window_s = time.perf_counter() - w0
    window_steps = list(range(first, prog.step_no))
    slow = sorted(range(len(step_s)), key=step_s.__getitem__)[-3:][::-1]
    log(f"window: {len(step_s)} steps in {window_s:.3f} s; the longest: "
        + ", ".join(f"step {first + i} {step_s[i]:.3f} s (input "
                    f"{input_s[first + i] * 1e3:.1f} ms)" for i in slow))
    window_sessions = prog.sessions[n_sessions:]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = prog.sup.stats.failures - failures0
    # -- the traced steps ---------------------------------------------------
    reading = _profiled_steps(spec, prog, dev) if trace else None
    ctx = SimpleNamespace(
        spec=spec, model=reference_model(spec), traffic=t, hw=spec.hw,
        counts=lambda name: counts_module(spec, name),
        setup_s=setup_s, steps=len(step_s), window_s=window_s,
        step_s=step_s, tokens_per_step=t["global_batch"] * t["seq_len"],
        input_s=[input_s[s] for s in window_steps],
        sessions=window_sessions, trace=reading)
    metrics = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = metric_module(spec, m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(peak)}
    out = {"window_steps": window_steps, "failed": failed,
           "metrics": metrics, "device": device,
           "program": {"loss": losses, "grad_norm": grad, "change": change}}
    if trace:
        device["busy_s"] = reading["busy_s"] if reading else 0.0
        device["window_s"] = reading["window_s"] if reading else 0.0
        if reading:
            out["breakdown"] = reading["breakdown"]
    return out


def _profiled_steps(spec, prog: Program, dev) -> Optional[Dict]:
    """``profiled_steps`` steps (and one before them that the reading
    skips) under ``torch.profiler``, with each per-layer metric's ranges
    put around the program's functions it names."""
    from torch.profiler import ProfilerActivity, profile, record_function

    ranges = []
    for m in spec.per_layer:
        ranges += getattr(metric_module(spec, m["name"]), "RANGES", [])

    def wrap(label, fn):
        def ranged(*a, **kw):
            with record_function(label):
                return fn(*a, **kw)
        return ranged

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    patches = []
    try:
        for label, mod_name, attr in ranges:
            mod = importlib.import_module(mod_name)
            patches.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, wrap(label, getattr(mod, attr)))
        with profile(activities=acts) as prof:
            for _ in range(spec.traffic["profiled_steps"] + 1):
                prog.step()
            _sync(dev)
    finally:
        for mod, attr, orig in patches:
            setattr(mod, attr, orig)
    ex = tracereader.extract(prof, [label for label, _, _ in ranges])
    return tracereader.reduce(ex, skip_steps=1)


# -- the reference ------------------------------------------------------------
def reference_run(spec, seed: int, dev, tokens: np.ndarray,
                  precision: str = "fp32", rows: Optional[Callable] = None
                  ) -> Dict:
    """The configuration's plain reference over the first steps' batches,
    from the weights made again from the seed; ``rows`` as in
    ``reference.model.train``."""
    m = reference_model(spec)
    shapes = shape_tree(spec)
    params, flat = weights.make(shapes, spec.config["init"], seed, dev)
    paths = [k for k, _ in weights.leaf_paths(params)]
    batches = []
    for w in range(spec.compared_steps):
        x, y = traffic_gen.expected_batch(tokens, spec.traffic, w)
        batches.append((torch.as_tensor(x, device=dev),
                        torch.as_tensor(y, device=dev)))
    out = spec.reference.train(params, paths, m, spec.traffic["optimizer"],
                               batches, spec.traffic["microbatches"],
                               precision, rows)
    del params, flat
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return f"card: {out.stdout.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"card: nvidia-smi failed ({e})"
