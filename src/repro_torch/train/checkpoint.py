"""Checkpointing: the packed single-file format ``CKPT-CKIO-v1``, async
save and CkIO-parallel restore.

Save packs a whole tree (nested dicts and lists of tensors, NumPy arrays
and Python ints) into ONE file: a 16-byte magic, the length of a JSON
manifest (leaf name -> dtype, shape, offset), the manifest, zero padding
to a 4096-byte data offset, then the leaves, each at a 128-byte-aligned
offset. The layout is the reference's byte for byte, so that each package
restores the other's files: leaves are named as ``jax.tree_util.keystr``
names them (``['a']['b'][0]``), dict keys flatten in sorted order, a
bfloat16 leaf is written as its 16-bit patterns with dtype ``"bfloat16"``,
and a Python int (the optimizer step) as the int32 scalar the reference
holds. The module is layout-agnostic: the train driver saves the
reference's stacked layout (``models.convert.train_state_to_reference``).

Restore is a CkIO workload: one read session over the blob, one consumer
client per leaf. ``AsyncCheckpointer.save`` copies every leaf to host
memory before it returns, then a worker thread writes the file, so the
training loop runs on; the copy matters because the optimizer updates
params and moments in place. ``load_into`` writes a restored tree's values
into the live tensors, so that a restore needs no second copy of the state
on the device; ``restore_sharded`` places each leaf onto a
``launch.sharding.NamedSharding``, this rank's block alone.
"""
from __future__ import annotations

import ast
import json
import os
import queue
import re
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import CkIO, FileOptions
from repro_torch.core.director import suggest_num_readers

MAGIC = b"CKPT-CKIO-v1\x00\x00\x00\x00"
ALIGN = 4096          # data offset
LEAF_ALIGN = 128      # each leaf's offset in the blob


def _leaf_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in ``jax.tree_util`` flattening order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """A tree of ``like``'s structure whose leaves are taken, in order,
    from ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


_NAME_KEY = re.compile(r"\[('(?:[^'\\]|\\.)*'|\"(?:[^\"\\]|\\.)*\"|\d+)\]")


def _tree_from_names(pairs: List[Tuple[str, Any]]) -> Any:
    """The tree whose ``_leaf_paths`` are ``pairs``: a string key makes a
    dict, an index a list. A subtree without leaves (an empty list) has no
    name, so it is absent."""
    root: Dict[Any, Any] = {}
    for name, leaf in pairs:
        keys = [ast.literal_eval(k) for k in _NAME_KEY.findall(name)]
        if not keys:
            return leaf
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(isinstance(k, int) for k in node):
            return [listify(node[i]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _host(leaf: Any) -> Tuple[str, np.ndarray]:
    """``(dtype name, host array of the leaf's bytes)``; may share the
    leaf's storage."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        a = t.numpy()
        return str(a.dtype), a
    if isinstance(leaf, np.ndarray):
        return str(leaf.dtype), leaf
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return "int32", np.asarray(leaf, dtype=np.int32)
    raise TypeError(f"checkpoint leaf of type {type(leaf).__name__}: "
                    f"expected a tensor, an array or an int")


def _snapshot(leaf: Any) -> Any:
    """A host copy of ``leaf`` that nothing else writes."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def host_copy(tree: Any) -> Any:
    """``tree`` with every leaf copied to host memory."""
    return _unflatten(tree, (_snapshot(x) for _, x in _leaf_paths(tree)))


def load_into(tree: Any, into: Any) -> Any:
    """A tree of ``into``'s structure holding ``tree``'s values: each tensor
    leaf of ``into`` is overwritten in place with the leaf of ``tree`` of
    the same name (shape and dtype must match); an int leaf takes the
    value as an int. Nothing of ``into`` but its structure, shapes and
    dtypes is read."""
    src = dict(_leaf_paths(tree))
    new = []
    for name, leaf in _leaf_paths(into):
        if name not in src:
            raise KeyError(f"restored tree has no leaf {name}")
        got = src[name]
        if isinstance(leaf, torch.Tensor):
            got = torch.as_tensor(got)
            if got.shape != leaf.shape or got.dtype != leaf.dtype:
                raise ValueError(f"leaf {name} is {got.dtype} "
                                 f"{tuple(got.shape)}, expected {leaf.dtype} "
                                 f"{tuple(leaf.shape)}")
            got = leaf.copy_(got)
        elif isinstance(leaf, int):
            got = int(got)
        new.append(got)
    return _unflatten(into, iter(new))


def save_checkpoint(path: str, tree: Any, step: int) -> Dict[str, Any]:
    """Synchronous packed save. Returns the manifest."""
    pairs = _leaf_paths(tree)
    hosts = [_host(x) for _, x in pairs]
    entries = []
    offset = 0
    for (name, _), (dtype, a) in zip(pairs, hosts):
        entries.append({
            "name": name,
            "dtype": dtype,
            "shape": list(a.shape),
            "offset": offset,
            "nbytes": a.nbytes,
        })
        offset += a.nbytes
        offset = (offset + LEAF_ALIGN - 1) // LEAF_ALIGN * LEAF_ALIGN
    manifest = {"step": step, "total_bytes": offset, "leaves": entries}
    blob_head = json.dumps(manifest).encode()
    head_len = 16 + 8 + len(blob_head)
    data_off = (head_len + ALIGN - 1) // ALIGN * ALIGN
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(len(blob_head).to_bytes(8, "little"))
        f.write(blob_head)
        f.write(b"\x00" * (data_off - head_len))
        for e, (_, a) in zip(entries, hosts):
            f.seek(data_off + e["offset"])
            f.write(np.ascontiguousarray(a).reshape(-1).view(np.uint8))
        # Pad the tail to the aligned total, so that a read session over
        # [data_off, data_off + total_bytes) never crosses EOF; only when
        # the aligned total ends past the last leaf (else the pad byte
        # would overwrite data).
        end_data = data_off + (
            entries[-1]["offset"] + entries[-1]["nbytes"] if entries else 0)
        if data_off + offset > end_data:
            f.seek(data_off + offset - 1)
            f.write(b"\x00")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    manifest["data_offset"] = data_off
    return manifest


def read_manifest(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        magic = f.read(16)
        if magic != MAGIC:
            raise ValueError(f"{path}: bad checkpoint magic")
        n = int.from_bytes(f.read(8), "little")
        manifest = json.loads(f.read(n))
    head_len = 16 + 8 + n
    manifest["data_offset"] = (head_len + ALIGN - 1) // ALIGN * ALIGN
    return manifest


def _decode(raw: np.ndarray, dtype: str, shape: List[int]) -> torch.Tensor:
    """A CPU tensor over the bytes of ``raw`` (uint8, not copied)."""
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16).reshape(shape)
    return torch.from_numpy(raw.view(np.dtype(dtype))).reshape(shape)


def restore_arrays(
    path: str,
    *,
    use_ckio: bool = True,
    num_readers: Optional[int] = None,
    num_pes: int = 4,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """Read every leaf into a CPU tensor, by name. The CkIO path reads the
    blob through one session with one over-decomposed consumer per leaf.
    The returned manifest gains ``"read"``: bytes, readers (0 without
    CkIO) and seconds of the read."""
    manifest = read_manifest(path)
    data_off = manifest["data_offset"]
    total = manifest["total_bytes"]
    bufs = {e["name"]: np.empty(e["nbytes"], dtype=np.uint8)
            for e in manifest["leaves"]}
    t0 = time.perf_counter()
    readers = 0
    if not use_ckio:
        with open(path, "rb") as f:
            for e in manifest["leaves"]:
                f.seek(data_off + e["offset"])
                if f.readinto(bufs[e["name"]]) != e["nbytes"]:
                    raise ValueError(f"{path}: leaf {e['name']} is truncated")
    elif total:
        ck = CkIO(num_pes=num_pes)
        readers = num_readers or suggest_num_readers(total, num_pes, 1)
        fh = ck.open_sync(path, FileOptions(num_readers=readers))
        sess = ck.start_read_session_sync(fh, total, data_off)
        try:
            futs = [
                ck.read_future(sess, e["nbytes"], data_off + e["offset"],
                               data=bufs[e["name"]],
                               client=ck.make_client(pe=i % num_pes))
                for i, e in enumerate(manifest["leaves"]) if e["nbytes"]]
            for f in futs:
                f.wait(ck.sched, timeout=600)
        finally:
            ck.close_read_session_sync(sess)
            ck.close_sync(fh)
    manifest["read"] = {"bytes": total, "readers": readers,
                        "seconds": time.perf_counter() - t0}
    out = {e["name"]: _decode(bufs[e["name"]], e["dtype"], e["shape"])
           for e in manifest["leaves"]}
    return out, manifest


def _restore_leaves(path: str, like: Any, **kw
                    ) -> Tuple[List[Tuple[str, Any]], List[Any], int]:
    """``like``'s ``(name, leaf)`` pairs, the file's values for them (a
    tensor leaf gives a CPU tensor, checked against its shape and dtype; an
    int leaf an int) and the step."""
    arrays, manifest = restore_arrays(path, **kw)
    pairs = _leaf_paths(like)
    missing = [n for n, _ in pairs if n not in arrays]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]} ...")
    new = []
    for name, leaf in pairs:
        got = arrays[name]
        if isinstance(leaf, torch.Tensor):
            if got.shape != leaf.shape or got.dtype != leaf.dtype:
                raise ValueError(f"{path}: leaf {name} is {got.dtype} "
                                 f"{tuple(got.shape)}, expected {leaf.dtype} "
                                 f"{tuple(leaf.shape)}")
        elif isinstance(leaf, int):
            got = int(got)
        new.append(got)
    return pairs, new, manifest["step"]


def restore_tree(path: str, like: Any = None, **kw) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (names must match). A tensor
    leaf of ``like`` gives a tensor of the file's values on its device (its
    shape and dtype must match); an int leaf gives an int; an array leaf a
    CPU tensor. Nothing of ``like`` but its structure, devices, shapes and
    dtypes is read. Without ``like``, the structure comes from the file's
    leaf names and every leaf is a CPU tensor."""
    if like is None:
        arrays, manifest = restore_arrays(path, **kw)
        return _tree_from_names(list(arrays.items())), manifest["step"]
    pairs, new, step = _restore_leaves(path, like, **kw)
    new = [got.to(leaf.device) if isinstance(leaf, torch.Tensor) else got
           for (_, leaf), got in zip(pairs, new)]
    return _unflatten(like, iter(new)), step


def restore_sharded(path: str, like: Any, shardings: Any, **kw
                    ) -> Tuple[Any, int]:
    """Elastic restore: ``restore_tree``, then each tensor leaf placed onto
    its sharding (``shardings`` has ``like``'s structure; a leaf is a
    ``launch.sharding.NamedSharding`` or None). None gives a plain tensor
    on the like leaf's device; a sharding gives a global DTensor of which
    this rank's block alone is copied to its device, from the host copy
    the restore read (no full copy on the device). A ``shardings`` tree of
    another structure than ``like``'s raises ``ValueError`` naming the first
    leaf where they part, before anything is read."""
    names = [n for n, _ in _leaf_paths(like)]
    placements = _leaf_paths(shardings)
    for i, want in enumerate(names):
        got = placements[i][0] if i < len(placements) else None
        if got != want:
            raise ValueError(f"restore_sharded: shardings do not have like's "
                             f"structure: like's leaf {i} is {want}, "
                             f"shardings' is {got}")
    if len(placements) > len(names):
        raise ValueError(f"restore_sharded: shardings do not have like's "
                         f"structure: {len(placements)} leaves for "
                         f"{len(names)}, the first extra {placements[len(names)][0]}")
    pairs, new, step = _restore_leaves(path, like, **kw)
    out = []
    for (_, leaf), (_, sh), got in zip(pairs, placements, new):
        if isinstance(leaf, torch.Tensor):
            got = got.to(leaf.device) if sh is None else sh.put(got)
        out.append(got)
    return _unflatten(like, iter(out)), step


class AsyncCheckpointer:
    """Background-thread checkpoint writer with retention. ``records``
    holds one dict per written checkpoint: step, bytes, and the seconds of
    the host snapshot (on the caller's thread) and of the write."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._errors: List[BaseException] = []
        self.records: List[Dict[str, float]] = []
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def path_for(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}.ckpt")

    def save(self, tree: Any, step: int, *,
             to_host: Callable[[Any], Any] = host_copy) -> None:
        """Copy ``tree`` to host memory through ``to_host``, then write it
        asynchronously. ``to_host`` must return host copies that nothing
        else writes (``models.convert.train_state_to_reference`` gives
        them in the reference's layout); its time is the record's
        ``snapshot_s``."""
        t0 = time.perf_counter()
        snap = to_host(tree)
        self._q.put((snap, step, time.perf_counter() - t0))

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            snap, step, snapshot_s = item
            try:
                t0 = time.perf_counter()
                manifest = save_checkpoint(self.path_for(step), snap, step)
                self.records.append({
                    "step": step, "bytes": manifest["total_bytes"],
                    "snapshot_s": snapshot_s,
                    "write_s": time.perf_counter() - t0})
                self._gc()
            except BaseException as e:  # surfaced by wait()
                self._errors.append(e)
            finally:
                del item, snap      # free the host copy before waiting again
                self._q.task_done()

    def _gc(self) -> None:
        ckpts = sorted(self.list_steps())
        for s in ckpts[: -self.keep] if self.keep > 0 else []:
            try:
                os.remove(self.path_for(s))
            except OSError:
                pass

    def list_steps(self) -> List[int]:
        out = []
        for fn in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)\.ckpt", fn)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest(self) -> Optional[str]:
        steps = self.list_steps()
        return self.path_for(steps[-1]) if steps else None

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def shutdown(self) -> None:
        self._q.join()
        self._q.put(None)
        self._thread.join(timeout=10)
