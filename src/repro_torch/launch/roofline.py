"""Roofline analysis over dry-run records (``launch/dryrun.py``).

Three terms per (arch × shape × mesh), from the dry run's meta-device
counts:

    compute_s    = hlo_flops (global) / (chips × PEAK_FLOPS)
    memory_s     = hlo_bytes (global) / (chips × HBM_BW)
                   (decode: one pass over one device's arguments, temps and
                   outputs / HBM_BW)
    collective_s = per-device collective bytes / LINK_BW

Hardware: NVIDIA H100 SXM5 (below). The terms are computed from datasheet
constants, not measured: a share of a measured time against ``step_s`` is
a roofline share (``chip_smoke.py``'s ``dryrun`` phase prints the card's).

``hlo_bytes`` is the pre-fusion count (every op's operands and results),
an upper bound on fused HBM traffic. Collective bytes are result bytes a
device of DTensor's functional collectives: an all-reduce counts its
payload once, and a ring all-reduce moves about twice that, so the
collective term is a lower bound within 2× — consistent across runs,
which is what comparing runs needs.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

# NVIDIA H100 SXM5 datasheet (nvidia.com/en-us/data-center/h100):
PEAK_FLOPS = 989e12       # dense BF16 tensor-core FLOP/s (1,979e12 with sparsity)
HBM_BW = 3.35e12          # HBM3 bytes/s
# NDR InfiniBand, 400 Gb/s per GPU (one ConnectX-7 a GPU in a DGX H100).
# Every axis of both production meshes (16 and 2×16) spans more than one
# 8-GPU NVLink node, so the inter-node link sets the collective term.
LINK_BW = 50e9            # bytes/s / GPU
HBM_PER_CHIP = 80e9       # H100 SXM5: 80 GB HBM3


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops: float
    useful_ratio: float          # MODEL_FLOPS / HLO_FLOPS
    step_s: float                # max of the three terms (no-overlap model)
    roofline_frac: float         # compute_s / step_s  ("how close to compute roof")
    hbm_fit: Optional[bool]
    hbm_used_bytes: Optional[int]
    tag: str = ""

    def row(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_ratio": self.useful_ratio, "step_s": self.step_s,
            "roofline_frac": self.roofline_frac, "hbm_fit": self.hbm_fit,
            "tag": self.tag,
        }


def analyze_record(rec: Dict[str, Any]) -> Optional[Roofline]:
    if "error" in rec or rec.get("hlo_flops") in (None, -1.0):
        return None
    chips = rec["chips"]
    flops = float(rec["hlo_flops"])
    coll = rec.get("collectives") or {}
    coll_dev = float(sum(v for k, v in coll.items() if k != "count"))

    compute_s = flops / (chips * PEAK_FLOPS)
    # memory term:
    #  * decode: one pass over resident per-device state (params + caches +
    #    temps + outputs);
    #  * train/prefill: global pre-fusion bytes over every device's HBM.
    if rec.get("kind") == "decode" and "temp_size_in_bytes" in rec:
        resident = (rec.get("argument_size_in_bytes", 0)
                    + rec.get("temp_size_in_bytes", 0)
                    + rec.get("output_size_in_bytes", 0))
        memory_s = resident / HBM_BW
    else:
        memory_s = float(rec.get("hlo_bytes") or 0.0) / (chips * HBM_BW)
    collective_s = coll_dev / LINK_BW

    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=lambda k: terms[k])
    step_s = max(terms.values())

    used = None
    fit = None
    if "temp_size_in_bytes" in rec:
        used = int(rec.get("argument_size_in_bytes", 0)) \
            + int(rec.get("temp_size_in_bytes", 0))
        fit = used <= HBM_PER_CHIP

    mf = float(rec.get("model_flops", 0.0))
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=mf, hlo_flops=flops,
        useful_ratio=(mf / flops) if flops > 0 else 0.0,
        step_s=step_s,
        roofline_frac=(compute_s / step_s) if step_s > 0 else 0.0,
        hbm_fit=fit, hbm_used_bytes=used,
    )


def load_records(path: str) -> List[Dict[str, Any]]:
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    return recs


def latest_by_cell(recs: List[Dict[str, Any]], tag: str = "") -> Dict[tuple, Dict]:
    """Last record per (arch, shape, mesh) with the given tag wins."""
    out: Dict[tuple, Dict] = {}
    for r in recs:
        if r.get("tag", "") != tag:
            continue
        out[(r.get("arch"), r.get("shape"), r.get("mesh"))] = r
    return out


def format_table(rows: List[Roofline]) -> str:
    hdr = (f"{'arch':<20} {'shape':<12} {'mesh':<8} "
           f"{'compute_s':>10} {'memory_s':>10} {'collect_s':>10} "
           f"{'dominant':>10} {'useful':>7} {'roof%':>6} {'fit':>4}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:<20} {r.shape:<12} {r.mesh:<8} "
            f"{r.compute_s:>10.4g} {r.memory_s:>10.4g} {r.collective_s:>10.4g} "
            f"{r.dominant:>10} {r.useful_ratio:>7.2f} "
            f"{100*r.roofline_frac:>5.1f}% "
            f"{'' if r.hbm_fit is None else ('ok' if r.hbm_fit else 'OOM'):>4}"
        )
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--in", dest="inp", default="build/dryrun.jsonl")
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default=None)
    args = ap.parse_args(argv)
    recs = load_records(args.inp)
    cells = latest_by_cell(recs, args.tag)
    rows = []
    for (_, _, mesh), rec in sorted(cells.items()):
        if args.mesh and mesh != args.mesh:
            continue
        r = analyze_record(rec)
        if r:
            rows.append(r)
    print(format_table(rows))


if __name__ == "__main__":
    main()
