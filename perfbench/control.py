"""Readings that set the upper ends of a cell's limits (not run by the
benchmark's own runs).

For each seed, the plain reference's first steps at the cell's own size
are compared, as the benchmark compares the program's, with three runs put
in the program's place:

* ``control``: the reference with every matmul's operands in float8 e4m3,
  the precision below the bf16 the configurations compute in;
* ``half_batch``: the reference with half of each microbatch's rows left
  out and the loss's mean taken over the rest;
* a step that leaves the state unchanged reads ``param_change_gap`` = 1 by
  the measure itself and needs no run.

  python3 perfbench/control.py --workload <cell> --seeds 11 12 13

Prints one JSON line a seed and reading; with ``--out`` also appends them
to that file.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def readings(cell: str, seed: int, device: str, root: str = REPO):
    import torch

    import compare
    import harness
    import traffic as traffic_gen

    spec = harness.load_spec(cell, root)
    dev = torch.device(device)
    tokens = traffic_gen.make_tokens(
        spec.traffic, spec.config["model"]["widths"]["vocab_size"], seed)
    t0 = time.perf_counter()
    ref = harness.reference_run(spec, seed, dev, tokens, "fp32")
    ref_s = time.perf_counter() - t0

    def half(t, l):
        return t[:t.shape[0] // 2], l[:l.shape[0] // 2]

    out = []
    for name, kw in (("control", {"precision": "fp8"}),
                     ("half_batch", {"rows": half})):
        run = harness.reference_run(spec, seed, dev, tokens, **kw)
        read = compare.readings(run, ref, 0)
        out.append({"cell": cell, "seed": seed, "run": name,
                    "reference_s": ref_s, "losses": run["loss"],
                    "reference_losses": ref["loss"],
                    **{k: v["value"] for k, v in read.items()},
                    "where": {k: v.get("at") for k, v in read.items()}})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [HERE, os.path.join(REPO, "src")]
    for seed in args.seeds:
        for line in readings(args.workload, seed, args.device):
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
