"""Runs of one cell as its bounds and limits are set from them: two sets
of runs on the same seeds, then traced runs, each a process of its own.

  python3 perfbench/sets.py --workload <cell> --seeds 1 2 3 4 5 6 \\
      --traced 7 8 9 --seconds 50 --out chiprun_out/sets_<cell>.jsonl

Appends one JSON line a run to ``--out`` (set, seed, exit code, wall
seconds, the result line or null, the end of standard error), then prints
each end-to-end metric's median and quartile spread a set and over both
(``statistics.quantiles``, as a share of the median), the largest reading
of each compared number, and the device's peak. Not run by the benchmark's
own runs. Exits 0 when every run exited 0 and read ``correct``.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def spread(values):
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def one(cell, seed, seconds, trace, label):
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)],
        cwd=REPO, capture_output=True, text=True)
    lines = p.stdout.strip().splitlines()
    result = None
    if p.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return {"set": label, "seed": seed, "trace": trace, "rc": p.returncode,
            "wall_s": time.perf_counter() - t0, "result": result,
            "stderr": p.stderr[-3000:]}


def summary(rows):
    out = []
    sets = sorted({r["set"] for r in rows if r["trace"] == 0})
    for s in sets + ["both"]:
        runs = [r["result"] for r in rows if r["result"] and r["trace"] == 0
                and (s == "both" or r["set"] == s)]
        if len(runs) < 2:
            continue
        for name in runs[0]["metrics"]:
            v = [r["metrics"][name]["value"] for r in runs]
            out.append(f"{s} {name}: median {statistics.median(v)!r} spread "
                       f"{spread(v) * 100:.3f} % over {len(v)} runs")
    done = [r["result"] for r in rows if r["result"]]
    for name in (done[0]["checks"] if done else {}):
        worst = max(r["checks"][name]["value"] for r in done)
        out.append(f"largest {name}: {worst!r} "
                   f"(limit {done[0]['checks'][name]['limit']!r})")
    if done:
        peak = max(r["device"]["memory_peak_bytes"] for r in done)
        out.append(f"memory_peak_bytes: largest {peak}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    ap.add_argument("--sets", default="AB")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    rows = []
    todo = [(s, seed, 0) for s in args.sets for seed in args.seeds]
    todo += [("T", seed, 1) for seed in args.traced]
    for label, seed, trace in todo:
        row = one(args.workload, seed, args.seconds, trace, label)
        rows.append(row)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
        r = row["result"]
        print(f"[{label} {seed}] rc {row['rc']} in {row['wall_s']:.1f} s "
              + (json.dumps({"correct": r["correct"], "metrics": r["metrics"],
                             "checks": r["checks"]}) if r else
                 row["stderr"][-400:]), flush=True)
    for line in summary(rows):
        print(line)
    ok = all(r["rc"] == 0 and r["result"] and r["result"]["correct"]
             for r in rows)
    print("every run exited 0 and read correct" if ok else
          "NOT every run exited 0 and read correct")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
