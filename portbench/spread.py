"""Run a cell several times, one process after another, and read the spread.

    python3 -m portbench.spread --workload <name> --seeds 11,12,13 [--sets 2]
        [--seconds S] [--trace 0|1] [--out results.jsonl]

Each run is ``python3 -m portbench.run`` in a fresh process, as a check
runs it; the runs of one set take the seeds in the order given, and every
set takes the same seeds. For each metric and set it prints the median
and the spread: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median, which is
what a metric's bound is set from. ``--seconds`` defaults to the
benchmark's ``run_seconds``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

from portbench import catalog


def run_once(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True, cwd=catalog.ROOT)
    rec = {"seed": seed, "rc": p.returncode, "wall_s": time.perf_counter() - t,
           "stderr": p.stderr[-1500:]}
    lines = p.stdout.strip().splitlines()
    if p.returncode == 0 and lines:
        rec["result"] = json.loads(lines[-1])
    return rec


def spread(values) -> dict:
    values = list(values)
    med = statistics.median(values)
    if len(values) < 2:
        return {"median": med, "spread": None, "n": len(values)}
    q1, _, q3 = statistics.quantiles(values, n=4)
    return {"median": med, "spread": (q3 - q1) / med if med else None, "n": len(values),
            "min": min(values), "max": max(values)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None, help="append each run's record here (JSON lines)")
    args = ap.parse_args(argv)
    seconds = args.seconds or catalog.benchmark()["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    by_set = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            rec = dict(run_once(args.workload, seed, seconds, args.trace), set=k,
                       workload=args.workload, seconds=seconds, trace=args.trace)
            runs.append(rec)
            line = json.dumps(rec)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        by_set.append(runs)
    summary = {"workload": args.workload, "seconds": seconds, "trace": args.trace, "sets": []}
    for runs in by_set:
        ok = [r["result"] for r in runs if "result" in r]
        names = sorted({m for r in ok for m in r["metrics"]})
        summary["sets"].append({
            "runs": len(runs), "results": len(ok), "correct": sum(r["correct"] for r in ok),
            "metrics": {m: spread(r["metrics"][m]["value"] for r in ok if m in r["metrics"])
                        for m in names}})
    print(json.dumps({"summary": summary}), flush=True)
    return 0 if all("result" in r for runs in by_set for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())
