"""Read a cell's compared numbers on many seeds in one process.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 3]

Each seed runs the cell as ``portbench.run`` does, with a short window at
the cell's own load: first with the program (the sound runs whose largest
reading is a limit's lower end), then with the control in the program's
place (the plain reference in bfloat16, one precision below the
configuration's float32, whose smallest reading is a limit's upper end).
Set-up is paid once. One JSON line a run: the seed, the engine, ``correct``
and each compared number; then a summary line of both ends per number.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run.point_caches()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    readings = {"program": {}, "control": {}}
    plan = [("program", s) for s in args.seeds.split(",") if s] + [
        ("control", s) for s in args.control_seeds.split(",") if s]
    for engine, seed in plan:
        result, _ = run.run_cell(args.workload, int(seed), args.seconds, False,
                                 device=args.device, engine=engine)
        checks = result["checks"]
        print(json.dumps({"engine": engine, "seed": int(seed), "correct": result["correct"],
                          "attempted": result["attempted"], "checks": checks}), flush=True)
        for name, c in checks.items():
            readings[engine].setdefault(name, []).append(c["value"])
    summary = {"workload": args.workload, "seconds": args.seconds,
               "lower": {k: max(v) for k, v in readings["program"].items()},
               "upper": {k: min(v) for k, v in readings["control"].items()}}
    print(json.dumps({"summary": summary}), flush=True)
    bad = run.forbidden_modules(sys.modules)
    if bad:
        print("portbench.calibrate: JAX modules loaded: " + ", ".join(bad), file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
