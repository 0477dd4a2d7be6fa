"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with one CUDA device. The cell, its
configuration, traffic mix and metrics are found by the names in
``BENCHMARK.json`` (``portbench.catalog``). The run:

1. makes the cell's studies on the card from the seed and keeps them in
   pinned host memory, loads the program's kernels (built once into
   ``portbench/_cache``, a fixed directory in the checkout) and runs a few
   studies to warm every shape the cell uses;
2. measures a window of ``--seconds``: the closed loop of ``harness``;
   with ``--trace 1`` it then runs a pass of whole studies under
   torch.profiler (about the traffic mix's ``trace_seconds``), whose trace
   the device's per-layer metrics read (the host's read the window; a
   profiler once started slows the host's later dispatch);
3. reads the device's memory peak, frees the program's state, and holds a
   sample of the window's answers (drawn from the seed) to the plain
   reference (``correct``);
4. prints the compared numbers beside their limits as its last lines on
   standard error, and one JSON line as its last line on standard output.

It exits non-zero and prints no result where CUDA or the devices the cell
asks for are missing, where the program cannot be imported, and where JAX
or the JAX package was loaded into the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# top-level module names that may not be in the process: JAX and the JAX
# package (the port's name begins with the JAX package's, so the whole
# first component is compared)
FORBIDDEN = ("jax", "jaxlib", "flax", "nm03_capstone_project_tpu")


def forbidden_modules(names) -> list:
    """The names whose first dotted component is one of FORBIDDEN."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def point_caches(root: Path = ROOT) -> None:
    """Every build and kernel cache of the program into fixed directories
    of the checkout, so only a cell's first run in a checkout builds."""
    cache = Path(root) / "portbench" / "_cache"
    os.environ["NM03_COMPILE_CACHE_DIR"] = str(cache / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them, or ""."""
    smi = shutil.which("nvidia-smi")
    if not smi:
        return ""
    try:
        return subprocess.run([smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             engine: str = "program", root: Path = ROOT, t_start: float = None,
             log=None):
    """One run of the cell ``name``: ``(result, check_lines)``."""
    import torch

    from portbench import catalog, harness

    log = log or (lambda msg: None)
    t_start = time.perf_counter() if t_start is None else t_start
    cell = catalog.cell(name, root)
    dev = torch.device(device)
    t_import = time.perf_counter() - t_start
    t = time.perf_counter()
    h = harness.Harness(cell, seed, dev, engine)
    t_data = time.perf_counter() - t
    t = time.perf_counter()
    warm, _ = h.drive(studies=harness.WARM_STUDIES, sample=False)
    t_warm = time.perf_counter() - t
    # the interpreter's collector skips what set-up made: a full collection
    # then walks the window's own objects, not every module torch imported
    gc.collect()
    gc.freeze()
    recs, t0 = h.drive(seconds=seconds, sample=True)
    setup_s = t0 - t_start
    cuda = dev.type == "cuda"
    summary = None
    if trace:
        h.warm_profiler()
        rate = len(recs) / seconds
        n = int(min(max(cell["traffic"]["trace_seconds"] * rate, 3), 2000))
        summary = h.traced_pass(n)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    h.release()
    t = time.perf_counter()
    checks = h.check()
    t_check = time.perf_counter() - t
    ok = harness.correct(checks)
    per_s = [0] * max(int(seconds), 1)
    for r in recs:
        if r.came and r.done_ms < len(per_s) * 1e3:
            per_s[int(r.done_ms // 1e3)] += 1
    log(f"setup_s {setup_s:.3f} (imports {t_import:.3f}, data {t_data:.3f}, warm {t_warm:.3f}); "
        f"window {len(recs)} studies, a second {min(per_s)}-{max(per_s)}; check {t_check:.3f} s")

    view = harness.RunView(cell, h.shape, seconds, setup_s, recs, summary)
    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = catalog.reader(root, m["name"])(view)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace and summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    failed = checks["answers_missing"]["value"] + (0 if ok else 1)
    result = {"correct": ok, "attempted": len(recs), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if trace and summary is not None:
        result["breakdown"] = summary.breakdown()
        result["trace_complete"] = summary.complete
        if cuda:
            result["card"] = power_limit()
    result["checks"] = checks
    lines = [f"check {k} {c['value']} {'limit' if 'limit' in c else 'min'} "
             f"{c.get('limit', c.get('min'))}" for k, c in checks.items()]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    point_caches()
    err = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731

    from portbench import catalog

    chips = {w["name"]: w for w in catalog.benchmark()["workloads"]}[args.workload]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"portbench: the cell needs {chips} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import nm03_capstone_project_tpu_torch  # noqa: F401
    except ImportError as e:
        err(f"portbench: the program cannot be imported: {e}")
        return 2
    torch.set_num_threads(2)
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             t_start=T_START, log=err)
    bad = forbidden_modules(sys.modules)
    if bad:
        err("portbench: modules of JAX or the JAX package were loaded: " + ", ".join(bad))
        return 3
    for line in lines:
        err(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
