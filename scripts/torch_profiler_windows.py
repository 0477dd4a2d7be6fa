#!/usr/bin/env python3
"""How often a torch.profiler window misses the port's kernels on the card.

    python scripts/torch_profiler_windows.py [--windows 10] [--repeats 5] [--launches N]

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit. ``chip_smoke.py`` takes each kernel's own device time from one
profiler window of ``repeats`` wrapper calls, and holds the window to
``repeats`` launches of the kernel by name. This script opens
``--windows`` such windows for each kernel and route, in turns, at the
shapes ``chip_smoke.py`` times them:

* ``band_kernel``, ``fused_kernel``, ``grow_kernel``: the main path's
  25 x 256 x 256 phantoms;
* ``select_kernel``: the median at k = 17 on that batch's median input;
* ``wide_kernel``: the median at k = 65 on a (2, 256, 256) batch;
* ``grow_global_kernel``: two phantoms at 4096 x 4096.

Each window records the CUDA activity alone, as
``chip_smoke.py::device_ms`` opens its windows. With ``--launches N`` one
window opens first, then N small kernels launch outside any window (as
the plain references of ``chip_smoke.py`` launch millions between its
windows), then the windows run. A window misses when its records of the
kernel are not ``repeats`` while the wrapper's own counter saw every
launch; for a missed window the script keeps the device events it did
see, by name.

Prints one JSON line per kernel (windows, misses, what each missed window
saw, the median and spread of the device ms of the full windows) and one
summary line, each with the card's name and power limit. Nothing here is
used by the port.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nm03_capstone_project_tpu_torch.config import PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.core import pad_to_canvas, valid_mask  # noqa: E402
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice  # noqa: E402
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm  # noqa: E402
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg  # noqa: E402
from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize  # noqa: E402
from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges  # noqa: E402
from nm03_capstone_project_tpu_torch.ops.seeds import seed_mask  # noqa: E402

SLICES, SIZE = 25, 256
MARGIN_S = 0.05  # each window held open this long on both sides of its calls


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def window(fn, wrapper, kernel: str, repeats: int):
    """One profiler window of ``repeats`` calls: (records of the kernel,
    device ms a launch, what the window saw)."""
    from torch.profiler import ProfilerActivity, profile

    before = wrapper.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(MARGIN_S)
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    if wrapper.launches - before != repeats:
        raise RuntimeError(f"{kernel}: the wrapper launched {wrapper.launches - before} times")
    hits = [e for e in prof.key_averages() if kernel in e.key]
    calls = sum(e.count for e in hits)
    ms = sum(e.self_device_time_total for e in hits) / calls / 1e3 if calls else None
    seen = {}
    if calls != repeats:
        for e in prof.key_averages():
            if e.self_device_time_total > 0:
                seen[e.key[:60]] = e.count
    return calls, ms, seen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--launches", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig(canvas=SIZE)
    rng = np.random.default_rng(0)
    hw = [(SIZE, SIZE) if i % 2 else (int(rng.integers(180, SIZE)), int(rng.integers(180, SIZE)))
          for i in range(SLICES)]
    bt = pad_to_canvas([phantom_slice(h, w, seed=i, lesion_radius=0.12)
                        for i, (h, w) in enumerate(hw)], (SIZE, SIZE), device=dev)
    x = extend_edges(bt.pixels, bt.dims)
    pre_kw = dict(
        norm_low=cfg.norm_low, norm_high=cfg.norm_high,
        norm_min=cfg.norm_intensity_min, norm_max=cfg.norm_intensity_max,
        clip_low=cfg.clip_low, clip_high=cfg.clip_high,
        median_window=cfg.median_window, sharpen_gain=cfg.sharpen_gain,
        sharpen_sigma=cfg.sharpen_sigma, sharpen_kernel=cfg.sharpen_kernel,
    )
    med_x = clip_intensity(normalize(x), cfg.clip_low, cfg.clip_high)
    img = hm.fused_preprocess_kernel(x, **pre_kw)
    seeds = seed_mask(bt.dims, (SIZE, SIZE))
    valid = valid_mask(bt.dims, (SIZE, SIZE))
    gkw = dict(valid=valid, block_iters=cfg.grow_block_iters, max_iters=cfg.grow_max_iters)
    gen = torch.Generator(device="cuda").manual_seed(1)
    wide_x = torch.rand((2, SIZE, SIZE), generator=gen, device=dev) * 4000 + 0.68
    big = 4096
    bb = pad_to_canvas([phantom_slice(big, big, seed=10, lesion_radius=0.12),
                        phantom_slice(big - big // 8, big - big // 5, seed=11,
                                      lesion_radius=0.12)], (big, big), device=dev)
    big_img = hm._fused_preprocess_plain(extend_edges(bb.pixels, bb.dims), **pre_kw)
    big_seeds, big_valid = seed_mask(bb.dims, (big, big)), valid_mask(bb.dims, (big, big))
    bkw = dict(valid=big_valid, block_iters=cfg.grow_block_iters, max_iters=cfg.grow_max_iters)
    kernels = {
        "band_kernel": (lambda: hm.vector_median_filter_kernel(med_x, 7),
                        hm.vector_median_filter_kernel),
        "fused_kernel": (lambda: hm.fused_preprocess_kernel(x, **pre_kw),
                         hm.fused_preprocess_kernel),
        "grow_kernel": (lambda: hg.region_grow_kernel(img, seeds, cfg.grow_low, cfg.grow_high,
                                                      **gkw), hg.region_grow_kernel),
        "select_kernel": (lambda: hm.vector_median_filter_kernel(med_x, 17),
                          hm.vector_median_select_kernel),
        "wide_kernel": (lambda: hm.vector_median_filter_kernel(wide_x, 65),
                        hm.vector_median_wide_kernel),
        "grow_global_kernel": (lambda: hg.region_grow_kernel(
            big_img, big_seeds, cfg.grow_low, cfg.grow_high, **bkw),
            hg.region_grow_global_kernel),
    }
    for fn, _ in kernels.values():
        fn()
    torch.cuda.synchronize()
    if args.launches:
        fn, wrapper = kernels["band_kernel"]
        window(fn, wrapper, "band_kernel", args.repeats)
        a, b = torch.zeros(1, device=dev), torch.ones(1, device=dev)
        for _ in range(args.launches):
            a = torch.minimum(a, b)
        torch.cuda.synchronize()

    seen = {k: [] for k in kernels}
    missed_seen = {k: [] for k in kernels}
    times = {k: [] for k in kernels}
    for _ in range(args.windows):
        for kernel, (fn, wrapper) in kernels.items():
            fn()
            torch.cuda.synchronize()
            calls, ms, what = window(fn, wrapper, kernel, args.repeats)
            seen[kernel].append(calls)
            if calls == args.repeats:
                times[kernel].append(ms)
            else:
                missed_seen[kernel].append(what)
    card = smi()
    total = 0
    for kernel, counts in seen.items():
        missed = [c for c in counts if c != args.repeats]
        total += len(missed)
        t = times[kernel]
        print(json.dumps({
            "kernel": kernel, "windows": args.windows, "repeats": args.repeats,
            "launches": args.launches, "misses": len(missed), "missed_counts": missed,
            "missed_saw": missed_seen[kernel][:3],
            "device_ms_p50": statistics.median(t) if t else None,
            "device_ms_min": min(t) if t else None, "device_ms_max": max(t) if t else None,
            "nvidia_smi": card}), flush=True)
    print(json.dumps({"windows": args.windows * len(seen), "misses": total,
                      "launches": args.launches, "nvidia_smi": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
