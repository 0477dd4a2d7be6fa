#!/usr/bin/env python3
"""The one-lane volume gang's program, three ways, on the card.

    python scripts/torch_gang_program_ab.py [--studies 20] [--rounds 3]

Run from the repository root on a machine with an NVIDIA GPU and the CUDA
toolkit. Each study is a 25-plane 256 x 256 phantom padded with zero
planes to the gang's 32-plane bucket, as the served cohort is. The script
times, per study, staging on the card through the mask back on the host
(the gang's one sync), for:

* ``process_volume`` — ``pipeline.process_volume`` on the dilate schedule,
  the one-lane gang's program before the gang ran the z-sharded program;
* ``ring1`` — ``serving.volumes.gang_program`` on one slab: the z-sharded
  program over a ring of one, which dilates its block alone;
* ``ring1_halo`` — the same with the ring's halo exchange forced on (zero
  planes padded and concatenated around the block at every step).

The variants run in turns (A B C ... C B A) so that drift on a shared host
falls on all of them alike; every mask must equal ``process_volume``'s.
Prints one JSON line per variant and one summary line, each with the
card's name and power limit. Nothing here is used by the port.
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
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume  # noqa: E402
from nm03_capstone_project_tpu_torch.parallel import zshard  # noqa: E402
from nm03_capstone_project_tpu_torch.pipeline import process_volume  # noqa: E402
from nm03_capstone_project_tpu_torch.serving.volumes import gang_program  # noqa: E402

DEPTH, BUCKET, SIZE = 25, 32, 256


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--studies", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = PipelineConfig(canvas=SIZE, grow_algorithm="dilate")
    studies = []
    for seed in range(args.studies):
        vol = np.zeros((BUCKET, SIZE, SIZE), np.float32)
        vol[:DEPTH] = phantom_volume(DEPTH, SIZE, SIZE, seed=seed)
        studies.append(vol)
    dims = np.asarray([SIZE, SIZE], np.int32)
    real_ring = zshard._ring

    def halo_ring(mesh, devices):
        ring = real_ring(mesh, devices)
        ring.alone = False
        return ring

    def run(which, vol):
        px = torch.from_numpy(vol).to(dev, non_blocking=False)
        dm = torch.from_numpy(dims).to(dev)
        if which == "process_volume":
            out = process_volume(px, dm, cfg)
            return out["mask"].cpu().numpy(), bool(out["grow_converged"])
        zshard._ring = halo_ring if which == "ring1_halo" else real_ring
        try:
            out = gang_program([px], dm, cfg)
        finally:
            zshard._ring = real_ring
        return out["mask"][0].cpu().numpy(), bool(out["grow_converged"])

    variants = ["process_volume", "ring1", "ring1_halo"]
    want = [run("process_volume", v) for v in studies]  # also the warmup
    for which in variants[1:]:
        for v, (m, c) in zip(studies, want):
            got = run(which, v)
            if not (np.array_equal(got[0], m) and got[1] == c):
                print(f"{which}: the mask differs from process_volume's", file=sys.stderr)
                return 1
    ms = {w: [] for w in variants}
    order = variants + variants[::-1]
    for _ in range(args.rounds):
        for which in order:
            for v in studies:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(which, v)
                ms[which].append((time.perf_counter() - t0) * 1e3)
    card = smi()
    for which in variants:
        xs = ms[which]
        print(json.dumps({"variant": which, "studies": len(xs), "p50_ms": statistics.median(xs),
                          "mean_ms": statistics.fmean(xs), "min_ms": min(xs),
                          "volumes_per_s": 1e3 / statistics.fmean(xs), "nvidia_smi": card}))
    base = statistics.median(ms["process_volume"])
    print(json.dumps({"ratio_p50_to_process_volume": {
        w: statistics.median(ms[w]) / base for w in variants[1:]}, "nvidia_smi": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
