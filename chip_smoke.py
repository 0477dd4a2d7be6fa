#!/usr/bin/env python3
"""Drive the PyTorch/H100 port on the card, end to end.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit. Phases, each printing one JSON line:

1. ``build`` — compiles the kernels from ``nm03_capstone_project_tpu_torch/
   csrc`` (nvcc, sm_90a, one process per source), reads the card's name and
   power limit, and prints each kernel's registers and spills as ptxas
   reports them, and the fused kernel's min/max a median for each window.
2. ``median``, ``fused``, ``grow`` — each hand-written kernel against its
   plain PyTorch version on the card, at the main path's shape (25, 256,
   256) and at a prime-sized canvas: the median and the fused kernel
   bitwise for every odd window 3..15 (the fused kernel rounds every step
   as the plain ops do), the grow kernel bitwise in mask, per-slice
   converged and steps, with a truncating ``max_iters`` too, and at
   canvases 512, 1024 and 2048; the fused kernel also bitwise over one long
   study of 160 planes at 512 x 512 in one launch (the volume path's
   shape). Each prints the wrapper's and the plain
   version's median time over repeats (CUDA events), the kernel's own
   device time a launch (``device_ms``, torch.profiler's self device time
   by kernel name) and the least time the card could take.
3. ``slice`` — a cohort of 20 patients x 25 slices (the size of the TCIA
   Brain-Tumor-Progression cohort the reference targets) through
   ``process_batch`` in batches of 25, with the kernels and again with the
   plain ops: masks and ``grow_converged`` identical, the first 50 masks
   equal to the golden the JAX package made
   (``nm03_capstone_project_tpu_torch/testdata/smoke_masks.json``), every
   kernel of the path launched. One
   batch with ``fuse_preprocess=False`` drives the standalone median kernel,
   and a batch of phantoms at canvas 1024 goes through ``process_batch``
   with the kernels and with the plain ops, masks equal.
4. ``driver`` — the batch drivers end to end: a synthetic DICOM cohort of
   20 patients x 25 slices at 256 (``data/synthetic.py::
   write_synthetic_cohort``) through ``CohortProcessor(mode="parallel")``:
   decode (the host C++ batch decoder), the pinned copy to the card, the
   fused and grow kernels, host render and JPEG export, manifest. Checks:
   500/500 slices and 1000 JPEG files, a manifest all ``done``, the masks
   equal to ``process_batch`` under the plain ops on the same decoded
   pixels, the first 50 masks and their host renders equal to the golden
   the JAX package made (``testdata/driver_golden.json``), and one patient
   each through ``mode="sequential"``, ``render_stage="device"`` and
   ``fuse_preprocess=False`` (the median kernel) equal to the parallel run
   in masks and JPEG bytes. Then the parallel driver's CLI, ``main()``
   with ``--results-json``, twice with the kernels and twice with
   ``--no-kernels``: a ``driver_throughput`` line with slices/s end to end
   (decode and JPEG export included), the JPEG encoder that ran, the
   kernels' launches and the card's name and power limit.
5. ``serve`` — the single-slice server (``serving/server.py``) on the card,
   in process on 127.0.0.1: warmup captures one CUDA graph per batch bucket
   (1, 2, 4, 8, 16), then the driver phase's 500 DICOM files arrive as
   ``POST /v1/segment`` bodies from 16 client threads (under the profiler:
   the device's idle share), 50 of them again one at a time (bucket 1,
   mask only), and 31 of the smoke cohort's non-square phantoms as raw
   float32 bodies in bursts of 1, 2, 4, 8 and 16. Checks: every answer 200,
   each mask equal to the driver's for the same slice and each JPEG pair
   byte-equal to the driver's files, the phantoms' masks equal to
   ``process_batch`` with the plain ops, every bucket replayed, no kernel
   wrapper run outside a graph, ``If-None-Match`` repeats answered 304 and
   plain repeats from the result tier, and a 503 after ``begin_drain``. A
   second server with ``fuse_preprocess=False`` answers 8 requests, so the
   median kernel launches inside its graphs. The line has the statuses,
   the batch-size histogram (by bucket bound), replays and capture seconds
   per bucket, p50/p99 latency and requests/s at concurrency 16 and 1, the
   idle share, the server's own mean request time and queue wait, one
   slice's DICOM decode and render + encode on the host (median of 20), one
   graph replay against eager ``_process`` per bucket (CUDA events, median
   of 20), the kernels' launches from replays and the card's name and power
   limit.
6. ``volume`` — the 3D volume path: the volume driver's CLI
   (``cli/volume.py``, ``main()`` with ``--export-mhd --results-json``)
   over the driver phase's 20 x 25 DICOM cohort, one volume a patient, in
   turns with the kernels and with ``--no-kernels`` (kernels, plain, plain,
   kernels). Checks: 20/20 patients, 500 planes and 1000 JPEG files a run;
   every mask read back from ``mask.mhd`` equal to the golden the JAX
   package made (``testdata/volume_golden.json``: sha256, voxels,
   ``grow_converged``); masks and JPEG bytes equal between the kernels and
   the plain run; the fused kernel launched once a patient and the grow
   kernel never (the growth is 3D torch ops). The cohort holds two
   distinct masks, so four phantom volumes of other shapes go through
   ``process_volume`` with the kernels, each equal to its entry in the
   golden. One patient each with ``--render-stage device``,
   ``--no-preprocess-fuse`` (the median kernel, once) and
   ``--grow-algorithm jump`` (converged) equals the kernels run. Then a
   long phantom study of 160 x 512 x 512 through ``process_volume`` with
   the kernels (one fused launch) and with the plain ops, masks and
   ``converged`` equal (the ``fused`` phase also holds the kernel bitwise at
   that shape). The line has volumes/s and slices/s (the results JSON's
   ``wall_s``, median over the turns), the ``timings_s`` shares of a
   kernels run, the device's idle share under the profiler for one kernels
   pass, the 3D growth's time, steps and blocks (one host sync a block)
   for the cohort's median patient and for the long study, the launches
   and the card's name and power limit.
7. ``kernels`` — one line, ``{"kernels": [...]}``, per kernel: launches in
   the driver's run (``launches``; the median kernel's from the unfused
   patient), in the ``slice`` phase's (``slice_launches``), by the
   ``serve`` phase's graph replays (``serve_launches``: replays times the
   launches a graph holds) and in the volume driver's run
   (``volume_launches``; the median kernel's from its unfused patient),
   the largest difference from the plain version, its wrapper and device
   time, the plain time and the bound.

The card's ``nvidia-smi`` name and power limit print on a line of their own;
the last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero without that line, as does a machine without CUDA.
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from pathlib import Path

import numpy as np
import torch

# H100 SXM data-sheet peaks (700 W). The 67 TFLOP/s of float32 outside the
# tensor cores counts an FMA as two flops: one add or multiply instruction
# issues at half of it. Min/max, 32-bit bitwise ops and shifts issue at 64
# per SM per clock against 128 float32 lanes (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0): a quarter.
PEAK_F32_FLOPS = 67e12
OP_RATES = {"add_mul": PEAK_F32_FLOPS / 2, "minmax_bitwise": PEAK_F32_FLOPS / 4}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
MAIN_SHAPE = (25, 256, 256)
DRIVER_COHORT = (20, 25, 256)  # patients, slices each, slice size
PRIME_SHAPE = (3, 251, 241)
GROW_CANVASES = (512, 1024, 2048)
WINDOWS = (3, 5, 7, 9, 11, 13, 15)
REPEATS = 20
SERVE_BUCKETS = (1, 2, 4, 8, 16)
SERVE_CONCURRENCY = 16
SERVE_SINGLES = 50  # requests one at a time (bucket 1)
SERVE_BURSTS = (2, 4, 8, 16)  # phantom bursts, one batch each
SERVE_REPEATS = 10  # If-None-Match repeats
LONG_STUDY = (160, 512, 512)  # planes, canvas: one long study in one launch
VOLUME_TURNS = ("kernels", "plain", "plain", "kernels")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, repeats: int = REPEATS) -> float:
    """Median milliseconds of ``fn`` over ``repeats`` runs (CUDA events)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, kernel: str, repeats: int = REPEATS) -> float:
    """The kernel's own device time a launch: torch.profiler's self device
    time of the kernels whose name holds ``kernel``, over ``repeats`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    calls = sum(e.count for e in hits)
    require(calls == repeats, f"profiler saw {calls} launches of {kernel}, not {repeats}")
    return sum(e.self_device_time_total for e in hits) / calls / 1e3


def ptxas_report(log: str) -> dict:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from ptxas -v."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            k = re.search(r"(band_kernel|fused_kernel|grow_kernel)(I(?:Li\d+E)+E)?", m.group(1))
            name = None if k is None else k.group(1) + (
                "<%s>" % ",".join(re.findall(r"\d+", k.group(2))) if k.group(2) else "")
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def bound(bytes_moved: float, ops: dict):
    """Least milliseconds for the work, and whether bytes or ops bound it.

    ``ops`` counts operations by kind of ``OP_RATES``; the kinds issue to
    separate pipes, so the slowest kind bounds the operations.
    """
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = max(n / OP_RATES[kind] * 1e3 for kind, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def files_of(root: Path) -> dict:
    """``{relative path: bytes}`` of the JPEG files under ``root``."""
    return {str(f.relative_to(root)): f.read_bytes() for f in sorted(root.rglob("*.jpg"))}


def driver_phase(tmp: Path, smi: str, kernels: dict, reset):
    """The batch drivers end to end on the card (phase 4 of the docstring).

    Returns the launches of the parallel run (the median kernel's from the
    unfused patient) and what the ``serve`` phase holds its answers to: the
    cohort's directory and, by (patient, stem), the parallel run's masks
    and JPEG pairs.
    """
    from nm03_capstone_project_tpu_torch import native
    from nm03_capstone_project_tpu_torch.cli import parallel as parallel_cli
    from nm03_capstone_project_tpu_torch.cli.runner import CohortProcessor
    from nm03_capstone_project_tpu_torch.config import BatchConfig, PipelineConfig
    from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom
    from nm03_capstone_project_tpu_torch.data.discovery import (
        find_patient_dirs,
        load_dicom_files_for_patient,
    )
    from nm03_capstone_project_tpu_torch.data.synthetic import write_synthetic_cohort
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.pipeline import process_batch
    from nm03_capstone_project_tpu_torch.render.export import encode_jpeg_bytes, jpeg_encoder

    n_pat, n_sl, size = DRIVER_COHORT
    cfg = PipelineConfig(canvas=size)
    t0 = time.perf_counter()
    cohort = tmp / "cohort"
    write_synthetic_cohort(cohort, n_patients=n_pat, n_slices=n_sl, height=size, width=size)
    write_s = time.perf_counter() - t0
    encoder = jpeg_encoder()
    require(native.available(), "the host C++ layer did not load")

    def collector():
        masks, lock = {}, threading.Lock()

        def sink(pid, stem, mask):
            with lock:
                masks[(pid, stem)] = np.array(mask, copy=True)
        return masks, sink

    # the main path: the parallel driver over the whole cohort
    masks, sink = collector()
    out_par = tmp / "parallel"
    proc = CohortProcessor(cohort, out_par, cfg=cfg, batch_cfg=BatchConfig(),
                           mode="parallel", mask_sink=sink)
    reset()
    t0 = time.perf_counter()
    summary = proc.process_all_patients()
    torch.cuda.synchronize()
    par_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    n = n_pat * n_sl
    require(summary.patients_ok == n_pat, f"patients ok {summary.patients_ok}/{n_pat}")
    require(summary.succeeded_slices == n and summary.total_slices == n,
            f"slices ok {summary.succeeded_slices}/{summary.total_slices}")
    par_files = files_of(out_par)
    require(len(par_files) == 2 * n, f"{len(par_files)} JPEG files, not {2 * n}")
    manifest = json.loads((out_par / "manifest.json").read_text())
    statuses = [s for pat in manifest.values() for s in pat.values()]
    require(len(statuses) == n and set(statuses) == {"done"},
            f"manifest: {len(statuses)} slices, statuses {sorted(set(statuses))}")
    require(launches["fused"] > 0 and launches["grow"] > 0,
            f"the driver did not launch every kernel of its path: {launches}")
    require(len(masks) == n, f"the mask sink saw {len(masks)} slices")

    # the same decoded pixels through process_batch with the plain ops
    plain_cfg = PipelineConfig(canvas=size, use_kernels=False)
    decoded = {}
    for pid in find_patient_dirs(cohort):
        files = load_dicom_files_for_patient(cohort, pid)
        px = np.zeros((len(files), size, size), np.float32)
        dims = np.zeros((len(files), 2), np.int32)
        for i, f in enumerate(files):
            a = read_dicom(f).pixels
            px[i, : a.shape[0], : a.shape[1]] = a
            dims[i] = a.shape
        decoded[pid] = ([f.stem for f in files], px, dims)
        want = process_batch(torch.from_numpy(px).cuda(), torch.from_numpy(dims).cuda(),
                             plain_cfg)["mask"].cpu().numpy()
        for i, f in enumerate(files):
            require(np.array_equal(masks[(pid, f.stem)], want[i]),
                    f"{pid}/{f.stem}: driver mask != plain process_batch")

    # the first 50 masks and their host renders against the JAX-made golden;
    # the renders are the ones the driver encoded (same renderer, same bytes)
    golden = json.loads((build.PKG / "testdata" / "driver_golden.json").read_text())
    for g in golden["slices"]:
        pid, stem = g["patient"], g["stem"]
        stems, px, dims = decoded[pid]
        i = stems.index(stem)
        m = masks[(pid, stem)]
        gray, seg = native.render_pair_native(px[i], m, dims[i], cfg)
        got = {"dims": [int(d) for d in dims[i]],
               "mask_sha256": hashlib.sha256(m.tobytes()).hexdigest(),
               "area": int(m.sum()),
               "gray_sha256": hashlib.sha256(gray.tobytes()).hexdigest(),
               "seg_sha256": hashlib.sha256(seg.tobytes()).hexdigest()}
        require(got == {k: g[k] for k in got}, f"{pid}/{stem}: differs from the golden")
        require(par_files[f"{pid}/{stem}_original.jpg"] == encode_jpeg_bytes(gray)
                and par_files[f"{pid}/{stem}_processed.jpg"] == encode_jpeg_bytes(seg),
                f"{pid}/{stem}: the driver's JPEG pair is not its render")

    # one patient each: sequential, device render, the unfused (median) path
    variants = {}
    for key, pid, mode, vcfg, bcfg in (
        ("sequential", "PGBM-0001", "sequential", cfg, BatchConfig()),
        ("device_render", "PGBM-0002", "parallel", cfg, BatchConfig(render_stage="device")),
        ("unfused", "PGBM-0003", "parallel",
         PipelineConfig(canvas=size, fuse_preprocess=False), BatchConfig()),
    ):
        vmasks, vsink = collector()
        out = tmp / key
        vproc = CohortProcessor(cohort, out, cfg=vcfg, batch_cfg=bcfg, mode=mode,
                                mask_sink=vsink)
        reset()
        res = vproc.process_patient(pid)
        torch.cuda.synchronize()
        vl = {k: fn.launches for k, fn in kernels.items()}
        require(res.succeeded == n_sl, f"{key}: {res.succeeded}/{n_sl} slices")
        need = ("median", "grow") if key == "unfused" else ("fused", "grow")
        require(all(vl[k] > 0 for k in need), f"{key}: launches {vl}")
        for (p_, stem), m in vmasks.items():
            require(np.array_equal(m, masks[(p_, stem)]), f"{key}: {p_}/{stem} mask differs")
        require(len(vmasks) == n_sl, f"{key}: the sink saw {len(vmasks)} slices")
        vfiles = files_of(out)
        require(vfiles == {k: v for k, v in par_files.items() if k.startswith(pid + "/")},
                f"{key}: JPEG files differ from the parallel run's")
        variants[key] = {"patient": pid, "launches": vl}
    launches["median"] = variants["unfused"]["launches"]["median"]

    # the parallel driver's CLI, end to end: plain, kernels, kernels, plain
    runs = {"kernels": [], "plain": []}
    timing = {}
    for i, which in enumerate(("plain", "kernels", "kernels", "plain")):
        rj = tmp / f"results_{i}.json"
        argv = ["--base-path", str(cohort), "--output", str(tmp / f"cli_{i}"),
                "--results-json", str(rj), "--canvas", str(size)]
        if which == "plain":
            argv.append("--no-kernels")
        reset()
        rc = parallel_cli.main(argv)
        require(rc == 0, f"parallel CLI run {i} ({which}) exited {rc}")
        rec = json.loads(rj.read_text())
        require(rec["summary"]["slices_ok"] == n, f"CLI run {i}: {rec['summary']['slices_ok']}")
        require(rec["backend"] == "cuda" and not rec["backend_degraded"], f"CLI run {i}: {rec}")
        kl = rec["kernel_launches"]
        require((kl["fused"] > 0 and kl["grow"] > 0) if which == "kernels"
                else sum(kl.values()) == 0, f"CLI run {i} ({which}) launches {kl}")
        runs[which].append(n / rec["wall_s"])
        timing[f"{which}_{i}"] = {"wall_s": rec["wall_s"], "timing_s": rec["timing_s"]}

    # where the device sits idle under the driver: device busy over one run
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        CohortProcessor(cohort, tmp / "profiled", cfg=cfg, mode="parallel").process_all_patients()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3

    emit({"phase": "driver", "patients": n_pat, "slices": n, "size": size,
          "write_cohort_s": write_s, "parallel_s": par_s, "jpeg_files": len(par_files),
          "launches": launches, "golden_slices": len(golden["slices"]),
          "variants": variants, "timing": timing,
          "profiled_wall_ms": wall_ms,
          "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured"})
    emit({"phase": "driver_throughput",
          "kernels_slices_per_s": runs["kernels"], "plain_slices_per_s": runs["plain"],
          "jpeg_encoder": encoder, "launches": launches, "nvidia_smi": smi})
    return launches, {"cohort": cohort, "masks": masks, "files": par_files}


def http_post(url: str, body: bytes, headers: dict):
    """POST with urllib; (status, json payload or None, headers, seconds)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            raw, status, hdrs = r.read(), r.status, dict(r.headers)
    except urllib.error.HTTPError as e:
        raw, status, hdrs = e.read(), e.code, dict(e.headers)
    dt = time.perf_counter() - t0
    return status, json.loads(raw) if raw else None, hdrs, dt


def client_run(url: str, jobs: list, concurrency: int):
    """Send ``jobs`` ((key, body, headers)) from ``concurrency`` threads;
    ``({key: (status, payload, headers, seconds)}, wall seconds)``."""
    results, lock, it = {}, threading.Lock(), iter(jobs)

    def worker():
        while True:
            with lock:
                job = next(it, None)
            if job is None:
                return
            key, body, headers = job
            out = http_post(url, body, headers)
            with lock:
                results[key] = out

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    require(not any(t.is_alive() for t in threads), "a client thread hung")
    require(len(results) == len(jobs), f"{len(results)} answers to {len(jobs)} requests")
    return results, wall


def latency_stats(results: dict, wall: float) -> dict:
    lat = sorted(r[3] * 1e3 for r in results.values())
    return {"requests": len(lat), "wall_s": wall, "requests_per_s": len(lat) / wall,
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}


def serve_phase(driver_out: dict, smi: str, kernels: dict, reset) -> dict:
    """Single-slice serving on the card (phase 5 of the docstring).

    Returns each kernel's launches made by graph replays while the servers
    answered requests (replays x the kernels a graph holds).
    """
    from torch.profiler import ProfilerActivity, profile

    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas
    from nm03_capstone_project_tpu_torch.data.discovery import (
        find_patient_dirs,
        load_dicom_files_for_patient,
    )
    from nm03_capstone_project_tpu_torch.data.synthetic import smoke_cohort
    from nm03_capstone_project_tpu_torch.pipeline import process_batch
    from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom_bytes
    from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import _process
    from nm03_capstone_project_tpu_torch.render.export import encode_jpeg_bytes
    from nm03_capstone_project_tpu_torch.render.host_render import host_render_pair
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp, serve_in_thread

    cohort, dmasks, dfiles = driver_out["cohort"], driver_out["masks"], driver_out["files"]
    dicom = [(pid, f.stem, f.read_bytes()) for pid in find_patient_dirs(cohort)
             for f in load_dicom_files_for_patient(cohort, pid)]
    require(len(dicom) == len(dmasks), f"{len(dicom)} DICOM files, {len(dmasks)} driver masks")
    cfg = PipelineConfig(canvas=DRIVER_COHORT[2])
    statuses = {}

    def tally(results: dict, want: int = 200):
        for status, payload, _, _ in results.values():
            statuses[status] = statuses.get(status, 0) + 1
            require(status == want, f"HTTP {status} where {want} was due: {payload}")

    def check_dicom(results: dict, jpeg: bool):
        for (pid, stem), (_, payload, headers, _) in results.items():
            m = dmasks[(pid, stem)]
            h, w = payload["shape"]
            require(payload["mask_sha256"] == hashlib.sha256(
                np.ascontiguousarray(m[:h, :w]).tobytes()).hexdigest(),
                f"served {pid}/{stem}: mask != the driver's")
            if jpeg:
                require(base64.b64decode(payload["original_jpeg_b64"])
                        == dfiles[f"{pid}/{stem}_original.jpg"]
                        and base64.b64decode(payload["processed_jpeg_b64"])
                        == dfiles[f"{pid}/{stem}_processed.jpg"],
                        f"served {pid}/{stem}: JPEG pair != the driver's files")

    app = ServingApp(cfg=cfg, buckets=SERVE_BUCKETS, result_cache_bytes=1 << 30)
    httpd, _, port = serve_in_thread(app)  # warmup: one CUDA graph a bucket
    url = f"http://127.0.0.1:{port}/v1/segment"
    try:
        graphs = app.status()["cuda_graphs"]
        require(graphs["enabled"] and sorted(map(int, graphs["lanes"]["0"])) == list(
            SERVE_BUCKETS), f"cuda_graphs: {graphs}")
        capture_s = {b: g["capture_s"] for b, g in graphs["lanes"]["0"].items()}
        reset()
        app.executor.reset_replays()  # the main path's run: replays from here count

        # the cohort's 500 DICOM files from 16 clients, under the profiler
        jobs = [((pid, stem), body, {"Content-Type": "application/dicom"})
                for pid, stem, body in dicom]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            c16, c16_wall = client_run(url, jobs, SERVE_CONCURRENCY)
            torch.cuda.synchronize()
        busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        tally(c16)
        check_dicom(c16, jpeg=True)

        # one at a time: bucket 1 (mask only: another result key, so no hit)
        jobs = [((pid, stem), body, {"Content-Type": "application/dicom"})
                for pid, stem, body in dicom[:SERVE_SINGLES]]
        c1, c1_wall = client_run(url + "?output=mask", jobs, 1)
        tally(c1)
        check_dicom(c1, jpeg=False)

        # the smoke cohort's non-square phantoms as raw float32 bodies, in
        # bursts that each coalesce into one batch: a 0.25 s window, taken
        # up by the batcher from its next batch on (the first phantom's)
        phantoms = [a for a in smoke_cohort() if a.shape[0] != a.shape[1]][5::7]
        phantoms = phantoms[: 1 + sum(SERVE_BURSTS)]
        app.batcher.max_wait_s = 0.25
        bursts, start = {}, 0
        for b in (1,) + SERVE_BURSTS:
            jobs = [(start + i, a.astype("<f4").tobytes(),
                     {"Content-Type": "application/octet-stream",
                      "X-Nm03-Height": str(a.shape[0]), "X-Nm03-Width": str(a.shape[1])})
                    for i, a in enumerate(phantoms[start : start + b])]
            res, _ = client_run(url, jobs, b)
            bursts.update(res)
            start += b
        tally(bursts)
        batch = pad_to_canvas(phantoms, cfg.canvas_hw, device="cuda")
        want = process_batch(batch.pixels, batch.dims, PipelineConfig(
            canvas=cfg.canvas, use_kernels=False))["mask"].cpu().numpy()
        for i, a in enumerate(phantoms):
            payload = bursts[i][1]
            got_sha = payload["mask_sha256"]
            h, w = a.shape
            require(payload["shape"] == [h, w] and got_sha == hashlib.sha256(
                np.ascontiguousarray(want[i, :h, :w]).tobytes()).hexdigest(),
                f"phantom {i} ({h}x{w}): served mask != plain process_batch")
        replays = {b: g["replays"] for b, g in app.status()["cuda_graphs"]["lanes"]["0"].items()}
        launches = app.executor.replay_launches()
        require(all(n > 0 for n in replays.values()), f"a bucket never replayed: {replays}")
        require(launches.get("fused", 0) > 0 and launches.get("grow", 0) > 0,
                f"the graphs did not launch every kernel of the path: {launches}")
        wrapper_launches = {k: fn.launches for k, fn in kernels.items()}
        require(sum(wrapper_launches.values()) == 0,
                f"serving ran a kernel wrapper outside a graph: {wrapper_launches}")

        # the result tier: repeats of answered bodies, with and without the ETag
        cached = 0
        for pid, stem, body in dicom[:SERVE_REPEATS]:
            etag = c16[(pid, stem)][2]["ETag"]
            status, payload, headers, _ = http_post(
                url, body, {"Content-Type": "application/dicom", "If-None-Match": etag})
            require(status == 304 and payload is None and headers["ETag"] == etag,
                    f"{pid}/{stem}: If-None-Match gave {status}")
            status, payload, headers, _ = http_post(
                url, body, {"Content-Type": "application/dicom"})
            require(status == 200 and headers["X-Nm03-Cache"] == "hit"
                    and headers["ETag"] == etag and payload["mask_sha256"]
                    == c16[(pid, stem)][1]["mask_sha256"], f"{pid}/{stem}: repeat missed")
            statuses[304] = statuses.get(304, 0) + 1
            statuses[200] += 1
            cached += 1
        require(app.executor.replay_launches() == launches, "a cached repeat replayed")

        # where a concurrency-16 request's time goes on the host: the
        # server's own wall and queue wait (its histograms), and one
        # slice's decode and render + encode, alone (median of 20)
        reg = app.registry
        server_side = {
            name: reg.get(name).sum / reg.get(name).count
            for name in ("serving_request_seconds", "serving_queue_wait_seconds")}
        body = dicom[0][2]
        px = read_dicom_bytes(body).pixels
        mask = dmasks[(dicom[0][0], dicom[0][1])]
        dims = np.asarray(px.shape, np.int32)

        def host_ms(fn):
            times = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times)

        host_cost_ms = {
            "decode": host_ms(lambda: read_dicom_bytes(body)),
            "render_encode": host_ms(lambda: [encode_jpeg_bytes(im) for im in
                                              host_render_pair(px, mask, dims, cfg)]),
        }
        hist = app.registry.get("serving_batch_size").cumulative()
        batch_hist, prev = {}, 0
        for le, n in hist:
            if n > prev:
                batch_hist[le] = n - prev
            prev = n
        drained = app.begin_drain(reason="chip_smoke")
        # a body the result tier has not seen (a stored one is still served)
        status, payload, _, _ = http_post(url + "?output=mask", dicom[-1][2],
                                          {"Content-Type": "application/dicom"})
        require(drained and status == 503 and payload["draining"] is True,
                f"after begin_drain a request got {status}")
        statuses[503] = statuses.get(503, 0) + 1
    finally:
        app.begin_drain(reason="chip_smoke")
        httpd.shutdown()
        httpd.server_close()

    # one graph replay against eager _process, per bucket, on the same inputs
    graph_vs_eager = {}
    for b in SERVE_BUCKETS:
        g = app.executor._runners[0][b]
        px, dm = g.pixels, g.dims
        graph_vs_eager[b] = {"graph_ms": cuda_ms(g.graph.replay),
                             "eager_ms": cuda_ms(lambda: _process(px, dm, cfg))}
    app.close()

    # the unfused path: the standalone median kernel inside the graphs
    uapp = ServingApp(cfg=PipelineConfig(canvas=cfg.canvas, fuse_preprocess=False),
                      buckets=(1, 4), result_cache_bytes=1 << 26)
    uhttpd, _, uport = serve_in_thread(uapp)
    try:
        uapp.executor.reset_replays()
        jobs = [((pid, stem), body, {"Content-Type": "application/dicom"})
                for pid, stem, body in dicom[100:108]]
        unfused, _ = client_run(f"http://127.0.0.1:{uport}/v1/segment?output=mask", jobs, 4)
        tally(unfused)
        ulaunch = uapp.executor.replay_launches()
    finally:
        uapp.begin_drain(reason="chip_smoke")
        uhttpd.shutdown()
        uhttpd.server_close()
        uapp.close()
    for (pid, stem), (_, payload, _, _) in unfused.items():
        m = dmasks[(pid, stem)]
        require(payload["mask_sha256"] == hashlib.sha256(m.tobytes()).hexdigest(),
                f"unfused served {pid}/{stem}: mask != the driver's")
    require(ulaunch.get("median", 0) > 0 and "fused" not in ulaunch,
            f"the unfused graphs' launches: {ulaunch}")

    serve_launches = {k: launches.get(k, 0) + ulaunch.get(k, 0) for k in kernels}
    emit({"phase": "serve", "buckets": list(SERVE_BUCKETS), "statuses": statuses,
          "dicom_requests": len(dicom), "singles": SERVE_SINGLES,
          "phantoms": len(phantoms), "cached_repeats": cached,
          "batch_size_hist": batch_hist, "replays": replays, "capture_s": capture_s,
          "concurrency16": latency_stats(c16, c16_wall), "concurrency1": latency_stats(
              c1, c1_wall),
          "server_mean_s": server_side, "host_cost_ms": host_cost_ms,
          "c16_device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          "c16_idle_share": 1 - busy_ms / (c16_wall * 1e3) if busy_ms > 0 else "not measured",
          "graph_vs_eager_ms": graph_vs_eager, "serve_launches": serve_launches,
          "unfused_launches": ulaunch, "nvidia_smi": smi})
    return serve_launches


def long_study():
    """``(volume, dims)`` of one long phantom study: LONG_STUDY planes at the
    full canvas, numpy float32 and int32."""
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume

    d, h, w = LONG_STUDY
    return phantom_volume(d, h, w, seed=5), np.asarray([h, w], np.int32)


def grow_stats(px, dm, cfg) -> dict:
    """The 3D growth of ``process_volume`` alone on one volume on the card:
    its milliseconds (host clock around it, synchronized; median of 3), the
    dilation steps it ran and the blocks of ``grow_block_iters`` steps (one
    host sync each)."""
    from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import (
        grow_volume,
        volume_grow_inputs,
    )

    pre, seeds, valid = volume_grow_inputs(px, dm, cfg)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, conv, steps = grow_volume(pre, seeds, valid, cfg, return_steps=True)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return {"grow_ms": statistics.median(times), "steps": steps,
            "blocks": steps // cfg.grow_block_iters, "converged": bool(conv)}


def volume_phase(tmp: Path, cohort: Path, study, smi: str, kernels: dict, reset) -> dict:
    """The 3D volume path on the card (phase 6 of the docstring).

    Returns each kernel's launches in the volume driver's main run (the
    median kernel's from the unfused patient).
    """
    from torch.profiler import ProfilerActivity, profile

    from nm03_capstone_project_tpu_torch.cli import volume as volume_cli
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas
    from nm03_capstone_project_tpu_torch.data.imageio import read_metaimage
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.pipeline import process_volume

    n_pat, n_sl, size = DRIVER_COHORT
    n = n_pat * n_sl
    cfg = PipelineConfig(canvas=size)
    golden_file = json.loads((build.PKG / "testdata" / "volume_golden.json").read_text())
    golden = {g["patient"]: g for g in golden_file["patients"]}
    require(len(golden) == n_pat, f"the volume golden holds {len(golden)} patients")

    def cli(base: Path, out: Path, *extra) -> dict:
        rj = out.parent / (out.name + ".json")
        rc = volume_cli.main(["--base-path", str(base), "--output", str(out),
                              "--results-json", str(rj), "--canvas", str(size),
                              "--export-mhd", *extra])
        require(rc == 0, f"volume CLI {out.name} exited {rc}")
        rec = json.loads(rj.read_text())
        require(rec["backend_actual"] == "cuda" and rec["z_sharded"] is False,
                f"volume CLI {out.name}: {rec['backend_actual']}")
        return rec

    def outputs(out: Path, rec: dict):
        """The run's JPEG files and its masks read back from mask.mhd."""
        masks = {pid: read_metaimage(out / pid / "mask.mhd")[0] for pid in rec["patients"]}
        return files_of(out), masks

    # the main path, the volume CLI over the cohort: kernels and plain in turns
    runs, kept, launches = {"kernels": [], "plain": []}, {}, None
    for i, which in enumerate(VOLUME_TURNS):
        out = tmp / f"volume_{i}"
        reset()
        rec = cli(cohort, out, *(["--no-kernels"] if which == "plain" else []))
        kl = rec["kernel_launches"]
        if i == 0:
            launches = {k: fn.launches for k, fn in kernels.items()}
            require(launches == kl, f"launch counts {launches} != the CLI's {kl}")
        pats = rec["patients"]
        require(len(pats) == n_pat and sum(p["exported"] for p in pats.values()) == n
                and sum(p["slices"] for p in pats.values()) == n,
                f"volume run {i} ({which}): {len(pats)} patients")
        require(kl == ({"fused": n_pat, "grow": 0, "median": 0} if which == "kernels"
                       else {"fused": 0, "grow": 0, "median": 0}),
                f"volume run {i} ({which}) launches {kl}")
        files, masks = outputs(out, rec)
        require(len(files) == 2 * n, f"volume run {i}: {len(files)} JPEG files, not {2 * n}")
        for pid, g in golden.items():
            m = masks[pid]
            got = {"depth": int(m.shape[0]),
                   "mask_sha256": hashlib.sha256(m.tobytes()).hexdigest(),
                   "voxels": int(m.sum()),
                   "grow_converged": pid not in rec["grow_truncated_patients"]}
            require(got == {k: g[k] for k in got} and pats[pid]["mask_voxels"] == g["voxels"],
                    f"volume run {i} ({which}) {pid}: differs from the golden")
        if which not in kept:
            kept[which] = (files, masks, out)
        runs[which].append(rec)
    kfiles, kmasks, kout = kept["kernels"]
    pfiles, pmasks, _ = kept["plain"]
    require(kfiles == pfiles, "volume: JPEG files with the kernels != plain")
    require(all(np.array_equal(kmasks[p], pmasks[p]) for p in kmasks),
            "volume: masks with the kernels != plain")

    # the cohort holds two distinct masks; phantom volumes of four other
    # shapes, each a mask of its own, through process_volume with the kernels
    for ph in golden_file["phantoms"]:
        d, h, w = ph["shape"]
        batch = pad_to_canvas(list(phantom_volume(d, h, w, seed=ph["seed"])), (size, size),
                              device="cuda")
        out = process_volume(batch.pixels, batch.dims[0], cfg)
        m = out["mask"].cpu().numpy()
        got = {"mask_sha256": hashlib.sha256(m.tobytes()).hexdigest(),
               "voxels": int(m.sum()), "grow_converged": bool(out["grow_converged"])}
        require(got == {k: ph[k] for k in got}, f"phantom volume {ph['shape']}: "
                "differs from the golden")

    # one patient each through the variants, against the kernels run
    variants = {}
    for key, pid, extra, need in (
        ("device_render", "PGBM-0004", ["--render-stage", "device"], {"fused": 1}),
        ("unfused", "PGBM-0005", ["--no-preprocess-fuse"], {"median": 1}),
        ("jump", "PGBM-0006", ["--grow-algorithm", "jump"], {"fused": 1}),
    ):
        base = tmp / f"vcohort_{key}"
        shutil.copytree(cohort / pid, base / pid)
        out = tmp / f"volume_{key}"
        reset()
        rec = cli(base, out, *extra)
        vl = {k: fn.launches for k, fn in kernels.items()}
        want = {"fused": 0, "grow": 0, "median": 0, **need}
        require(vl == want == rec["kernel_launches"], f"volume {key}: launches {vl}")
        vfiles, vmasks = outputs(out, rec)
        conv = pid not in rec["grow_truncated_patients"]
        # the jump schedule converges within its 1024 rounds here, and then
        # gives the dilate schedule's masks
        require(conv, f"volume {key}: {pid} truncated")
        require(np.array_equal(vmasks[pid], kmasks[pid]), f"volume {key}: mask differs")
        require(vfiles == {k: v for k, v in kfiles.items() if k.startswith(pid + "/")},
                f"volume {key}: JPEG files differ from the kernels run's")
        variants[key] = {"patient": pid, "launches": vl, "converged": conv}
    launches["median"] = variants["unfused"]["launches"]["median"]

    # where a kernels run's time goes, and the device's idle share under it
    rec0 = runs["kernels"][0]
    shares = {}
    for key, sec in rec0["timings_s"].items():
        stage = key.split("/", 1)[0]
        shares[stage] = shares.get(stage, 0.0) + sec / rec0["wall_s"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cli(cohort, tmp / "volume_profiled")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3

    # the 3D growth alone: every cohort patient, the median one reported
    per_patient = {}
    for pid in golden:
        vol, dims, _, _ = volume_cli._load_volume(cohort, pid, cfg)
        per_patient[pid] = grow_stats(torch.from_numpy(vol).cuda(),
                                      torch.from_numpy(dims).cuda(), cfg)
    by_ms = sorted(per_patient, key=lambda p: per_patient[p]["grow_ms"])
    median_pid = by_ms[len(by_ms) // 2]

    # one long study through process_volume, kernels and plain
    svol, sdims = study
    spx, sdm = torch.from_numpy(svol).cuda(), torch.from_numpy(sdims).cuda()
    scfg = PipelineConfig(canvas=LONG_STUDY[1])
    splain = PipelineConfig(canvas=LONG_STUDY[1], use_kernels=False)

    def study_run(c):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = process_volume(spx, sdm, c)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset()
    sfast, first_s = study_run(scfg)
    study_launches = {k: fn.launches for k, fn in kernels.items()}
    sslow, first_plain_s = study_run(splain)
    require(study_launches == {"fused": 1, "grow": 0, "median": 0},
            f"long study launches {study_launches}")
    require(torch.equal(sfast["mask"], sslow["mask"]), "long study: kernel mask != plain")
    require(bool(sfast["grow_converged"]) == bool(sslow["grow_converged"]),
            "long study: converged differs")
    require(int(sfast["mask"].sum()) > 0, "long study segmented nothing")
    del sslow
    # warm runs in turns (the first ones above also pay the allocator's
    # first blocks at this shape)
    study_s = {"kernels": [], "plain": []}
    for which in VOLUME_TURNS:
        study_s[which].append(study_run(scfg if which == "kernels" else splain)[1])
    study_grow = grow_stats(spx, sdm, scfg)

    def rate(recs):
        walls = [r["wall_s"] for r in recs]
        return {"volumes_per_s": statistics.median(n_pat / w for w in walls),
                "slices_per_s": statistics.median(n / w for w in walls), "wall_s": walls}

    emit({"phase": "volume", "patients": n_pat, "planes": n, "size": size,
          "jpeg_files": len(kfiles), "golden_patients": len(golden),
          "golden_phantoms": len(golden_file["phantoms"]),
          "checks": ["20/20 patients ok, 500 planes, 1000 JPEG files a run",
                     "every mask (mask.mhd) = volume_golden.json (sha256, voxels, converged)",
                     "4 phantom volumes of other shapes (kernels) = volume_golden.json",
                     "kernels = plain: masks and JPEG bytes",
                     "device render, unfused (median kernel), jump = the kernels run",
                     "fused kernel once a patient; long study kernels = plain"],
          "kernels": rate(runs["kernels"]), "plain": rate(runs["plain"]),
          "time_shares": shares, "profiled_wall_ms": wall_ms,
          "device_busy_ms": busy_ms if busy_ms > 0 else "not measured",
          "idle_share": 1 - busy_ms / wall_ms if busy_ms > 0 else "not measured",
          "grow_median_patient": {"patient": median_pid, **per_patient[median_pid]},
          "grow_ms_range": [per_patient[by_ms[0]]["grow_ms"], per_patient[by_ms[-1]]["grow_ms"]],
          "long_study": {"shape": list(LONG_STUDY),
                         "process_volume_s": statistics.median(study_s["kernels"]),
                         "plain_s": statistics.median(study_s["plain"]), "turns_s": study_s,
                         "first_s": {"kernels": first_s, "plain": first_plain_s},
                         "voxels": int(sfast["mask"].sum()),
                         "converged": bool(sfast["grow_converged"]), **study_grow},
          "variants": variants, "launches": launches, "nvidia_smi": smi})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing to drive", file=sys.stderr)
        return 1
    try:
        from nm03_capstone_project_tpu_torch.kernels import build, median_runs
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})", file=sys.stderr)
        return 1
    from nm03_capstone_project_tpu_torch.config import DEFAULT_BATCH_SIZE, PipelineConfig
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas, valid_mask
    from nm03_capstone_project_tpu_torch.data.synthetic import (
        phantom_slice,
        smoke_cohort,
    )
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
    from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
    from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize
    from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter
    from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges
    from nm03_capstone_project_tpu_torch.ops.region_growing import region_grow
    from nm03_capstone_project_tpu_torch.ops.seeds import seed_mask
    from nm03_capstone_project_tpu_torch.ops.selection_network import comparator_counts
    from nm03_capstone_project_tpu_torch.pipeline import process_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    for name in build.SOURCES:
        build.load(name)
    ptxas = {}
    for name in build.SOURCES:
        log = (build.build_dir() / f"{name}.log")
        if log.exists():
            ptxas.update(ptxas_report(log.read_text()))
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "compiled": {k: round(v, 3) for k, v in built.items()},
          "nvidia_smi": smi, "ptxas": ptxas,
          "fused_minmax_per_median": {
              f"k{k}_R{r}": round(median_runs.ops_per_output(k, r), 2)
              for k, r in median_runs.FUSED_RUNS.items()}})
    require(ptxas.get("fused_kernel<7,%d>" % median_runs.FUSED_RUNS[7], {}).get(
        "spill_stores") == 0, "the fused kernel spills at k = 7")

    cfg = PipelineConfig(canvas=256)
    counts = comparator_counts(cfg.median_window)
    median_ops = counts["presort_minmax"] + counts["merge_minmax_pruned_shared"]
    ks = cfg.sharpen_kernel
    # per pixel: the median and the clip's min and max; normalize (3), two
    # ks-tap passes (ks products, ks - 1 sums each) and the unsharp update (3)
    fused_ops = {"minmax_bitwise": median_ops + 2, "add_mul": 3 + 2 * (2 * ks - 1) + 3}
    pre_kw = dict(
        norm_low=cfg.norm_low, norm_high=cfg.norm_high,
        norm_min=cfg.norm_intensity_min, norm_max=cfg.norm_intensity_max,
        clip_low=cfg.clip_low, clip_high=cfg.clip_high,
        median_window=cfg.median_window, sharpen_gain=cfg.sharpen_gain,
        sharpen_sigma=cfg.sharpen_sigma, sharpen_kernel=cfg.sharpen_kernel,
    )

    cohort = smoke_cohort()
    batches = [
        pad_to_canvas(cohort[i : i + DEFAULT_BATCH_SIZE], cfg.canvas_hw, device=dev)
        for i in range(0, len(cohort), DEFAULT_BATCH_SIZE)
    ]
    main_px, main_dims = batches[1].pixels, batches[1].dims  # mixed true dims
    require(tuple(main_px.shape) == MAIN_SHAPE, "main batch shape")
    prime_px = torch.from_numpy(np.stack(
        [phantom_slice(*PRIME_SHAPE[1:], seed=s, lesion_radius=0.12) for s in range(3)]
    )).to(dev)
    prime_dims = torch.tensor([[251, 241], [240, 241], [251, 200]], dtype=torch.int32,
                              device=dev)
    gen = torch.Generator(device="cpu").manual_seed(7)
    results = {}

    # -- 2a. median ----------------------------------------------------------
    def median_input(px, dims):
        x = extend_edges(px, dims)
        return clip_intensity(normalize(x), cfg.clip_low, cfg.clip_high)

    err, cases = 0.0, []
    for shape, x in (
        ("main", median_input(main_px, main_dims)),
        ("prime", median_input(prime_px, prime_dims)),
        ("prime_random", (torch.rand(PRIME_SHAPE, generator=gen) * 4000 + 0.68).to(dev)),
    ):
        for k in ((7,) if shape == "main" else WINDOWS):
            got, want = hm.vector_median_filter_kernel(x, k), vector_median_filter(x, k)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"median kernel != plain ({shape}, k={k})")
            err = max(err, max_abs(got, want))
            cases.append(f"{shape}:k{k}")
    x = median_input(main_px, main_dims)
    ms = cuda_ms(lambda: hm.vector_median_filter_kernel(x, 7))
    dev_ms = device_ms(lambda: hm.vector_median_filter_kernel(x, 7), "band_kernel")
    plain_ms = cuda_ms(lambda: vector_median_filter(x, 7), repeats=5)
    n = x.numel()
    b_ms, b_by = bound(8 * n, {"minmax_bitwise": median_ops * n})
    results["median"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "median", "bitwise": True, "cases": cases, "ms": ms, "device_ms": dev_ms,
          "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
          "launches": hm.vector_median_filter_kernel.launches})

    # -- 2b. fused preprocess ------------------------------------------------
    # one long study as the volume path launches it: its planes as the batch
    study = long_study()
    study_x = extend_edges(torch.from_numpy(study[0]).to(dev),
                           torch.from_numpy(study[1]).to(dev).expand(LONG_STUDY[0], 2))
    err, cases = 0.0, []
    for shape, x in (
        ("main", extend_edges(main_px, main_dims)),
        ("prime", extend_edges(prime_px, prime_dims)),
        ("prime_random", (torch.rand(PRIME_SHAPE, generator=gen) * 9000).to(dev)),
        ("study%dx%d" % LONG_STUDY[:2], study_x),
    ):
        for k in ((7,) if shape in ("main", "study%dx%d" % LONG_STUDY[:2]) else WINDOWS):
            kw = dict(pre_kw, median_window=k)
            got = hm.fused_preprocess_kernel(x, **kw)
            want = hm._fused_preprocess_plain(x, **kw)
            torch.cuda.synchronize()
            require(bool(torch.isfinite(got).all()), f"fused kernel not finite ({shape}, k={k})")
            require(torch.equal(got, want), f"fused kernel != plain ({shape}, k={k})")
            err = max(err, max_abs(got, want))
            cases.append(f"{shape}:k{k}")
    x = extend_edges(main_px, main_dims)
    ms = cuda_ms(lambda: hm.fused_preprocess_kernel(x, **pre_kw))
    dev_ms = device_ms(lambda: hm.fused_preprocess_kernel(x, **pre_kw), "fused_kernel")
    plain_ms = cuda_ms(lambda: hm._fused_preprocess_plain(x, **pre_kw), repeats=5)
    n = x.numel()
    b_ms, b_by = bound(8 * n, {k: v * n for k, v in fused_ops.items()})
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    tile_h, tile_w, grid, smem = hm.fused_launch_shape(
        *x.shape, cfg.median_window, cfg.sharpen_kernel, n_sm)
    # the long study in one launch: its wrapper time and bound
    study_ms = cuda_ms(lambda: hm.fused_preprocess_kernel(study_x, **pre_kw), repeats=5)
    study_bound = bound(8 * study_x.numel(), {k: v * study_x.numel() for k, v in fused_ops.items()})
    study_shape = hm.fused_launch_shape(*study_x.shape, cfg.median_window, cfg.sharpen_kernel,
                                        n_sm)
    del study_x
    results["fused"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "fused", "bitwise": True, "cases": cases, "ms": ms, "device_ms": dev_ms,
          "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
          "tile": [tile_h, tile_w], "grid": grid, "smem_bytes": smem,
          "study": {"shape": list(LONG_STUDY), "ms": study_ms, "bound_ms": study_bound[0],
                    "bound_by": study_bound[1], "launch_shape": list(study_shape)},
          "launches": hm.fused_preprocess_kernel.launches})

    # -- 2c. region growing --------------------------------------------------
    def grow_inputs(px, dims):
        pre = hm._fused_preprocess_plain(extend_edges(px, dims), **pre_kw)
        hw = tuple(px.shape[-2:])
        return pre, seed_mask(dims, hw), valid_mask(dims, hw)

    def canvas_batch(c: int):
        """Phantoms on a c x c canvas, one of full size and one smaller."""
        dims = [(c, c), (c - c // 8, c - c // 5)]
        slices = [phantom_slice(h, w, seed=10 + i, lesion_radius=0.12)
                  for i, (h, w) in enumerate(dims)]
        return pad_to_canvas(slices, (c, c), device=dev)

    err, cases, truncated, shapes = 0.0, [], 0, {}
    grow_cases = [("main", grow_inputs(main_px, main_dims)),
                  ("prime", grow_inputs(prime_px, prime_dims))]
    for c in GROW_CANVASES:
        bt = canvas_batch(c)
        grow_cases.append((f"canvas{c}", grow_inputs(bt.pixels, bt.dims)))
    for shape, (img, seeds, valid) in grow_cases:
        shapes[shape] = hg.grow_launch_shape(*img.shape[-2:])
        for bi, mi in ((cfg.grow_block_iters, cfg.grow_max_iters), (2, 4)):
            kw = dict(valid=valid, block_iters=bi, max_iters=mi, return_steps=True)
            gm, gc, gs = hg.region_grow_kernel(img, seeds, cfg.grow_low, cfg.grow_high, **kw)
            wm, wc, ws = region_grow(img, seeds, cfg.grow_low, cfg.grow_high, **kw)
            torch.cuda.synchronize()
            require(torch.equal(gm, wm), f"grow kernel mask != plain ({shape}, {mi})")
            require(torch.equal(gc, wc), f"grow kernel converged != plain ({shape}, {mi})")
            require(torch.equal(gs, ws), f"grow kernel steps != plain ({shape}, {mi})")
            require(mi == 4 or int(wm.sum()) > 0, f"nothing grew ({shape})")
            if mi == 4:
                truncated += int((~gc).sum())
            err = max(err, max_abs(gm, wm))
            cases.append(f"{shape}:max_iters={mi}:steps={gs.tolist()}")
    require(truncated > 0, "the truncating grow case truncated no slice")
    img, seeds, valid = grow_inputs(main_px, main_dims)
    gkw = dict(valid=valid, block_iters=cfg.grow_block_iters, max_iters=cfg.grow_max_iters)
    ms = cuda_ms(lambda: hg.region_grow_kernel(
        img, seeds, cfg.grow_low, cfg.grow_high, **gkw))
    dev_ms = device_ms(lambda: hg.region_grow_kernel(
        img, seeds, cfg.grow_low, cfg.grow_high, **gkw), "grow_kernel")
    plain_ms = cuda_ms(lambda: region_grow(
        img, seeds, cfg.grow_low, cfg.grow_high, **gkw), repeats=5)
    # the depth of each slice's fixpoint on this data, as the kernel ran it
    steps = hg.region_grow_kernel(img, seeds, cfg.grow_low, cfg.grow_high,
                                  return_steps=True, **gkw)[2]
    b, h, w = img.shape
    words = h * ((w + 31) // 32)
    # per step and 32-pixel word: 4 neighbour shifts/ORs, 2 carries, up/down, band AND
    grow_ops = float(steps.sum()) * words * 9
    b_ms, b_by = bound(b * h * w * (4 + 1 + 1 + 1) + 4 * b, {"minmax_bitwise": grow_ops})
    results["grow"] = dict(max_abs_err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by)
    emit({"phase": "grow", "bitwise": True, "cases": cases,
          "truncated_slices": truncated, "steps_per_slice": steps.tolist(),
          "launch_shapes": shapes, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
          "bound_ms": b_ms, "bound_by": b_by, "launches": hg.region_grow_kernel.launches})

    # -- 3. the cohort through process_batch ---------------------------------
    kernels = {
        "fused": hm.fused_preprocess_kernel,
        "grow": hg.region_grow_kernel,
        "median": hm.vector_median_filter_kernel,
    }

    def reset():
        for fn in kernels.values():
            fn.launches = 0

    def run(c):
        outs = [process_batch(bt.pixels, bt.dims, c) for bt in batches]
        torch.cuda.synchronize()
        return outs

    plain_cfg = PipelineConfig(canvas=256, use_kernels=False)
    process_batch(batches[0].pixels, batches[0].dims, cfg)  # warm-up, not counted
    process_batch(batches[0].pixels, batches[0].dims, plain_cfg)
    torch.cuda.synchronize()

    reset()  # the main path's run: every launch from here to the read counts
    fast = run(cfg)
    launches = {k: fn.launches for k, fn in kernels.items()}
    slow = run(plain_cfg)
    require(launches["fused"] > 0 and launches["grow"] > 0,
            f"the main path did not launch every kernel: {launches}")
    for i, (a, p) in enumerate(zip(fast, slow)):
        require(torch.equal(a["mask"], p["mask"]), f"batch {i}: kernel masks != plain")
        require(torch.equal(a["grow_converged"], p["grow_converged"]),
                f"batch {i}: kernel grow_converged != plain")
    masks = torch.cat([o["mask"] for o in fast]).cpu().numpy()
    conv = torch.cat([o["grow_converged"] for o in fast]).cpu().numpy()
    golden_path = build.PKG / "testdata" / "smoke_masks.json"
    golden = json.loads(golden_path.read_text())["slices"]
    for g in golden:
        i = g["index"]
        got = {"sha256": hashlib.sha256(masks[i].tobytes()).hexdigest(),
               "area": int(masks[i].sum()), "converged": bool(conv[i])}
        require(got == {k: g[k] for k in got}, f"slice {i}: mask differs from the golden")
    require(masks.shape == (len(cohort), 256, 256), "mask shape")
    require(int(masks.sum()) > 0, "the cohort segmented nothing")

    # the standalone median kernel's path: one batch, fuse_preprocess=False
    unfused_cfg = PipelineConfig(canvas=256, fuse_preprocess=False)
    reset()
    unfused = process_batch(batches[1].pixels, batches[1].dims, unfused_cfg)
    torch.cuda.synchronize()
    unfused_launches = {k: fn.launches for k, fn in kernels.items()}
    require(unfused_launches["median"] > 0 and unfused_launches["grow"] > 0,
            f"the unfused path did not launch its kernels: {unfused_launches}")
    require(torch.equal(unfused["mask"], fast[1]["mask"]), "unfused masks != fused masks")
    launches["median"] = unfused_launches["median"]

    # a canvas past the old one-CTA limit: phantoms at 1024 through process_batch
    big = canvas_batch(1024)
    big_fast = process_batch(big.pixels, big.dims, PipelineConfig(canvas=1024))
    big_slow = process_batch(big.pixels, big.dims, PipelineConfig(canvas=1024, use_kernels=False))
    torch.cuda.synchronize()
    require(torch.equal(big_fast["mask"], big_slow["mask"]), "canvas 1024: kernel masks != plain")
    require(torch.equal(big_fast["grow_converged"], big_slow["grow_converged"]),
            "canvas 1024: kernel grow_converged != plain")
    require(int(big_fast["mask"].sum()) > 0, "canvas 1024 segmented nothing")

    # throughput, host clock around whole cohort runs ending in a synchronize;
    # plain, kernels, kernels, plain in turns
    runs = {"plain": [], "kernels": []}
    for which in ("plain", "kernels", "kernels", "plain") * 2:
        t = time.perf_counter()
        run(cfg if which == "kernels" else plain_cfg)
        runs[which].append(time.perf_counter() - t)
    fast_s, slow_s = statistics.median(runs["kernels"]), statistics.median(runs["plain"])

    # where a batch's time goes: device time by kernel over 4 batches
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for bt in batches[:4]:
            process_batch(bt.pixels, bt.dims, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_kernel = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if getattr(e, "self_device_time_total", 0) > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in by_kernel)
    emit({"phase": "profile", "batches": 4, "wall_ms": wall_ms,
          "device_busy_ms": busy_ms if by_kernel else "not measured",
          "idle_share": 1 - busy_ms / wall_ms if by_kernel else "not measured",
          "top": [{"kernel": k[:80], "ms": ms, "calls": c} for k, ms, c in by_kernel[:10]]})

    n = len(cohort)
    emit({"phase": "slice", "slices": n, "batch": DEFAULT_BATCH_SIZE, "canvas": 256,
          "kernels_slices_per_s": n / fast_s, "plain_slices_per_s": n / slow_s,
          "kernels_s": runs["kernels"], "plain_s": runs["plain"],
          "golden_slices": len(golden),
          "converged": int(conv.sum()), "mask_area": int(masks.sum()),
          "launches": launches, "unfused_launches": unfused_launches,
          "canvas1024_mask_area": int(big_fast["mask"].sum())})

    # -- 4. the batch drivers -------------------------------------------------
    with tempfile.TemporaryDirectory(prefix="nm03_driver_") as tmp:
        driver_launches, driver_out = driver_phase(Path(tmp), smi, kernels, reset)
        # -- 5. single-slice serving --------------------------------------
        serve_launches = serve_phase(driver_out, smi, kernels, reset)
        # -- 6. the 3D volume path ----------------------------------------
        volume_launches = volume_phase(Path(tmp), driver_out["cohort"], study, smi,
                                       kernels, reset)

    # -- 7. kernels ----------------------------------------------------------
    meta = {
        "median": ("vector_median_filter", "csrc/median.cu",
                   "nm03_capstone_project_tpu/ops/pallas_median.py:101"),
        "fused": ("fused_preprocess", "csrc/fused.cu",
                  "nm03_capstone_project_tpu/ops/pallas_median.py:165"),
        "grow": ("region_grow", "csrc/grow.cu",
                 "nm03_capstone_project_tpu/ops/pallas_region_growing.py:30"),
    }
    rows = []
    for key, (name, src, replaces) in meta.items():
        r = results[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"nm03_capstone_project_tpu_torch/{src}", "replaces": replaces,
            "launches": driver_launches[key], "slice_launches": launches[key],
            "serve_launches": serve_launches[key],
            "volume_launches": volume_launches[key],
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    emit({"kernels": rows})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 a failed phase fails the run, after its traceback
        traceback.print_exc()
        sys.exit(1)
