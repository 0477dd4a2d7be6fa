#!/usr/bin/env python3
"""Where the port's fused, grow, wide median and sharpen kernels spend their time, on the card.

    python scripts/torch_kernel_probe.py            # every probe
    python scripts/torch_kernel_probe.py fused      # or one of fused, grow, grow_global, wide,
                                                    # sharpen

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit; it needs no profiler such as ``ncu``. The script builds copies of
``nm03_capstone_project_tpu_torch/csrc/{fused,grow,median}.cu`` into the
git-ignored ``nm03_capstone_project_tpu_torch/_build/probe/``, with
``clock64()`` stamps written by thread 0 of each CTA at the phase
boundaries, and prints one JSON line per measurement:

* ``fused``: at the main path's shape (25, 256, 256), k = 7, the kernel's
  time a launch (CUDA events over 50 launches) as built and stamped, the
  cycles of each phase of a CTA's first tile (stage, median, vertical blur
  with the edge pad, horizontal blur and store), the same kernel without
  its median (the medians replaced by a copy: the cost of everything
  else), and the SASS opcode mix (``cuobjdump``, where the toolkit has it);
* ``grow``: a batch of 25 slices of 256 x 256 all in the band, seeded at
  the centre, so the region grows for every step ``max_iters`` allows; the
  time a launch at 16, 48 and 160 steps for clusters of 2, 4 and 8 CTAs,
  and, at 48 steps, the cycles of packing, of the first barrier, exchange
  and block of 16 steps together, then of each exchange and block;
* ``grow_global``: the global route at 4096 x 4096 x 2 (two phantoms), its
  time a launch as built and stamped, and for each super-step the tiles
  stepped and the slowest CTA's tile load, steps, write and grid barrier
  (``%globaltimer`` stamps, comparable across SMs);
* ``wide``: the median's wide route at k = 65 on the canvas-256
  ``process_batch``'s median input (two phantoms, (2, 256, 256)) and on
  random data of that shape, and at k = 127 on random (1, 64, 64): the
  time a launch for band heights from 1 row to the whole slice, the
  wrapper's own choice marked (``wide_launch_shape``), and at each
  height the cycles of a CTA's first tile in its sort (load and bitonic
  network) and in its walk down the band (upkeep and bisection), the
  median over the CTAs;
* ``sharpen``: the sharpen kernel at 9 and 33 taps on random (25, 256, 256)
  (the main batch's shape) and (2, 3072, 3072) (the canvas-3072
  ``process_batch``'s): the device time a launch (torch.profiler over 20
  launches, the input warm in L2) of the wrapper's plan
  (``sharpen_launch_shape``), and of 32 x 64, 64 x 64 and 32 x 128 tiles
  with one tile a CTA and with four CTAs an SM walking them: as built;
  without the blur (staging and stores only: the design's memory time),
  the same staged through registers in place of cp.async, and with no
  staging at all (each centre read and stored); the whole kernel staged
  through registers; with 16-row vertical windows; capped at 40 and 32
  registers (six and eight CTAs an SM). At the wrapper's plan, the phases
  of each CTA's first tile (``%globaltimer`` stamps of the first 2048
  CTAs: landed, vertical pass, horizontal pass and stores, and when the
  CTAs end). Beside them the staged plan (one tile a CTA), a torch
  copy of the same bytes, plain copy kernels of six CTA shapes (their
  CTAs' start spread and ends), and each sharpen kernel's registers and
  spills from the build's ptxas log.

Every line carries the card's name and power limit. Nothing here is used
by the port.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from nm03_capstone_project_tpu_torch.kernels import build  # noqa: E402
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm  # noqa: E402
from nm03_capstone_project_tpu_torch.ops.sharpen import gaussian_kernel_1d  # noqa: E402

OUT = build.PKG / "_build" / "probe"
STAMPS = "__device__ long long g_stamp[2048 * 16];\n"
READ = ('extern "C" int probe_read(long long* h) '
        "{ return (int)cudaMemcpyFromSymbol(h, g_stamp, sizeof(g_stamp)); }\n")


def stamp(slot: str) -> str:
    return f"if (threadIdx.x == 0) g_stamp[blockIdx.x * 16 + ({slot})] = clock64();\n"


def write(path: Path, text: str) -> None:
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def variant(name: str, source: str, subs) -> Path:
    """Write csrc/<source>.cu with ``subs`` applied, and the headers."""
    src = (build.CSRC / f"{source}.cu").read_text()
    src = src.replace("namespace {\n", STAMPS + READ + "namespace {\n", 1)
    for old, new in subs:
        if old not in src:
            raise RuntimeError(f"probe {name}: the source no longer has {old[:60]!r}")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for header, text in build.headers().items():
        write(d / header, text)
    write(d / f"{source}.cu", src)
    return d


def compile_all(dirs) -> dict:
    def one(item):
        name, (d, source) = item
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(d), "-o", str(d / "lib.so"),
               str(d / f"{source}.cu")]
        p = subprocess.run(cmd, capture_output=True, text=True)
        if p.returncode:
            raise RuntimeError(f"probe {name}: nvcc failed\n{p.stdout}{p.stderr}")
        # nm03-lint: disable=NM361 the probe builds an instrumented copy of a kernel in its own scratch directory, never the build key's
        return name, ctypes.CDLL(str(d / "lib.so"))

    with ThreadPoolExecutor(len(dirs)) as ex:
        return dict(ex.map(one, dirs.items()))


def event_ms(fn, n: int = 50) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def stamps(lib) -> np.ndarray:
    buf = np.zeros(2048 * 16, np.int64)
    lib.probe_read.argtypes = [ctypes.c_void_p]
    if lib.probe_read(buf.ctypes.data) != 0:
        raise RuntimeError("probe: reading the stamps failed")
    return buf.reshape(2048, 16)


def sass_mix(lib_path: Path, top: int = 12) -> dict:
    tool = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "cuobjdump"
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True,
                          text=True).stdout
    ops: dict = {}
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]+)", sass):
        ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    return dict(sorted(ops.items(), key=lambda kv: -kv[1])[:top])


def probe_fused(card: dict) -> None:
    tile = "    const float* xb = x + (size_t)b * H * W;\n"
    first = "t == blockIdx.x && "
    phases = [
        (tile, tile + "    " + stamp("0").replace("if (", "if (" + first)),
        ("      in[i * L.iws + j] = fminf(fmaxf(n, p.clip_low), p.clip_high);\n    }\n"
         "    __syncthreads();\n",
         "      in[i * L.iws + j] = fminf(fmaxf(n, p.clip_low), p.clip_high);\n    }\n"
         "    __syncthreads();\n    " + stamp("1").replace("if (", "if (" + first)),
        ("      MedianRun<K, R>::run(in + i * L.iws + j * R, L.iws, M + (mo + i) * L.mws + j * R);"
         "\n    }\n    __syncthreads();\n",
         "      MedianRun<K, R>::run(in + i * L.iws + j * R, L.iws, M + (mo + i) * L.mws + j * R);"
         "\n    }\n    __syncthreads();\n    " + stamp("2").replace("if (", "if (" + first)),
        ("    // 4. horizontal pass", "    " + stamp("3").replace("if (", "if (" + first)
         + "    // 4. horizontal pass"),
        ("    __syncthreads();  // the next tile overwrites in, V and M\n",
         "    __syncthreads();  // the next tile overwrites in, V and M\n    "
         + stamp("4").replace("if (", "if (" + first)),
    ]
    no_median = [("      MedianRun<K, R>::run(in + i * L.iws + j * R, L.iws, M + (mo + i) * L.mws + j * R);",
                  "      for (int l = 0; l < R; ++l)\n"
                  "        M[(mo + i) * L.mws + j * R + l] = in[(i + r) * L.iws + j * R + l + r];")]
    dirs = {"fused": (variant("fused", "fused", []), "fused"),
            "fused_stamped": (variant("fused_stamped", "fused", phases), "fused"),
            "fused_no_median": (variant("fused_no_median", "fused", no_median), "fused")}
    libs = compile_all(dirs)
    x = (torch.rand((25, 256, 256), generator=torch.Generator().manual_seed(1)) * 4000).cuda()
    out = torch.empty_like(x)
    want = hm._fused_preprocess_plain(x)
    th, tw, grid, _ = hm.fused_launch_shape(25, 256, 256, 7, 9,
                                            torch.cuda.get_device_properties(0).multi_processor_count)
    taps = gaussian_kernel_1d(0.5, 9)
    c_taps = (ctypes.c_float * 9)(*[float(t) for t in taps])
    result = {"probe": "fused", "shape": [25, 256, 256], "k": 7, "tile": [th, tw], "grid": grid}
    for name, lib in libs.items():
        f = lib.nm03_fused_preprocess
        f.argtypes = build.ARGTYPES["fused"]["nm03_fused_preprocess"]
        f.restype = ctypes.c_int

        def call():
            err = f(x.data_ptr(), out.data_ptr(), 25, 256, 256, 7, 0.0, 2.0 / 10000.0, 0.5,
                    0.68, 4000.0, 2.0, ctypes.cast(c_taps, ctypes.c_void_p), 9, th, tw, grid,
                    torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe {name}: CUDA error {err}")

        result[f"{name}_ms"] = event_ms(call)
        if name != "fused_no_median" and not torch.equal(out, want):
            raise RuntimeError(f"probe {name}: the kernel no longer equals the plain version")
        if name == "fused_stamped":
            st = stamps(lib)[:grid, :5]
            cycles = np.diff(st, axis=1)
            result["phase_cycles_mean"] = dict(zip(
                ("stage", "median", "vertical_blur", "horizontal_blur_store"),
                cycles.mean(0).round().astype(int).tolist()))
            result["tile_cycles_max"] = int((st[:, 4] - st[:, 0]).max())
    result["sass_mix"] = sass_mix(dirs["fused"][0] / "lib.so")
    print(json.dumps({**result, **card}), flush=True)


def probe_grow(card: dict) -> None:
    subs = [
        ("  pack_rows(image,", "  " + stamp("0") + "  pack_rows(image,"),
        ("  cluster.sync();  // every CTA of the cluster has started before any writes another\n",
         "  " + stamp("1") + "  cluster.sync();  // every CTA of the cluster has started before"
         " any writes another\n  int n_stamp = 2;\n"),
        ("      done += s;\n      count = exchange(", "      done += s;\n      " +
         stamp("n_stamp++ & 15").replace("if (", "if (n_stamp < 15 && ") + "      count = exchange("),
        ("      count = exchange(cluster, hl, sm + n * (1 + p), red, sums0);\n    }\n",
         "      count = exchange(cluster, hl, sm + n * (1 + p), red, sums0);\n      " +
         stamp("n_stamp++ & 15").replace("if (", "if (n_stamp < 15 && ") + "    }\n"),
    ]
    libs = compile_all({"grow": (variant("grow", "grow", []), "grow"),
                        "grow_stamped": (variant("grow_stamped", "grow", subs), "grow")})
    b, h, w = 25, 256, 256
    img = torch.full((b, h, w), 0.8, device="cuda")
    seeds = torch.zeros((b, h, w), dtype=torch.uint8, device="cuda")
    seeds[:, h // 2, w // 2] = 1
    valid = torch.ones_like(seeds)
    mask = torch.empty_like(seeds)
    conv = torch.empty((b,), dtype=torch.int32, device="cuda")
    steps = torch.empty_like(conv)
    for name, lib in libs.items():
        f = lib.nm03_region_grow
        f.argtypes = build.ARGTYPES["grow"]["nm03_region_grow"]
        f.restype = ctypes.c_int
        for cluster in (2, 4, 8):
            times = {}
            for max_iters in (16, 48, 160):
                def call():
                    err = f(img.data_ptr(), seeds.data_ptr(), valid.data_ptr(), mask.data_ptr(),
                            conv.data_ptr(), steps.data_ptr(), b, h, w, 0.74, 0.91, 4, 16,
                            max_iters, cluster, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"probe {name}: CUDA error {err}")

                times[max_iters] = event_ms(call)
                if int(steps[0]) != max_iters:
                    raise RuntimeError(f"probe {name}: ran {int(steps[0])} steps, not {max_iters}")
            line = {"probe": name, "shape": [b, h, w], "cluster": cluster,
                    "ms_at_steps": times}
            if name == "grow_stamped":
                call_48 = lambda: f(img.data_ptr(), seeds.data_ptr(), valid.data_ptr(),  # noqa: E731
                                    mask.data_ptr(), conv.data_ptr(), steps.data_ptr(), b, h, w,
                                    0.74, 0.91, 4, 16, 48, cluster,
                                    torch.cuda.current_stream().cuda_stream)
                call_48()
                torch.cuda.synchronize()
                st = stamps(lib)[: b * cluster, :8]
                d = np.diff(st, axis=1).mean(0).round().astype(int).tolist()
                line["cycles_at_48_steps"] = {
                    "pack": d[0], "barrier_exchange_and_16_steps": d[1],
                    "then_exchange_16_steps_alternating": d[2:7]}
            print(json.dumps({**line, **card}), flush=True)


GLOBAL_SUPERSTEPS = 40  # super-steps stamped a CTA (slots of g_stamp: 132 x 40 x 6)


def probe_grow_global(card: dict) -> None:
    """The global grow route at 4096 x 4096 x 2 (two phantoms, as
    chip_smoke.py's envelope phase grows them): ``%globaltimer`` stamps by
    thread 0 of each CTA at each super-step's start, after its tile load,
    after its steps, after its write, and before and after the grid
    barrier; per super-step the tiles stepped and the slowest of each
    phase."""
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas, valid_mask
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice
    from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
    from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges
    from nm03_capstone_project_tpu_torch.ops.seeds import seed_mask

    ns = GLOBAL_SUPERSTEPS

    def st(slot: int) -> str:
        return ('{ unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); '
                f"if (threadIdx.x == 0 && gs < {ns}) "
                f"g_stamp[((size_t)blockIdx.x * {ns} + gs) * 6 + {slot}] = (long long)t_; }}\n")

    subs = [
        ("      const uint32_t* cur = p ? buf1 : buf0;\n",
         "      const uint32_t* cur = p ? buf1 : buf0;\n" + st(0)),
        ("          __syncthreads();\n          // s steps;",
         "          __syncthreads();\n" + st(1) + "          // s steps;"),
        ("          // the own words out, and their popcount\n",
         st(2) + "          // the own words out, and their popcount\n"),
        ("          if (!g.resident) q = 0;\n", st(3) + "          if (!g.resident) q = 0;\n"),
        ("      grid.sync();\n      p ^= 1;\n", st(4) + "      grid.sync();\n" + st(5) + "      p ^= 1;\n"),
    ]
    libs = compile_all({"grow_global": (variant("grow_global", "grow", []), "grow"),
                        "grow_global_stamped": (variant("grow_global_stamped", "grow", subs),
                                                "grow")})
    cfg = PipelineConfig(canvas=256)
    c = 4096
    dims = [(c, c), (c - c // 8, c - c // 5)]
    bt = pad_to_canvas([phantom_slice(h, w, seed=10 + i, lesion_radius=0.12)
                        for i, (h, w) in enumerate(dims)], (c, c), device="cuda")
    pre = dict(norm_low=cfg.norm_low, norm_high=cfg.norm_high,
               norm_min=cfg.norm_intensity_min, norm_max=cfg.norm_intensity_max,
               clip_low=cfg.clip_low, clip_high=cfg.clip_high, median_window=cfg.median_window,
               sharpen_gain=cfg.sharpen_gain, sharpen_sigma=cfg.sharpen_sigma,
               sharpen_kernel=cfg.sharpen_kernel)
    img = hm._fused_preprocess_plain(extend_edges(bt.pixels, bt.dims), **pre).contiguous()
    seeds = seed_mask(bt.dims, (c, c)).contiguous().view(torch.uint8)
    valid = valid_mask(bt.dims, (c, c)).contiguous().view(torch.uint8)
    b, h, w = img.shape
    tiles = hg.global_tiles(b, h, w, cfg.grow_block_iters,
                            torch.cuda.get_device_properties(0).multi_processor_count)
    words = h * ((w + 31) // 32)
    mask = torch.empty((b, h, w), dtype=torch.uint8, device="cuda")
    conv = torch.empty((b,), dtype=torch.int32, device="cuda")
    steps = torch.empty_like(conv)
    packed = torch.empty((3, b * words), dtype=torch.int32, device="cuda")
    scratch = torch.empty((5 * b + 3 * tiles.tiles,), dtype=torch.int32, device="cuda")
    for name, lib in libs.items():
        f = lib.nm03_region_grow_global
        f.argtypes = build.ARGTYPES["grow"]["nm03_region_grow_global"]
        f.restype = ctypes.c_int

        def call():
            scratch.zero_()
            err = f(img.data_ptr(), seeds.data_ptr(), valid.data_ptr(), mask.data_ptr(),
                    conv.data_ptr(), steps.data_ptr(), packed[0].data_ptr(),
                    packed[1].data_ptr(), packed[2].data_ptr(), scratch.data_ptr(), b, h, w,
                    cfg.grow_low, cfg.grow_high, 4, cfg.grow_block_iters, cfg.grow_max_iters,
                    tiles.rows, tiles.words, tiles.halo, tiles.pitch, tiles.grid,
                    torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"probe {name}: CUDA error {err}")

        line = {"probe": name, "shape": [b, h, w], "tiles": tiles._asdict(),
                "ms": event_ms(call, 10), "steps": steps.tolist()}
        if name == "grow_global_stamped":
            lib.probe_read.argtypes = [ctypes.c_void_p]
            call()
            torch.cuda.synchronize()
            st_ = stamps(lib).reshape(-1)[: 2048 * 16 // (ns * 6) * ns * 6]
            st_ = st_.reshape(-1, ns, 6)[: tiles.grid]
            per = []
            for gs in range(ns):
                a = st_[:, gs]
                if not (a[:, 0] > 0).any():
                    break
                busy = a[:, 1] > 0
                us = lambda x: round(float(x) / 1e3, 3)  # noqa: E731
                per.append({"busy_tiles": int(busy.sum()),
                            "load_us": us((a[busy, 1] - a[busy, 0]).max()) if busy.any() else 0,
                            "steps_us": us((a[busy, 2] - a[busy, 1]).max()) if busy.any() else 0,
                            "write_us": us((a[busy, 3] - a[busy, 2]).max()) if busy.any() else 0,
                            "barrier_us": us(a[:, 5].max() - a[:, 4].max()),
                            "superstep_us": us(a[:, 5].max() - a[:, 0].min())})
            line["supersteps"] = len(per)
            line["median_of_later_supersteps"] = {
                k: float(np.median([r[k] for r in per[1:]])) for k in per[0]}
            line["first_superstep"] = per[0]
        print(json.dumps({**line, **card}), flush=True)


def probe_wide(card: dict) -> None:
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice
    from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize
    from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges

    first = "if (tile == blockIdx.x) "
    row_end = ("      __syncthreads();  // the next row moves the segments, or the next tile "
               "loads them\n    }\n")
    d = variant("wide", "median", [
        ("    // 1. row y0's segments, then a bitonic sort of each\n",
         "    " + first + "{" + stamp("0") + "}\n    // 1. row y0's segments, then a bitonic "
         "sort of each\n"),
        ("    for (int y = y0; y < y1; ++y) {\n      // 2. down one row",
         "    " + first + "{" + stamp("1") + "}\n    for (int y = y0; y < y1; ++y) {\n"
         "      // 2. down one row"),
        (row_end, row_end + "    " + first + "{" + stamp("2") + "}\n"),
    ])
    lib = compile_all({"wide": (d, "median")})["wide"]
    lib.nm03_median_wide.argtypes = build.ARGTYPES["median"]["nm03_median_wide"]
    cfg = PipelineConfig(canvas=256)
    dims = [(256, 256), (224, 205)]  # testdata/envelope_wide_golden.json
    bt = pad_to_canvas([phantom_slice(a, b, seed=40 + i, lesion_radius=0.2)
                        for i, (a, b) in enumerate(dims)], (256, 256), device="cuda")
    mx = clip_intensity(normalize(extend_edges(bt.pixels, bt.dims), cfg.norm_low, cfg.norm_high,
                                  cfg.norm_intensity_min, cfg.norm_intensity_max),
                        cfg.clip_low, cfg.clip_high)
    gen = torch.Generator(device="cpu").manual_seed(65)
    cases = [("phantoms", mx, 65),
             ("random", (torch.rand((2, 256, 256), generator=gen) * 4000 + 0.68).cuda(), 65),
             ("random", (torch.rand((1, 64, 64), generator=gen) * 4000 + 0.68).cuda(), 127)]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    for name, x, k in cases:
        b, h, w = x.shape
        per_sm = hm._wide_ctas_per_sm(0, k)  # the runtime's, as the wrapper takes it
        chosen = hm.wide_launch_shape(b, h, w, k, n_sm, per_sm)
        out = torch.empty_like(x)
        want = hm.vector_median_filter_kernel(x, k)
        bands = {}
        for rows in sorted({1, 2, 4, 8, 16, 32, 64, h, chosen.rows} & set(range(1, h + 1))):
            shape = chosen._replace(rows=rows)
            tiles = b * -(-h // rows) * -(-w // hm.WIDE_COLS)
            grid = min(tiles, shape.grid if rows == chosen.rows else n_sm * per_sm)
            scratch = (torch.empty(grid * hm.wide_segment_bytes(k) // 4, dtype=torch.int32,
                                   device="cuda") if shape.scratch else None)

            def call():
                err = lib.nm03_median_wide(x.data_ptr(), out.data_ptr(),
                                           None if scratch is None else scratch.data_ptr(), 0,
                                           b, h, w, k, rows, grid, stream)
                build.check(err, "nm03_median_wide (probe)")

            ms = event_ms(call, n=20)
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                raise RuntimeError(f"probe wide: {name} k={k} rows={rows} differs")
            st = stamps(lib)[:grid]
            bands[rows] = {"tiles": tiles, "grid": grid, "ms": ms,
                           "sort_cycles": float(np.median(st[:, 1] - st[:, 0])),
                           "walk_cycles": float(np.median(st[:, 2] - st[:, 1]))}
        print(json.dumps({"probe": "wide", "case": name, "shape": [b, h, w], "k": k,
                          "chosen_rows": chosen.rows, "ctas_per_sm": per_sm, "bands": bands,
                          **card}), flush=True)


def ptxas_sharpen() -> dict:
    """Registers and spill bytes of each sharpen kernel in the build's ptxas log."""
    from chip_smoke import ptxas_report

    log = build.build_dir() / "fused.log"
    report = ptxas_report(log.read_text()) if log.exists() else {}
    return {k: v for k, v in report.items() if "sharpen" in k}


def device_ms(fn, n: int = 20) -> float:
    """The device time a call of ``fn``: torch.profiler's self device time
    of every kernel and copy in a window of ``n`` calls, over ``n``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()) / n / 1e3


SHARPEN_TILES = ((32, 64), (64, 64), (32, 128))


def sharpen_variants() -> dict:
    """Copies of the windowed sharpen kernel (``csrc/fused.cu``), by name:
    substitutions on its source."""
    kernel = ("template <int KS>\n__global__ void __launch_bounds__(SHARPEN_THREADS)\n"
              "windowed_sharpen_kernel")
    timer = ('{ unsigned long long g; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g)); '
             "if (threadIdx.x == 0 && blockIdx.x < 2048) "
             "g_stamp[blockIdx.x * 16 + (SLOT)] = (long long)g; }\n")
    first = "if (tt == blockIdx.x) "
    vertical = "for (int q = threadIdx.x; q < nvc * (TH / WIN_SEG); q += SHARPEN_THREADS) {"
    no_blur = [(vertical, vertical.replace("nvc * (TH / WIN_SEG)", "0")),
               ("o[u] = __fadd_rn(c[u], __fmul_rn(gain, __fsub_rn(c[u], acc[u])));",
                "o[u] = c[u];")]
    ldg = [("        cp_async16(dst, row + cx);",
            "        *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>("
            "row + cx));"),
           ("for (int e = 0; e < 4; ++e) cp_async4(dst + e, row + clampi(cx + e, 0, W - 1));",
            "for (int e = 0; e < 4; ++e) dst[e] = __ldg(row + clampi(cx + e, 0, W - 1));")]
    end = "    __syncthreads();  // the next tile stages into S and overwrites V\n  }\n}"
    # a plain copy of float4s, PER a thread, its CTAs stamped at start and end
    copy = ("}  // namespace\n", "}  // namespace\n"
            "template <int PER> __global__ void probe_copy_kernel(const float4* x, float4* y, "
            "long long n) {\n" + timer.replace("SLOT", "8")
            + "  long long i = (long long)blockIdx.x * blockDim.x * PER + threadIdx.x;\n"
            "  float4 v[PER];\n"
            "#pragma unroll\n  for (int k = 0; k < PER; ++k) if (i + k * blockDim.x < n) "
            "v[k] = x[i + k * blockDim.x];\n"
            "#pragma unroll\n  for (int k = 0; k < PER; ++k) if (i + k * blockDim.x < n) "
            "y[i + k * blockDim.x] = v[k];\n  __syncthreads();\n"
            + timer.replace("SLOT", "9") + "}\n"
            'extern "C" int probe_copy(const float* x, float* y, long long n, int threads, '
            "int per, void* stream) {\n  const long long n4 = n / 4, g = (n4 + (long long)"
            "threads * per - 1) / (threads * per);\n  cudaStream_t s = (cudaStream_t)stream;\n"
            "  if (per == 1) probe_copy_kernel<1><<<g, threads, 0, s>>>((const float4*)x, "
            "(float4*)y, n4);\n  else if (per == 2) probe_copy_kernel<2><<<g, threads, 0, s>>>"
            "((const float4*)x, (float4*)y, n4);\n  else probe_copy_kernel<4><<<g, threads, 0, "
            "s>>>((const float4*)x, (float4*)y, n4);\n  return (int)cudaGetLastError();\n}\n")
    return {
        # globaltimer stamps: start, first tile landed, vertical pass, first tile done, end
        "stamped": [
            ("  const FastDiv div_cpr(cpr);\n",
             "  const FastDiv div_cpr(cpr);\n" + timer.replace("SLOT", "0")),
            ("    cp_async_wait_all();\n    __syncthreads();\n",
             "    cp_async_wait_all();\n    __syncthreads();\n    " + first
             + timer.replace("SLOT", "1")),
            ("    __syncthreads();\n\n    // horizontal pass and",
             "    __syncthreads();\n    " + first + timer.replace("SLOT", "2")
             + "\n    // horizontal pass and"),
            (end, end[:-5] + "    " + first + timer.replace("SLOT", "3") + "  }\n  "
             + timer.replace("SLOT", "4") + "}"),
            copy],
        # the staging and the centres' stores only: the design's memory time
        "no_blur": no_blur,
        # the same with 16-byte loads through registers in place of cp.async
        "no_blur_ldg": no_blur + ldg,
        # no staging at all: each centre read from global and stored (the kernel's
        # CTAs, shared memory and barriers around a plain copy's traffic)
        "no_staging": no_blur + [
            ("for (int idx = threadIdx.x; idx < chunks; idx += SHARPEN_THREADS) {",
             "for (int idx = threadIdx.x; idx < 0; idx += SHARPEN_THREADS) {"),
            ("      const float4 c4 = *reinterpret_cast<const float4*>(S + (y + rs) * L.ss + RSP + xx);",
             "      const float4 c4 = __ldg(reinterpret_cast<const float4*>(m + (size_t)b * H * W"
             " + (size_t)(y0 + y) * W + x0 + xx));")],
        # the whole kernel staged through registers
        "ldg": ldg,
        # sixteen rows a vertical window in place of eight
        "seg16": [("constexpr int WIN_SEG = 8;", "constexpr int WIN_SEG = 16;")],
        # at most 40 and 32 registers a thread: six and eight CTAs an SM
        "six_per_sm": [(kernel, kernel.replace("(SHARPEN_THREADS)", "(SHARPEN_THREADS, 6)"))],
        "eight_per_sm": [(kernel, kernel.replace("(SHARPEN_THREADS)", "(SHARPEN_THREADS, 8)"))],
    }


def probe_sharpen(card: dict) -> None:
    from nm03_capstone_project_tpu_torch.ops.sharpen import sharpen

    dirs = {name: (variant(f"sharpen_{name}", "fused", subs), "fused")
            for name, subs in sharpen_variants().items()}
    libs = {"built": build.load("fused"), **compile_all(dirs)}
    for lib in libs.values():
        lib.nm03_sharpen.argtypes = build.ARGTYPES["fused"]["nm03_sharpen"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(19)
    windowed = hm.PLANS.index("windowed")
    print(json.dumps({"probe": "sharpen_ptxas", "kernels": ptxas_sharpen(), **card}), flush=True)

    for name, shape in (("main", (25, 256, 256)), ("canvas3072", (2, 3072, 3072))):
        b, h, w = shape
        x = (torch.rand(shape, generator=gen) * 4000 + 0.68).cuda()
        out = torch.empty_like(x)
        copy_ms = device_ms(lambda: out.copy_(x))
        for ks in (9, 33):
            want = sharpen(x, 2.0, 0.5, ks)
            taps = hm._device_taps(0.5, ks, x.device)
            chosen = hm.sharpen_launch_shape(b, h, w, ks, n_sm)

            def time_plan(lib, plan, th, tw, grid, check=True):
                def call():
                    build.check(lib.nm03_sharpen(x.data_ptr(), out.data_ptr(), taps.data_ptr(),
                                                 None, b, h, w, ks, 2.0, th, tw, plan, grid,
                                                 stream), "nm03_sharpen (probe)")

                out.fill_(float("nan"))
                ms = device_ms(call)
                torch.cuda.synchronize()
                if check and not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                    raise RuntimeError(f"probe sharpen: {name} {ks} taps, plan {plan}, "
                                       f"{th}x{tw}, grid {grid} differs from the plain sharpen")
                return ms

            def sweep(lname):
                lib, check = libs[lname], not lname.startswith("no_")
                res = {}
                for th, tw in SHARPEN_TILES:
                    tiles = b * -(-h // th) * -(-w // tw)
                    res[f"{th}x{tw}"] = {p: time_plan(lib, windowed, th, tw, g, check) for p, g in (
                        ("one_tile_a_cta_ms", tiles), ("four_ctas_an_sm_ms", min(tiles, 4 * n_sm)))}
                return res

            result = {"probe": "sharpen", "case": name, "shape": list(shape), "taps": ks,
                      "chosen": chosen._asdict(), "torch_copy_ms": copy_ms,
                      "chosen_ms": time_plan(libs["built"], windowed, chosen.tile_h,
                                             chosen.tile_w, chosen.grid),
                      **{v: sweep(v) for v in ("built", "no_blur", "no_blur_ldg", "no_staging",
                                               "ldg", "seg16", "six_per_sm", "eight_per_sm")},
                      "staged_plan_ms": time_plan(libs["built"], hm.PLANS.index("staged"), 32, 64,
                                                  b * -(-h // 32) * -(-w // 64))}
            lib = libs["stamped"]
            result["stamped_ms"] = time_plan(lib, windowed, chosen.tile_h, chosen.tile_w,
                                             chosen.grid)
            st = stamps(lib)[:min(chosen.grid, 2048), :5].astype(np.float64)
            t0 = st[:, 0].min()
            result["stamps_ns"] = {
                "ctas_stamped": len(st),
                "span": float(st[:, 4].max() - t0),
                "start_spread": float(st[:, 0].max() - t0),
                "first_tile_landed": float(np.median(st[:, 1] - st[:, 0])),
                "vertical": float(np.median(st[:, 2] - st[:, 1])),
                "horizontal_and_store": float(np.median(st[:, 3] - st[:, 2])),
                "cta_life": float(np.median(st[:, 4] - st[:, 0])),
                "ends_q50_q90_q100": [float(np.quantile(st[:, 4] - t0, q))
                                      for q in (0.5, 0.9, 1.0)]}
            if ks == 9 and name == "main":  # plain copies of the same bytes, by CTA shape
                lib.probe_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
                copies = {}
                for threads, per in ((256, 1), (256, 2), (256, 4), (128, 4), (1024, 1),
                                     (1024, 4)):
                    def call():
                        build.check(lib.probe_copy(x.data_ptr(), out.data_ptr(), x.numel(),
                                                   threads, per, stream), "probe_copy")

                    ms = device_ms(call)
                    g = -(-x.numel() // 4 // (threads * per))
                    st = stamps(lib)[:min(g, 2048), 8:10].astype(np.float64)
                    t0 = st[:, 0].min()
                    copies[f"{threads}x{per}"] = {
                        "ctas": g, "ms": ms, "start_spread_ns": float(st[:, 0].max() - t0),
                        "ends_q50_q100_ns": [float(np.quantile(st[:, 1] - t0, q))
                                             for q in (0.5, 1.0)]}
                if not torch.equal(out, x):
                    raise RuntimeError("probe sharpen: the copy kernel differs")
                result["copy_kernels"] = copies
            print(json.dumps({**result, **card}), flush=True)

def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_probe: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    card = {"nvidia_smi": smi.strip().splitlines()[0]}
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "fused"):
        probe_fused(card)
    if which in ("all", "grow"):
        probe_grow(card)
    if which in ("all", "grow_global"):
        probe_grow_global(card)
    if which in ("all", "wide"):
        probe_wide(card)
    if which in ("all", "sharpen"):
        probe_sharpen(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
