#!/usr/bin/env python3
"""Where the port's fused and grow kernels spend their time, on the card.

    python scripts/torch_kernel_probe.py            # both kernels
    python scripts/torch_kernel_probe.py fused      # or one of them

Run from the repository root on a machine with an NVIDIA H100 and the CUDA
toolkit; it needs no profiler such as ``ncu``. The script builds copies of
``nm03_capstone_project_tpu_torch/csrc/{fused,grow}.cu`` into the
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
  and block of 16 steps together, then of each exchange and block.

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
