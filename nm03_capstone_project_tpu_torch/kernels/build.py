"""Build the port's CUDA sources into shared libraries, loaded with ctypes.

Each ``csrc/<name>.cu`` becomes ``lib<name>.so``, compiled on first use
with ``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`` (Hopper, plain C entry points, no PyTorch headers). All
missing libraries are compiled together, one ``nvcc`` process per source.
The median kernels include headers generated here from
:mod:`ops.selection_network`, so their straight-line min/max code is the
plan the plain PyTorch median runs:

* ``median_plans.cuh``: ``median_plan<K>``, the unshared plan per pixel, for
  the standalone median (``median.cu``);
* ``median_runs.cuh``: ``MedianRun<K, R>``, presort plus shared plan over a
  run of R adjacent medians (:mod:`.median_runs`), for the fused
  preprocess kernel (``fused.cu``).

Libraries go into ``_build/<key>/`` beside this package, where ``key``
hashes the sources, the generated headers and the flags: an edited source
is rebuilt, an unchanged one is loaded. Sources come from the package only.
The port's lint holds the key to the build (NM381): every module constant
:func:`build_all` reads must be read by :func:`build_dir` too.

Every C entry point takes its pointers and the CUDA stream as
``ctypes.c_void_p`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

from nm03_capstone_project_tpu_torch.kernels import median_runs
from nm03_capstone_project_tpu_torch.ops.selection_network import median_merge_plan

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
SOURCES = ("median", "fused", "grow")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
MEDIAN_WINDOWS = (1, 3, 5, 7, 9, 11, 13, 15)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
ARGTYPES = {
    "median": {
        "nm03_median_filter": [_P, _P, _I, _I, _I, _I, _P],
    },
    "fused": {
        "nm03_fused_preprocess": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                                  _P, _I, _I, _I, _I, _P],
    },
    "grow": {
        "nm03_region_grow": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _I,
                             _P],
    },
}


def median_plans_header() -> str:
    """CUDA source of ``median_plan<K>`` for every K in MEDIAN_WINDOWS.

    ``median_plan<K>(s, ps)`` runs ``median_merge_plan(K, share=False)``
    for one pixel: ``s[a * ps + d]`` is the a-th smallest of the K vertical
    neighbors in the window column at offset d from the pixel. The plan's
    intermediates are all read at offset 0, so each becomes one register.
    """
    lines = [
        "// Generated by nm03_capstone_project_tpu_torch/kernels/build.py from",
        "// ops/selection_network.py: median_merge_plan(K, share=False).",
        "#pragma once",
        "template <int K> __device__ __forceinline__ float median_plan(const float*, int);",
    ]
    for k in MEDIAN_WINDOWS:
        plan = median_merge_plan(k, share=False)
        r = k // 2
        body = []

        def name(i: int, sh: int) -> str:
            if i < k:
                return f"x{i}_{sh + r}"
            if sh != 0:
                raise AssertionError("unshared plan read an intermediate at a shift")
            return f"v{i}"

        used = sorted({(a, ash) for _, _, a, ash, _, _ in plan.ops if a < k}
                      | {(b, bsh) for _, _, _, _, b, bsh in plan.ops if b < k}
                      | ({plan.out} if plan.out[0] < k else set()))
        for i, sh in used:
            body.append(f"  const float {name(i, sh)} = s[{i} * ps + ({sh})];")
        for kind, out, a, ash, b, bsh in plan.ops:
            fn = "fminf" if kind == "min" else "fmaxf"
            body.append(
                f"  const float v{out} = {fn}({name(a, ash)}, {name(b, bsh)});"
            )
        body.append(f"  return {name(*plan.out)};")
        lines.append(
            f"template <> __device__ __forceinline__ float median_plan<{k}>"
            "(const float* s, int ps) {"
        )
        lines.extend(body)
        lines.append("}")
    return "\n".join(lines) + "\n"


def median_runs_header() -> str:
    """CUDA source of ``MedianRun<K, R>`` and ``FusedRuns<K>::R`` for every K
    in MEDIAN_WINDOWS, R = ``median_runs.FUSED_RUNS[K]``."""
    lines = [
        "// Generated by nm03_capstone_project_tpu_torch/kernels/build.py from",
        "// kernels/median_runs.py: presort plus median_merge_plan(K, share=True)",
        "// over a run of R adjacent medians.",
        "#pragma once",
        "template <int K, int R> struct MedianRun;",
        "template <int K> struct FusedRuns;",
    ]
    for k in MEDIAN_WINDOWS:
        runs = median_runs.FUSED_RUNS[k]
        lines.append(f"template <> struct FusedRuns<{k}> {{ static constexpr int R = {runs}; }};")
        lines.append(median_runs.cuda_source(median_runs.median_run_program(k, runs)))
    return "\n".join(lines) + "\n"


def headers() -> Dict[str, str]:
    """The generated headers, by file name."""
    return {"median_plans.cuh": median_plans_header(), "median_runs.cuh": median_runs_header()}


def build_dir() -> Path:
    """``_build/<key>``: the key hashes sources, generated headers and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    for text in headers().values():
        h.update(text.encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_all() -> Dict[str, float]:
    """Compile every missing library, all nvcc processes at once.

    Returns seconds per library built (empty when all were cached). The
    compiler's register/shared-memory report goes to ``<name>.log``.
    """
    out_dir = build_dir()
    missing = [n for n in SOURCES if not (out_dir / f"lib{n}.so").exists()]
    if not missing:
        return {}
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, text in headers().items():
        (out_dir / name).write_text(text)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in missing:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(out_dir), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (out_dir / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return seconds


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library ``lib<name>.so`` with its argtypes declared (once
    a process: the ``--sanitize`` watchdog counts each load)."""
    from nm03_capstone_project_tpu_torch.utils import sanitize

    path = build_dir() / f"lib{name}.so"
    if not path.exists():
        build_all()
    sanitize.note_compile("library", f"lib{name}.so")
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in ARGTYPES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
