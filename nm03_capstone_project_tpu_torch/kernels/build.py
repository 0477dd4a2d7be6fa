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

Where a library comes from is decided at its first :func:`load` in a
process, in this order:

1. the process's cache (:func:`attach_cache`: the server's
   ``--compile-cache-dir``), or ``$NM03_COMPILE_CACHE_DIR``: an entry of
   :class:`..compilehub.persist.KernelCache` whose key and checksum verify
   (source ``cache``);
2. a build in a process-private directory, the headers generated there,
   then published to that cache (source ``built``): all missing libraries
   at once;
3. with no cache asked for, ``_build/<key>/`` beside this package, as
   before the cache existed (source ``local``).

A cache entry's key (:func:`persist_key`) digests the sources and the
generated headers and names the flags, the arch, ``nvcc --version`` and the
port's version: an edited source or a new toolkit is rebuilt, an unchanged
one is loaded. ``_build/<key>`` keeps its key (:func:`build_dir`: the
sources, the headers and the flags) and records beside the libraries the
``nvcc --version`` that built them: a process that reaches ``nvcc``
rebuilds a directory another toolkit (or no record) made, and one that
reaches none loads it as it is, since it could build nothing in its
place. Sources come from the package only. The port's lint holds both
keys to the build (NM381): every module constant :func:`build_all` reads
must be read by :func:`persist_key` and by :func:`build_dir`.
:func:`records` reports each library's source, build seconds and load
seconds (``/readyz`` ``compile_hub``).

Every C entry point takes its pointers and the CUDA stream as
``ctypes.c_void_p`` and returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that is not 0.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from nm03_capstone_project_tpu_torch import __version__
from nm03_capstone_project_tpu_torch.compilehub.persist import (
    SCHEMA,
    KernelCache,
    PersistKey,
    cache_dir_from_env,
)
from nm03_capstone_project_tpu_torch.kernels import median_runs
from nm03_capstone_project_tpu_torch.ops.selection_network import median_merge_plan
from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_text
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("compilehub")

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_ROOT = PKG / "_build"
SOURCES = ("median", "fused", "grow", "grow3d", "masks")
ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", f"arch=compute_{ARCH[3:]},code={ARCH}",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
MEDIAN_WINDOWS = (1, 3, 5, 7, 9, 11, 13, 15)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
ARGTYPES = {
    "median": {
        "nm03_median_filter": [_P, _P, _I, _I, _I, _I, _P],
        "nm03_median_select": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
        "nm03_median_wide": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "nm03_median_wide_ctas_per_sm": [_I, _P],
        # the same with the split route's prologue: norm_min, scale,
        # norm_low, clip_low, clip_high before the stream
        "nm03_median_filter_pre": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P],
        "nm03_median_select_pre": [_P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P],
        "nm03_median_wide_pre": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                                 _P],
    },
    "fused": {
        "nm03_fused_preprocess": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F,
                                  _P, _I, _I, _I, _I, _P],
        "nm03_sharpen": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    },
    "grow": {
        "nm03_region_grow": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _I, _I, _I, _I,
                             _P],
        "nm03_region_grow_global": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _F, _F, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "grow3d": {
        # pre, seeds and its four strides, valid and its four, band, the
        # two region buffers, state, B, D, H, W, words a buffer, low, high
        "nm03_grow3d_pack": [_P, _P, _L, _L, _L, _L, _P, _L, _L, _L, _L, _P, _P, _P, _P,
                             _I, _I, _I, _I, _L, _F, _F, _P],
        # band, the two region buffers, state, B, D, H, W, words a buffer,
        # connectivity, block_iters, max_iters
        "nm03_grow3d_run": [_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _L, _P],
        "nm03_grow3d_unpack": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _P],
    },
    "masks": {
        # dims, seeds, valid, P, H, W
        "nm03_seed_valid": [_P, _P, _P, _I, _I, _I, _P],
        # seg, dims, dims_step, out, P, depth, H, W, radius, radius through z
        "nm03_finish": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P],
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


def persist_key(name: str) -> PersistKey:
    """The key of ``lib<name>.so``: every input of the build.

    The sources and the generated headers by digest, the exact flags, the
    target arch, ``nvcc --version`` (None where no ``nvcc`` is reachable)
    and the port's version. The port's lint (NM381) holds this function to
    every module constant :func:`build_all` reads.
    """
    src = hashlib.sha256()
    for n in SOURCES:
        src.update(n.encode() + b"\0")
        src.update((CSRC / f"{n}.cu").read_bytes())
    hdr = hashlib.sha256()
    for fname, text in sorted(headers().items()):
        hdr.update(fname.encode() + b"\0")
        hdr.update(text.encode())
    return PersistKey(
        schema=SCHEMA,
        name=name,
        sources_sha256=src.hexdigest(),
        headers_sha256=hdr.hexdigest(),
        nvcc_flags=tuple(NVCC_FLAGS),
        arch=ARCH,
        nvcc_version=nvcc_version(),
        nm03_version=__version__,
    )


def build_dir() -> Path:
    """``_build/<key>``, where a process without a cache builds and loads:
    the key hashes sources, generated headers and flags."""
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


@functools.lru_cache(maxsize=1)
def nvcc_version() -> Optional[str]:
    """``nvcc --version`` of the toolkit this process would build with, or
    None where none is reachable (such a process cannot build)."""
    try:
        cmd = [_nvcc(), "--version"]
    except RuntimeError:
        return None
    try:
        # nm03-lint: disable=NM422 the first load of a process resolves every library under build._LOCK on purpose: a second thread waits for the verified or built libraries instead of racing nvcc for them
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return proc.stdout.strip() if proc.returncode == 0 else None


def _write_header(path: Path, text: str) -> None:
    """Write a generated header only when it differs, and atomically: a
    concurrent ``nvcc`` never reads a header another process truncated."""
    try:
        if path.read_text() == text:
            return
    except OSError:
        pass
    atomic_write_text(path, text)


def _compile(names, out_dir: Path) -> Dict[str, float]:
    """Compile ``lib<name>.so`` for each name into ``out_dir``, all nvcc
    processes at once, with the generated headers there; seconds per
    library. The compiler's register/shared-memory report goes to
    ``<name>.log``."""
    for fname, text in headers().items():
        _write_header(out_dir / fname, text)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(out_dir), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        # nm03-lint: disable=NM422 the first load of a process resolves every library under build._LOCK on purpose: a second thread waits for the verified or built libraries instead of racing nvcc for them
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


def _toolkit_record(out_dir: Path) -> Path:
    """Where ``_build/<key>`` records the ``nvcc --version`` that built it."""
    return out_dir / "nvcc_version.txt"


def _built_by_another_toolkit(out_dir: Path) -> bool:
    """Whether the reachable ``nvcc`` differs from the one that built
    ``out_dir`` (or no record says which did); False where no ``nvcc`` is
    reachable: such a process loads what is there."""
    version = nvcc_version()
    if version is None:
        return False
    try:
        return _toolkit_record(out_dir).read_text() != version
    except OSError:
        return True


def build_all() -> Dict[str, float]:
    """Compile every library missing from :func:`build_dir`, or all of them
    where the reachable ``nvcc`` is not the toolkit that built them, all
    nvcc processes at once; seconds per library built (empty when all were
    there)."""
    out_dir = build_dir()
    stale = out_dir.is_dir() and _built_by_another_toolkit(out_dir)
    missing = [n for n in SOURCES if stale or not (out_dir / f"lib{n}.so").exists()]
    if not missing:
        return {}
    if stale:
        log.warning("kernel libraries in %s were built by another nvcc; rebuilding", out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    seconds = _compile(missing, out_dir)
    version = nvcc_version()
    if version is not None:
        atomic_write_text(_toolkit_record(out_dir), version)
    return seconds


# -- where a process's libraries come from -------------------------------------

_LOCK = threading.Lock()
# the cache this process resolves through (attach_cache, or the variable's),
# and whether a cache was asked for at all: then nothing is built beside the
# package, even where the cache is unusable
_STATE: Dict[str, object] = {"cache": None, "private": False, "env_checked": False}
# name -> {source: cache | built | local, build_s, load_s, entry, path}
_RECORDS: Dict[str, dict] = {}
_PRIVATE_DIR: List[Path] = []


def attach_cache(cache: Optional[KernelCache], private: bool = False) -> None:
    """Resolve this process's libraries through ``cache``
    (``--compile-cache-dir``; it wins over ``$NM03_COMPILE_CACHE_DIR``).

    ``private=True`` with no cache: a cache was asked for but its directory
    is unusable, so build in a process-private directory and store nothing.
    ``attach_cache(None)`` goes back to the variable, else ``_build/``.
    Only the first :func:`load` of each library decides.
    """
    with _LOCK:
        _STATE.update(cache=cache, private=bool(private or cache is not None),
                      env_checked=cache is not None or private)


def attached_cache() -> Optional[KernelCache]:
    return _STATE["cache"]


def _process_cache():
    """(cache or None, private): the attached cache, else the variable's."""
    with _LOCK:
        if not _STATE["env_checked"]:
            _STATE["env_checked"] = True
            root = cache_dir_from_env()
            if root:
                _STATE["private"] = True
                try:
                    _STATE["cache"] = KernelCache(root)
                except OSError as e:
                    log.warning("compile cache dir %s unusable (%s); building "
                                "the kernel libraries privately", root, e)
        return _STATE["cache"], _STATE["private"]


def _private_dir() -> Path:
    if not _PRIVATE_DIR:
        d = Path(tempfile.mkdtemp(prefix="nm03_kernels_"))
        atexit.register(shutil.rmtree, d, ignore_errors=True)
        _PRIVATE_DIR.append(d)
    return _PRIVATE_DIR[0]


def _resolve_private(cache: Optional[KernelCache]) -> None:
    """Every library not yet resolved: verified from the cache, else built
    in the private directory (all misses at once) and stored."""
    out_dir = _private_dir()
    missing = []
    for name in SOURCES:
        if name in _RECORDS:
            continue
        t0 = time.perf_counter()
        path = cache.load(name, out_dir) if cache is not None else None
        if path is None:
            missing.append(name)
            continue
        _RECORDS[name] = {"source": "cache", "build_s": None,
                          "load_s": time.perf_counter() - t0,
                          "entry": cache.key(name).filename(), "path": str(path)}
    if not missing:
        return
    seconds = _compile(missing, out_dir)
    for name in missing:
        path = out_dir / f"lib{name}.so"
        stored = cache.store(name, path) if cache is not None else False
        _RECORDS[name] = {"source": "built", "build_s": seconds[name], "load_s": 0.0,
                          "entry": cache.key(name).filename() if stored else None,
                          "path": str(path)}


def _resolve(name: str) -> Path:
    cache, private = _process_cache()
    if not private:
        out_dir = build_dir()
        path = out_dir / f"lib{name}.so"
        stale = path.exists() and _built_by_another_toolkit(out_dir)
        built = build_all() if stale or not path.exists() else {}
        for n in (*built, name):
            _RECORDS.setdefault(n, {"source": "local", "build_s": built.get(n),
                                    "load_s": 0.0, "entry": None,
                                    "path": str(path.with_name(f"lib{n}.so"))})
        return path
    with _LOCK:
        if name not in _RECORDS:
            _resolve_private(cache)
        return Path(_RECORDS[name]["path"])


def records() -> Dict[str, dict]:
    """Each resolved library: its source (``cache``, ``built`` or
    ``local``), build seconds (None when not built here), load seconds
    (the cache entry's read, check and copy, and the ``dlopen``) and cache
    entry."""
    with _LOCK:
        return {n: {k: v for k, v in r.items() if k != "path"}
                for n, r in sorted(_RECORDS.items())}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library ``lib<name>.so`` with its argtypes declared.

    Resolved once a process (the ``--sanitize`` watchdog counts each
    load), in this order: the attached cache or
    ``$NM03_COMPILE_CACHE_DIR`` (a verified entry, else a private build
    that is then stored), else ``_build/<key>/`` beside the package.
    """
    from nm03_capstone_project_tpu_torch.utils import sanitize

    path = _resolve(name)
    sanitize.note_compile("library", f"lib{name}.so")
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in ARGTYPES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    with _LOCK:
        rec = _RECORDS.get(name)
        if rec is not None:
            rec["load_s"] = round(rec["load_s"] + time.perf_counter() - t0, 6)
    return lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
