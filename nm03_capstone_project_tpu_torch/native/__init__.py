"""ctypes bindings for the host-side C++ layer (``csrc/host/nm03native.cpp``).

The port's own copy of the JAX package's native layer: the same C++ source
(``csrc/host/nm03native.cpp``, byte-equal to the JAX package's, a test pins
it) with its own binding. It serves the batch drivers on the host: the
threaded batch decoder (``nm03_load_batch``), the export renderer
(``nm03_render_pair``, byte-identical to :mod:`..render.host_render`) and the
baseline JPEG encoder (``nm03_jpeg_encode_gray``), which the export uses
where PIL is not installed.

The shared library is compiled on first use with ``g++ -O3 -pthread
-ffp-contract=off`` into ``_build/host/`` beside the CUDA kernels (git
ignored), keyed by a source hash. ``NM03_NO_NATIVE=1`` (the drivers'
``--no-native``) turns the layer off on request: ``available()`` is then
False and the drivers take the pure-Python decoder and renderer. Without
that request a failed build raises, with the compiler's message; nothing
falls back to Python silently.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

_log = get_logger("native")

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "host" / "nm03native.cpp"
_BUILD_DIR = _PKG / "_build" / "host"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def disabled() -> bool:
    """True when the caller turned the layer off (``NM03_NO_NATIVE=1``)."""
    return os.environ.get("NM03_NO_NATIVE") == "1"


def _compile() -> Optional[Path]:
    """Build the shared library with g++; returns its path or None."""
    from nm03_capstone_project_tpu_torch.native.buildlib import build_shared_library

    # -ffp-contract=off: the host-export renderer mirrors NumPy's f32
    # arithmetic operation for operation; letting the compiler contract the
    # lerp into FMAs would break the byte-identical-render guarantee
    return build_shared_library(
        _SRC, _BUILD_DIR, "nm03native", ["-pthread", "-ffp-contract=off"], _log
    )


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library; None when :func:`disabled`. Raises RuntimeError
    when the layer is wanted but does not build or load."""
    global _lib, _build_error
    if disabled():
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is None:
            path = _compile()
            if path is None:
                _build_error = (
                    f"the host C++ layer ({_SRC.name}) did not build with g++ "
                    "(the compiler's message is in the log above); pass "
                    "--no-native or set NM03_NO_NATIVE=1 for the pure-Python path"
                )
            else:
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as e:
                    _build_error = f"failed to load {path}: {e}"
        if _build_error is not None:
            raise RuntimeError(_build_error)

        lib.nm03_last_error.restype = ctypes.c_char_p
        lib.nm03_load_batch.restype = ctypes.c_int
        lib.nm03_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.nm03_jpeg_encode_gray.restype = ctypes.c_long
        lib.nm03_jpeg_encode_gray.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_long,
        ]
        lib.nm03_render_pair.restype = ctypes.c_int
        lib.nm03_render_pair.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.POINTER(ctypes.c_ubyte),
        ]
        _lib = lib
        _log.info("native layer loaded (%s)", path.name)
        return _lib


def available() -> bool:
    """True unless :func:`disabled`; raises when the layer does not build."""
    return _load() is not None


def last_error() -> str:
    lib = _load()
    return lib.nm03_last_error().decode() if lib else "native layer disabled"


# error codes returned per-slice by nm03_load_batch
BATCH_ERRORS = {
    0: "ok",
    1: "cannot read file",
    2: "DICOM parse failed",
    3: "image dimensions too small",
    4: "slice exceeds canvas; raise --canvas",
}


def load_batch_native(
    paths: Sequence[str | os.PathLike],
    canvas: int,
    min_dim: int,
    threads: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Threaded decode of a slice batch into a padded canvas arena.

    Returns (pixels, dims, ok, err): pixels (n, canvas, canvas) float32
    zero-padded, dims (n, 2) int32 rows/cols, ok (n,) bool, err (n,) int32
    per-slice failure codes (see BATCH_ERRORS). Failed slices have ok=False
    and keep min_dim dims + a zero slot — the contract _pad_stack/_read_slice
    implement in Python (cli/runner.py).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native layer disabled (NM03_NO_NATIVE=1)")
    n = len(paths)
    pixels = np.zeros((n, canvas, canvas), np.float32)
    dims = np.full((n, 2), min_dim, np.int32)
    ok = np.zeros(n, np.uint8)
    err = np.zeros(n, np.int32)
    if n == 0:
        return pixels, dims, ok.astype(bool), err
    encoded = [os.fspath(p).encode() for p in paths]
    arr = (ctypes.c_char_p * n)(*encoded)
    lib.nm03_load_batch(
        arr, n, canvas, canvas, min_dim, threads,
        pixels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dims.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        err.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return pixels, dims, ok.astype(bool), err


def encode_jpeg_gray(image: np.ndarray, quality: int = 90) -> bytes:
    """Encode a uint8 grayscale (H, W) array as baseline JPEG bytes."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native layer disabled (NM03_NO_NATIVE=1)")
    arr = np.ascontiguousarray(image)
    if arr.dtype != np.uint8 or arr.ndim != 2:
        raise ValueError(f"expected 2D uint8 image, got {arr.dtype} {arr.shape}")
    h, w = arr.shape
    cap = h * w * 2 + 4096  # worst case far below uncompressed x2 + headers
    out = np.empty(cap, np.uint8)
    n = lib.nm03_jpeg_encode_gray(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        h, w, quality,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        cap,
    )
    if n < 0:
        raise ValueError(f"native JPEG encode failed: {last_error()}")
    return out[:n].tobytes()


def render_pair_native(
    pixels: np.ndarray, mask: np.ndarray, dims, cfg
) -> "tuple[np.ndarray, np.ndarray]":
    """C++ twin of render.host_render.host_render_pair — identical bytes.

    ``pixels``: (canvas, canvas) float32 padded slice; ``mask``: uint8 canvas
    mask; ``dims``: true (h, w). Returns the (gray, seg) uint8 pair at
    ``cfg.render_size``. Raises RuntimeError when the native layer is
    disabled (callers then use the NumPy renderer).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native layer disabled (NM03_NO_NATIVE=1)")
    px = np.ascontiguousarray(pixels, np.float32)
    mk = np.ascontiguousarray(mask, np.uint8)
    h, w = int(dims[0]), int(dims[1])
    out = int(cfg.render_size)
    gray = np.empty((out, out), np.uint8)
    seg = np.empty((out, out), np.uint8)
    rc = lib.nm03_render_pair(
        px.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        px.shape[0], px.shape[1],
        mk.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        mk.shape[0], mk.shape[1],
        h, w, out,
        ctypes.c_float(cfg.overlay_opacity),
        ctypes.c_float(cfg.overlay_border_opacity),
        int(cfg.overlay_border_radius),
        gray.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        seg.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    if rc != 0:
        raise ValueError(f"native render failed: {last_error()}")
    return gray, seg
