"""Hand-written Hopper kernels for the median and the fused preprocess stage.

The JAX package's Pallas kernels ``_median_band_kernel`` and
``_fused_band_kernel`` (ops/pallas_median.py:101 and :165) become the CUDA
kernels of ``csrc/median.cu`` and ``csrc/fused.cu``, bound through ctypes
(:mod:`nm03_capstone_project_tpu_torch.kernels.build`). Beside each kernel
is its plain PyTorch version, which the CPU tests and ``chip_smoke.py``
hold it against:

* :func:`vector_median_filter_kernel` — the k x k clamp-to-edge median,
  bit-identical to :func:`.median.vector_median_filter`;
* :func:`fused_preprocess_kernel` — normalize -> clip -> median ->
  sharpen in one pass over the image, bit-identical to
  :func:`_fused_preprocess_plain` (the kernel rounds every step as the
  plain ops do; see the source note in ``csrc/fused.cu``). Its persistent
  grid walks tiles whose shape :func:`fused_launch_shape` picks.

Dispatch (:func:`median_filter`, :func:`fused_preprocess`): with
``use_kernels`` a CUDA tensor launches the kernel or raises, and a CPU
tensor takes the plain version. Nothing falls back on a failure. Each
kernel wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.kernels.median_runs import FUSED_RUNS
from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize
from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter
from nm03_capstone_project_tpu_torch.ops.sharpen import gaussian_kernel_1d, sharpen

MAX_WINDOW = 15  # odd median windows 1..15 are compiled
MAX_TAPS = 31  # longest sharpen kernel the fused kernel takes
MAX_BATCH = 65535  # the standalone median grid's z dimension
MAX_TILE_W = 256  # widest tile of the fused kernel
BLUR_ROWS = 4  # rows the fused kernel's blur accumulates together
SMEM_PER_BLOCK = 232448  # the H100's opt-in shared memory per block (227 KB)


@functools.lru_cache(maxsize=None)
def fused_launch_shape(
    b: int, h: int, w: int, k: int, ks: int, n_sm: int
) -> Tuple[int, int, int, int]:
    """``(tile_h, tile_w, grid, shared bytes)`` of the fused kernel.

    Tiles span the width up to MAX_TILE_W columns. A persistent grid of one
    CTA an SM walks them, so the time goes as the waves of tiles times a
    tile's median rows (its outputs plus the sharpen's halo): the tile
    height minimizes that product, which weighs halo rows against a ragged
    last wave, among heights whose shared memory fits a block. The layout
    mirrors ``Layout`` in ``csrc/fused.cu``.
    """
    r, rs, runs = k // 2, ks // 2, FUSED_RUNS[k]
    n_c = -(-w // MAX_TILE_W)
    tw = -(-w // n_c)
    row_runs = -(-min(w, tw + 2 * rs) // runs) * runs

    def smem(th: int) -> int:
        staged = (min(h, th + 2 * rs) + 2 * r) * ((row_runs + 2 * r) | 1)
        blurred = th * ((tw + 2 * rs) | 1)  # shares the staged tile's memory
        medians = (th + 2 * rs + BLUR_ROWS - 1) * (row_runs | 1)
        return 4 * (max(staged, blurred) + medians)

    best = None
    for n_r in range(1, h + 1):
        th = -(-h // n_r)
        if smem(th) > SMEM_PER_BLOCK:
            continue
        tiles = b * -(-h // th) * n_c
        cost = -(-tiles // n_sm) * min(h, th + 2 * rs)
        if best is None or cost < best[0]:
            best = (cost, th, min(tiles, n_sm))
    if best is None:
        raise ValueError(f"fused kernel: no tile of a {h}x{w} slice fits shared memory")
    _, th, grid = best
    return th, tw, grid, smem(th)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _batched(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` as a contiguous (B, H, W) float32 CUDA tensor, or raise."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"{what} takes (..., H, W), got shape {tuple(x.shape)}")
    return x.reshape(-1, x.shape[-2], x.shape[-1]).contiguous()


def _check_window(size: int) -> None:
    if size % 2 != 1 or not 1 <= size <= MAX_WINDOW:
        raise ValueError(f"median window must be odd and in [1, {MAX_WINDOW}], got {size}")


def vector_median_filter_kernel(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """The k x k clamp-to-edge median of a (..., H, W) CUDA tensor."""
    _check_window(size)
    xb = _batched(x, "vector_median_filter_kernel")
    if xb.shape[0] > MAX_BATCH:
        raise ValueError(f"vector_median_filter_kernel: at most {MAX_BATCH} slices a call, "
                         f"got {xb.shape[0]}")
    out = torch.empty_like(xb)
    if xb.numel() == 0:
        return out.reshape(x.shape)
    b, h, w = xb.shape
    lib = build.load("median")
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = lib.nm03_median_filter(xb.data_ptr(), out.data_ptr(), b, h, w, size, stream)
    build.check(err, "nm03_median_filter")
    vector_median_filter_kernel.launches += 1
    return out.reshape(x.shape)


vector_median_filter_kernel.launches = 0


def fused_preprocess_kernel(
    x: torch.Tensor,
    *,
    norm_low: float = 0.5,
    norm_high: float = 2.5,
    norm_min: float = 0.0,
    norm_max: float = 10000.0,
    clip_low: float = 0.68,
    clip_high: float = 4000.0,
    median_window: int = 7,
    sharpen_gain: float = 2.0,
    sharpen_sigma: float = 0.5,
    sharpen_kernel: int = 9,
) -> torch.Tensor:
    """normalize -> clip -> k x k median -> unsharp sharpen, one kernel.

    ``x`` is the (..., H, W) float32 canvas on the GPU, already
    edge-extended for the true dims by the pipeline.
    """
    _check_window(median_window)
    if sharpen_kernel % 2 != 1 or not 1 <= sharpen_kernel <= MAX_TAPS:
        raise ValueError(
            f"sharpen kernel must be odd and in [1, {MAX_TAPS}], got {sharpen_kernel}"
        )
    xb = _batched(x, "fused_preprocess_kernel")
    out = torch.empty_like(xb)
    if xb.numel() == 0:
        return out.reshape(x.shape)
    b, h, w = xb.shape
    th, tw, grid, _ = fused_launch_shape(
        b, h, w, median_window, sharpen_kernel, _sm_count(xb.device.index or 0))
    taps = gaussian_kernel_1d(sharpen_sigma, sharpen_kernel)
    c_taps = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    scale = (norm_high - norm_low) / (norm_max - norm_min)
    lib = build.load("fused")
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = lib.nm03_fused_preprocess(
        xb.data_ptr(), out.data_ptr(), b, h, w, median_window,
        norm_min, scale, norm_low, clip_low, clip_high, sharpen_gain,
        ctypes.cast(c_taps, ctypes.c_void_p), len(taps), th, tw, grid, stream,
    )
    build.check(err, "nm03_fused_preprocess")
    fused_preprocess_kernel.launches += 1
    return out.reshape(x.shape)


fused_preprocess_kernel.launches = 0


def _fused_preprocess_plain(
    x: torch.Tensor,
    *,
    norm_low: float = 0.5,
    norm_high: float = 2.5,
    norm_min: float = 0.0,
    norm_max: float = 10000.0,
    clip_low: float = 0.68,
    clip_high: float = 4000.0,
    median_window: int = 7,
    sharpen_gain: float = 2.0,
    sharpen_sigma: float = 0.5,
    sharpen_kernel: int = 9,
) -> torch.Tensor:
    """The plain composition of the four stages (the JAX package's
    ``_fused_preprocess_xla``)."""
    out = normalize(x, norm_low, norm_high, norm_min, norm_max)
    out = clip_intensity(out, clip_low, clip_high)
    out = vector_median_filter(out, median_window)
    return sharpen(out, sharpen_gain, sharpen_sigma, sharpen_kernel)


def median_filter(x: torch.Tensor, size: int = 7, use_kernels: bool = True) -> torch.Tensor:
    """The median kernel for a CUDA tensor with ``use_kernels``; else plain."""
    if use_kernels and x.device.type != "cpu":
        return vector_median_filter_kernel(x, size)
    return vector_median_filter(x, size)


def fused_preprocess(x: torch.Tensor, *, use_kernels: bool = True, **params) -> torch.Tensor:
    """The fused kernel for a CUDA tensor with ``use_kernels``; else plain.

    ``params`` are :func:`fused_preprocess_kernel`'s keyword arguments.
    """
    if use_kernels and x.device.type != "cpu":
        return fused_preprocess_kernel(x, **params)
    return _fused_preprocess_plain(x, **params)
