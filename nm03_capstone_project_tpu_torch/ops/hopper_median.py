"""Hand-written Hopper kernels for the median and the fused preprocess stage.

The JAX package's Pallas kernels ``_median_band_kernel`` and
``_fused_band_kernel`` (ops/pallas_median.py:101 and :165) become the CUDA
kernels of ``csrc/median.cu`` and ``csrc/fused.cu``, bound through ctypes
(:mod:`nm03_capstone_project_tpu_torch.kernels.build`). Beside each kernel
is its plain PyTorch version, which the CPU tests and ``chip_smoke.py``
hold it against:

* :func:`vector_median_filter_kernel` — the k x k clamp-to-edge median,
  bit-identical to :func:`.median.vector_median_filter`: the generated
  selection plan for k <= MAX_WINDOW (route ``network``), and from
  k = 17 to MAX_SELECT_WINDOW the exact selection of
  :func:`vector_median_select_kernel` (route ``select``), which the
  plans' register budget cannot reach. A batch of more than MAX_BATCH
  slices goes in several launches;
* :func:`fused_preprocess_kernel` — normalize -> clip -> median ->
  sharpen in one pass over the image, bit-identical to
  :func:`_fused_preprocess_plain` (the kernel rounds every step as the
  plain ops do; see the source note in ``csrc/fused.cu``). Its persistent
  grid walks tiles whose shape :func:`fused_launch_shape` picks. For a
  window past MAX_WINDOW or a sharpen kernel past MAX_TAPS that function
  picks the ``unfused`` route instead, before launch: the port's torch
  ops for normalize, clip and sharpen around the median kernel, as the
  JAX package runs XLA where no band fits. Its bits are the plain
  composition's by construction.

Each route is chosen from the shape and the config before launch, never
after a kernel error, and named in a log line at its first use.

Dispatch (:func:`median_filter`, :func:`fused_preprocess`): with
``use_kernels`` a CUDA tensor launches the kernel or raises, and a CPU
tensor takes the plain version. Nothing falls back on a failure. Each
kernel wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.kernels.median_runs import FUSED_RUNS
from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize
from nm03_capstone_project_tpu_torch.ops.median import (
    vector_median_filter,
    vector_median_filter_merge,
    vector_median_filter_sort,
)
from nm03_capstone_project_tpu_torch.ops.sharpen import gaussian_kernel_1d, sharpen
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger, log_once

log = get_logger("kernels")

MAX_WINDOW = 15  # odd median windows 1..15 run the generated plans
MAX_SELECT_WINDOW = 63  # the largest odd window of the select route
MAX_TAPS = 31  # longest sharpen kernel the fused kernel takes
MAX_BATCH = 65535  # the standalone median grid's z dimension
MAX_TILE_W = 256  # widest tile of the fused kernel
BLUR_ROWS = 4  # rows the fused kernel's blur accumulates together
SMEM_PER_BLOCK = 232448  # the H100's opt-in shared memory per block (227 KB)


def _note_route(kernel: str, route: str, detail: str) -> None:
    """Log a kernel's route the first time this process takes it."""
    log_once(log, (kernel, route), "%s: route %s (%s)", kernel, route, detail)


class MedianLaunch(NamedTuple):
    """How :func:`vector_median_filter_kernel` runs a (b, h, w) batch."""

    route: str  # "network" (odd k <= MAX_WINDOW) or "select"
    launches: int  # grids of at most MAX_BATCH slices


def _check_window(k: int) -> None:
    if k % 2 != 1 or not 1 <= k <= MAX_SELECT_WINDOW:
        raise ValueError(
            f"median window must be odd and in [1, {MAX_SELECT_WINDOW}] on the card "
            f"(MAX_SELECT_WINDOW), got {k}")


def median_launch_shape(b: int, h: int, w: int, k: int) -> MedianLaunch:
    """The median kernel's route and launches for a (b, h, w) batch and an
    odd window k; ValueError past MAX_SELECT_WINDOW."""
    _check_window(k)
    return MedianLaunch("network" if k <= MAX_WINDOW else "select",
                        max(1, -(-b // MAX_BATCH)))


class FusedLaunch(NamedTuple):
    """The fused kernel's tiles, or the ``unfused`` route (all zero)."""

    tile_h: int
    tile_w: int
    grid: int
    smem: int

    @property
    def route(self) -> str:
        return "fused" if self.grid else "unfused"


UNFUSED = FusedLaunch(0, 0, 0, 0)


@functools.lru_cache(maxsize=None)
def fused_launch_shape(b: int, h: int, w: int, k: int, ks: int, n_sm: int) -> FusedLaunch:
    """``(tile_h, tile_w, grid, shared bytes)`` of the fused kernel, or
    :data:`UNFUSED` where the fused kernel does not take the config: a
    window past MAX_WINDOW, a sharpen kernel past MAX_TAPS, or no tile
    that fits shared memory.

    Tiles span the width up to MAX_TILE_W columns. A persistent grid of one
    CTA an SM walks them, so the time goes as the waves of tiles times a
    tile's median rows (its outputs plus the sharpen's halo): the tile
    height minimizes that product, which weighs halo rows against a ragged
    last wave, among heights whose shared memory fits a block. The layout
    mirrors ``Layout`` in ``csrc/fused.cu``.
    """
    if k not in FUSED_RUNS or ks % 2 != 1 or not 1 <= ks <= MAX_TAPS:
        return UNFUSED
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
        return UNFUSED
    _, th, grid = best
    return FusedLaunch(th, tw, grid, smem(th))


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


def vector_median_filter_kernel(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """The k x k clamp-to-edge median of a (..., H, W) CUDA tensor: the
    generated plan for k <= MAX_WINDOW, else
    :func:`vector_median_select_kernel`."""
    _check_window(size)
    xb = _batched(x, "vector_median_filter_kernel")
    b, h, w = xb.shape
    shape = median_launch_shape(b, h, w, size)
    if shape.route == "select":
        return vector_median_select_kernel(x, size)
    out = torch.empty_like(xb)
    if xb.numel() == 0:
        return out.reshape(x.shape)
    if shape.launches > 1:
        _note_route("median", "network", f"{b} slices in {shape.launches} launches")
    lib = build.load("median")
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    for b0 in range(0, b, MAX_BATCH):
        nb = min(MAX_BATCH, b - b0)
        err = lib.nm03_median_filter(xb[b0].data_ptr(), out[b0].data_ptr(), nb, h, w, size,
                                     stream)
        build.check(err, "nm03_median_filter")
        vector_median_filter_kernel.launches += 1
    return out.reshape(x.shape)


vector_median_filter_kernel.launches = 0


def vector_median_select_kernel(x: torch.Tensor, size: int = 17) -> torch.Tensor:
    """The k x k clamp-to-edge median of a (..., H, W) CUDA tensor by exact
    selection (``csrc/median.cu``, ``nm03_median_select``): any odd k up to
    MAX_SELECT_WINDOW, bit-identical to :func:`.median.vector_median_filter`
    (NaN and signed zeros as the source note there says). The route of
    :func:`vector_median_filter_kernel` from k = 17."""
    _check_window(size)
    xb = _batched(x, "vector_median_select_kernel")
    b, h, w = xb.shape
    shape = median_launch_shape(b, h, w, size)
    out = torch.empty_like(xb)
    if xb.numel() == 0:
        return out.reshape(x.shape)
    _note_route("median", "select", f"k={size}, {shape.launches} launch(es) of {b} slices")
    lib = build.load("median")
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    for b0 in range(0, b, MAX_BATCH):
        nb = min(MAX_BATCH, b - b0)
        err = lib.nm03_median_select(xb.data_ptr(), out.data_ptr(), b0, nb, h, w, size,
                                     MAX_SELECT_WINDOW, stream)
        build.check(err, "nm03_median_select")
        vector_median_select_kernel.launches += 1
    return out.reshape(x.shape)


vector_median_select_kernel.launches = 0


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
    edge-extended for the true dims by the pipeline. Where
    :func:`fused_launch_shape` picks the ``unfused`` route, the median
    kernel runs between the torch ops of the plain composition.
    """
    _check_window(median_window)
    if sharpen_kernel % 2 != 1 or sharpen_kernel < 1:
        raise ValueError(f"sharpen kernel must be odd and positive, got {sharpen_kernel}")
    xb = _batched(x, "fused_preprocess_kernel")
    b, h, w = xb.shape
    out = torch.empty_like(xb)
    if xb.numel() == 0:
        return out.reshape(x.shape)
    th, tw, grid, _ = fused_launch_shape(
        b, h, w, median_window, sharpen_kernel, _sm_count(xb.device.index or 0))
    if not grid:
        _note_route("fused", "unfused",
                    f"k={median_window}, {sharpen_kernel} sharpen taps: the median kernel "
                    "between torch normalize, clip and sharpen")
        out = clip_intensity(normalize(x, norm_low, norm_high, norm_min, norm_max),
                             clip_low, clip_high)
        out = vector_median_filter_kernel(out, median_window)
        return sharpen(out, sharpen_gain, sharpen_sigma, sharpen_kernel)
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


# the plain medians by ``PipelineConfig.median_impl``: the same bits each
PLAIN_MEDIANS = {
    "pruned": vector_median_filter,
    "merge": vector_median_filter_merge,
    "sort": vector_median_filter_sort,
}


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
    median_impl: str = "pruned",
) -> torch.Tensor:
    """The plain composition of the four stages (the JAX package's
    ``_fused_preprocess_xla``), with the plain median ``median_impl``."""
    out = normalize(x, norm_low, norm_high, norm_min, norm_max)
    out = clip_intensity(out, clip_low, clip_high)
    out = PLAIN_MEDIANS[median_impl](out, median_window)
    return sharpen(out, sharpen_gain, sharpen_sigma, sharpen_kernel)


def median_filter(x: torch.Tensor, size: int = 7, use_kernels: bool = True,
                  impl: str = "pruned") -> torch.Tensor:
    """The median kernel for a CUDA tensor with ``use_kernels`` (its own
    pruned plan, whatever ``impl`` says); else the plain ``impl``."""
    if use_kernels and x.device.type != "cpu":
        return vector_median_filter_kernel(x, size)
    return PLAIN_MEDIANS[impl](x, size)


def fused_preprocess(x: torch.Tensor, *, use_kernels: bool = True,
                     median_impl: str = "pruned", **params) -> torch.Tensor:
    """The fused kernel for a CUDA tensor with ``use_kernels`` (its own
    pruned plan, whatever ``median_impl`` says); else plain.

    ``params`` are :func:`fused_preprocess_kernel`'s keyword arguments.
    """
    if use_kernels and x.device.type != "cpu":
        return fused_preprocess_kernel(x, **params)
    return _fused_preprocess_plain(x, median_impl=median_impl, **params)
