"""Hand-written Hopper kernels for the median and the fused preprocess stage.

The JAX package's Pallas kernels ``_median_band_kernel`` and
``_fused_band_kernel`` (ops/pallas_median.py:101 and :165) become the CUDA
kernels of ``csrc/median.cu`` and ``csrc/fused.cu``, bound through ctypes
(:mod:`nm03_capstone_project_tpu_torch.kernels.build`). Beside each kernel
is its plain PyTorch version, which the CPU tests and ``chip_smoke.py``
hold it against:

* :func:`vector_median_filter_kernel` — the k x k clamp-to-edge median,
  bit-identical to :func:`.median.vector_median_filter` for any odd k:
  the generated selection plan for k <= MAX_WINDOW (route ``network``),
  from k = 17 to MAX_SELECT_WINDOW the exact selection of
  :func:`vector_median_select_kernel` (route ``select``), which the
  plans' register budget cannot reach, and past that
  :func:`vector_median_wide_kernel` (route ``wide``), the same selection
  over sorted column segments kept down a strip of rows instead of
  planes of a 2D tile. A batch of more than MAX_BATCH slices goes in
  several launches;
* :func:`fused_preprocess_kernel` — normalize -> clip -> median ->
  sharpen in one pass over the image, bit-identical to
  :func:`_fused_preprocess_plain` (the kernel rounds every step as the
  plain ops do; see the source note in ``csrc/fused.cu``). Its persistent
  grid walks tiles whose shape :func:`fused_launch_shape` picks. For a
  window past MAX_WINDOW or a sharpen kernel past MAX_TAPS that function
  picks the ``split`` route instead, before launch, where the JAX package
  runs XLA because no band fits: two hand-written kernels and no torch op
  between them. The median kernel of the window's route (``network``,
  ``select`` or ``wide``) normalizes and clips every value where it reads
  it (its prologue), then :func:`sharpen_filter_kernel` blurs and updates
  the median image in one pass, with any odd number of taps. The same
  bits as the plain composition;
* :func:`sharpen_filter_kernel` — the unsharp sharpen alone, bit-identical
  to :func:`.sharpen.sharpen`, over tiles that :func:`sharpen_launch_shape`
  picks: up to WIN_MAX_TAPS taps tiles staged with cp.async and blurred by
  register windows down and 16-byte reads across, past that the general
  loop.

Torch ops remain around a median kernel only where the caller asks for
the stages apart (``PipelineConfig(fuse_preprocess=False)``): the plain
normalize, clip and sharpen around :func:`vector_median_filter_kernel`.

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
MAX_TAPS = 31  # longest sharpen kernel the fused kernel takes
MAX_BATCH = 65535  # the standalone median grid's z dimension
MAX_TILE_W = 256  # widest tile of the fused kernel
BLUR_ROWS = 4  # rows the fused kernel's blur accumulates together
SMEM_PER_BLOCK = 232448  # the H100's opt-in shared memory per block (227 KB)
SELECT_ROWS, SELECT_COLS = 8, 32  # outputs of a select CTA (STH, STW in csrc/median.cu)
SHARPEN_ROWS, SHARPEN_COLS = 32, 64  # a sharpen tile's outputs past the windowed plan
WIDE_COLS, WIDE_THREADS = 32, 256  # a wide tile's output columns, a wide CTA's threads (WTW, WNT)


def select_smem_bytes(k: int) -> int:
    """Shared bytes of a select CTA at window k, laid out as
    ``SelectLayout`` in ``csrc/median.cu``: 2P + 1 planes (P the largest
    power of 2 <= k) of the CTA's SELECT_ROWS x (SELECT_COLS + k - 1)
    column segments, a plane rounded up to a multiple of 32 words, then the
    staged (SELECT_ROWS + k - 1) x (SELECT_COLS + k - 1) tile of keys."""
    iw = SELECT_COLS + k - 1
    plane = -(-SELECT_ROWS * iw // 32) * 32
    planes = 2 * (1 << (k.bit_length() - 1)) + 1
    return 4 * (planes * plane + (SELECT_ROWS + k - 1) * iw)


def _largest_select_window() -> int:
    k = 1
    while select_smem_bytes(k + 2) <= SMEM_PER_BLOCK:  # the bytes grow with k
        k += 2
    return k


# the largest odd window of the select route: the last whose tile fits a
# block's shared memory (63: 226,000 bytes; 65 would take 423,936)
MAX_SELECT_WINDOW = _largest_select_window()


def wide_segment_bytes(k: int) -> int:
    """Bytes of a wide CTA's sorted column segments (``wide_segment_words``
    in ``csrc/median.cu``): k planes of the strip's WIDE_COLS + k - 1
    columns, a plane rounded up to a multiple of 32 words."""
    return 4 * k * (-(-(WIDE_COLS + k - 1) // 32) * 32)


def wide_shared(k: int) -> bool:
    """Whether the wide kernel keeps window k's segments in shared memory
    (up to k = 225: 230,400 bytes); past that in a device scratch the
    wrapper allocates, read through L1 and L2."""
    return wide_segment_bytes(k) <= SMEM_PER_BLOCK


# the largest odd window whose wide segments fit a block's shared memory
MAX_WIDE_SHARED_WINDOW = max(k for k in range(1, 401, 2) if wide_shared(k))


class WideLaunch(NamedTuple):
    """How :func:`vector_median_wide_kernel` runs a batch (its first launch)."""

    rows: int  # output rows a tile walks: a band
    tiles: int  # slices x bands x strips
    grid: int  # CTAs, each walking every grid-th tile
    smem: int  # shared bytes a CTA; 0 where the segments are in scratch
    scratch: int  # 32-bit words of device scratch; 0 where they are in shared memory


@functools.lru_cache(maxsize=None)
def wide_launch_shape(b: int, h: int, w: int, k: int, n_sm: int, per_sm: int) -> WideLaunch:
    """The wide kernel's bands, grid and memory for a (b, h, w) batch at
    window k on a card of ``n_sm`` SMs, each holding ``per_sm`` CTAs at
    once with the segments in shared memory (the runtime's occupancy,
    :func:`_wide_ctas_per_sm`; unused where they are in scratch).

    A tile is a strip of WIDE_COLS output columns down a band of rows; its
    CTA sorts the strip's segments at the top of the band and moves them
    down a row at a time after that. The band is the shortest whose tiles
    all run at once (the slots: n_sm x per_sm; one CTA an SM where the
    segments are in scratch, each CTA its own): a CTA waits on its loads,
    so the card wants every slot filled, and the extra sorts of shorter
    bands cost less than idle slots (``scripts/torch_kernel_probe.py
    wide`` times each band height on the card). Where even one-band tiles
    overflow the slots, the band is the whole height."""
    nb = min(b, MAX_BATCH)
    strips = -(-w // WIDE_COLS)
    seg = wide_segment_bytes(k)
    shared = seg <= SMEM_PER_BLOCK
    slots = n_sm * (max(1, per_sm) if shared else 1)
    bands = slots // (nb * strips)  # the most bands whose tiles all fit the slots
    rows = -(-h // bands) if bands else h
    tiles = nb * -(-h // rows) * strips
    grid = min(tiles, slots)
    return WideLaunch(rows, tiles, grid, seg if shared else 0, 0 if shared else grid * seg // 4)


def _note_route(kernel: str, route: str, detail: str) -> None:
    """Log a kernel's route the first time this process takes it."""
    log_once(log, (kernel, route), "%s: route %s (%s)", kernel, route, detail)


class MedianLaunch(NamedTuple):
    """How :func:`vector_median_filter_kernel` runs a (b, h, w) batch."""

    route: str  # "network" (odd k <= MAX_WINDOW), "select" (<= MAX_SELECT_WINDOW) or "wide"
    launches: int  # grids of at most MAX_BATCH slices


def _check_window(k: int) -> None:
    if k % 2 != 1 or k < 1:
        raise ValueError(f"median window must be odd and positive, got {k}")


def median_launch_shape(b: int, h: int, w: int, k: int) -> MedianLaunch:
    """The median kernel's route and launches for a (b, h, w) batch and an
    odd window k; ValueError for an even or non-positive window."""
    _check_window(k)
    route = "network" if k <= MAX_WINDOW else "select" if k <= MAX_SELECT_WINDOW else "wide"
    return MedianLaunch(route, max(1, -(-b // MAX_BATCH)))


class FusedLaunch(NamedTuple):
    """The fused kernel's tiles, or the ``split`` route (all zero)."""

    tile_h: int
    tile_w: int
    grid: int
    smem: int

    @property
    def route(self) -> str:
        return "fused" if self.grid else "split"


SPLIT = FusedLaunch(0, 0, 0, 0)


@functools.lru_cache(maxsize=None)
def fused_launch_shape(b: int, h: int, w: int, k: int, ks: int, n_sm: int) -> FusedLaunch:
    """``(tile_h, tile_w, grid, shared bytes)`` of the fused kernel, or
    :data:`SPLIT` where the fused kernel does not take the config: a
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
        return SPLIT
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
        return SPLIT
    _, th, grid = best
    return FusedLaunch(th, tw, grid, smem(th))


WIN_MAX_TAPS = 33  # the windowed plan's taps: every odd count up to here is compiled
WIN_SEG = 8  # rows of V a thread of the windowed plan fills (WIN_SEG in csrc/fused.cu)
WIN_ROWS, WIN_COLS = 32, 128  # a windowed tile's outputs at most
PLANS = ("rows", "staged", "windowed")  # nm03_sharpen's `plan` argument is the index


def sharpen_smem_bytes(ks: int, th: int, tw: int, plan: str) -> int:
    """Shared bytes of a sharpen CTA at th x tw tiles under ``plan``
    (``WinLayout`` and ``sharpen_floats`` in ``csrc/fused.cu``):

    * ``windowed``: the staged tile (th + ks - 1 rows of tw + 2 rsp, rsp =
      ks // 2 rounded up to 4) and V (th rows of tw - 4 + 4 ceil((ks + 3) /
      4): the horizontal pass's 16-byte loads);
    * ``staged``: the ks taps, the staged tile (th + ks - 1 rows of tw + ks
      - 1) and V (th rows of tw + ks - 1);
    * ``rows``: V alone."""
    if plan == "windowed":
        rsp = (ks // 2 + 3) & ~3
        return 4 * ((th + ks - 1) * (tw + 2 * rsp) + th * (tw - 4 + 4 * ((ks + 6) // 4)))
    sw = tw + ks - 1
    return 4 * ((ks + (th + ks - 1) * sw) * (plan == "staged") + th * sw)


class SharpenLaunch(NamedTuple):
    """How :func:`sharpen_filter_kernel` runs a batch."""

    tile_h: int
    tile_w: int
    plan: str  # one of PLANS; "rows" with V in a device scratch where ``scratch``
    grid: int  # CTAs, each walking every grid-th tile
    smem: int  # shared bytes a CTA
    scratch: int  # floats of the device scratch that holds V; 0 where V is shared

    @property
    def staged(self) -> bool:
        """Whether the median tile is staged in shared memory."""
        return self.plan != "rows"


MAX_GRID = 2**31 - 1  # a launch's largest x dimension


def windowed_tile(h: int, w: int) -> tuple[int, int]:
    """The windowed plan's tile for an h x w canvas: WIN_ROWS x WIN_COLS,
    cut to the canvas rounded up to WIN_SEG rows and 4 columns (the kernel
    computes whole tiles)."""
    return (min(WIN_ROWS, -(-h // WIN_SEG) * WIN_SEG), min(WIN_COLS, -(-w // 4) * 4))


@functools.lru_cache(maxsize=None)
def sharpen_launch_shape(b: int, h: int, w: int, ks: int, n_sm: int) -> SharpenLaunch:
    """The sharpen kernel's plan, tiles and memory for a (b, h, w) batch
    and an odd ks on a card of ``n_sm`` SMs.

    Up to WIN_MAX_TAPS taps the windowed plan: :func:`windowed_tile`'s
    tiles, one a CTA (``scripts/torch_kernel_probe.py sharpen`` times tile
    shapes and grids on the card). Past it the first that fits a block's
    shared memory: SHARPEN_ROWS x SHARPEN_COLS tiles with the median tile,
    the taps and V staged (up to 177 taps), one tile a CTA; else the rows of
    one pass only, V staged and the median and the taps read through L1,
    the tile halved in height until V fits; else one-row tiles with V in a
    device scratch, one CTA an SM, each with its own V."""
    if ks <= WIN_MAX_TAPS:
        th, tw = windowed_tile(h, w)
        tiles = b * -(-h // th) * -(-w // tw)
        return SharpenLaunch(th, tw, "windowed", min(tiles, MAX_GRID),
                             sharpen_smem_bytes(ks, th, tw, "windowed"), 0)
    tw = SHARPEN_COLS
    heights = [SHARPEN_ROWS >> i for i in range(SHARPEN_ROWS.bit_length())]  # 32, 16, ..., 1
    for th, plan in [(SHARPEN_ROWS, "staged")] + [(th, "rows") for th in heights]:
        smem = sharpen_smem_bytes(ks, th, tw, plan)
        if smem <= SMEM_PER_BLOCK:
            tiles = b * -(-h // th) * -(-w // tw)
            return SharpenLaunch(th, tw, plan, min(tiles, MAX_GRID), smem, 0)
    grid = min(b * h * -(-w // tw), n_sm)
    return SharpenLaunch(1, tw, "rows", grid, 0, grid * (tw + ks - 1))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _wide_ctas_per_sm(index: int, k: int) -> int:
    """The wide kernel's CTAs an SM of device ``index`` holds at once with
    window k's segments in shared memory, by the runtime's occupancy
    (``nm03_median_wide_ctas_per_sm``); 1 where they are in scratch."""
    if not wide_shared(k):
        return 1
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = build.load("median").nm03_median_wide_ctas_per_sm(k, ctypes.byref(n))
    build.check(err, "nm03_median_wide_ctas_per_sm")
    return n.value


def _batched(x: torch.Tensor, what: str) -> torch.Tensor:
    """``x`` as a contiguous (B, H, W) float32 CUDA tensor, or raise."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, got {x.dtype}")
    if x.dim() < 2:
        raise ValueError(f"{what} takes (..., H, W), got shape {tuple(x.shape)}")
    return x.reshape(-1, x.shape[-2], x.shape[-1]).contiguous()


class Prologue(NamedTuple):
    """Normalize and clip, applied by a median kernel to every value it
    reads (the ``*_pre`` entry points of ``csrc/median.cu``): the median of
    ``clip_intensity(normalize(x, ...), clip_low, clip_high)``, bit for bit.
    ``scale`` is :func:`.elementwise.normalize`'s, computed in double and
    used as float32."""

    norm_min: float
    scale: float
    norm_low: float
    clip_low: float
    clip_high: float

    @classmethod
    def of(cls, norm_low: float, norm_high: float, norm_min: float, norm_max: float,
           clip_low: float, clip_high: float) -> "Prologue":
        return cls(norm_min, (norm_high - norm_low) / (norm_max - norm_min), norm_low,
                   clip_low, clip_high)


def _entry(name: str, prologue):
    """``(function, its name, arguments before the stream)``: the median
    library's entry ``name``, or with a prologue its ``_pre`` twin, which
    takes the prologue's five constants just before the stream."""
    if prologue is not None:
        name += "_pre"
    return getattr(build.load("median"), name), name, tuple(prologue or ())


def vector_median_filter_kernel(x: torch.Tensor, size: int = 7,
                                prologue: Prologue | None = None) -> torch.Tensor:
    """The k x k clamp-to-edge median of a (..., H, W) CUDA tensor: the
    generated plan for k <= MAX_WINDOW, else
    :func:`vector_median_select_kernel` up to MAX_SELECT_WINDOW, else
    :func:`vector_median_wide_kernel`. With a ``prologue`` the kernel
    normalizes and clips each value where it reads it."""
    _check_window(size)
    xb = _batched(x, "vector_median_filter_kernel")
    b, h, w = xb.shape
    shape = median_launch_shape(b, h, w, size)
    if shape.route == "select":
        return vector_median_select_kernel(x, size, prologue)
    if shape.route == "wide":
        return vector_median_wide_kernel(x, size, prologue)
    out = torch.empty_like(xb)
    if xb.numel() == 0:
        return out.reshape(x.shape)
    if shape.launches > 1:
        _note_route("median", "network", f"{b} slices in {shape.launches} launches")
    fn, name, pre = _entry("nm03_median_filter", prologue)
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    for b0 in range(0, b, MAX_BATCH):
        nb = min(MAX_BATCH, b - b0)
        err = fn(xb[b0].data_ptr(), out[b0].data_ptr(), nb, h, w, size, *pre, stream)
        build.check(err, name)
        vector_median_filter_kernel.launches += 1
    return out.reshape(x.shape)


vector_median_filter_kernel.launches = 0


def vector_median_select_kernel(x: torch.Tensor, size: int = 17,
                                prologue: Prologue | None = None) -> torch.Tensor:
    """The k x k clamp-to-edge median of a (..., H, W) CUDA tensor by exact
    selection (``csrc/median.cu``, ``nm03_median_select``): each CTA sorts
    its column segments once and bisects each window's keys with a binary
    search a segment (:func:`select_smem_bytes`). Any odd k up to
    MAX_SELECT_WINDOW, bit-identical to :func:`.median.vector_median_filter`
    (NaN and signed zeros as the source note there says). The route of
    :func:`vector_median_filter_kernel` from k = 17; ``prologue`` as there."""
    _check_window(size)
    if size > MAX_SELECT_WINDOW:
        raise ValueError(f"the select kernel takes windows up to {MAX_SELECT_WINDOW} "
                         f"(MAX_SELECT_WINDOW), got {size}: the wide route takes it")
    xb = _batched(x, "vector_median_select_kernel")
    b, h, w = xb.shape
    shape = median_launch_shape(b, h, w, size)
    out = torch.empty_like(xb)
    if xb.numel() == 0:
        return out.reshape(x.shape)
    _note_route("median", "select", f"k={size}, {shape.launches} launch(es) of {b} slices")
    fn, name, pre = _entry("nm03_median_select", prologue)
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    for b0 in range(0, b, MAX_BATCH):
        nb = min(MAX_BATCH, b - b0)
        err = fn(xb.data_ptr(), out.data_ptr(), b0, nb, h, w, size, MAX_SELECT_WINDOW, *pre,
                 stream)
        build.check(err, name)
        vector_median_select_kernel.launches += 1
    return out.reshape(x.shape)


vector_median_select_kernel.launches = 0


def vector_median_wide_kernel(x: torch.Tensor, size: int = 65,
                              prologue: Prologue | None = None) -> torch.Tensor:
    """The k x k clamp-to-edge median of a (..., H, W) CUDA tensor by a
    bisection over sorted column segments (``csrc/median.cu``,
    ``nm03_median_wide``): each CTA walks a strip of 32 output columns down
    a band of rows (:func:`wide_launch_shape`), sorting the strip's
    segments once and moving them down a row by one deletion and one
    insertion each; the select kernel's order-preserving keys and rule. The
    segments sit in shared memory where they fit (:func:`wide_shared`),
    else in a device scratch allocated here. Any odd k, bit-identical to
    :func:`.median.vector_median_filter` (NaN and signed zeros as for the
    select kernel). The route of :func:`vector_median_filter_kernel` past
    MAX_SELECT_WINDOW; ``prologue`` as there."""
    _check_window(size)
    xb = _batched(x, "vector_median_wide_kernel")
    b, h, w = xb.shape
    shape = median_launch_shape(b, h, w, size)
    out = torch.empty_like(xb)
    if xb.numel() == 0:
        return out.reshape(x.shape)
    index = xb.device.index or 0
    wl = wide_launch_shape(b, h, w, size, _sm_count(index), _wide_ctas_per_sm(index, size))
    where = "shared memory" if wl.smem else "a device scratch"
    _note_route("median", "wide", f"k={size}, segments in {where}, {wl.rows}-row bands, "
                f"{shape.launches} launch(es) of {b} slices")
    scratch = (torch.empty(wl.scratch, dtype=torch.int32, device=xb.device) if wl.scratch
               else None)
    fn, name, pre = _entry("nm03_median_wide", prologue)
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    for b0 in range(0, b, MAX_BATCH):
        nb = min(MAX_BATCH, b - b0)
        err = fn(xb.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                 b0, nb, h, w, size, wl.rows, wl.grid, *pre, stream)
        build.check(err, name)
        vector_median_wide_kernel.launches += 1
    return out.reshape(x.shape)


vector_median_wide_kernel.launches = 0


@functools.lru_cache(maxsize=None)
def _device_taps(sigma: float, size: int, device: torch.device) -> torch.Tensor:
    """:func:`.sharpen.gaussian_kernel_1d`'s float32 taps on ``device``,
    copied once a (sigma, size, device): the first call on a device runs
    eagerly (``serving/graphs.py`` warms before it captures), so a captured
    graph reads a buffer that outlives it."""
    # nm03-lint: disable=NM401 the sharpen's taps: a kernel constant copied once a device, not streamed input
    return torch.from_numpy(gaussian_kernel_1d(sigma, size).copy()).to(device)


def sharpen_filter_kernel(x: torch.Tensor, gain: float = 2.0, sigma: float = 0.5,
                          size: int = 9) -> torch.Tensor:
    """The unsharp sharpen of a (..., H, W) CUDA tensor (``csrc/fused.cu``,
    ``nm03_sharpen``): ``x + gain * (x - blur(x))``, the gaussian blur of
    ``size`` taps down the rows, then along them, clamp-to-edge; any odd
    ``size``. Bit-identical to :func:`.sharpen.sharpen`. The second launch
    of :func:`fused_preprocess_kernel`'s ``split`` route."""
    if size % 2 != 1 or size < 1:
        raise ValueError(f"sharpen kernel must be odd and positive, got {size}")
    xb = _batched(x, "sharpen_filter_kernel")
    b, h, w = xb.shape
    out = torch.empty_like(xb)
    if xb.numel() == 0:
        return out.reshape(x.shape)
    sl = sharpen_launch_shape(b, h, w, size, _sm_count(xb.device.index or 0))
    if sl.plan == "rows":
        v_in = "a device scratch" if sl.scratch else "shared memory"
        _note_route("sharpen", "rows", f"{size} taps over {h}x{w}: {sl.tile_h}-row tiles, the "
                    f"median and the taps through L1, V in {v_in}")
    taps = _device_taps(float(sigma), size, xb.device)
    scratch = (torch.empty(sl.scratch, dtype=torch.float32, device=xb.device) if sl.scratch
               else None)
    err = build.load("fused").nm03_sharpen(
        xb.data_ptr(), out.data_ptr(), taps.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, h, w, size, gain, sl.tile_h,
        sl.tile_w, PLANS.index(sl.plan), sl.grid,
        torch.cuda.current_stream(xb.device).cuda_stream)
    build.check(err, "nm03_sharpen")
    sharpen_filter_kernel.launches += 1
    return out.reshape(x.shape)


sharpen_filter_kernel.launches = 0


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
    :func:`fused_launch_shape` picks the ``split`` route, two kernels: the
    window's median route with normalize and clip on load into one
    ``torch.empty`` buffer, then :func:`sharpen_filter_kernel`.
    """
    _check_window(median_window)
    if sharpen_kernel % 2 != 1 or sharpen_kernel < 1:
        raise ValueError(f"sharpen kernel must be odd and positive, got {sharpen_kernel}")
    xb = _batched(x, "fused_preprocess_kernel")
    b, h, w = xb.shape
    if xb.numel() == 0:
        return torch.empty_like(xb).reshape(x.shape)
    th, tw, grid, _ = fused_launch_shape(
        b, h, w, median_window, sharpen_kernel, _sm_count(xb.device.index or 0))
    pro = Prologue.of(norm_low, norm_high, norm_min, norm_max, clip_low, clip_high)
    if not grid:
        route = median_launch_shape(b, h, w, median_window).route
        _note_route("fused", "split",
                    f"k={median_window}, {sharpen_kernel} sharpen taps: the {route} median "
                    "with normalize and clip on load, then the sharpen kernel")
        med = vector_median_filter_kernel(xb, median_window, pro)
        return sharpen_filter_kernel(med, sharpen_gain, sharpen_sigma,
                                     sharpen_kernel).reshape(x.shape)
    out = torch.empty_like(xb)
    taps = gaussian_kernel_1d(sharpen_sigma, sharpen_kernel)
    c_taps = (ctypes.c_float * len(taps))(*[float(t) for t in taps])
    lib = build.load("fused")
    stream = torch.cuda.current_stream(xb.device).cuda_stream
    err = lib.nm03_fused_preprocess(
        xb.data_ptr(), out.data_ptr(), b, h, w, median_window, *pro, sharpen_gain,
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
