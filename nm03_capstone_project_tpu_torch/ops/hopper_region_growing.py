"""Hand-written Hopper kernels for seeded region growing.

The JAX package's Pallas kernel ``_grow_kernel``
(ops/pallas_region_growing.py:30) becomes the CUDA kernels of
``csrc/grow.cu``. :func:`region_grow_kernel` is bit-identical to the plain
:func:`.region_growing.region_grow`: mask, per-slice ``converged`` and
steps alike. It takes one of two routes, picked by
:func:`grow_launch_shape` from the slice size before launch and named in
a log line at its first use:

* ``cluster``: one thread-block cluster per slice iterating the
  masked-dilation fixpoint on bit-packed rows, each CTA holding a band of
  rows in its shared memory and reading its neighbours' edge rows from
  theirs. Up to about a 2160 x 2048 slice (8 CTAs' shared memory); every
  slice that fits takes it.
* ``global``: past that, :func:`region_grow_global_kernel`, one
  cooperative grid over the whole batch with the bit-packed band and
  region in global memory, stepped by tiles in shared memory
  (:func:`global_tiles`) with one grid barrier per super-step of up to
  ``block_iters`` steps, at any slice size whose buffers fit the card's
  memory (one that does not fails in torch's own allocation).

Neither route ends in the plain op on the card.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.ops.region_growing import region_grow, region_grow_jump
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger, log_once

log = get_logger("kernels")

CUDA_ERROR_INVALID_CONFIGURATION = 9  # cudaErrorInvalidConfiguration
SMEM_PER_BLOCK = 232448  # the H100's opt-in shared memory per block (227 KB)
MAX_CLUSTER = 8  # the largest portable cluster
WORDS_PER_CTA = 512  # the cluster grows until each CTA owns about this many words
MAX_HALO = 16  # rows a CTA holds beyond its own on each side
SCRATCH_WORDS = 64  # popcount partials: one per warp and one per rank
GLOBAL_MAX_WORDS = 1 << 30  # packed words of one global launch (the rest in more)
GLOBAL_THREADS = 512  # threads of a global-route CTA
GLOBAL_MAX_HALO = 32  # rows a global tile holds beyond its own (a step moves a pixel one place)
GLOBAL_WIDE_WORDS = 128  # a global tile spans its slice's width up to this many words
GLOBAL_TILE_WORDS = 126  # else at most this many own words, 128 held with a word each side
GLOBAL_RED = 40  # ints of reduction scratch a global CTA keeps after its slice bits


class GrowLaunch(NamedTuple):
    """``(C, rows per CTA, shared bytes per CTA)`` of the cluster route, or
    all zero for the global route."""

    cluster: int
    rows: int
    smem: int

    @property
    def route(self) -> str:
        return "cluster" if self.cluster else "global"


@functools.lru_cache(maxsize=None)
def grow_launch_shape(h: int, w: int) -> GrowLaunch:
    """The grow kernel's launch for an (h, w) slice.

    The cluster route: C is the smallest of 2, 4, 8 that leaves about
    WORDS_PER_CTA 32-pixel words to each CTA (a batch of 25 slices of 256
    x 256 keeps 100 CTAs busy, one an SM) and whose bit-packed band and
    two region buffers fit a CTA's shared memory: its own rows and
    min(MAX_HALO, rows) halo rows each side, as ``csrc/grow.cu`` lays them
    out. Where not even 8 CTAs hold the slice, the global route
    (``GrowLaunch(0, 0, 0)``), at any size. ValueError for an empty slice.
    """
    if h < 1 or w < 1:
        raise ValueError(f"grow kernel: empty slice {h}x{w}")
    ww = (w + 31) // 32

    def shape(c: int) -> GrowLaunch:
        rows = -(-h // c)
        words = (rows + 2 * min(MAX_HALO, rows)) * ww  # a buffer
        return GrowLaunch(c, rows, (3 * words + SCRATCH_WORDS) * 4)

    c = 2
    while c < MAX_CLUSTER and (h * ww > c * WORDS_PER_CTA or shape(c)[2] > SMEM_PER_BLOCK):
        c *= 2
    if shape(c)[2] <= SMEM_PER_BLOCK:
        return shape(c)
    return GrowLaunch(0, 0, 0)


class GlobalTiles(NamedTuple):
    """The global route's tiling of a launch, which the kernel takes as
    given (``csrc/grow.cu``, ``GlobalTiles``): own rows and words of a
    tile, the rows it holds beyond them each side, the words of a row in
    shared memory (:func:`global_pitch`), the tiles of the launch, its
    CTAs, the shared bytes of one, and whether every tile has a CTA of its
    own."""

    rows: int
    words: int
    halo: int
    pitch: int
    tiles: int
    grid: int
    smem: int

    @property
    def resident(self) -> bool:
        return self.tiles <= self.grid


@functools.lru_cache(maxsize=None)
def global_tiles(b: int, h: int, w: int, block_iters: int, n_sm: int) -> GlobalTiles:
    """The tiles of the global route for b (h, w) slices on n_sm SMs.

    A tile spans its slice's width up to GLOBAL_WIDE_WORDS words, else the
    width is cut into equal tiles of at most GLOBAL_TILE_WORDS. The rows
    are cut so that the tiles number about one an SM, where the held tile
    (its own rows and ``halo`` = min(block_iters, GLOBAL_MAX_HALO, rows)
    rows each side, band and two region buffers) fits a CTA's shared
    memory, with a border of zero words around it (:func:`global_pitch`):
    then every tile stays in its CTA for the whole fixpoint. Otherwise the
    CTAs walk the tiles, cut as many as make whole rounds of the CTAs. A tile
    is at least min(block_iters, GLOBAL_MAX_HALO, h) rows tall, so that
    one super-step reaches no farther than the neighbouring tiles.
    """
    ww = (w + 31) // 32
    s0 = min(block_iters, GLOBAL_MAX_HALO)
    tx = 1 if ww <= GLOBAL_WIDE_WORDS else -(-ww // GLOBAL_TILE_WORDS)
    tw = -(-ww // tx)
    pitch = global_pitch(ww, tw)
    fixed = 4 * ((b + 31) // 32 + GLOBAL_RED)
    tr_max = (SMEM_PER_BLOCK - fixed) // (12 * pitch) - 2 * s0 - 2
    tr = -(-h // max(1, n_sm // (b * tx)))
    tr = max(tr, min(s0, h))
    if tr > tr_max:
        if tr_max < min(s0, h):
            raise ValueError(f"grow kernel: no global tile of a {h}x{w} slice fits shared memory")
        # as many tile rows as make whole rounds of the CTAs, at least
        # those that fit
        ty = -(-h // tr_max)
        rounds = -(-(b * ty * tx) // n_sm)
        ty = max(ty, min(h // min(s0, h), rounds * n_sm // (b * tx)))
        tr = -(-h // ty)
    halo = min(s0, tr)
    tiles = b * -(-h // tr) * tx
    rows = min(h, tr + 2 * halo)
    return GlobalTiles(tr, tw, halo, pitch, tiles, min(tiles, n_sm),
                       4 * (3 * (rows + 2) * pitch) + fixed)


def global_pitch(ww: int, tw: int) -> int:
    """Words of a row of a global tile in shared memory: its held words (a
    word each side of the own ones, within the slice) rounded up to even,
    and a border of zero words, two left and two right (``csrc/grow.cu``)."""
    held = ww if tw == ww else min(ww, tw + 2)
    return -(-held // 2) * 2 + 4


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_args(image: torch.Tensor, what: str, connectivity: int, block_iters: int,
                max_iters: int) -> None:
    """Raise on what the grow kernels do not take."""
    if image.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got {image.device}")
    if image.dtype != torch.float32:
        raise TypeError(f"{what} takes float32, got {image.dtype}")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if block_iters < 1 or max_iters < 1:
        raise ValueError("grow iteration counts must be positive")


def _flat_u8(t: torch.Tensor, name: str, image: torch.Tensor) -> torch.Tensor:
    """``t != 0`` broadcast to ``image``'s shape, as contiguous (B, H, W)
    uint8 on ``image``'s device (the plain op broadcasts the same way). A
    bool tensor of the image's shape is passed on as it is, without a copy."""
    if t.device != image.device:
        raise ValueError(f"region_grow_kernel: {name} is on {t.device}, image on {image.device}")
    h, w = image.shape[-2:]
    m = t if t.dtype == torch.bool else t != 0
    return torch.broadcast_to(m, image.shape).reshape(-1, h, w).contiguous().view(torch.uint8)


def region_grow_kernel(
    image: torch.Tensor,
    seeds: torch.Tensor,
    low: float = 0.74,
    high: float = 0.91,
    valid: Optional[torch.Tensor] = None,
    connectivity: int = 4,
    block_iters: int = 16,
    max_iters: int = 1024,
    return_steps: bool = False,
):
    """Region growing of (..., H, W) CUDA tensors; ``(mask uint8, converged)``.

    ``converged`` has the leading shape (one bool per slice). ``seeds`` and
    ``valid`` broadcast to the image's shape. With ``return_steps`` a third
    int32 tensor of that leading shape holds the dilation steps each slice
    ran, as :func:`.region_growing.region_grow` reports them.
    """
    _check_args(image, "region_grow_kernel", connectivity, block_iters, max_iters)
    lead, (h, w) = image.shape[:-2], image.shape[-2:]
    cluster, _, smem = grow_launch_shape(h, w)
    if not cluster:
        return region_grow_global_kernel(
            image, seeds, low, high, valid=valid, connectivity=connectivity,
            block_iters=block_iters, max_iters=max_iters, return_steps=return_steps)
    img = image.reshape(-1, h, w).contiguous()
    b = img.shape[0]
    sd = _flat_u8(seeds, "seeds", image)
    vd = None if valid is None else _flat_u8(valid, "valid", image)
    mask = torch.empty((b, h, w), dtype=torch.uint8, device=img.device)
    conv = torch.empty((b,), dtype=torch.int32, device=img.device)
    steps = torch.empty((b,), dtype=torch.int32, device=img.device)
    if b > 0:
        lib = build.load("grow")
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.nm03_region_grow(
            img.data_ptr(), sd.data_ptr(), None if vd is None else vd.data_ptr(),
            mask.data_ptr(), conv.data_ptr(), steps.data_ptr(), b, h, w,
            float(np.float32(low)), float(np.float32(high)),
            connectivity, block_iters, max_iters, cluster, stream,
        )
        if err == CUDA_ERROR_INVALID_CONFIGURATION:
            raise ValueError(
                f"grow kernel: a {h}x{w} slice needs {smem} bytes of shared memory in "
                f"each of {cluster} CTAs, more than this card lets a block use"
            )
        build.check(err, "nm03_region_grow")
        region_grow_kernel.launches += 1
    out = (mask.reshape(image.shape), (conv != 0).reshape(lead))
    return out + (steps.reshape(lead),) if return_steps else out


region_grow_kernel.launches = 0


def region_grow_global_kernel(
    image: torch.Tensor,
    seeds: torch.Tensor,
    low: float = 0.74,
    high: float = 0.91,
    valid: Optional[torch.Tensor] = None,
    connectivity: int = 4,
    block_iters: int = 16,
    max_iters: int = 1024,
    return_steps: bool = False,
):
    """:func:`region_grow_kernel` by the global route (``csrc/grow.cu``,
    ``nm03_region_grow_global``): the band and the two region buffers
    bit-packed in global memory, the steps run by tiles in shared memory
    (:func:`global_tiles`), one cooperative launch a batch of at most
    GLOBAL_MAX_WORDS packed words (a slice past that alone in its own
    launch). The route of :func:`region_grow_kernel` for slices past one
    cluster; any slice size works here."""
    _check_args(image, "region_grow_global_kernel", connectivity, block_iters, max_iters)
    lead, (h, w) = image.shape[:-2], image.shape[-2:]
    if h < 1 or w < 1:
        raise ValueError(f"grow kernel: empty slice {h}x{w}")
    img = image.reshape(-1, h, w).contiguous()
    b = img.shape[0]
    sd = _flat_u8(seeds, "seeds", image)
    vd = None if valid is None else _flat_u8(valid, "valid", image)
    mask = torch.empty((b, h, w), dtype=torch.uint8, device=img.device)
    conv = torch.empty((b,), dtype=torch.int32, device=img.device)
    steps = torch.empty((b,), dtype=torch.int32, device=img.device)
    words = h * ((w + 31) // 32)
    per_launch = max(1, GLOBAL_MAX_WORDS // words)
    if b > 0:
        log_once(log, ("grow", "global"),
                 "grow: route global (%dx%d slices past one cluster's shared memory)", h, w)
        lib = build.load("grow")
        stream = torch.cuda.current_stream(img.device).cuda_stream
        lo, hi = float(np.float32(low)), float(np.float32(high))
        n_sm = _sm_count(img.device.index or 0)
        for b0 in range(0, b, per_launch):
            nb = min(per_launch, b - b0)
            tiles = global_tiles(nb, h, w, block_iters, n_sm)
            packed = torch.empty((3, nb * words), dtype=torch.int32, device=img.device)
            scratch = torch.zeros((5 * nb + 3 * tiles.tiles,), dtype=torch.int32,
                                  device=img.device)
            err = lib.nm03_region_grow_global(
                img[b0].data_ptr(), sd[b0].data_ptr(),
                None if vd is None else vd[b0].data_ptr(),
                mask[b0].data_ptr(), conv[b0:].data_ptr(), steps[b0:].data_ptr(),
                packed[0].data_ptr(), packed[1].data_ptr(), packed[2].data_ptr(),
                scratch.data_ptr(), nb, h, w, lo, hi, connectivity, block_iters, max_iters,
                tiles.rows, tiles.words, tiles.halo, tiles.pitch, tiles.grid, stream,
            )
            build.check(err, "nm03_region_grow_global")
            region_grow_global_kernel.launches += 1
    out = (mask.reshape(image.shape), (conv != 0).reshape(lead))
    return out + (steps.reshape(lead),) if return_steps else out


region_grow_global_kernel.launches = 0


def grow_dispatch(
    image: torch.Tensor,
    seeds: torch.Tensor,
    low: float,
    high: float,
    valid: Optional[torch.Tensor] = None,
    connectivity: int = 4,
    block_iters: int = 16,
    max_iters: int = 1024,
    use_kernels: bool = True,
    algorithm: str = "dilate",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Route a 2D grow by schedule and device.

    ``algorithm="dilate"``: the grow kernel for a CUDA tensor with
    ``use_kernels``, else the plain :func:`.region_growing.region_grow`.
    ``algorithm="jump"``: :func:`.region_growing.region_grow_jump` on any
    device, torch ops (no kernel computes that schedule, in either
    package). ``max_iters`` stays a growth radius in one-ring steps: the
    jump schedule doubles its reach a round, so its round cap is
    ``ceil(log2(max(max_iters, 2))) + 2``, the JAX package's budget.
    """
    if algorithm not in ("dilate", "jump"):
        raise ValueError(f"grow algorithm must be 'dilate' or 'jump', got {algorithm!r}")
    if algorithm == "jump":
        max_rounds = math.ceil(math.log2(max(max_iters, 2))) + 2
        return region_grow_jump(image, seeds, low, high, valid=valid,
                                connectivity=connectivity, max_rounds=max_rounds)
    kw = dict(valid=valid, connectivity=connectivity, block_iters=block_iters,
              max_iters=max_iters)
    if use_kernels and image.device.type != "cpu":
        return region_grow_kernel(image, seeds, low, high, **kw)
    return region_grow(image, seeds, low, high, **kw)
