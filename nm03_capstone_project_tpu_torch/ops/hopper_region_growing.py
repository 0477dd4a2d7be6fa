"""Hand-written Hopper kernel for seeded region growing.

The JAX package's Pallas kernel ``_grow_kernel``
(ops/pallas_region_growing.py:30) becomes the CUDA kernel of
``csrc/grow.cu``: one thread-block cluster per slice iterating the
masked-dilation fixpoint on bit-packed rows, each CTA holding a band of
rows in its shared memory and reading its neighbours' edge rows from
theirs. :func:`region_grow_kernel` is bit-identical to the plain
:func:`.region_growing.region_grow`: mask, per-slice ``converged`` and
steps alike.

:func:`grow_launch_shape` picks the cluster for a slice size. Up to a
2048 x 2048 canvas fits; a slice whose share of rows exceeds one CTA's
shared memory even at 8 CTAs is refused with a ValueError before launch;
there is no route to the plain op on the card.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.ops.region_growing import region_grow, region_grow_jump

CUDA_ERROR_INVALID_CONFIGURATION = 9  # cudaErrorInvalidConfiguration
SMEM_PER_BLOCK = 232448  # the H100's opt-in shared memory per block (227 KB)
MAX_CLUSTER = 8  # the largest portable cluster
WORDS_PER_CTA = 512  # the cluster grows until each CTA owns about this many words
MAX_HALO = 16  # rows a CTA holds beyond its own on each side
SCRATCH_WORDS = 64  # popcount partials: one per warp and one per rank


@functools.lru_cache(maxsize=None)
def grow_launch_shape(h: int, w: int) -> Tuple[int, int, int]:
    """``(C, rows per CTA, shared bytes per CTA)`` for an (h, w) slice.

    C is the smallest of 2, 4, 8 that leaves about WORDS_PER_CTA 32-pixel
    words to each CTA (a batch of 25 slices of 256 x 256 keeps 100 CTAs
    busy, one an SM) and whose bit-packed band and two region buffers fit
    a CTA's shared memory: its own rows and min(MAX_HALO, rows) halo rows
    each side, as ``csrc/grow.cu`` lays them out. Raises ValueError where
    not even 8 CTAs hold the slice.
    """
    if h < 1 or w < 1:
        raise ValueError(f"grow kernel: empty slice {h}x{w}")
    ww = (w + 31) // 32

    def shape(c: int) -> Tuple[int, int, int]:
        rows = -(-h // c)
        words = (rows + 2 * min(MAX_HALO, rows)) * ww  # a buffer
        return c, rows, (3 * words + SCRATCH_WORDS) * 4

    c = 2
    while c < MAX_CLUSTER and (h * ww > c * WORDS_PER_CTA or shape(c)[2] > SMEM_PER_BLOCK):
        c *= 2
    if shape(c)[2] > SMEM_PER_BLOCK:
        raise ValueError(
            f"grow kernel: a {h}x{w} slice needs {shape(c)[2]} bytes of shared memory in "
            f"each of {c} CTAs, more than a block may use (a 2048x2048 canvas fits)"
        )
    return shape(c)


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
    if image.device.type != "cuda":
        raise ValueError(f"region_grow_kernel takes CUDA tensors, got {image.device}")
    if image.dtype != torch.float32:
        raise TypeError(f"region_grow_kernel takes float32, got {image.dtype}")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if block_iters < 1 or max_iters < 1:
        raise ValueError("grow iteration counts must be positive")
    lead, (h, w) = image.shape[:-2], image.shape[-2:]
    cluster, _, smem = grow_launch_shape(h, w)
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
