"""Seeded region growing, plain PyTorch.

Equivalent of FAST ``SeededRegionGrowing::create(0.74f, 0.91f, seeds)``
(reference src/test/test_pipeline.cpp:98-108): a flood fill from the
adaptive seeds accepting pixels whose intensity lies in [low, high].

:func:`region_grow` is the fixpoint of masked dilation, on the JAX
package's schedule: one unconditional block of ``block_iters`` steps, then
blocks until the popcount stops changing or ``max_iters`` is reached. Each
step is Jacobi: the whole region grows by one ring from the previous one.
It is the plain version the CUDA grow kernel
(``ops.hopper_region_growing``) is held against.

:func:`region_grow_jump` is the other convergence schedule of the JAX
package, pointer-jumping label merge: the same sets in O(log diameter)
rounds. No kernel computes it, in either package.

The 3D growth's loops (:func:`jump_fill` here, ``ops.volume``) take the
pipeline's stage hooks as arguments, ``stage(name)`` a context and
``counter(name)``; :func:`no_stage` and :func:`no_count` are the hooks of
a caller that records nothing.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.ops.morphology import dilate
from nm03_capstone_project_tpu_torch.ops.neighborhood import (
    constant_shifted_views,
    footprint_offsets,
)


def grow_band(
    image: torch.Tensor, low: float, high: float, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Bool band ``low <= image <= high`` (and ``valid``).

    The bounds are compared as float32, as the JAX package's weak-typed
    Python floats are (0.74 -> 0.74000001f).
    """
    band = (image >= float(np.float32(low))) & (image <= float(np.float32(high)))
    if valid is not None:
        band = band & valid.bool()
    return band


def region_grow(
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
    """Flood-fill segmentation; returns ``(mask, converged)``.

    ``image``/``seeds``/``valid`` are (..., H, W). ``mask`` is uint8 {0,1}
    shaped like ``image``; ``converged`` has the leading shape (one bool per
    slice; a 0-d tensor for one slice) and is False where the iteration cap
    truncated a still-growing region. The loop runs while any slice still
    grows; a slice whose popcount is stable is a fixpoint, so further steps
    leave it unchanged and the result equals a loop per slice.

    With ``return_steps`` a third int32 tensor of the leading shape holds
    the dilation steps each slice's own loop runs: the depth of its
    fixpoint, which the grow kernel reports the same way.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    band = grow_band(image, low, high, valid)
    shape = "cross" if connectivity == 4 else "box"

    def grow_block(r):
        for _ in range(block_iters):
            r = dilate(r, 3, shape) & band
        return r

    region = seeds.bool() & band
    prev = region.sum(dim=(-2, -1))
    region = grow_block(region)
    count = region.sum(dim=(-2, -1))
    steps = torch.full_like(count, block_iters, dtype=torch.int32)
    iters = block_iters
    while bool((count != prev).any()) and iters < max_iters:
        steps += block_iters * (count != prev)
        region = grow_block(region)
        prev, count = count, region.sum(dim=(-2, -1))
        iters += block_iters
    out = (region.to(torch.uint8), count == prev)
    return out + (steps,) if return_steps else out


# label-chain compressions (gathers) after each neighbour-min, as in the JAX package
_JUMPS_PER_ROUND = 2

_NO_STAGE = contextlib.nullcontext()


def no_stage(name: str):
    return _NO_STAGE


def no_count(name: str, value: int = 1) -> None:
    pass


def jump_fill(band: torch.Tensor, seeds: torch.Tensor, offsets, max_rounds: int,
              stage=no_stage, counter=no_count):
    """Pointer-jumping label merge over a batch of 2D or 3D grids.

    ``band`` and ``seeds`` are bool (B, *grid); ``offsets`` are the
    neighbours over the grid axes (a footprint; its centre is harmless).
    Returns ``(region, converged, rounds)``: the uint8 region (B, *grid),
    one bool per grid, and the rounds run.

    Labels are int32 cell ids per grid, ``n`` (the grid's size) the
    sentinel of out-of-band cells. Each round takes the min label over the
    in-band neighbours, then compresses label chains with ``label <-
    label_of[label]`` (a gather) ``_JUMPS_PER_ROUND`` times; the loop reads
    one "anything changed" flag per round back to the host and stops at the
    first round that changes no grid, since a grid at its fixpoint stays
    there. A cell joins the region iff its component's label is one a seed
    carries.

    ``stage`` and ``counter`` are the 3D growth's hooks: a round is a
    ``grow3d.block`` span, its flag read a ``grow3d.sync`` span counted
    under ``grow3d.syncs``.
    """
    b, grid = band.shape[0], band.shape[1:]
    n = math.prod(grid)
    dev = band.device
    sentinel = torch.tensor(n, dtype=torch.int32, device=dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev).reshape(grid)
    labels0 = torch.where(band, ids, sentinel)
    tail = sentinel.expand(b, 1)

    def gather(table, labels):
        # torch gathers with int64 indices; the label values stay int32
        return torch.gather(table, 1, labels.reshape(b, n).long()).reshape(band.shape)

    def round_(labels):
        m = labels
        for view in constant_shifted_views(labels, offsets, n):
            m = torch.minimum(m, view)
        labels = torch.where(band, m, sentinel)
        for _ in range(_JUMPS_PER_ROUND):
            flat = torch.cat([labels.reshape(b, n), tail], dim=1)
            labels = torch.where(band, gather(flat, labels), sentinel)
        return labels

    def changed(prev, labels):
        with stage("grow3d.sync"):
            flag = bool((prev != labels).any())
        counter("grow3d.syncs")
        return flag

    with stage("grow3d.block"):
        prev, labels, it = labels0, round_(labels0), 1
    while changed(prev, labels) and it < max_rounds:
        with stage("grow3d.block"):
            prev, labels = labels, round_(labels)
        it += 1
    converged = (prev == labels).reshape(b, n).all(dim=1)

    seed_labels = torch.where(seeds & band, labels, sentinel)
    marked = torch.zeros((b, n + 1), dtype=torch.bool, device=dev)
    # duplicate indices all write True: deterministic
    marked.scatter_(1, seed_labels.reshape(b, n).long(), True)
    marked[:, n] = False
    return (band & gather(marked, labels)).to(torch.uint8), converged, it


def region_grow_jump(
    image: torch.Tensor,
    seeds: torch.Tensor,
    low: float = 0.74,
    high: float = 0.91,
    valid: Optional[torch.Tensor] = None,
    connectivity: int = 4,
    max_rounds: int = 256,
):
    """Flood fill in O(log diameter) rounds via pointer-jumping label merge.

    Returns ``(mask, converged)`` like :func:`region_grow`, one ``converged``
    per slice of the leading shape. The same sets as :func:`region_grow`
    (4/8-connected band pixels reachable from a seed), so the masks are
    bit-identical whenever both converge; ``converged`` is False only where
    ``max_rounds`` cut the label fixpoint short. The JAX package's
    ``region_grow_jump`` takes one (H, W) slice and is vmapped; this takes
    (..., H, W) and runs :func:`jump_fill` over the slices as one batch,
    which equals a loop per slice.
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    offsets = footprint_offsets(3, "cross" if connectivity == 4 else "box")
    hw = image.shape[-2:]
    band = torch.broadcast_to(grow_band(image, low, high, valid), image.shape)
    seeds = torch.broadcast_to(seeds.bool(), image.shape)
    region, converged, _ = jump_fill(band.reshape(-1, *hw), seeds.reshape(-1, *hw),
                                     offsets, max_rounds)
    return region.reshape(image.shape), converged.reshape(image.shape[:-2])
