"""3D volumetric operators, plain PyTorch.

The port of the JAX package's ``ops/volume.py``. A patient's T1+C series
stacked into a (D, H, W) volume is segmented with true 3D connectivity, so
a lesion grows as one connected body instead of D independent 2D islands.
The 'cross' footprint at size 3 is the 6-connected structuring element (the
3D analog of the reference's 4-connected flood fill); 'box' gives
26-connectivity.

No Pallas kernel computes these in the JAX package (they are XLA ops).
Here they are torch ops on whatever device the volume is on, and
:func:`region_grow_3d` is also the plain version of the one hand-written
kernel of the volume path, :func:`.hopper_volume.region_grow_3d_kernel`,
which the pipeline takes for the dilate schedule on the card with
``use_kernels`` (``pipeline/volume_pipeline.py::grow_volume``).

* :func:`dilate3d` / :func:`erode3d` work on the last three axes of any
  (..., D, H, W) tensor and keep its dtype (bool or uint8); outside the
  volume counts as background (0) for both.
* :func:`region_grow_3d` is the dilate-schedule fixpoint. Its loop reads
  one popcount per block of ``block_iters`` steps back to the host (a
  synchronization on the card), as the JAX ``while_loop`` evaluates its
  condition once per block; the kernel keeps the schedule and tests one
  "changed" flag on the card instead, with no read on the host.
* :func:`region_grow_jump_3d` is the pointer-jumping label merge, one
  (D, H, W) volume at a time.

Both growths take the pipeline's stage hooks (``stage``, ``counter``):
each block of steps (each round) is a ``grow3d.block`` span, each read
that waits on the card a ``grow3d.sync`` span counted under
``grow3d.syncs``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from nm03_capstone_project_tpu_torch.ops.neighborhood import constant_shifted_views
from nm03_capstone_project_tpu_torch.ops.region_growing import (
    grow_band,
    jump_fill,
    no_count,
    no_stage,
)

_SHAPES = {6: "cross", 26: "box"}


def footprint_offsets_3d(size: int, shape: str = "cross") -> List[Tuple[int, int, int]]:
    """Offsets (dz, dr, dc) of a 3D structuring element.

    shape: 'box' (full cube), 'cross' (city-block radius size//2, the
    6-connected element for size 3), or 'ball' (euclidean radius size/2).
    """
    r = size // 2
    offs = []
    for dz in range(-r, r + 1):
        for dr in range(-r, r + 1):
            for dc in range(-r, r + 1):
                if shape == "box":
                    offs.append((dz, dr, dc))
                elif shape == "cross":
                    if abs(dz) + abs(dr) + abs(dc) <= r:
                        offs.append((dz, dr, dc))
                elif shape == "ball":
                    if dz * dz + dr * dr + dc * dc <= (size / 2.0) ** 2:
                        offs.append((dz, dr, dc))
                else:
                    raise ValueError(f"unknown footprint shape: {shape}")
    return offs


def shifted_stack_3d(x: torch.Tensor, offsets: List[Tuple[int, int, int]]) -> torch.Tensor:
    """Stack 3D-shifted views of ``x`` (..., D, H, W) along a new leading
    axis; voxels shifted in from outside the volume are 0 (the JAX
    package's ``pad_mode="constant"``)."""
    return torch.stack(list(constant_shifted_views(x, offsets, 0)), dim=0)


def _morph3d(x: torch.Tensor, size: int, shape: str, is_max: bool) -> torch.Tensor:
    offs = footprint_offsets_3d(size, shape)
    orig_dtype = x.dtype
    work = x.to(torch.uint8) if orig_dtype == torch.bool else x
    op = torch.maximum if is_max else torch.minimum
    out = None
    # a max/min fold over the views: the same values as the stack's reduction
    for view in constant_shifted_views(work, offs, 0):
        out = view if out is None else op(out, view)
    return out.to(orig_dtype)


def dilate3d(x: torch.Tensor, size: int = 3, shape: str = "cross") -> torch.Tensor:
    """3D dilation over (..., D, H, W); outside the volume counts as background.

    Volumetric extension of FAST ``Dilation::create(3)``
    (src/sequential/main_sequential.cpp:250), 6-connected by default.
    """
    return _morph3d(x, size, shape, is_max=True)


def erode3d(x: torch.Tensor, size: int = 3, shape: str = "cross") -> torch.Tensor:
    """3D erosion over (..., D, H, W); foreground erodes at the volume border."""
    return _morph3d(x, size, shape, is_max=False)


def region_grow_3d(
    volume: torch.Tensor,
    seeds: torch.Tensor,
    low: float = 0.74,
    high: float = 0.91,
    valid: Optional[torch.Tensor] = None,
    connectivity: int = 6,
    block_iters: int = 16,
    max_iters: int = 4096,
    return_steps: bool = False,
    stage=no_stage,
    counter=no_count,
):
    """3D seeded region growing; returns ``(mask, converged)``.

    ``mask`` is uint8 {0,1} shaped like ``volume``; ``converged`` is ONE
    0-d bool for the whole input, leading batch axes included (the
    popcount sums every axis, as in the JAX package), False when
    ``max_iters`` truncated a still-growing region.

    The flood fill is the fixpoint of masked 3D dilation: grow one 6- (or
    26-) connected shell per step, intersect with the band [low, high],
    and repeat until the popcount stops changing. The schedule is the JAX
    package's: one unconditional block of ``block_iters`` steps, then
    blocks while the count changed and fewer than ``max_iters`` steps ran.
    With ``return_steps`` a third value, an int, holds the dilation steps
    run (``block_iters`` times the blocks).
    """
    if connectivity not in _SHAPES:
        raise ValueError(f"connectivity must be 6 or 26, got {connectivity}")
    band = grow_band(volume, low, high, valid)
    shape = _SHAPES[connectivity]
    region0 = seeds.bool() & band

    def grow_block(r):
        for _ in range(block_iters):
            r = dilate3d(r, 3, shape) & band
        return r

    def grew(count, prev):
        # one popcount back to the host per block: the loop's only sync
        with stage("grow3d.sync"):
            flag = bool(count != prev)
        counter("grow3d.syncs")
        return flag

    with stage("grow3d.block"):
        region = grow_block(region0)
        prev, count = region0.sum(), region.sum()
    iters = block_iters
    while grew(count, prev) and iters < max_iters:
        with stage("grow3d.block"):
            region = grow_block(region)
            prev, count = count, region.sum()
        iters += block_iters
    out = (region.to(torch.uint8), count == prev)
    return out + (iters,) if return_steps else out


def region_grow_jump_3d(
    volume: torch.Tensor,
    seeds: torch.Tensor,
    low: float = 0.74,
    high: float = 0.91,
    valid: Optional[torch.Tensor] = None,
    connectivity: int = 6,
    max_rounds: int = 256,
    return_steps: bool = False,
    stage=no_stage,
    counter=no_count,
):
    """3D flood fill in O(log diameter) rounds via pointer-jumping label merge.

    Returns ``(mask, converged)`` like :func:`region_grow_3d` (the same
    sets whenever the dilate schedule converges within its cap). One
    (D, H, W) volume, a batch of one for :func:`.region_growing.jump_fill`;
    any other rank raises. Labels are int32 voxel ids, ``n = D*H*W`` the
    sentinel of out-of-band voxels, and the loop reads one "anything
    changed" flag per round back to the host. With ``return_steps`` a third
    value, an int, holds the rounds run.
    """
    if volume.dim() != 3:
        raise ValueError(
            f"region_grow_jump_3d is per-volume (3D); got shape {tuple(volume.shape)}"
            " — call it once per volume instead"
        )
    if connectivity not in _SHAPES:
        raise ValueError(f"connectivity must be 6 or 26, got {connectivity}")
    band = grow_band(volume, low, high, valid)
    seeds = torch.broadcast_to(seeds.bool(), band.shape)
    offsets = footprint_offsets_3d(3, _SHAPES[connectivity])
    region, converged, rounds = jump_fill(band[None], seeds[None], offsets, max_rounds,
                                          stage, counter)
    out = (region[0], converged[0])
    return out + (rounds,) if return_steps else out
