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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.ops.morphology import dilate


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
