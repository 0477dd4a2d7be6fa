"""Adaptive seed-point generation.

The reference builds its SeededRegionGrowing seed list from the image
dimensions with C++ integer arithmetic (src/test/test_pipeline.cpp:79-106,
src/sequential/main_sequential.cpp:213-241):

* a central seed (w/2, h/2),
* four offset seeds at (w/2 +- w/8, h/2) and (w/2, h/2 +- h/8),
* a grid over the central half: x in [w/4, 3*w/4) step w/10,
  y in [h/4, 3*h/4) step h/10.

Here the seed list is a seed mask computed elementwise from the true dims
of each slice. All divisions are integer floor divisions, matching C++
integer division on the positive operands involved.
"""

from __future__ import annotations

from typing import Tuple

import torch


def seed_mask(dims: torch.Tensor, canvas_hw: Tuple[int, int]) -> torch.Tensor:
    """Bool (..., H, W) mask marking the reference's adaptive seed points.

    Args:
      dims: integer tensor (..., 2) of true (height, width) per slice.
      canvas_hw: padded canvas shape.
    """
    hh, ww = canvas_hw
    rows = torch.arange(hh, dtype=torch.int32, device=dims.device).view(hh, 1)
    cols = torch.arange(ww, dtype=torch.int32, device=dims.device).view(1, ww)

    h = dims[..., 0:1, None].to(torch.int32)  # (..., 1, 1)
    w = dims[..., 1:2, None].to(torch.int32)

    cx = w // 2
    cy = h // 2
    off_x = w // 8
    off_y = h // 8

    # the five explicit seeds: center plus axis-aligned offsets
    # (test_pipeline.cpp:86-95)
    fixed = (
        ((cols == cx) & (rows == cy))
        | ((cols == cx + off_x) & (rows == cy))
        | ((cols == cx - off_x) & (rows == cy))
        | ((cols == cx) & (rows == cy + off_y))
        | ((cols == cx) & (rows == cy - off_y))
    )

    # the central-half grid (test_pipeline.cpp:102-106); step >= 1 so tiny
    # images (below the reference's own 100 px guard) don't divide by zero
    step_x = torch.clamp(w // 10, min=1)
    step_y = torch.clamp(h // 10, min=1)
    x0 = w // 4
    y0 = h // 4
    grid = (
        (cols >= x0)
        & (cols < (3 * w) // 4)
        & ((cols - x0) % step_x == 0)
        & (rows >= y0)
        & (rows < (3 * h) // 4)
        & ((rows - y0) % step_y == 0)
    )

    inside = (rows < h) & (cols < w) & (rows >= 0) & (cols >= 0)
    return (fixed | grid) & inside
