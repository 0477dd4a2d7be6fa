"""Image containers.

Every slice is padded to a fixed canvas and its true (height, width) rides
along as data, so one batch holds slices of every size.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class SliceBatch:
    """A batch of 2D slices padded to a common canvas.

    Attributes:
      pixels: float32 tensor (B, H, W) — padded pixel data. Padding values
        are 0 and must be ignored via :func:`valid_mask`.
      dims: int32 tensor (B, 2) — the true (height, width) of each slice.
    """

    pixels: torch.Tensor
    dims: torch.Tensor

    @property
    def batch(self) -> int:
        return self.pixels.shape[0]

    @property
    def canvas_hw(self) -> Tuple[int, int]:
        return self.pixels.shape[-2], self.pixels.shape[-1]


def valid_mask(dims: torch.Tensor, canvas_hw: Tuple[int, int]) -> torch.Tensor:
    """Bool mask (..., H, W): True where row < height and col < width.

    ``dims`` has shape (..., 2) holding (height, width).
    """
    h, w = canvas_hw
    rows = torch.arange(h, dtype=torch.int32, device=dims.device).view(h, 1)
    cols = torch.arange(w, dtype=torch.int32, device=dims.device).view(1, w)
    height = dims[..., 0:1, None]  # (..., 1, 1)
    width = dims[..., 1:2, None]
    return (rows < height) & (cols < width)
