"""Morphological dilation / erosion.

Equivalents of FAST ``Dilation::create(3)`` / ``Erosion::create(3)``
(reference src/test/test_pipeline.cpp:119-125), the cleanup on the uint8
segmentation mask. Outside-image pixels count as background (0): dilation
pads with the minimum, erosion erodes at the image border. Each op is a
max/min fold over the shifted views of the structuring element ('cross',
'box' or 'disk'). The JAX package decomposes some elements (box as two
separable passes, disk 5 as box 3 then cross 3); max and min are exact and
the constant-0 border commutes through the stages on the non-negative mask
dtypes these ops serve, so the plain fold gives the same bits.
"""

from __future__ import annotations

import torch

from nm03_capstone_project_tpu_torch.ops.neighborhood import footprint_offsets, pad


def _morph(x: torch.Tensor, size: int, shape: str, is_max: bool) -> torch.Tensor:
    if size == 1:
        return x
    orig_dtype = x.dtype
    work = x.to(torch.uint8) if orig_dtype == torch.bool else x
    offs = footprint_offsets(size, shape)
    r = size // 2
    xp = pad(work, r, r, "constant", 0)
    h, w = x.shape[-2], x.shape[-1]
    op = torch.maximum if is_max else torch.minimum
    out = None
    for dr, dc in offs:
        view = xp[..., r + dr : r + dr + h, r + dc : r + dc + w]
        out = view if out is None else op(out, view)
    return out.to(orig_dtype)


def dilate(x: torch.Tensor, size: int = 3, shape: str = "cross") -> torch.Tensor:
    """Grayscale/binary dilation with a size x size structuring element."""
    return _morph(x, size, shape, is_max=True)


def erode(x: torch.Tensor, size: int = 3, shape: str = "cross") -> torch.Tensor:
    """Grayscale/binary erosion with a size x size structuring element."""
    return _morph(x, size, shape, is_max=False)
