"""Shared neighborhood machinery for the stencil ops.

The reference's per-pixel kernels run under OpenCL samplers with
clamp-to-edge addressing; on a padded canvas the equivalent is
(a) replicating each slice's true edge into the padding region
(:func:`extend_edges`) so stencils never mix padding zeros into real pixels,
and (b) expressing small windows as stacks of shifted views
(:func:`shifted_stack`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def extend_edges(x: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """Replicate each slice's true boundary into the canvas padding.

    ``x`` is (..., H, W); ``dims`` is (..., 2) true (height, width). Every
    pixel at (r, c) becomes x[min(r, h-1), min(c, w-1)]: rows first, then
    the columns of the row-extended array.
    """
    h_canvas, w_canvas = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    rows = torch.arange(h_canvas, device=x.device).view(h_canvas, 1)
    cols = torch.arange(w_canvas, device=x.device).view(1, w_canvas)
    h = dims[..., 0:1, None].long()
    w = dims[..., 1:2, None].long()
    row_edge = torch.gather(x, -2, (h - 1).expand(*lead, 1, w_canvas))
    x = torch.where(rows >= h, row_edge, x)
    col_edge = torch.gather(x, -1, (w - 1).expand(*lead, h_canvas, 1))
    return torch.where(cols >= w, col_edge, x)


def pad(x: torch.Tensor, r_rows: int, r_cols: int, mode: str = "edge", value=0):
    """Pad the last two axes by ``r_rows``/``r_cols`` on both sides.

    ``mode`` is 'edge' (replicate, via clamped index gathers, any dtype and
    rank) or 'constant' (``value``).
    """
    h, w = x.shape[-2], x.shape[-1]
    if mode == "constant":
        out = x.new_full((*x.shape[:-2], h + 2 * r_rows, w + 2 * r_cols), value)
        out[..., r_rows : r_rows + h, r_cols : r_cols + w] = x
        return out
    if mode != "edge":
        raise ValueError(f"unknown pad mode: {mode!r}")
    ri = torch.arange(-r_rows, h + r_rows, device=x.device).clamp_(0, h - 1)
    ci = torch.arange(-r_cols, w + r_cols, device=x.device).clamp_(0, w - 1)
    return x.index_select(-2, ri).index_select(-1, ci)


def shifted_stack(
    x: torch.Tensor,
    offsets: List[Tuple[int, int]],
    pad_mode: str = "edge",
    constant_values=0,
) -> torch.Tensor:
    """Stack shifted views of ``x`` along a new leading axis.

    For each (dr, dc) in ``offsets`` the result holds x shifted so that entry
    [k, ..., r, c] == x_padded[..., r + dr + R, c + dc + C] where R, C are the
    max absolute offsets.
    """
    max_r = max(abs(dr) for dr, _ in offsets)
    max_c = max(abs(dc) for _, dc in offsets)
    xp = pad(x, max_r, max_c, pad_mode, constant_values)
    h, w = x.shape[-2], x.shape[-1]
    views = [
        xp[..., max_r + dr : max_r + dr + h, max_c + dc : max_c + dc + w]
        for dr, dc in offsets
    ]
    return torch.stack(views, dim=0)


def constant_shifted_views(x: torch.Tensor, offsets, fill=0):
    """Yield ``x`` shifted by each offset, ``out[i] = x[i + offset]``.

    An offset of k entries shifts the last k axes of ``x`` (2D or 3D);
    entries with no source inside ``x`` take ``fill``. The views share one
    padded copy.
    """
    k = len(offsets[0])
    grid = x.shape[-k:]
    radii = [max(abs(o[a]) for o in offsets) for a in range(k)]
    xp = x.new_full((*x.shape[:-k], *(n + 2 * r for n, r in zip(grid, radii))), fill)
    xp[(Ellipsis, *(slice(r, r + n) for n, r in zip(grid, radii)))] = x
    for off in offsets:
        yield xp[(Ellipsis, *(slice(r + d, r + d + n) for n, r, d in zip(grid, radii, off)))]


def window_offsets(size: int) -> List[Tuple[int, int]]:
    """All (dr, dc) offsets of a size x size window centered at 0."""
    r = size // 2
    return [(dr, dc) for dr in range(-r, size - r) for dc in range(-r, size - r)]


def footprint_offsets(size: int, shape: str) -> List[Tuple[int, int]]:
    """Offsets of a structuring element.

    shape: 'box' (full window), 'cross' (city-block radius size//2, the
    4-connected element for size 3), or 'disk' (euclidean radius size/2).
    """
    r = size // 2
    offs = []
    for dr in range(-r, r + 1):
        for dc in range(-r, r + 1):
            if shape == "box":
                offs.append((dr, dc))
            elif shape == "cross":
                if abs(dr) + abs(dc) <= r:
                    offs.append((dr, dc))
            elif shape == "disk":
                if dr * dr + dc * dc <= (size / 2.0) ** 2:
                    offs.append((dr, dc))
            else:
                raise ValueError(f"unknown footprint shape: {shape}")
    return offs
