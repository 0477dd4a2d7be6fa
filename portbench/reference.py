"""The plain reference of the segmentation chain, in PyTorch.

Written from the reference's operator chain (FAST: IntensityNormalization,
IntensityClipping, VectorMedianFilter, ImageSharpening,
SeededRegionGrowing, ImageCaster, Dilation) and imports nothing of the
program. It takes the raw pixels and true sizes the benchmark made and
works out everything else again: edge replication into the canvas
padding, seeds, valid masks, the Gaussian taps.

Every step rounds as separate float32 operations do, so on finite data
it gives the same bits as any exact implementation of the chain: the
median is a library median of the clamped window, the blur two passes of
taps summed in order, the growth the fixpoint of masked dilation on the
reference's block schedule (one unconditional block, then blocks while the
popcount changes, up to a cap).

``dtype`` is the precision of the intensity stages (normalize, clip,
median, sharpen, the band's compares). ``torch.bfloat16`` gives the
control: the same chain one precision below the configuration's float32.

Planes go through the intensity stages in blocks (``block_planes``), so
the median's unfolded windows fit beside whatever else holds the device.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def extend_edges(x: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """x[..., min(r, h - 1), min(c, w - 1)]: each slice's true edge
    replicated into the canvas padding."""
    hh, ww = x.shape[-2:]
    rows = torch.arange(hh, device=x.device).view(hh, 1)
    cols = torch.arange(ww, device=x.device).view(1, ww)
    h = dims[..., 0].long().view(-1, 1, 1)
    w = dims[..., 1].long().view(-1, 1, 1)
    ri = torch.minimum(rows, h - 1).expand(-1, hh, ww)
    ci = torch.minimum(cols, w - 1).expand(-1, hh, ww)
    flat = x.reshape(x.shape[0], hh * ww)
    return torch.gather(flat, 1, (ri * ww + ci).reshape(x.shape[0], -1)).view_as(x)


def _edge_pad(x: torch.Tensor, rr: int, rc: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    ri = torch.arange(-rr, h + rr, device=x.device).clamp(0, h - 1)
    ci = torch.arange(-rc, w + rc, device=x.device).clamp(0, w - 1)
    return x.index_select(-2, ri).index_select(-1, ci)


def median(x: torch.Tensor, k: int) -> torch.Tensor:
    """The k x k median with clamp-to-edge borders (a library median of
    each window's k * k values)."""
    r = k // 2
    win = _edge_pad(x, r, r).unfold(-2, k, 1).unfold(-2, k, 1)
    return win.reshape(*x.shape, k * k).median(dim=-1).values


def gaussian_taps(sigma: float, size: int) -> np.ndarray:
    """Normalized taps, computed in float64 and stored as float32."""
    xs = np.arange(-(size // 2), size // 2 + 1, dtype=np.float64)
    k = np.exp(-(xs ** 2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def sharpen(x: torch.Tensor, gain: float, sigma: float, size: int) -> torch.Tensor:
    """x + gain * (x - blur(x)); the blur a vertical then a horizontal
    pass, clamp-to-edge, ``acc = t0 * x0``, then ``acc = acc + ti * xi``."""
    taps = torch.from_numpy(gaussian_taps(sigma, size)).to(x.dtype).tolist()
    r, (h, w) = size // 2, x.shape[-2:]
    xp, acc = _edge_pad(x, r, 0), None
    for i, t in enumerate(taps):
        term = t * xp[..., i:i + h, :]
        acc = term if acc is None else acc + term
    xp, acc = _edge_pad(acc, 0, r), None
    for i, t in enumerate(taps):
        term = t * xp[..., :, i:i + w]
        acc = term if acc is None else acc + term
    return x + gain * (x - acc)


def intensity(px: torch.Tensor, dims: torch.Tensor, p: dict, dtype=torch.float32,
              block_planes: int = 16) -> torch.Tensor:
    """Normalize -> clip -> median -> sharpen of (B, H, W) canvas pixels
    with (B, 2) true sizes, in ``dtype``."""
    scale = (p["norm_high"] - p["norm_low"]) / (p["norm_intensity_max"] - p["norm_intensity_min"])
    out = []
    for b0 in range(0, px.shape[0], block_planes):
        x = extend_edges(px[b0:b0 + block_planes], dims[b0:b0 + block_planes]).to(dtype)
        x = (x - p["norm_intensity_min"]) * scale + p["norm_low"]
        x = torch.clamp(x, p["clip_low"], p["clip_high"])
        x = median(x, p["median_window"])
        out.append(sharpen(x, p["sharpen_gain"], p["sharpen_sigma"], p["sharpen_kernel"]))
    return torch.cat(out)


def seeds_and_valid(dims: torch.Tensor, canvas: Tuple[int, int]):
    """The reference's adaptive seeds and the valid mask, (B, H, W) bool:
    the centre, four seeds an eighth of the size off it, and a grid over
    the central half in steps of a tenth, all in C++ integer arithmetic."""
    hh, ww = canvas
    rows = torch.arange(hh, device=dims.device).view(1, hh, 1)
    cols = torch.arange(ww, device=dims.device).view(1, 1, ww)
    h = dims[:, 0].long().view(-1, 1, 1)
    w = dims[:, 1].long().view(-1, 1, 1)
    cx, cy, ox, oy = w // 2, h // 2, w // 8, h // 8
    at = lambda r, c: (rows == r) & (cols == c)  # noqa: E731
    fixed = at(cy, cx) | at(cy, cx + ox) | at(cy, cx - ox) | at(cy + oy, cx) | at(cy - oy, cx)
    sx, sy = (w // 10).clamp(min=1), (h // 10).clamp(min=1)
    x0, y0 = w // 4, h // 4
    grid = ((cols >= x0) & (cols < (3 * w) // 4) & ((cols - x0) % sx == 0)
            & (rows >= y0) & (rows < (3 * h) // 4) & ((rows - y0) % sy == 0))
    valid = (rows < h) & (cols < w)
    return (fixed | grid) & valid, valid


def _dilate(m: torch.Tensor, axes) -> torch.Tensor:
    """OR of ``m`` with its neighbours one step along each of ``axes``;
    outside the grid counts as background."""
    out = m.clone()
    for ax in axes:
        n = m.shape[ax]
        out.narrow(ax, 1, n - 1).logical_or_(m.narrow(ax, 0, n - 1))
        out.narrow(ax, 0, n - 1).logical_or_(m.narrow(ax, 1, n - 1))
    return out


def grow(img: torch.Tensor, seeds: torch.Tensor, valid: torch.Tensor, p: dict,
         axes, per: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded growth in the band [grow_low, grow_high] along ``axes``
    (4-connected in 2D, 6-connected in 3D), on the block schedule.
    ``per``: the axes one popcount (and one converged flag) sums over."""
    low = float(np.float32(p["grow_low"]))
    high = float(np.float32(p["grow_high"]))
    band = (img >= low) & (img <= high) & valid
    block, cap = p["grow_block_iters"], p["grow_max_iters"]

    def run_block(r):
        for _ in range(block):
            r = _dilate(r, axes) & band
        return r

    region0 = seeds & band
    region = run_block(region0)
    prev, count, iters = region0.sum(per), region.sum(per), block
    while bool((count != prev).any()) and iters < cap:
        region = run_block(region)
        prev, count = count, region.sum(per)
        iters += block
    return region, count == prev


def process_batch(px: torch.Tensor, dims: torch.Tensor, p: dict,
                  dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A (B, H, W) stack of slices: each slice grown on its own (one
    converged flag a slice), its mask dilated by the cross and cut to its
    true size. Returns uint8 ``mask`` (B, H, W) and bool ``grow_converged``
    (B,)."""
    canvas = tuple(px.shape[-2:])
    pre = intensity(px, dims, p, dtype)
    seeds, valid = seeds_and_valid(dims, canvas)
    region, converged = grow(pre, seeds, valid, p, axes=(1, 2), per=(1, 2))
    return {"mask": _finish(region, valid, p, axes=(1, 2)), "grow_converged": converged}


def process_volume(px: torch.Tensor, dims: torch.Tensor, p: dict,
                   dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """A (D, H, W) volume of one true size ``dims`` (2,): grown as one
    6-connected body (one converged flag), its mask dilated in 3D and cut
    to the true size of every plane."""
    d, canvas = px.shape[0], tuple(px.shape[-2:])
    plane_dims = dims.view(1, 2).expand(d, 2)
    pre = intensity(px, plane_dims, p, dtype)
    seeds, valid = seeds_and_valid(dims.view(1, 2), canvas)
    seeds, valid = seeds.expand(d, *canvas), valid.expand(d, *canvas)
    region, converged = grow(pre, seeds, valid, p, axes=(0, 1, 2), per=(0, 1, 2))
    return {"mask": _finish(region, valid, p, axes=(0, 1, 2)), "grow_converged": converged}


def _finish(region: torch.Tensor, valid: torch.Tensor, p: dict, axes) -> torch.Tensor:
    """The dilation (a cross of ``morph_size``: radius steps of the
    neighbour OR) cut to the valid mask, as uint8."""
    m = region
    for _ in range(p["morph_size"] // 2):
        m = _dilate(m, axes)
    return (m & valid).to(torch.uint8)
