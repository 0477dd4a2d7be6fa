"""Device rendering: letterboxed grayscale + segmentation overlay, in torch.

The port of the JAX package's ``render/render.py``: the reference's export
render stack, ``RenderToImage::create(Color::Black(), 512, 512)``
(test_pipeline.cpp:164, main_sequential.cpp:258) with an ``ImageRenderer``
for the original and a ``SegmentationRenderer`` (label 1 = white, fill
opacity 0.6, border opacity 1.0, border radius 2; test_pipeline.cpp:136-146)
for the mask. It serves ``--render-stage device`` and the test-pipeline
driver; the batch drivers' default renders on the host
(:mod:`.host_render`).

Geometry: the slice is scaled (bilinear for grayscale, nearest for masks) by
``min(out/h, out/w)`` and centered on a black canvas. The letterbox is
axis-aligned, so the source coordinate of an output pixel separates into a
per-row and a per-column coordinate.

The JAX package resamples with two f32 matmuls on a TPU and with a
separable two-stage gather elsewhere; the port takes the gather (rows, then
columns), the form the JAX package runs on the CPU and the host renderer
mirrors. Every step is its own op: the lerp is a multiply and an add, never
``torch.lerp`` or ``addcmul``, which could round once as a fused
multiply-add. So the card's render equals the host renderer bit for bit,
and the JAX render wherever XLA does not contract the lerp. Quotients take
two tensors (a Python scalar over a tensor is a reciprocal times the
scalar in torch, which rounds differently).

Every function takes one slice ((H, W) pixels, (2,) dims) or a batch
((B, H, W), (B, 2)).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.core.image import valid_mask
from nm03_capstone_project_tpu_torch.ops.neighborhood import footprint_offsets

_BIG = 3.4e38


def _batched(x: torch.Tensor, dims: torch.Tensor):
    """``(x, dims, squeeze)``: a leading batch axis added to one slice."""
    if dims.dim() == 1:
        return x.unsqueeze(0), dims.unsqueeze(0), True
    return x, dims, False


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _letterbox_coords(dims: torch.Tensor, out_size: int):
    """Per-slice source coords for each output row/col, plus in-bounds mask.

    ``dims`` is (B, 2). Returns (src_y, src_x, inside): (B, out) float32
    source coordinates of the rows and columns, and the (B, out, out) bool
    mask of output pixels inside the scaled slice.
    """
    h = dims[:, 0].to(torch.float32)
    w = dims[:, 1].to(torch.float32)
    out_f = _f32(out_size, h)
    scale = torch.minimum(out_f / h, out_f / w)
    dest_h = h * scale
    dest_w = w * scale
    off_y = (out_f - dest_h) / _f32(2.0, h)
    off_x = (out_f - dest_w) / _f32(2.0, h)
    o = torch.arange(out_size, dtype=torch.float32, device=dims.device)
    sc = scale[:, None]
    src_y = (o - off_y[:, None] + 0.5) / sc - 0.5
    src_x = (o - off_x[:, None] + 0.5) / sc - 0.5
    inside_y = (o >= torch.floor(off_y)[:, None]) & (o < torch.ceil(off_y + dest_h)[:, None])
    inside_x = (o >= torch.floor(off_x)[:, None]) & (o < torch.ceil(off_x + dest_w)[:, None])
    inside = inside_y[:, :, None] & inside_x[:, None, :]
    return src_y, src_x, inside


def _gather_rows(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``img[b, idx[b, i], :]`` for (B, H, W) img and (B, n) idx -> (B, n, W)."""
    return torch.gather(img, 1, idx[:, :, None].expand(-1, -1, img.shape[-1]))


def _gather_cols(img: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``img[b, :, idx[b, j]]`` for (B, R, W) img and (B, n) idx -> (B, R, n)."""
    return torch.gather(img, 2, idx[:, None, :].expand(-1, img.shape[1], -1))


def _sample_bilinear(img: torch.Tensor, src_y, src_x, dims) -> torch.Tensor:
    """Separable two-stage gather: lerp rows first, then columns."""
    h = dims[:, 0:1].long()
    w = dims[:, 1:2].long()
    y0 = torch.minimum(torch.clamp(torch.floor(src_y).long(), min=0), h - 1)
    y1 = torch.minimum(torch.clamp(y0 + 1, min=0), h - 1)
    fy = torch.clamp(src_y - y0.to(torch.float32), 0.0, 1.0)[:, :, None]
    x0 = torch.minimum(torch.clamp(torch.floor(src_x).long(), min=0), w - 1)
    x1 = torch.minimum(torch.clamp(x0 + 1, min=0), w - 1)
    fx = torch.clamp(src_x - x0.to(torch.float32), 0.0, 1.0)[:, None, :]
    rows = _gather_rows(img, y0) * (1 - fy) + _gather_rows(img, y1) * fy
    return _gather_cols(rows, x0) * (1 - fx) + _gather_cols(rows, x1) * fx


def _sample_nearest(img: torch.Tensor, src_y, src_x, dims) -> torch.Tensor:
    """Round-to-nearest (half to even, as jnp.round), clamp-to-edge."""
    h = dims[:, 0:1].long()
    w = dims[:, 1:2].long()
    yy = torch.minimum(torch.clamp(torch.round(src_y).long(), min=0), h - 1)
    xx = torch.minimum(torch.clamp(torch.round(src_x).long(), min=0), w - 1)
    return _gather_cols(_gather_rows(img, yy), xx)


def _gray(pixels, dims, src_y, src_x, inside) -> torch.Tensor:
    """The grayscale leg, shared by :func:`render_gray` and the fused pair."""
    pixels = pixels.to(torch.float32)
    vmask = valid_mask(dims, tuple(pixels.shape[-2:]))
    big = _f32(_BIG, pixels)
    vmin = torch.where(vmask, pixels, big).amin(dim=(-2, -1))[:, None, None]
    vmax = torch.where(vmask, pixels, -big).amax(dim=(-2, -1))[:, None, None]
    rng = torch.clamp(vmax - vmin, min=1e-6)
    sampled = _sample_bilinear(pixels, src_y, src_x, dims)
    gray = (sampled - vmin) / rng * 255.0
    gray = torch.where(inside, gray, _f32(0.0, gray))
    return torch.clamp(gray, 0, 255).to(torch.uint8)


def _erode_disk(m: torch.Tensor, size: int) -> torch.Tensor:
    """Binary erosion of (B, H, W) bool by the disk element, background
    border: an AND over the element's shifted views (the JAX package's
    ``erode(m, size, "disk")``, as :mod:`.host_render` folds it too)."""
    r = size // 2
    h, w = m.shape[-2:]
    padded = torch.zeros((*m.shape[:-2], h + 2 * r, w + 2 * r), dtype=torch.bool,
                         device=m.device)
    padded[..., r : r + h, r : r + w] = m
    out = None
    for dr, dc in footprint_offsets(size, "disk"):
        view = padded[..., r + dr : r + dr + h, r + dc : r + dc + w]
        out = view if out is None else out & view
    return out


def _label_bands(mask, dims, src_y, src_x, inside, border_radius: int):
    """(label, border): the resampled label and its border band."""
    m = _sample_nearest((mask > 0).to(torch.uint8), src_y, src_x, dims)
    m = (m > 0) & inside
    interior = _erode_disk(m, 2 * border_radius + 1)
    return m, m & ~interior


def render_gray(pixels: torch.Tensor, dims: torch.Tensor, out_size: int = 512) -> torch.Tensor:
    """Letterboxed window-normalized grayscale render -> uint8 (out, out).

    Intensities are windowed to the slice's own [min, max] over its true
    extent (FAST's renderer auto-windows), scaled to 0..255 on black.
    """
    px, dm, squeeze = _batched(pixels, dims)
    src_y, src_x, inside = _letterbox_coords(dm, out_size)
    out = _gray(px, dm, src_y, src_x, inside)
    return out[0] if squeeze else out


def _mask_alpha(mask, dims, out_size, opacity, border_opacity, border_radius):
    """Per-pixel overlay alpha in render space: fill opacity inside the
    label, border opacity on the ``border_radius``-pixel boundary band."""
    src_y, src_x, inside = _letterbox_coords(dims, out_size)
    m, border = _label_bands(mask, dims, src_y, src_x, inside, border_radius)
    zero = torch.zeros((), dtype=torch.float32, device=m.device)
    return torch.where(
        border, _f32(border_opacity, m), torch.where(m, _f32(opacity, m), zero)
    )


def render_segmentation(
    mask: torch.Tensor,
    dims: torch.Tensor,
    out_size: int = 512,
    opacity: float = 0.6,
    border_opacity: float = 1.0,
    border_radius: int = 2,
) -> torch.Tensor:
    """Letterboxed white-on-black label render -> uint8 (out, out).

    SegmentationRenderer::create({1: White}, 0.6, 1.0, 2) rendered alone
    (the batch drivers' ``_processed`` export, main_sequential.cpp:66-73).
    """
    mk, dm, squeeze = _batched(mask, dims)
    alpha = _mask_alpha(mk, dm, out_size, opacity, border_opacity, border_radius)
    out = torch.clamp(alpha * 255.0, 0, 255).to(torch.uint8)
    return out[0] if squeeze else out


def render_overlay(
    pixels: torch.Tensor,
    mask: torch.Tensor,
    dims: torch.Tensor,
    out_size: int = 512,
    opacity: float = 0.6,
    border_opacity: float = 1.0,
    border_radius: int = 2,
) -> torch.Tensor:
    """Grayscale render with the white label composited on top -> uint8."""
    px, dm, squeeze = _batched(pixels, dims)
    mk = mask.unsqueeze(0) if squeeze else mask
    gray = render_gray(px, dm, out_size).to(torch.float32)
    alpha = _mask_alpha(mk, dm, out_size, opacity, border_opacity, border_radius)
    out = gray * (1.0 - alpha) + 255.0 * alpha
    out = torch.clamp(out, 0, 255).to(torch.uint8)
    return out[0] if squeeze else out


def _opacity_u8(opacity: float) -> int:
    """The uint8 level ``clip(opacity * 255, 0, 255)`` truncates to, in f32
    (0.6 -> 153), so the fused integer leg equals the f32 alpha path."""
    v = np.float32(opacity) * np.float32(255.0)
    return int(np.clip(v, np.float32(0.0), np.float32(255.0)))


def render_pair_fused(
    pixels: torch.Tensor, mask: torch.Tensor, dims: torch.Tensor, cfg
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both export renders sharing one letterbox geometry; the segmentation
    leg stays integer (a select between the three uint8 levels of
    :func:`_opacity_u8`). Pixel-identical to the two separate renders."""
    px, dm, squeeze = _batched(pixels, dims)
    mk = mask.unsqueeze(0) if squeeze else mask
    src_y, src_x, inside = _letterbox_coords(dm, cfg.render_size)
    gray = _gray(px, dm, src_y, src_x, inside)
    m, border = _label_bands(mk, dm, src_y, src_x, inside, cfg.overlay_border_radius)
    fill = torch.tensor(_opacity_u8(cfg.overlay_opacity), dtype=torch.uint8, device=m.device)
    edge = torch.tensor(
        _opacity_u8(cfg.overlay_border_opacity), dtype=torch.uint8, device=m.device
    )
    seg = torch.where(border, edge, torch.where(m, fill, torch.zeros_like(fill)))
    return (gray[0], seg[0]) if squeeze else (gray, seg)


def render_pair(
    pixels: torch.Tensor, mask: torch.Tensor, dims: torch.Tensor, cfg
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grayscale render, segmentation render) per ``cfg``: the batch
    drivers' export contract (one ``_original`` and one ``_processed``
    image per slice, main_sequential.cpp:61-73). ``cfg.render_fused``
    (default True) takes :func:`render_pair_fused`; False the two separate
    renders."""
    if getattr(cfg, "render_fused", True):
        return render_pair_fused(pixels, mask, dims, cfg)
    gray = render_gray(pixels, dims, cfg.render_size)
    seg = render_segmentation(
        mask, dims, cfg.render_size, cfg.overlay_opacity,
        cfg.overlay_border_opacity, cfg.overlay_border_radius,
    )
    return gray, seg
