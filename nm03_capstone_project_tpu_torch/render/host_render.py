"""Host-side rendering: the batch drivers' export renderer.

The port's copy of the JAX package's ``render/host_render.py``. Same
contract as :mod:`nm03_capstone_project_tpu_torch.render.render` — FAST's
``RenderToImage(Color::Black(), 512, 512)`` + ``ImageRenderer`` /
``SegmentationRenderer({1: White}, 0.6, 1.0, 2)`` export stack
(reference src/sequential/main_sequential.cpp:49-78) — implemented in NumPy
for the host.

Why a second implementation exists: the device renderer produces two
512x512 canvases per slice, ~0.5 MB that must cross back to the host per
slice just to be JPEG-encoded. Rendering is O(out^2) arithmetic on data the
host already holds (the decoded pixels never needed to come back, and the
mask is 65 KB), so by default the batch drivers fetch ONLY the mask and
render here, overlapped with the next batch's device compute in the IO
pool. ``--render-stage device`` renders on the card instead
(:mod:`.render`, which the test-pipeline driver uses too).

The math mirrors the device renderer's gather formulation line for line
(same f32 separable rows-then-columns lerp with separate multiplies and
adds, same nearest selection, same erosion-based border band), so the two
agree bit for bit. Sequential and parallel drivers share THIS path, so their outputs
stay bit-identical to each other — the invariant the reference can only
check by diffing output directories (README.md:60-66).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from nm03_capstone_project_tpu_torch.ops.neighborhood import footprint_offsets

_F32 = np.float32


def _letterbox_coords(dims: np.ndarray, out_size: int):
    """NumPy mirror of render._letterbox_coords (same f32 arithmetic)."""
    h = _F32(dims[0])
    w = _F32(dims[1])
    scale = min(_F32(out_size) / h, _F32(out_size) / w)
    dest_h = h * scale
    dest_w = w * scale
    off_y = (_F32(out_size) - dest_h) / _F32(2)
    off_x = (_F32(out_size) - dest_w) / _F32(2)
    o = np.arange(out_size, dtype=np.float32)
    src_y = (o - off_y + _F32(0.5)) / scale - _F32(0.5)
    src_x = (o - off_x + _F32(0.5)) / scale - _F32(0.5)
    inside_y = (o >= np.floor(off_y)) & (o < np.ceil(off_y + dest_h))
    inside_x = (o >= np.floor(off_x)) & (o < np.ceil(off_x + dest_w))
    inside = inside_y[:, None] & inside_x[None, :]
    return src_y, src_x, inside


def _sample_bilinear(img, src_y, src_x, dims):
    h, w = int(dims[0]), int(dims[1])
    y0 = np.clip(np.floor(src_y).astype(np.int32), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    fy = np.clip(src_y - y0.astype(np.float32), 0.0, 1.0)[:, None]
    x0 = np.clip(np.floor(src_x).astype(np.int32), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fx = np.clip(src_x - x0.astype(np.float32), 0.0, 1.0)[None, :]
    rows = img[y0, :] * (1 - fy) + img[y1, :] * fy
    return rows[:, x0] * (1 - fx) + rows[:, x1] * fx


def _sample_nearest(img, src_y, src_x, dims):
    h, w = int(dims[0]), int(dims[1])
    yy = np.clip(np.round(src_y).astype(np.int32), 0, h - 1)
    xx = np.clip(np.round(src_x).astype(np.int32), 0, w - 1)
    return img[yy, :][:, xx]


def _erode_disk(m: np.ndarray, size: int) -> np.ndarray:
    """Binary erosion, disk element, background padding (ops.morphology)."""
    out = np.ones_like(m)
    h, w = m.shape
    padded = np.zeros((h + size, w + size), m.dtype)
    r = size // 2
    padded[r : r + h, r : r + w] = m
    for dr, dc in footprint_offsets(size, "disk"):
        out &= padded[r + dr : r + dr + h, r + dc : r + dc + w]
    return out


def host_render_gray(
    pixels: np.ndarray, dims: np.ndarray, out_size: int = 512
) -> np.ndarray:
    """NumPy mirror of render.render_gray: letterboxed auto-windowed uint8."""
    pixels = np.asarray(pixels, np.float32)
    h, w = int(dims[0]), int(dims[1])
    region = pixels[:h, :w]
    vmin = np.float32(region.min())
    rng = np.maximum(np.float32(region.max()) - vmin, np.float32(1e-6))
    src_y, src_x, inside = _letterbox_coords(dims, out_size)
    sampled = _sample_bilinear(pixels, src_y, src_x, dims)
    gray = (sampled - vmin) / rng * np.float32(255.0)
    gray = np.where(inside, gray, np.float32(0.0))
    return np.clip(gray, 0, 255).astype(np.uint8)


def host_render_segmentation(
    mask: np.ndarray,
    dims: np.ndarray,
    out_size: int = 512,
    opacity: float = 0.6,
    border_opacity: float = 1.0,
    border_radius: int = 2,
) -> np.ndarray:
    """NumPy mirror of render.render_segmentation (bit-identical output)."""
    src_y, src_x, inside = _letterbox_coords(dims, out_size)
    m = _sample_nearest((np.asarray(mask) > 0).astype(np.uint8), src_y, src_x, dims)
    m = (m > 0) & inside
    interior = _erode_disk(m, 2 * border_radius + 1)
    border = m & ~interior
    alpha = np.where(
        border, np.float32(border_opacity), np.where(m, np.float32(opacity), np.float32(0))
    )
    return np.clip(alpha * np.float32(255.0), 0, 255).astype(np.uint8)


def host_render_pair(
    pixels: np.ndarray, mask: np.ndarray, dims: np.ndarray, cfg
) -> Tuple[np.ndarray, np.ndarray]:
    """(grayscale render, segmentation render), host-side, per ``cfg``.

    Drop-in counterpart of render.render_pair for the batch-export contract
    (one `_original` + one `_processed` image per slice,
    main_sequential.cpp:61-73).
    """
    gray = host_render_gray(pixels, dims, cfg.render_size)
    seg = host_render_segmentation(
        mask,
        dims,
        cfg.render_size,
        cfg.overlay_opacity,
        cfg.overlay_border_opacity,
        cfg.overlay_border_radius,
    )
    return gray, seg
