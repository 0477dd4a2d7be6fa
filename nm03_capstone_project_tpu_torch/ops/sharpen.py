"""Unsharp-mask sharpening.

Equivalent of FAST ``ImageSharpening::create(2.0f, 0.5f, 9)`` (reference
src/test/test_pipeline.cpp:71): gaussian blur (sigma, odd kernel size)
followed by the unsharp update

    out = x + gain * (x - blur(x))

The blur is a separable pair of shifted-add sweeps in the JAX package's tap
order: for each axis, ``acc = k[0] * shift_0(x)``, then ``acc = acc + k[i] *
shift_i(x)``. Boundary handling is clamp-to-edge.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.ops.neighborhood import pad


@functools.lru_cache(maxsize=None)
def gaussian_kernel_1d(sigma: float, size: int) -> np.ndarray:
    """Normalized 1D gaussian taps: computed in float64, stored as float32."""
    if size % 2 != 1:
        raise ValueError(f"kernel size must be odd, got {size}")
    r = size // 2
    # nm03-lint: disable=NM341 deliberate: taps are computed once on the host at full precision, then cast; the f32 cast below is the pipeline boundary
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x: torch.Tensor, sigma: float, size: int) -> torch.Tensor:
    """Separable gaussian blur over the last two axes, clamp-to-edge."""
    # float(np.float32) is exact, and a float32 tensor times a Python float
    # multiplies in float32: each term is the float32 product
    taps = [float(v) for v in gaussian_kernel_1d(sigma, size)]
    r = size // 2
    h, w = x.shape[-2], x.shape[-1]
    xp = pad(x, r, 0, "edge")
    acc = None
    for i in range(size):
        term = taps[i] * xp[..., i : i + h, :]
        acc = term if acc is None else acc + term
    xp = pad(acc, 0, r, "edge")
    acc = None
    for i in range(size):
        term = taps[i] * xp[..., :, i : i + w]
        acc = term if acc is None else acc + term
    return acc


def sharpen(
    x: torch.Tensor, gain: float = 2.0, sigma: float = 0.5, size: int = 9
) -> torch.Tensor:
    """Unsharp mask with the reference's default (gain=2, sigma=0.5, size=9)."""
    return x + gain * (x - gaussian_blur(x, sigma, size))
