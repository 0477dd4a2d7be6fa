"""Elementwise intensity ops.

Each runs as separate PyTorch ops, so every intermediate is rounded to
float32 (no fused multiply-add): the CUDA kernels mirror exactly that
order with ``__fmul_rn``/``__fadd_rn``.
"""

from __future__ import annotations

import torch


def normalize(
    x: torch.Tensor,
    low: float = 0.5,
    high: float = 2.5,
    intensity_min: float = 0.0,
    intensity_max: float = 10000.0,
) -> torch.Tensor:
    """Linear intensity rescale from [intensity_min, intensity_max] to [low, high].

    Equivalent of FAST ``IntensityNormalization::create(0.5f, 2.5f, 0.0f,
    10000.0f)`` (reference src/test/test_pipeline.cpp:55). Values outside the
    source window extrapolate linearly; clamping is :func:`clip_intensity`'s
    job. ``scale`` is computed in double and used as float32, as the JAX
    package's weak-typed constant is.
    """
    scale = (high - low) / (intensity_max - intensity_min)
    return (x - intensity_min) * scale + low


def clip_intensity(x: torch.Tensor, low: float = 0.68, high: float = 4000.0) -> torch.Tensor:
    """Clamp intensities to [low, high].

    Equivalent of FAST ``IntensityClipping::create(0.68f, 4000.0f)``
    (reference src/test/test_pipeline.cpp:60).
    """
    return torch.clamp(x, low, high)


def cast_uint8(x: torch.Tensor) -> torch.Tensor:
    """Cast to uint8 (FAST ``ImageCaster::create(TYPE_UINT8)``)."""
    return x.to(torch.uint8)


def binary_threshold(x: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """1 where low <= x <= high else 0 (uint8).

    FAST ``BinaryThresholding`` (declared in the reference's API surface,
    FAST_directives.hpp:13, never instantiated).
    """
    return ((x >= low) & (x <= high)).to(torch.uint8)
