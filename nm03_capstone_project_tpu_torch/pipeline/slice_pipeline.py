"""The 2D slice pipeline.

The JAX package composes the operator chain as one jitted function and
vmaps it over a padded slice stack; here every op takes the batch
dimension as it comes (``(..., H, W)`` pixels with ``(..., 2)`` true dims),
PyTorch runs the ops eagerly, and the hot stages launch the hand-written
Hopper kernels on the GPU (``cfg.use_kernels``):

* preprocess: the fused normalize -> clip -> median -> sharpen kernel, or,
  with ``fuse_preprocess=False``, the standalone median kernel between the
  plain elementwise and sharpen ops;
* segment: the region-growing kernel.

Two variants mirror the reference's drivers:

* :func:`process_slice` / :func:`process_batch` — the batch contract
  (main_sequential.cpp:170-272, main_parallel.cpp:66-170): preprocess,
  region-grow, uint8 cast, dilation only.
* :func:`process_slice_stages` — the test-pipeline contract
  (src/test/test_pipeline.cpp:53-125): every intermediate stage, with
  erosion and dilation as parallel branches off the caster.

The entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU and no explicit CPU request they raise.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from nm03_capstone_project_tpu_torch.core.backend import resolve_device
from nm03_capstone_project_tpu_torch.core.image import valid_mask
from nm03_capstone_project_tpu_torch.ops.elementwise import (
    cast_uint8,
    clip_intensity,
    normalize,
)
from nm03_capstone_project_tpu_torch.ops.hopper_median import fused_preprocess, median_filter
from nm03_capstone_project_tpu_torch.ops.hopper_region_growing import grow_dispatch
from nm03_capstone_project_tpu_torch.ops.morphology import dilate, erode
from nm03_capstone_project_tpu_torch.ops.neighborhood import extend_edges
from nm03_capstone_project_tpu_torch.ops.seeds import seed_mask
from nm03_capstone_project_tpu_torch.ops.sharpen import sharpen


def _inputs(pixels, dims, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixels (float32) and dims (int32) as tensors on the resolved device."""
    dev = resolve_device(device)
    px = torch.as_tensor(pixels, dtype=torch.float32, device=dev)
    dm = torch.as_tensor(dims, dtype=torch.int32, device=dev)
    return px, dm


def _preprocess(px: torch.Tensor, dm: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    x = extend_edges(px, dm)
    if cfg.fuse_preprocess:
        return fused_preprocess(
            x,
            use_kernels=cfg.use_kernels,
            norm_low=cfg.norm_low,
            norm_high=cfg.norm_high,
            norm_min=cfg.norm_intensity_min,
            norm_max=cfg.norm_intensity_max,
            clip_low=cfg.clip_low,
            clip_high=cfg.clip_high,
            median_window=cfg.median_window,
            sharpen_gain=cfg.sharpen_gain,
            sharpen_sigma=cfg.sharpen_sigma,
            sharpen_kernel=cfg.sharpen_kernel,
        )
    x = normalize(
        x, cfg.norm_low, cfg.norm_high, cfg.norm_intensity_min, cfg.norm_intensity_max
    )
    x = clip_intensity(x, cfg.clip_low, cfg.clip_high)
    x = median_filter(x, cfg.median_window, use_kernels=cfg.use_kernels)
    return sharpen(x, cfg.sharpen_gain, cfg.sharpen_sigma, cfg.sharpen_kernel)


def _segment(
    pre: torch.Tensor, dm: torch.Tensor, cfg: PipelineConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    canvas_hw = tuple(pre.shape[-2:])
    return grow_dispatch(
        pre,
        seed_mask(dm, canvas_hw),
        cfg.grow_low,
        cfg.grow_high,
        valid=valid_mask(dm, canvas_hw),
        block_iters=cfg.grow_block_iters,
        max_iters=cfg.grow_max_iters,
        use_kernels=cfg.use_kernels,
        algorithm=cfg.grow_algorithm,
    )


def preprocess(pixels, dims, cfg: PipelineConfig = DEFAULT_CONFIG, device=None) -> torch.Tensor:
    """Normalize -> clip -> vector median -> sharpen (the preprocessing stage).

    ``pixels`` is (..., H, W) on the canvas; ``dims`` the true (..., 2)
    (h, w). The slice's true edge is replicated into the canvas padding
    first, so the stencils see clamp-to-edge boundaries.
    """
    px, dm = _inputs(pixels, dims, device)
    return _preprocess(px, dm, cfg)


def segment(
    preprocessed, dims, cfg: PipelineConfig = DEFAULT_CONFIG, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Seeded region growing with the adaptive seed grid.

    Returns ``(mask, converged)``: the uint8 {0,1} mask and a bool per slice
    that is False when the fixpoint hit its iteration cap.
    """
    pre, dm = _inputs(preprocessed, dims, device)
    return _segment(pre, dm, cfg)


def _process(px: torch.Tensor, dm: torch.Tensor, cfg: PipelineConfig) -> Dict[str, torch.Tensor]:
    seg, converged = _segment(_preprocess(px, dm, cfg), dm, cfg)
    mask = dilate(cast_uint8(seg), cfg.morph_size)
    # dilation must not spill into the canvas padding — the reference's
    # Dilation runs on the exact-size image and can never write there
    mask = mask * valid_mask(dm, tuple(px.shape[-2:])).to(mask.dtype)
    return {"original": px, "mask": mask, "grow_converged": converged}


def process_slice(
    pixels, dims, cfg: PipelineConfig = DEFAULT_CONFIG, device=None
) -> Dict[str, torch.Tensor]:
    """Full batch-driver pipeline for one (H, W) slice with (2,) dims.

    Returns {'original', 'mask', 'grow_converged'}: the input pixels, the
    final uint8 mask after dilation, and a 0-d bool (False = the growing cap
    truncated this slice's mask).
    """
    px, dm = _inputs(pixels, dims, device)
    if px.dim() != 2 or tuple(dm.shape) != (2,):
        raise ValueError(
            f"process_slice takes (H, W) pixels and (2,) dims, got "
            f"{tuple(px.shape)} and {tuple(dm.shape)}"
        )
    return _process(px, dm, cfg)


def process_batch(
    pixels, dims, cfg: PipelineConfig = DEFAULT_CONFIG, device=None
) -> Dict[str, torch.Tensor]:
    """:func:`process_slice` over a (B, H, W) stack with (B, 2) dims.

    ``mask`` is uint8 (B, H, W) and ``grow_converged`` bool (B,), as the
    JAX package's vmapped ``process_batch`` returns them.
    """
    px, dm = _inputs(pixels, dims, device)
    if px.dim() != 3 or tuple(dm.shape) != (px.shape[0], 2):
        raise ValueError(
            f"process_batch takes (B, H, W) pixels and (B, 2) dims, got "
            f"{tuple(px.shape)} and {tuple(dm.shape)}"
        )
    return _process(px, dm, cfg)


def process_slice_stages(
    pixels, dims, cfg: PipelineConfig = DEFAULT_CONFIG, device=None
) -> Dict[str, torch.Tensor]:
    """Test-pipeline variant: every intermediate stage, erosion branch included.

    Mirrors src/test/test_pipeline.cpp:53-125: erosion and dilation both
    branch off the caster output. Keys match the export names of the
    reference's test driver (test_pipeline.cpp:167-177). Takes one slice or
    a batch.
    """
    px, dm = _inputs(pixels, dims, device)
    pre = _preprocess(px, dm, cfg)
    seg, converged = _segment(pre, dm, cfg)
    cast = cast_uint8(seg)
    valid = valid_mask(dm, tuple(px.shape[-2:]))
    dilated = dilate(cast, cfg.morph_size) * valid.to(torch.uint8)
    return {
        "original_image": px,
        "preprocessed_image": pre,
        "segmentation": cast,
        "erosion_result": erode(cast, cfg.morph_size),
        "final_dilated_result": dilated,
        "grow_converged": converged,
    }


def check_min_dims(dims, min_dim: int = DEFAULT_CONFIG.min_dim):
    """Host-side guard mirroring main_sequential.cpp:189-192.

    Returns a bool numpy array of the slices that pass the reference's
    minimum dimension check; callers skip failures and count them.
    """
    if isinstance(dims, torch.Tensor):
        dims = dims.cpu().numpy()
    d = np.asarray(dims)
    return (d[..., 0] >= min_dim) & (d[..., 1] >= min_dim)
