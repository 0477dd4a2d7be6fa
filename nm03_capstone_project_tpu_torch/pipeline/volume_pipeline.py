"""The 3D volumetric pipeline.

The port of the JAX package's ``pipeline/volume_pipeline.py``: a patient's
series is stacked into a (D, H, W) volume, every plane is preprocessed as
the slice pipeline does it, and segmentation and morphology run with true
3D connectivity, so the lesion grows as one 6-connected body across
slices instead of D unrelated 2D islands.

The JAX package vmaps its per-slice ``preprocess`` over the stack; here the
batched :func:`.slice_pipeline._preprocess` takes the D planes as its batch,
so with ``cfg.use_kernels`` on the card a volume's preprocessing is ONE
launch of the fused preprocess kernel (or, with ``fuse_preprocess=False``,
one launch of the median kernel between the plain elementwise and sharpen
ops). The 3D growth on the dilate schedule is, with ``cfg.use_kernels`` on
the card, the hand-written kernel of :mod:`..ops.hopper_volume` (one
launch for the whole fixpoint, which reads nothing back to the host; the
JAX package has XLA ops there and no Pallas kernel), and on the CPU the
torch loop of :mod:`..ops.volume`; the jump
schedule is torch ops on either. The seed grid and valid plane, and the
final 3D dilation cut to the true size, are one launch each of the
kernels of :mod:`..ops.hopper_masks` on the card with ``cfg.use_kernels``,
torch ops elsewhere. The 2D grow kernel does not run here.

:func:`process_volume` runs on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request it raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from nm03_capstone_project_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from nm03_capstone_project_tpu_torch.ops.hopper_masks import finish_mask, seed_valid_masks
from nm03_capstone_project_tpu_torch.ops.hopper_volume import region_grow_3d_kernel
from nm03_capstone_project_tpu_torch.ops.volume import region_grow_3d, region_grow_jump_3d
from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import (
    _count,
    _inputs,
    _preprocess,
    _stage,
)


def volume_grow_inputs(
    px: torch.Tensor, dm: torch.Tensor, cfg: PipelineConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(preprocessed, seeds, valid)`` of one (D, H, W) volume with (2,) dims.

    The reference's adaptive seed grid (test_pipeline.cpp:79-106) is a pure
    function of (h, w): the same grid is planted on every plane, and 3D
    growth connects the planes through z. ``seeds`` and ``valid`` are
    (D, H, W) views of one plane's masks.
    """
    d = px.shape[-3]
    canvas_hw = tuple(px.shape[-2:])
    pre = _preprocess(px, dm.expand(d, 2), cfg)
    with _stage("seeds"):
        seeds, valid = seed_valid_masks(dm, canvas_hw, cfg.use_kernels)
    return pre, seeds.expand(d, *canvas_hw), valid.expand(d, *canvas_hw)


def grow_volume(pre, seeds, valid, cfg: PipelineConfig, return_steps: bool = False):
    """The 3D growth of :func:`process_volume` on its inputs, by schedule
    and device.

    ``dilate``: the 3D grow kernel
    (:func:`..ops.hopper_volume.region_grow_3d_kernel`) for a volume off the
    CPU with ``cfg.use_kernels``, as the 2D ``grow_dispatch`` picks, else
    the torch loop :func:`..ops.volume.region_grow_3d`; the same bits, the
    same schedule. ``jump`` (torch ops on any device) passes
    ``cfg.grow_max_iters`` to ``region_grow_jump_3d`` as its round cap
    unchanged, as the JAX package's ``process_volume`` does (unlike the 2D
    dispatch, which derives a log2 budget). With
    ``return_steps`` a third value holds the dilation steps or the jump
    rounds run (on the kernel a 0-d int32 tensor on the card, read by no
    one here), which the ``grow3d.steps`` counter records under
    :func:`.slice_pipeline.stage_spans`.
    """
    with _stage("grow3d"):
        if cfg.grow_algorithm == "jump":
            out = region_grow_jump_3d(
                pre, seeds, cfg.grow_low, cfg.grow_high, valid=valid,
                max_rounds=cfg.grow_max_iters, return_steps=True,
                stage=_stage, counter=_count,
            )
        else:
            grow = (region_grow_3d_kernel if cfg.use_kernels and pre.device.type != "cpu"
                    else region_grow_3d)
            out = grow(
                pre, seeds, cfg.grow_low, cfg.grow_high, valid=valid,
                block_iters=cfg.grow_block_iters, max_iters=cfg.grow_max_iters,
                return_steps=True, stage=_stage, counter=_count,
            )
    _count("grow3d.steps", out[2])
    return out if return_steps else out[:2]


def _process_volume(px: torch.Tensor, dm: torch.Tensor, cfg: PipelineConfig):
    seg, converged = grow_volume(*volume_grow_inputs(px, dm, cfg), cfg)
    with _stage("morph"):
        mask = finish_mask(seg, dm, cfg.morph_size, cfg.use_kernels, volume=True)
    return {"original": px, "mask": mask, "grow_converged": converged}


def process_volume(
    volume, dims, cfg: PipelineConfig = DEFAULT_CONFIG, device=None
) -> Dict[str, torch.Tensor]:
    """Full volumetric pipeline for one stacked series.

    Args:
      volume: (D, H, W) float raw intensities on the padded canvas; all
        slices of one series share the true in-plane size.
      dims: int32 (2,) true (height, width) of the series' slices.
      cfg: pipeline hyper-parameters (the reference's 2D contract values
        apply unchanged to each plane's preprocessing).

    Returns {'original', 'mask', 'grow_converged'}: the input volume, the
    uint8 (D, H, W) mask after 6-connected dilation (zero outside each
    plane's true extent), and a 0-d bool that is False when the growing
    fixpoint hit its cap (a truncated, under-covering mask).
    """
    with _stage("entry"):
        px, dm = _inputs(volume, dims, device)
        if px.dim() != 3 or tuple(dm.shape) != (2,):
            raise ValueError(
                f"process_volume takes (D, H, W) pixels and (2,) dims, got "
                f"{tuple(px.shape)} and {tuple(dm.shape)}"
            )
        return _process_volume(px, dm, cfg)
