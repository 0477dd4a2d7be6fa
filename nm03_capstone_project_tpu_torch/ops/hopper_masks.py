"""Hand-written Hopper kernels for the masks around the growth.

Replace no Pallas kernel: the JAX package computes the seed grid, the
valid mask and the final dilation with XLA ops, and the port ran them as
eager torch ops (:func:`.seeds.seed_mask` and
:func:`..core.image.valid_mask` before the growth, about 80 launches;
``cast_uint8``, :func:`.morphology.dilate` or :func:`.volume.dilate3d`, a
second valid mask and a multiply after it, 13 to 31), each a few bytes of
work a pixel. They were added because those launches were most of an entry
call's host time once the kernels did the rest. ``csrc/masks.cu`` makes each
stage one launch, bit for bit the plain ops:

* :func:`seed_valid_masks_kernel`: the seed and valid masks of every plane
  from the int32 ``dims`` on the card, as bool tensors the grow kernels
  take without a copy;
* :func:`finish_mask_kernel`: the grown mask (uint8 or bool) dilated by
  the cross footprint, in-plane or through z, and cut to the true size, as
  the uint8 mask.

Bound: bytes, and tiny (2 bytes a pixel each); the design is one grid over
the output, four 4-byte runs a thread, each CTA reading its plane's dims
once.
:func:`seed_valid_masks` and :func:`finish_mask` pick the kernel for CUDA
tensors under ``use_kernels``, else the plain ops, which stay as the CPU
path and as what the kernels are held to.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from nm03_capstone_project_tpu_torch.core.image import valid_mask
from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.ops.elementwise import cast_uint8
from nm03_capstone_project_tpu_torch.ops.morphology import dilate
from nm03_capstone_project_tpu_torch.ops.seeds import seed_mask
from nm03_capstone_project_tpu_torch.ops.volume import dilate3d


def _on_card(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got {t.device}")


def _int32_dims(dims: torch.Tensor, what: str) -> torch.Tensor:
    if dims.shape[-1:] != (2,):
        raise ValueError(f"{what} takes (..., 2) dims, got {tuple(dims.shape)}")
    return dims.to(torch.int32).contiguous()


def seed_valid_masks_plain(dims: torch.Tensor, canvas_hw: Tuple[int, int]):
    """``(seeds, valid)``: bool (..., H, W) masks of the torch ops."""
    return seed_mask(dims, canvas_hw), valid_mask(dims, canvas_hw)


def seed_valid_masks_kernel(dims: torch.Tensor, canvas_hw: Tuple[int, int]):
    """:func:`seed_valid_masks_plain` of CUDA ``dims`` (..., 2) in one launch
    of ``seed_valid_kernel``: contiguous bool (..., H, W) seeds and valid."""
    _on_card(dims, "seed_valid_masks_kernel")
    dm = _int32_dims(dims, "seed_valid_masks_kernel")
    h, w = (int(n) for n in canvas_hw)
    shape = (*dims.shape[:-1], h, w)
    seeds = torch.empty(shape, dtype=torch.bool, device=dims.device)
    valid = torch.empty(shape, dtype=torch.bool, device=dims.device)
    planes = math.prod(dims.shape[:-1])
    if seeds.numel() > 0:
        stream = torch.cuda.current_stream(dims.device).cuda_stream
        build.check(build.load("masks").nm03_seed_valid(
            dm.data_ptr(), seeds.data_ptr(), valid.data_ptr(), planes, h, w, stream),
            "nm03_seed_valid")
        seed_valid_masks_kernel.launches += 1
    return seeds, valid


seed_valid_masks_kernel.launches = 0


def seed_valid_masks(dims: torch.Tensor, canvas_hw: Tuple[int, int], use_kernels: bool = True):
    """The seed and valid masks: the kernel for CUDA dims with
    ``use_kernels``, else the torch ops."""
    if use_kernels and dims.is_cuda:
        return seed_valid_masks_kernel(dims, canvas_hw)
    return seed_valid_masks_plain(dims, canvas_hw)


def finish_mask_plain(seg: torch.Tensor, dims: torch.Tensor, size: int,
                      volume: bool = False) -> torch.Tensor:
    """The uint8 final mask of the torch ops: the grown mask cast, dilated
    by the cross of ``size`` (2D over each plane; 3D over the (D, H, W)
    volume with ``volume``, ``dims`` (2,) for every plane) and cut to the
    true size."""
    hw = tuple(seg.shape[-2:])
    if volume:
        mask = dilate3d(cast_uint8(seg), size)
        valid = valid_mask(dims, hw).expand(*seg.shape[-3:])
    else:
        mask = dilate(cast_uint8(seg), size)
        valid = valid_mask(dims, hw)
    return mask * valid.to(mask.dtype)


def finish_mask_kernel(seg: torch.Tensor, dims: torch.Tensor, size: int,
                       volume: bool = False) -> torch.Tensor:
    """:func:`finish_mask_plain` of a CUDA uint8 or bool ``seg`` in one launch
    of ``finish_kernel``. 2D: ``seg`` (..., H, W) with one (h, w) a plane
    (dims (..., 2)) or one for all (dims (2,)). 3D: ``seg`` (..., D, H, W)
    with dims (2,)."""
    _on_card(seg, "finish_mask_kernel")
    if seg.dtype not in (torch.uint8, torch.bool):
        raise TypeError(f"finish_mask_kernel takes uint8 or bool, got {seg.dtype}")
    if size < 1:
        raise ValueError(f"morph size must be positive, got {size}")
    if dims.device != seg.device:
        raise ValueError(f"finish_mask_kernel: dims are on {dims.device}, seg on {seg.device}")
    dm = _int32_dims(dims, "finish_mask_kernel")
    if seg.dim() < (3 if volume else 2):
        raise ValueError(f"finish_mask_kernel: a {'volume' if volume else 'plane'} is too "
                         f"few axes for {tuple(seg.shape)}")
    h, w = seg.shape[-2:]
    planes = math.prod(seg.shape[:-2])
    depth = seg.shape[-3] if volume else 1
    if dm.numel() == 2:
        step = 0
    elif not volume and dm.numel() == 2 * planes:
        step = 1
    else:
        raise ValueError(f"finish_mask_kernel: dims {tuple(dims.shape)} do not fit "
                         f"{'a volume' if volume else 'planes'} {tuple(seg.shape)}")
    src = seg.contiguous()
    out = torch.empty(seg.shape, dtype=torch.uint8, device=seg.device)
    if out.numel() > 0:
        r = size // 2
        stream = torch.cuda.current_stream(seg.device).cuda_stream
        build.check(build.load("masks").nm03_finish(
            src.data_ptr(), dm.data_ptr(), step, out.data_ptr(), planes, depth, h, w, r,
            r if volume else 0, stream), "nm03_finish")
        finish_mask_kernel.launches += 1
    return out


finish_mask_kernel.launches = 0


def finish_mask(seg: torch.Tensor, dims: torch.Tensor, size: int, use_kernels: bool = True,
                volume: bool = False) -> torch.Tensor:
    """The final mask: the kernel for a CUDA ``seg`` with ``use_kernels``,
    else the torch ops."""
    if use_kernels and seg.is_cuda:
        return finish_mask_kernel(seg, dims, size, volume)
    return finish_mask_plain(seg, dims, size, volume)
