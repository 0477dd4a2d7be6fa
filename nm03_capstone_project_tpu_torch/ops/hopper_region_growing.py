"""Hand-written Hopper kernel for seeded region growing.

The JAX package's Pallas kernel ``_grow_kernel``
(ops/pallas_region_growing.py:30) becomes the CUDA kernel of
``csrc/grow.cu``: one CTA per slice iterating the masked-dilation fixpoint
in shared memory on bit-packed rows. :func:`region_grow_kernel` is
bit-identical to the plain :func:`.region_growing.region_grow`, mask and
per-slice ``converged`` alike.

A slice whose packed buffers exceed the shared memory a block may use
(:func:`grow_smem_bytes`; canvas 768 fits on the H100, 1024 does not) is
refused with a ValueError; there is no route to the plain op on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.ops.region_growing import region_grow

CUDA_ERROR_INVALID_CONFIGURATION = 9  # cudaErrorInvalidConfiguration


def grow_smem_bytes(h: int, w: int) -> int:
    """Shared memory the grow kernel takes for an (h, w) slice: band and
    two region buffers of 32-pixel words, plus the popcount scratch."""
    return (3 * h * ((w + 31) // 32) + 33) * 4


def _flat_u8(t: torch.Tensor, name: str, image: torch.Tensor) -> torch.Tensor:
    """``t != 0`` broadcast to ``image``'s shape, as contiguous (B, H, W)
    uint8 on ``image``'s device (the plain op broadcasts the same way). A
    bool tensor of the image's shape is passed on as it is, without a copy."""
    if t.device != image.device:
        raise ValueError(f"region_grow_kernel: {name} is on {t.device}, image on {image.device}")
    h, w = image.shape[-2:]
    m = t if t.dtype == torch.bool else t != 0
    return torch.broadcast_to(m, image.shape).reshape(-1, h, w).contiguous().view(torch.uint8)


def region_grow_kernel(
    image: torch.Tensor,
    seeds: torch.Tensor,
    low: float = 0.74,
    high: float = 0.91,
    valid: Optional[torch.Tensor] = None,
    connectivity: int = 4,
    block_iters: int = 16,
    max_iters: int = 1024,
    return_steps: bool = False,
):
    """Region growing of (..., H, W) CUDA tensors; ``(mask uint8, converged)``.

    ``converged`` has the leading shape (one bool per slice). ``seeds`` and
    ``valid`` broadcast to the image's shape. With ``return_steps`` a third
    int32 tensor of that leading shape holds the dilation steps each slice
    ran, as :func:`.region_growing.region_grow` reports them.
    """
    if image.device.type != "cuda":
        raise ValueError(f"region_grow_kernel takes CUDA tensors, got {image.device}")
    if image.dtype != torch.float32:
        raise TypeError(f"region_grow_kernel takes float32, got {image.dtype}")
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    if block_iters < 1 or max_iters < 1:
        raise ValueError("grow iteration counts must be positive")
    lead, (h, w) = image.shape[:-2], image.shape[-2:]
    img = image.reshape(-1, h, w).contiguous()
    b = img.shape[0]
    sd = _flat_u8(seeds, "seeds", image)
    vd = None if valid is None else _flat_u8(valid, "valid", image)
    mask = torch.empty((b, h, w), dtype=torch.uint8, device=img.device)
    conv = torch.empty((b,), dtype=torch.int32, device=img.device)
    steps = torch.empty((b,), dtype=torch.int32, device=img.device)
    if b > 0:
        lib = build.load("grow")
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.nm03_region_grow(
            img.data_ptr(), sd.data_ptr(), None if vd is None else vd.data_ptr(),
            mask.data_ptr(), conv.data_ptr(), steps.data_ptr(), b, h, w,
            float(np.float32(low)), float(np.float32(high)),
            connectivity, block_iters, max_iters, stream,
        )
        if err == CUDA_ERROR_INVALID_CONFIGURATION:
            raise ValueError(
                f"grow kernel: a {h}x{w} slice needs {grow_smem_bytes(h, w)} bytes of "
                "shared memory, more than a block may use; larger slices are not ported"
            )
        build.check(err, "nm03_region_grow")
        region_grow_kernel.launches += 1
    out = (mask.reshape(image.shape), (conv != 0).reshape(lead))
    return out + (steps.reshape(lead),) if return_steps else out


region_grow_kernel.launches = 0


def grow_dispatch(
    image: torch.Tensor,
    seeds: torch.Tensor,
    low: float,
    high: float,
    valid: Optional[torch.Tensor] = None,
    connectivity: int = 4,
    block_iters: int = 16,
    max_iters: int = 1024,
    use_kernels: bool = True,
    algorithm: str = "dilate",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grow kernel for a CUDA tensor with ``use_kernels``; else plain.

    Only the "dilate" schedule is ported; "jump" raises NotImplementedError.
    """
    if algorithm != "dilate":
        raise NotImplementedError(f"grow algorithm {algorithm!r} is not ported yet")
    kw = dict(valid=valid, connectivity=connectivity, block_iters=block_iters,
              max_iters=max_iters)
    if use_kernels and image.device.type != "cpu":
        return region_grow_kernel(image, seeds, low, high, **kw)
    return region_grow(image, seeds, low, high, **kw)
