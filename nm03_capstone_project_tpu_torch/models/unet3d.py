"""3D segmentation U-Net: the volumetric student.

The port of the JAX package's ``models/unet3d.py``: the 2D skeleton of
:mod:`.unet` with 3x3x3 convolutions and 2x2x2 pooling and upsampling over
(D, H, W) jointly, on NCDHW activations and OIDHW weights, with the same
casts. D, H and W must each be divisible by ``2**levels``. Its teacher is
the classical volume pipeline (6-connected growth, 3D dilation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.core.backend import resolve_device
from nm03_capstone_project_tpu_torch.models.unet import UNet, _he_init_, apply_unet, predict_mask


class UNet3d(UNet):
    """The 3D student: (B, D, H, W) volumes -> (B, D, H, W) float32 logits."""

    ndim = 3

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(x, 2, 2)


def init_unet3d(
    generator: torch.Generator, base: int = 8, levels: int = 2, in_ch: int = 1,
    device=None,
) -> UNet3d:
    """A freshly initialised :class:`UNet3d` on ``device`` (``cuda`` unless
    the caller passes ``"cpu"``). ``base`` defaults to 8, as in the JAX
    package; its training CLI passes ``--base-channels`` (16)."""
    dev = resolve_device(device)
    model = UNet3d(base, levels, in_ch)
    _he_init_(model, generator)
    # nm03-lint: disable=NM401 one-time weight placement: parameters are not the data path
    return model.to(dev)


# the module's class selects the family, so the 2D entry points serve the
# 3D student unchanged: (B, D, H, W) volumes -> float32 logits / uint8 mask
apply_unet3d = apply_unet
predict_mask3d = predict_mask


def distill_volume(volume, dims, cfg: PipelineConfig = None, device=None) -> torch.Tensor:
    """Teacher labels from the classical 3D pipeline for one (D, H, W)
    volume: one launch of the fused preprocess kernel on the card."""
    from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import process_volume

    return process_volume(volume, dims, cfg or PipelineConfig(), device=device)["mask"]
