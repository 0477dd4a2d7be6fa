"""Segmentation U-Net: the student distilled from the classical pipeline.

The port of the JAX package's ``models/unet.py``. The network is the same
encoder-decoder with the same parameters: ``levels`` stages of two 3x3
conv + ReLU blocks with a 2x2 max-pool between them, a bottleneck block,
nearest x2 upsampling with the skip concatenated after the upsampled
features, and a 1x1 head of 8 channels summed into one logit map.

Layout is PyTorch's: NCHW activations and OIHW weights (the JAX package
keeps NHWC and HWIO; :mod:`..convert` maps one onto the other).

Precision mirrors the JAX package's casts one by one, without autocast:
the parameters stay float32, each conv casts its input, weight and bias to
the compute dtype, and the bias add, the ReLU, max-pool, upsampling, the
skip concatenation and the head sum run in that dtype; only the logits
come back as float32. ``torch.autocast`` would keep some of these ops in
float32 and compute something else. A float32 forward on the GPU runs its
convolutions without TF32 (:func:`conv_precision`), whatever the global
cuDNN setting says.

Initialisation is He-normal with zero biases, drawn from an explicit CPU
``torch.Generator``, so a seed gives the same weights on the card and on
the CPU. It cannot reproduce JAX's PRNG: to hold the two packages to each
other, convert JAX weights with :func:`..convert.unet_params_from_jax`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nm03_capstone_project_tpu_torch.core.backend import resolve_device


@contextlib.contextmanager
def conv_precision(dtype: torch.dtype, device: torch.device):
    """IEEE float32 convolutions on the GPU while the block runs.

    cuDNN runs float32 convolutions in TF32 when ``cudnn.allow_tf32`` is
    set (PyTorch's default), which is not the float32 the JAX package
    computes. The student turns it off for its own float32 forward and
    backward passes and restores the caller's setting after.
    """
    if dtype != torch.float32 or torch.device(device).type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class Conv(nn.Module):
    """A stride-1 'SAME' convolution with a bias, both cast per call."""

    def __init__(self, cin: int, cout: int, k: int, ndim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((cout, cin) + (k,) * ndim))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.padding = k // 2
        self._conv = F.conv2d if ndim == 2 else F.conv3d
        self._bias_shape = (1, cout) + (1,) * ndim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the bias is added after the conv, in the compute dtype, as the
        # JAX package does (a bias fused into the conv would be added
        # before the output is rounded)
        out = self._conv(x, self.weight.to(x.dtype), None, padding=self.padding)
        return out + self.bias.to(x.dtype).view(self._bias_shape)


class Block(nn.Module):
    """conv -> ReLU -> conv -> ReLU."""

    def __init__(self, cin: int, cout: int, ndim: int):
        super().__init__()
        self.c1 = Conv(cin, cout, 3, ndim)
        self.c2 = Conv(cout, cout, 3, ndim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.c2(torch.relu(self.c1(x))))


class UNet(nn.Module):
    """The 2D student: (B, H, W) pixels -> (B, H, W) float32 logits.

    Channel widths are ``base * 2**level``; with ``base=16`` and two levels
    the largest conv is the decoder's (3, 3, 64 + 32, 32) in HWIO terms.
    H and W must be divisible by ``2**levels``.
    """

    ndim = 2

    def __init__(self, base: int = 16, levels: int = 2, in_ch: int = 1):
        super().__init__()
        if base % 8:
            raise ValueError(f"base channels must be a multiple of 8, got {base}")
        self.base, self.levels, self.in_ch = base, levels, in_ch
        nd = self.ndim
        widths = [base * 2**lv for lv in range(levels)]
        self.enc = nn.ModuleList(
            Block(cin, cout, nd) for cin, cout in zip([in_ch] + widths[:-1], widths)
        )
        cmid = base * 2**levels
        self.mid = Block(widths[-1] if widths else in_ch, cmid, nd)
        dec, cin = [], cmid
        for cout in reversed(widths):
            # input = upsampled decoder features + the skip connection
            dec.append(Block(cin + cout, cout, nd))
            cin = cout
        self.dec = nn.ModuleList(dec)
        self.head = Conv(cin, 8, 1, nd)  # 8 channels summed: the JAX head

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool2d(x, 2, 2)

    def _upsample(self, x: torch.Tensor) -> torch.Tensor:
        for axis in range(2, 2 + self.ndim):
            x = x.repeat_interleave(2, dim=axis)
        return x

    def forward(self, pixels: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        spatial = tuple(pixels.shape[-self.ndim:])
        if pixels.dim() != self.ndim + 1 or any(s % 2**self.levels for s in spatial):
            raise ValueError(
                f"{type(self).__name__} takes (B, {', '.join('DHW'[3 - self.ndim:])}) "
                f"inputs with spatial sizes divisible by {2**self.levels}, got "
                f"{tuple(pixels.shape)}"
            )
        with conv_precision(compute_dtype, pixels.device):
            x = pixels[:, None].to(compute_dtype)
            skips = []
            for block in self.enc:
                x = block(x)
                skips.append(x)
                x = self._pool(x)
            x = self.mid(x)
            for block, skip in zip(self.dec, reversed(skips)):
                x = torch.cat([self._upsample(x), skip.to(x.dtype)], dim=1)
                x = block(x)
            logits8 = self.head(x)
        # the JAX head sum accumulates in float32 and rounds to the compute
        # dtype; only then do the logits become float32
        return logits8.float().sum(dim=1).to(compute_dtype).float()


def _he_init_(model: nn.Module, generator: torch.Generator) -> None:
    """He-normal weights (std sqrt(2 / fan_in)) in module order, zero biases."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                w = m.weight
                fan_in = math.prod(w.shape[1:])
                w.copy_(torch.randn(w.shape, generator=generator) * math.sqrt(2.0 / fan_in))
                m.bias.zero_()


def init_unet(
    generator: torch.Generator, base: int = 16, levels: int = 2, in_ch: int = 1,
    device=None,
) -> UNet:
    """A freshly initialised :class:`UNet` on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``); the weights come from ``generator``, a CPU
    ``torch.Generator``."""
    dev = resolve_device(device)
    model = UNet(base, levels, in_ch)
    _he_init_(model, generator)
    # nm03-lint: disable=NM401 one-time weight placement: parameters are not the data path
    return model.to(dev)


def apply_unet(model: UNet, pixels: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Forward pass: (B, H, W) float pixels -> (B, H, W) float32 logits
    ((B, D, H, W) for the 3D student)."""
    return model(pixels, compute_dtype)


@torch.no_grad()
def predict_mask(model: UNet, pixels: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """uint8 mask, the classical pipeline's output contract."""
    return (model(pixels, compute_dtype) > 0).to(torch.uint8)


def param_shardings(model: UNet, mesh) -> Dict[str, Optional[int]]:
    """For each parameter of ``model`` (its ``state_dict`` name), the dim it
    splits on over the mesh's ``model`` axis, or None where it is replicated.

    The JAX package's rule: a leaf splits on its out-channels when their
    count divides by the axis size ``tp > 1``. Out-channels are dim 0 of the
    port's OIHW weights and of the biases (the JAX package's HWIO kernels
    keep them last), so a split leaf splits on dim 0.
    """
    tp = mesh.shape.get("model", 1)
    return {name: 0 if tp > 1 and p.shape[0] % tp == 0 else None
            for name, p in model.named_parameters()}


def unet_from_state(state: Dict[str, np.ndarray], device=None) -> UNet:
    """Rebuild the student a ``state_dict`` of arrays describes.

    ``base``, ``levels`` and ``in_ch`` follow from the shapes, and a weight
    of rank 5 makes it the 3D family, so a checkpoint needs no skeleton
    description to load.
    """
    from nm03_capstone_project_tpu_torch.models.unet3d import UNet3d

    w0 = np.asarray(state["enc.0.c1.weight"])
    levels = len({k.split(".")[1] for k in state if k.startswith("enc.")})
    cls = UNet3d if w0.ndim == 5 else UNet
    model = cls(base=int(w0.shape[0]), levels=levels, in_ch=int(w0.shape[1]))
    want = model.state_dict()
    if set(state) != set(want):
        raise ValueError(
            f"parameters do not describe a {cls.__name__}: missing "
            f"{sorted(set(want) - set(state))}, unexpected {sorted(set(state) - set(want))}"
        )
    for k, v in want.items():
        if tuple(np.shape(state[k])) != tuple(v.shape):
            raise ValueError(f"{k}: shape {np.shape(state[k])}, expected {tuple(v.shape)}")
    model.load_state_dict({k: torch.tensor(np.asarray(v, np.float32)) for k, v in state.items()})
    return model.to(resolve_device(device))

