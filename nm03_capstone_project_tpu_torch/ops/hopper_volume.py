"""Hand-written Hopper kernel for the 3D seeded region growing.

Replaces no Pallas kernel: the JAX package computes the 3D growth with
XLA ops, and the port ran it as the torch loop of
:func:`.volume.region_grow_3d`, about 11 eager launches a dilation step
over the whole volume (a 155 x 256 x 256 study: 48 steps, ~530 launches,
12 ms of elementwise kernels on the card and as long again of host
launching). It was added because that loop was most of
``process_volume``'s time. :func:`region_grow_3d_kernel` runs the same
fixpoint through ``csrc/grow3d.cu`` in three launches: one packs the band
and the seeded region, one cooperative launch runs every block of
``block_iters`` steps and decides on the card, after each, whether to run
another, one unpacks the mask. Bit for bit the plain loop's mask,
``converged`` and steps; the host reads none of them, so the call returns
as soon as the launches are enqueued and the card's next work (the next
study's copy) can run under the growth.

Bound: bytes. The pack reads the float32 volume once and the unpack
writes the uint8 mask once: the only traffic to HBM. A step reads the
packed region and band and writes a region, 3/8 of a byte a voxel, in
L2. The design keeps the band and both region buffers bit-packed (32
voxels a word along W, 1.44 MB a buffer at 155 x 256 x 256) and so in
L2 for the whole growth, lays them out with a
border of zero words (:func:`grow3d_layout`) so that a step tests no
edge, and runs every step in one persistent grid with one grid barrier
after each. A block ends in one flag, not two popcounts: the growth is
monotone, so the count changed over a block exactly where some word
changed in it. The flag, the steps, the blocks and the buffer that holds
the result stay in device words (``GROW3D_STATE``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.ops.region_growing import no_count, no_stage

CONNECTIVITY = (6, 26)
# the growth's int32 state words on the card (csrc/grow3d.cu): the last
# block that changed a word (0: none), the steps run, the buffer that holds
# the region, the blocks run
GROW3D_STATE = ("flag", "steps", "cur", "blocks")


class Grow3dLayout(NamedTuple):
    """The packed buffers' layout (``csrc/grow3d.cu``, ``layout_of``): words
    of a row (its leading zero word included), of a plane (its leading zero
    row included), the zero words before the first plane and after the
    last, and the words of one buffer."""

    row: int
    plane: int
    front: int
    total: int


def grow3d_layout(b: int, d: int, h: int, w: int) -> Grow3dLayout:
    """The layout of b volumes of d x h x w: each row led by a zero word,
    each plane by a zero row, each volume by a zero plane, one zero plane
    after the last volume, and ``front`` zero words at either end, enough
    for a warp's reads one plane, row and word past the stepped range."""
    row = (w + 31) // 32 + 1
    plane = (h + 1) * row
    front = -(-(row + 33) // 32) * 32
    return Grow3dLayout(row, plane, front, 2 * front + (b * (d + 1) + 1) * plane)


def _strided_u8(t: torch.Tensor, shape: torch.Size, b: int):
    """``t != 0`` broadcast to ``shape`` as a (B, D, H, W) uint8 view and its
    element strides: a bool or uint8 tensor is read where it lies, an
    expanded plane as a plane (a view reshaped, copied only where its
    strides do not allow a view)."""
    m = t if t.dtype in (torch.bool, torch.uint8) else t != 0
    m = torch.broadcast_to(m, shape).reshape(b, *shape[-3:])
    if m.dtype == torch.bool:
        m = m.view(torch.uint8)
    return m, m.stride()


def region_grow_3d_kernel(
    volume: torch.Tensor,
    seeds: torch.Tensor,
    low: float = 0.74,
    high: float = 0.91,
    valid: Optional[torch.Tensor] = None,
    connectivity: int = 6,
    block_iters: int = 16,
    max_iters: int = 4096,
    return_steps: bool = False,
    stage=no_stage,
    counter=no_count,
):
    """:func:`.volume.region_grow_3d` of a (..., D, H, W) CUDA float32 volume
    on the kernels of ``csrc/grow3d.cu``: ``(mask uint8, converged)``, and
    the steps run with ``return_steps``, a 0-d int32 tensor on the device.

    The plain loop's schedule, block for block: one unconditional block of
    ``block_iters`` steps, then blocks while the last one changed a voxel
    and fewer than ``max_iters`` steps ran, decided on the card;
    ``converged`` is ONE 0-d bool on the device for the whole input
    (leading batch axes are independent volumes under one flag, as the
    popcount sums every axis). Three launches (pack, run, unpack) and no
    read on the host: the call returns before the growth has run. The run
    is one launch inside a ``grow3d.block`` span, counted once under
    ``grow3d.launches`` and in ``launches``; ``grow3d.syncs`` counts 0 and
    ``grow3d.blocks`` the blocks run, a 0-d tensor that the counter's
    reader resolves when it reads it.
    """
    if volume.device.type != "cuda":
        raise ValueError(f"region_grow_3d_kernel takes CUDA tensors, got {volume.device}")
    if volume.dtype != torch.float32:
        raise TypeError(f"region_grow_3d_kernel takes float32, got {volume.dtype}")
    if volume.dim() < 3:
        raise ValueError(f"region_grow_3d_kernel takes (..., D, H, W), got {tuple(volume.shape)}")
    if connectivity not in CONNECTIVITY:
        raise ValueError(f"connectivity must be 6 or 26, got {connectivity}")
    if block_iters < 1 or max_iters < 1:
        raise ValueError("grow iteration counts must be positive")
    for t, name in ((seeds, "seeds"), (valid, "valid")):
        if t is not None and t.device != volume.device:
            raise ValueError(f"region_grow_3d_kernel: {name} is on {t.device}, "
                             f"volume on {volume.device}")
    vol = volume.contiguous()
    d, h, w = vol.shape[-3:]
    b = math.prod(vol.shape[:-3])
    mask = torch.empty(vol.shape, dtype=torch.uint8, device=vol.device)
    if mask.numel() == 0:
        # the plain loop's answer on nothing: one block, nothing changed
        out = (mask, torch.ones((), dtype=torch.bool, device=vol.device))
        return out + (torch.full((), block_iters, dtype=torch.int32, device=vol.device),) \
            if return_steps else out
    sd, ss = _strided_u8(seeds, vol.shape, b)
    vd, vs = (None, (0, 0, 0, 0)) if valid is None else _strided_u8(valid, vol.shape, b)
    lay = grow3d_layout(b, d, h, w)
    bufs = torch.empty((3, lay.total), dtype=torch.int32, device=vol.device)
    state = torch.empty((len(GROW3D_STATE),), dtype=torch.int32, device=vol.device)
    conv = torch.empty((), dtype=torch.bool, device=vol.device)
    lib = build.load("grow3d")
    stream = torch.cuda.current_stream(vol.device).cuda_stream
    band, buf0, buf1 = (bufs[i].data_ptr() for i in range(3))
    build.check(lib.nm03_grow3d_pack(
        vol.data_ptr(), sd.data_ptr(), *ss, None if vd is None else vd.data_ptr(), *vs,
        band, buf0, buf1, state.data_ptr(), b, d, h, w, lay.total,
        float(np.float32(low)), float(np.float32(high)), stream), "nm03_grow3d_pack")
    with stage("grow3d.block"):
        build.check(lib.nm03_grow3d_run(
            band, buf0, buf1, state.data_ptr(), b, d, h, w, lay.total, connectivity,
            block_iters, max_iters, stream), "nm03_grow3d_run")
    region_grow_3d_kernel.launches += 1
    counter("grow3d.launches")
    counter("grow3d.syncs", 0)
    _, steps, _, blocks = state.unbind()
    counter("grow3d.blocks", blocks)
    build.check(lib.nm03_grow3d_unpack(
        buf0, buf1, state.data_ptr(), mask.data_ptr(), conv.data_ptr(), b, d, h, w, lay.total,
        stream), "nm03_grow3d_unpack")
    out = (mask, conv)
    return out + (steps,) if return_steps else out


region_grow_3d_kernel.launches = 0
