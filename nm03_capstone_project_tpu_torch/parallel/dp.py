"""Data-parallel slice batches over a device mesh.

The port of the JAX package's ``parallel/dp.py``, the replacement of the
reference's OpenMP batch loop (src/parallel/main_parallel.cpp:330-347).
The JAX package shards the batch axis with ``NamedSharding`` and runs the
vmapped pipeline as one SPMD program; here the batch splits over the
mesh's ``data`` devices (:func:`.mesh.batch_shards`), each chunk runs
through the port's batch pipeline on its own device (on a card: one fused
preprocess launch and one grow launch a chunk, or the median kernel under
``fuse_preprocess=False``), and the results come back in order. Slices
are independent, so nothing crosses devices but the inputs and outputs,
and the masks are the single-device ones bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from nm03_capstone_project_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from nm03_capstone_project_tpu_torch.parallel.mesh import (
    Mesh,
    batch_shards,
    gather_shards,
    make_mesh,
    on_device,
)
from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import _process
from nm03_capstone_project_tpu_torch.render.render import render_pair


def _chunk(px: torch.Tensor, dm: torch.Tensor, cfg: PipelineConfig, with_render: bool,
           mask_only: bool) -> Dict[str, torch.Tensor]:
    out = _process(px, dm, cfg)
    if mask_only:
        return {"mask": out["mask"], "grow_converged": out["grow_converged"]}
    if with_render:
        gray, seg = render_pair(px, out["mask"], dm, cfg)
        return {"original": gray, "mask": seg, "grow_converged": out["grow_converged"]}
    return out


def process_batch_sharded(
    pixels,
    dims,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
    with_render: bool = False,
    mask_only: bool = False,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Run a (B, H, W) slice batch data-parallel across the mesh.

    B must divide the mesh's ``data`` axis evenly: use
    :func:`.mesh.pad_to_multiple` on the host batch first.

    Args:
      pixels: (B, H, W) float canvas batch (host array or tensor).
      dims: (B, 2) true dims.
      mesh: a mesh with a ``data`` axis (default: every device of
        :func:`.mesh.local_devices` of ``device``).
      with_render: return the 512x512 rendered pair in place of the
        canvas outputs (``original`` the grayscale render, ``mask`` the
        segmentation render), as the JAX function does.
      mask_only: return {'mask', 'grow_converged'} only; exclusive with
        ``with_render``.

    The outputs are gathered on the first ``data`` device. Every mode's
    output carries ``grow_converged``, a (B,) bool, False for slices whose
    growing fixpoint hit its cap. On a one-device mesh this is exactly
    :func:`..pipeline.process_batch` on that device.
    """
    if mask_only and with_render:
        raise ValueError("mask_only and with_render are mutually exclusive")
    if mesh is None:
        mesh = make_mesh(axis_names=("data",), device=device)
    return map_batch_sharded(
        lambda dev, px, dm: _chunk(px, dm, cfg, with_render, mask_only), pixels, dims, mesh)


def map_batch_sharded(fn: Callable[[torch.device, torch.Tensor, torch.Tensor], Dict],
                      pixels, dims, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """``fn(device, pixels, dims)`` on each ``data`` chunk of a (B, H, W)
    batch, on the chunk's device; the dicts it returns gathered in order on
    the first ``data`` device. The axis size must divide B. Every chunk is
    enqueued before any is read: chunks on different cards run at once,
    chunks on one card queue on its stream."""
    devs = mesh.axis_devices("data")
    px_shards = batch_shards(pixels, mesh, "data", torch.float32)
    dm_shards = batch_shards(dims, mesh, "data", torch.int32)
    outs = []
    for dev, px, dm in zip(devs, px_shards, dm_shards):
        with on_device(dev):
            outs.append(fn(dev, px, dm))
    if len(outs) == 1:
        return outs[0]
    return {k: gather_shards([o[k] for o in outs], devs[0]) for k in outs[0]}
