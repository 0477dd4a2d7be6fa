"""Device meshes and the split/gather helpers of the port's parallel paths.

The port of the JAX package's ``parallel/mesh.py``. There a mesh is a
``jax.sharding.Mesh`` and XLA inserts the collectives; here it is a small
:class:`Mesh` (a numpy array of ``torch.device`` with named axes) and the
parallel paths move the pieces themselves:

* ``data`` — batch parallelism: the batch splits over the axis's devices
  (:func:`batch_shards`, the counterpart of ``batch_sharding``) and the
  results come back in order (:func:`gather_shards`);
* ``z`` — volume sharding: a (D, H, W) series splits along z and the 3D
  stencils exchange halo planes between neighbours (:mod:`.zshard`).

The default device pool is every visible CUDA device, or ``[cpu]`` when
the caller asks for the CPU. A caller may name the same device more than
once: the tests build ``[cpu] * 4`` meshes and ``chip_smoke.py`` a
``[cuda:0] * 4`` one, the counterpart of the JAX tests' virtual devices
(``xla_force_host_platform_device_count``), so every halo exchange and
every convergence reduction runs on one card. No driver repeats a device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.core.backend import resolve_device


class Mesh:
    """Devices laid out on named axes.

    ``devices`` is a numpy object array of ``torch.device`` shaped by the
    axes; ``shape`` is ``{name: size}`` as a JAX mesh's. A mesh from
    :func:`.distributed.global_mesh` has ``process_group`` set: it holds
    one device a rank, and only this rank's entry is addressable here.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 process_group: bool = False):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes {tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_group = bool(process_group)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, the other axes at index 0 (where a
        JAX sharding over ``axis`` alone places its shards)."""
        k = self.axis_names.index(axis)
        idx = tuple(slice(None) if i == k else 0 for i in range(self.devices.ndim))
        return list(self.devices[idx])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def local_devices(device=None) -> List[torch.device]:
    """The default device pool: every visible CUDA device, or ``[cpu]``
    when ``device`` asks for the CPU (raises without a GPU otherwise)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def local_devices_from(device: torch.device) -> List[torch.device]:
    """:func:`local_devices` of the resolved ``device`` in turn, starting at
    ``device`` itself (``cuda`` meaning the current card), so that a mesh
    built on them gathers its outputs on the caller's device."""
    devs = local_devices(device)
    here = torch.device(device)
    if here.type == "cuda" and here.index is None:
        here = torch.device("cuda", torch.cuda.current_device())
    k = next((i for i, d in enumerate(devs) if d == here), 0)
    return devs[k:] + devs[:k]


def _device_array(devices: Sequence[torch.device], shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr.reshape(tuple(shape))


def make_mesh(
    n_devices: Optional[int] = None,
    axis_names: Sequence[str] = ("data",),
    axis_sizes: Optional[Sequence[int]] = None,
    devices: Optional[Sequence] = None,
    device=None,
) -> Mesh:
    """Build a mesh over the first ``n_devices`` of ``devices``.

    Args:
      n_devices: number of devices to use (default: all in ``devices``).
      axis_names: mesh axis names, e.g. ("data",) or ("data", "z").
      axis_sizes: sizes per axis; must multiply to n_devices. Defaults to
        all devices on the first axis.
      devices: the device pool (default :func:`local_devices` of
        ``device``); a device may appear more than once.
      device: ``"cpu"`` for a CPU pool; ``cuda`` (the default) otherwise.
    """
    devices = list(local_devices(device) if devices is None else devices)
    n = len(devices) if n_devices is None else n_devices
    if n > len(devices):
        raise ValueError(f"requested {n} devices, only {len(devices)} available")
    if axis_sizes is None:
        axis_sizes = [n] + [1] * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis_sizes {list(axis_sizes)} != n_devices {n}")
    return Mesh(_device_array(devices[:n], axis_sizes), axis_names)


def pad_to_multiple(
    pixels: np.ndarray, dims: np.ndarray, multiple: int
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad a (B, H, W) host batch along B so it divides the mesh evenly.

    Filler slices get dims (1, 1): they fail the reference's min-dimension
    guard (main_sequential.cpp:189-192) by construction, so callers that
    count successes never see them, and their valid region is a single pixel
    so the padded lanes converge immediately in the region-growing fixpoint.

    Returns (pixels, dims, real_count).
    """
    b = pixels.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return pixels, dims, b
    pad_px = np.zeros((rem,) + pixels.shape[1:], pixels.dtype)
    pad_dims = np.ones((rem, 2), dims.dtype)
    return (
        np.concatenate([pixels, pad_px]),
        np.concatenate([dims, pad_dims]),
        b,
    )


def on_device(device: torch.device):
    """Make ``device`` current for the kernels launched inside (their
    stream is the tensor's device's current stream); a no-op on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def to_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    """A host array or a tensor on ``device`` (a no-copy view where it
    already lies there)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def batch_shards(x, mesh: Mesh, axis: str = "data", dtype=None) -> List[torch.Tensor]:
    """Split axis 0 of ``x`` evenly over the devices of ``axis``, one
    piece on each: the port's ``batch_sharding``. Raises ValueError when
    the axis does not divide the batch (pad with :func:`pad_to_multiple`)."""
    devs = mesh.axis_devices(axis)
    b = x.shape[0]
    if b % len(devs):
        raise ValueError(
            f"batch {b} not divisible by {axis}-axis size {len(devs)}; "
            "pad with pad_to_multiple first"
        )
    step = b // len(devs)
    return [to_device(x[i * step:(i + 1) * step], d, dtype) for i, d in enumerate(devs)]


def replicated(x, mesh: Mesh, dtype=None) -> List[torch.Tensor]:
    """``x`` on every device of the mesh (flat order): the port's
    ``replicated``."""
    return [to_device(x, d, dtype) for d in mesh.devices.flat]


def gather_shards(shards: Sequence[torch.Tensor], device: torch.device,
                  dim: int = 0) -> torch.Tensor:
    """The pieces concatenated in order on ``device``: what reading a
    sharded JAX array back gives."""
    return torch.cat([s.to(device) for s in shards], dim=dim)
