"""Device staging: the home of the host→device copy of a batch.

The port of the JAX package's ``ingest/staging.py::stage_batch``. There the
copy is ``jax.device_put``, asynchronous by nature; here a :class:`Stager`
makes it so on the card:

* each array is copied from **pinned** host memory with
  ``non_blocking=True`` on a **side CUDA stream** that the stager owns (the
  ingest pipeline's stager thread runs it), so batch N+1's copy overlaps
  batch N's kernels on the consumer's stream;
* an **event** recorded after the copies travels with the batch;
  :func:`wait_staged` makes the consumer's stream wait on it before the
  batch's first kernel;
* ``record_stream`` tells the caching allocator that the consumer's stream
  uses the device tensor, so its memory is not handed to another
  allocation before the consumer's work on it is done.

The host arrays stay in the batch as ``<key>_host`` (the host renderer
reads them). On the CPU, staging is a plain copy into a tensor. The JAX
package's ``host_only`` mode (its degraded, CPU-fallback run) is not
ported: the port has no such fallback.

:func:`stage_volume` is the volume gang's upload: one z-slab of a study
and its dims onto one lane's device, on the stream the gang computes on.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

# the batch keys the drivers stage (host copies kept as <key>_host)
DEFAULT_STAGE_KEYS = ("pixels", "dims")
READY_KEY = "staged_event"


class Stager:
    """Stages batch dicts onto ``device``; one per ingest pipeline.

    Build it on the consumer's thread: the consumer's stream is the current
    stream there. The side stream is the stager's own.
    """

    def __init__(self, device: torch.device, keys: Sequence[str] = DEFAULT_STAGE_KEYS):
        self.device = torch.device(device)
        self.keys = tuple(keys)
        self.copy_stream: Optional[torch.cuda.Stream] = None
        self.consumer_stream: Optional[torch.cuda.Stream] = None
        if self.device.type == "cuda":
            self.copy_stream = torch.cuda.Stream(self.device)
            self.consumer_stream = torch.cuda.current_stream(self.device)

    def __call__(self, item: dict) -> dict:
        return stage_batch(item, self.device, self.keys, self.copy_stream,
                           self.consumer_stream)


def stage_batch(
    item: dict,
    device: torch.device,
    keys: Sequence[str] = DEFAULT_STAGE_KEYS,
    copy_stream: Optional[torch.cuda.Stream] = None,
    consumer_stream: Optional[torch.cuda.Stream] = None,
) -> dict:
    """Stage the named numpy leaves of one batch dict onto ``device``.

    Keys that are None are left alone; each staged key keeps its host array
    as ``<key>_host``. On a CUDA device ``copy_stream`` and
    ``consumer_stream`` are required, and the returned dict carries the
    copies' event under ``READY_KEY`` for :func:`wait_staged`.
    """
    out = dict(item)
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and (copy_stream is None or consumer_stream is None):
        raise ValueError("staging onto the card needs a copy stream and the consumer's stream")
    staged = []
    for k in keys:
        v = out.get(k)
        if v is None:
            continue
        out[f"{k}_host"] = v
        host = torch.from_numpy(np.ascontiguousarray(v))
        if not cuda:
            out[k] = host.clone()
            continue
        pinned = host.pin_memory()
        with torch.cuda.stream(copy_stream):
            dev = pinned.to(device, non_blocking=True)
        dev.record_stream(consumer_stream)
        out[k] = dev
        staged.append(k)
    if staged:
        event = torch.cuda.Event()
        event.record(copy_stream)
        out[READY_KEY] = event
    return out


def wait_staged(item: dict) -> None:
    """Make the current stream wait for the batch's copies (no host wait);
    a CPU batch has nothing to wait for."""
    event = item.get(READY_KEY)
    if event is not None:
        torch.cuda.current_stream().wait_event(event)


def stage_volume(volume: np.ndarray, dims: np.ndarray, device: torch.device,
                 stream: Optional[torch.cuda.Stream] = None):
    """Stage one (D, H, W) float32 stack and its (2,) int32 dims; ``(vol, dims)``.

    The JAX package's ``stage_volume`` places the study on a z-sharded
    mesh; here the gang stages each lane's z-slab with one call. On a CUDA
    device the copies are pinned and non-blocking, issued
    on ``stream`` (required there): the gang's own stream, which its
    program then runs on, so no event is needed between copy and compute.
    On the CPU the arrays become tensors.
    """
    device = torch.device(device)
    host_vol = torch.from_numpy(np.ascontiguousarray(volume, np.float32))
    host_dims = torch.from_numpy(np.ascontiguousarray(dims, np.int32))
    if device.type != "cuda":
        return host_vol.clone(), host_dims.clone()
    if stream is None:
        raise ValueError("staging a volume onto the card needs the gang's stream")
    with torch.cuda.stream(stream):
        return (host_vol.pin_memory().to(device, non_blocking=True),
                host_dims.pin_memory().to(device, non_blocking=True))
