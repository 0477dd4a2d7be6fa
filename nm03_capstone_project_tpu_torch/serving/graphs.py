"""One CUDA graph per (lane, batch bucket): the warm serving program.

The JAX package warms one AOT-compiled executable per (lane, bucket)
(``compilehub/programs.py::serve_mask``) so a serve-time dispatch is a
lookup plus an execute. Eager PyTorch has no compile step to amortize, but
it pays the host for every one of the ~20 small ops around the kernels of
a batch (``pipeline/slice_pipeline.py::_process``), and at one to
sixteen slices a batch that host work is the batch's whole cost. A
:class:`BucketGraph` captures ``_process`` once, at the bucket's shape, on
static device buffers:

* in: pixels ``(bucket, canvas, canvas)`` float32 and dims ``(bucket, 2)``
  int32, each with a pinned host twin the batch is written into;
* out: the uint8 mask and the bool ``grow_converged``, each copied back
  into a pinned host twin.

A replay (:meth:`BucketGraph.launch`) is then four asynchronous copies
and one ``cudaGraphLaunch`` on the lane's stream; :meth:`BucketGraph.fetch`
waits on an event recorded after the copy back. The fused preprocess and
grow kernels, the seed/valid and finish kernels (and the standalone
median kernel under ``fuse_preprocess=False``) are kernel nodes of the
graph; the grow
kernel's thread-block cluster launch (``cudaLaunchKernelEx``) is captured
as a cluster kernel node.

Capture rules the class keeps:

* the kernels are built (``nvcc``) and their one-time
  ``cudaFuncSetAttribute`` runs before capture: two eager iterations of
  ``_process`` on the lane's stream first (PyTorch's recipe);
* nothing in ``_process`` reads host memory at replay: the fused kernel's
  sharpen taps go by value in its parameter block, the wrappers launch on
  the current stream, and no plain op with a host sync is on the path
  (the plain grow syncs every step; it runs only for CPU tensors; the
  jump schedule syncs every round, so a graph refuses it);
* every graph of a lane shares one memory pool: the lane replays one graph
  at a time (the executor holds the lane's lock around launch and fetch),
  so a later graph may reuse an earlier one's intermediates, never its
  live outputs.

Under ``--sanitize`` each stage's finite flag (:mod:`..utils.sanitize`)
is one more output of the graph, checked after the replay's fetch, and a
capture counts into the recompile watchdog.

A capture that fails raises; nothing runs eagerly in its place. The
kernel wrappers' ``.launches`` counters tick at capture only; the graph
records how many launches of each kernel it holds (:attr:`kernels`) and
counts its replays, so launches under serving are replays × kernels.

At capture the graph also records its device bytes (:attr:`memory`, the
device-time ledger's HBM table, in place of the JAX package's
``executable_cost``): ``argument_bytes`` (the static inputs),
``output_bytes`` (the static outputs), ``temp_bytes`` (the most the
capture held allocated at once beyond the outputs: the intermediates, in
the lane's graph pool) and ``peak_hbm_bytes`` (the inputs plus that most,
outputs included).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.ops import launches
from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import _process
from nm03_capstone_project_tpu_torch.utils import sanitize

# the kernel wrappers a serving graph may hold, by the names chip_smoke.py
# and PERF.md use
KERNELS = launches.KERNELS
EAGER_ITERS = 2  # eager runs on the capture stream before capture


def kernel_launches() -> Dict[str, int]:
    """Each kernel wrapper's launch count so far."""
    return launches.launch_counts()


class BucketGraph:
    """``_process`` at one bucket's shape, captured once, replayed per batch.

    ``pool`` is the lane's shared graph memory pool
    (``torch.cuda.graph_pool_handle()``) and ``stream`` the lane's CUDA
    stream; both belong to ``device``. Raises ValueError for a device that
    is not CUDA: a CPU tensor has no graph to replay.
    """

    def __init__(self, cfg: PipelineConfig, bucket: int, device, pool, stream):
        if cfg.grow_algorithm != "dilate":
            # its loop reads a flag back to the host every round
            raise ValueError(
                f"grow_algorithm={cfg.grow_algorithm!r} syncs the host each round, "
                "which a CUDA graph cannot capture; serve with 'dilate' (the grow kernel)"
            )
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(
                f"BucketGraph captures CUDA work; got device {dev} (the CPU runs "
                "the plain ops eagerly, without a graph)"
            )
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1, got {bucket}")
        c = cfg.canvas
        self.cfg = cfg
        self.bucket = int(bucket)
        self.device = dev
        self.pool = pool
        self.stream = stream
        self.pixels = torch.zeros((bucket, c, c), dtype=torch.float32, device=dev)
        self.dims = torch.full((bucket, 2), cfg.min_dim, dtype=torch.int32, device=dev)
        # nm03-lint: disable=NM401 the graph's own staging: static buffers and their pinned twins, filled before each replay
        self.host_pixels = torch.zeros((bucket, c, c), dtype=torch.float32).pin_memory()
        # nm03-lint: disable=NM401 the graph's own staging: static buffers and their pinned twins, filled before each replay
        self.host_dims = torch.zeros((bucket, 2), dtype=torch.int32).pin_memory()
        # nm03-lint: disable=NM401 the graph's own staging: static buffers and their pinned twins, filled before each replay
        self.host_mask = torch.zeros((bucket, c, c), dtype=torch.uint8).pin_memory()
        # nm03-lint: disable=NM401 the graph's own staging: static buffers and their pinned twins, filled before each replay
        self.host_conv = torch.zeros((bucket,), dtype=torch.bool).pin_memory()
        self.graph = torch.cuda.CUDAGraph()
        self.mask = None  # static outputs, set by capture()
        self.converged = None
        self.kernels: Dict[str, int] = {}
        self.capture_s = None
        self.memory: Dict[str, int] = {}
        self.replays = 0
        self.finite_flags = []  # --sanitize: (stage, flag) outputs of the graph
        self._done = torch.cuda.Event()

    def capture(self) -> float:
        """Warm the kernels eagerly, then capture ``_process``; seconds."""
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            self.stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self.stream):
                for _ in range(EAGER_ITERS):
                    _process(self.pixels, self.dims, self.cfg)
            self.stream.synchronize()
            before = kernel_launches()
            torch.cuda.reset_peak_memory_stats(self.device)
            held0 = torch.cuda.memory_allocated(self.device)
            with sanitize.capture_checks() as flags, torch.cuda.graph(
                    self.graph, pool=self.pool, stream=self.stream):
                out = _process(self.pixels, self.dims, self.cfg)
            after = kernel_launches()
            torch.cuda.synchronize()
            peak = max(torch.cuda.max_memory_allocated(self.device) - held0, 0)
        self.mask, self.converged = out["mask"], out["grow_converged"]
        # nm03-lint: disable=NM331 BucketGraph is driven under its lane's lock: WarmExecutor.run_batch holds it around launch and fetch, and capture runs at warmup before any request
        self.finite_flags = flags
        sanitize.note_compile("graph", f"bucket {self.bucket} on {self.device}")
        # nm03-lint: disable=NM331 BucketGraph is driven under its lane's lock: WarmExecutor.run_batch holds it around launch and fetch, and capture runs at warmup before any request
        self.kernels = {k: after[k] - before[k] for k in KERNELS if after[k] > before[k]}
        args = self.pixels.nbytes + self.dims.nbytes
        outs = self.mask.nbytes + self.converged.nbytes
        # nm03-lint: disable=NM331 BucketGraph is driven under its lane's lock: WarmExecutor.run_batch holds it around launch and fetch, and capture runs at warmup before any request
        self.memory = {"argument_bytes": args, "output_bytes": outs,
                       "temp_bytes": max(peak - outs, 0), "peak_hbm_bytes": args + peak}
        # nm03-lint: disable=NM331 BucketGraph is driven under its lane's lock: WarmExecutor.run_batch holds it around launch and fetch, and capture runs at warmup before any request
        self.capture_s = time.perf_counter() - t0
        return self.capture_s

    def launch(self, pixels: np.ndarray, dims: np.ndarray) -> None:
        """Stage one padded batch and replay the graph, without waiting.

        The caller serializes launch and fetch (the executor's lane lock):
        the pinned buffers and the pool are the lane's, one batch at a time.
        """
        if self.mask is None:
            raise RuntimeError(f"bucket {self.bucket}: replay before capture")
        if pixels.shape != tuple(self.host_pixels.shape) or dims.shape != (self.bucket, 2):
            raise ValueError(
                f"bucket {self.bucket} takes pixels {tuple(self.host_pixels.shape)} and "
                f"dims ({self.bucket}, 2), got {pixels.shape} and {dims.shape}"
            )
        # nm03-lint: disable=NM322 a pinned host tensor's .numpy() is a view of host memory, no device sync
        np.copyto(self.host_pixels.numpy(), pixels, casting="same_kind")
        # nm03-lint: disable=NM322 a pinned host tensor's .numpy() is a view of host memory, no device sync
        np.copyto(self.host_dims.numpy(), dims, casting="same_kind")
        with torch.cuda.stream(self.stream):
            # nm03-lint: disable=NM401 the graph's own staging: static buffers and their pinned twins, filled before each replay
            self.pixels.copy_(self.host_pixels, non_blocking=True)
            # nm03-lint: disable=NM401 the graph's own staging: static buffers and their pinned twins, filled before each replay
            self.dims.copy_(self.host_dims, non_blocking=True)
            self.graph.replay()
            # nm03-lint: disable=NM401 the graph's own staging: static buffers and their pinned twins, filled before each replay
            self.host_mask.copy_(self.mask, non_blocking=True)
            # nm03-lint: disable=NM401 the graph's own staging: static buffers and their pinned twins, filled before each replay
            self.host_conv.copy_(self.converged, non_blocking=True)
            self._done.record(self.stream)
        # nm03-lint: disable=NM331 BucketGraph is driven under its lane's lock: WarmExecutor.run_batch holds it around launch and fetch, and capture runs at warmup before any request
        self.replays += 1

    def fetch(self):
        """Wait for the last replay; host copies of ``(mask, converged)``.
        Under ``--sanitize`` the replay's stage flags are checked first."""
        self._done.synchronize()
        sanitize.raise_if_nonfinite(self.finite_flags)
        return self.host_mask.numpy().copy(), self.host_conv.numpy().copy()

    def stats(self) -> dict:
        return {"capture_s": self.capture_s, "replays": self.replays,
                "kernels": dict(self.kernels)}


def record_kernel_sequence(cfg: PipelineConfig, bucket: int, device, stream=None):
    """``[(op name, stage)]`` of one eager ``_process`` run at the bucket's
    shape, on zeros with ``min_dim`` dims, recorded under the profiler with
    the pipeline's stage ranges on (:func:`..obs.ledger.kernel_sequence`).

    On a card it runs on ``stream`` and the ops are its kernels, in the
    order a replay of the bucket's graph launches them; on the CPU they
    are the ATen ops. Takes the process's one profiler lock (raises
    ``ProfileBusy`` when another capture holds it).
    """
    import contextlib
    import json
    import os
    import tempfile

    from nm03_capstone_project_tpu_torch.obs.ledger import kernel_sequence
    from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import stage_ranges
    from nm03_capstone_project_tpu_torch.utils.profiling import exclusive_profiler

    dev = torch.device(device)
    c = cfg.canvas
    px = torch.zeros((bucket, c, c), dtype=torch.float32, device=dev)
    dm = torch.full((bucket, 2), cfg.min_dim, dtype=torch.int32, device=dev)
    on_stream = (torch.cuda.stream(stream) if stream is not None
                 else contextlib.nullcontext())
    with exclusive_profiler() as prof:
        with on_stream, stage_ranges():
            _process(px, dm, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    fd, path = tempfile.mkstemp(prefix="nm03_seq_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents") or []
    finally:
        os.unlink(path)
    return kernel_sequence(events)
