"""Whole-volume serving: one study, one request, one gang dispatch.

The port's counterpart of the JAX package's ``serving/volumes.py``, behind
``POST /v1/segment-volume``. The JAX gang runs the z-sharded program
(``parallel/zshard.py::zshard_volume_callable``) over a mesh built from the
healthy lanes; on a one-lane replica that mesh is one device wide and the
program equals ``process_volume`` on the **dilate** schedule (zshard never
reads ``cfg.grow_algorithm``). The port's gang runs exactly that on one
lane's device: the batched 2D preprocess (one fused kernel launch, or the
median kernel under ``fuse_preprocess=False``), the 3D dilate fixpoint at
``grow_block_iters``/``grow_max_iters``, ``cast_uint8``, ``dilate3d`` at
``morph_size`` and the valid re-mask. The z-sharded multi-card gang is
ROADMAP A6; until then a gang is one lane wide (``z_shards`` 1), on the
first healthy lane, moving to the next one on a lane death.

:class:`VolumeGang` owns

* its **own bounded admission queue**, so bulk volumes shed on their own
  capacity and never take slice-admission slots;
* the batcher's **gang gate**
  (:meth:`~.batcher.DynamicBatcher.gang_parked`): a study waits out the
  in-flight slice window and holds new windows back while it runs;
* **fault-domain integration**: a failure the executor's classifier calls
  a lane fault (deadline, lost card) quarantines the gang's lane through
  the executor and re-runs the study on the next healthy lane (span
  ``volume_requeue``); with no healthy lane left the request sheds with
  :class:`GangUnavailable` (503 + ``Retry-After``). A deterministic error
  goes back to the requester. Never a CPU or plain-op answer in place of
  the card's;
* the fault plan's **``volume`` site** (``dispatch_error``), checked once a
  dispatch attempt with the JAX gang's rules: a rule that selects the
  dispatching lane books that lane's death through the same quarantine
  and re-runs the study on the next healthy lane; a rule without a lane
  selector sheds the request (:class:`GangUnavailable`).

Depth buckets mirror the batch buckets: a study pads with zero planes
(which segment empty) up to the smallest bucket that fits, and the mask is
cropped back to ``[:depth, :h, :w]``. The 3D growth reads one popcount a
block back to the host, which a CUDA graph cannot capture, so a bucket runs
eagerly on the gang's own stream; warmup runs each bucket once, after the
executor has captured its graphs (no gang work may run during a capture).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.ingest.staging import stage_volume
from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import _process_volume
from nm03_capstone_project_tpu_torch.serving.queue import AdmissionQueue
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("serving")

# depth buckets a study pads up into (one warm program each), as the JAX
# package's; the largest is the served depth cap
DEFAULT_VOLUME_DEPTH_BUCKETS: Tuple[int, ...] = (8, 16, 32)


class GangUnavailable(RuntimeError):
    """No healthy lane can serve this volume now; the server sheds it with
    503 + ``Retry-After``, never a mask the gang cannot vouch for."""


@dataclass
class VolumeRequest:
    """One whole-volume request, admission to response.

    ``volume`` is the decoded host (depth, h, w) float32 stack, ``dims``
    the true in-plane (h, w). The gang fills ``mask`` (cropped uint8
    (depth, h, w)), ``converged``, ``z_shards``, ``gang_wait_s`` (or
    ``error``) and sets ``done``.
    """

    request_id: str
    volume: object
    dims: tuple
    depth: int
    t_admitted: float = field(default_factory=time.monotonic)
    trace: object = None  # obs.trace.TraceContext
    t_popped: float = 0.0  # stamped by AdmissionQueue.get_batch
    mask: object = None
    converged: bool = True
    z_shards: int = 0
    gang_wait_s: float = 0.0
    queue_wait_s: float = 0.0
    requeues: int = 0  # re-runs on another lane after a lane death
    lane: Optional[int] = None
    error: Optional[BaseException] = None
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None

    def fail(self, exc: BaseException) -> None:
        self.error = exc
        self.done.set()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        return self.done.wait(timeout_s)


def gang_program(px: torch.Tensor, dm: torch.Tensor, cfg: PipelineConfig) -> Dict[str, torch.Tensor]:
    """The JAX gang's one-device program: ``process_volume`` on the dilate
    schedule, whatever ``cfg.grow_algorithm`` says (JAX
    ``parallel/zshard.py`` grows by dilation only)."""
    return _process_volume(px, dm, dataclasses.replace(cfg, grow_algorithm="dilate"))


class VolumeGang:
    """The gang lane: one thread serving whole-volume requests, one at a time.

    Construction touches no device; the lanes resolve at :meth:`warmup`
    (call it after the executor's own warmup).
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        executor,
        batcher,
        queue_capacity: int = 4,
        depth_buckets: Tuple[int, ...] = DEFAULT_VOLUME_DEPTH_BUCKETS,
        fault_plan=None,
        obs=None,
    ):
        buckets = tuple(int(b) for b in depth_buckets)
        if not buckets or list(buckets) != sorted(set(buckets)):
            raise ValueError(
                f"volume depth buckets must be strictly increasing, got {depth_buckets}"
            )
        if any(b < 1 for b in buckets):
            raise ValueError(f"volume depth buckets must be >= 1, got {buckets}")
        self.fault_plan = fault_plan
        self.obs = obs
        self._seq = itertools.count()  # volume-request ordinals (the `index` selector)
        self.cfg = cfg
        self.executor = executor
        self.batcher = batcher
        self.depth_buckets = buckets
        self.queue = AdmissionQueue(queue_capacity)
        self._warm_width = 0  # the gang's z width, pinned at warmup
        self._streams: Dict[int, torch.cuda.Stream] = {}
        self._streams_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name="nm03-serve-gang", daemon=True)
        self._started = False

    # -- lifecycle ---------------------------------------------------------

    @property
    def max_depth(self) -> int:
        """The deepest study one request may carry (the largest bucket)."""
        return self.depth_buckets[-1]

    @property
    def z_shards(self) -> int:
        """The gang's z width (0 before warmup)."""
        return self._warm_width

    @property
    def default_cost(self) -> int:
        """The slice-equivalent cost a router weighs an unsized volume
        request by (the smallest depth bucket)."""
        return self.depth_buckets[0]

    def _device_pool(self) -> List[Tuple[int, torch.device]]:
        """``[(lane, device)]`` the gang may run on: the healthy lanes."""
        return self.executor.healthy_lane_devices()

    def padded_depth(self, depth: int) -> int:
        """The dispatch depth of a ``depth``-plane study: the smallest
        bucket that fits. Raises ValueError past the largest bucket."""
        for b in self.depth_buckets:
            if depth <= b:
                return b
        raise ValueError(
            f"study of {depth} planes exceeds the largest volume depth bucket {self.max_depth}"
        )

    def _stream(self, lane: int, device: torch.device):
        """The gang's own stream on a lane's device (None on the CPU)."""
        if device.type != "cuda":
            return None
        with self._streams_lock:
            if lane not in self._streams:
                self._streams[lane] = torch.cuda.Stream(device)
            return self._streams[lane]

    @staticmethod
    def _on(device: torch.device, stream):
        """Make ``device`` and the gang's ``stream`` current on this thread
        (a new thread starts on device 0 and its default stream)."""
        if stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(device))
        stack.enter_context(torch.cuda.stream(stream))
        return stack

    def _run_program(self, stack: np.ndarray, dims: np.ndarray, lane: int,
                     device: torch.device, trace=None):
        """Stage, run and gather one padded study on one lane; host
        ``(mask, converged)``. The gather is the one sync the gang adds."""
        stream = self._stream(lane, device)
        dispatch = trace.span("volume_dispatch", lane=lane, z_shards=1) if trace else \
            contextlib.nullcontext()
        gather = trace.span("volume_gather", lane=lane) if trace else contextlib.nullcontext()
        with self._on(device, stream):
            with dispatch:
                vol, dm = stage_volume(stack, dims, device, stream)
                out = gang_program(vol, dm, self.cfg)
            with gather:
                mask = out["mask"].cpu().numpy()
                conv = bool(out["grow_converged"])
        return mask, conv

    def warmup(self) -> Dict[int, float]:
        """Run every depth bucket once on zeros with ``min_dim`` dims, on
        the first healthy lane; ``{bucket: seconds}``. Call after the
        executor's warmup. A bucket that fails raises."""
        pool = self._device_pool()
        if not pool:
            raise GangUnavailable("no healthy lane to warm the volume gang on")
        lane, device = pool[0]
        c = self.cfg.canvas
        timings = {}
        for b in self.depth_buckets:
            t0 = time.perf_counter()
            self._run_program(np.zeros((b, c, c), np.float32),
                              np.asarray([self.cfg.min_dim, self.cfg.min_dim], np.int32),
                              lane, device)
            timings[b] = round(time.perf_counter() - t0, 3)
        # one lane wide until the z-sharded mesh is ported (ROADMAP A6)
        self._warm_width = 1
        return timings

    def start(self) -> "VolumeGang":
        self._started = True
        self._thread.start()
        return self

    def join(self, timeout_s: Optional[float] = None) -> bool:
        """Wait for the gang to drain (close its queue first)."""
        if not self._started:
            return True
        self._thread.join(timeout=timeout_s)
        return not self._thread.is_alive()

    # -- admission ---------------------------------------------------------

    def submit(self, volume: np.ndarray, dims: Tuple[int, int],
               trace_id: Optional[str] = None) -> VolumeRequest:
        """Admit one decoded study; QueueFull/QueueClosed shed at the door.

        Depth guards are the caller's (the server answers 413 before
        admission); this validates only what the gang depends on.
        """
        from nm03_capstone_project_tpu_torch.obs.trace import TraceContext, new_trace_id

        depth = int(volume.shape[0])
        self.padded_depth(depth)  # raises past the largest bucket
        req = VolumeRequest(
            request_id=uuid.uuid4().hex[:12],
            volume=volume,
            dims=(int(dims[0]), int(dims[1])),
            depth=depth,
            trace=TraceContext(trace_id or new_trace_id()),
        )
        self.queue.put(req)  # raises QueueFull / QueueClosed
        return req

    # -- the gang loop -----------------------------------------------------

    def _run(self) -> None:
        while True:
            batch = self.queue.get_batch(1, 0.0)
            if not batch:  # closed and empty: drain complete
                return
            req = batch[0]
            try:
                self._execute(req)
            except BaseException as e:  # noqa: BLE001 — the loop must survive
                if not req.done.is_set():
                    req.fail(e)

    def _fire_fault(self, seq: int, lane: int):
        """Consult the ``volume`` fault site for the dispatching lane; the
        fired rule or None. A ``lane``-selected rule fires exactly when its
        lane dispatches (the deterministic "the lane dies mid-volume"
        drill); one without a lane selector blames no lane (an
        unattributable failure: the gang sheds rather than guess). The JAX
        gang checks every lane of its mesh; the port's is one lane wide."""
        plan = self.fault_plan
        if plan is None or not plan.has_site("volume"):
            return None
        return plan.fire("volume", obs=self.obs, index=seq, lane=lane)

    def _execute(self, req: VolumeRequest) -> None:
        now = time.monotonic()
        req.queue_wait_s = max(now - req.t_admitted, 0.0)
        if req.trace is not None:
            req.trace.add_span("queue_wait", req.t_admitted, req.t_popped or now)
        seq = next(self._seq)
        t_gang0 = time.monotonic()
        with self.batcher.gang_parked():
            t_acquired = time.monotonic()
            req.gang_wait_s = t_acquired - t_gang0
            if req.trace is not None:
                req.trace.add_span("volume_gang_acquire", t_gang0, t_acquired)
            try:
                self._dispatch_volume(req, seq)
            except BaseException as e:  # noqa: BLE001 — per-request containment
                req.fail(e)
                return
        req.done.set()

    def _dispatch_volume(self, req: VolumeRequest, seq: int) -> None:
        """Run the study on the first healthy lane; on a lane fault (or an
        injected one that names the lane), quarantine that lane and re-run
        on the next one."""
        c = self.cfg.canvas
        h, w = req.dims
        # zero filler planes segment empty, so cropping [:depth] gives the
        # unpadded study's mask
        stack = np.zeros((self.padded_depth(req.depth), c, c), np.float32)
        stack[: req.depth, :h, :w] = req.volume
        dims = np.asarray([h, w], np.int32)
        excluded: set = set()
        # one hop a lane the pool started with, plus one: bounded even
        # against flapping lanes
        hops_left = len(self._device_pool()) + 1
        while True:
            hops_left -= 1
            if hops_left < 0:
                raise GangUnavailable(
                    "volume request exhausted its re-dispatch budget (lanes are "
                    "flapping; see serving_lane_quarantines_total)"
                )
            pool = [(ln, d) for ln, d in self._device_pool() if ln not in excluded]
            if not pool:
                raise GangUnavailable("no healthy lane left to run the volume on")
            lane, device = pool[0]
            rule = self._fire_fault(seq, lane)
            if rule is not None:
                if rule.lane is None:
                    raise GangUnavailable(
                        "injected unattributable volume failure (volume dispatch_error)"
                    )
                # the drill's deterministic lane death: book it through the
                # real quarantine machine and re-run on the next lane
                log.warning("volume %s: injected death of lane %d mid-volume; "
                            "re-dispatching", req.request_id, lane)
                self.executor.quarantine_lane(lane, "device_lost")
                excluded.add(lane)
                self._note_requeue(req, lane, "injected_device_lost")
                continue
            sup = self.executor.new_supervisor()
            trace = req.trace
            try:
                mask, conv = sup.run(
                    lambda: self._run_program(stack, dims, lane, device, trace),
                    label="volume_dispatch",
                )
            except BaseException as e:  # noqa: BLE001 — classified below
                cause = self.executor._quarantine_cause(e)
                if cause is None:
                    raise  # deterministic failure: the requester's
                # one lane ran the whole study: the fault is that lane's
                log.warning("volume %s: lane %d failed (%s); re-dispatching",
                            req.request_id, lane, cause)
                self.executor.quarantine_lane(lane, cause)
                excluded.add(lane)
                self._note_requeue(req, lane, cause)
                continue
            req.mask = np.ascontiguousarray(mask[: req.depth, :h, :w])
            req.converged = conv
            req.z_shards = 1
            req.lane = lane
            return

    def _note_requeue(self, req: VolumeRequest, lane, cause: str) -> None:
        req.requeues += 1
        if req.trace is not None:
            t = time.monotonic()
            req.trace.add_span("volume_requeue", t, t, lane=lane, cause=cause)

    # -- status ------------------------------------------------------------

    def status(self) -> dict:
        """The ``/readyz`` ``volumes`` block."""
        return {
            "enabled": True,
            "depth_buckets": list(self.depth_buckets),
            "max_depth": self.max_depth,
            "z_shards": self.z_shards,
            "queue_depth": len(self.queue),
            "queue_capacity": self.queue.capacity,
            "distributed": False,
            "default_cost": self.default_cost,
        }
