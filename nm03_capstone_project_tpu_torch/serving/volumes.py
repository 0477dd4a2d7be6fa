"""Whole-volume serving: one study, one request, one gang dispatch.

The port of the JAX package's ``serving/volumes.py``, behind
``POST /v1/segment-volume``. The gang runs the z-sharded volume program
(:func:`..parallel.zshard.zshard_volume_callable`, the one the
``nm03-volume --z-shard`` driver runs, so the served mask equals the
driver's by construction) over a z-mesh of the healthy lanes' devices: the
study splits into one slab a lane, each slab preprocesses on its lane's
device (one fused kernel launch a slab, or the median kernel under
``fuse_preprocess=False``), and the 3D dilate fixpoint and the final
dilation exchange halo planes between neighbouring slabs. The program
grows by dilation whatever ``cfg.grow_algorithm`` says, as the JAX
program does. On a one-lane replica the mesh is one device wide and the
program is ``process_volume`` on the dilate schedule.

:class:`VolumeGang` owns

* its **own bounded admission queue**, so bulk volumes shed on their own
  capacity and never take slice-admission slots;
* the batcher's **gang gate**
  (:meth:`~.batcher.DynamicBatcher.gang_parked`): a study waits out the
  in-flight slice window and holds new windows back while it runs;
* **fault-domain integration**: the mesh is built from the executor's
  healthy lanes at dispatch time. A lane fault (deadline, lost card) on a
  one-lane mesh quarantines that lane and re-runs the study on the next
  one; on a wider mesh the study re-meshes onto the survivors when the
  fleet has booked a death meanwhile, and sheds (:class:`GangUnavailable`,
  503 + ``Retry-After``) when no lane can be blamed. Every re-run is a
  ``volume_requeue`` span. A deterministic error goes back to the
  requester. Never a CPU or plain-op answer in place of the card's;
* the fault plan's **``volume`` site** (``dispatch_error``), checked once a
  dispatch attempt for every lane of the mesh, with the JAX gang's rules:
  a rule that selects a lane of the mesh books that lane's death through
  the same quarantine and re-meshes onto the survivors; a rule without a
  lane selector sheds the request.

**Across processes** (``--distributed-init`` in a ``torch.distributed``
job, :func:`distributed_gang_program`): the z-mesh is the job's
process-group mesh, one device a rank
(:func:`..parallel.distributed.global_mesh`). Rank 0 runs HTTP and this
gang; every other rank runs :func:`.follower.follow`. For each dispatch
rank 0 broadcasts a fixed-size header, on the host over gloo, and the
study (:func:`..parallel.distributed.broadcast_study`), then every rank
runs the z-sharded program over the process group. An idle gang
broadcasts a keepalive header well inside the process group's timeout.
Global devices carry no lane id, so the gang blames no lane: a failed
cross-process dispatch (a follower's death) marks the gang down, that
request and every later one shed with 503 + ``Retry-After``, and
``status()`` says why; slices keep serving on rank 0's lanes. A follower
lost between dispatches fails the next header (gloo raises when a peer's
socket closes). One lost during a study is caught by the study's bound
(``bound_s``, the server's ``--volume-timeout-s``): the study and its
collectives run on the job's data-plane group
(:func:`..parallel.distributed.open_data_plane`), whose timeout is that
bound, and when a study outlasts it rank 0 marks the gang down, aborts the
data plane's communicator (:func:`..parallel.distributed.abort_data_plane`)
and fails the request with :class:`GangUnavailable`, while its slice lanes
keep serving. A follower bounds its studies the same way and exits
non-zero (:func:`.follower.follow`).

Depth buckets mirror the batch buckets: a study pads with zero planes
(which segment empty) up to the smallest bucket that fits, rounded up to a
multiple of the mesh width (:meth:`VolumeGang.padded_depth`), and the mask
is cropped back to ``[:depth, :h, :w]``. The mesh is as wide as the halo
allows (:meth:`VolumeGang._usable_shards`). The 3D growth reads one
popcount a block back to the host, which a CUDA graph cannot capture, so a
study runs eagerly on the gang's own stream of each card; warmup runs each
bucket once at the width dispatch will use, after the executor has
captured its graphs (no gang work may run during a capture). Eager
PyTorch compiles nothing per shape or width, so a re-mesh onto survivors
never needs a warmup while it holds the gang.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.ingest.staging import stage_volume
from nm03_capstone_project_tpu_torch.parallel import distributed
from nm03_capstone_project_tpu_torch.parallel.mesh import Mesh, make_mesh
from nm03_capstone_project_tpu_torch.parallel.zshard import (
    _check_depth,
    process_volume_zsharded,
    zshard_volume_callable,
)
from nm03_capstone_project_tpu_torch.serving.queue import AdmissionQueue
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

if TYPE_CHECKING:  # the lock-order analysis resolves the gang's calls through them
    from nm03_capstone_project_tpu_torch.serving.batcher import DynamicBatcher
    from nm03_capstone_project_tpu_torch.serving.executor import WarmExecutor

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
    requeues: int = 0  # re-runs on the survivors after a lane death
    lane: Optional[int] = None  # the mesh's first lane
    lanes: List[int] = field(default_factory=list)  # every lane of the mesh
    error: Optional[BaseException] = None
    done: threading.Event = field(default_factory=threading.Event)

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None

    def fail(self, exc: BaseException) -> None:
        # nm03-lint: disable=NM331 release ordering via the Event (ServeRequest.fail's contract)
        self.error = exc
        self.done.set()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        return self.done.wait(timeout_s)


def gang_program(shards: List[torch.Tensor], dm: torch.Tensor,
                 cfg: PipelineConfig) -> Dict[str, object]:
    """The gang's program: the z-sharded volume program over the devices
    the slabs lie on (one slab a lane, in z order), on the dilate schedule
    whatever ``cfg.grow_algorithm`` says (JAX ``parallel/zshard.py``
    grows by dilation only)."""
    mesh = make_mesh(axis_names=("z",), devices=[s.device for s in shards])
    return zshard_volume_callable(mesh, dataclasses.replace(cfg, grow_algorithm="dilate"))(
        shards, dm)


def distributed_gang_program(stack: torch.Tensor, dims, cfg: PipelineConfig):
    """One cross-process gang dispatch, run by every rank of the job after
    :func:`..parallel.distributed.broadcast_study`: the z-sharded program
    over the job's process-group mesh (one slab a rank, the process-group
    transport also in a world of 1), on the dilate schedule. Returns the
    whole (D, H, W) mask, gathered on every rank, and the 0-d converged
    flag."""
    g = distributed.global_mesh(("z",))
    mesh = Mesh(g.devices, ("z",), process_group=True)
    out = process_volume_zsharded(stack, dims, dataclasses.replace(cfg, grow_algorithm="dilate"),
                                  mesh)
    return out["mask"], out["grow_converged"]


@contextlib.contextmanager
def _dispatch_span(trace, lane, z_shards: int):
    """The ``volume_dispatch`` span of one study, which also carries the
    host's split of it: ``stage_s`` (the study to the devices: the slabs'
    copies, or across a job the study's broadcast) up to the time the
    block appends to the yielded list, and ``program_s`` (the z-sharded
    program) after it. Recorded when the block fails, too."""
    t0, marks = time.monotonic(), []
    try:
        yield marks
    finally:
        if trace is not None:
            t1 = time.monotonic()
            split = ({"stage_s": round(marks[0] - t0, 6), "program_s": round(t1 - marks[0], 6)}
                     if marks else {})
            trace.add_span("volume_dispatch", t0, t1, lane=lane, z_shards=z_shards, **split)


# an idle cross-process gang's keepalive period: a tenth of the process
# group's timeout, so a follower's wait for the next dispatch never ends it
KEEPALIVE_S = distributed.DEFAULT_TIMEOUT_S / 10


class VolumeGang:
    """The gang lane: one thread serving whole-volume requests, one at a
    time, each over a z-mesh of the healthy lanes.

    Construction touches no device; the lanes resolve at :meth:`warmup`
    (call it after the executor's own warmup).
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        executor: "WarmExecutor",
        batcher: "DynamicBatcher",
        queue_capacity: int = 4,
        depth_buckets: Tuple[int, ...] = DEFAULT_VOLUME_DEPTH_BUCKETS,
        fault_plan=None,
        obs=None,
        distributed: bool = False,
        bound_s: Optional[float] = None,
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
        self._warm_width = 0  # the full-mesh z width, pinned at warmup
        self._streams: Dict[int, torch.cuda.Stream] = {}
        self._streams_lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name="nm03-serve-gang", daemon=True)
        self._started = False
        # --distributed-init: in a job, the mesh spans the job's ranks
        self.distributed = bool(distributed)
        # one broadcast sequence at a time: a dispatch, a keepalive, the stop
        self._collective = threading.Lock()
        self._down: Optional[str] = None  # why the cross-process gang stopped
        self._down_lock = threading.Lock()  # the bound's timer marks it down too
        # a cross-process study's bound (the server's --volume-timeout-s)
        self.bound_s = None if bound_s is None else float(bound_s)
        self._stopped = threading.Event()
        self._keepalive = threading.Thread(target=self._keepalive_loop,
                                           name="nm03-serve-gang-keepalive", daemon=True)

    # -- lifecycle ---------------------------------------------------------

    @property
    def max_depth(self) -> int:
        """The deepest study one request may carry (the largest bucket)."""
        return self.depth_buckets[-1]

    @property
    def z_shards(self) -> int:
        """The full-mesh z width (0 before warmup): the largest width any
        bucket dispatches at over the lanes warmup saw."""
        return self._warm_width

    @property
    def default_cost(self) -> int:
        """The slice-equivalent cost a router weighs an unsized volume
        request by (the smallest depth bucket)."""
        return self.depth_buckets[0]

    @property
    def in_job(self) -> bool:
        """Whether the mesh spans the ranks of a ``torch.distributed`` job."""
        return self.distributed and distributed.is_initialized()

    def _device_pool(self) -> List[Tuple[int, torch.device]]:
        """``[(lane, device)]`` the next mesh is built from: the healthy
        lanes."""
        return self.executor.healthy_lane_devices()

    def padded_depth(self, depth: int, n_shards: int = 1) -> int:
        """The dispatch depth of a ``depth``-plane study on ``n_shards``:
        the smallest bucket that fits, rounded up to a multiple of
        ``n_shards`` (the extra planes are zero filler, which segments
        empty, as the driver's divisibility pad). Raises ValueError past
        the largest bucket."""
        for b in self.depth_buckets:
            if depth <= b:
                return -(-b // n_shards) * n_shards
        raise ValueError(
            f"study of {depth} planes exceeds the largest volume depth bucket {self.max_depth}"
        )

    def _usable_shards(self, pool_size: int, depth: int) -> int:
        """The widest mesh <= ``pool_size`` whose slabs are at least as
        deep as the final dilation's halo (``morph_size // 2``)."""
        halo = self.cfg.morph_size // 2
        n = max(pool_size, 1)
        while n > 1 and self.padded_depth(depth, n) // n < max(halo, 1):
            n -= 1
        return n

    def _stream(self, lane: int, device: torch.device):
        """The gang's own stream on a lane's device (None on the CPU)."""
        if device.type != "cuda":
            return None
        with self._streams_lock:
            if lane not in self._streams:
                self._streams[lane] = torch.cuda.Stream(device)
            return self._streams[lane]

    def _mesh_streams(self, pool) -> List[Optional[torch.cuda.Stream]]:
        """One stream a slab: the gang's stream of the FIRST lane on each
        device, so the slabs of lanes that share a card (a repeated-device
        mesh) are staged and computed in one order on one stream."""
        first: Dict[str, Optional[torch.cuda.Stream]] = {}
        out = []
        for lane, dev in pool:
            key = str(dev)
            if key not in first:
                first[key] = self._stream(lane, dev)
            out.append(first[key])
        return out

    def _run_program(self, stack: np.ndarray, dims: np.ndarray, lanes: List[int],
                     devices: List[torch.device], trace=None):
        """Stage, run and gather one padded study over the lanes' z-mesh;
        host ``(mask, converged)``. The gather is the one sync the gang
        adds."""
        pool = list(zip(lanes, devices))
        streams = self._mesh_streams(pool)
        n = len(pool)
        d = stack.shape[0] // n
        gather = (trace.span("volume_gather", lane=lanes[0]) if trace
                  else contextlib.nullcontext())
        with contextlib.ExitStack() as current:
            # the gang's stream is current on every card of the mesh (a new
            # thread starts on device 0 and its default stream)
            for st in {id(st): st for st in streams if st is not None}.values():
                current.enter_context(torch.cuda.stream(st))
            with _dispatch_span(trace, lanes[0], n) as marks:
                staged = [stage_volume(stack[i * d:(i + 1) * d], dims, dev, st)
                          for i, (dev, st) in enumerate(zip(devices, streams))]
                marks.append(time.monotonic())
                out = gang_program([v for v, _ in staged], staged[0][1], self.cfg)
            with gather:
                mask = np.concatenate([m.cpu().numpy() for m in out["mask"]])
                conv = bool(out["grow_converged"])
        return mask, conv

    def _run_distributed(self, stack: np.ndarray, dims: np.ndarray, trace=None,
                         req: Optional[VolumeRequest] = None):
        """:meth:`_run_program` across the job: broadcast the study, run
        :func:`distributed_gang_program` with the followers, fetch the mask.
        Any failure marks the gang down and sheds (:class:`GangUnavailable`):
        after a collective failed, the ranks' places in the op sequence can
        no longer be trusted. So does a study that outlasts ``bound_s``
        (:meth:`_bound_passed`), whatever its collectives return after."""
        # refused here, before any collective, so that no follower meets it
        _check_depth(stack.shape[0], distributed.process_count(), self.cfg)
        dev = distributed.local_device()
        st = self._stream(None, dev)
        gather = trace.span("volume_gather", lane=None) if trace else contextlib.nullcontext()
        with self._collective:
            if self._down is not None:
                raise GangUnavailable(f"the cross-process volume gang is down ({self._down})")
            try:
                with distributed.bounded_study(self.bound_s,
                                               lambda: self._bound_passed(req)) as passed:
                    with (torch.cuda.stream(st) if st is not None
                          else contextlib.nullcontext()):
                        with _dispatch_span(trace, None, distributed.process_count()) as marks:
                            _, vol, dm = distributed.broadcast_study(
                                distributed.OP_STUDY, stack, dims)
                            marks.append(time.monotonic())
                            mask, conv = distributed_gang_program(vol, dm, self.cfg)
                        with gather:
                            # nm03-lint: disable=NM422 the mask's fetch ends the study's device work inside the one broadcast sequence the collective lock exists to serialize (no keepalive may interleave)
                            out = mask.cpu().numpy(), bool(conv)
                if passed.is_set():  # an aborted communicator's data is not a mask
                    raise GangUnavailable(f"the study passed its bound of {self.bound_s:g}s")
                return out
            except BaseException as e:  # noqa: BLE001 — the job is broken either way
                self._mark_down(f"{type(e).__name__}: {e}")
                raise GangUnavailable(
                    f"cross-process volume dispatch failed ({type(e).__name__}); the gang "
                    "is down until the job restarts") from e

    def _bound_passed(self, req: Optional[VolumeRequest]) -> None:
        """A cross-process study outlasted ``bound_s`` (a follower lost or
        stopped mid-study): mark the gang down and fail the request now
        (503 + ``Retry-After``); :func:`..parallel.distributed.bounded_study`
        then aborts the data plane's communicator so the blocked
        collectives return. The process and its slice lanes live on; every
        later study sheds."""
        self._mark_down(f"a study passed its bound of {self.bound_s:g}s (--volume-timeout-s)")
        if req is not None and not req.done.is_set():
            req.fail(GangUnavailable(
                f"the cross-process study passed its bound of {self.bound_s:g}s; the gang "
                "is down until the job restarts"))

    def _mark_down(self, cause: str) -> None:
        with self._down_lock:
            if self._down is None:
                self._down = cause
                log.error("volume gang: the cross-process gang is down: %s", cause)

    def _keepalive_loop(self) -> None:
        """Keep the followers' wait for the next dispatch alive while idle,
        and notice a follower's death before the next study does."""
        while not self._stopped.wait(KEEPALIVE_S):
            with self._collective:
                if self._down is not None or self._stopped.is_set():
                    return
                try:
                    distributed.broadcast_study(distributed.OP_KEEPALIVE)
                except BaseException as e:  # noqa: BLE001 — recorded, then shed
                    self._mark_down(f"keepalive: {type(e).__name__}: {e}")
                    return

    def close(self, timeout_s: float = 10.0) -> None:
        """End the followers' loop with the stop op (rank 0 of a job,
        unless the gang is down); a no-op outside a job. Call after
        :meth:`join`: a dispatch still holding the collectives past
        ``timeout_s`` leaves the followers to their own timeout."""
        self._stopped.set()
        if not self.in_job or distributed.process_index() != 0:
            return
        if not self._collective.acquire(timeout=timeout_s):
            log.warning("volume gang: a dispatch still holds the collectives; "
                        "the followers get no stop")
            return
        try:
            if self._down is None:
                distributed.broadcast_study(distributed.OP_STOP)
                # nm03-lint: disable=NM331 under _collective, acquired just above with a timeout
                self._down = "stopped"
        except BaseException as e:  # noqa: BLE001 — closing either way
            self._mark_down(f"stop: {type(e).__name__}: {e}")
        finally:
            self._collective.release()

    def warmup(self) -> Dict[int, float]:
        """Run every depth bucket once on zeros with ``min_dim`` dims, at
        the mesh width dispatch will use for it (``_usable_shards`` depends
        on the bucket when the halo limits shallow ones; in a job it is
        every rank); ``{bucket: seconds}``. Call after the executor's
        warmup. A bucket that fails raises."""
        pool = [] if self.in_job else self._device_pool()
        if not pool and not self.in_job:
            raise GangUnavailable("no healthy lane to warm the volume gang on")
        c = self.cfg.canvas
        dims = np.asarray([self.cfg.min_dim, self.cfg.min_dim], np.int32)
        timings, width = {}, 0
        for b in self.depth_buckets:
            n = distributed.process_count() if self.in_job else self._usable_shards(len(pool), b)
            width = max(width, n)
            stack = np.zeros((self.padded_depth(b, n), c, c), np.float32)
            t0 = time.perf_counter()
            if self.in_job:
                self._run_distributed(stack, dims)
            else:
                self._run_program(stack, dims, [ln for ln, _ in pool[:n]],
                                  [d for _, d in pool[:n]])
            timings[b] = round(time.perf_counter() - t0, 3)
        # nm03-lint: disable=NM331 single writer: warmup() runs once on the startup thread before start(); /readyz readers see 0 (warming) or the final width
        self._warm_width = width
        return timings

    def _padded_stack(self, volume: np.ndarray, depth: int, n_shards: int) -> np.ndarray:
        """``volume`` in the corner of a zero (padded depth, canvas, canvas)
        stack: zero filler planes segment empty, so cropping the mask back
        to ``[:depth, :h, :w]`` gives the unpadded study's."""
        c = self.cfg.canvas
        stack = np.zeros((self.padded_depth(depth, n_shards), c, c), np.float32)
        stack[:depth, :volume.shape[1], :volume.shape[2]] = volume
        return stack

    def start(self) -> "VolumeGang":
        # nm03-lint: disable=NM331 owner-thread write before _thread.start(); the start() fence orders it
        self._started = True
        self._thread.start()
        if self.in_job:
            self._keepalive.start()
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

    def _fire_fault(self, seq: int, lanes: List[int]):
        """Consult the ``volume`` fault site once for every lane of the
        mesh; the fired rule or None. A ``lane``-selected rule fires
        exactly when its lane is in the dispatching mesh (the
        deterministic "lane k dies mid-volume" drill); one without a lane
        selector fires on the first check and blames no lane (an
        unattributable failure: the gang sheds rather than guess)."""
        plan = self.fault_plan
        if plan is None or not plan.has_site("volume"):
            return None
        for ln in lanes:
            rule = plan.fire("volume", obs=self.obs, index=seq, lane=ln)
            if rule is not None:
                return rule
        return None

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
                if not req.done.is_set():  # the bound may have answered it already
                    req.fail(e)
                return
        req.done.set()

    def _dispatch_volume(self, req: VolumeRequest, seq: int) -> None:
        """Run the study over a z-mesh of the healthy lanes, re-meshing
        onto the survivors after a lane death."""
        h, w = req.dims
        # nm03-lint: disable=NM322 host ints of the request's header, no device value
        dims = np.asarray([h, w], np.int32)
        if self.in_job:
            self._dispatch_across_job(req, seq, dims)
            return
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
            full_pool = [(ln, d) for ln, d in self._device_pool() if ln not in excluded]
            if not full_pool:
                raise GangUnavailable("no healthy lane left to run the volume on")
            pool = full_pool[:self._usable_shards(len(full_pool), req.depth)]
            lanes = [ln for ln, _ in pool]
            rule = self._fire_fault(seq, lanes)
            if rule is not None:
                if rule.lane is None or rule.lane not in lanes:
                    raise GangUnavailable(
                        "injected unattributable volume failure (volume dispatch_error)"
                    )
                # the drill's deterministic lane death: book it through the
                # real quarantine machine and re-mesh onto the survivors
                log.warning("volume %s: injected death of lane %d mid-volume; "
                            "re-meshing onto the survivors", req.request_id, rule.lane)
                self.executor.quarantine_lane(rule.lane, "device_lost")
                excluded.add(rule.lane)
                self._note_requeue(req, rule.lane, "injected_device_lost")
                continue
            stack = self._padded_stack(req.volume, req.depth, len(pool))
            sup = self.executor.new_supervisor()
            trace = req.trace
            try:
                # nm03-lint: disable=NM422 the canonical gang hold: the WHOLE study's program runs under the parked batcher; that exclusivity is what makes a volume dispatch safe
                mask, conv = sup.run(
                    lambda: self._run_program(stack, dims, lanes, [d for _, d in pool], trace),
                    label="volume_dispatch",
                )
            except BaseException as e:  # noqa: BLE001 — classified below
                cause = self.executor._quarantine_cause(e)
                if cause is None:
                    raise  # deterministic failure: the requester's
                if len(lanes) == 1:
                    # one lane ran the whole study: the fault is that lane's
                    log.warning("volume %s: lane %d failed (%s); re-dispatching",
                                req.request_id, lanes[0], cause)
                    self.executor.quarantine_lane(lanes[0], cause)
                    excluded.add(lanes[0])
                    self._note_requeue(req, lanes[0], cause)
                    continue
                survivors = [ln for ln, _ in self._device_pool() if ln not in excluded]
                if survivors != [ln for ln, _ in full_pool]:
                    # the fleet booked a lane death meanwhile (slice traffic
                    # or the prober saw it): re-mesh onto the survivors
                    log.warning("volume %s: mesh dispatch failed (%s); re-meshing onto "
                                "the surviving lanes", req.request_id, cause)
                    self._note_requeue(req, None, cause)
                    continue
                # unattributable with an unchanged fleet: shedding beats
                # guessing which card to blame; the client retries
                raise GangUnavailable(
                    f"mesh-wide volume dispatch failed ({cause}) with no "
                    "attributable lane; retry after the fleet settles"
                ) from e
            req.mask = np.ascontiguousarray(mask[: req.depth, :h, :w])
            req.converged = conv
            req.z_shards = len(lanes)
            req.lane = lanes[0]
            req.lanes = lanes
            return

    def _dispatch_across_job(self, req: VolumeRequest, seq: int, dims: np.ndarray) -> None:
        """The study over the job's ranks: no lane to blame, so an injected
        or real failure sheds (and a real one marks the gang down)."""
        if self._down is not None:
            raise GangUnavailable(f"the cross-process volume gang is down ({self._down})")
        n = distributed.process_count()
        if self._fire_fault(seq, [None]) is not None:
            raise GangUnavailable("injected unattributable volume failure (volume dispatch_error)")
        h, w = req.dims
        mask, conv = self._run_distributed(self._padded_stack(req.volume, req.depth, n), dims,
                                           req.trace, req)
        req.mask = np.ascontiguousarray(mask[: req.depth, :h, :w])
        req.converged = conv
        req.z_shards = n
        req.lane, req.lanes = None, []

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
            "distributed": self.in_job,
            "processes": distributed.process_count() if self.in_job else 1,
            # a cross-process gang that lost a rank sheds every study
            "ready": self._down is None or not self.in_job,
            "down_cause": self._down if self.in_job else None,
            "default_cost": self.default_cost,
        }
