"""Warm per-lane, per-bucket CUDA graphs behind per-lane fault domains.

The port's counterpart of the JAX package's ``serving/executor.py``. An
online service cannot amortize per-batch dispatch cost over a cohort, so
the executor warms ONE program per (replica lane, batch-size bucket) at
startup and a serve-time dispatch is a lookup plus a replay. In the JAX
package that program is an AOT-compiled executable; here it is a CUDA
graph over the pipeline (:class:`~.graphs.BucketGraph`), captured before
the HTTP listener starts.

**Replica lanes**: every visible CUDA device is a lane (``lanes`` caps the
count), each with its own stream, graph memory pool and graphs; the
batcher fans coalesced batches out across healthy lanes. An explicit
``lane_devices`` list replaces that choice (a constructor argument, not a
CLI flag): it may name one device several times, so the CPU tests build
four CPU lanes and ``chip_smoke.py`` four lanes on one card, the
counterpart of the JAX tests' virtual devices. Lanes that share a device
stay separate lanes: each keeps its own stream, graphs, fault domain and
busy accounting. On the CPU, which runs only when the caller asks for it
(``device="cpu"``, as the tests do), there is one lane unless
``lane_devices`` names more, and each bucket runs the plain ops eagerly
(:class:`EagerBucket`).

**Fault domains**: each lane runs its dispatches under its own
:class:`~..resilience.DispatchSupervisor`; a deadline expiry or an
exhausted retry budget *quarantines that lane*
(:mod:`~nm03_capstone_project_tpu_torch.serving.lanes`) and the batcher
re-dispatches the chunk. A probation probe replays the lane's bucket-1
graph on a canary batch, supervised, off the request path, and reinstates
the lane when it passes. While EVERY lane is quarantined the replica is
``degraded``: ``/readyz`` answers 503 and every dispatch raises
:class:`~..resilience.DeadlineExceeded` at once, until the probe
reinstates a lane. The JAX package's one-way CPU fallback is not ported:
nothing here serves from the CPU in place of the card, so the degradation
is not one-way (a one-card replica degrades at every quarantine and comes
back with its lane).

**Chaos**: with a :class:`~..resilience.FaultPlan`, every supervised
dispatch (and every probation canary, for rules that select its lane)
consults the plan's ``dispatch`` site before it launches: a ``transient``
rule raises a retryable error, a ``hang`` blocks until the deadline
abandons it.

**Telemetry**: each dispatch's busy interval (host wall around launch,
fetch and sync, failed attempts included) goes to the saturation monitor
(:mod:`..obs.saturation`) and onto the chunk's trace for the device-time
ledger (:mod:`..obs.ledger`); at warmup each (lane, bucket) pins its
operation count (:func:`..obs.saturation.bucket_flops`) for MFU, and lane
0's buckets give the ledger their graph bytes and the kernel sequence of
one recorded eager run (:func:`.graphs.record_kernel_sequence`).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.core.backend import resolve_device
from nm03_capstone_project_tpu_torch.obs import flightrec
from nm03_capstone_project_tpu_torch.obs.trace import NULL_TRACE, TraceContext
from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import _process
from nm03_capstone_project_tpu_torch.obs.saturation import bucket_flops
from nm03_capstone_project_tpu_torch.resilience import (
    DeadlineExceeded,
    DispatchSupervisor,
    InjectedTransientError,
    ResilienceConfig,
    execute_hang,
    is_retryable,
)
from nm03_capstone_project_tpu_torch.serving.graphs import BucketGraph, record_kernel_sequence
from nm03_capstone_project_tpu_torch.serving.lanes import (
    PROBATION,
    QUARANTINED,
    LaneFaultDomains,
    LaneQuarantined,
)
from nm03_capstone_project_tpu_torch.serving.metrics import (
    SERVING_GRAPH_REPLAYS_TOTAL,
    SERVING_LANE_BATCHES_TOTAL,
    SERVING_LANE_INFLIGHT,
    SERVING_LANES_READY,
    SERVING_WARMUP_SECONDS,
)
from nm03_capstone_project_tpu_torch.utils import sanitize
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("serving")

DEFAULT_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16)

# how long the probation prober sleeps between passes over the
# quarantined set; a quarantined lane gets its first canary after one
# interval, so the knob trades reinstatement latency against probe load
DEFAULT_LANE_PROBE_INTERVAL_S = 5.0


class EagerBucket:
    """The CPU's bucket runner: the plain ops, eagerly, no graph.

    The same ``launch``/``fetch`` interface as :class:`~.graphs.BucketGraph`;
    only an executor built with ``device="cpu"`` makes these.
    """

    def __init__(self, cfg: PipelineConfig, bucket: int):
        self.cfg = cfg
        self.bucket = int(bucket)
        self.capture_s = None
        self.replays = 0
        self.kernels: Dict[str, int] = {}
        c = cfg.canvas
        # the host buffers a batch occupies (no graph, no pool to measure)
        self.memory = {"argument_bytes": self.bucket * (c * c * 4 + 2 * 4),
                       "output_bytes": self.bucket * (c * c + 1)}
        self._out = None

    def capture(self) -> float:
        return 0.0

    def launch(self, pixels: np.ndarray, dims: np.ndarray) -> None:
        out = _process(torch.from_numpy(np.ascontiguousarray(pixels, np.float32)),
                       torch.from_numpy(np.ascontiguousarray(dims, np.int32)), self.cfg)
        self._out = (out["mask"].numpy(), out["grow_converged"].numpy())
        self.replays += 1

    def fetch(self):
        out, self._out = self._out, None
        return out


class WarmExecutor:
    """Per-lane, per-bucket warm pipeline programs.

    ``buckets`` is the ascending list of batch sizes a program exists for;
    a coalesced chunk is padded up to the smallest bucket that fits
    (:meth:`bucket_for`). ``device`` is ``"cuda"`` (the default; raises
    without a GPU) or ``"cpu"`` on request. ``supports_trace`` tells the
    batcher :meth:`run_batch` takes the chunk trace.
    """

    supports_trace = True

    def __init__(
        self,
        cfg: PipelineConfig,
        buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
        resilience: Optional[ResilienceConfig] = None,
        obs=None,
        lanes: Optional[int] = None,
        lane_probe_interval_s: float = DEFAULT_LANE_PROBE_INTERVAL_S,
        device=None,
        fault_plan=None,
        saturation=None,
        ledger=None,
        lane_devices: Optional[Sequence] = None,
    ):
        if not buckets or list(buckets) != sorted(set(int(b) for b in buckets)):
            raise ValueError(f"buckets must be strictly increasing, got {buckets}")
        if any(b < 1 for b in buckets):
            raise ValueError(f"buckets must be >= 1, got {buckets}")
        if lanes is not None and lanes < 1:
            raise ValueError(f"lanes must be >= 1 (or None = all), got {lanes}")
        if lane_probe_interval_s <= 0:
            raise ValueError(
                f"lane_probe_interval_s must be > 0, got {lane_probe_interval_s}"
            )
        self.cfg = cfg
        self.buckets: Tuple[int, ...] = tuple(int(b) for b in buckets)
        self.device = resolve_device(device)
        self._explicit_lanes = None
        if lane_devices is not None:
            devs = [torch.device(d) for d in lane_devices]
            if not devs or lanes is not None:
                raise ValueError("lane_devices takes a non-empty list and no lanes cap")
            if any(d.type != self.device.type for d in devs):
                raise ValueError(
                    f"lane_devices {[str(d) for d in devs]} are not all {self.device.type}"
                )
            for d in devs:
                resolve_device(d)
            self._explicit_lanes = devs
        self.obs = obs
        self.res = resilience if resilience is not None else ResilienceConfig()
        self.lane_probe_interval_s = float(lane_probe_interval_s)
        self.fault_plan = fault_plan
        # efficiency accounting (obs.saturation.SaturationMonitor) and the
        # device-time ledger (obs.ledger.DeviceTimeLedger); None = off
        self.saturation = saturation
        self.ledger = ledger
        self._lock = threading.Lock()
        self._probe_seq = itertools.count()
        self._dispatch_seq = itertools.count()
        self._busy_s = 0.0  # request-path dispatch busy seconds, failures included
        self._warm = False
        self._requested_lanes = (
            lanes if self._explicit_lanes is None else len(self._explicit_lanes))
        self._lane_devices: Optional[List[torch.device]] = None
        self._lane_warm: List[bool] = []
        self._lane_inflight: List[int] = []
        self._lane_batches: List[int] = []
        self._lane_supervisors: List[DispatchSupervisor] = []
        # one lock a lane: a lane replays one graph at a time (its graphs
        # share a memory pool and its buckets' pinned buffers)
        self._lane_locks: List[threading.Lock] = []
        self._runners: List[Dict[int, object]] = []
        self.fleet: Optional[LaneFaultDomains] = None
        self._prober: Optional[threading.Thread] = None
        self._closed = threading.Event()  # set by close(): no more probes
        self._degraded = False
        self._degraded_cause: Optional[str] = None

    def new_supervisor(self) -> DispatchSupervisor:
        """A fresh supervisor with this executor's policy.

        Public for the volume gang: a supervisor's retry budget is spent
        by its failures, so every caller that can outlive one (probation
        probes, gang dispatches) takes a fresh one.
        """
        retry = self.res.make_retry_policy()
        retry.obs = self.obs
        return DispatchSupervisor(self.res, retry=retry, obs=self.obs)

    # -- lanes -------------------------------------------------------------

    def _resolve_lanes(self) -> List[torch.device]:
        """The lane devices: the explicit ``lane_devices``, else every
        visible CUDA device up to ``lanes``, or the one CPU lane."""
        with self._lock:
            if self._lane_devices is not None:
                return self._lane_devices
            if self._explicit_lanes is not None:
                devs = list(self._explicit_lanes)
            elif self.device.type == "cpu":
                devs = [self.device]
            else:
                n = torch.cuda.device_count()
                devs = [torch.device("cuda", i)
                        for i in range(min(n, self._requested_lanes or n))]
            self._lane_devices = devs
            self._lane_warm = [self._warm] * len(devs)
            self._lane_inflight = [0] * len(devs)
            self._lane_batches = [0] * len(devs)
            self._lane_supervisors = [self.new_supervisor() for _ in devs]
            self._lane_locks = [threading.Lock() for _ in devs]
            self._runners = [{} for _ in devs]
            self.fleet = LaneFaultDomains(len(devs), obs=self.obs)
        if self.saturation is not None:
            # outside the lock: set_lanes publishes gauges
            # the device itself as the third field: lanes that share a card
            # share its peak in the fleet MFU
            self.saturation.set_lanes([
                (d.type, torch.cuda.get_device_name(d) if d.type == "cuda" else "", str(d))
                for d in devs
            ])
        with self._lock:
            return self._lane_devices

    @property
    def lane_count(self) -> Optional[int]:
        """Resolved lane count; the requested cap before resolution."""
        with self._lock:
            if self._lane_devices is not None:
                return len(self._lane_devices)
        return self._requested_lanes

    @property
    def lanes_ready(self) -> int:
        """Warm AND healthy lanes — the ``serving_lanes_ready`` gauge."""
        with self._lock:
            fleet = self.fleet
            if self._lane_devices is not None:
                return sum(
                    1
                    for i, w in enumerate(self._lane_warm)
                    if w and (fleet is None or fleet.is_healthy(i))
                )
            return (self._requested_lanes or 1) if self._warm else 0

    def healthy_lanes(self) -> Optional[List[int]]:
        """Lane ids currently accepting traffic; None before resolution."""
        with self._lock:
            fleet = self.fleet
        if fleet is None:
            return None
        return fleet.healthy_lanes()

    def healthy_lane_devices(self) -> List[Tuple[int, torch.device]]:
        """``[(lane, device)]`` of the lanes currently taking traffic: the
        volume gang's pool (a quarantined lane is out of it as it is out of
        the slice fan-out). Resolves the lanes on first use."""
        devs = self._resolve_lanes()
        return [(i, devs[i]) for i in self.healthy_lanes()]

    def quarantine_lane(self, lane: int, cause: str) -> None:
        """Quarantine one lane from outside the dispatch path (the volume
        gang books a lane death it can attribute here)."""
        self._resolve_lanes()
        self._quarantine_lane(lane, cause, NULL_TRACE)

    @property
    def quarantined_count(self) -> int:
        with self._lock:
            fleet = self.fleet
        return fleet.quarantined_count() if fleet is not None else 0

    @property
    def capacity(self) -> Optional[float]:
        """Healthy-lane fraction (the ``/readyz`` field); None before
        lane resolution."""
        with self._lock:
            fleet = self.fleet
            n = len(self._lane_devices) if self._lane_devices else 0
        if fleet is None or n == 0:
            return None
        return round(fleet.healthy_count() / n, 4)

    def lane_state(self) -> List[dict]:
        """Per-lane readiness/inflight/dispatch/fault-domain state (the
        ``/readyz`` ``lanes.per_lane`` payload); [] before resolution."""
        with self._lock:
            if self._lane_devices is None:
                return []
            fleet = self.fleet
            rows = [
                {
                    "lane": i,
                    "device": str(d),
                    "warm": self._lane_warm[i],
                    "inflight": self._lane_inflight[i],
                    "batches": self._lane_batches[i],
                }
                for i, d in enumerate(self._lane_devices)
            ]
        if fleet is not None:
            for row, st in zip(rows, fleet.snapshot()):
                row["state"] = st["state"]
                row["quarantine_cause"] = st["cause"]
                row["quarantines"] = st["quarantines"]
        return rows

    def graph_stats(self) -> dict:
        """The ``/readyz`` ``cuda_graphs`` block: each lane's buckets with
        their capture seconds, replays and the kernel launches a replay
        holds."""
        with self._lock:
            runners = [dict(r) for r in self._runners]
        return {
            "enabled": self.device.type == "cuda",
            "lanes": {
                str(lane): {str(b): r.stats() for b, r in sorted(rs.items())}
                for lane, rs in enumerate(runners)
                if self.device.type == "cuda"
            },
        }

    def reset_replays(self) -> None:
        """Zero every bucket's replay count (a measurement starts here)."""
        with self._lock:
            runners = [r for rs in self._runners for r in rs.values()]
        for r in runners:
            r.replays = 0

    def replay_launches(self) -> Dict[str, int]:
        """Kernel launches made by graph replays since the last
        :meth:`reset_replays`: each bucket's replays times the launches of
        each kernel its graph holds."""
        with self._lock:
            runners = [r for rs in self._runners for r in rs.values()]
        out: Dict[str, int] = {}
        for r in runners:
            for k, n in r.kernels.items():
                out[k] = out.get(k, 0) + r.replays * n
        return out

    def _set_lanes_ready_gauge(self) -> None:
        if self.obs is not None:
            self.obs.registry.gauge(
                SERVING_LANES_READY,
                help="warm, healthy replica lanes (devices) taking traffic "
                "in this serving process",
            ).set(self.lanes_ready)

    # -- state -------------------------------------------------------------

    @property
    def warm(self) -> bool:
        """True once every lane's every bucket is captured and replayed."""
        with self._lock:
            return self._warm

    @warm.setter
    def warm(self, value: bool) -> None:
        with self._lock:
            self._warm = bool(value)
            if self._lane_devices is not None:
                for i in range(len(self._lane_warm)):
                    self._lane_warm[i] = bool(value)

    @property
    def degraded(self) -> bool:
        """True while every lane is quarantined: requests fail fast."""
        with self._lock:
            return self._degraded

    @property
    def degraded_cause(self) -> Optional[str]:
        with self._lock:
            return self._degraded_cause

    @property
    def busy_seconds(self) -> float:
        """Host wall of every request-path dispatch so far (launch, fetch
        and sync, failed and retried attempts included): what the
        device-time ledger's accounts sum to."""
        with self._lock:
            return self._busy_s

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest warm bucket that fits ``n`` requests."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} exceeds the largest bucket {self.buckets[-1]}")

    # -- warmup ------------------------------------------------------------

    def _new_runner(self, lane: int, bucket: int, pool, stream):
        if self.device.type == "cpu":
            return EagerBucket(self.cfg, bucket)
        return BucketGraph(self.cfg, bucket, self._lane_devices[lane], pool, stream)

    def warmup(self) -> Dict[str, Dict[int, float]]:
        """Capture and replay every (lane, bucket) once; nested timings.

        Returns ``{"lane0": {bucket: capture seconds}, ...}``. Each graph
        is replayed once on zeros here, so first-replay set-up is paid
        behind ``/readyz``, not by the first request. A capture that fails
        raises: the executor never turns warm.
        """
        c = self.cfg.canvas
        devs = self._resolve_lanes()
        if self.cfg.use_kernels and any(d.type == "cuda" for d in devs):
            # the kernel libraries first (from the compile cache, a build,
            # or _build/: kernels/build.py), so a bucket's capture seconds
            # are its capture alone
            from nm03_capstone_project_tpu_torch.kernels import build

            for name in build.SOURCES:
                build.load(name)
        timings: Dict[str, Dict[int, float]] = {}
        for lane, dev in enumerate(devs):
            pool = stream = None
            if dev.type == "cuda":
                pool = torch.cuda.graph_pool_handle()
                stream = torch.cuda.Stream(dev)
            lane_t: Dict[int, float] = {}
            for b in self.buckets:
                runner = self._new_runner(lane, b, pool, stream)
                lane_t[b] = round(runner.capture(), 6)
                runner.launch(np.zeros((b, c, c), np.float32),
                              np.full((b, 2), self.cfg.min_dim, np.int32))
                runner.fetch()
                runner.replays = 0
                with self._lock:
                    self._runners[lane][b] = runner
                if self.saturation is not None:
                    # pin the bucket's operation count once: every
                    # successful dispatch credits it to the MFU window
                    self.saturation.set_lane_bucket_flops(lane, b, bucket_flops(self.cfg, b))
                if self.ledger is not None and lane == 0:
                    # lane 0 only: every lane runs the same program per bucket
                    self.ledger.set_bucket_hbm(b, runner.memory)
            if self.ledger is not None and lane == 0:
                self._record_sequences(dev, stream)
            timings[f"lane{lane}"] = lane_t
            with self._lock:
                self._lane_warm[lane] = True
            self._set_lanes_ready_gauge()
        if self.obs is not None:
            for lane_key, lane_t in timings.items():
                for b, s in lane_t.items():
                    self.obs.registry.gauge(
                        SERVING_WARMUP_SECONDS,
                        help="startup CUDA graph capture time per lane and batch bucket",
                        bucket=str(b),
                        lane=lane_key[len("lane"):],
                    ).set(s)
        # nm03-lint: disable=NM331 goes through the lock-guarded property setter; the linter cannot see through the descriptor
        self.warm = True
        self._set_lanes_ready_gauge()
        return timings

    def _record_sequences(self, dev, stream) -> None:
        """Feed the ledger each bucket's kernel sequence from one recorded
        eager run (after every graph of the lane is captured). Best-effort,
        as the JAX package's HLO parse: a profiler that is busy or absent
        leaves the stage map empty (the pie then reads ``other``), never
        fails warmup."""
        for b in self.buckets:
            try:
                self.ledger.ingest_kernel_sequence(
                    b, record_kernel_sequence(self.cfg, b, dev, stream))
            except Exception as e:  # noqa: BLE001 — attribution is evidence
                log.warning("ledger: no kernel sequence for bucket %d: %s", b, e)

    # -- chaos hook --------------------------------------------------------

    def _pre(self, index: Optional[int], lane: Optional[int] = None, lane_only: bool = False):
        """Dispatch-site fault hook (resilience.FaultPlan); None when off.

        ``lane`` reaches the plan's selectors, so ``{"site": "dispatch",
        "kind": "hang", "lane": 0}`` wedges one chosen lane. Probation
        probes pass ``lane_only=True``: only rules that select their lane
        are consulted (a still-sick lane keeps failing its canary), and
        generic rules keep their ``after``/``count`` budgets for the
        request traffic they were written against.
        """
        plan = self.fault_plan
        if plan is None or not plan.has_site("dispatch"):
            return None

        def pre(cancel):
            rule = plan.fire("dispatch", obs=self.obs, index=index, lane=lane,
                             lane_only=lane_only)
            if rule is None:
                return
            if rule.kind == "hang":
                execute_hang(rule, cancel)
            else:  # transient
                raise InjectedTransientError(
                    f"injected transient device error (serve dispatch {index} lane {lane})"
                )

        return pre

    # -- quarantine / probation -------------------------------------------

    @staticmethod
    def _quarantine_cause(exc: BaseException) -> Optional[str]:
        """Deadline expiry and an exhausted transient-retry budget are LANE
        faults; anything else is a deterministic error that must reach the
        riders unchanged."""
        if isinstance(exc, DeadlineExceeded):
            return "deadline"
        if is_retryable(exc):
            return "device_lost"
        return None

    def _quarantine_lane(self, lane: int, cause: str, trace) -> None:
        fleet = self.fleet
        if fleet is None:
            return
        changed, healthy_left = fleet.quarantine(
            lane, cause, trace_ids=getattr(trace, "trace_ids", [])
        )
        if not changed:
            return
        self._set_lanes_ready_gauge()
        if healthy_left == 0:
            self._process_degrade(cause)
        self._ensure_prober()

    def _process_degrade(self, cause: str) -> None:
        """Every lane is quarantined: the replica is degraded until the
        probe reinstates one (the state is re-read under the lock, so a
        reinstatement racing this quarantine wins)."""
        fleet = self.fleet
        with self._lock:
            if self._degraded or fleet is None or fleet.healthy_count() > 0:
                return
            self._degraded = True
            self._degraded_cause = str(cause)
        log.warning(
            "all %s lanes quarantined (%s): not ready, requests fail fast",
            self.lane_count, cause,
        )
        if self.obs is not None:
            try:
                self.obs.degraded(
                    cause=cause,
                    site="serve_fleet",
                    timeout_s=self.res.dispatch_timeout_s,
                    lanes=self.lane_count,
                )
            except Exception:  # noqa: BLE001 — telemetry never costs the run
                pass
        flightrec.auto_dump(reason=f"degraded_{cause}")

    def _recover(self) -> None:
        """A lane is healthy again: the degraded replica serves again."""
        fleet = self.fleet
        with self._lock:
            if not self._degraded or fleet is None or fleet.healthy_count() == 0:
                return
            self._degraded = False
            self._degraded_cause = None
        log.warning("a lane was reinstated: the replica is ready again")
        if self.obs is not None:
            try:
                self.obs.events.emit("serving_recovered", lanes=self.lane_count)
            except Exception:  # noqa: BLE001 — telemetry never costs the run
                pass

    def _ensure_prober(self) -> None:
        # start() INSIDE the lock: a created-but-unstarted Thread reports
        # is_alive() False, so a racing quarantine could spawn a duplicate
        with self._lock:
            if self._closed.is_set() or (self._prober is not None and self._prober.is_alive()):
                return
            self._prober = threading.Thread(
                target=self._probe_loop, name="nm03-lane-probe", daemon=True
            )
            self._prober.start()

    def _probe_loop(self) -> None:
        """Canary every quarantined lane, reinstate on success. Exits when
        nothing is quarantined (the next quarantine spawns it again)."""
        try:
            while not self._closed.wait(self.lane_probe_interval_s):
                fleet = self.fleet
                if fleet is None:
                    return
                quarantined = fleet.lanes_in(QUARANTINED)
                if not quarantined and not fleet.lanes_in(PROBATION):
                    return
                for lane in quarantined:
                    if not fleet.begin_probation(lane):
                        continue
                    if self._probe_lane(lane):
                        with self._lock:
                            self._lane_supervisors[lane] = self.new_supervisor()
                        if fleet.reinstate(lane):
                            self._set_lanes_ready_gauge()
                            self._recover()
                    else:
                        fleet.fail_probation(lane)
        finally:
            # unregister before the liveness gap closes, then re-check: a
            # quarantine that landed meanwhile saw a live prober and did
            # not spawn one
            with self._lock:
                self._prober = None
            fleet = self.fleet
            if fleet is not None and fleet.lanes_in(QUARANTINED) and not self._closed.is_set():
                self._ensure_prober()

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop the probation prober (the server's close); idempotent."""
        self._closed.set()
        with self._lock:
            prober = self._prober
        if prober is not None:
            prober.join(timeout_s)

    def _probe_lane(self, lane: int) -> bool:
        """One supervised canary: the lane's smallest bucket replayed on
        zeros, under a fresh supervisor (the full deadline and retries)."""
        c = self.cfg.canvas
        b = self.buckets[0]
        ctx = TraceContext(f"probe-l{lane}-{next(self._probe_seq)}")
        try:
            with self._lock:
                runner = self._runners[lane][b]
                lane_lock = self._lane_locks[lane]
            px = np.zeros((b, c, c), np.float32)
            dm = np.full((b, 2), self.cfg.min_dim, np.int32)

            def primary():
                with lane_lock:
                    runner.launch(px, dm)
                    return runner.fetch()

            with ctx.span("probe", lane=lane):
                self.new_supervisor().run(primary, label="serve_probe",
                                          pre=self._pre(None, lane, lane_only=True))
            return True
        except BaseException as e:  # noqa: BLE001 — a failed canary is data
            log.warning("lane %d probation probe failed: %s", lane, e)
            return False

    # -- the serve-time entry point ----------------------------------------

    def run_batch(self, pixels: np.ndarray, dims: np.ndarray, lane: int = 0, trace=None):
        """Run one bucket-padded batch on one lane, under supervision.

        ``pixels`` is (bucket, canvas, canvas) float32, ``dims`` (bucket, 2)
        int32, already padded by the batcher. Each supervised attempt
        records a ``device_dispatch`` span (stage into the bucket's pinned
        buffers, copy to the card, replay) and a ``fetch`` span (the event
        sync and the copy out of pinned memory) on the chunk's ``trace``.
        Returns host-side ``(mask, converged)`` arrays.

        Raises :class:`LaneQuarantined` when THIS lane's supervised ladder
        gave up (deadline / exhausted transient retries) — the batcher
        re-dispatches the chunk to a healthy lane — and the original error
        on a deterministic failure. Once every lane is quarantined it
        raises :class:`DeadlineExceeded` at once.
        """
        trace = trace if trace is not None else NULL_TRACE
        bucket = int(pixels.shape[0])
        devs = self._resolve_lanes()
        if not 0 <= lane < len(devs):
            raise ValueError(f"lane {lane} outside [0, {len(devs)})")
        if self.degraded:
            raise DeadlineExceeded(
                f"all {self.lane_count} lanes quarantined ({self.degraded_cause}); "
                "the port has no CPU fallback"
            )
        fleet = self.fleet
        if fleet is not None and not fleet.is_healthy(lane):
            # the batcher picked this lane before the quarantine landed
            raise LaneQuarantined(lane, fleet.cause(lane) or "quarantined")
        with self._lock:
            runner = self._runners[lane].get(bucket)
            sup = self._lane_supervisors[lane]
            lane_lock = self._lane_locks[lane]
        if runner is None:
            raise RuntimeError(f"lane {lane} has no warm bucket {bucket} (warmup not run)")
        index = next(self._dispatch_seq)
        reg = self.obs.registry if self.obs is not None else None
        if reg is not None:
            inflight_g = reg.gauge(
                SERVING_LANE_INFLIGHT,
                help="device batches in flight per replica lane",
                lane=str(lane),
            )
            inflight_g.inc()
        with self._lock:
            self._lane_inflight[lane] += 1

        attempts = {"n": 0}  # shared so retried primaries number their spans

        def primary():
            # fetch INSIDE the supervised call: a wedged fetch is the same
            # wedge as a wedged dispatch
            attempts["n"] += 1
            with lane_lock:
                with trace.span("device_dispatch", attempt=attempts["n"]):
                    runner.launch(pixels, dims)
                with trace.span("fetch", attempt=attempts["n"]):
                    return runner.fetch()

        t_busy0 = time.monotonic()
        dispatched_ok = False
        try:
            # --sanitize: a graph stages its batch through its pinned
            # buffers; a host array reaching the pipeline here is an upload
            with sanitize.guard_dispatch("serving/executor.py::run_batch"):
                out = sup.run(primary, label="serve_dispatch", pre=self._pre(index, lane))
            dispatched_ok = True
        except BaseException as e:  # noqa: BLE001 — classified below
            cause = self._quarantine_cause(e)
            if cause is None:
                raise  # deterministic failure: the riders' problem
            self._quarantine_lane(lane, cause, trace)
            raise LaneQuarantined(lane, cause) from e
        finally:
            t_busy1 = time.monotonic()
            with self._lock:
                self._busy_s += t_busy1 - t_busy0
            if self.saturation is not None:
                # busy is busy either way (a dispatch that hung to its
                # deadline held the lane); only a success credits the
                # bucket's operations to MFU
                self.saturation.record_dispatch(lane, t_busy0, t_busy1, bucket=bucket,
                                                counted=dispatched_ok)
            if hasattr(trace, "device_busy_s"):
                # onto the chunk's own trace (requeued attempts add up): the
                # batcher prorates the total into the device-time ledger
                trace.device_busy_s += t_busy1 - t_busy0
            if reg is not None:
                inflight_g.dec()
            with self._lock:
                self._lane_inflight[lane] -= 1
        with self._lock:
            self._lane_batches[lane] += 1
        if reg is not None:
            reg.counter(
                SERVING_LANE_BATCHES_TOTAL,
                help="device batches dispatched per replica lane",
                lane=str(lane),
            ).inc()
            reg.counter(
                SERVING_GRAPH_REPLAYS_TOTAL,
                help="serving batches run per lane and bucket (CUDA graph "
                "replays on the card, eager plain-op runs on the CPU)",
                lane=str(lane),
                bucket=str(bucket),
            ).inc()
        return out
