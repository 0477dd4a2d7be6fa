"""Device-time ledger: what every served request COSTS.

The port's copy of the JAX package's ``obs/ledger.py``: three coupled
planes over evidence the serving stack already produces.

* **Per-request cost attribution** — the executor's per-dispatch busy
  intervals (host wall around the launch, fetch and sync), prorated across
  the rows of each padded chunk: real rows charged to the ``request``
  account, dead rows to ``padding``, probation canaries to ``probe``
  (excluded from the per-request histogram). The three accounts sum to the
  executor's recorded busy time exactly: proration conserves.
* **Live stage shares** — a cadence-driven sampler takes short
  ``torch.profiler`` captures (through the one-at-a-time lock of
  :mod:`..utils.profiling`), labels each device op with a pipeline stage
  and reduces the timeline to per-stage self time:
  ``serving_device_time_share{stage}``. This is profiler device time, a
  separate number from the busy seconds above. There is no HLO to read
  the stage from, so a device op's stage comes from two rules:

  - the port's hand-written kernels map by name (:data:`KERNEL_STAGES`),
    the way the JAX package's source-file rule maps their Pallas files;
  - the PyTorch ops' kernels around them map by their position in a
    bucket's kernel sequence, recorded at warmup from one eager run of the
    pipeline under ``record_function(stage)`` ranges
    (:func:`kernel_sequence`). A sampled run whose sequence matches no
    recorded one (a re-capture, a data-dependent loop on the CPU) is
    labelled op by op: hand-written kernels by name, every other op
    ``other``, and those ops are counted (``unmatched_ops``).

  On a card the device ops are the kernels CUPTI reports (the kernel
  nodes of a CUDA graph replay included); on the CPU, which runs the ops
  on the host, they are the ATen ops.
* **HBM ledger** — each bucket's CUDA graph bytes, measured at capture
  (``serving/graphs.py``), published as
  ``serving_executable_hbm_bytes{bucket,kind}`` for the kinds a captured
  graph has (argument, output, temp, peak).

Stdlib only at import: the Chrome-trace JSON is parsed with the standard
library and the capture function is injected. Thread-shared state is
lock-guarded. Metric names live in :mod:`.metrics`.
"""

from __future__ import annotations

import base64
import collections
import gzip
import io
import json
import logging
import threading
import time
import zipfile
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from nm03_capstone_project_tpu_torch.obs.metrics import (
    LEDGER_PROFILE_SKIPPED_TOTAL,
    SERVING_DEVICE_SECONDS_PER_REQUEST,
    SERVING_DEVICE_SECONDS_PER_REQUEST_MEAN,
    SERVING_DEVICE_SECONDS_TOTAL,
    SERVING_DEVICE_TIME_SHARE,
    SERVING_EXECUTABLE_HBM_BYTES,
)

_log = logging.getLogger("nm03.ledger")

# the three cost accounts every dispatched row lands in (and sums across)
ACCOUNTS = ("request", "padding", "probe")

# the serving pipeline's stage vocabulary (the JAX package's), plus "other"
# for device time no stage claims (copies, ops outside the pipeline)
STAGES = ("normalize", "median7", "sharpen", "grow", "morph", "render")

# the hand-written kernels by the name the profiler reports (the
# __global__ function), each with its entry point in csrc/: the fused
# preprocess and the standalone median are the median7 stage, as their
# Pallas files are in the JAX package's source-file rule
KERNEL_STAGES: Tuple[Tuple[str, str], ...] = (
    ("fused_kernel", "median7"),  # csrc/fused.cu, nm03_fused_preprocess
    ("band_kernel", "median7"),  # csrc/median.cu, nm03_median_filter
    ("grow_kernel", "grow"),  # csrc/grow.cu, nm03_region_grow
)

# graph-capture byte counts -> the {kind} label of
# serving_executable_hbm_bytes (the JAX package's executable_cost() kinds
# that a captured CUDA graph has; its `alias` and `code` have none)
HBM_KINDS: Tuple[Tuple[str, str], ...] = (
    ("argument_bytes", "argument"),
    ("output_bytes", "output"),
    ("temp_bytes", "temp"),
    ("peak_hbm_bytes", "peak"),
)

# per-request device-seconds: sub-ms card rows up to tens of seconds of a
# CPU lane — much finer at the bottom than the latency buckets, because a
# row's device share is latency divided by the batch size
DEVICE_SECONDS_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

# Chrome-trace categories of torch.profiler: a card's device ops, the host
# ops the CPU runs, the launch calls that link a kernel to its host thread
KERNEL_CAT = "kernel"
DEVICE_COPY_CATS = ("gpu_memcpy", "gpu_memset")
CPU_OP_CAT = "cpu_op"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ANNOTATION_CAT = "user_annotation"
OP_KEY = "hlo_op"  # the arg reduce_trace_events reads, as in the JAX traces


def stage_for_kernel(name: str) -> Optional[str]:
    """The stage of a hand-written kernel by its name, else None."""
    for fragment, stage in KERNEL_STAGES:
        if fragment in (name or ""):
            return stage
    return None


def _complete(events: Iterable[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and float(e.get("dur", 0) or 0) > 0]


def device_events(events: Iterable[dict]) -> List[dict]:
    """The device ops of one capture, in start order on each timeline.

    A capture that holds kernel events ran on a card: its device ops are
    those kernels (and the device copies). One without is a CPU run: its
    device ops are the ATen ops.
    """
    evs = _complete(events)
    kernels = [e for e in evs if e.get("cat") in (KERNEL_CAT,) + DEVICE_COPY_CATS]
    if any(e.get("cat") == KERNEL_CAT for e in kernels):
        out = kernels
    else:
        out = [e for e in evs if e.get("cat") == CPU_OP_CAT]
    out.sort(key=lambda e: (str(e.get("pid")), str(e.get("tid")), float(e["ts"]),
                            -float(e["dur"])))
    return out


def _launch_points(events: List[dict]) -> Dict[object, Tuple[object, float]]:
    """correlation id -> (host thread, time) of each kernel launch call."""
    out = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                out[corr] = ((e.get("pid"), e.get("tid")), float(e["ts"]))
    return out


def kernel_sequence(events: Iterable[dict], stages: Sequence[str] = STAGES
                    ) -> List[Tuple[str, str]]:
    """``[(op name, stage)]`` of one recorded eager run, in device order.

    ``events`` is the Chrome trace of the run under ``record_function``
    ranges named after ``stages``. A kernel's stage is the innermost range
    around its launch call on the launching thread (found through the
    kernel's ``correlation`` id); an ATen op's (the CPU) the innermost
    range around the op itself. A hand-written kernel keeps its name's
    stage; an op outside every range is ``other``.
    """
    evs = _complete(events)
    ranges: Dict[Tuple, List[Tuple[float, float, str]]] = collections.defaultdict(list)
    for e in evs:
        if e.get("cat") == ANNOTATION_CAT and e.get("name") in stages:
            t0 = float(e["ts"])
            ranges[(e.get("pid"), e.get("tid"))].append((t0, t0 + float(e["dur"]), e["name"]))
    for rows in ranges.values():
        rows.sort()
    launches = _launch_points(evs)

    def enclosing(thread, t: float) -> str:
        best = None
        for t0, t1, name in ranges.get(thread, ()):
            if t0 > t:
                break
            if t1 >= t and (best is None or t0 >= best[0]):
                best = (t0, name)
        return best[1] if best else "other"

    seq = []
    for e in device_events(evs):
        name = str(e.get("name"))
        stage = stage_for_kernel(name)
        if stage is None:
            if e.get("cat") == KERNEL_CAT:
                hit = launches.get((e.get("args") or {}).get("correlation"))
                stage = enclosing(*hit) if hit else "other"
            elif e.get("cat") == CPU_OP_CAT:
                stage = enclosing((e.get("pid"), e.get("tid")), float(e["ts"]))
            else:
                stage = "other"
        seq.append((name, stage))
    return seq


def label_trace_events(
    events: Iterable[dict], sequences: Sequence[Sequence[Tuple[str, str]]]
) -> Tuple[List[dict], Dict[str, str], int]:
    """Give every device op of a capture a stage.

    On each device timeline, ops are matched greedily against the recorded
    ``sequences`` (longest first): a run of ops whose names equal a whole
    recorded sequence takes its stages position by position. An op outside
    every such run takes its hand-written kernel's stage, or ``other``;
    ``unmatched`` counts those that are not hand-written kernels. Returns
    ``(events with args[OP_KEY] set, {op key: stage}, unmatched)`` for
    :func:`reduce_trace_events`.
    """
    seqs = sorted({tuple(s) for s in sequences if s}, key=len, reverse=True)
    names = [[n for n, _ in s] for s in seqs]
    stages = [[st for _, st in s] for s in seqs]
    by_line: Dict[Tuple, List[dict]] = collections.OrderedDict()
    for e in device_events(events):
        by_line.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    labeled, stage_of, unmatched = [], {}, 0
    for line in by_line.values():
        line_names = [str(e.get("name")) for e in line]
        i = 0
        while i < len(line):
            for seq_names, seq_stages in zip(names, stages):
                n = len(seq_names)
                if line_names[i:i + n] == seq_names:
                    run = seq_stages
                    break
            else:
                run = None
            if run is None:
                stage = stage_for_kernel(line_names[i])
                if stage is None:
                    stage = "other"
                    if line[i].get("cat") in (KERNEL_CAT, CPU_OP_CAT):
                        unmatched += 1
                run = [stage]
            for stage in run:
                key = f"op{len(labeled)}"
                ev = dict(line[i])
                ev["args"] = {**(ev.get("args") or {}), OP_KEY: key}
                labeled.append(ev)
                stage_of[key] = stage
                i += 1
    return labeled, stage_of, unmatched


def reduce_trace_events(
    events: Iterable[dict], stage_of: Dict[str, str]
) -> Dict[str, float]:
    """Per-stage device SELF-time (seconds) from Chrome-trace events.

    The JAX package's arithmetic, unchanged. Considers only complete
    (``ph == "X"``) events carrying an ``hlo_op`` arg (the key
    :func:`label_trace_events` writes on each device op); everything else
    is excluded. Events nest on each (pid, tid) timeline (an ATen op
    contains the ops it calls), so durations are reduced to self-time with
    an interval stack: a child's duration is subtracted from its
    enclosing parent's stage, never double-counted.
    """
    per_thread: Dict[Tuple, List[Tuple[float, float, str]]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        op = args.get("hlo_op")
        if not op:
            continue
        try:
            ts = float(ev["ts"])
            dur = float(ev.get("dur", 0.0))
        except (KeyError, TypeError, ValueError):
            continue
        if dur <= 0:
            continue
        key = (ev.get("pid"), ev.get("tid"))
        per_thread.setdefault(key, []).append((ts, dur, str(op).lstrip("%")))
    stage_us: Dict[str, float] = collections.defaultdict(float)
    for rows in per_thread.values():
        # at equal start times the LONGER event is the parent: sort it first
        rows.sort(key=lambda r: (r[0], -r[1]))
        stack: List[Tuple[str, float]] = []  # (stage, end_ts)
        for ts, dur, op in rows:
            while stack and stack[-1][1] <= ts:
                stack.pop()
            stage = stage_of.get(op, "other")
            stage_us[stage] += dur
            if stack:
                stage_us[stack[-1][0]] -= dur
            stack.append((stage, ts + dur))
    return {s: us / 1e6 for s, us in stage_us.items() if us > 1e-9}


def trace_events_from_capture(capture: dict) -> List[dict]:
    """Extract Chrome-trace events from a ``capture_profile`` result.

    The capture zips the profiler's Chrome trace (``*.trace.json``, or a
    gzipped ``*.trace.json.gz``; stdlib all the way down).
    Oversized captures kept server-side (``zip_dropped``) are read back
    from ``zip_path``. Returns ``[]`` when no trace rode the capture.
    """
    data = None
    if capture.get("zip_b64"):
        data = base64.b64decode(capture["zip_b64"])
    elif capture.get("zip_path"):
        with open(capture["zip_path"], "rb") as f:
            data = f.read()
    if not data:
        return []
    events: List[dict] = []
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        for name in zf.namelist():
            if name.endswith(".trace.json.gz"):
                doc = json.loads(gzip.decompress(zf.read(name)))
            elif name.endswith(".trace.json"):
                doc = json.loads(zf.read(name))
            else:
                continue
            events.extend(doc.get("traceEvents") or [])
    return events


class DeviceTimeLedger:
    """Per-request device-time accounting + live stage shares + HBM ledger.

    Fed by the executor (accumulated chunk busy seconds, each bucket's
    warmup kernel sequence and graph bytes), charged by the batcher per
    dispatched chunk
    (:meth:`charge_chunk` prorates; :meth:`observe_request` lands each
    non-probe rider's total in the histogram), sampled by a
    :class:`ProfileSampler`, and read by :meth:`publish`/:meth:`snapshot`
    on every scrape and once at drain — the same pull-refresh contract as
    the SaturationMonitor. All shared state is lock-guarded.
    """

    def __init__(
        self,
        registry=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._accounts: Dict[str, float] = {a: 0.0 for a in ACCOUNTS}
        self._request_count = 0
        self._request_seconds = 0.0
        # bucket -> [(op name, stage)] of one recorded eager run
        self._sequences: Dict[int, List[Tuple[str, str]]] = {}
        # cumulative reduced device seconds per stage across every sample:
        # shares smooth over sampling jitter instead of flapping per trace
        self._stage_seconds: Dict[str, float] = {}
        self._samples_taken = 0
        self._samples_skipped = 0
        self._unmatched_ops = 0
        self._hbm: Dict[int, Dict[str, int]] = {}

    # -- feeding (executor / batcher side) ---------------------------------

    def charge_chunk(
        self,
        busy_s: float,
        bucket_rows: int,
        real_rows: int,
        probe_rows: int = 0,
    ) -> float:
        """Prorate one chunk's device-busy seconds across its canvas rows.

        ``bucket_rows`` is the padded canvas height the device actually
        ran; ``real_rows`` the non-probe riders, ``probe_rows`` the
        probation canaries aboard. Every row costs the same share
        (``busy_s / bucket_rows`` — the device computes padding as hard as
        payload), so request + probe + padding always sums back to
        ``busy_s`` exactly. Returns the per-row share the caller stamps on
        each rider.
        """
        busy = max(float(busy_s), 0.0)
        rows = max(int(bucket_rows), 1)
        real = max(int(real_rows), 0)
        probe = max(int(probe_rows), 0)
        pad = max(rows - real - probe, 0)
        share = busy / rows
        with self._lock:
            self._accounts["request"] += share * real
            self._accounts["probe"] += share * probe
            self._accounts["padding"] += share * pad
        if self.registry is not None and busy > 0:
            for account, amount in (
                ("request", share * real),
                ("probe", share * probe),
                ("padding", share * pad),
            ):
                if amount > 0:
                    self.registry.counter(
                        SERVING_DEVICE_SECONDS_TOTAL,
                        help="device-busy seconds by cost account: request "
                        "(real riders), padding (dead canvas rows), probe "
                        "(probation canaries) — the three sum to the "
                        "executor's recorded busy time",
                        account=account,
                    ).inc(amount)
        return share

    def observe_request(self, seconds: float) -> None:
        """One finished NON-probe request's total device-seconds (its
        prorated share, summed over every dispatch attempt it rode)."""
        s = max(float(seconds), 0.0)
        with self._lock:
            self._request_count += 1
            self._request_seconds += s
        if self.registry is not None:
            self.registry.histogram(
                SERVING_DEVICE_SECONDS_PER_REQUEST,
                help="prorated device-seconds each served request cost "
                "(probe canaries excluded)",
                buckets=DEVICE_SECONDS_BUCKETS,
            ).observe(s)

    def note_profile_skipped(self) -> None:
        """The sampler yielded to a client capture (busy lock) — counted,
        never queued (a queued sample would stack behind an operator's
        pull and fire at an arbitrary later moment)."""
        with self._lock:
            self._samples_skipped += 1
        if self.registry is not None:
            self.registry.counter(
                LEDGER_PROFILE_SKIPPED_TOTAL,
                help="ledger profile samples skipped because a client "
                "GET /debug/profile capture held the profiler lock",
            ).inc()

    def ingest_kernel_sequence(self, bucket: int, sequence: Sequence[Tuple[str, str]]) -> int:
        """One bucket's ``[(op name, stage)]`` from a recorded eager run
        (:func:`kernel_sequence`; the warmup feed); returns its length."""
        seq = [(str(n), str(st)) for n, st in sequence]
        with self._lock:
            self._sequences[int(bucket)] = seq
        return len(seq)

    def set_bucket_hbm(self, bucket: int, cost: Optional[dict]) -> None:
        """One bucket's graph bytes (``BucketGraph.memory``; best-effort —
        absent kinds are simply not published)."""
        if not cost:
            return
        kinds = {
            label: int(cost[key])
            for key, label in HBM_KINDS
            if isinstance(cost.get(key), (int, float))
        }
        if not kinds:
            return
        with self._lock:
            self._hbm[int(bucket)] = kinds

    def ingest_trace_events(self, events: Iterable[dict]) -> Dict[str, float]:
        """Reduce one capture's events into stage self-time and fold it
        into the cumulative shares; returns this sample's stage seconds."""
        with self._lock:
            sequences = list(self._sequences.values())
        labeled, stage_of, unmatched = label_trace_events(events, sequences)
        sample = reduce_trace_events(labeled, stage_of)
        with self._lock:
            self._samples_taken += 1
            self._unmatched_ops += unmatched
            for stage, s in sample.items():
                self._stage_seconds[stage] = (
                    self._stage_seconds.get(stage, 0.0) + s
                )
        return sample

    def ingest_capture(self, capture: dict) -> Dict[str, float]:
        """Full path for one ``capture_profile`` result: unzip, parse the
        Chrome trace, reduce, accumulate."""
        return self.ingest_trace_events(trace_events_from_capture(capture))

    # -- reading (scrape / drain side) -------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            accounts = {a: round(v, 9) for a, v in self._accounts.items()}
            total_stage = sum(self._stage_seconds.values())
            shares = {
                s: round(v / total_stage, 4)
                for s, v in sorted(self._stage_seconds.items())
                if total_stage > 0
            }
            # per-share rounding can overshoot the pie (sum 1.0001); the
            # "shares sum to <= 1" contract is load-bearing (the telemetry
            # checker's gauge-sum gate), so shave the excess off the
            # largest slice
            excess = round(sum(shares.values()) - 1.0, 9)
            if excess > 0:
                top = max(shares, key=shares.get)
                shares[top] = round(shares[top] - excess, 9)
            stage_seconds = {
                s: round(v, 6) for s, v in sorted(self._stage_seconds.items())
            }
            count, seconds = self._request_count, self._request_seconds
            hbm = {b: dict(k) for b, k in sorted(self._hbm.items())}
            taken, skipped = self._samples_taken, self._samples_skipped
            unmatched = self._unmatched_ops
        return {
            "accounts": accounts,
            "device_seconds_total": round(sum(accounts.values()), 9),
            "requests": {
                "count": count,
                "device_seconds_sum": round(seconds, 9),
                "device_seconds_mean": (
                    round(seconds / count, 9) if count else None
                ),
            },
            "stage_shares": shares,
            "stage_seconds": stage_seconds,
            # unmatched_ops: sampled ops that matched no recorded kernel
            # sequence and went to "other" (the port's own key)
            "profile_samples": {"taken": taken, "skipped": skipped,
                                "unmatched_ops": unmatched},
            "hbm_bytes": hbm,
        }

    def publish(self) -> dict:
        """Refresh the ledger gauges from :meth:`snapshot`; returns it.

        Counters and histograms land at feed time; this pushes the
        derived gauges (stage shares, the per-request mean, the HBM
        table) so every scrape and the drain snapshot carry them.
        """
        snap = self.snapshot()
        reg = self.registry
        if reg is None:
            return snap
        for stage, share in snap["stage_shares"].items():
            reg.gauge(
                SERVING_DEVICE_TIME_SHARE,
                help="fraction of sampled device self-time spent in one "
                "pipeline stage (profiler-sampled; shares sum to <= 1)",
                stage=stage,
            ).set(share)
        mean = snap["requests"]["device_seconds_mean"]
        if mean is not None:
            reg.gauge(
                SERVING_DEVICE_SECONDS_PER_REQUEST_MEAN,
                help="mean prorated device-seconds per served request "
                "(probe canaries excluded) — the gauge twin of the "
                "histogram",
            ).set(mean)
        for bucket, kinds in snap["hbm_bytes"].items():
            for kind, nbytes in kinds.items():
                reg.gauge(
                    SERVING_EXECUTABLE_HBM_BYTES,
                    help="per-bucket CUDA graph bytes measured at capture: "
                    "argument/output/temp/peak bytes of each warm serving "
                    "graph",
                    bucket=str(bucket),
                    kind=kind,
                ).set(nbytes)
        return snap


class ProfileSampler:
    """Cadence-driven stage-share sampler for one :class:`DeviceTimeLedger`.

    Every ``interval_s`` it takes a short profiler capture through the
    injected ``capture`` callable (default
    ``utils.profiling.capture_profile``, which owns the process-global
    one-at-a-time lock) and feeds the reduced trace to the ledger. When a
    client ``GET /debug/profile`` pull (or any other profiled section)
    holds the lock the sample is SKIPPED and counted — never queued — so
    an operator's capture is never contended and the sampler can never
    stack behind one. Capture or reduction failures are
    logged and swallowed: sampling must never take serving down.
    """

    def __init__(
        self,
        ledger: DeviceTimeLedger,
        interval_s: float = 30.0,
        duration_ms: int = 200,
        capture: Optional[Callable[[int], dict]] = None,
    ):
        self.ledger = ledger
        self.interval_s = float(interval_s)
        self.duration_ms = int(duration_ms)
        self._capture = capture
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def sample_once(self) -> bool:
        """One sample attempt; True when a trace landed in the ledger."""
        capture = self._capture
        if capture is None:
            from nm03_capstone_project_tpu_torch.utils.profiling import (
                capture_profile as capture,
            )
        try:
            result = capture(self.duration_ms)
        except Exception as exc:
            from nm03_capstone_project_tpu_torch.utils.profiling import ProfileBusy

            if isinstance(exc, ProfileBusy):
                self.ledger.note_profile_skipped()
            else:
                _log.warning("ledger profile capture failed: %s", exc)
            return False
        try:
            self.ledger.ingest_capture(result)
        except Exception as exc:
            _log.warning("ledger trace reduction failed: %s", exc)
            return False
        return True

    def start(self) -> None:
        if self.interval_s <= 0 or self._thread is not None:
            return
        # nm03-lint: disable=NM331 start()/stop() run on the owning thread; the sampler thread never reads _thread
        self._thread = threading.Thread(
            target=self._run, name="ledger-sampler", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.sample_once()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
            # nm03-lint: disable=NM331 start()/stop() run on the owning thread; the sampler thread never reads _thread
            self._thread = None
