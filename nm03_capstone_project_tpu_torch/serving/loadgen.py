"""``nm03-loadgen``: closed/open-loop load generator for the server.

The port's copy of the JAX package's ``nm03-loadgen``, the same flags,
traffic models and summary schema, so either package's load generator
drives either package's server. It measures the serving path — queue
wait, coalescing, shed behaviour — with the numbers capacity planning
needs: p50/p95/p99 end-to-end latency, sustained throughput, status mix,
and the observed batch-size distribution (from the server's
``X-Nm03-Batch-Size`` header, the direct evidence that dynamic batching
coalesced anything). Every request carries a unique
``X-Nm03-Request-Id`` the server honours as its trace id and echoes back;
the per-request records in ``--results-json`` (sent/echoed id,
server-reported queue-wait and lane) join client-side latencies to the
server-side span trees.

Two traffic models:

* **closed loop** (default): ``--concurrency`` workers, each with one
  request outstanding — throughput is offered-load-limited, the classic
  saturation probe;
* **open loop** (``--rate R``): requests fire on a fixed schedule no
  matter how the server is doing — the model that actually exposes queue
  growth and shedding (closed loops self-throttle and hide both).

``--targets URL[,URL...]`` is the multi-target mode: request *i* goes to
``targets[i % n]``. ``--self-serve`` brings up the port's server in this
process (ephemeral port) first, on ``cuda`` unless ``--device cpu`` is
given: ``python -m nm03_capstone_project_tpu_torch.serving.loadgen
--self-serve --device cpu --requests 40``. Pure stdlib HTTP client;
payloads are synthetic phantom slices sent as raw float32 arrays
(``--dicom`` sends real Part-10 bytes through the full parser path
instead). :func:`run_load` and :class:`LoadResult` are the library
surface for callers with bodies of their own.
"""

from __future__ import annotations

import argparse
import collections
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
import uuid
from typing import List, Optional

import numpy as np

from nm03_capstone_project_tpu_torch.obs.metrics import (
    SERVING_BUSY_FRACTION,
    SERVING_MFU,
    SERVING_PADDING_WASTE_RATIO,
)
from nm03_capstone_project_tpu_torch.serving.metrics import SERVING_BATCHES_TOTAL


def parse_slo_spec(spec: str) -> dict:
    """``availability=99.5,p99_ms=500`` -> {availability, p99_ms}.

    Either key may be omitted (at least one required); values are floats.
    Raises ValueError on malformed input (the CLI maps it to a usage
    error).
    """
    out: dict = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        k, eq, v = part.partition("=")
        k = k.strip()
        if not eq or k not in ("availability", "p99_ms"):
            raise ValueError(
                f"--expect-slo wants availability=PCT and/or p99_ms=MS, "
                f"got {part!r}"
            )
        try:
            out[k] = float(v.strip())
        except ValueError:
            raise ValueError(
                f"--expect-slo value for {k} must be a number, got "
                f"{v.strip()!r}"
            ) from None
    if not out:
        raise ValueError("--expect-slo needs at least one objective")
    if "availability" in out and not 0.0 < out["availability"] <= 100.0:
        raise ValueError(
            f"--expect-slo availability must be in (0, 100], got "
            f"{out['availability']}"
        )
    return out


def evaluate_slo(summary: dict, expect: dict) -> dict:
    """The client-side SLO gate verdict over one run's summary.

    Availability is judged on the CLIENT's view — ok requests over total
    — and p99 on the client-observed end-to-end latency, so the gate
    measures what users saw, not what any one process published. Returns
    ``{pass, checks: {...}}`` (each check: expected/observed/pass).
    """
    checks: dict = {}
    if "availability" in expect:
        total = summary.get("requests_total") or 0
        ok = summary.get("requests_ok") or 0
        observed = (ok / total * 100.0) if total else 0.0
        checks["availability"] = {
            "expected_pct": expect["availability"],
            "observed_pct": round(observed, 4),
            "pass": observed >= expect["availability"],
        }
    if "p99_ms" in expect:
        observed = (summary.get("latency_ms") or {}).get("p99")
        checks["p99_ms"] = {
            "expected_ms": expect["p99_ms"],
            "observed_ms": observed,
            "pass": observed is not None and observed <= expect["p99_ms"],
        }
    return {
        "pass": all(c["pass"] for c in checks.values()),
        "checks": checks,
    }


def _percentile(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile on an already-sorted list."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1, int(round(p / 100.0 * len(sorted_vals))) - 1))
    return sorted_vals[k]


class LoadResult:
    """Thread-safe accumulator for per-request observations."""

    # per-request records kept for --results-json; bounded so a very long
    # soak cannot balloon the artifact
    MAX_REQUEST_RECORDS = 10000

    def __init__(self):
        self._lock = threading.Lock()
        self.latencies_s: List[float] = []
        self.statuses: collections.Counter = collections.Counter()
        self.batch_sizes: collections.Counter = collections.Counter()
        self.queue_waits_s: List[float] = []
        self.lanes: collections.Counter = collections.Counter()
        # fleet attribution: which replica answered (the
        # fleet payload's `replica`, or the target URL when driving
        # replicas directly) and how many failover hops riders took
        self.replicas: collections.Counter = collections.Counter()
        self.failovers = 0
        self.requests_dropped = 0
        self.requests: List[dict] = []
        self.echo_mismatches = 0
        self.errors: List[str] = []
        # whole-volume attribution: per-request z-shard counts
        # and gang-waits from the /v1/segment-volume response payload
        self.zshards: collections.Counter = collections.Counter()
        self.gang_waits_s: List[float] = []
        # device-cost attribution: each ok response's prorated
        # `device_seconds` payload field — the client-side view of the
        # serving_device_seconds_per_request histogram
        self.device_seconds: List[float] = []
        # result-tier attribution: each ok response's
        # X-Nm03-Cache verdict (hit | miss | fill), with the latency and
        # device-seconds distributions split served-from-cache vs
        # computed — the zipfian replay's evidence columns
        self.cache_states: collections.Counter = collections.Counter()
        self.latencies_hit_s: List[float] = []
        self.latencies_miss_s: List[float] = []
        self.device_seconds_hit: List[float] = []
        self.device_seconds_miss: List[float] = []

    def record(self, status: str, latency_s: float, batch_size: int = 0,
               error: str = "", sent_id: str = "", echoed_id: str = "",
               queue_wait_s: Optional[float] = None,
               lane: Optional[int] = None,
               replica: Optional[str] = None,
               replica_hops: Optional[int] = None,
               z_shards: Optional[int] = None,
               gang_wait_s: Optional[float] = None,
               device_s: Optional[float] = None,
               cache_state: Optional[str] = None) -> None:
        with self._lock:
            self.statuses[status] += 1
            if status == "ok":
                self.latencies_s.append(latency_s)
                if batch_size:
                    self.batch_sizes[batch_size] += 1
                if queue_wait_s is not None:
                    self.queue_waits_s.append(queue_wait_s)
                if lane is not None:
                    self.lanes[lane] += 1
                if replica is not None:
                    self.replicas[replica] += 1
                if replica_hops:
                    self.failovers += 1
                if z_shards is not None:
                    self.zshards[int(z_shards)] += 1
                if gang_wait_s is not None:
                    self.gang_waits_s.append(gang_wait_s)
                if device_s is not None:
                    self.device_seconds.append(device_s)
                if cache_state is not None:
                    self.cache_states[cache_state] += 1
                    if cache_state == "hit":
                        self.latencies_hit_s.append(latency_s)
                        if device_s is not None:
                            self.device_seconds_hit.append(device_s)
                    else:  # miss and fill both computed
                        self.latencies_miss_s.append(latency_s)
                        if device_s is not None:
                            self.device_seconds_miss.append(device_s)
            elif error and len(self.errors) < 20:
                self.errors.append(error)
            if sent_id and echoed_id and sent_id != echoed_id:
                self.echo_mismatches += 1
            if len(self.requests) < self.MAX_REQUEST_RECORDS:
                rec = {
                    "id": sent_id,
                    "echoed_id": echoed_id,
                    "status": status,
                    "latency_ms": round(latency_s * 1e3, 3),
                }
                if queue_wait_s is not None:
                    rec["queue_wait_ms"] = round(queue_wait_s * 1e3, 3)
                if lane is not None:
                    rec["lane"] = lane
                if batch_size:
                    rec["batch_size"] = batch_size
                if replica is not None:
                    rec["replica"] = replica
                if replica_hops is not None:
                    rec["replica_hops"] = replica_hops
                if z_shards is not None:
                    rec["z_shards"] = int(z_shards)
                if gang_wait_s is not None:
                    rec["gang_wait_ms"] = round(gang_wait_s * 1e3, 3)
                if device_s is not None:
                    rec["device_seconds"] = round(device_s, 9)
                if cache_state is not None:
                    rec["cache"] = cache_state
                self.requests.append(rec)
            else:
                # counted, not silent: a soak past the cap must say so in
                # the artifact, or a server-side join reads the missing
                # tail as requests with no client record
                self.requests_dropped += 1

    def summary(self, wall_s: float, mode: str) -> dict:
        lat = sorted(self.latencies_s)
        n_ok = len(lat)
        total = sum(self.statuses.values())
        out = {
            "schema": "nm03.loadgen.v1",
            "mode": mode,
            "requests_total": total,
            "requests_ok": n_ok,
            "statuses": dict(sorted(self.statuses.items())),
            "wall_s": round(wall_s, 3),
            "throughput_rps": round(n_ok / wall_s, 2) if wall_s > 0 else 0.0,
            "latency_ms": {
                "p50": round(_percentile(lat, 50) * 1e3, 2),
                "p95": round(_percentile(lat, 95) * 1e3, 2),
                "p99": round(_percentile(lat, 99) * 1e3, 2),
                "mean": round(sum(lat) / n_ok * 1e3, 2) if n_ok else 0.0,
                "max": round(lat[-1] * 1e3, 2) if n_ok else 0.0,
            },
            # {batch_size: ok-request count}: >1 keys = coalescing happened
            "batch_sizes": {str(k): v for k, v in sorted(self.batch_sizes.items())},
            "max_observed_batch": max(self.batch_sizes) if self.batch_sizes else 0,
        }
        # server-reported attribution (X-Nm03-Queue-Wait-Ms / X-Nm03-Lane):
        # the queue-wait distribution separates "the server was slow" from
        # "the request waited", and lanes_observed is the client-side view
        # of the fleet fan-out
        qw = sorted(self.queue_waits_s)
        out["queue_wait_ms"] = {
            "p50": round(_percentile(qw, 50) * 1e3, 2),
            "p95": round(_percentile(qw, 95) * 1e3, 2),
            "p99": round(_percentile(qw, 99) * 1e3, 2),
            "mean": round(sum(qw) / len(qw) * 1e3, 2) if qw else 0.0,
        }
        out["lanes_observed"] = {str(k): v for k, v in sorted(self.lanes.items())}
        # fleet attribution: ok-request counts by answering
        # replica (>1 keys = the fleet really spread the load) and the
        # riders that outlived a replica via failover (replica_hops >= 1)
        out["replicas_observed"] = {
            str(k): v for k, v in sorted(self.replicas.items())
        }
        out["failovers_observed"] = self.failovers
        # whole-volume evidence: which mesh widths served the
        # volumes and the gang-wait distribution — the request-level view
        # of the serving_volume_* gauges the acceptance drill gates
        if self.zshards:
            gw = sorted(self.gang_waits_s)
            out["volume"] = {
                "zshards_observed": {
                    str(k): v for k, v in sorted(self.zshards.items())
                },
                "gang_wait_ms": {
                    "p50": round(_percentile(gw, 50) * 1e3, 3),
                    "p95": round(_percentile(gw, 95) * 1e3, 3),
                    "max": round(gw[-1] * 1e3, 3) if gw else 0.0,
                    "mean": round(sum(gw) / len(gw) * 1e3, 3) if gw else 0.0,
                },
            }
        # device-cost evidence: the prorated device-seconds
        # distribution clients were billed — the request-level view of
        # serving_device_seconds_total{account="request"}. Milliseconds,
        # like every other latency block in this summary.
        if self.device_seconds:
            ds = sorted(self.device_seconds)
            out["device_seconds_ms"] = {
                "p50": round(_percentile(ds, 50) * 1e3, 3),
                "p95": round(_percentile(ds, 95) * 1e3, 3),
                "mean": round(sum(ds) / len(ds) * 1e3, 3),
                "max": round(ds[-1] * 1e3, 3),
                "sum_s": round(sum(ds), 6),
            }
            # the result-tier split: what a hit is worth —
            # hit_mean must read ~0.0 (a hit charges no device time),
            # miss_mean is what each cold study actually cost
            if self.device_seconds_hit or self.device_seconds_miss:
                dh, dm = self.device_seconds_hit, self.device_seconds_miss
                out["device_seconds_ms"]["hit_mean"] = (
                    round(sum(dh) / len(dh) * 1e3, 6) if dh else None
                )
                out["device_seconds_ms"]["miss_mean"] = (
                    round(sum(dm) / len(dm) * 1e3, 6) if dm else None
                )
        # result-tier evidence: the hit ratio clients saw
        # (X-Nm03-Cache: hit over every response that carried the
        # header) and the latency split that prices a repeat study
        if self.cache_states:
            total_states = sum(self.cache_states.values())
            hits = self.cache_states.get("hit", 0)
            lh = sorted(self.latencies_hit_s)
            lm = sorted(self.latencies_miss_s)
            out["cache_hit_ratio"] = round(hits / total_states, 4)
            out["cache"] = {
                "states": dict(sorted(self.cache_states.items())),
                "hit_latency_ms": {
                    "p50": round(_percentile(lh, 50) * 1e3, 3),
                    "p95": round(_percentile(lh, 95) * 1e3, 3),
                },
                "miss_latency_ms": {
                    "p50": round(_percentile(lm, 50) * 1e3, 3),
                    "p95": round(_percentile(lm, 95) * 1e3, 3),
                },
            }
        out["trace_echo_mismatches"] = self.echo_mismatches
        if self.requests_dropped:
            out["requests_record_cap"] = self.MAX_REQUEST_RECORDS
            out["requests_records_dropped"] = self.requests_dropped
        if self.errors:
            out["error_sample"] = self.errors[:5]
        return out


def _make_payloads(height: int, width: int, n_distinct: int, dicom: bool):
    """Pre-build request bodies (payload build must not pollute latency).

    Raw mode sends little-endian float32 with the dims in headers; DICOM
    mode writes real Part-10 bytes so the server exercises the actual
    parser. A few distinct phantoms (lesion radius varies with seed) keep
    the server from serving one memoized answer shape.
    """
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice

    payloads = []
    for i in range(n_distinct):
        img = phantom_slice(height, width, seed=i)
        if dicom:
            from nm03_capstone_project_tpu_torch.data.dicomlite import write_dicom

            import os
            import tempfile

            fd, path = tempfile.mkstemp(suffix=".dcm")
            os.close(fd)
            try:
                write_dicom(path, np.clip(img, 0, 65535).astype(np.uint16))
                with open(path, "rb") as f:
                    body = f.read()
            finally:
                os.unlink(path)
            headers = {"Content-Type": "application/dicom"}
        else:
            body = img.astype("<f4").tobytes()
            headers = {
                "Content-Type": "application/octet-stream",
                "X-Nm03-Height": str(height),
                "X-Nm03-Width": str(width),
            }
        payloads.append((body, headers))
    return payloads


def _make_volume_payloads(
    depth: int, height: int, width: int, n_distinct: int, dicom: bool
):
    """Pre-build whole-study request bodies (``--volume`` mode).

    Raw mode stacks ``depth`` phantom slices as little-endian float32
    with the dims in X-Nm03-Depth/Height/Width; DICOM mode writes one
    Part-10 file per plane and concatenates them under the length-
    prefixed ``application/x-nm03-dicom-parts`` framing the server
    decodes.
    """
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume

    payloads = []
    for i in range(n_distinct):
        vol = np.asarray(
            phantom_volume(n_slices=depth, height=height, width=width, seed=i),
            np.float32,
        )
        if dicom:
            import os
            import tempfile

            from nm03_capstone_project_tpu_torch.data.dicomlite import write_dicom

            parts = []
            fd, path = tempfile.mkstemp(suffix=".dcm")
            os.close(fd)
            try:
                for plane in vol:
                    write_dicom(
                        path, np.clip(plane, 0, 65535).astype(np.uint16)
                    )
                    with open(path, "rb") as f:
                        raw = f.read()
                    parts.append(len(raw).to_bytes(4, "little") + raw)
            finally:
                os.unlink(path)
            body = b"".join(parts)
            headers = {"Content-Type": "application/x-nm03-dicom-parts"}
        else:
            body = vol.astype("<f4").tobytes()
            headers = {
                "Content-Type": "application/octet-stream",
                "X-Nm03-Depth": str(depth),
                "X-Nm03-Height": str(height),
                "X-Nm03-Width": str(width),
            }
        payloads.append((body, headers))
    return payloads


def _zipf_schedule(payloads, n_requests: int, s: float):
    """Expand ``payloads`` into a per-request zipfian replay.

    Request *i* sends ``schedule[i % n]`` — ``run_load``'s round-robin
    indexing — so pre-drawing the whole schedule turns study REUSE into
    plain list repetition with zero change to the send path (the entries
    alias the same body bytes; nothing is copied). Rank *r* is drawn
    with P(r) ∝ 1/r^s over the keyspace; at s ≈ 1.1 over 32 studies the
    hottest study is roughly a quarter of all traffic — the skew a
    hospital's repeat-read workload actually shows, and the one the
    result tier is priced against. The seed is fixed: two runs replay
    the identical request stream, so a cold-vs-warm comparison differs
    only in cache state.
    """
    ranks = np.arange(1, len(payloads) + 1, dtype=np.float64)
    probs = ranks ** -float(s)
    probs /= probs.sum()
    rng = np.random.default_rng(20260807)
    draws = rng.choice(len(payloads), size=max(1, int(n_requests)), p=probs)
    return [payloads[int(i)] for i in draws]


def _one_request(url: str, body: bytes, headers: dict, timeout_s: float,
                 result: LoadResult, req_id: str = "") -> None:
    t0 = time.monotonic()
    if req_id:
        headers = {**headers, "X-Nm03-Request-Id": req_id}
    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            data = resp.read()
            bs = int(resp.headers.get("X-Nm03-Batch-Size", 0))
            echoed = resp.headers.get("X-Nm03-Request-Id", "")
            qw_hdr = resp.headers.get("X-Nm03-Queue-Wait-Ms")
            lane_hdr = resp.headers.get("X-Nm03-Lane")
            try:
                qw = float(qw_hdr) / 1e3 if qw_hdr is not None else None
            except ValueError:
                qw = None
            try:
                lane = int(lane_hdr) if lane_hdr not in (None, "None") else None
            except ValueError:
                lane = None
            # fleet attribution: the payload's replica /
            # replica_hops (the fleet front-end's truth fields), header
            # then target-host:port fallback — so replicas_observed is
            # meaningful whether --targets drives a fleet or replicas
            # directly (a bare replica names no replica itself)
            replica = (
                resp.headers.get("X-Nm03-Replica")
                or urllib.parse.urlsplit(url).netloc
            )
            # result-tier verdict: hit | miss | fill, absent
            # when neither tier is enabled on the serving side
            cache_state = resp.headers.get("X-Nm03-Cache")
            hops = None
            z_shards = gang_wait = device_s = None
            try:
                payload = json.loads(data)
                if isinstance(payload, dict):
                    replica = payload.get("replica") or replica
                    hops = payload.get("replica_hops")
                    # whole-volume truth fields: present only
                    # on /v1/segment-volume responses
                    z_shards = payload.get("z_shards")
                    gang_wait = payload.get("gang_wait_s")
                    # prorated device cost
                    device_s = payload.get("device_seconds")
            except (json.JSONDecodeError, UnicodeDecodeError):
                pass
            result.record(
                "ok", time.monotonic() - t0, batch_size=bs, sent_id=req_id,
                echoed_id=echoed, queue_wait_s=qw, lane=lane,
                replica=replica, replica_hops=hops,
                z_shards=z_shards, gang_wait_s=gang_wait,
                device_s=device_s, cache_state=cache_state,
            )
    except urllib.error.HTTPError as e:
        echoed = e.headers.get("X-Nm03-Request-Id", "") if e.headers else ""
        e.read()
        status = {503: "shed", 504: "timeout"}.get(e.code, f"http_{e.code}")
        result.record(status, time.monotonic() - t0, error=f"HTTP {e.code}",
                      sent_id=req_id, echoed_id=echoed)
    except Exception as e:  # noqa: BLE001 — a load test records, never dies
        result.record("error", time.monotonic() - t0, error=str(e),
                      sent_id=req_id)


def run_load(
    url,
    payloads,
    n_requests: int,
    concurrency: int,
    rate_rps: float,
    timeout_s: float,
    result: Optional[LoadResult] = None,
) -> dict:
    """Drive the load; returns the summary dict.

    ``url`` is one endpoint or a list of them (``--targets`` multi-target
    mode, ): request *i* goes to ``urls[i % len(urls)]`` — an
    even spread whether the targets are one fleet front-end or the
    replicas driven directly. Every request carries a unique
    ``X-Nm03-Request-Id`` (``lg-<run>-<n>``) that the server honors as
    the trace id and echoes back — the handle that joins a loadgen
    record to its server-side span tree (``nm03-trace``) and
    flight-recorder entries.
    """
    urls = [url] if isinstance(url, str) else list(url)
    result = result if result is not None else LoadResult()
    run_tag = uuid.uuid4().hex[:6]

    def req_id(i: int) -> str:
        return f"lg-{run_tag}-{i:06d}"

    t_start = time.monotonic()
    if rate_rps and rate_rps > 0:
        # open loop: fixed schedule, one thread per in-flight request —
        # send times never wait on responses, so queue growth is visible
        threads = []
        interval = 1.0 / rate_rps
        for i in range(n_requests):
            target = t_start + i * interval
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            body, headers = payloads[i % len(payloads)]
            t = threading.Thread(
                target=_one_request,
                args=(urls[i % len(urls)], body, headers, timeout_s, result,
                      req_id(i)),
                daemon=True,
            )
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=timeout_s + 5)
        mode = f"open_loop@{rate_rps}rps"
    else:
        # closed loop: `concurrency` workers pulling a shared counter
        counter = iter(range(n_requests))
        lock = threading.Lock()

        def worker():
            while True:
                with lock:
                    i = next(counter, None)
                if i is None:
                    return
                body, headers = payloads[i % len(payloads)]
                _one_request(urls[i % len(urls)], body, headers, timeout_s,
                             result, req_id(i))

        workers = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(max(1, concurrency))
        ]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=n_requests * (timeout_s + 5))
        mode = f"closed_loop@c{concurrency}"
    return result.summary(time.monotonic() - t_start, mode)


def probe_server_topology(url: str, timeout_s: float = 5.0) -> dict:
    """Best-effort ``/readyz`` probe for the serving topology fields.

    Returns ``{lanes, mesh_shape, buckets, degraded}`` (values None when
    the server is unreachable or predates the fleet fields). The body is
    parsed whatever the status code — a draining or degraded server still
    reports its shape, and the loadgen record must carry the topology the
    measurement actually ran against (a p99 from one lane must not
    masquerade as an eight-card number).
    """
    out = {
        "lanes": None, "mesh_shape": None, "buckets": None, "degraded": None,
        "capacity": None, "lanes_quarantined": None,
        "is_fleet": False, "replicas": None, "replicas_ready": None,
        "replicas_ejected": None,
    }
    req = urllib.request.Request(f"{url}/readyz", method="GET")
    try:
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                body = resp.read()
        except urllib.error.HTTPError as e:  # 503 still carries the payload
            body = e.read()
        st = json.loads(body or b"{}")
    except Exception:  # noqa: BLE001 — a probe failure must not fail the run
        return out
    lanes = (st.get("lanes") or {}).get("count")
    out["lanes"] = lanes
    out["mesh_shape"] = st.get("mesh_shape")
    out["buckets"] = st.get("buckets")
    out["degraded"] = st.get("degraded")
    # partial-capacity fields: the healthy-lane fraction and the
    # quarantined count a chaos run's plateau is explained by
    out["capacity"] = st.get("capacity")
    out["lanes_quarantined"] = (st.get("lanes") or {}).get("quarantined")
    # fleet front-end fields: when the probed URL is an
    # nm03-fleet router, `capacity` above is the ROUTED fraction and the
    # replicas block explains a chaos run's plateau one level up
    reps = st.get("replicas")
    if isinstance(reps, dict):
        out["is_fleet"] = True
        out["replicas"] = reps.get("count")
        out["replicas_ready"] = reps.get("ready")
        out["replicas_ejected"] = reps.get("ejected")
    return out


def probe_server_efficiency(url: str, timeout_s: float = 5.0) -> dict:
    """Best-effort saturation read from ``/metrics.json``.

    Returns ``{busy_fraction, padding_waste_ratio, mfu, batches_total}``
    (Nones when unreachable or the server predates the saturation layer).
    The scrape itself refreshes the server's sliding-window gauges, so a
    poll DURING the run reads live utilization, not a stale publish.
    """
    out = {
        "busy_fraction": None, "padding_waste_ratio": None, "mfu": None,
        "batches_total": None,
    }
    req = urllib.request.Request(f"{url}/metrics.json", method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            snap = json.loads(resp.read())
    except Exception:  # noqa: BLE001 — a probe failure must not fail the run
        return out
    batches = 0.0
    for rec in snap.get("metrics", []):
        name, value = rec.get("name"), rec.get("value")
        if not isinstance(value, (int, float)):
            continue
        if rec.get("type") == "gauge" and not rec.get("labels"):
            if name == SERVING_BUSY_FRACTION:
                out["busy_fraction"] = float(value)
            elif name == SERVING_PADDING_WASTE_RATIO:
                out["padding_waste_ratio"] = float(value)
            elif name == SERVING_MFU:
                out["mfu"] = float(value)
        elif rec.get("type") == "counter" and name == SERVING_BATCHES_TOTAL:
            batches += float(value)
            out["batches_total"] = batches
    return out


class CapacityWatch:
    """Background ``/readyz`` + ``/metrics.json`` poller for a load run.

    A single post-run probe would miss a quarantine that probation already
    healed; polling during the run records the partial-capacity PLATEAU a
    chaos drill's throughput dip is explained by —
    ``lanes_quarantined_observed`` is the peak quarantined count and
    ``capacity_min_observed`` the floor the fleet served at. The
    efficiency join: ``busy_fraction_min_observed`` is the
    utilization floor once traffic began (samples before the first device
    batch are skipped — a cold fleet's honest 0.0 would say nothing about
    the run), ``padding_waste_max_observed``/``mfu_max_observed`` the
    worst padding and best flops utilization seen live.
    """

    def __init__(self, url: str, interval_s: float = 0.5):
        self.url = url
        self.interval_s = interval_s
        # written by the poller thread, read by main after stop(): the
        # lock (not the join fence alone) keeps start()'s inline sample,
        # the poller, and stop()'s final sample coherent
        self._lock = threading.Lock()
        self.max_quarantined: Optional[int] = None
        self.min_capacity: Optional[float] = None
        self.min_busy: Optional[float] = None
        self.max_padding: Optional[float] = None
        self.max_mfu: Optional[float] = None
        # fleet-level floors: only move when the watched URL
        # is an nm03-fleet front-end (its /readyz carries a replicas
        # block) — the ⅔ plateau a kill-a-replica drill is read from
        self.min_fleet_capacity: Optional[float] = None
        self.max_replicas_ejected: Optional[int] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="nm03-loadgen-capwatch", daemon=True
        )

    def _sample(self) -> None:
        topo = probe_server_topology(self.url, timeout_s=2.0)
        eff = probe_server_efficiency(self.url, timeout_s=2.0)
        q, c = topo["lanes_quarantined"], topo["capacity"]
        with self._lock:
            if q is not None:
                self.max_quarantined = max(self.max_quarantined or 0, int(q))
            if c is not None:
                self.min_capacity = (
                    float(c) if self.min_capacity is None
                    else min(self.min_capacity, float(c))
                )
            busy = eff["busy_fraction"]
            if busy is not None and (eff["batches_total"] or 0) > 0:
                self.min_busy = (
                    busy if self.min_busy is None else min(self.min_busy, busy)
                )
            if eff["padding_waste_ratio"] is not None:
                self.max_padding = max(
                    self.max_padding or 0.0, eff["padding_waste_ratio"]
                )
            if eff["mfu"] is not None:
                self.max_mfu = max(self.max_mfu or 0.0, eff["mfu"])
            if topo["is_fleet"]:
                if c is not None:
                    self.min_fleet_capacity = (
                        float(c) if self.min_fleet_capacity is None
                        else min(self.min_fleet_capacity, float(c))
                    )
                if topo["replicas_ejected"] is not None:
                    self.max_replicas_ejected = max(
                        self.max_replicas_ejected or 0,
                        int(topo["replicas_ejected"]),
                    )

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._sample()

    def start(self) -> "CapacityWatch":
        self._sample()  # one guaranteed sample even on a very short run
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._sample()  # the post-run view (reinstated fleets read 0 here)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nm03-loadgen", description=__doc__.strip().splitlines()[0]
    )
    p.add_argument(
        "--url", default="http://127.0.0.1:8077", help="server base URL"
    )
    p.add_argument(
        "--targets", default=None, metavar="URL[,URL...]",
        help="multi-target mode: comma list of base URLs — an "
        "nm03-fleet front-end or replicas driven directly; request i goes "
        "to targets[i %% n] and the summary gains replicas_observed / "
        "failovers_observed / fleet_capacity_min_observed. Overrides --url",
    )
    p.add_argument("--requests", type=int, default=100, help="total requests")
    p.add_argument(
        "--concurrency", type=int, default=8,
        help="closed-loop workers (ignored with --rate)",
    )
    p.add_argument(
        "--rate", type=float, default=0.0, metavar="RPS",
        help="open-loop arrival rate; 0 = closed loop",
    )
    p.add_argument(
        "--mode", choices=["mask", "jpeg"], default="mask",
        help="response payload: mask summary (cheap; throughput probe) or "
        "the full JPEG pair (the end-user path)",
    )
    p.add_argument("--height", type=int, default=128, help="phantom slice height")
    p.add_argument("--width", type=int, default=128, help="phantom slice width")
    p.add_argument(
        "--volume", action="store_true",
        help="whole-study mode: POST synthetic multi-slice "
        "studies to /v1/segment-volume instead of slices to /v1/segment; "
        "the summary gains a `volume` block (per-request z-shard counts "
        "and the gang-wait distribution from the response payload)",
    )
    p.add_argument(
        "--volume-depth", type=int, default=8, metavar="D",
        help="planes per synthetic study in --volume mode (must fit the "
        "server's --volume-depth-buckets)",
    )
    p.add_argument(
        "--dicom", action="store_true",
        help="send real Part-10 DICOM bytes (full parser path) instead of "
        "raw float32 arrays",
    )
    p.add_argument(
        "--distinct", type=int, default=4, help="distinct pre-built payloads"
    )
    p.add_argument(
        "--zipf", type=float, default=0.0, metavar="S",
        help="zipfian study-reuse replay: draw each request's "
        "payload with P(rank r) ∝ 1/r^S over --keyspace distinct studies "
        "(S≈1.1 is a realistic hot-study skew; 0 disables) — the mode "
        "that exercises the result tier; the summary gains "
        "cache_hit_ratio and the hit/miss latency and device-seconds "
        "split",
    )
    p.add_argument(
        "--keyspace", type=int, default=32, metavar="N",
        help="distinct synthetic studies the --zipf draw ranges over "
        "(replaces --distinct in zipf mode)",
    )
    p.add_argument("--timeout-s", type=float, default=30.0, help="per-request timeout")
    p.add_argument(
        "--warmup", type=int, default=4,
        help="unmeasured warmup requests before the run",
    )
    p.add_argument(
        "--results-json", default=None,
        help="write the summary JSON here (the serving evidence artifact)",
    )
    p.add_argument(
        "--self-serve", action="store_true",
        help="bring up the port's server in this process on an ephemeral port "
        "first (zero-setup smoke)",
    )
    p.add_argument(
        "--self-serve-args", default="",
        help="extra server flags for --self-serve, space-separated "
        '(e.g. "--canvas 128 --max-wait-ms 25")',
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where a --self-serve server runs: the GPU (default; without one "
        "it fails) or, on request, the CPU",
    )
    p.add_argument(
        "--expect-slo", default=None, metavar="SPEC",
        help="gate the run against a client-side SLO: "
        "'availability=99.5,p99_ms=500' (either key optional) — exit "
        "non-zero when the observed ok-fraction falls below the "
        "availability or the client p99 exceeds the target; the verdict "
        "rides the summary as `slo_gate`",
    )
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    expect_slo = None
    if args.expect_slo:
        try:
            expect_slo = parse_slo_spec(args.expect_slo)
        except ValueError as e:
            parser.error(str(e))
    httpd = app = None
    url = args.url
    if args.self_serve:
        from nm03_capstone_project_tpu_torch.serving import server as serving_server

        serve_args = serving_server.build_parser().parse_args(
            ["--device", args.device, *args.self_serve_args.split()]
        )
        app = serving_server.app_from_args(serve_args)
        httpd, _, port = serving_server.serve_in_thread(app)
        url = f"http://127.0.0.1:{port}"
        print(f"loadgen: self-serve listening on {url}", flush=True)

    if args.targets:
        # multi-target mode: spread requests over the list; the
        # capacity watch and the topology probe read the FIRST target
        # (point it at the fleet front-end to watch the routed capacity)
        bases = [t.strip().rstrip("/") for t in args.targets.split(",")
                 if t.strip()]
        if not bases:
            print("loadgen: --targets needs at least one URL", flush=True)
            return 2
        url = bases[0]
    else:
        bases = [url]
    # zipf replay mode: the keyspace replaces --distinct and
    # the payload list becomes a pre-drawn per-request schedule
    zipf_on = args.zipf and args.zipf > 0
    n_distinct = max(1, args.keyspace) if zipf_on else args.distinct
    if args.volume:
        # whole-study mode: the summary payload (no mask bytes) keeps the
        # wire cheap — the gates read z_shards/gang_wait_s, not the mask
        endpoints = [f"{b}/v1/segment-volume?output=summary" for b in bases]
        payloads = _make_volume_payloads(
            args.volume_depth, args.height, args.width, n_distinct,
            args.dicom,
        )
    else:
        endpoints = [f"{b}/v1/segment?output={args.mode}" for b in bases]
        payloads = _make_payloads(
            args.height, args.width, n_distinct, args.dicom
        )
    if zipf_on:
        payloads = _zipf_schedule(payloads, args.requests, args.zipf)
    endpoint = endpoints[0]
    if args.warmup > 0:
        warm = LoadResult()  # discarded: compile/cache effects stay out
        run_load(endpoints, payloads, args.warmup, min(args.warmup, 4), 0.0,
                 args.timeout_s, warm)
    result = LoadResult()
    # poll /readyz through the run: a mid-run quarantine that probation
    # heals before the final probe must still land in the summary
    watch = CapacityWatch(url).start()
    summary = run_load(
        endpoints, payloads, args.requests, args.concurrency, args.rate,
        args.timeout_s, result,
    )
    watch.stop()
    summary["endpoint"] = endpoint
    if args.targets:
        summary["targets"] = bases
    if zipf_on:
        summary["zipf"] = {"s": args.zipf, "keyspace": n_distinct}
    # serving topology alongside the numbers (mesh_shape/lanes ride next to
    # the drivers' backend_requested/backend_actual honesty pair): probed
    # from the live server so the record describes what actually served
    topo = probe_server_topology(url, timeout_s=args.timeout_s)
    summary["lanes"] = topo["lanes"]
    summary["mesh_shape"] = topo["mesh_shape"]
    # the partial-capacity evidence: peak quarantined lanes and
    # the capacity floor observed DURING the run, plus the final fraction
    summary["lanes_quarantined_observed"] = watch.max_quarantined
    summary["capacity_min_observed"] = watch.min_capacity
    summary["capacity"] = topo["capacity"]
    # server-side efficiency joined to the client-side numbers:
    # a p99 means something different at 20% lane utilization than at 95%
    summary["busy_fraction_min_observed"] = watch.min_busy
    summary["padding_waste_max_observed"] = watch.max_padding
    summary["mfu_max_observed"] = watch.max_mfu
    # fleet-level evidence: the routed-capacity floor and the
    # peak ejected count observed DURING the run — the numbers that
    # explain a kill-a-replica drill's throughput dip (None when the
    # watched URL is not an nm03-fleet front-end)
    summary["fleet_capacity_min_observed"] = watch.min_fleet_capacity
    summary["replicas_ejected_max_observed"] = watch.max_replicas_ejected
    summary["replicas"] = topo["replicas"]
    summary["replicas_ready"] = topo["replicas_ready"]
    # the client-side SLO gate: judged on what clients SAW —
    # the verdict rides the artifact whether or not it passes
    if expect_slo is not None:
        summary["slo_gate"] = evaluate_slo(summary, expect_slo)
    if args.self_serve and app is not None:
        app.begin_drain(reason="loadgen_done")
        httpd.shutdown()
        httpd.server_close()
        app.close(status="ok")
        summary["server_status"] = app.status()
    if args.results_json:
        from nm03_capstone_project_tpu_torch.utils.timing import write_results_json

        # per-request records (sent/echoed trace id, server-reported
        # queue-wait and lane) ride the artifact, not stdout
        write_results_json(
            args.results_json, {**summary, "requests": result.requests}
        )
    print(json.dumps(summary, indent=2))
    lat, qw = summary["latency_ms"], summary["queue_wait_ms"]
    cap = summary["capacity_min_observed"]

    def _pct(v):
        # 3 significant digits, not a fixed point: 8 virtual CPU lanes
        # sharing one core legitimately sit at 0.04% busy, and "0.0%"
        # would misread as "never worked"
        return "?" if v is None else f"{v * 100:.3g}%"

    fleet_cap = summary["fleet_capacity_min_observed"]
    vol_cols = ""
    if summary.get("volume"):
        vb = summary["volume"]
        vol_cols = (
            f"zshards={vb['zshards_observed']} "
            f"gang_wait_p95={vb['gang_wait_ms']['p95']}ms "
        )
    ds_cols = ""
    if summary.get("device_seconds_ms"):
        db = summary["device_seconds_ms"]
        ds_cols = (
            f"device_seconds_p50={db['p50']}ms "
            f"device_seconds_p95={db['p95']}ms "
        )
    cache_cols = ""
    if summary.get("cache_hit_ratio") is not None:
        # the result-tier columns: printed whenever any
        # response carried an X-Nm03-Cache verdict
        cb = summary["cache"]
        cache_cols = (
            f"cache_hit_ratio={summary['cache_hit_ratio']} "
            f"hit_p50={cb['hit_latency_ms']['p50']}ms "
            f"miss_p50={cb['miss_latency_ms']['p50']}ms "
        )
    fleet_cols = ""
    if summary.get("targets") or summary["replicas"] is not None:
        # the fleet columns: printed on --targets runs and
        # whenever the watched /readyz was a fleet front-end
        fleet_cols = (
            f"replicas={len(summary['replicas_observed']) or '?'} "
            f"failovers={summary['failovers_observed']} "
            f"fleet_cap_min={'?' if fleet_cap is None else fleet_cap} "
        )
    print(
        f"loadgen: ok={summary['requests_ok']}/{summary['requests_total']} "
        f"p50={lat['p50']}ms p95={lat['p95']}ms "
        f"queue_wait_p95={qw['p95']}ms "
        f"lanes={summary['lanes_observed'] or '{}'} "
        f"quarantined_max={summary['lanes_quarantined_observed']} "
        f"capacity_min={'?' if cap is None else cap} "
        f"busy_min={_pct(summary['busy_fraction_min_observed'])} "
        f"padding_max={_pct(summary['padding_waste_max_observed'])} "
        f"mfu_max={_pct(summary['mfu_max_observed'])} "
        f"{ds_cols}"
        f"{cache_cols}"
        f"{vol_cols}"
        f"{fleet_cols}"
        f"echo_mismatch={summary['trace_echo_mismatches']}",
        flush=True,
    )
    if expect_slo is not None:
        gate = summary["slo_gate"]
        detail = "  ".join(
            f"{k}: {'ok' if c['pass'] else 'FAIL'} "
            f"(want {c.get('expected_pct', c.get('expected_ms'))}, "
            f"got {c.get('observed_pct', c.get('observed_ms'))})"
            for k, c in sorted(gate["checks"].items())
        )
        print(
            f"loadgen: --expect-slo "
            f"{'PASSED' if gate['pass'] else 'FAILED'}  {detail}",
            flush=True,
        )
        if not gate["pass"]:
            return 1
    # exit non-zero when nothing succeeded: a load test that measured no
    # requests is a failed measurement, whatever the server said
    return 0 if summary["requests_ok"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
