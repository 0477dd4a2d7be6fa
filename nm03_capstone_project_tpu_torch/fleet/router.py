"""The fleet front end: capacity-weighted routing, failover, backpressure.

The port's copy of the JAX package's ``fleet/router.py``: a stdlib
:class:`ThreadingHTTPServer` in front of N server replicas (each a
``python -m nm03_capstone_project_tpu_torch.serving.server`` process), so
one process death costs 1/N of the capacity, not all of it:

* ``POST /v1/segment`` proxies to one replica, chosen by **smooth
  weighted round-robin** over the currently-healthy set with weights from
  the replicas' own published signals — ``/readyz`` ``capacity`` (the
  healthy-lane fraction) × admission-queue headroom — refreshed by a
  background health-poll loop;
* a replica that times out, refuses connections, answers 503, or reports
  zero capacity is **ejected** through the same HEALTHY → EJECTED →
  PROBATION → HEALTHY machine ``serving/lanes.py`` runs for lanes
  (probation = an off-path canary ``POST /v1/segment`` on a synthetic
  zero slice; reinstatement on success);
* a proxied request that dies on a dying replica (connection reset,
  timeout, aborted body) **fails over** to a healthy replica under a
  bounded hop budget — riders never fail; ``X-Nm03-Replica`` and
  ``replica_hops`` in the payload tell the truth;
* a replica's 503 is **backpressure, honored**: the request reroutes
  while a healthy alternative exists, and when none does the client gets
  the replica's own ``Retry-After`` back;
* 4xx/5xx application verdicts (a malformed body is malformed on every
  replica) propagate as-is — only transport failures and shed reroute;
* the router's own content-addressed result tier (the port's ``cache/``)
  answers a repeated request without a replica pick, while every healthy
  replica publishes one program version;
* the fault plan's ``fleet`` rules fire here: ``replica_unreachable`` at
  the health poll, ``proxy_io_error`` at the forward.

``GET /healthz`` / ``/readyz`` / ``/metrics`` / ``/metrics.json`` serve
the FLEET's own state: ``/readyz`` is 200 while ≥1 replica is healthy
(the payload carries the per-replica table and the routed ``capacity``
fraction) and the ``fleet_*`` series live in an ordinary obs registry.

Free of torch and numpy at import: the router is orchestration, bytes in
and bytes out, and must start in milliseconds without claiming the card.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request
from typing import Dict, FrozenSet, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from nm03_capstone_project_tpu_torch.cache import (
    ResultStore,
    etag_matches,
    result_key,
)
from nm03_capstone_project_tpu_torch.fleet.replicas import (
    EJECTED,
    ReplicaStates,
    normalize_target,
    target_label,
)
from nm03_capstone_project_tpu_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS,
    FLEET_FAILOVERS_TOTAL,
    FLEET_PROBES_TOTAL,
    FLEET_REPLICAS_EJECTED,
    FLEET_REPLICAS_READY,
    FLEET_REQUESTS_ROUTED_TOTAL,
    FLEET_REQUESTS_TOTAL,
    FLEET_REQUEST_SECONDS,
    FLEET_ROUTED_CAPACITY,
    FLEET_SHED_TOTAL,
)
from nm03_capstone_project_tpu_torch.obs.trace import (
    FLEET_TRACE_EVENT,
    TraceContext,
    new_trace_id,
    sanitize_trace_id,
)
from nm03_capstone_project_tpu_torch.serving.metrics import (
    SERVING_RESULT_CACHE_BYTES,
    SERVING_RESULT_CACHE_EVICT_TOTAL,
    SERVING_RESULT_CACHE_FILL_TOTAL,
    SERVING_RESULT_CACHE_HIT_TOTAL,
    SERVING_RESULT_CACHE_MISS_TOTAL,
)
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("fleet")

RETRY_AFTER_S = 1  # the fleet-wide shed hint when no replica named one
# request headers forwarded replica-ward (lowercase); responses echo
# every X-Nm03-* plus the bare ETag — the result tier's revalidation
# token (If-None-Match in, ETag out) must survive the proxy both ways
_FORWARD_HEADERS = ("content-type", "if-none-match")
_FORWARD_PREFIX = "x-nm03-"
_MAX_BODY_BYTES = 64 << 20  # replicas enforce their own canvas-derived cap
_WEIGHT_FLOOR = 0.01  # a healthy replica with a full queue is still pickable


class FleetApp:
    """Everything behind the fleet HTTP handler: states, poller, proxy."""

    def __init__(
        self,
        targets,
        obs=None,
        health_interval_s: float = 1.0,
        probe_interval_s: float = 5.0,
        health_timeout_s: float = 2.0,
        proxy_timeout_s: float = 90.0,
        canary_hw: int = 32,
        canary_timeout_s: float = 30.0,
        fault_plan=None,
        slo=None,
        result_cache_bytes: int = 0,
    ):
        if obs is None:
            from nm03_capstone_project_tpu_torch.obs import RunContext

            obs = RunContext.create(driver="fleet")
        self.obs = obs
        self.registry = obs.registry
        self.fault_plan = fault_plan
        self.replicas = ReplicaStates(targets, obs=obs)
        self.health_interval_s = float(health_interval_s)
        self.probe_interval_s = float(probe_interval_s)
        self.health_timeout_s = float(health_timeout_s)
        self.proxy_timeout_s = float(proxy_timeout_s)
        self.canary_hw = int(canary_hw)
        self.canary_timeout_s = float(canary_timeout_s)
        self._lock = threading.Lock()
        # smooth-WRR current weights; the picker state (nginx algorithm:
        # add each candidate's weight, pick the max, subtract the total —
        # deterministic, proportional, no starvation)
        self._wrr: Dict[str, float] = {t: 0.0 for t in self.replicas.targets}
        self._seq = 0  # proxied-request ordinal (the fault-plan index key)
        self._probe_seq = 0
        self._last_probe: Dict[str, float] = {}
        self.draining = False
        self._stop = threading.Event()
        self._poller = threading.Thread(
            target=self._poll_loop, name="nm03-fleet-health", daemon=True
        )
        self._t0 = time.monotonic()
        # the shed counter exists at 0 from startup so a clean run's
        # snapshot proves "nothing shed" rather than saying nothing (the
        # labeled failover/routed counters appear with their first real
        # labels — an empty-label placeholder would be a phantom series)
        self.registry.counter(
            FLEET_SHED_TOTAL,
            help="requests answered 503 by the fleet (every replica shed "
            "or unhealthy); carries the replica's own Retry-After through",
        )
        # the SLO layer's status classes exist at 0 from startup, so a
        # clean run's snapshot proves "zero errors/sheds" exactly and the
        # SLO monitor's first sample has series to read
        for cls in ("ok", "error", "shed"):
            self.registry.counter(
                FLEET_REQUESTS_TOTAL, help=self._REQ_HELP, status=cls
            )
        # the router-side result tier: a content-addressed hit
        # is answered HERE — it never spends a WRR round or touches a
        # replica. The program-version half of every key comes from the
        # replicas' own /readyz publications (_fleet_result_version), so
        # the backend-free router never computes it — and a fleet that
        # disagrees on the version (mid-rolling-restart) bypasses the
        # tier by construction.
        self.result_store = (
            ResultStore(
                int(result_cache_bytes), on_evict=self._on_result_evict
            )
            if int(result_cache_bytes) > 0
            else None
        )
        # the bytes gauge exists (at 0) from startup when the tier is on:
        # its presence IS nm03-top's tier-enabled signal
        self._publish_result_bytes()
        # the SLO plane: burn rates/budget over the fleet's own
        # request accounting, pull-refreshed by publish_gauges()
        self.slo = None
        if slo is not None:
            from nm03_capstone_project_tpu_torch.obs.slo import SLOMonitor

            self.slo = SLOMonitor(
                self.registry, slo, FLEET_REQUESTS_TOTAL,
                FLEET_REQUEST_SECONDS,
                # the fleet's bad set: propagated replica 5xx verdicts and
                # fleet-wide sheds; `invalid` (4xx) is the client's fault
                bad_statuses=("error", "shed"),
            )

    _REQ_HELP = (
        "terminal proxied-request outcomes by status class (ok = 2xx, "
        "invalid = 4xx application verdicts, error = 5xx, shed = the "
        "fleet-wide 503) — the fleet SLO layer's availability input"
    )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetApp":
        """One synchronous health sweep (routing starts informed), then
        the background poll loop."""
        self._sweep()
        self._poller.start()
        self.obs.events.emit(
            "fleet_ready",
            targets=[target_label(t) for t in self.replicas.targets],
            healthy=self.replicas.healthy_count(),
        )
        return self

    def begin_drain(self, reason: str = "sigterm") -> None:
        """Stop the poll loop, flush telemetry. Idempotent."""
        with self._lock:
            if self.draining:
                return
            self.draining = True
        self._stop.set()
        self._poller.join(timeout=10.0)
        self.obs.events.emit("fleet_drain", level="WARNING", reason=reason)
        try:
            self.publish_gauges()
            self.obs.write_metrics()
        except Exception as e:  # noqa: BLE001 — telemetry never blocks a drain
            log.warning("fleet drain: metrics flush failed: %s", e)

    def close(self, status: str = "ok") -> None:
        self.obs.close(status=status)

    # -- health loop -------------------------------------------------------

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.health_interval_s):
            try:
                self._sweep()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                log.warning("fleet health sweep failed: %s", e)

    def _sweep(self) -> None:
        """One pass: poll every replica, canary the due ejected ones.

        Polls run CONCURRENTLY (one short-lived thread per target): a
        wedged replica that accepts but never answers costs its own
        ``health_timeout_s``, not a serial N× stretch of every other
        replica's ejection-detection latency — the contract
        ``--health-interval-s`` advertises. A poll that outlives the
        join grace is treated as not-ok for this sweep (its late signal
        write is lock-guarded and harmless).
        """
        targets = self.replicas.targets
        if len(targets) == 1:
            outcomes = {targets[0]: self._poll_one(targets[0])}
        else:
            outcomes: Dict[str, bool] = {}
            guard = threading.Lock()

            def poll(t: str) -> None:
                ok = self._poll_one(t)
                with guard:
                    outcomes[t] = ok

            threads = [
                threading.Thread(
                    target=poll, args=(t,),
                    name=f"nm03-fleet-poll-{target_label(t)}", daemon=True,
                )
                for t in targets
            ]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=self.health_timeout_s + 5.0)
        for target in targets:
            if outcomes.get(target) and self.replicas.state(target) == EJECTED:
                self._maybe_probe(target)
        self.publish_gauges()

    def _poll_one(self, target: str) -> bool:
        """GET ``/readyz``; classify. True = 200 with routable capacity."""
        plan = self.fault_plan
        if plan is not None and plan.has_site("fleet"):
            rule = plan.fire(
                "fleet", obs=self.obs, stem=target_label(target),
                kinds=("replica_unreachable",),
            )
            if rule is not None:
                # the drill's deterministic outage: the poll "refused"
                self._handle_unhealthy(target, "refused")
                return False
        try:
            req = urllib.request.Request(f"{target}/readyz", method="GET")
            try:
                with urllib.request.urlopen(
                    req, timeout=self.health_timeout_s
                ) as resp:
                    status, body = resp.status, resp.read()
            except urllib.error.HTTPError as e:  # 503 still carries a payload
                status, body = e.code, e.read()
        except Exception as e:  # noqa: BLE001 — classified, never raised
            cause = "timeout" if "timed out" in str(e).lower() else "refused"
            self._handle_unhealthy(target, cause)
            return False
        try:
            st = json.loads(body or b"{}")
        except json.JSONDecodeError:
            st = {}
        capacity = st.get("capacity")
        if status != 200:
            self._handle_unhealthy(target, f"http_{status}")
            return False
        if capacity is not None and float(capacity) <= 0.0:
            self._handle_unhealthy(target, "zero_capacity")
            return False
        # the clock handshake: the replica echoes its own
        # (mono_s, ts_unix) pair on /readyz, so the router can publish
        # each replica's monotonic→wall offset for skew triage (the
        # nm03-trace merge derives the same offset from each log itself)
        clock = st.get("clock") or {}
        clock_offset_s = None
        if isinstance(clock.get("ts_unix"), (int, float)) and isinstance(
            clock.get("mono_s"), (int, float)
        ):
            clock_offset_s = round(
                float(clock["ts_unix"]) - float(clock["mono_s"]), 6
            )
        # the replica's published volume cost: the default
        # slice-equivalent weight of one whole-volume request (its
        # smallest depth bucket) — None on slice-only replicas
        volumes = st.get("volumes") or {}
        volume_cost = (
            volumes.get("default_cost") if volumes.get("enabled") else None
        )
        self.replicas.update_signals(
            target,
            capacity=capacity,
            queue_depth=st.get("queue_depth"),
            queue_capacity=st.get("queue_capacity"),
            identity=st.get("replica"),
            canvas=st.get("canvas"),
            min_dim=st.get("min_dim"),
            clock_offset_s=clock_offset_s,
            volume_cost=volume_cost,
            # the replica's result-tier program version: the
            # key half the router's own content-addressed tier borrows —
            # published even when the replica's store is disabled
            result_version=(st.get("result_cache") or {}).get(
                "program_version"
            ),
        )
        return True

    def _handle_unhealthy(self, target: str, cause: str) -> None:
        self.replicas.eject(target, cause)  # no-op unless HEALTHY

    def _maybe_probe(self, target: str) -> None:
        """Probation canary for an ejected replica whose poll just passed.

        Gated on the probe cadence AND on the same-sweep ``/readyz``
        success, so a replica that is simply down never costs a canary —
        and an injected ``replica_unreachable`` outage (which fails the
        poll) deterministically holds the replica out. The canary itself
        runs on its own daemon thread: a wedged replica that accepts the
        connection but never answers would otherwise hold the single
        sweep thread for ``canary_timeout_s``, blinding the health poll
        to every OTHER replica for the duration (the begin_probation
        claim keeps two canaries off one target).
        """
        now = time.monotonic()
        with self._lock:
            if now - self._last_probe.get(target, -1e9) < self.probe_interval_s:
                return
            self._last_probe[target] = now
            self._probe_seq += 1
            n = self._probe_seq
        threading.Thread(
            target=self._probe_one, args=(target, n),
            name=f"nm03-fleet-probe-{target_label(target)}", daemon=True,
        ).start()

    def _probe_one(self, target: str, n: int) -> None:
        """One probation canary: claim, POST, reinstate or re-eject."""
        if not self.replicas.begin_probation(target):
            return
        # size the canary inside the replica's own published guards: a
        # 32x32 default against a --min-dim 100 replica would be a 400
        # on every probe and an ejection that never heals (the bug the
        # first live drill caught) — the replica tells us what fits
        sig = self.replicas.signals(target)
        hw = self.canary_hw
        if sig.get("min_dim"):
            hw = max(hw, int(sig["min_dim"]))
        if sig.get("canvas"):
            hw = min(hw, int(sig["canvas"]))
        body = bytes(hw * hw * 4)  # a zero float32 slice — the warmup input
        label = target_label(target)
        probe_id = f"fleet-probe-{label}-{n}"
        headers = {
            "Content-Type": "application/octet-stream",
            "X-Nm03-Height": str(hw),
            "X-Nm03-Width": str(hw),
            "X-Nm03-Request-Id": probe_id,
            # the probe tag: the replica still serves
            # and traces the canary but keeps it OUT of its request
            # metrics and SLO accounting — a probe every interval against
            # an otherwise-idle replica must not pollute the very series
            # the SLO layer reads
            "X-Nm03-Probe": "1",
        }
        outcome = "failed"
        ctx = TraceContext(probe_id)
        t0 = time.monotonic()
        try:
            req = urllib.request.Request(
                f"{target}/v1/segment?output=mask", data=body,
                headers=headers, method="POST",
            )
            with urllib.request.urlopen(
                req, timeout=self.canary_timeout_s
            ) as resp:
                resp.read()
                ok = resp.status == 200
        except Exception:  # noqa: BLE001 — a failed canary is an outcome
            ok = False
        if ok:
            outcome = "passed"
            self.replicas.reinstate(target)
        else:
            self.replicas.fail_probation(target)
        ctx.add_span(
            "canary_probe", t0, time.monotonic(), replica=label,
            outcome=outcome, probe=True,
        )
        try:
            self.registry.counter(
                FLEET_PROBES_TOTAL,
                help="probation canary requests by replica and outcome",
                replica=label, outcome=outcome,
            ).inc()
            # probes are traced (probe=true) but never counted in
            # fleet_requests_total — the fleet-side half of the satellite
            self.obs.events.emit(
                FLEET_TRACE_EVENT,
                trace_id=probe_id,
                request_id=f"probe-{n:06d}",
                replica=label,
                replica_hops=0,
                status=200 if ok else None,
                probe=True,
                spans=ctx.snapshot(),
            )
        except Exception:  # noqa: BLE001
            pass

    # -- routing -----------------------------------------------------------

    def pick(
        self, exclude: FrozenSet[str] = frozenset(), cost: float = 1.0
    ) -> Optional[str]:
        """Smooth weighted round-robin over healthy, non-excluded targets.

        ``cost`` is the request's slice-equivalent weight: the
        picked replica is debited ``cost`` rounds' worth instead of one,
        so a 32-plane volume request "spends" that replica's turn 32
        times over and the next 31 slice picks land elsewhere — WRR never
        mistakes a whole study for one slice.
        """
        healthy = [
            t for t in self.replicas.healthy_targets() if t not in exclude
        ]
        if not healthy:
            return None
        weights = {
            t: max(self.replicas.weight(t), _WEIGHT_FLOOR) for t in healthy
        }
        total = sum(weights.values())
        with self._lock:
            for t, w in weights.items():
                self._wrr[t] = self._wrr.get(t, 0.0) + w
            best = max(healthy, key=lambda t: self._wrr[t])
            self._wrr[best] -= total * max(float(cost), 1.0)
        return best

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _forward(
        self, target: str, body: bytes, headers: dict, query: str,
        path: str = "/v1/segment",
    ) -> Tuple[int, bytes, List[Tuple[str, str]]]:
        """One proxied POST to ``target``; HTTP errors return, transport
        errors raise (the caller's failover trigger)."""
        url = f"{target}{path}" + (f"?{query}" if query else "")
        req = urllib.request.Request(
            url, data=body, headers=headers, method="POST"
        )
        try:
            with urllib.request.urlopen(
                req, timeout=self.proxy_timeout_s
            ) as resp:
                return resp.status, resp.read(), list(resp.getheaders())
        except urllib.error.HTTPError as e:
            data = e.read()
            return e.code, data, list(e.headers.items()) if e.headers else []

    def _count_failover(self, target: str, cause: str) -> None:
        self.registry.counter(
            FLEET_FAILOVERS_TOTAL,
            help="proxied requests moved off a replica mid-flight by "
            "replica and cause (io_error = transport death, shed = "
            "rerouted 503 backpressure)",
            replica=target_label(target), cause=cause,
        ).inc()

    def volume_request_cost(self, headers: dict) -> float:
        """The slice-equivalent WRR cost of one volume request.

        The request's own declared depth (``X-Nm03-Depth``, the raw
        stacked format) when present; otherwise the largest volume cost
        any replica published on ``/readyz`` (its smallest depth bucket —
        an undeclared DICOM study is at least that deep once padded);
        floor 1.0 so a missing signal degrades to slice weighting, never
        a zero-cost pick.
        """
        for k, v in headers.items():
            if k.lower() == "x-nm03-depth":
                try:
                    return max(float(int(v)), 1.0)
                except (TypeError, ValueError):
                    break
        published = [
            self.replicas.signals(t).get("volume_cost")
            for t in self.replicas.targets
        ]
        costs = [float(c) for c in published if c]
        return max(costs) if costs else 1.0

    # -- the result tier (router side) ---------------------------

    def _on_result_evict(self, n: int) -> None:
        # fired from inside the store's lock — a counter bump only (the
        # bytes gauge refreshes outside the lock, in _result_fill and the
        # admin evict handler)
        self.registry.counter(
            SERVING_RESULT_CACHE_EVICT_TOTAL,
            help="result-tier entries evicted by tier (LRU pressure, "
            "explicit evict, or a failed verify-on-read)",
            tier="router",
        ).inc(n)

    def _count_result(self, name: str, help_text: str) -> None:
        self.registry.counter(name, help=help_text, tier="router").inc()

    def _publish_result_bytes(self) -> None:
        if self.result_store is not None:
            self.registry.gauge(
                SERVING_RESULT_CACHE_BYTES,
                help="resident bytes in the router result store",
            ).set(self.result_store.bytes)

    def _fleet_result_version(self) -> Optional[str]:
        """The one program version every healthy replica publishes, or None.

        The router tier only engages while the WHOLE healthy set agrees
        on a single ``result_version`` (each replica's ``/readyz``
        ``result_cache.program_version``). During a rolling restart the
        fleet is mixed, the set has two members, and the tier bypasses by
        construction — a mask the old algorithm computed can never answer
        a request the new one would segment differently. Invalidation is
        the key changing, not a flush.
        """
        versions = {
            self.replicas.signals(t).get("result_version")
            for t in self.replicas.healthy_targets()
        }
        if len(versions) != 1:
            return None
        v = versions.pop()
        return v or None

    def _result_digest(
        self, body: bytes, query: str, path: str
    ) -> Optional[str]:
        """This request's content-addressed key digest, or None (bypass).

        None when the tier is off or the healthy set doesn't currently
        agree on one program version. Router keys hash the raw query
        string's sorted parameters: the router never interprets replica
        semantics (defaults, clamping), so two spellings of one request
        land on different keys and both simply miss — never wrong, at
        worst one extra compute.
        """
        if self.result_store is None:
            return None
        version = self._fleet_result_version()
        if version is None:
            return None
        algo = "segment-volume" if path.endswith("-volume") else "segment"
        params = dict(
            sorted(parse_qs(query, keep_blank_values=True).items())
        )
        return result_key(body, algo, params, version).digest()

    def _serve_cached(
        self, entry, headers: dict, ctx: "TraceContext", seq: int,
        t_req: float,
    ) -> Tuple[int, bytes, List[Tuple[str, str]]]:
        """Answer a router-tier hit: 304 on a matching ``If-None-Match``,
        else the stored payload with this request's own identity fields.

        The HTTP ETag served is the REPLICA's content ETag when one was
        recorded at fill (entry.meta) — so revalidation works identically
        whichever tier answers — falling back to the store's own payload
        digest when the replica tier was off.
        """
        etag = entry.meta.get("etag") or entry.etag
        inm = next(
            (v for k, v in headers.items() if k.lower() == "if-none-match"),
            None,
        )
        base = [
            ("ETag", etag),
            ("X-Nm03-Cache", "hit"),
            ("X-Nm03-Request-Id", ctx.trace_id),
            ("X-Nm03-Replica-Hops", "0"),
        ]
        if etag_matches(inm, etag):
            self._finish_request(ctx, seq, t_req, 304, None, 0)
            return 304, b"", base
        data = entry.payload
        try:
            payload = json.loads(data)
        except (json.JSONDecodeError, UnicodeDecodeError):
            payload = None
        if isinstance(payload, dict):
            # per-execution fields tell THIS request's truth: nothing
            # ran, nothing waited, nothing hopped (replica/replica_id
            # stay — they name who computed the stored result)
            payload["request_id"] = ctx.trace_id
            payload["cached"] = True
            payload["device_seconds"] = 0.0
            payload["queue_wait_s"] = 0.0
            payload["replica_hops"] = 0
            data = json.dumps(payload).encode()
        self._finish_request(ctx, seq, t_req, 200, None, 0)
        return 200, data, [("Content-Type", "application/json"), *base]

    def _result_fill(
        self, digest: str, data: bytes, path: str,
        resp_headers: List[Tuple[str, str]],
    ) -> None:
        """Store one routed 200 at the router tier.

        The stored bytes are the AUGMENTED payload (replica identity
        included) — ``entry.etag`` must stay the digest of exactly those
        bytes because it doubles as the verify-on-read check — while the
        replica's own content ETag (when its tier is on) rides in
        ``entry.meta`` for the HTTP surface.
        """
        if self.result_store is None:
            return
        algo = "segment-volume" if path.endswith("-volume") else "segment"
        replica_etag = next(
            (v for k, v in resp_headers if k.lower() == "etag"), None
        )
        entry, created = self.result_store.fill(
            digest, data, algo,
            meta={"etag": replica_etag} if replica_etag else None,
        )
        if created:
            self._count_result(
                SERVING_RESULT_CACHE_FILL_TOTAL,
                "computed results stored into the tier, by tier",
            )
            self._publish_result_bytes()

    def proxy_segment(
        self, body: bytes, headers: dict, query: str = "",
        trace_id: Optional[str] = None, path: str = "/v1/segment",
        cost: float = 1.0,
    ) -> Tuple[int, bytes, List[Tuple[str, str]]]:
        """Route one ``POST /v1/segment[-volume]``; (status, body, headers).

        ``path`` selects the replica endpoint (``/v1/segment-volume``
        proxies through the same failover/shed ladder — a volume request
        that dies on a dying replica moves on like any rider); ``cost``
        is the request's slice-equivalent WRR debit
        (:meth:`volume_request_cost`).

        The failover ladder: transport death ejects the replica and moves
        the request on; a 503 remembers the replica's Retry-After and
        tries an alternative; each replica is tried at most once, and the
        budget is bounded by the fleet size — no infinite ping-pong even
        against a racing reinstatement.

        Every request is traced: ``trace_id`` is the handler's
        minted-or-honored ``X-Nm03-Request-Id`` (minted here for direct
        callers), forwarded replica-ward so the replica's ``serve_trace``
        tree shares it, and the router records its own span chain —
        ``route_pick`` → ``proxy_hop`` per attempt (→ ``failover`` on a
        transport death or shed) — emitted as one ``fleet_trace`` event.
        """
        seq = self._next_seq()
        t_req = time.monotonic()
        ctx = TraceContext(trace_id or new_trace_id())
        # the canonical trace header rides to the replica (replacing any
        # case variant of the client's), so the replica-side span tree
        # shares this request's id — the multi-log merge's join key. The
        # probe tag is STRIPPED from client traffic: only the router's
        # own canary path (_probe_one) may set it — a client smuggling
        # X-Nm03-Probe through the fleet would otherwise have its real
        # requests silently excluded from the replica's request metrics
        # and SLO accounting while the fleet counts them
        headers = {
            k: v for k, v in headers.items()
            if k.lower() not in ("x-nm03-request-id", "x-nm03-probe")
        }
        headers["X-Nm03-Request-Id"] = ctx.trace_id
        # the router-side lookup happens BEFORE admission to the pick
        # loop: a hit never spends a WRR round, never costs a
        # replica pick, and charges zero device-seconds anywhere
        cache_digest = self._result_digest(body, query, path)
        if cache_digest is not None:
            entry = self.result_store.lookup(cache_digest)
            if entry is not None:
                self._count_result(
                    SERVING_RESULT_CACHE_HIT_TOTAL,
                    "result-tier lookups served from cache, by tier",
                )
                return self._serve_cached(entry, headers, ctx, seq, t_req)
            self._count_result(
                SERVING_RESULT_CACHE_MISS_TOTAL,
                "result-tier lookups that fell through to compute, by tier",
            )
        plan = self.fault_plan
        tried: set = set()
        hops = 0
        shed: Optional[Tuple[int, bytes, List[Tuple[str, str]]]] = None
        status: int = 503
        data: bytes = b""
        final: Optional[str] = None
        resp_headers: List[Tuple[str, str]] = []
        while True:
            t_pick = time.monotonic()
            target = self.pick(exclude=frozenset(tried), cost=cost)
            ctx.add_span(
                "route_pick", t_pick, time.monotonic(),
                replica=target_label(target) if target else None,
                attempt=hops + 1,
            )
            if target is None:
                break
            tried.add(target)
            label = target_label(target)
            if plan is not None and plan.has_site("fleet"):
                rule = plan.fire(
                    "fleet", obs=self.obs, stem=label,
                    index=seq, kinds=("proxy_io_error",),
                )
                if rule is not None:
                    # the drill's deterministic mid-body abort: same path
                    # a real connection reset takes
                    t0 = time.monotonic()
                    self.replicas.eject(target, "proxy_error")
                    self._count_failover(target, "io_error")
                    now = time.monotonic()
                    ctx.add_span(
                        "proxy_hop", t0, now, replica=label,
                        outcome="io_error", attempt=hops + 1,
                    )
                    ctx.add_span(
                        "failover", now, time.monotonic(), replica=label,
                        cause="io_error",
                    )
                    hops += 1
                    continue
            t0 = time.monotonic()
            try:
                status, data, resp_headers = self._forward(
                    target, body, headers, query, path=path
                )
            except Exception as e:  # noqa: BLE001 — transport death → failover
                log.warning(
                    "proxy to %s failed (%s); failing over", label, e,
                )
                now = time.monotonic()
                ctx.add_span(
                    "proxy_hop", t0, now, replica=label,
                    outcome="io_error", attempt=hops + 1,
                )
                self.replicas.eject(target, "proxy_error")
                self._count_failover(target, "io_error")
                ctx.add_span(
                    "failover", now, time.monotonic(), replica=label,
                    cause="io_error",
                )
                hops += 1
                continue
            if status == 503:
                # backpressure: reroute while an alternative exists,
                # propagate the replica's own Retry-After when none does
                now = time.monotonic()
                ctx.add_span(
                    "proxy_hop", t0, now, replica=label,
                    outcome="shed", attempt=hops + 1,
                )
                shed = (status, data, resp_headers)
                self._count_failover(target, "shed")
                ctx.add_span(
                    "failover", now, time.monotonic(), replica=label,
                    cause="shed",
                )
                hops += 1
                continue
            ctx.add_span(
                "proxy_hop", t0, time.monotonic(), replica=label,
                outcome="ok" if status == 200 else f"http_{status}",
                attempt=hops + 1,
            )
            final = target
            break
        if final is not None:
            # a routed verdict (200 or an application error) returns as-is
            self.registry.counter(
                FLEET_REQUESTS_ROUTED_TOTAL,
                help="requests served to completion by each replica "
                "(non-503 responses returned to the client)",
                replica=target_label(final),
            ).inc()
            out_headers = self._response_headers(resp_headers, final, hops)
            if status == 200:
                data = self._augment_payload(data, final, hops)
                if cache_digest is not None:
                    # replica-side fill rides home through the router's
                    # own tier: the next identical study never leaves it
                    self._result_fill(cache_digest, data, path, resp_headers)
        else:
            # no healthy replica left (or every one shed / died)
            self.registry.counter(
                FLEET_SHED_TOTAL,
                help="requests answered 503 by the fleet (every replica "
                "shed or unhealthy); carries the replica's own Retry-After "
                "through",
            ).inc()
            if shed is not None:
                status, data, resp_headers = shed
                retry_after = next(
                    (v for k, v in resp_headers if k.lower() == "retry-after"),
                    str(RETRY_AFTER_S),
                )
            else:
                retry_after = str(RETRY_AFTER_S)
                data = json.dumps({
                    "error": "no healthy replica "
                    f"({self.replicas.ejected_count()} of "
                    f"{len(self.replicas)} ejected)",
                    "replica_hops": hops,
                }).encode()
            status = 503
            out_headers = [
                ("Content-Type", "application/json"),
                ("Retry-After", retry_after),
                # the echo contract holds on the shed path too: the
                # replica would have echoed it, so the fleet must
                ("X-Nm03-Request-Id", ctx.trace_id),
            ]
        self._finish_request(ctx, seq, t_req, status, final, hops)
        return status, data, out_headers

    def _finish_request(
        self, ctx: TraceContext, seq: int, t_req: float, status: int,
        final: Optional[str], hops: int,
    ) -> None:
        """One proxied request's terminal accounting: the SLO layer's
        status class + latency observation, and the ``fleet_trace``
        event carrying the router's span chain."""
        if 200 <= status < 400:
            # 304 Not Modified is a served verdict (the result tier's
            # revalidation answer), not an error — it burns no budget
            cls = "ok"
        elif status == 503:
            cls = "shed"
        elif status >= 500:
            cls = "error"
        else:
            cls = "invalid"
        try:
            self.registry.counter(
                FLEET_REQUESTS_TOTAL, help=self._REQ_HELP, status=cls
            ).inc()
            self.registry.histogram(
                FLEET_REQUEST_SECONDS,
                help="client-observed proxy latency per request (front-end "
                "admission to the final verdict, failover hops included) — "
                "the fleet SLO layer's latency input",
                buckets=DEFAULT_LATENCY_BUCKETS,
            ).observe(time.monotonic() - t_req)
            self.obs.events.emit(
                FLEET_TRACE_EVENT,
                trace_id=ctx.trace_id,
                request_id=f"fl-{seq:06d}",
                replica=target_label(final) if final else None,
                replica_hops=hops,
                status=status,
                spans=ctx.snapshot(),
            )
        except Exception as e:  # noqa: BLE001 — telemetry never fails a request
            log.warning("fleet trace emit failed: %s", e)

    def _response_headers(
        self, resp_headers: List[Tuple[str, str]], target: str, hops: int
    ) -> List[Tuple[str, str]]:
        """Replica ``X-Nm03-*``/Content-Type headers + the fleet's own.

        The prefix filter drops the replica's Content-Length by
        construction — the handler recomputes it against the (possibly
        augmented) body, so a stale length can never reach the client.
        """
        out = [
            (k, v) for k, v in resp_headers
            if k.lower().startswith(_FORWARD_PREFIX)
            or k.lower() in ("content-type", "etag")
        ]
        out.append(("X-Nm03-Replica", target_label(target)))
        out.append(("X-Nm03-Replica-Hops", str(hops)))
        return out

    def _augment_payload(self, data: bytes, target: str, hops: int) -> bytes:
        """Add ``replica``/``replica_id``/``replica_hops`` to a 200 payload."""
        try:
            payload = json.loads(data)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return data  # non-JSON passes through untouched
        if not isinstance(payload, dict):
            return data
        payload["replica"] = target_label(target)
        identity = self.replicas.signals(target).get("identity") or {}
        payload["replica_id"] = identity.get("id")
        payload["replica_hops"] = hops
        return json.dumps(payload).encode()

    # -- status / telemetry ------------------------------------------------

    def publish_gauges(self) -> None:
        """Refresh the fleet-level gauges from the current state table."""
        if self.slo is not None:
            try:
                self.slo.publish()  # pull-refresh the burn-rate windows
            except Exception as e:  # noqa: BLE001 — telemetry never blocks
                log.warning("fleet SLO publish failed: %s", e)
        healthy = self.replicas.healthy_count()
        self.registry.gauge(
            FLEET_REPLICAS_READY,
            help="replicas currently HEALTHY and taking routed traffic",
        ).set(healthy)
        self.registry.gauge(
            FLEET_REPLICAS_EJECTED,
            help="replicas currently out of rotation (ejected or under "
            "probation)",
        ).set(self.replicas.ejected_count())
        self.registry.gauge(
            FLEET_ROUTED_CAPACITY,
            help="the fleet's routed capacity fraction: mean healthy-replica "
            "published capacity (one dead replica of three reads 0.667)",
        ).set(round(self.replicas.capacity_fraction(), 6))

    @property
    def ready(self) -> bool:
        with self._lock:
            draining = self.draining
        return self.replicas.healthy_count() >= 1 and not draining

    def status(self) -> dict:
        snap = self.replicas.snapshot()
        return {
            "ready": self.ready,
            "draining": self.draining,
            "fleet": True,
            # the SLO verdict rides /readyz like the replica's saturation
            # block: burn rates + budget against the declared objective
            # (null when no objective was declared). last_block, not
            # publish: the /readyz handler already published via
            # publish_gauges() — one probe must sample once
            "slo": self.slo.last_block() if self.slo is not None else None,
            "capacity": round(self.replicas.capacity_fraction(), 6),
            # the router-side result tier: stats + the
            # fleet-agreed program version (null while the healthy set
            # disagrees — the rolling-restart bypass window)
            "result_cache": (
                {
                    **self.result_store.stats(),
                    "program_version": self._fleet_result_version(),
                }
                if self.result_store is not None
                else {"enabled": False}
            ),
            "replicas": {
                "count": len(self.replicas),
                "ready": self.replicas.healthy_count(),
                "ejected": self.replicas.ejected_count(),
                "per_replica": snap,
            },
            "uptime_s": round(time.monotonic() - self._t0, 3),
        }


# -- the HTTP layer ---------------------------------------------------------


def make_handler(app: FleetApp):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        server_version = "nm03-fleet/1.0"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: A003
            log.debug("%s %s", self.address_string(), fmt % args)

        def _reply(self, status: int, data: bytes, headers=()):
            self.send_response(status)
            seen_ct = False
            for k, v in headers:
                if k.lower() == "content-type":
                    seen_ct = True
                self.send_header(k, v)
            if not seen_ct:
                self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _reply_json(self, status: int, body: dict, headers=()):
            self._reply(status, json.dumps(body).encode(), headers)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
            path = urlsplit(self.path).path
            if path == "/healthz":
                self._reply_json(
                    200,
                    {"status": "alive",
                     "uptime_s": round(time.monotonic() - app._t0, 3)},
                )
            elif path == "/readyz":
                app.publish_gauges()
                st = app.status()
                self._reply_json(200 if st["ready"] else 503, st)
            elif path == "/metrics":
                app.publish_gauges()
                self._reply(
                    200, app.registry.to_prometheus().encode(),
                    [("Content-Type", "text/plain; version=0.0.4")],
                )
            elif path == "/metrics.json":
                app.publish_gauges()
                self._reply(
                    200,
                    json.dumps(app.obs.metrics_snapshot(), indent=1).encode(),
                    [("Content-Type", "application/json")],
                )
            elif path == "/debug/result-cache":
                # the result tier's admin surface: stats plus
                # hot-to-cold rows, and the fleet-agreed program version
                # (null while the healthy set disagrees — the bypass
                # window an operator sees during a rolling restart)
                if app.result_store is None:
                    self._reply_json(200, {"enabled": False})
                else:
                    self._reply_json(
                        200,
                        {
                            **app.result_store.stats(),
                            "program_version": app._fleet_result_version(),
                            "ls": app.result_store.ls(),
                        },
                    )
            elif path == "/debug/flightrec":
                # the remote debug pull: the router's own
                # flight rings over HTTP — `nm03-fleet flightrec` fans
                # the same endpoint across the replicas
                from nm03_capstone_project_tpu_torch.obs import flightrec

                snap = flightrec.get_recorder().snapshot(reason="debug_pull")
                self._reply(
                    200, json.dumps(snap, default=str).encode(),
                    [("Content-Type", "application/json")],
                )
            else:
                self._reply_json(404, {"error": f"unknown path {path}"})

        def do_POST(self):  # noqa: N802
            split = urlsplit(self.path)
            # the fleet mints-or-honors the trace identity EXPLICITLY
            #: the id is decided here, echoed on every reply
            # (errors included) and forwarded replica-ward, so the whole
            # fleet timeline of this request shares one id
            trace_id = sanitize_trace_id(
                self.headers.get("X-Nm03-Request-Id")
            ) or new_trace_id()
            echo = [("X-Nm03-Request-Id", trace_id)]
            if split.path == "/debug/result-cache/evict":
                # admin evict (?digest=D for one entry, bare for all)
                if app.result_store is None:
                    self._reply_json(
                        404, {"error": "result tier disabled"}, echo
                    )
                    return
                qs = parse_qs(split.query)
                digest = (qs.get("digest") or [None])[0]
                n = app.result_store.evict(digest)
                app._publish_result_bytes()
                self._reply_json(200, {"evicted": n}, echo)
                return
            if split.path not in ("/v1/segment", "/v1/segment-volume"):
                self._reply_json(
                    404, {"error": f"unknown path {split.path}"}, echo
                )
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except ValueError:
                self._reply_json(400, {"error": "bad Content-Length"}, echo)
                return
            if length <= 0:
                self._reply_json(400, {"error": "empty body"}, echo)
                return
            if length > _MAX_BODY_BYTES:
                self._reply_json(
                    413,
                    {"error": f"body of {length} bytes exceeds the fleet cap"},
                    echo,
                )
                return
            body = self.rfile.read(length)
            headers = {
                k: v for k, v in self.headers.items()
                if k.lower().startswith(_FORWARD_PREFIX)
                or k.lower() in _FORWARD_HEADERS
            }
            # a whole-volume request weighs its declared depth in the WRR
            # — the router must not treat a 32-plane study as
            # one slice when spreading load
            cost = (
                app.volume_request_cost(headers)
                if split.path == "/v1/segment-volume"
                else 1.0
            )
            try:
                status, data, resp_headers = app.proxy_segment(
                    body, headers, split.query, trace_id=trace_id,
                    path=split.path, cost=cost,
                )
            except Exception as e:  # noqa: BLE001 — per-request containment
                log.warning("fleet request failed: %s", e)
                self._reply_json(
                    500, {"error": str(e), "error_class": type(e).__name__},
                    echo,
                )
                return
            self._reply(status, data, resp_headers)

    return Handler


def make_http_server(app: FleetApp, host: str = "127.0.0.1", port: int = 0):
    """Bind (port 0 = ephemeral); ``.server_address`` carries the real port."""
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer((host, port), make_handler(app))
    httpd.daemon_threads = True
    return httpd


def serve_in_thread(app: FleetApp, host: str = "127.0.0.1", port: int = 0):
    """Start a fleet on a daemon thread; ``(httpd, thread, port)`` (tests)."""
    httpd = make_http_server(app, host, port)
    app.start()
    t = threading.Thread(
        target=httpd.serve_forever, name="nm03-fleet-http", daemon=True
    )
    t.start()
    return httpd, t, httpd.server_address[1]


__all__ = [
    "FleetApp",
    "make_handler",
    "make_http_server",
    "normalize_target",
    "serve_in_thread",
]
