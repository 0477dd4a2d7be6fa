"""Replica-level fault domains: ejection, probation, reinstatement.

The port's copy of the JAX package's ``fleet/replicas.py``. The serving
lanes' state machine (``serving/lanes.py``) applied one level up, to whole
server replicas behind the fleet front end:

* **HEALTHY** — the replica takes proxied traffic (the router's
  capacity-weighted pick runs over exactly these targets);
* **EJECTED** — the replica's health poll timed out, refused the
  connection, answered 503, or reported zero capacity — or a proxied
  request died on it mid-flight; it takes no traffic and its in-flight
  riders fail over to healthy replicas;
* **PROBATION** — the health loop has claimed the replica and is sending
  an off-path canary request (a real ``POST /v1/segment`` on a synthetic
  slice); success reinstates it to HEALTHY, failure returns it to
  EJECTED (cause ``probe_failed``).

There is no terminal state: a fleet whose every replica is ejected keeps
polling and answers 503 + Retry-After meanwhile — replicas are processes,
and processes come back (the rolling restart in ``fleet.manager`` relies
on it).

Every transition is observable: ``fleet_replica_state{replica}`` (0
healthy, 1 probation, 2 ejected), ``fleet_replica_ejections_total
{replica,cause}``, ``fleet_replica_reinstated_total{replica}``, WARNING
``replica_ejected`` / INFO ``replica_reinstated`` events, and
flight-recorder marks. The replica label is the target's ``host:port`` —
stable across that replica's restarts, unlike the per-incarnation ``id``
the ``/readyz`` identity block reports (which rides the events instead).

Free of torch and numpy at import: the router must come up, and its state
machine be unit-testable, in a process that never loads a backend or
claims the card. Shared state is lock-guarded.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence

from nm03_capstone_project_tpu_torch.obs import flightrec
from nm03_capstone_project_tpu_torch.obs.metrics import (
    FLEET_REPLICA_CAPACITY,
    FLEET_REPLICA_EJECTIONS_TOTAL,
    FLEET_REPLICA_REINSTATED_TOTAL,
    FLEET_REPLICA_STATE,
)
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("fleet")

HEALTHY = "healthy"
PROBATION = "probation"
EJECTED = "ejected"

REPLICA_STATE_VALUES = {HEALTHY: 0, PROBATION: 1, EJECTED: 2}


def normalize_target(target: str) -> str:
    """``host:port`` / ``http://host:port[/]`` -> the base URL (no slash)."""
    t = target.strip().rstrip("/")
    if "://" not in t:
        t = f"http://{t}"
    return t


def target_label(target: str) -> str:
    """The bounded metric label for one target: ``host:port``.

    Stable across the replica's restarts (unlike its ``/readyz`` identity
    ``id``), so the per-replica series survive a rolling redeploy.
    """
    url = normalize_target(target)
    return url.split("://", 1)[1]


class ReplicaStates:
    """The per-replica state machine + last-known health signals.

    One instance per :class:`fleet.router.FleetApp`. Transitions mirror
    ``serving/lanes.py``'s lane machine (all lock-guarded; mutators
    return what the caller needs without re-reading state):

    ``eject(target, cause)`` — HEALTHY → EJECTED; idempotent for any
    target already out of the healthy set (a proxied request failing on
    a replica the health poll already ejected is the same incident).
    Returns ``(changed, healthy_remaining)``.

    ``begin_probation(target)`` — EJECTED → PROBATION; the health loop's
    exclusive canary claim.

    ``reinstate(target)`` — PROBATION → HEALTHY (the canary passed).

    ``fail_probation(target)`` — PROBATION → EJECTED (cause
    ``probe_failed``, counted as a fresh ejection).

    ``update_signals(target, ...)`` records the replica's own published
    routing signals (``/readyz`` capacity, queue depth/capacity, the
    identity block) — the inputs to the router's capacity-weighted pick.
    """

    def __init__(self, targets: Sequence[str], obs=None):
        urls = [normalize_target(t) for t in targets]
        if not urls:
            raise ValueError("a fleet needs at least one replica target")
        if len(set(urls)) != len(urls):
            raise ValueError(f"duplicate replica targets in {list(targets)}")
        self._lock = threading.Lock()
        self._targets: List[str] = urls
        self._states: Dict[str, str] = {t: HEALTHY for t in urls}
        self._causes: Dict[str, Optional[str]] = {t: None for t in urls}
        self._ejections: Dict[str, int] = {t: 0 for t in urls}
        self._signals: Dict[str, dict] = {t: {} for t in urls}
        self.obs = obs
        # the gauge series exist from construction on, so a drill can
        # assert `fleet_replica_state{replica=host:port}=0` and
        # distinguish "healthy" from "never reported"
        for t in urls:
            self._set_state_gauge(t, HEALTHY)

    # -- reads -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._targets)

    @property
    def targets(self) -> List[str]:
        return list(self._targets)

    def state(self, target: str) -> str:
        with self._lock:
            return self._states[target]

    def cause(self, target: str) -> Optional[str]:
        with self._lock:
            return self._causes[target]

    def is_healthy(self, target: str) -> bool:
        with self._lock:
            return self._states[target] == HEALTHY

    def healthy_targets(self) -> List[str]:
        with self._lock:
            return [t for t in self._targets if self._states[t] == HEALTHY]

    def targets_in(self, state: str) -> List[str]:
        with self._lock:
            return [t for t in self._targets if self._states[t] == state]

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._states.values() if s == HEALTHY)

    def ejected_count(self) -> int:
        """Targets currently out of the healthy set (ejected OR under
        probation — neither takes traffic)."""
        with self._lock:
            return sum(1 for s in self._states.values() if s != HEALTHY)

    def signals(self, target: str) -> dict:
        with self._lock:
            return dict(self._signals[target])

    def weight(self, target: str) -> float:
        """The routing weight: published capacity × queue headroom.

        ``capacity`` is the replica's own healthy-lane fraction;
        headroom is ``1 - queue_depth/queue_capacity`` (the bounded
        admission queue). Missing signals default to 1.0 — a replica
        that predates a field is weighted, not starved.
        """
        with self._lock:
            sig = self._signals[target]
        cap = sig.get("capacity")
        cap = 1.0 if cap is None else max(float(cap), 0.0)
        depth, qcap = sig.get("queue_depth"), sig.get("queue_capacity")
        headroom = 1.0
        if depth is not None and qcap:
            headroom = max(1.0 - float(depth) / float(qcap), 0.0)
        return cap * headroom

    def capacity_fraction(self) -> float:
        """The fleet's routed capacity: mean healthy-replica capacity.

        Each healthy replica contributes its own published ``capacity``
        (1.0 when unreported), ejected/probation ones contribute 0 — so
        one dead replica of three reads 2/3, and a surviving replica
        running at 3-of-4 lanes drags the fleet to its true fraction.
        """
        with self._lock:
            total = 0.0
            for t in self._targets:
                if self._states[t] != HEALTHY:
                    continue
                cap = self._signals[t].get("capacity")
                total += 1.0 if cap is None else max(float(cap), 0.0)
            return total / len(self._targets)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [
                {
                    "target": t,
                    "replica": target_label(t),
                    "state": self._states[t],
                    "cause": self._causes[t],
                    "ejections": self._ejections[t],
                    "capacity": self._signals[t].get("capacity"),
                    "queue_depth": self._signals[t].get("queue_depth"),
                    "queue_capacity": self._signals[t].get("queue_capacity"),
                    "identity": self._signals[t].get("identity"),
                    "clock_offset_s": self._signals[t].get("clock_offset_s"),
                    "result_version": self._signals[t].get("result_version"),
                }
                for t in self._targets
            ]

    # -- transitions -------------------------------------------------------

    def eject(self, target: str, cause: str):
        """HEALTHY → EJECTED; ``(changed, healthy_left)``.

        Idempotent unless the target is HEALTHY: a proxied request
        failing on a replica the health poll already ejected (or the
        probation canary currently owns) is the same physical incident —
        counting it again would double-book one outage, and flipping
        PROBATION back would steal the canary claim mid-probe.
        """
        with self._lock:
            if target not in self._states:
                raise KeyError(f"unknown replica target {target!r}")
            if self._states[target] != HEALTHY:
                changed = False
            else:
                self._transition_to_ejected(target, cause)
                changed = True
            healthy_left = sum(
                1 for s in self._states.values() if s == HEALTHY
            )
        if not changed:
            return False, healthy_left
        self._emit_ejected(target, cause, healthy_left)
        return True, healthy_left

    def begin_probation(self, target: str) -> bool:
        """EJECTED → PROBATION (the health loop's exclusive canary claim)."""
        with self._lock:
            if self._states.get(target) != EJECTED:
                return False
            self._states[target] = PROBATION
            self._set_state_gauge(target, PROBATION)
        flightrec.note("mark", "replica_probation", replica=target_label(target))
        if self.obs is not None:
            try:
                self.obs.events.emit(
                    "replica_probation", replica=target_label(target)
                )
            except Exception:  # noqa: BLE001
                pass
        return True

    def reinstate(self, target: str) -> bool:
        """PROBATION → HEALTHY: the canary passed; the replica takes traffic."""
        with self._lock:
            if self._states.get(target) != PROBATION:
                return False
            self._states[target] = HEALTHY
            self._causes[target] = None
            self._set_state_gauge(target, HEALTHY)
        if self.obs is not None:
            try:
                self.obs.registry.counter(
                    FLEET_REPLICA_REINSTATED_TOTAL,
                    help="replicas reinstated to HEALTHY by a passing "
                    "probation canary",
                    replica=target_label(target),
                ).inc()
                self.obs.events.emit(
                    "replica_reinstated", replica=target_label(target)
                )
            except Exception:  # noqa: BLE001
                pass
        flightrec.note("mark", "replica_reinstated", replica=target_label(target))
        log.warning("replica %s reinstated by probation canary", target_label(target))
        return True

    def fail_probation(self, target: str, cause: str = "probe_failed") -> bool:
        """PROBATION → EJECTED: the canary failed; keep the replica out."""
        with self._lock:
            if self._states.get(target) != PROBATION:
                return False
            self._transition_to_ejected(target, cause)
            healthy_left = sum(
                1 for s in self._states.values() if s == HEALTHY
            )
        self._emit_ejected(target, cause, healthy_left)
        return True

    def update_signals(
        self,
        target: str,
        capacity: Optional[float] = None,
        queue_depth: Optional[int] = None,
        queue_capacity: Optional[int] = None,
        identity: Optional[dict] = None,
        canvas: Optional[int] = None,
        min_dim: Optional[int] = None,
        clock_offset_s: Optional[float] = None,
        volume_cost: Optional[int] = None,
        result_version: Optional[str] = None,
    ) -> None:
        """Record one health poll's routing signals for ``target``.

        ``canvas``/``min_dim`` are the replica's request-size guards —
        the probation canary sizes itself inside them.
        ``clock_offset_s`` is the replica's monotonic→wall offset from
        the /readyz clock handshake: published in the router
        table so cross-replica skew is triageable from one screen (the
        nm03-trace merge derives the same offset from each log itself).
        ``volume_cost`` is the replica's published default slice-
        equivalent cost of one whole-volume request: what the
        WRR debits an unsized ``/v1/segment-volume`` proxy by, so a
        volume never weighs like one slice.
        ``result_version`` is the replica's result-key program identity
        (``/readyz`` ``result_cache.program_version``): the
        router's own result tier only engages while every healthy
        replica publishes the SAME value — a mixed fleet mid-rolling-
        restart bypasses the router cache by construction.
        """
        sig = {
            "capacity": capacity,
            "queue_depth": queue_depth,
            "queue_capacity": queue_capacity,
            "identity": identity,
            "canvas": canvas,
            "min_dim": min_dim,
            "clock_offset_s": clock_offset_s,
            "volume_cost": volume_cost,
            "result_version": result_version,
        }
        with self._lock:
            if target not in self._signals:
                raise KeyError(f"unknown replica target {target!r}")
            self._signals[target] = sig
        if self.obs is not None and capacity is not None:
            try:
                self.obs.registry.gauge(
                    FLEET_REPLICA_CAPACITY,
                    help="the replica's own published /readyz capacity "
                    "fraction (healthy-lane share), as last polled",
                    replica=target_label(target),
                ).set(float(capacity))
            except Exception:  # noqa: BLE001
                pass

    # -- telemetry ---------------------------------------------------------

    def _transition_to_ejected(self, target: str, cause: str) -> None:
        """The one EJECTED transition body (caller holds ``_lock``).

        Gauge/counter inside the lock so racing transitions publish in
        state order (the registry lock is a leaf — no ordering cycle);
        events/log stay outside, they do I/O.
        """
        # the caller holds _lock (eject/fail_probation); one helper so the
        # two transition paths cannot drift
        # nm03-lint: disable=NM331 caller holds _lock by contract (eject/fail_probation); the shared helper exists so the two transition paths cannot drift
        self._states[target] = EJECTED
        # nm03-lint: disable=NM331 caller holds _lock, see above
        self._causes[target] = str(cause)
        # nm03-lint: disable=NM331 caller holds _lock, see above
        self._ejections[target] += 1
        self._set_state_gauge(target, EJECTED)
        if self.obs is not None:
            try:
                self.obs.registry.counter(
                    FLEET_REPLICA_EJECTIONS_TOTAL,
                    help="replica ejection transitions by replica and cause "
                    "(refused / timeout / http_503 / zero_capacity / "
                    "proxy_error / probe_failed)",
                    replica=target_label(target),
                    cause=str(cause),
                ).inc()
            except Exception:  # noqa: BLE001
                pass

    def _emit_ejected(self, target: str, cause: str, healthy_left: int) -> None:
        """The ejection's log line, WARNING event, and flight mark (shared
        by ``eject``/``fail_probation`` so the paths cannot drift)."""
        label = target_label(target)
        log.warning(
            "replica %s ejected (%s); %d healthy replica(s) remain",
            label, cause, healthy_left,
        )
        if self.obs is not None:
            try:
                self.obs.events.emit(
                    "replica_ejected", level="WARNING", replica=label,
                    cause=str(cause), healthy_remaining=healthy_left,
                )
            except Exception:  # noqa: BLE001 — telemetry never blocks triage
                pass
        flightrec.note("mark", "replica_ejected", replica=label, cause=str(cause))

    def _set_state_gauge(self, target: str, state: str) -> None:
        if self.obs is None:
            return
        try:
            self.obs.registry.gauge(
                FLEET_REPLICA_STATE,
                help="per-replica fault-domain state "
                "(0 healthy, 1 probation, 2 ejected)",
                replica=target_label(target),
            ).set(REPLICA_STATE_VALUES[state])
        except Exception:  # noqa: BLE001
            pass
