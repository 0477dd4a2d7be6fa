"""Per-lane fault domains: quarantine, probation, reinstatement.

The port's copy of the JAX package's ``serving/lanes.py``. Each replica
lane (one CUDA device) is its own fault domain:

* **HEALTHY** — the lane takes traffic (the batcher fans windows over
  exactly these lanes);
* **QUARANTINED** — the lane's supervised dispatch expired its deadline
  or exhausted its retry budget; it takes no traffic, its in-flight
  chunk is re-dispatched to healthy lanes, and the flight recorder
  auto-dumps the transition;
* **PROBATION** — a background probe thread has claimed the lane and is
  replaying its bucket-1 CUDA graph on a canary batch, supervised, off
  the request path; success reinstates the lane to HEALTHY, failure
  returns it to QUARANTINED.

When **every** lane is quarantined the replica is degraded (``/readyz``
503 with ``degraded: true``) and requests fail fast until the probe
reinstates a lane. The JAX package's last resort, a one-way CPU fallback,
is not ported: the port never serves from the CPU in place of the card,
so its degradation is not one-way either — on a one-card replica every
quarantine degrades it, and the probe is what brings it back.

Every transition is observable: ``serving_lane_state{lane}`` (0 healthy,
1 probation, 2 quarantined), ``serving_lane_quarantines_total{lane,cause}``,
``serving_lane_reinstated_total{lane}``, WARNING ``lane_quarantined`` /
INFO ``lane_reinstated`` events, and flight-recorder marks + an auto-dump
named ``lane<N>_quarantine_<cause>`` at each quarantine. ``probe_failed``
re-quarantines mark and count but do NOT dump: the lane's original
quarantine already dumped the wedged dispatch's ring.

Stdlib only.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

from nm03_capstone_project_tpu_torch.obs import flightrec
from nm03_capstone_project_tpu_torch.serving.metrics import (
    LANE_STATE_VALUES,
    SERVING_LANE_QUARANTINES_TOTAL,
    SERVING_LANE_REINSTATED_TOTAL,
    SERVING_LANE_STATE,
)
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("serving")

HEALTHY = "healthy"
PROBATION = "probation"
QUARANTINED = "quarantined"


class LaneQuarantined(RuntimeError):
    """One lane left the healthy set mid-dispatch; re-dispatch the chunk.

    Raised by the executor toward the batcher — NOT toward a client. The
    batcher catches it and re-fans the chunk onto the remaining healthy
    lanes (span ``requeue``); when no healthy lane remains the chunk's
    next dispatch fails fast on the degraded executor.
    """

    def __init__(self, lane: int, cause: str):
        super().__init__(f"lane {lane} quarantined ({cause})")
        self.lane = int(lane)
        self.cause = str(cause)


class LaneFaultDomains:
    """The per-lane state machine; one instance per :class:`WarmExecutor`.

    Transitions (all lock-guarded; every mutator returns what the caller
    needs to act without re-reading state):

    ``quarantine(lane, cause)`` — HEALTHY → QUARANTINED; idempotent for
    any lane already out of the healthy set (a racing second dispatch on
    a quarantined lane, or a STALE in-flight dispatch timing out after
    the prober claimed the lane for PROBATION, changes nothing and
    counts nothing — it is the same physical wedge, and stealing the
    probation claim would invalidate a passing canary). Returns
    ``(changed, healthy_remaining)`` so the caller can trip the
    replica's degradation exactly when the LAST lane goes.

    ``begin_probation(lane)`` — QUARANTINED → PROBATION; the probe
    thread's claim, so two probers can never canary one lane at once.

    ``reinstate(lane)`` — PROBATION → HEALTHY (the probe passed).

    ``fail_probation(lane)`` — PROBATION → QUARANTINED (the probe
    failed; cause ``probe_failed``, counted as a fresh quarantine).
    """

    def __init__(self, n_lanes: int, obs=None):
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        self._lock = threading.Lock()
        self._states: List[str] = [HEALTHY] * int(n_lanes)
        self._causes: List[Optional[str]] = [None] * int(n_lanes)
        self._quarantines: List[int] = [0] * int(n_lanes)
        self.obs = obs
        # the gauge series exist from lane 0 of warmup on, so a topology
        # assertion (--expect-gauge serving_lane_state{lane=N}=0) can
        # distinguish "healthy" from "never reported"
        for lane in range(int(n_lanes)):
            self._set_state_gauge(lane, HEALTHY)

    # -- reads -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._states)

    def state(self, lane: int) -> str:
        with self._lock:
            return self._states[lane]

    def cause(self, lane: int) -> Optional[str]:
        with self._lock:
            return self._causes[lane]

    def is_healthy(self, lane: int) -> bool:
        with self._lock:
            return self._states[lane] == HEALTHY

    def healthy_lanes(self) -> List[int]:
        with self._lock:
            return [i for i, s in enumerate(self._states) if s == HEALTHY]

    def lanes_in(self, state: str) -> List[int]:
        with self._lock:
            return [i for i, s in enumerate(self._states) if s == state]

    def healthy_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._states if s == HEALTHY)

    def quarantined_count(self) -> int:
        """Lanes currently out of the healthy set (quarantined OR under
        probation — neither takes traffic)."""
        with self._lock:
            return sum(1 for s in self._states if s != HEALTHY)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [
                {"lane": i, "state": s, "cause": self._causes[i],
                 "quarantines": self._quarantines[i]}
                for i, s in enumerate(self._states)
            ]

    # -- transitions -------------------------------------------------------

    def quarantine(
        self, lane: int, cause: str, trace_ids: Sequence[str] = (),
    ):
        """HEALTHY → QUARANTINED; ``(changed, healthy_left)``.

        ``trace_ids`` are the wedged chunk's riders — they ride the
        WARNING event and the flight-recorder mark so the post-mortem
        names the requests the quarantine stranded.

        Idempotent unless the lane is HEALTHY: new dispatches never land
        on a non-healthy lane (``run_batch`` bounces them at entry), so a
        quarantine call for a QUARANTINED — or prober-claimed PROBATION —
        lane is a STALE in-flight dispatch reporting the wedge that
        already quarantined it. Counting/dumping it again would
        double-book one incident, and flipping PROBATION back would
        steal the prober's claim mid-canary (its reinstate would then
        no-op, idling the lane one extra probe round).
        """
        with self._lock:
            if not 0 <= lane < len(self._states):
                raise ValueError(f"lane {lane} outside [0, {len(self._states)})")
            if self._states[lane] != HEALTHY:
                changed = False
            else:
                self._transition_to_quarantined(lane, cause)
                changed = True
            healthy_left = sum(1 for s in self._states if s == HEALTHY)
        if not changed:
            return False, healthy_left
        self._emit_quarantined(lane, cause, healthy_left, list(trace_ids))
        # the quarantine transition IS the post-mortem moment for this
        # lane: dump while the wedged thread's ring still holds the
        # dispatch that never returned. Inert unless a dump dir is
        # configured (--flight-dir / NM03_FLIGHTREC_DIR).
        flightrec.auto_dump(reason=f"lane{int(lane)}_quarantine_{cause}")
        return True, healthy_left

    def begin_probation(self, lane: int) -> bool:
        """QUARANTINED → PROBATION (the probe thread's exclusive claim)."""
        with self._lock:
            if self._states[lane] != QUARANTINED:
                return False
            self._states[lane] = PROBATION
            self._set_state_gauge(lane, PROBATION)
        flightrec.note("mark", "lane_probation", lane=int(lane))
        if self.obs is not None:
            try:
                self.obs.events.emit("lane_probation", lane=int(lane))
            except Exception:  # noqa: BLE001
                pass
        return True

    def reinstate(self, lane: int) -> bool:
        """PROBATION → HEALTHY: the canary passed; the lane takes traffic
        (and a degraded replica is ready again)."""
        with self._lock:
            if self._states[lane] != PROBATION:
                return False
            self._states[lane] = HEALTHY
            self._causes[lane] = None
            self._set_state_gauge(lane, HEALTHY)
        if self.obs is not None:
            try:
                self.obs.registry.counter(
                    SERVING_LANE_REINSTATED_TOTAL,
                    help="lanes reinstated to HEALTHY by a passing "
                    "probation probe",
                    lane=str(lane),
                ).inc()
                self.obs.events.emit("lane_reinstated", lane=int(lane))
            except Exception:  # noqa: BLE001
                pass
        flightrec.note("mark", "lane_reinstated", lane=int(lane))
        log.warning("lane %d reinstated by probation probe", lane)
        return True

    def fail_probation(self, lane: int, cause: str = "probe_failed") -> bool:
        """PROBATION → QUARANTINED: the canary failed; keep the lane out.

        Counted as a fresh quarantine (the cause tells it apart) but
        deliberately NOT auto-dumped — see the module docstring: the
        original quarantine's dump carries the wedged dispatch's ring,
        and a still-sick chip fails a canary every probe interval.
        """
        with self._lock:
            if self._states[lane] != PROBATION:
                return False
            self._transition_to_quarantined(lane, cause)
            healthy_left = sum(1 for s in self._states if s == HEALTHY)
        self._emit_quarantined(lane, cause, healthy_left, [])
        return True

    # -- telemetry ---------------------------------------------------------

    def _transition_to_quarantined(self, lane: int, cause: str) -> None:
        """The one QUARANTINED transition body (caller holds ``_lock``).

        Gauge/counter INSIDE the lock: racing transitions must publish
        in state order, or ``--expect-gauge`` reads a state the fleet is
        not in (the registry lock is a leaf — no ordering cycle).
        Events/log/dump stay outside: they do I/O and carry their own
        timestamps.
        """
        # the caller holds _lock (quarantine/fail_probation); the shared
        # helper exists so the two transition paths cannot drift
        # nm03-lint: disable=NM331 caller holds _lock by contract (quarantine/fail_probation); the shared helper exists so the two transition paths cannot drift
        self._states[lane] = QUARANTINED
        # nm03-lint: disable=NM331 caller holds _lock, see above
        self._causes[lane] = str(cause)
        # nm03-lint: disable=NM331 caller holds _lock, see above
        self._quarantines[lane] += 1
        self._set_state_gauge(lane, QUARANTINED)
        self._count_quarantine(lane, cause)

    def _emit_quarantined(
        self, lane: int, cause: str, healthy_left: int, trace_ids: List[str]
    ) -> None:
        """The quarantine transition's log line, WARNING event, and
        flight-recorder mark (shared by ``quarantine``/``fail_probation``
        so the two paths can never drift apart)."""
        log.warning(
            "lane %d quarantined (%s); %d healthy lane(s) remain",
            lane, cause, healthy_left,
        )
        if self.obs is not None:
            try:
                self.obs.events.emit(
                    "lane_quarantined", level="WARNING", lane=int(lane),
                    cause=str(cause), healthy_remaining=healthy_left,
                    trace_ids=trace_ids,
                )
            except Exception:  # noqa: BLE001 — telemetry never blocks triage
                pass
        flightrec.note(
            "mark", "lane_quarantined", lane=int(lane), cause=str(cause),
            trace_ids=trace_ids,
        )

    def _set_state_gauge(self, lane: int, state: str) -> None:
        if self.obs is None:
            return
        try:
            self.obs.registry.gauge(
                SERVING_LANE_STATE,
                help="per-lane fault-domain state "
                "(0 healthy, 1 probation, 2 quarantined)",
                lane=str(lane),
            ).set(LANE_STATE_VALUES[state])
        except Exception:  # noqa: BLE001
            pass

    def _count_quarantine(self, lane: int, cause: str) -> None:
        if self.obs is None:
            return
        try:
            self.obs.registry.counter(
                SERVING_LANE_QUARANTINES_TOTAL,
                help="lane quarantine transitions by lane and cause "
                "(deadline / device_lost / probe_failed)",
                lane=str(lane),
                cause=str(cause),
            ).inc()
        except Exception:  # noqa: BLE001
            pass
