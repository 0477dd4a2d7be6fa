"""SLO plane: declared objectives, multi-window burn rates, error budget.

The port's copy of the JAX package's ``obs/slo.py``, the same arithmetic
over the same series, so the two packages' servers give the same verdict
for the same request history:

* an :class:`SLOObjective` declares what "meeting it" means — an
  availability percentage (the fraction of requests that must terminate
  ok) and optionally a latency target at a percentile (``p99 <= 500ms``:
  at most 1% of requests may exceed 500 ms);
* an :class:`SLOMonitor` computes **multi-window burn rates** from the
  registry's existing request series (``serving_requests_total`` +
  ``serving_request_seconds``), never counting requests itself, so the
  verdict and the metrics cannot disagree. A burn rate of 1.0 means the
  service is consuming error budget exactly as fast as the objective
  allows; the paging pair is a FAST window (default 5 m) and a SLOW
  window (default 1 h);
* three gauges carry the verdict: ``slo_burn_rate_fast``,
  ``slo_burn_rate_slow``, ``slo_error_budget_remaining`` (1.0 = the
  whole budget intact, 0.0 = spent, negative = blown), plus an
  ``slo_objective_info`` info-gauge whose labels name the objective.

The monitor is pull-refreshed like the saturation layer: ``publish()``
on every ``/metrics``/``/metrics.json``/``/readyz`` hit and once at drain.
Probe traffic (``status="probe"``) is in neither the good nor the bad set.

Pure arithmetic over the registry, stdlib only; shared state is
lock-guarded.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional, Sequence

from nm03_capstone_project_tpu_torch.obs.metrics import (
    SLO_BURN_RATE_FAST,
    SLO_BURN_RATE_SLOW,
    SLO_ERROR_BUDGET_REMAINING,
    SLO_OBJECTIVE_INFO,
)

DEFAULT_FAST_WINDOW_S = 300.0
DEFAULT_SLOW_WINDOW_S = 3600.0

# replica-side status classes (serving_requests_total{status}): `shed`
# counts against availability (the client got a 503), `invalid` does not
# (a malformed body is the client's unavailability, not ours), `probe`
# never counts anywhere (canaries are not traffic)
GOOD_STATUSES = ("ok",)
BAD_STATUSES = ("error", "timeout", "shed")


class SLOObjective:
    """One declared service-level objective.

    ``availability_pct`` is the fraction of requests that must terminate
    ok (99.5 = at most 0.5% may fail). ``latency_target_s`` (optional)
    declares a latency SLI at ``latency_pct`` (default 99.0): at most
    ``100 - latency_pct`` percent of requests may exceed the target.
    Pick targets on latency-histogram bucket bounds — the monitor reads
    slow counts from the cumulative buckets, so a target between bounds
    is effectively rounded UP to the next bound (documented, not hidden).
    """

    __slots__ = (
        "availability_pct", "latency_target_s", "latency_pct",
        "window_fast_s", "window_slow_s",
    )

    def __init__(
        self,
        availability_pct: float = 99.0,
        latency_target_s: Optional[float] = None,
        latency_pct: float = 99.0,
        window_fast_s: float = DEFAULT_FAST_WINDOW_S,
        window_slow_s: float = DEFAULT_SLOW_WINDOW_S,
    ):
        if not 0.0 < float(availability_pct) < 100.0:
            raise ValueError(
                f"availability_pct must be in (0, 100), got {availability_pct}"
            )
        if latency_target_s is not None and float(latency_target_s) <= 0:
            raise ValueError(
                f"latency_target_s must be positive, got {latency_target_s}"
            )
        if not 0.0 < float(latency_pct) < 100.0:
            raise ValueError(
                f"latency_pct must be in (0, 100), got {latency_pct}"
            )
        if float(window_fast_s) <= 0 or float(window_slow_s) <= 0:
            raise ValueError("SLO windows must be positive")
        if float(window_fast_s) > float(window_slow_s):
            raise ValueError(
                f"fast window ({window_fast_s}s) must not exceed the slow "
                f"window ({window_slow_s}s)"
            )
        self.availability_pct = float(availability_pct)
        self.latency_target_s = (
            float(latency_target_s) if latency_target_s is not None else None
        )
        self.latency_pct = float(latency_pct)
        self.window_fast_s = float(window_fast_s)
        self.window_slow_s = float(window_slow_s)

    @property
    def availability_budget(self) -> float:
        """The allowed bad fraction (99.5% objective -> 0.005)."""
        return (100.0 - self.availability_pct) / 100.0

    @property
    def latency_budget(self) -> float:
        """The allowed slow fraction (p99 target -> 0.01)."""
        return (100.0 - self.latency_pct) / 100.0

    def describe(self) -> dict:
        return {
            "availability_pct": self.availability_pct,
            "latency_target_ms": (
                round(self.latency_target_s * 1e3, 3)
                if self.latency_target_s is not None else None
            ),
            "latency_pct": self.latency_pct,
            "window_fast_s": self.window_fast_s,
            "window_slow_s": self.window_slow_s,
        }


class _Totals:
    """One cumulative reading: good/bad requests, slow/total latencies."""

    __slots__ = ("t", "good", "bad", "slow", "lat_total")

    def __init__(self, t, good, bad, slow, lat_total):
        self.t = t
        self.good = good
        self.bad = bad
        self.slow = slow
        self.lat_total = lat_total


class SLOMonitor:
    """Burn-rate/budget computation over one process's request series.

    Reads the registry the process already maintains — it never counts
    requests itself, so the SLO verdict and the metrics wall cannot
    disagree. ``publish()`` appends one cumulative sample to a bounded
    ring and re-derives:

    * per window W (fast/slow): the burn rate over the delta between the
      newest sample and the best baseline sample ~W ago — the maximum of
      the availability burn (``bad_fraction / availability_budget``) and
      the latency burn (``slow_fraction / latency_budget``). No traffic
      in the window = burn 0.0 (nothing burned, nothing served);
    * the error budget remaining since monitor start: ``1 - consumed``
      where consumed is the worst SLI's cumulative bad share against its
      budget (negative = the objective is already blown for this run).

    Early in the process the windows are shorter than declared (a 30 s
    old process has 30 s of history); the baseline then is the oldest
    sample — the honest "burn since start".
    """

    def __init__(
        self,
        registry,
        objective: SLOObjective,
        requests_counter: str,
        latency_histogram: str,
        good_statuses: Sequence[str] = GOOD_STATUSES,
        bad_statuses: Sequence[str] = BAD_STATUSES,
        status_label: str = "status",
        clock: Callable[[], float] = time.monotonic,
    ):
        self.registry = registry
        self.objective = objective
        self.requests_counter = str(requests_counter)
        self.latency_histogram = str(latency_histogram)
        self.good_statuses = frozenset(good_statuses)
        self.bad_statuses = frozenset(bad_statuses)
        self.status_label = str(status_label)
        self._clock = clock
        self._lock = threading.Lock()
        # the t0 baseline is held OUTSIDE the window ring: the budget
        # computation needs the true first reading forever, and a bounded
        # ring under a fast scraper would silently evict it
        self._first = self._read()
        # bounded sample ring for the window baselines: age-evicted past
        # the slow window, maxlen a backstop against a pathological
        # scrape storm (a dropped old sample only coarsens a baseline)
        self._samples: deque = deque(maxlen=8192)
        self._samples.append(self._first)
        self._last_block: Optional[dict] = None
        # the gauges exist from construction on (budget intact, nothing
        # burning), so "never computed" is distinguishable from absent
        self._gauge(SLO_ERROR_BUDGET_REMAINING,
                    "fraction of the declared error budget left for this "
                    "process's lifetime (1 = intact, <=0 = blown)").set(1.0)
        self._gauge(SLO_BURN_RATE_FAST,
                    "error-budget burn rate over the fast window (1.0 = "
                    "burning exactly at the objective's allowed rate)").set(0.0)
        self._gauge(SLO_BURN_RATE_SLOW,
                    "error-budget burn rate over the slow window").set(0.0)
        d = objective.describe()
        self.registry.gauge(
            SLO_OBJECTIVE_INFO,
            help="the declared SLO (value is always 1; the labels carry "
            "the objective)",
            availability_pct=str(d["availability_pct"]),
            latency_target_ms=str(d["latency_target_ms"]),
            latency_pct=str(d["latency_pct"]),
            window_fast_s=str(int(d["window_fast_s"])),
            window_slow_s=str(int(d["window_slow_s"])),
        ).set(1)

    def _gauge(self, name: str, help: str):
        return self.registry.gauge(name, help=help)

    # -- cumulative reads --------------------------------------------------

    def _read(self) -> _Totals:
        """One cumulative reading of the request series, registry truth."""
        good = bad = 0.0
        for m in self.registry.series():
            if m.kind != "counter" or m.name != self.requests_counter:
                continue
            status = m.labels.get(self.status_label)
            if status in self.good_statuses:
                good += m.value
            elif status in self.bad_statuses:
                bad += m.value
            # anything else (invalid, probe, future classes) is neither
        slow = lat_total = 0
        target = self.objective.latency_target_s
        for m in self.registry.series():
            if m.kind != "histogram" or m.name != self.latency_histogram:
                continue
            cum = m.cumulative()
            total = cum[-1][1] if cum else 0
            lat_total += total
            if target is None:
                continue
            # the smallest bound >= target: requests above it are slow.
            # A target between bounds therefore rounds UP to the next
            # bound (conservative toward "fast"); a target past every
            # finite bound cannot be measured and counts nothing slow.
            at_bound = None
            for le, c in cum:
                if le == "+Inf":
                    continue
                if float(le) >= target:
                    at_bound = c
                    break
            if at_bound is not None:
                slow += total - at_bound
        return _Totals(self._clock(), good, bad, slow, lat_total)

    # -- burn math ---------------------------------------------------------

    def _baseline(self, now: float, window_s: float) -> _Totals:
        """The newest sample at least ``window_s`` old (else the oldest)."""
        base = self._samples[0]
        for s in self._samples:
            if s.t <= now - window_s:
                base = s
            else:
                break
        return base

    def _burn(self, cur: _Totals, base: _Totals) -> float:
        burns = [0.0]
        d_req = (cur.good - base.good) + (cur.bad - base.bad)
        if d_req > 0:
            bad_frac = max(cur.bad - base.bad, 0.0) / d_req
            burns.append(bad_frac / self.objective.availability_budget)
        if self.objective.latency_target_s is not None:
            d_lat = cur.lat_total - base.lat_total
            if d_lat > 0:
                slow_frac = max(cur.slow - base.slow, 0.0) / d_lat
                burns.append(slow_frac / self.objective.latency_budget)
        return max(burns)

    def _budget_remaining(self, cur: _Totals) -> float:
        """1 - the worst SLI's cumulative budget consumption since start."""
        first = self._first
        consumed = [0.0]
        total_req = (cur.good - first.good) + (cur.bad - first.bad)
        if total_req > 0:
            allowed = self.objective.availability_budget * total_req
            consumed.append((cur.bad - first.bad) / allowed)
        if self.objective.latency_target_s is not None:
            total_lat = cur.lat_total - first.lat_total
            if total_lat > 0:
                allowed = self.objective.latency_budget * total_lat
                consumed.append((cur.slow - first.slow) / allowed)
        return 1.0 - max(consumed)

    # -- the pull-refresh entry point --------------------------------------

    def publish(self) -> dict:
        """Sample, recompute, refresh the gauges; returns the SLO block.

        Called on every scrape/readyz probe and once at drain (the same
        cadence contract the saturation monitor follows).
        """
        with self._lock:
            cur = self._read()
            self._samples.append(cur)
            # age-evict past the slow window (+25% slack): the ring only
            # needs to reach one slow-window baseline back
            horizon = cur.t - self.objective.window_slow_s * 1.25
            while len(self._samples) > 2 and self._samples[0].t < horizon:
                self._samples.popleft()
            fast = self._burn(cur, self._baseline(cur.t,
                                                  self.objective.window_fast_s))
            slow = self._burn(cur, self._baseline(cur.t,
                                                  self.objective.window_slow_s))
            remaining = self._budget_remaining(cur)
        self._gauge(SLO_BURN_RATE_FAST, "").set(round(fast, 6))
        self._gauge(SLO_BURN_RATE_SLOW, "").set(round(slow, 6))
        self._gauge(SLO_ERROR_BUDGET_REMAINING, "").set(round(remaining, 6))
        block = {
            "objective": self.objective.describe(),
            "burn_rate_fast": round(fast, 6),
            "burn_rate_slow": round(slow, 6),
            "error_budget_remaining": round(remaining, 6),
        }
        with self._lock:
            self._last_block = block
        return block

    def last_block(self) -> dict:
        """The most recent ``publish()`` result (publishing once if the
        monitor never has) — for payload builders whose caller already
        refreshed the gauges this scrape, so one probe samples once."""
        with self._lock:
            block = self._last_block
        return block if block is not None else self.publish()


def objective_from_args(args) -> Optional[SLOObjective]:
    """The server's CLI wiring (the JAX package shares it with its fleet).

    Returns None (no SLO plane) unless at least one objective flag was
    given; a latency target without an availability flag uses the 99.0
    default availability.
    """
    availability = getattr(args, "slo_availability", None)
    p99_ms = getattr(args, "slo_p99_ms", None)
    if availability is None and p99_ms is None:
        return None
    fast = getattr(args, "slo_fast_window_s", None)
    slow = getattr(args, "slo_slow_window_s", None)
    # explicit None checks, not `or`: a (bogus) --slo-fast-window-s 0
    # must reach SLOObjective's "windows must be positive" error, never
    # be silently swallowed into the default
    return SLOObjective(
        availability_pct=availability if availability is not None else 99.0,
        latency_target_s=(p99_ms / 1e3) if p99_ms is not None else None,
        window_fast_s=DEFAULT_FAST_WINDOW_S if fast is None else fast,
        window_slow_s=DEFAULT_SLOW_WINDOW_S if slow is None else slow,
    )


def add_slo_args(parser_group) -> None:
    """The ``--slo-*`` flag set, as the JAX server takes it."""
    parser_group.add_argument(
        "--slo-availability", type=float, default=None, metavar="PCT",
        help="declare an availability objective (e.g. 99.5 = at most 0.5%% "
        "of requests may fail); enables the slo_* gauges",
    )
    parser_group.add_argument(
        "--slo-p99-ms", type=float, default=None, metavar="MS",
        help="declare a p99 latency target in milliseconds (at most 1%% of "
        "requests may exceed it); pick a value on a latency-histogram "
        "bucket bound — in-between targets round up to the next bound",
    )
    parser_group.add_argument(
        "--slo-fast-window-s", type=float, default=None, metavar="S",
        help=f"fast burn-rate window (default {DEFAULT_FAST_WINDOW_S:.0f}s "
        "— the 'on fire now' pager window)",
    )
    parser_group.add_argument(
        "--slo-slow-window-s", type=float, default=None, metavar="S",
        help=f"slow burn-rate window (default {DEFAULT_SLOW_WINDOW_S:.0f}s "
        "— the 'sustained, not a blip' window)",
    )


__all__ = [
    "DEFAULT_FAST_WINDOW_S",
    "DEFAULT_SLOW_WINDOW_S",
    "SLOMonitor",
    "SLOObjective",
    "add_slo_args",
    "objective_from_args",
]
