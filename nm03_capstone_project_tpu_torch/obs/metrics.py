"""Metrics registry: counters, gauges, and bucketed histograms.

The port's copy of the JAX package's ``obs/metrics.py``: the same registry,
the same ``nm03.metrics.v1`` JSON snapshot (``scripts/check_telemetry.py
--metrics`` validates both packages' snapshots) and the same Prometheus
text exposition.

Design constraints:

* **Thread-safe.** HTTP handler threads, the batcher and the lane threads
  all write to one registry.
* **Pure stdlib.** The registry imports no torch and no numpy.
* **Bounded cardinality is the caller's job**, but the registry enforces
  name/label hygiene (Prometheus-legal names, string label values) so a
  drifting call site fails at the increment, not in the scrape pipeline.
"""

from __future__ import annotations

import json
import math
import re
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

SCHEMA_METRICS = "nm03.metrics.v1"

# -- metric names -------------------------------------------------------------
# The series the ported layers register, under the JAX package's names.
# Serving series live in serving/metrics.py.
STAGE_LATENCY_METRIC = "nm03_stage_latency_seconds"
RESILIENCE_RETRIES_TOTAL = "resilience_retries_total"
PIPELINE_DEGRADED_TOTAL = "pipeline_degraded_total"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Latency buckets in seconds, spanning sub-ms device dispatches to
# multi-minute cohort sections.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValueError(f"invalid metric name: {name!r}")
    return name


def _check_labels(labels: Dict[str, str]) -> Dict[str, str]:
    out = {}
    for k in sorted(labels):
        if not _LABEL_RE.match(k):
            raise ValueError(f"invalid label name: {k!r}")
        out[k] = str(labels[k])
    return out


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in labels.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    """One (name, labels) series. Subclasses define the value semantics."""

    kind = "untyped"

    def __init__(self, name: str, labels: Dict[str, str], help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        # RLock, not Lock: a signal handler may snapshot the registry on the
        # main thread, interrupting a frame that already holds this lock —
        # same-thread re-acquisition must succeed
        self._lock = threading.RLock()


class Counter(_Metric):
    """Monotone non-decreasing accumulator (Prometheus counter semantics)."""

    kind = "counter"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (inc by {amount})"
            )
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render(self) -> dict:
        return {"value": self.value}


class Gauge(_Metric):
    """Point-in-time value; may move in both directions."""

    kind = "gauge"

    def __init__(self, name, labels, help=""):
        super().__init__(name, labels, help)
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render(self) -> dict:
        return {"value": self.value}


class Histogram(_Metric):
    """Bucketed distribution with Prometheus cumulative-``le`` semantics."""

    kind = "histogram"

    def __init__(self, name, labels, help="", buckets: Iterable[float] = None):
        super().__init__(name, labels, help)
        bounds = tuple(buckets) if buckets is not None else DEFAULT_LATENCY_BUCKETS
        if not bounds or list(bounds) != sorted(set(bounds)):
            raise ValueError(f"histogram buckets must be strictly increasing: {bounds}")
        if not all(math.isfinite(b) for b in bounds):
            # the +Inf bucket is implicit (always last); a non-finite bound
            # must fail here, at creation, not at snapshot/export time
            raise ValueError(f"histogram buckets must be finite: {bounds}")
        self.bounds: Tuple[float, ...] = tuple(float(b) for b in bounds)
        # per-bucket (non-cumulative) counts; the +Inf bucket is the last slot
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _state(self) -> Tuple[List[Tuple[str, int]], float, int]:
        """(cumulative buckets, sum, count) read under ONE lock hold, so a
        concurrent observe() can never tear a snapshot (a torn +Inf-vs-count
        pair would fail the check_telemetry gate on a file the registry
        itself wrote)."""
        with self._lock:
            out, acc = [], 0
            for b, c in zip(self.bounds, self._counts):
                acc += c
                out.append((repr(b) if b != int(b) else str(int(b)), acc))
            out.append(("+Inf", acc + self._counts[-1]))
            return out, self._sum, self._count

    def cumulative(self) -> List[Tuple[str, int]]:
        """[(le-string, cumulative count)] ending with ('+Inf', total)."""
        return self._state()[0]

    def _render(self) -> dict:
        cum, s, c = self._state()
        return {"buckets": [[le, n] for le, n in cum], "sum": s, "count": c}


class MetricsRegistry:
    """Get-or-create home for every metric series of one run."""

    _KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._lock = threading.RLock()  # signal-handler reentrancy (see _Metric)
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], _Metric] = {}
        self._kind_by_name: Dict[str, str] = {}

    def _get_or_create(self, cls, name, help, labels, **kwargs) -> _Metric:
        _check_name(name)
        labels = _check_labels(labels)
        key = (name, tuple(labels.items()))
        with self._lock:
            existing_kind = self._kind_by_name.get(name)
            if existing_kind is not None and existing_kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as {existing_kind}, "
                    f"requested {cls.kind}"
                )
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, labels, help=help, **kwargs)
                self._metrics[key] = m
                self._kind_by_name[name] = cls.kind
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(
        self, name: str, help: str = "", buckets: Iterable[float] = None, **labels
    ) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str, **labels) -> Optional[_Metric]:
        """Existing series or None (never creates; for tests/validators)."""
        key = (name, tuple(_check_labels(labels).items()))
        with self._lock:
            return self._metrics.get(key)

    def series(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def counter_totals(self) -> Dict[str, float]:
        """Sum of every counter across its label sets (heartbeat payload)."""
        out: Dict[str, float] = {}
        for m in self.series():
            if isinstance(m, Counter):
                out[m.name] = out.get(m.name, 0.0) + m.value
        return {k: out[k] for k in sorted(out)}

    # -- export ------------------------------------------------------------

    def snapshot(
        self, run_id: Optional[str] = None, git_sha: Optional[str] = None
    ) -> dict:
        """JSON-able snapshot (schema ``nm03.metrics.v1``)."""
        metrics = []
        for m in sorted(self.series(), key=lambda m: (m.name, sorted(m.labels.items()))):
            rec = {"name": m.name, "type": m.kind, "labels": m.labels}
            if m.help:
                rec["help"] = m.help
            rec.update(m._render())
            metrics.append(rec)
        return {
            "schema": SCHEMA_METRICS,
            "run_id": run_id,
            "git_sha": git_sha,
            "created_unix": round(time.time(), 3),
            "metrics": metrics,
        }

    def write_snapshot(self, path, run_id=None, git_sha=None) -> None:
        import os

        path = str(path)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(run_id=run_id, git_sha=git_sha), f, indent=1)
            f.write("\n")
        os.replace(tmp, path)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        by_name: Dict[str, List[_Metric]] = {}
        for m in self.series():
            by_name.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(by_name):
            group = by_name[name]
            help_text = next((m.help for m in group if m.help), "")
            if help_text:
                lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {group[0].kind}")
            for m in sorted(group, key=lambda m: sorted(m.labels.items())):
                if isinstance(m, Histogram):
                    buckets, h_sum, h_count = m._state()  # one atomic read
                    for le, cum in buckets:
                        le_sel = f'le="{le}"'
                        lines.append(
                            f"{name}_bucket{_format_labels(m.labels, le_sel)} {cum}"
                        )
                    lines.append(f"{name}_sum{_format_labels(m.labels)} {h_sum}")
                    lines.append(f"{name}_count{_format_labels(m.labels)} {h_count}")
                else:
                    v = m.value
                    out = int(v) if float(v).is_integer() else v
                    lines.append(f"{name}{_format_labels(m.labels)} {out}")
        return "\n".join(lines) + "\n" if lines else ""
