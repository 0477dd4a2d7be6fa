"""``nm03-top``: a live one-screen saturation view of a server or a fleet.

The port's copy of the JAX package's ``serving/top.py``; run it as
``python -m nm03_capstone_project_tpu_torch.serving.top``. It polls a
running server's ``/metrics.json`` and ``/readyz`` and renders a
refreshing console view of how much of the card the replica is using —
per-lane state + busy fraction + MFU, queue depth, window occupancy,
padding waste, and request/shed/requeue RATES computed from counter deltas
between polls. ``--fleet`` points it at the fleet front end instead: it
reads the router's per-replica table and aggregates every replica's
``/metrics.json`` + ``/readyz`` into one screen — per-replica
state/capacity/busy/MFU rows plus fleet routed/failover/shed rates
(schema ``nm03.fleettop.v1``).

Stdlib only and read-only — it issues only GETs, so pointing it at a
production replica is always safe. ``--once`` prints a single view and
exits (``--format json`` makes that machine-readable).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import urllib.error
import urllib.request
from typing import Dict, Optional, Tuple

from nm03_capstone_project_tpu_torch.obs.metrics import (
    FLEET_FAILOVERS_TOTAL,
    FLEET_REQUESTS_ROUTED_TOTAL,
    FLEET_SHED_TOTAL,
    INGEST_DECODE_QUEUE_DEPTH,
    INGEST_RING_OCCUPANCY_RATIO,
    INGEST_UPLOAD_OVERLAP_RATIO,
    SERVING_BUSY_FRACTION,
    SERVING_DEVICE_SECONDS_PER_REQUEST_MEAN,
    SERVING_DEVICE_TIME_SHARE,
    SERVING_LANE_BUSY_FRACTION,
    SERVING_LANE_MFU,
    SERVING_MFU,
    SERVING_PADDING_WASTE_RATIO,
    SERVING_WINDOW_OCCUPANCY_RATIO,
    SLO_BURN_RATE_FAST,
    SLO_BURN_RATE_SLOW,
    SLO_ERROR_BUDGET_REMAINING,
)
from nm03_capstone_project_tpu_torch.serving.metrics import (
    SERVING_REQUESTS_TOTAL,
    SERVING_REQUEUES_TOTAL,
    SERVING_RESULT_CACHE_BYTES,
    SERVING_RESULT_CACHE_EVICT_TOTAL,
    SERVING_RESULT_CACHE_HIT_TOTAL,
    SERVING_RESULT_CACHE_MISS_TOTAL,
    SERVING_SHED_TOTAL,
)

CLEAR = "\x1b[2J\x1b[H"  # clear screen + home (ANSI)


class Sample:
    """One poll: parsed metrics snapshot + the /readyz status payload."""

    def __init__(self, metrics: dict, readyz: dict, ts: float):
        self.ts = ts
        self.readyz = readyz
        # gauges: (name, sorted label items) -> value; counters: summed by
        # name (rates never need label splits) and kept per-label for lanes
        self.gauges: Dict[Tuple[str, tuple], float] = {}
        self.counter_totals: Dict[str, float] = {}
        for rec in metrics.get("metrics", []):
            name, kind = rec.get("name"), rec.get("type")
            labels = tuple(sorted((rec.get("labels") or {}).items()))
            value = rec.get("value")
            if not isinstance(value, (int, float)):
                continue
            if kind == "gauge":
                self.gauges[(name, labels)] = float(value)
            elif kind == "counter":
                self.counter_totals[name] = (
                    self.counter_totals.get(name, 0.0) + float(value)
                )

    def gauge(self, name: str, **labels) -> Optional[float]:
        return self.gauges.get((name, tuple(sorted(labels.items()))))


def _pie_block(cur: "Sample") -> Optional[dict]:
    """The device-time pie, or None when the scraped process
    hasn't taken a profile sample yet (sampler off, or first cadence tick
    still pending) — top shows the ledger's gauges, it never profiles."""
    shares = {
        labels[0][1]: v
        for (name, labels), v in cur.gauges.items()
        if name == SERVING_DEVICE_TIME_SHARE and labels
    }
    if not shares:
        return None
    return {k: round(v, 4) for k, v in shares.items()}


def _pie_line(
    shares: Optional[dict], ds_per_req: Optional[float]
) -> Optional[str]:
    if shares is None and ds_per_req is None:
        return None
    parts = ["device pie"]
    for stage, v in sorted(
        (shares or {}).items(), key=lambda kv: -kv[1]
    ):
        parts.append(f"{stage} {_fmt(v, pct=True).strip()}")
    if ds_per_req is not None:
        parts.append(f"ds/req {ds_per_req * 1000:.3g}ms")
    return "   ".join(parts)


def _cache_block(cur: "Sample", prev: Optional["Sample"]) -> Optional[dict]:
    """The result-tier row, or None when the scraped process
    runs no tier — the bytes gauge exists (at 0) from startup on any
    tier-enabled process, so its absence IS the disabled signal; top
    renders the gauges, it never guesses."""
    bytes_g = cur.gauge(SERVING_RESULT_CACHE_BYTES)
    if bytes_g is None:
        return None
    hits = cur.counter_totals.get(SERVING_RESULT_CACHE_HIT_TOTAL, 0.0)
    misses = cur.counter_totals.get(SERVING_RESULT_CACHE_MISS_TOTAL, 0.0)
    lookups = hits + misses
    return {
        "bytes": int(bytes_g),
        "hits": int(hits),
        "misses": int(misses),
        "hit_ratio": round(hits / lookups, 4) if lookups else None,
        "hit_per_s": _rate(cur, prev, SERVING_RESULT_CACHE_HIT_TOTAL),
        "evict_per_s": _rate(cur, prev, SERVING_RESULT_CACHE_EVICT_TOTAL),
    }


def _cache_line(cache: Optional[dict]) -> Optional[str]:
    if cache is None:
        return None

    def _r(v):
        return "-" if v is None else v

    hr = cache["hit_ratio"]
    return (
        f"result cache {cache['bytes']}B   "
        f"hit ratio {'-' if hr is None else _fmt(hr, pct=True).strip()} "
        f"({cache['hits']}/{cache['hits'] + cache['misses']})   "
        f"hit/s {_r(cache['hit_per_s'])}   "
        f"evict/s {_r(cache['evict_per_s'])}"
    )


def _slo_block(cur: "Sample") -> Optional[dict]:
    """The SLO row's numbers, or None when no objective was
    declared on the scraped process — top shows the gauges, it never
    recomputes (or invents) an objective."""
    budget = cur.gauge(SLO_ERROR_BUDGET_REMAINING)
    if budget is None:
        return None
    return {
        "error_budget_remaining": budget,
        "burn_rate_fast": cur.gauge(SLO_BURN_RATE_FAST),
        "burn_rate_slow": cur.gauge(SLO_BURN_RATE_SLOW),
    }


def _slo_line(slo: Optional[dict]) -> Optional[str]:
    if slo is None:
        return None

    def _n(v):
        return "-" if v is None else f"{v:.3g}"

    return (
        f"slo burn fast {_n(slo['burn_rate_fast'])}   "
        f"slow {_n(slo['burn_rate_slow'])}   "
        f"budget {_fmt(slo['error_budget_remaining'], pct=True).strip()} left"
    )


def fetch_sample(url: str, timeout_s: float) -> Sample:
    """GET /metrics.json + /readyz (any status; a 503 body still carries
    the fleet payload). Raises URLError/OSError when the server is gone."""
    with urllib.request.urlopen(
        f"{url}/metrics.json", timeout=timeout_s
    ) as resp:
        metrics = json.loads(resp.read())
    try:
        with urllib.request.urlopen(f"{url}/readyz", timeout=timeout_s) as r:
            readyz = json.loads(r.read())
    except urllib.error.HTTPError as e:  # 503 carries the payload too
        try:
            readyz = json.loads(e.read() or b"{}")
        except json.JSONDecodeError:
            readyz = {}
    return Sample(metrics, readyz, time.monotonic())


def _rate(cur: Sample, prev: Optional[Sample], name: str) -> Optional[float]:
    if prev is None:
        return None
    dt = cur.ts - prev.ts
    if dt <= 0:
        return None
    return round(
        max(
            cur.counter_totals.get(name, 0.0)
            - prev.counter_totals.get(name, 0.0),
            0.0,
        )
        / dt,
        2,
    )


def build_view(cur: Sample, prev: Optional[Sample] = None) -> dict:
    """One renderable/JSON-able view from a poll (+ rates vs the prior).

    Every number is sourced from the same registry the ``/metrics``
    scrape and the ``check_telemetry`` gates read — nm03-top shows the
    gauges, it never recomputes them.
    """
    st = cur.readyz or {}
    lanes_info = st.get("lanes") or {}
    rows = []
    for lane_row in lanes_info.get("per_lane") or []:
        lane = lane_row.get("lane")
        busy = cur.gauge(SERVING_LANE_BUSY_FRACTION, lane=str(lane))
        mfu = cur.gauge(SERVING_LANE_MFU, lane=str(lane))
        rows.append(
            {
                "lane": lane,
                "state": lane_row.get("state", "?"),
                "busy_fraction": busy,
                "mfu": mfu,
                "inflight": lane_row.get("inflight"),
                "batches": lane_row.get("batches"),
                "quarantines": lane_row.get("quarantines"),
            }
        )
    return {
        "schema": "nm03.top.v1",
        "ready": st.get("ready"),
        "draining": st.get("draining"),
        "degraded": st.get("degraded"),
        "capacity": st.get("capacity"),
        "uptime_s": st.get("uptime_s"),
        "queue_depth": st.get("queue_depth"),
        "queue_capacity": st.get("queue_capacity"),
        "lanes": rows,
        "busy_fraction": cur.gauge(SERVING_BUSY_FRACTION),
        "mfu": cur.gauge(SERVING_MFU),
        "padding_waste_ratio": cur.gauge(SERVING_PADDING_WASTE_RATIO),
        "window_occupancy_ratio": cur.gauge(SERVING_WINDOW_OCCUPANCY_RATIO),
        # streaming-ingest column: present whenever the scraped
        # snapshot carries the ingest_* gauges (a process feeding the card
        # through ingest/), null otherwise — nm03-top renders what the
        # registry knows, it never guesses
        "ingest": (
            {
                "ring_occupancy_ratio": cur.gauge(INGEST_RING_OCCUPANCY_RATIO),
                "decode_queue_depth": cur.gauge(INGEST_DECODE_QUEUE_DEPTH),
                "upload_overlap_ratio": cur.gauge(INGEST_UPLOAD_OVERLAP_RATIO),
            }
            if cur.gauge(INGEST_RING_OCCUPANCY_RATIO) is not None
            else None
        ),
        # the SLO row: burn rates + budget when the scraped
        # process declared an objective, null otherwise
        "slo": _slo_block(cur),
        # the result-tier row: bytes/hit-ratio/evict rate from
        # the serving_result_cache_* series, null when the tier is off
        "result_cache": _cache_block(cur, prev),
        # the device-time pie: per-stage shares of sampled
        # device time + mean prorated device-seconds per request — null
        # until the ledger's profile sampler has reduced a capture
        "device_time_share": _pie_block(cur),
        "device_seconds_per_request": cur.gauge(
            SERVING_DEVICE_SECONDS_PER_REQUEST_MEAN
        ),
        # rates from counter deltas between polls (null on the first poll
        # and in --once mode: one sample has no delta)
        "rates_per_s": {
            "requests": _rate(cur, prev, SERVING_REQUESTS_TOTAL),
            "shed": _rate(cur, prev, SERVING_SHED_TOTAL),
            "requeues": _rate(cur, prev, SERVING_REQUEUES_TOTAL),
        },
    }


def _fmt(v, pct: bool = False, width: int = 7) -> str:
    if v is None:
        return "-".rjust(width)
    if pct:
        # 3 significant digits: a virtual-CPU lane's honest 0.04% busy
        # (or a 3e-4% MFU) must not render as a misleading "0.0%"
        return f"{v * 100:.3g}%".rjust(width)
    return f"{v:.6g}".rjust(width)


def render_text(view: dict, url: str) -> str:
    """The one-screen console rendering of a view."""
    state = (
        "DRAINING" if view.get("draining")
        else "DEGRADED" if view.get("degraded")
        else "ready" if view.get("ready")
        else "not-ready"
    )
    rates = view["rates_per_s"]
    lines = [
        f"nm03-top — {url}   [{state}]   uptime "
        f"{view.get('uptime_s') if view.get('uptime_s') is not None else '?'}s",
        (
            f"queue {view.get('queue_depth')}/{view.get('queue_capacity')}   "
            f"capacity {_fmt(view.get('capacity'), pct=True).strip()}   "
            f"busy {_fmt(view.get('busy_fraction'), pct=True).strip()}   "
            f"mfu {_fmt(view.get('mfu'), pct=True).strip()}"
        ),
        (
            f"occupancy {_fmt(view.get('window_occupancy_ratio'), pct=True).strip()}   "
            f"padding waste "
            f"{_fmt(view.get('padding_waste_ratio'), pct=True).strip()}   "
            f"req/s {rates['requests'] if rates['requests'] is not None else '-'}   "
            f"shed/s {rates['shed'] if rates['shed'] is not None else '-'}   "
            f"requeue/s {rates['requeues'] if rates['requeues'] is not None else '-'}"
        ),
        "",
        f"{'lane':>4} {'state':<12} {'busy':>8} {'mfu':>8} "
        f"{'inflight':>8} {'batches':>8} {'quar':>5}",
    ]
    ing = view.get("ingest")
    if ing is not None:
        lines.insert(
            3,
            (
                f"ingest ring "
                f"{_fmt(ing['ring_occupancy_ratio'], pct=True).strip()}   "
                f"decode-q {ing['decode_queue_depth'] if ing['decode_queue_depth'] is not None else '-'}   "
                f"upload overlap "
                f"{_fmt(ing['upload_overlap_ratio'], pct=True).strip()}"
            ),
        )
    cache_line = _cache_line(view.get("result_cache"))
    if cache_line is not None:
        lines.insert(3, cache_line)
    pie_line = _pie_line(
        view.get("device_time_share"), view.get("device_seconds_per_request")
    )
    if pie_line is not None:
        lines.insert(3, pie_line)
    slo_line = _slo_line(view.get("slo"))
    if slo_line is not None:
        lines.insert(3, slo_line)
    for row in view["lanes"]:
        lines.append(
            f"{str(row['lane']):>4} {str(row['state']):<12} "
            f"{_fmt(row['busy_fraction'], pct=True, width=8)} "
            f"{_fmt(row['mfu'], pct=True, width=8)} "
            f"{str(row['inflight']):>8} {str(row['batches']):>8} "
            f"{str(row['quarantines']):>5}"
        )
    if not view["lanes"]:
        lines.append("  (no lanes resolved yet — server still warming?)")
    return "\n".join(lines)


# -- the fleet view ----------------------------------------------


def fetch_fleet_sample(url: str, timeout_s: float):
    """One fleet poll: the router's /readyz table + its /metrics.json,
    plus a per-replica :class:`Sample` for every reachable replica.

    Returns ``(fleet_sample, {target: replica Sample or None})``. Raises
    when the FLEET itself is unreachable; an unreachable replica is a row
    with nulls — exactly what an ejected replica should look like.
    """
    fleet = fetch_sample(url, timeout_s)
    per: Dict[str, Optional[Sample]] = {}
    table = (fleet.readyz.get("replicas") or {}).get("per_replica") or []
    for row in table:
        target = row.get("target")
        if not target:
            continue
        try:
            per[target] = fetch_sample(target, timeout_s)
        except Exception:  # noqa: BLE001 — a dead replica is a null row
            per[target] = None
    return fleet, per


def build_fleet_view(
    fleet: Sample,
    per: Dict[str, Optional[Sample]],
    prev_fleet: Optional[Sample] = None,
    prev_per: Optional[Dict[str, Optional[Sample]]] = None,
) -> dict:
    """One renderable/JSON-able aggregate of the whole fleet.

    Fleet-level numbers come from the router's own /readyz + fleet_*
    counters; each replica row aggregates that replica's /metrics.json
    (busy/MFU/queue) next to the router's verdict on it (state/cause) —
    the one-screen answer to "which replica is the outlier".
    """
    st = fleet.readyz or {}
    table = (st.get("replicas") or {}).get("per_replica") or []
    prev_per = prev_per or {}
    rows = []
    for entry in table:
        target = entry.get("target")
        s = per.get(target)
        ps = prev_per.get(target)
        r_ready = s.readyz if s is not None else {}
        rows.append({
            "replica": entry.get("replica"),
            "target": target,
            "state": entry.get("state", "?"),
            "cause": entry.get("cause"),
            "ejections": entry.get("ejections"),
            "capacity": entry.get("capacity"),
            "queue_depth": r_ready.get("queue_depth"),
            "lanes_ready": (r_ready.get("lanes") or {}).get("ready"),
            "busy_fraction": (
                s.gauge(SERVING_BUSY_FRACTION) if s is not None else None
            ),
            "mfu": s.gauge(SERVING_MFU) if s is not None else None,
            "device_seconds_per_request": (
                s.gauge(SERVING_DEVICE_SECONDS_PER_REQUEST_MEAN)
                if s is not None else None
            ),
            "requests_per_s": (
                _rate(s, ps, SERVING_REQUESTS_TOTAL)
                if s is not None and ps is not None else None
            ),
            "id": (entry.get("identity") or {}).get("id"),
            "pid": (entry.get("identity") or {}).get("pid"),
        })
    # the fleet pie: each stage's share averaged across the
    # replicas that have sampled one — the fleet-wide "where do the
    # device-seconds go" answer, null until any replica has a pie
    pies = [p for p in (
        _pie_block(s) for s in per.values() if s is not None
    ) if p]
    fleet_pie: Optional[dict] = None
    if pies:
        stages = sorted({k for p in pies for k in p})
        fleet_pie = {
            st: round(
                sum(p.get(st, 0.0) for p in pies) / len(pies), 4
            )
            for st in stages
        }
    return {
        "schema": "nm03.fleettop.v1",
        "ready": st.get("ready"),
        "draining": st.get("draining"),
        "capacity": st.get("capacity"),
        "uptime_s": st.get("uptime_s"),
        "replicas_ready": (st.get("replicas") or {}).get("ready"),
        "replicas_ejected": (st.get("replicas") or {}).get("ejected"),
        # the fleet-level SLO row: the ROUTER's own burn
        # gauges — the whole-fleet verdict, not any one replica's
        "slo": _slo_block(fleet),
        # the ROUTER's own result tier: the front-end store
        # that answers repeats without a replica pick — null when off
        "result_cache": _cache_block(fleet, prev_fleet),
        "device_time_share": fleet_pie,
        "replicas": rows,
        "rates_per_s": {
            "routed": _rate(fleet, prev_fleet, FLEET_REQUESTS_ROUTED_TOTAL),
            "failovers": _rate(fleet, prev_fleet, FLEET_FAILOVERS_TOTAL),
            "shed": _rate(fleet, prev_fleet, FLEET_SHED_TOTAL),
        },
    }


def render_fleet_text(view: dict, url: str) -> str:
    """The one-screen console rendering of a fleet view."""
    state = (
        "DRAINING" if view.get("draining")
        else "ready" if view.get("ready")
        else "NOT-READY"
    )
    rates = view["rates_per_s"]

    def _r(k):
        return rates[k] if rates[k] is not None else "-"

    lines = [
        f"nm03-top — fleet {url}   [{state}]   uptime "
        f"{view.get('uptime_s') if view.get('uptime_s') is not None else '?'}s",
        (
            f"replicas {view.get('replicas_ready')}/"
            f"{(view.get('replicas_ready') or 0) + (view.get('replicas_ejected') or 0)} "
            f"ready   capacity {_fmt(view.get('capacity'), pct=True).strip()}   "
            f"routed/s {_r('routed')}   failover/s {_r('failovers')}   "
            f"shed/s {_r('shed')}"
        ),
        "",
        f"{'replica':<22} {'state':<10} {'cap':>6} {'lanes':>5} "
        f"{'queue':>5} {'busy':>8} {'mfu':>8} {'req/s':>7} "
        f"{'ds/req':>8} {'eject':>5}",
    ]
    cache_line = _cache_line(view.get("result_cache"))
    if cache_line is not None:
        lines.insert(2, cache_line)
    pie_line = _pie_line(view.get("device_time_share"), None)
    if pie_line is not None:
        lines.insert(2, pie_line)
    slo_line = _slo_line(view.get("slo"))
    if slo_line is not None:
        lines.insert(2, slo_line)
    for row in view["replicas"]:
        dsr = row["device_seconds_per_request"]
        dsr_s = "-" if dsr is None else f"{dsr * 1000:.3g}ms"
        lines.append(
            f"{str(row['replica']):<22} {str(row['state']):<10} "
            f"{_fmt(row['capacity'], pct=True, width=6)} "
            f"{str(row['lanes_ready'] if row['lanes_ready'] is not None else '-'):>5} "
            f"{str(row['queue_depth'] if row['queue_depth'] is not None else '-'):>5} "
            f"{_fmt(row['busy_fraction'], pct=True, width=8)} "
            f"{_fmt(row['mfu'], pct=True, width=8)} "
            f"{str(row['requests_per_s'] if row['requests_per_s'] is not None else '-'):>7} "
            f"{dsr_s:>8} "
            f"{str(row['ejections']):>5}"
        )
    if not view["replicas"]:
        lines.append("  (no replicas in the fleet table yet)")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nm03-top", description=__doc__.strip().splitlines()[0]
    )
    p.add_argument(
        "--url", default="http://127.0.0.1:8077", help="server base URL"
    )
    p.add_argument(
        "--fleet", action="store_true",
        help="treat --url as an nm03-fleet front-end: aggregate every "
        "replica's /metrics.json + /readyz behind it into one screen "
        "(per-replica state/capacity/busy/MFU + fleet routed/failover/"
        "shed rates)",
    )
    p.add_argument(
        "--interval-s", type=float, default=2.0,
        help="refresh period (each refresh is one /metrics.json + /readyz "
        "poll; rates are deltas over this period)",
    )
    p.add_argument(
        "--once", action="store_true",
        help="print one view and exit (rates are null: one sample has no "
        "delta)",
    )
    p.add_argument(
        "--format", choices=["text", "json"], default="text",
        help="output format (json is the machine/CI interface)",
    )
    p.add_argument(
        "--timeout-s", type=float, default=5.0, help="per-poll HTTP timeout"
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.interval_s <= 0:
        print("nm03-top: --interval-s must be > 0", file=sys.stderr)
        return 2
    prev: Optional[Sample] = None
    prev_per: Optional[Dict[str, Optional[Sample]]] = None
    try:
        while True:
            try:
                if args.fleet:
                    cur, per = fetch_fleet_sample(args.url, args.timeout_s)
                else:
                    cur = fetch_sample(args.url, args.timeout_s)
            except Exception as e:  # noqa: BLE001 — unreachable server is the exit
                print(f"nm03-top: {args.url} unreachable: {e}", file=sys.stderr)
                return 2
            if args.fleet:
                view = build_fleet_view(cur, per, prev, prev_per)
            else:
                view = build_view(cur, prev)
            if args.format == "json":
                out = json.dumps(view, indent=None if args.once else 1)
                print(out, flush=True)
            else:
                screen = (
                    render_fleet_text(view, args.url) if args.fleet
                    else render_text(view, args.url)
                )
                if args.once:
                    print(screen, flush=True)
                else:
                    sys.stdout.write(CLEAR + screen + "\n")
                    sys.stdout.flush()
            if args.once:
                return 0
            prev = cur
            if args.fleet:
                prev_per = per
            time.sleep(args.interval_s)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
