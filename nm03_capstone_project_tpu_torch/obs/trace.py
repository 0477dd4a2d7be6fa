"""Request-scoped tracing for the serving path + the Perfetto exporter.

The port's copy of the JAX package's ``obs/trace.py``: every
``POST /v1/segment`` gets a
**trace id** (an inbound ``X-Nm03-Request-Id`` header is honored after
sanitization, else one is minted) that travels on the
:class:`~..serving.queue.ServeRequest` through admission → coalescing →
the supervised executor → response, and is echoed back as the
``X-Nm03-Request-Id`` response header. Each hop records a **span**
(``queue_wait``, ``coalesce``, ``pad_stack``, ``device_dispatch`` per
supervised attempt, ``fetch``, ``encode``). Chunk-level spans are
*shared*: one record carries every rider's trace id. Completed requests
emit one ``serve_trace`` event (the span tree) into the JSONL event log,
in the JAX package's ``nm03.trace.v1`` span layout, and every span
begin/end also feeds the
:mod:`~nm03_capstone_project_tpu_torch.obs.flightrec` ring. The fleet
router's twin, ``fleet_trace``, carries its own span chain
(:data:`FLEET_SPAN_NAMES`).

The exporter (:func:`main`, ``python -m
nm03_capstone_project_tpu_torch.obs.trace``, the port's ``nm03-trace``)
turns one stream's ``serve_trace`` records into Chrome/Perfetto
``trace_event`` JSON, or stitches a fleet router's stream and its
replicas' streams into one multi-process timeline, each stream's
monotonic span times moved onto the shared wall clock by its own offset.
Its output equals the JAX exporter's for the same streams.

Stdlib only: neither torch nor numpy at import.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import re
import sys
import threading
import time
from typing import Dict, Iterable, List, Optional

from nm03_capstone_project_tpu_torch.obs import flightrec

SCHEMA_TRACE = "nm03.trace.v1"

# the JSONL event (one per completed request) carrying the span tree
SERVE_TRACE_EVENT = "serve_trace"
# the router's twin: one per proxied request (and one per probation
# canary, flagged probe=true) in the fleet front end's stream
FLEET_TRACE_EVENT = "fleet_trace"
# the serving span vocabulary: the JAX package's names for the hops the
# port has (docs/OBSERVABILITY.md trace schema); the serving tests pin it
SERVE_SPAN_NAMES = (
    "queue_wait",       # admission -> popped by the batcher
    "coalesce",         # popped -> the batching window closed
    "pad_stack",        # chunk padded into its bucket canvas stack
    "device_dispatch",  # one supervised execute attempt on one lane
    "fetch",            # device -> host result fetch (inside the deadline)
    "requeue",          # chunk re-dispatched off a quarantined lane
    "probe",            # probation canary on a quarantined lane (off-path)
    "encode",           # host render + JPEG encode on the handler thread
    # whole-volume serving: the gang lane's span chain
    "volume_gang_acquire",  # waiting for the slice batcher to park
    "volume_dispatch",      # one supervised run of a study on one lane
    "volume_gather",        # device -> host mask-volume fetch
    "volume_requeue",       # the study re-dispatched off a dead lane
)

# the router's own spans, riding `fleet_trace` events
FLEET_SPAN_NAMES = (
    "route_pick",       # one smooth-WRR pick over the healthy set
    "proxy_hop",        # one forward attempt to one replica (`replica` field)
    "failover",         # the rider moved off a dying/shedding replica
    "canary_probe",     # one probation canary POST (off-path, probe=true)
)

# client-supplied trace ids: bounded charset/length so a hostile header
# cannot smuggle log-breaking bytes into the event stream or a filename
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:\-]{0,63}$")

_SPAN_SEQ = itertools.count(1)


def new_trace_id() -> str:
    import uuid

    return uuid.uuid4().hex[:16]


def sanitize_trace_id(raw: Optional[str]) -> Optional[str]:
    """A usable client-supplied trace id, or None (caller mints one)."""
    if not isinstance(raw, str):
        return None
    raw = raw.strip()
    return raw if _TRACE_ID_RE.match(raw) else None


def _new_span_id() -> str:
    # pid-salted: the exporter dedupes shared chunk spans by id, and a
    # concatenated event stream (two replicas' logs, or a restarted
    # server appending with ">>") must not let a second process's s1
    # collide with the first's and be silently dropped from the export
    return f"s{os.getpid():x}.{next(_SPAN_SEQ):x}"


def make_span(
    name: str,
    t0_s: float,
    t1_s: float,
    trace_ids: List[str],
    lane: Optional[int] = None,
    **fields,
) -> dict:
    """One span record (the unit both the event log and the exporter use).

    Times are ``time.monotonic()`` seconds — one process-wide timebase so
    spans from different threads line up on one timeline. ``riders`` > 1
    marks a shared (chunk-level) span: one dispatch, many requests.
    """
    rec = {
        "id": _new_span_id(),
        "name": str(name),
        "t0_s": round(t0_s, 6),
        "dur_s": round(max(t1_s - t0_s, 0.0), 6),
        "thread": threading.current_thread().name,
        "lane": lane,
        "riders": len(trace_ids),
        "trace_ids": list(trace_ids),
    }
    for k, v in fields.items():
        if k not in rec:
            rec[k] = v
    return rec


class TraceContext:
    """One request's span collection, carried on the ServeRequest.

    Appends happen from the handler, batcher, and lane-pool threads, but
    always sequenced by the request's own lifecycle handoffs (queue put,
    chunk dispatch, done-Event); the lock makes the container safe against
    a concurrent flight-recorder snapshot mid-append anyway.
    """

    __slots__ = ("trace_id", "spans", "_lock")

    def __init__(self, trace_id: Optional[str] = None):
        self.trace_id = trace_id or new_trace_id()
        self.spans: List[dict] = []
        self._lock = threading.Lock()

    def add(self, rec: dict) -> None:
        with self._lock:
            self.spans.append(rec)

    def add_span(
        self, name: str, t0_s: float, t1_s: float, lane: Optional[int] = None,
        **fields,
    ) -> dict:
        """Record a retrospective span (both endpoints already measured)."""
        rec = make_span(name, t0_s, t1_s, [self.trace_id], lane=lane, **fields)
        self.add(rec)
        flightrec.note(
            "span", name, trace_id=self.trace_id,
            dur_s=rec["dur_s"], lane=lane,
        )
        return rec

    @contextlib.contextmanager
    def span(self, name: str, lane: Optional[int] = None, **fields):
        """Time a section on this request's trace (e.g. ``encode``)."""
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.add_span(name, t0, time.monotonic(), lane=lane, **fields)

    def snapshot(self) -> List[dict]:
        with self._lock:
            return list(self.spans)


class ChunkTrace:
    """Shared spans for one dispatched chunk: many riders, one lane.

    The batcher builds one per chunk; ``span()`` records ONE span carrying
    every rider's trace id and appends it to every rider's context, so a
    coalesced batch is a single dispatch block with ``riders`` requests.
    """

    __slots__ = ("contexts", "lane", "trace_ids", "device_busy_s")

    def __init__(self, contexts: Iterable, lane: Optional[int] = None):
        self.contexts = [c for c in contexts if c is not None]
        self.lane = lane
        self.trace_ids = [c.trace_id for c in self.contexts]
        # accumulated device-busy seconds across every dispatch ATTEMPT of
        # this chunk (requeues included): WarmExecutor.run_batch adds each
        # interval; the batcher prorates the total over the chunk's rows
        self.device_busy_s = 0.0

    def mark(self, name: str, **fields) -> None:
        """Flight-recorder-only marker (no span): the in-flight evidence a
        wedged dispatch leaves behind even when its span never closes."""
        flightrec.note(
            "mark", name, trace_ids=self.trace_ids, lane=self.lane, **fields
        )

    @contextlib.contextmanager
    def span(self, name: str, **fields):
        if not self.contexts:
            yield
            return
        t0 = time.monotonic()
        flightrec.note(
            "span_begin", name, trace_ids=self.trace_ids, lane=self.lane,
            **fields,
        )
        try:
            yield
        finally:
            rec = make_span(
                name, t0, time.monotonic(), self.trace_ids, lane=self.lane,
                **fields,
            )
            for c in self.contexts:
                c.add(rec)
            flightrec.note(
                "span", name, trace_ids=self.trace_ids,
                dur_s=rec["dur_s"], lane=self.lane,
            )


class _NullTrace:
    """No-op stand-in so un-traced call paths cost nothing."""

    lane = None
    trace_ids: List[str] = []

    def mark(self, name: str, **fields) -> None:
        pass

    def span(self, name: str, **fields):
        return contextlib.nullcontext()


NULL_TRACE = _NullTrace()


# -- Chrome/Perfetto trace_event export --------------------------------------


def chrome_trace_events(serve_traces: Iterable[dict]) -> List[dict]:
    """``serve_trace`` records -> Chrome ``trace_event`` B/E pairs.

    Track layout: request-scoped spans (lane is null) ride a per-request
    track named by trace id; chunk-scoped spans ride ``lane N`` tracks —
    the view where ≥2 requests sharing one dispatch span on distinct lanes
    is visible at a glance. Shared spans are deduplicated by span id (they
    appear in every rider's record). Metadata (``ph: "M"``) events name
    the process and tracks; B/E events are globally ts-sorted.
    """
    meta, be = _process_events(list(serve_traces), 1, "nm03-serve")
    be.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "E" else 1))
    return meta + be


def _process_events(
    recs: List[dict], pid: int, process_name: str, shift_s: float = 0.0
) -> tuple:
    """One process's trace records -> (metadata events, unsorted B/E list).

    The single-process exporter and the multi-log merge share this body:
    ``pid`` scopes the track table, ``shift_s`` is added to every span
    time BEFORE the µs conversion (the merge passes each stream's
    monotonic→merged-timeline offset; adding after the conversion would
    put the values past float's 0.1 µs resolution).
    """
    # trace ids are client-controlled and nothing enforces uniqueness: a
    # client retrying with the same X-Nm03-Request-Id while the original
    # is in flight yields two span trees under one id. Disambiguate those
    # request tracks by the server-side request_id so the serializing
    # cursor below never rewrites one request's times to fit another's.
    id_counts: Dict[str, int] = {}
    for rec in recs:
        tid_ = rec.get("trace_id")
        if tid_:
            id_counts[tid_] = id_counts.get(tid_, 0) + 1

    spans: List[tuple] = []  # (span, request-track override)
    seen: set = set()
    for rec in recs:
        tid_ = rec.get("trace_id")
        req_track = f"req {tid_}" if tid_ else None
        if tid_ and id_counts.get(tid_, 0) > 1 and rec.get("request_id"):
            req_track = f"req {tid_} ({rec['request_id']})"
        for sp in rec.get("spans") or []:
            sid = sp.get("id")
            if sid is None or sid in seen:
                continue
            seen.add(sid)
            spans.append((sp, req_track))

    tids: Dict[str, int] = {}
    meta: List[dict] = [
        {
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": process_name},
        }
    ]

    def tid_for(track: str) -> int:
        if track not in tids:
            tids[track] = len(tids) + 1
            meta.append(
                {
                    "ph": "M", "pid": pid, "tid": tids[track],
                    "name": "thread_name", "args": {"name": track},
                }
            )
        return tids[track]

    # group by track: within one track (one request's lifecycle spans, or
    # one lane's sequential chunk work) spans never truly overlap, but the
    # independent 0.1 µs roundings of t0 and dur can make an adjacent
    # pair's E land a hair after the next B — a serializing cursor per
    # track clamps that away so B/E stacks balance at every prefix
    by_track: Dict[str, List[dict]] = {}
    for sp, req_track in spans:
        lane = sp.get("lane")
        if lane is not None:
            track = f"lane {lane}"
        else:
            # `or`, not a .get default: a present-but-empty trace_ids list
            # (schema drift, hand-edited stream) must not crash the export
            track = req_track or f"req {(sp.get('trace_ids') or ['?'])[0]}"
        by_track.setdefault(track, []).append(sp)

    be: List[dict] = []
    # rounding tears are <= 0.2 µs (two independent 0.1 µs roundings);
    # anything past this is a genuine overlap, not an artifact
    _TEAR_EPS_US = 1.0
    for track, track_spans in by_track.items():
        # greedy interval partitioning: spans that GENUINELY overlap on one
        # track — a retry ladder's abandoned device_dispatch attempt
        # returning late while attempt 2 runs on the same lane — keep their
        # true times on an "(overlap)" sibling track instead of being
        # cursor-clamped into a wrong start and a zero width; the cursor
        # only ever absorbs sub-µs rounding tears
        subtracks: List[list] = []  # [tid, cursor_ts] per sibling track
        for sp in sorted(track_spans, key=lambda s: float(s.get("t0_s", 0.0))):
            lane = sp.get("lane")
            t0 = float(sp.get("t0_s", 0.0)) + shift_s
            b_ts = round(t0 * 1e6, 1)
            e_ts = round((t0 + float(sp.get("dur_s", 0.0))) * 1e6, 1)
            slot = next(
                (s for s in subtracks if b_ts >= s[1] - _TEAR_EPS_US), None
            )
            if slot is None:
                n = len(subtracks)
                name = track if n == 0 else (
                    f"{track} (overlap)" if n == 1 else f"{track} (overlap {n})"
                )
                slot = [tid_for(name), b_ts]
                subtracks.append(slot)
            if b_ts < slot[1]:
                b_ts = slot[1]  # sub-µs tear
            if e_ts <= b_ts:
                e_ts = round(b_ts + 0.1, 1)  # strictly-positive width
            slot[1] = e_ts
            args = {
                "trace_ids": sp.get("trace_ids", []),
                "riders": sp.get("riders", len(sp.get("trace_ids", []))),
            }
            if lane is not None:
                args["lane"] = lane
            if "attempt" in sp:
                args["attempt"] = sp["attempt"]
            # fleet-span attribution: which replica a proxy_hop went to and
            # how it ended (the fields --expect-fleet-trace joins on), plus
            # failover causes and the probe flag
            for k in ("replica", "outcome", "cause", "probe"):
                if k in sp:
                    args[k] = sp[k]
            common = {"name": sp.get("name", "?"), "pid": pid, "tid": slot[0],
                      "cat": "serving"}
            be.append({**common, "ph": "B", "ts": b_ts, "args": args})
            be.append({**common, "ph": "E", "ts": e_ts})
    # the caller sorts B/E globally (an E at the same ts as its track's
    # next B must come first so every per-track stack prefix balances)
    return meta, be


def load_serve_traces(events_path: str) -> List[dict]:
    """The ``serve_trace`` records of one JSONL event stream (in order)."""
    return load_stream(events_path)["serve"]


def load_stream(events_path: str) -> dict:
    """Parse one JSONL event stream for the exporter.

    Returns ``{path, serve, fleet, offset_s, run_id}``: the
    ``serve_trace`` and ``fleet_trace`` records in order, plus the
    stream's monotonic→wall clock offset. Span times are
    ``time.monotonic()`` seconds of the WRITING process — meaningless
    across processes — but every event record carries both ``ts_unix``
    and ``mono_s``, so ``median(ts_unix - mono_s)`` recovers the
    process's monotonic epoch on the shared wall clock: the offset the
    multi-log merge aligns each process's spans with. (The replica
    ``/readyz`` handshake echoes the same clock pair live, so the router
    can publish per-replica offsets for skew triage; the merge derives
    its offsets from each log itself and needs no side channel.)
    Unparsable lines are skipped — a SIGKILLed replica's torn tail is
    exactly the post-mortem input this tool exists for.
    """
    serve: List[dict] = []
    fleet: List[dict] = []
    offsets: List[float] = []
    run_id = None
    with open(events_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn tail: a crash mid-write is exactly our use case
            if not isinstance(rec, dict):
                continue
            ts, mono = rec.get("ts_unix"), rec.get("mono_s")
            if isinstance(ts, (int, float)) and isinstance(mono, (int, float)):
                offsets.append(float(ts) - float(mono))
            if run_id is None and rec.get("run_id"):
                run_id = rec["run_id"]
            if rec.get("event") == SERVE_TRACE_EVENT:
                serve.append(rec)
            elif rec.get("event") == FLEET_TRACE_EVENT:
                fleet.append(rec)
    offsets.sort()
    offset_s = offsets[len(offsets) // 2] if offsets else 0.0
    return {
        "path": str(events_path),
        "serve": serve,
        "fleet": fleet,
        "offset_s": offset_s,
        "run_id": run_id,
    }


def _replica_process_name(stream: dict, trace_to_replica: Dict[str, str]) -> str:
    """Name one replica stream's process track.

    The replica's own log does not know its host:port — the ROUTER does
    (every ``fleet_trace`` names the answering replica) — so the join is
    by trace id: the label that answered the majority of this stream's
    trace ids names the process. Streams the router never routed to
    (direct traffic, or a replica that died before completing anything)
    fall back to the run id.
    """
    votes: Dict[str, int] = {}
    for rec in stream["serve"]:
        label = trace_to_replica.get(rec.get("trace_id"))
        if label:
            votes[label] = votes.get(label, 0) + 1
    if votes:
        return f"replica {max(votes, key=votes.get)}"
    suffix = stream["run_id"] or os.path.basename(stream["path"])
    return f"replica {suffix}"


def merged_chrome_trace_events(streams: List[dict]) -> List[dict]:
    """N event streams -> ONE multi-process Perfetto timeline.

    Each stream becomes its own process (router streams — those carrying
    ``fleet_trace`` records — first, then replicas), with every span's
    monotonic time normalized onto one shared timeline via the stream's
    own wall-clock offset (see :func:`load_stream`). The result answers
    "where did request X's 400 ms go, across which replicas" from one
    screen: the router's ``route_pick → proxy_hop → failover →
    proxy_hop`` chain sits above each replica's full span tree under the
    same trace id.
    """
    routers = [s for s in streams if s["fleet"]]
    replicas = [s for s in streams if not s["fleet"]]
    # trace id -> answering replica label, from the router's own records
    trace_to_replica: Dict[str, str] = {}
    for s in routers:
        for rec in s["fleet"]:
            if rec.get("trace_id") and rec.get("replica"):
                trace_to_replica[rec["trace_id"]] = rec["replica"]

    # one shared zero point: the earliest wall-aligned span start across
    # every stream, so ts values stay small enough for 0.1 µs arithmetic
    base = None
    for s in streams:
        for rec in s["fleet"] + s["serve"]:
            for sp in rec.get("spans") or []:
                try:
                    t = float(sp.get("t0_s", 0.0)) + s["offset_s"]
                except (TypeError, ValueError):
                    continue
                base = t if base is None else min(base, t)
    base = base or 0.0

    events: List[dict] = []
    be_all: List[dict] = []
    pid = 0
    for i, s in enumerate(routers):
        pid += 1
        name = "nm03-fleet" if len(routers) == 1 else f"nm03-fleet {i}"
        meta, be = _process_events(
            s["fleet"] + s["serve"], pid, name, shift_s=s["offset_s"] - base
        )
        events.extend(meta)
        be_all.extend(be)
    for s in replicas:
        pid += 1
        meta, be = _process_events(
            s["serve"], pid, _replica_process_name(s, trace_to_replica),
            shift_s=s["offset_s"] - base,
        )
        events.extend(meta)
        be_all.extend(be)
    be_all.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "E" else 1))
    events.extend(be_all)
    return events


def export_chrome_trace(events_paths, out_path: str) -> int:
    """Write the Perfetto-loadable export; returns the request-tree count.

    ``events_paths`` is one stream path or a list of them: a single
    replica-only stream keeps the original single-process export byte
    layout; multiple streams (or any stream carrying ``fleet_trace``
    records) produce the merged multi-process timeline.
    """
    from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_text

    paths = (
        [events_paths] if isinstance(events_paths, (str, os.PathLike))
        else list(events_paths)
    )
    streams = [load_stream(p) for p in paths]
    n_serve = sum(len(s["serve"]) for s in streams)
    n_fleet = sum(len(s["fleet"]) for s in streams)
    if len(streams) == 1 and not n_fleet:
        trace_events = chrome_trace_events(streams[0]["serve"])
        metadata = {"source": streams[0]["path"], "requests": n_serve}
    else:
        trace_events = merged_chrome_trace_events(streams)
        metadata = {
            "sources": [s["path"] for s in streams],
            "requests": n_serve,
            "fleet_requests": n_fleet,
            "processes": len(streams),
        }
    payload = {
        "schema": SCHEMA_TRACE,
        "displayTimeUnit": "ms",
        "traceEvents": trace_events,
        "metadata": metadata,
    }
    atomic_write_text(out_path, json.dumps(payload, indent=1) + "\n")
    return n_serve + n_fleet


def main(argv=None) -> int:
    """``nm03-trace``: events JSONL -> Chrome/Perfetto trace_event JSON.

    Load the output at https://ui.perfetto.dev (or chrome://tracing).
    """
    p = argparse.ArgumentParser(
        prog="nm03-trace", description=main.__doc__.strip().splitlines()[0]
    )
    p.add_argument(
        "events", nargs="+",
        help="JSONL event stream(s) (--log-json output). One replica "
        "stream exports the classic single-process timeline; several — "
        "the fleet router's log plus N replica logs — are stitched into "
        "ONE multi-process timeline with per-replica tracks and "
        "clock-offset-normalized times",
    )
    p.add_argument(
        "-o", "--out", default=None,
        help="trace JSON output path (default: <first events file>"
        ".trace.json)",
    )
    args = p.parse_args(argv)
    out = args.out or f"{args.events[0]}.trace.json"
    try:
        n = export_chrome_trace(args.events, out)
    except OSError as e:
        print(f"nm03-trace: {e}", file=sys.stderr)
        return 2
    merged = f" (merged from {len(args.events)} streams)" if len(
        args.events
    ) > 1 else ""
    print(f"nm03-trace: {n} request trace(s){merged} -> {out}")
    if n == 0:
        print(
            "nm03-trace: no serve_trace records (nor fleet_trace) found — "
            "was the stream written by the server's or the fleet's --log-json "
            "with traffic served?",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
