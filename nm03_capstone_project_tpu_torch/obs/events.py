"""Structured event log: JSON-lines run telemetry.

The port's copy of the JAX package's ``obs/events.py``, schema and all.

Every record is one JSON object on one line carrying the run envelope —
run id, git SHA, a monotonically increasing sequence number, wall AND
monotonic timestamps — plus a level, an event name, and free-form fields.
The schema (``nm03.events.v1``) is documented in docs/OBSERVABILITY.md and
enforced by scripts/check_telemetry.py; the server writes it via ``--log-json``.

Also here:

* :class:`Heartbeat` — a daemon thread emitting a periodic ``heartbeat``
  event with uptime and live counter totals, so a stalled cohort run is
  distinguishable from a slow one by tailing the event stream;
* :class:`LogBridge` — a ``logging.Handler`` that mirrors the package
  logger's WARNING+ records into the event stream, so the existing
  ``log.warning`` fault-containment messages (decode failures, export
  failures) become structured events without touching every call site.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
import uuid
from collections import deque
from typing import Optional

SCHEMA_EVENTS = "nm03.events.v1"
LEVELS = ("DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL")
# the run envelope; emit() rejects field names that would shadow it
RESERVED_KEYS = (
    "schema", "run_id", "git_sha", "seq", "ts_unix", "mono_s", "level", "event",
)


def new_run_id() -> str:
    return uuid.uuid4().hex[:12]


_GIT_SHA_CACHE: Optional[str] = None


def _default_git_sha() -> str:
    # lazy (utils.timing shells out to git; never at import time) and cached
    # per process: library callers construct many sink-less EventLogs and
    # must not pay two subprocesses each
    global _GIT_SHA_CACHE
    if _GIT_SHA_CACHE is None:
        try:
            from nm03_capstone_project_tpu_torch.utils.timing import git_sha

            _GIT_SHA_CACHE = git_sha()
        except Exception:  # noqa: BLE001 — stamping must never break a run
            _GIT_SHA_CACHE = "unknown"
    return _GIT_SHA_CACHE


class EventLog:
    """Thread-safe JSONL event writer with a fixed run envelope.

    One run per file: ``path`` is truncated at open (the schema demands a
    single run_id per stream), and a failing sink write disables the sink
    rather than raising — emit() can only raise on contract violations
    (unknown level, envelope shadowing), never on I/O.

    With neither ``path`` nor ``stream`` the log is a sink-less recorder:
    records are still built (and kept in a small in-memory tail for tests
    and post-mortems) but nothing touches disk — the default for library
    use so :class:`~nm03_capstone_project_tpu_torch.obs.run.RunContext` can be
    unconditional in the drivers.
    """

    def __init__(
        self,
        path=None,
        stream=None,
        run_id: Optional[str] = None,
        git_sha: Optional[str] = None,
        tail: int = 256,
    ):
        if path is not None and stream is not None:
            raise ValueError("pass path or stream, not both")
        self.run_id = run_id or new_run_id()
        self.git_sha = git_sha if git_sha is not None else _default_git_sha()
        # RLock: a signal handler may close() this log on the main
        # thread mid-emit (same-thread re-acquisition must not deadlock)
        self._lock = threading.RLock()
        self._seq = 0
        self._owns_fh = False
        self._fh = stream
        if path is not None:
            path = str(path)
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
            # truncate, don't append: the schema (and check_telemetry.py)
            # demand ONE run per stream — one run_id, seq from 0,
            # run_started first / run_finished last. Appending a second run
            # would make the validator reject two individually valid runs.
            # a long-lived line-buffered streaming sink, not an artifact write:
            # one run per file (truncate at open); readers tolerate a torn tail
            self._fh = open(path, "w", buffering=1)
            self._owns_fh = True
        self.tail = deque(maxlen=tail)

    @property
    def enabled(self) -> bool:
        return self._fh is not None

    def emit(self, event: str, level: str = "INFO", **fields) -> dict:
        """Write one record; returns it (also kept in the in-memory tail)."""
        if level not in LEVELS:
            raise ValueError(f"unknown level {level!r} (want one of {LEVELS})")
        clash = [k for k in fields if k in RESERVED_KEYS]
        if clash:
            raise ValueError(f"fields shadow the run envelope: {clash}")
        with self._lock:
            record = {
                "schema": SCHEMA_EVENTS,
                "run_id": self.run_id,
                "git_sha": self.git_sha,
                "seq": self._seq,
                "ts_unix": round(time.time(), 6),
                "mono_s": round(time.monotonic(), 6),
                "level": level,
                "event": str(event),
            }
            record.update(fields)
            self._seq += 1
            self.tail.append(record)
            if self._fh is not None:
                # default=str: an un-JSON-able field value must degrade to
                # its repr, never kill the run or tear the line
                line = json.dumps(record, default=str) + "\n"
                try:
                    self._fh.write(line)
                except Exception as e:  # noqa: BLE001 — ENOSPC/EPIPE/closed fd
                    # telemetry must never cost the run its results: degrade
                    # to sink-less mode (in-memory tail keeps recording) and
                    # say so once on stderr — the write will not come back
                    self._fh = None
                    import sys

                    print(
                        f"warning: event log write failed; telemetry sink "
                        f"disabled: {e}",
                        file=sys.stderr,
                    )
        return record

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                with contextlib.suppress(Exception):
                    self._fh.flush()
                if self._owns_fh:
                    with contextlib.suppress(Exception):
                        self._fh.close()
                self._fh = None


class LogBridge(logging.Handler):
    """Mirror WARNING+ package-logger records into the event stream."""

    def __init__(self, events: EventLog, level=logging.WARNING):
        super().__init__(level=level)
        self.events = events

    def emit(self, record: logging.LogRecord) -> None:
        with contextlib.suppress(Exception):  # logging must never raise
            self.events.emit(
                "log",
                level=record.levelname if record.levelname in LEVELS else "WARNING",
                logger=record.name,
                message=record.getMessage(),
            )


class Heartbeat:
    """Daemon thread emitting a periodic ``heartbeat`` event.

    The payload carries uptime and the registry's live counter totals
    (slices done/failed so far, patients completed, ...), making progress
    visible mid-run from the event stream alone.
    """

    def __init__(self, events: EventLog, interval_s: float, registry=None):
        if interval_s <= 0:
            raise ValueError("heartbeat interval must be positive")
        self.events = events
        self.interval_s = float(interval_s)
        self.registry = registry
        self._t0 = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="nm03-obs-heartbeat", daemon=True
        )

    def start(self) -> "Heartbeat":
        self._thread.start()
        return self

    def _run(self) -> None:
        n = 0
        while not self._stop.wait(self.interval_s):
            n += 1
            fields = {"uptime_s": round(time.monotonic() - self._t0, 3), "beat": n}
            if self.registry is not None:
                fields["counters"] = self.registry.counter_totals()
            with contextlib.suppress(Exception):  # never kill the run
                self.events.emit("heartbeat", **fields)

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
