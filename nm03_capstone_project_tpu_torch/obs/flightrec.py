"""Crash flight recorder: a bounded in-memory ring, dumped on demand.

The port's copy of the JAX package's ``obs/flightrec.py``. A hung serving
dispatch and a crashed process share one diagnostic problem: by the time
anyone notices, the process either died (nothing on disk) or is wedged
(logs stop exactly at the interesting moment). The flight recorder keeps a
small, always-on, lock-guarded ring of the most recent events and spans
**per thread**, costing one dict build and one deque append per record
while the process is healthy, and dumps it *atomically* (tmp+rename, via
:func:`~nm03_capstone_project_tpu_torch.utils.atomicio.atomic_write_text`)
when something goes wrong:

* **SIGUSR2** — the operator's post-mortem trigger against a live (or
  wedged) process: ``kill -USR2 <pid>`` and the last N records of every
  thread land in ``nm03_flight_<pid>_sigusr2_<n>.json``;
* **a lane quarantine** — the serving executor auto-dumps when a lane's
  dispatch expires its deadline, capturing what every thread was doing;
* **unhandled crash** — ``sys.excepthook`` / ``threading.excepthook``
  chains dump before the traceback prints.

Stdlib only. Recording is process-global (:func:`note`); dumping is inert
until :func:`configure`/:func:`install` names a directory, so library
callers never spray files. Schema ``nm03.flightrec.v1``, as the JAX
package writes it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from collections import OrderedDict, deque
from typing import Optional

SCHEMA_FLIGHT = "nm03.flightrec.v1"

# per-thread ring length and the thread-ring cap: HTTP handler threads are
# transient and unboundedly named, so the ring table is LRU-bounded — a
# post-mortem cares about the threads active at the end, not every
# connection ever served
DEFAULT_RING = 256
MAX_THREADS = 64

ENV_DUMP_DIR = "NM03_FLIGHTREC_DIR"


class _Ring:
    """One thread's bounded record ring, with its own lock.

    The lock is per-ring so the only contention on a thread's hot-path
    append is a concurrent snapshot/dump — never another thread's append.
    RLock, not Lock: a SIGUSR2 dump runs on the main thread and must
    survive interrupting a main-thread ``note()`` that already holds its
    own ring's lock.
    """

    __slots__ = ("lock", "records", "last_mono")

    def __init__(self, maxlen: int):
        self.lock = threading.RLock()
        self.records: deque = deque(maxlen=maxlen)
        self.last_mono = time.monotonic()


class FlightRecorder:
    """Per-thread bounded rings of recent records, dumpable atomically.

    ``note()`` is the hot path and is deliberately tiny: build one dict,
    append to the calling thread's own ring under that ring's (otherwise
    uncontended) lock — the serving path funnels every span boundary of
    every lane and handler thread through here, so a process-wide note
    lock would serialize exactly the threads tracing exists to tell
    apart. The table lock is only taken to register a new thread's ring,
    to evict, and to snapshot. Everything else (dump, handler
    installation) is cold-path.
    """

    def __init__(self, ring: int = DEFAULT_RING, max_threads: int = MAX_THREADS):
        # RLock: a signal handler dumping on the main thread must survive
        # interrupting a main-thread note() mid-registration
        self._lock = threading.RLock()
        self._ring_len = int(ring)
        self._max_threads = int(max_threads)
        self._rings: "OrderedDict[str, _Ring]" = OrderedDict()
        self._tl = threading.local()  # caches this thread's (key, ring)
        self._dump_dir: Optional[str] = None
        self._dump_seq = itertools.count()
        self._installed = False
        self._prev_excepthook = None
        self._prev_threading_hook = None
        self._t0 = time.monotonic()

    # -- recording (the hot path) ------------------------------------------

    def note(self, kind: str, name: str, **fields) -> None:
        """Append one record to the calling thread's ring. Never raises."""
        try:
            rec = {
                "ts_unix": round(time.time(), 6),
                "mono_s": round(time.monotonic(), 6),
                "kind": str(kind),
                "name": str(name),
            }
            for k, v in fields.items():
                if k not in rec:
                    rec[k] = v
            cur = threading.current_thread()
            # name#ident, not name alone: every supervisor worker is named
            # "nm03-dispatch", and one shared ring would let healthy lanes
            # flush the wedged lane's evidence in seconds
            key = f"{cur.name}#{cur.ident}"
            ring = getattr(self._tl, "ring", None)
            # the membership probe is deliberately lock-free (dict reads
            # are atomic): it only decides whether to take the slow
            # registration path, which re-checks under the lock
            if (
                ring is None
                or self._tl.key != key
                or key not in self._rings
            ):
                with self._lock:
                    ring = self._rings.get(key)
                    if ring is None:
                        ring = _Ring(self._ring_len)
                        self._rings[key] = ring
                        while len(self._rings) > self._max_threads:
                            self._evict_one_ring()
                self._tl.key = key
                self._tl.ring = ring
            with ring.lock:
                ring.records.append(rec)
                ring.last_mono = rec["mono_s"]
        except Exception:  # noqa: BLE001 — the recorder must never cost a run
            pass

    def _evict_one_ring(self) -> None:
        """Drop one ring (caller holds the table lock; table is over cap).

        Dead threads' rings go first: a wedged thread stops calling
        ``note()`` and so stops refreshing ``last_mono``, which would make
        plain LRU evict exactly the ring a post-mortem needs ("the thread
        whose ring stops"). Only when every ring belongs to a live thread
        does the least-recently-active one go.
        """
        live = {f"{t.name}#{t.ident}" for t in threading.enumerate()}
        victim = next((k for k in self._rings if k not in live), None)
        if victim is None:
            victim = min(
                self._rings, key=lambda k: self._rings[k].last_mono
            )
        del self._rings[victim]

    # -- snapshot / dump ---------------------------------------------------

    def snapshot(self, reason: str = "snapshot") -> dict:
        with self._lock:
            entries = list(self._rings.items())
        threads = {}
        for k, ring in entries:
            with ring.lock:
                threads[k] = list(ring.records)
        return {
            "schema": SCHEMA_FLIGHT,
            "reason": str(reason),
            "pid": os.getpid(),
            "ts_unix": round(time.time(), 6),
            "mono_s": round(time.monotonic(), 6),
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "threads_live": [t.name for t in threading.enumerate()],
            "records_total": sum(len(v) for v in threads.values()),
            "threads": threads,
        }

    def configure(self, dump_dir: Optional[str]) -> None:
        """Name (or clear, with None) the auto-dump directory."""
        with self._lock:
            self._dump_dir = str(dump_dir) if dump_dir is not None else None

    @property
    def configured(self) -> bool:
        with self._lock:
            return self._dump_dir is not None

    def dump(self, path: Optional[str] = None, reason: str = "manual") -> str:
        """Write the snapshot atomically; returns the dump path.

        With no ``path``, the file lands in the configured dump directory
        (or the cwd) as ``nm03_flight_<pid>_<reason>_<n>.json``. The write
        goes through ``atomic_write_text`` — a dump raced by the crash it
        documents must be complete-or-absent, never torn.
        """
        from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_text

        snap = self.snapshot(reason=reason)
        if path is None:
            safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in reason)
            name = f"nm03_flight_{os.getpid()}_{safe}_{next(self._dump_seq)}.json"
            with self._lock:
                base = self._dump_dir or "."
            path = os.path.join(base, name)
        atomic_write_text(path, json.dumps(snap, default=str, indent=1) + "\n")
        return path

    def auto_dump(self, reason: str) -> Optional[str]:
        """Dump iff a dump directory is configured; swallows every error.

        The hook sites (lane quarantine, excepthooks, the SIGUSR2 handler)
        call this — a failing dump must never make a bad moment
        worse.
        """
        if not self.configured:
            return None
        try:
            path = self.dump(reason=reason)
        except Exception:  # noqa: BLE001 — post-mortem capture is best-effort
            return None
        with contextlib.suppress(Exception):
            sys.stderr.write(f"nm03-flightrec: dumped {reason} -> {path}\n")
            sys.stderr.flush()
        return path

    # -- handler installation (cold path, process-lifetime) ----------------

    def install(
        self,
        dump_dir: Optional[str] = None,
        sigusr2: bool = True,
        excepthook: bool = True,
    ) -> None:
        """Arm the recorder: dump dir + SIGUSR2 handler + crash hooks.

        Idempotent (a second install only refreshes the dump dir). The
        SIGUSR2 handler can only be registered from the main thread;
        elsewhere it is skipped silently (``configure`` + ``auto_dump``
        still work — the in-process tests use exactly that).
        """
        self.configure(
            dump_dir if dump_dir is not None else os.environ.get(ENV_DUMP_DIR, ".")
        )
        with self._lock:
            if self._installed:
                return
            self._installed = True
        if sigusr2:
            with contextlib.suppress(Exception):  # non-main thread / platform
                import signal

                signal.signal(
                    signal.SIGUSR2, lambda s, f: self.auto_dump("sigusr2")
                )
        if excepthook:
            self._prev_excepthook = sys.excepthook

            def hook(exc_type, exc, tb):
                self.note(
                    "crash", exc_type.__name__, message=str(exc)[:500]
                )
                self.auto_dump(f"crash_{exc_type.__name__}")
                (self._prev_excepthook or sys.__excepthook__)(exc_type, exc, tb)

            sys.excepthook = hook
            self._prev_threading_hook = threading.excepthook

            def thread_hook(args):
                if args.exc_type is not SystemExit:
                    self.note(
                        "crash",
                        args.exc_type.__name__,
                        message=str(args.exc_value)[:500],
                        thread=getattr(args.thread, "name", None),
                    )
                    self.auto_dump(f"thread_crash_{args.exc_type.__name__}")
                (self._prev_threading_hook or threading.__excepthook__)(args)

            threading.excepthook = thread_hook


# the process-wide recorder: one ring table per process, like the compile
# hub — a post-mortem wants every thread's tail in ONE file
_RECORDER = FlightRecorder()


def get_recorder() -> FlightRecorder:
    return _RECORDER


def note(kind: str, name: str, **fields) -> None:
    """Record into the process recorder (the tracer's feed)."""
    _RECORDER.note(kind, name, **fields)


def configure(dump_dir: Optional[str]) -> None:
    _RECORDER.configure(dump_dir)


def install(dump_dir: Optional[str] = None, **kwargs) -> None:
    _RECORDER.install(dump_dir=dump_dir, **kwargs)


def auto_dump(reason: str) -> Optional[str]:
    return _RECORDER.auto_dump(reason)


def dump(path: Optional[str] = None, reason: str = "manual") -> str:
    return _RECORDER.dump(path=path, reason=reason)
