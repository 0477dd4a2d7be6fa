"""Rolling-restart orchestration: redeploy a fleet at (N−1)/N capacity.

The port's copy of the JAX package's ``fleet/manager.py``.
:func:`rolling_restart` walks the replica list ONE AT A TIME: SIGTERM the
replica (the server's graceful drain — admissions stop, admitted batches
finish, telemetry flushes), wait for its listener to close, relaunch it
from the command line its own ``/readyz`` identity block published, and
wait for the new process's ``/readyz`` to go 200 before touching the
next replica. The fleet front end's health loop ejects the draining
replica within one poll and probation reinstates the fresh one, so the
routed capacity never drops below (N−1)/N.

With ``compile_cache_dir`` every relaunch carries that kernel-library
cache (:func:`_relaunch_argv` replaces or appends the flag in the
published recipe), so the relaunched replica loads its three libraries,
verified, instead of running ``nvcc``; its CUDA graphs are captured anew
either way (a graph cannot be persisted). The report records, for each
replica, its drain seconds, its warm seconds (process start to
``/readyz`` 200), the capture seconds its graphs report and, as the JAX
report does, its builds and cache hits (``compile_cache_hits``: null for
a replica without a cache).

Same-host by construction: the SIGTERM and the relaunch both happen on
the machine this runs on (the replica block's ``pid``/``cwd`` are local
facts).

A relaunch on a held port. A replica first started with ``--port 0`` got
its port from the kernel's ephemeral range, and once its listener is gone
any ``connect()`` on this host may take that port as its own source port
(the front end's health probes of the dead replica, this walk's own
polls; to a port with nothing listening, a connect can even reach
itself). Such a socket holds the port until it closes, and the relaunched
server's ``bind`` fails with EADDRINUSE. ``nm03-serve`` then exits with
:data:`ADDRESS_IN_USE_EXIT`; the walk watches the relaunched process
(``proc.poll()``) while it waits for ``/readyz``, relaunches after
:data:`RELAUNCH_BACKOFF_S` while the port stays held and the warm deadline
allows, naming the sockets that hold it (:func:`port_holders`), and fails
at once, with the exit code, when the process exits for any other reason.

Free of torch and numpy at import.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import time
import urllib.error
import urllib.request
from typing import List, Optional, Sequence
from urllib.parse import urlsplit

from nm03_capstone_project_tpu_torch.fleet.replicas import (
    normalize_target,
    target_label,
)
from nm03_capstone_project_tpu_torch.utils.exitcodes import ADDRESS_IN_USE_EXIT
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("fleet")

SCHEMA_RESTART = "nm03.fleetrestart.v1"
RELAUNCH_BACKOFF_S = 0.5  # between relaunches on a held port

_TCP_STATES = {"01": "ESTABLISHED", "02": "SYN_SENT", "03": "SYN_RECV", "04": "FIN_WAIT1",
               "05": "FIN_WAIT2", "06": "TIME_WAIT", "07": "CLOSE", "08": "CLOSE_WAIT",
               "09": "LAST_ACK", "0A": "LISTEN", "0B": "CLOSING"}


class RestartError(RuntimeError):
    """One replica failed a restart step; the rolling walk stops there
    (continuing would risk a second replica down at the same time)."""


class _Exited(Exception):
    """The relaunched process exited before its ``/readyz`` went 200."""

    def __init__(self, rc: int):
        super().__init__(rc)
        self.rc = rc


def port_holders(port: int) -> List[str]:
    """The TCP sockets of this host whose local port is ``port``, from
    ``/proc/net/tcp`` and ``tcp6`` ("local :P -> remote :Q STATE"); empty
    where those files are missing."""
    out = []
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        try:
            with open(table) as f:
                rows = f.read().splitlines()[1:]
        except OSError:
            continue
        for row in rows:
            cols = row.split()
            if len(cols) < 4 or int(cols[1].rsplit(":", 1)[1], 16) != port:
                continue
            remote = int(cols[2].rsplit(":", 1)[1], 16)
            out.append(f"local :{port} -> remote :{remote} {_TCP_STATES.get(cols[3], cols[3])}")
    return out


def _get_json(url: str, timeout_s: float = 5.0):
    """(status, parsed body) for a GET; raises on transport failure."""
    req = urllib.request.Request(url, method="GET")
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return resp.status, json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:  # 503 still carries the payload
        try:
            return e.code, json.loads(e.read() or b"{}")
        except json.JSONDecodeError:
            return e.code, {}


def _wait_listener_closed(target: str, timeout_s: float, poll_s: float) -> float:
    """Block until ``target`` refuses connections; returns the wait.

    ``nm03-serve`` closes its listener only after the graceful drain
    completes (admitted batches finished, metrics flushed), so
    connection-refused IS the drain-done signal — no pid polling, which
    would hang on an unreaped zombie.
    """
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    while time.monotonic() < deadline:
        try:
            req = urllib.request.Request(f"{target}/healthz", method="GET")
            with urllib.request.urlopen(req, timeout=2.0) as resp:
                resp.read()
        except urllib.error.HTTPError:
            pass  # still answering HTTP — still draining
        except Exception as e:  # noqa: BLE001 — classified below
            # a TIMEOUT means the listener is still up but slow (a loaded
            # host finishing admitted batches) — keep waiting; relaunching
            # now would EADDRINUSE-crash the replacement while the old
            # process still holds the port. Only refused/reset means the
            # listener really closed.
            if "timed out" not in str(e).lower():
                return time.monotonic() - t0
        time.sleep(poll_s)
    raise RestartError(
        f"{target_label(target)} still listening after {timeout_s:.0f}s "
        "drain wait"
    )


def _wait_ready(
    target: str, timeout_s: float, poll_s: float, old_pid: Optional[int], proc=None
) -> dict:
    """Block until ``/readyz`` answers 200 from a NEW pid; returns it.
    Raises :class:`_Exited` as soon as ``proc`` (the relaunched process,
    when it can be polled) has exited."""
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    last = "no response yet"
    poll = getattr(proc, "poll", None)
    while time.monotonic() < deadline:
        rc = poll() if poll is not None else None
        if rc is not None:
            raise _Exited(rc)
        try:
            status, st = _get_json(f"{target}/readyz", timeout_s=5.0)
        except Exception as e:  # noqa: BLE001 — not up yet
            last = str(e)
            time.sleep(poll_s)
            continue
        pid = (st.get("replica") or {}).get("pid")
        if status == 200 and (old_pid is None or pid != old_pid):
            st["_warm_wait_s"] = round(time.monotonic() - t0, 3)
            return st
        last = f"status {status}, pid {pid}"
        time.sleep(poll_s)
    raise RestartError(
        f"{target_label(target)} not ready after {timeout_s:.0f}s ({last})"
    )


def _wait_fleet_sees(
    fleet_url: str, target: str, timeout_s: float, poll_s: float
) -> None:
    """Block until the fleet front-end reports ``target`` HEALTHY again.

    Without this, the orchestrator would move to the next replica while
    the front-end's probation canary is still pending — two replicas out
    of rotation at once, which is exactly the (N−1)/N floor this module
    promises to hold.
    """
    label = target_label(target)
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            _, st = _get_json(f"{fleet_url}/readyz", timeout_s=5.0)
            per = (st.get("replicas") or {}).get("per_replica") or []
            if any(
                r.get("replica") == label and r.get("state") == "healthy"
                for r in per
            ):
                return
        except Exception:  # noqa: BLE001 — keep waiting
            pass
        time.sleep(poll_s)
    raise RestartError(
        f"fleet at {fleet_url} never reinstated {label} inside {timeout_s:.0f}s"
    )


def _relaunch_argv(argv: Sequence[str], compile_cache_dir: Optional[str]):
    """The replica's published relaunch argv, with the cache dir ensured."""
    out: List[str] = list(argv)
    if compile_cache_dir:
        if "--compile-cache-dir" in out:
            i = out.index("--compile-cache-dir")
            if i + 1 < len(out):
                out[i + 1] = compile_cache_dir
        else:
            out += ["--compile-cache-dir", compile_cache_dir]
    return out


def _relaunch(target, label, launch, cwd, env, spawn, entry, warm_timeout_s, poll_s,
              old_pid, say) -> dict:
    """Spawn the relaunch and wait for its ``/readyz`` 200; spawn it again
    while it exits on a held port (:data:`ADDRESS_IN_USE_EXIT`) and the
    warm deadline allows. Any other exit fails at once."""
    deadline = time.monotonic() + warm_timeout_s
    port = urlsplit(target).port
    entry["relaunch_attempts"] = 0
    held_error = None  # the last relaunch's bind error, while one exits on it
    while True:
        proc = spawn(
            launch,
            cwd=cwd or None,
            env=env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            start_new_session=True,
        )
        entry["relaunch_attempts"] += 1
        entry["spawned_pid"] = getattr(proc, "pid", None)
        try:
            return _wait_ready(target, max(0.0, deadline - time.monotonic()), poll_s, old_pid,
                               proc=proc)
        except RestartError as e:  # the warm deadline, while a relaunch still starts
            if held_error is None:
                raise
            raise RestartError(f"{e}; {held_error}") from None
        except _Exited as e:
            held = port_holders(port) if port else []
            if e.rc != ADDRESS_IN_USE_EXIT:
                raise RestartError(
                    f"{label}: the relaunched process (pid {entry['spawned_pid']}) exited "
                    f"with code {e.rc} before /readyz went 200") from None
            held_error = (f"the relaunched process exited with code {e.rc}: port {port} in "
                          f"use (EADDRINUSE), held by {held or 'a socket gone by now'}")
            if time.monotonic() + RELAUNCH_BACKOFF_S >= deadline:
                raise RestartError(
                    f"{label}: {held_error}, for {warm_timeout_s:.0f}s") from None
            say(f"fleet restart: {label} {held_error}; relaunching in {RELAUNCH_BACKOFF_S}s")
            time.sleep(RELAUNCH_BACKOFF_S)


def rolling_restart(
    targets: Sequence[str],
    compile_cache_dir: Optional[str] = None,
    drain_timeout_s: float = 120.0,
    warm_timeout_s: float = 600.0,
    poll_s: float = 0.25,
    fleet_url: Optional[str] = None,
    spawn=subprocess.Popen,
    env: Optional[dict] = None,
    emit=None,
) -> dict:
    """Restart every replica in ``targets``, one at a time; the report.

    Per replica: read the ``/readyz`` identity block (pid + the
    ``relaunch_argv``/``cwd`` the server published for exactly this
    purpose), SIGTERM, wait for the listener to close (= drain done),
    relaunch, and wait for the NEW pid's ``/readyz`` 200. With ``fleet_url``, also
    wait for the front-end to reinstate the replica before moving on, so
    at most one replica is ever out of rotation.

    ``spawn`` is injectable (tests capture the relaunched processes);
    the default detaches into a new session with /dev/null stdio — the
    replicas must outlive this orchestrator. A step failure raises
    :class:`RestartError` after recording the partial report on the
    exception (``.report``); the walk never continues past a replica it
    could not bring back.
    """
    say = emit if emit is not None else (lambda msg: log.warning("%s", msg))
    urls = [normalize_target(t) for t in targets]
    entries: List[dict] = []
    report = {"schema": SCHEMA_RESTART, "ok": False, "replicas": entries}
    for target in urls:
        label = target_label(target)
        entry: dict = {"replica": label, "target": target}
        entries.append(entry)
        try:
            _, st = _get_json(f"{target}/readyz", timeout_s=10.0)
        except Exception as e:  # noqa: BLE001
            err = RestartError(f"{label}: /readyz unreachable before restart: {e}")
            err.report = report
            raise err from e
        rep = st.get("replica") or {}
        old_pid, argv, cwd = rep.get("pid"), rep.get("relaunch_argv"), rep.get("cwd")
        if not old_pid or not argv:
            err = RestartError(
                f"{label}: /readyz carries no replica identity block "
                "(pid/relaunch_argv) — was this server started from its command line?"
            )
            err.report = report
            raise err
        entry["old_pid"] = old_pid
        entry["old_id"] = rep.get("id")
        say(f"fleet restart: draining {label} (pid {old_pid}, id {rep.get('id')})")
        try:
            os.kill(int(old_pid), signal.SIGTERM)
        except ProcessLookupError:
            say(f"fleet restart: {label} pid {old_pid} already gone")
        except OSError as e:
            err = RestartError(f"{label}: SIGTERM pid {old_pid} failed: {e}")
            err.report = report
            raise err from e
        try:
            entry["drain_s"] = round(
                _wait_listener_closed(target, drain_timeout_s, poll_s), 3
            )
            say(f"fleet restart: {label} drained in {entry['drain_s']}s; relaunching")
            launch = _relaunch_argv(argv, compile_cache_dir)
            entry["argv"] = launch
            # beside the new replica's replica.start_unix: how much of
            # warm_s passed before its app existed (interpreter, imports)
            entry["spawned_unix"] = round(time.time(), 3)
            ready = _relaunch(target, label, launch, cwd, env, spawn, entry,
                              warm_timeout_s, poll_s, old_pid, say)
        except RestartError as e:
            entry["error"] = str(e)
            e.report = report
            raise
        except Exception as e:  # noqa: BLE001 — relaunch itself failed
            entry["error"] = str(e)
            err = RestartError(f"{label}: relaunch failed: {e}")
            err.report = report
            raise err from e
        new_rep = ready.get("replica") or {}
        hub = ready.get("compile_hub") or {}
        entry["new_pid"] = new_rep.get("pid")
        entry["new_id"] = new_rep.get("id")
        entry["warm_s"] = ready.get("_warm_wait_s")
        # the warmup's CUDA graph capture, as the new replica reports it
        # (null on a CPU replica, which captures no graphs)
        graphs = (ready.get("cuda_graphs") or {}).get("lanes") or {}
        entry["capture_s"] = (
            round(sum(g.get("capture_s") or 0.0 for lane in graphs.values()
                      for g in lane.values()), 3)
            if graphs else None
        )
        # the cache-hit proof: a warm relaunch loads every library, so
        # builds stays 0 and the hits equal the library count
        entry["builds"] = hub.get("builds")
        entry["cache_hits"] = hub.get("cache_hits")
        entry["cache_misses"] = hub.get("cache_misses")
        entry["compile_cache_hits"] = new_rep.get("compile_cache_hits")
        say(
            f"fleet restart: {label} ready in {entry['warm_s']}s "
            f"(pid {entry['new_pid']}, graph capture {entry['capture_s']}s, "
            f"builds={entry['builds']}, cache_hits={entry['cache_hits']})"
        )
        if fleet_url:
            try:
                _wait_fleet_sees(fleet_url, target, warm_timeout_s, poll_s)
            except RestartError as e:
                entry["error"] = str(e)
                e.report = report
                raise
            say(f"fleet restart: front-end reinstated {label}")
        entry["ok"] = True
    report["ok"] = True
    return report
