"""Runtime lockdep for the port: the instrumented-lock witness twin of NM421/NM422.

The port's copy of the JAX package's ``utils/lockdep.py``, with the same
logic. The static analysis
(:mod:`nm03_capstone_project_tpu_torch.analysis.lockorder`) proves a
*may-hold* graph from source; this module observes the *actual* one.
:func:`install` patches ``threading.Lock``/``threading.RLock`` so that every
lock **created by the port's code after the patch** is wrapped: each
acquire records the acquiring thread's currently-held set and adds
``held -> acquired`` edges to an observed acquisition-order graph, detects
inversions live (an edge whose reverse was already observed — the runtime
face of an NM421 cycle, caught on the FIRST inverted pair, not the eventual
deadlock), and flags holds that exceed an optional budget. The result dumps
as ``lockdep_witness.json`` (tmp+rename, NM351), which the port's gate
(``python -m nm03_capstone_project_tpu_torch.analysis.gate
--lockdep-witness``) checks: zero inversions, zero observed cycles, and
every observed edge explained by the static graph.

Opt-in and zero-overhead when off: nothing here runs unless
:func:`install` is called (the port's server calls :func:`install_from_env`,
gated on ``NM03_LOCKDEP=1``, before any serving object exists). Without the
variable the factories are untouched and no wrapper exists.

Scope rules (why "created by the port's code"):

* the instrumented creation sites are frames under the port package's
  directory, matched with the path separator (the JAX package's directory,
  a prefix of the port's name, is another tree);
* stdlib internals (``queue``, ``concurrent.futures``, ``threading.Event``,
  ``Thread``'s started-flag) create locks from stdlib frames — they pass
  through uninstrumented, and so do the locks torch, its profiler, gloo and
  NCCL create (their frames are not the port's); a C extension creating a
  lock under a package frame is filtered by requiring the creating source
  line to spell ``Lock``/``RLock``/``Condition``;
* a lock's identity is its **creation site** ``path:line`` — exactly the
  registry key the static graph uses, so the witness maps 1:1 onto
  :class:`~nm03_capstone_project_tpu_torch.analysis.lockorder.LockGraph.by_site`;
* tests may pass ``extra_prefixes`` to also instrument fixture locks
  (the ABBA inversion battery creates its pair inside tests/).
"""

from __future__ import annotations

import json
import linecache
import os
import re
import sys
import threading
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = [
    "install",
    "install_from_env",
    "uninstall",
    "active",
    "state",
    "dump_witness",
    "LockdepState",
]

_ENV_FLAG = "NM03_LOCKDEP"
_ENV_BUDGET = "NM03_LOCKDEP_BUDGET_MS"
_ENV_WITNESS = "NM03_LOCKDEP_WITNESS"

_STATE: Optional["LockdepState"] = None
_ORIG: Optional[Tuple[type, type]] = None

_STACK_LIMIT = 16
_STACK_KEEP = 8
_OVER_BUDGET_CAP = 200


def _short_stack() -> List[str]:
    """Compact formatted stack, trimmed of lockdep/threading noise."""
    here = __file__
    tmod = getattr(threading, "__file__", "")
    out = []
    for fr in traceback.extract_stack(limit=_STACK_LIMIT):
        if fr.filename == here or fr.filename == tmod:
            continue
        out.append(f"{fr.filename}:{fr.lineno} in {fr.name}")
    return out[-_STACK_KEEP:]


class _Site:
    __slots__ = ("id", "path", "line", "kind", "acquires")

    def __init__(self, sid: str, path: str, line: int, kind: str):
        self.id = sid
        self.path = path
        self.line = line
        self.kind = kind
        self.acquires = 0


class LockdepState:
    """One installed lockdep session: sites, edges, inversions, budgets."""

    def __init__(
        self,
        orig_lock,
        budget_s: Optional[float],
        prefixes: Tuple[str, ...],
        repo_root: Path,
    ):
        # a REAL (uninstrumented) lock guards the graph structures
        self._glock = orig_lock()
        self._tls = threading.local()
        self.budget_s = budget_s
        self.prefixes = prefixes
        self.repo_root = repo_root
        self.sites: Dict[Tuple[str, int], _Site] = {}
        self.edges: Dict[Tuple[str, str], Dict] = {}
        self.inversions: List[Dict] = []
        self.over_budget: List[Dict] = []

    # -- identity --------------------------------------------------------

    def site_for(self, path: str, line: int, kind: str) -> _Site:
        with self._glock:
            site = self.sites.get((path, line))
            if site is None:
                site = _Site(f"{path}:{line}", path, line, kind)
                self.sites[(path, line)] = site
            return site

    # -- per-thread held stack -------------------------------------------

    def _held(self) -> List[Tuple[object, _Site, float, bool]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = []
            self._tls.held = held
        return held

    # -- events ----------------------------------------------------------

    def note_acquire(self, lock: "_InstrumentedLock") -> None:
        held = self._held()
        reentrant = lock._is_rlock and any(e[0] is lock for e in held)
        if not reentrant:
            with self._glock:
                lock._site.acquires += 1
                for hlock, hsite, _t0, _re in held:
                    if hlock is lock:
                        continue
                    self._edge_locked(hsite, lock._site)
        held.append((lock, lock._site, time.monotonic(), reentrant))

    def note_release(self, lock: "_InstrumentedLock") -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                _l, site, t0, reentrant = held.pop(i)
                if not reentrant and self.budget_s:
                    dur = time.monotonic() - t0
                    if dur > self.budget_s:
                        with self._glock:
                            if len(self.over_budget) < _OVER_BUDGET_CAP:
                                self.over_budget.append(
                                    {
                                        "site": site.id,
                                        "held_s": round(dur, 6),
                                        "budget_s": self.budget_s,
                                        "stack": _short_stack(),
                                    }
                                )
                return
        # acquired before install() or handed across threads: nothing to pop

    def _edge_locked(self, src: _Site, dst: _Site) -> None:
        key = (src.id, dst.id)
        rec = self.edges.get(key)
        if rec is None:
            rec = {"count": 0, "stack": _short_stack()}
            self.edges[key] = rec
            rev = self.edges.get((dst.id, src.id))
            if rev is not None and src.id != dst.id:
                # the runtime NM421: both orders of the same pair observed.
                # Name BOTH stacks — the fix needs the two call paths, and
                # by the time the deadlock fires neither is on a stack.
                self.inversions.append(
                    {
                        "first": src.id,
                        "second": dst.id,
                        "stack": _short_stack(),
                        "prior_stack": list(rev["stack"]),
                    }
                )
        rec["count"] += 1

    # -- artifact --------------------------------------------------------

    def snapshot(self) -> Dict:
        with self._glock:
            return {
                "version": 1,
                "budget_s": self.budget_s,
                "sites": [
                    {
                        "id": s.id,
                        "path": s.path,
                        "line": s.line,
                        "kind": s.kind,
                        "acquires": s.acquires,
                    }
                    for s in sorted(self.sites.values(), key=lambda s: s.id)
                ],
                "edges": [
                    {
                        "src": a,
                        "dst": b,
                        "count": rec["count"],
                        "stack": list(rec["stack"]),
                    }
                    for (a, b), rec in sorted(self.edges.items())
                ],
                "inversions": [dict(i) for i in self.inversions],
                "over_budget": [dict(o) for o in self.over_budget],
            }


class _InstrumentedLock:
    """Drop-in ``threading.Lock`` wrapper that reports to the state.

    Deliberately does NOT expose ``_release_save``/``_acquire_restore``:
    ``threading.Condition`` then falls back to plain ``release()``/
    ``acquire()``, which keeps condition waits flowing through the tracked
    path (the wait's re-acquire is a real acquisition).
    """

    _is_rlock = False
    __slots__ = ("_inner", "_site", "_state")

    def __init__(self, inner, site: _Site, state: LockdepState):
        self._inner = inner
        self._site = site
        self._state = state

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._state.note_acquire(self)
        return ok

    def release(self) -> None:
        self._state.note_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<lockdep {self._site.id} wrapping {self._inner!r}>"


class _InstrumentedRLock(_InstrumentedLock):
    _is_rlock = True
    __slots__ = ()

    def locked(self) -> bool:  # RLocks grew .locked() only in 3.12
        locked_fn = getattr(self._inner, "locked", None)
        if locked_fn is not None:
            return locked_fn()
        # acquire-probe fallback; an owner-thread probe would reentrantly
        # succeed, so check ownership first
        if getattr(self._inner, "_is_owned", lambda: False)():
            return True
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


def _make_factory(state: LockdepState, orig, rlock: bool):
    kind = "RLock" if rlock else "Lock"
    wrapper = _InstrumentedRLock if rlock else _InstrumentedLock
    tfile = getattr(threading, "__file__", "")
    # the creating line must spell the factory: C extensions (numpy's
    # BitGenerator) call threading.Lock with the PACKAGE caller's frame on
    # top, and instrumenting a foreign internal lock — misattributed to
    # whatever package line invoked the extension — poisons the witness
    factory_re = re.compile(r"\b(?:Lock|RLock|Condition)\b")

    def factory():
        inner = orig()
        f = sys._getframe(1)
        while f is not None and f.f_code.co_filename == __file__:
            f = f.f_back
        if f is None:
            return inner
        filename = f.f_code.co_filename
        if filename == tfile:
            # threading-internal creation (Event/Thread/Condition() build
            # their own locks): stdlib-owned, not a package site
            return inner
        if not any(filename.startswith(p) for p in state.prefixes):
            return inner  # stdlib / third-party / pre-existing code paths
        if not factory_re.search(linecache.getline(filename, f.f_lineno)):
            return inner  # C-extension creation under a package frame
        try:
            rel = Path(filename).resolve().relative_to(state.repo_root)
            path = rel.as_posix()
        except ValueError:
            path = filename
        site = state.site_for(path, f.f_lineno, kind)
        return wrapper(inner, site, state)

    factory.__name__ = f"lockdep_{kind}"
    return factory


# -- lifecycle ----------------------------------------------------------------


def active() -> bool:
    return _STATE is not None


def state() -> Optional[LockdepState]:
    return _STATE


def install(
    budget_s: Optional[float] = None,
    extra_prefixes: Tuple[str, ...] = (),
) -> LockdepState:
    """Patch the lock factories; idempotent (returns the live state).

    Only locks created AFTER install are instrumented — construct the
    serving app inside the lockdep window. ``extra_prefixes`` widens the
    instrumented creation-site set beyond the package (test fixtures).
    """
    global _STATE, _ORIG
    if _STATE is not None:
        return _STATE
    pkg_root = Path(__file__).resolve().parents[1]
    repo_root = pkg_root.parent
    prefixes = (str(pkg_root) + os.sep,) + tuple(
        str(Path(p).resolve()) + os.sep for p in extra_prefixes
    )
    orig = (threading.Lock, threading.RLock)
    st = LockdepState(orig[0], budget_s, prefixes, repo_root)
    threading.Lock = _make_factory(st, orig[0], rlock=False)
    threading.RLock = _make_factory(st, orig[1], rlock=True)
    _ORIG = orig
    _STATE = st
    return st


def uninstall() -> Optional[LockdepState]:
    """Restore the original factories; returns the finished state.

    Wrappers already handed out keep working (their inner lock is real);
    they just stop gaining siblings. Drain threads releasing after
    uninstall still balance their held stacks through the same state.
    """
    global _STATE, _ORIG
    if _STATE is None:
        return None
    assert _ORIG is not None
    threading.Lock, threading.RLock = _ORIG
    st = _STATE
    _STATE = None
    _ORIG = None
    return st


def install_from_env() -> Optional[LockdepState]:
    """Env-gated install: the server's and ``--sanitize``'s entry point.

    ``NM03_LOCKDEP=1`` turns it on; ``NM03_LOCKDEP_BUDGET_MS`` sets the
    informational hold budget; ``NM03_LOCKDEP_WITNESS=<path>`` dumps the
    witness at interpreter exit (the serving drill's artifact).
    """
    if os.environ.get(_ENV_FLAG, "").lower() not in ("1", "true", "on", "yes"):
        return None
    budget_ms = os.environ.get(_ENV_BUDGET, "").strip()
    budget_s = float(budget_ms) / 1e3 if budget_ms else None
    st = install(budget_s=budget_s)
    witness = os.environ.get(_ENV_WITNESS, "").strip()
    if witness and not getattr(st, "_atexit_hooked", False):
        import atexit

        atexit.register(dump_witness, witness, st)
        st._atexit_hooked = True  # type: ignore[attr-defined]
    return st


def dump_witness(path: str | os.PathLike, st: Optional[LockdepState] = None) -> Path:
    """Write the witness JSON atomically (tmp+rename — NM351)."""
    st = st or _STATE
    if st is None:
        raise RuntimeError("lockdep is not installed and no state was given")
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(out.name + ".tmp")
    tmp.write_text(json.dumps(st.snapshot(), indent=1, sort_keys=True) + "\n")
    os.replace(tmp, out)
    return out
