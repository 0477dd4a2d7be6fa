"""Seedable, deterministic fault injection for the drivers and the server.

The port's copy of the JAX package's ``resilience/faultinject.py``: the
same plan format, sites, kinds, selectors and fire rules, so one plan file
parses in both packages and fires on the same checks. A :class:`FaultPlan`
makes each containment claim a chaos test: a JSON plan names the site, the
kind of fault, and the exact slice, patient, batch or lane it hits, and the
drivers and the server consult the plan at their injection points. Zero
overhead when off: the callers hold ``None`` and never call in.

Activation (either):

* ``--fault-plan SPEC`` on the batch drivers and the server, or
* ``NM03_FAULT_PLAN=SPEC`` in the environment (the batch drivers).

``SPEC`` is inline JSON (starts with ``{``) or a path to a JSON file::

    {"seed": 7, "faults": [
      {"site": "decode",   "kind": "error",    "stem": "1-02"},
      {"site": "decode",   "kind": "corrupt",  "stem": "1-03"},
      {"site": "dispatch", "kind": "hang",     "index": 0, "hang_s": 120},
      {"site": "dispatch", "kind": "transient","count": 2},
      {"site": "export",   "kind": "io_error", "stem": "1-04"},
      {"site": "export",   "kind": "sigterm",  "after": 4}
    ]}

Selectors (``patient``, ``stem``, ``index``, ``lane``) restrict where a rule
fires; ``after`` skips the first N-1 matching checks (1-based ordinal),
``count`` caps total fires (default unlimited), and ``rate`` fires
probabilistically, with the draw derived from (plan seed, rule, site,
selector values) through ``random.Random`` seeded with that string (a
SHA-512 digest of it, not Python's per-process salted ``hash``), so the
same plan against the same cohort injects the same faults in both packages,
whatever the thread scheduling.

Kinds by site (:data:`KINDS_BY_SITE`, as the JAX package has them):

* ``decode``:   ``error`` (fail before decode), ``corrupt`` (feed the real
  parser deterministically corrupted file bytes);
* ``dispatch``: ``transient`` (a retryable :class:`InjectedTransientError`),
  ``hang`` (block ``hang_s`` seconds before the launch, the wedge the
  dispatch deadline exists for);
* ``export``:   ``io_error`` (raise before the JPEG pair writes),
  ``sigterm`` (deliver SIGTERM to this process: the crash-safe resume
  drill);
* ``cache``:    ``io_error`` (abort the publish of a compile-cache entry
  between the write of its tmp file and its rename: the process serves
  from its own build, the next start misses and rebuilds, the tmp file is
  left for ``gc``; ``stem`` selects the entry filename), ``corrupt_entry``
  (the result tier's verify-on-read sees one flipped byte: ``stem``
  selects the result-key digest);
* ``ingest``:   ``decode_error`` (fail one work item on the ingest decode
  pool), ``stall`` (wedge the stager ``hang_s`` seconds);
* ``fleet``:    ``replica_unreachable`` (the router's health poll sees
  the replica refuse), ``proxy_io_error`` (a forwarded request fails on
  the socket, and the router fails it over): both fired by the fleet
  router (:mod:`..fleet.router`);
* ``volume``:   ``dispatch_error`` (fail one volume-gang dispatch; with a
  ``lane`` selector the gang blames that lane, quarantines it and re-runs
  the study on the next healthy lane; without one it sheds).

Injected faults are observable: every fire increments
``resilience_faults_injected_total{site,kind}`` and emits a
``fault_injected`` event when the caller passes its RunContext.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

from nm03_capstone_project_tpu_torch.resilience.policy import TransientDeviceError

ENV_VAR = "NM03_FAULT_PLAN"

SITES = ("decode", "dispatch", "export", "cache", "ingest", "fleet", "volume")
KINDS_BY_SITE = {
    "decode": ("error", "corrupt"),
    "dispatch": ("transient", "hang"),
    "export": ("io_error", "sigterm"),
    # one site for both cache tiers, told apart by fire()'s `kinds`
    # filter. io_error is the compile cache's store path
    # (compilehub/persist.py): it aborts an entry's publish, so a failed
    # persist costs a rebuild on the next start, never a torn entry
    # (`stem` selects the entry filename). corrupt_entry is the result
    # tier's read path (cache/store.py verify-on-read): the lookup sees one
    # flipped byte, the digest check evicts the entry and reports a miss,
    # so a corrupt entry costs one recompute, never a wrong mask (`stem`
    # selects the result-key digest)
    "cache": ("io_error", "corrupt_entry"),
    # the ingest pipeline: `decode_error` fails one work item on the
    # decode pool (an IngestFailure record the driver counts); `stall`
    # wedges the stager for hang_s (decode blocks on the full ring, the
    # run completes late, never wrong). `index` selects the work item:
    # the batch index in the parallel driver, the slice index in the
    # sequential one
    "ingest": ("decode_error", "stall"),
    # the replica fleet's front end (fleet/router.py fires both):
    # `replica_unreachable` and `proxy_io_error`
    "fleet": ("replica_unreachable", "proxy_io_error"),
    # the volume gang (serving/volumes.py): `dispatch_error` fails one
    # study's dispatch as a retryable device error. With a `lane`
    # selector the gang blames that lane, quarantines it and re-runs the
    # study on the next healthy lane; without one the failure is
    # unattributable and the gang sheds with Retry-After. `index`
    # selects the volume-request ordinal
    "volume": ("dispatch_error",),
}

# kinds of KINDS_BY_SITE whose target the port does not have: a plan holding
# one is refused when it is parsed, rather than accepted and never fired.
# None is left
NOT_PORTED_KINDS: dict = {}


class InjectedDecodeError(RuntimeError):
    """An injected per-slice decode failure (contained like a real one)."""


class InjectedExportError(OSError):
    """An injected export I/O failure (contained like a real one)."""


class InjectedTransientError(TransientDeviceError):
    """An injected retryable device error."""


class FaultAbandoned(RuntimeError):
    """Raised inside an abandoned (deadline-expired) hang so the orphaned
    worker thread dies instead of proceeding to the real dispatch."""


@dataclass
class FaultRule:
    site: str
    kind: str
    patient: Optional[str] = None
    stem: Optional[str] = None
    index: Optional[int] = None
    # replica-lane selector (dispatch site, serving fleet): a chaos drill
    # can deterministically wedge ONE chosen lane of a multi-card replica
    # ({"site": "dispatch", "kind": "hang", "lane": 2}); checks that carry
    # no lane (the batch drivers) never match a lane-selected rule
    lane: Optional[int] = None
    after: Optional[int] = None  # fire from the Nth matching check (1-based)
    count: Optional[int] = None  # max fires; None = unlimited
    rate: Optional[float] = None  # per-check probability (seeded draw)
    hang_s: float = 60.0
    # mutable bookkeeping (guarded by the plan's lock)
    _seen: int = field(default=0, repr=False)
    _fired: int = field(default=0, repr=False)

    def validate(self) -> "FaultRule":
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} (want {SITES})")
        if self.kind not in KINDS_BY_SITE[self.site]:
            raise ValueError(
                f"kind {self.kind!r} invalid for site {self.site!r} "
                f"(want one of {KINDS_BY_SITE[self.site]})"
            )
        if (self.site, self.kind) in NOT_PORTED_KINDS:
            raise ValueError(
                f"fault {self.site}/{self.kind}: {NOT_PORTED_KINDS[(self.site, self.kind)]}"
            )
        if self.rate is not None and not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.hang_s < 0:
            raise ValueError(f"hang_s must be >= 0, got {self.hang_s}")
        return self

    def selectors_match(self, patient=None, stem=None, index=None, lane=None) -> bool:
        """Selector-only match (no ordinal/count/rate state consulted)."""
        if self.patient is not None and self.patient != patient:
            return False
        if self.stem is not None and self.stem != stem:
            return False
        if self.index is not None and self.index != index:
            return False
        if self.lane is not None and self.lane != lane:
            return False
        return True


class FaultPlan:
    """A parsed, thread-safe fault plan; drivers hold ``None`` when off."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = [r.validate() for r in rules]
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._sites = frozenset(r.site for r in self.rules)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_spec(cls, spec) -> Optional["FaultPlan"]:
        """Build from a dict, inline-JSON string, or path; None stays None."""
        if spec is None:
            return None
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            text = spec if spec.lstrip().startswith("{") else None
            if text is None:
                with open(spec) as f:
                    text = f.read()
            try:
                spec = json.loads(text)
            except json.JSONDecodeError as e:
                raise ValueError(f"fault plan is not valid JSON: {e}") from e
        if not isinstance(spec, dict):
            raise ValueError(f"fault plan must be a JSON object, got {type(spec)}")
        known = {"site", "kind", "patient", "stem", "index", "lane", "after",
                 "count", "rate", "hang_s"}
        rules = []
        for i, entry in enumerate(spec.get("faults", [])):
            if not isinstance(entry, dict):
                raise ValueError(f"faults[{i}] is not an object")
            unknown = set(entry) - known
            if unknown:
                raise ValueError(f"faults[{i}] has unknown keys {sorted(unknown)}")
            rules.append(FaultRule(**entry))
        return cls(rules, seed=spec.get("seed", 0))

    @classmethod
    def from_env(cls, environ=os.environ) -> Optional["FaultPlan"]:
        return cls.from_spec(environ.get(ENV_VAR) or None)

    # -- matching ----------------------------------------------------------

    def has_site(self, site: str) -> bool:
        return site in self._sites

    def routes_decode(self, patient=None, stem=None, index=None) -> bool:
        """Selector-only decode-site probe, side-effect free.

        The native batch loader uses this to route fault-matched files
        through the Python decode path (where injection actually happens)
        without consuming the rule's ordinal/count state.
        """
        return any(
            r.site == "decode" and r.selectors_match(patient, stem, index)
            for r in self.rules
        )

    def _draw(
        self, rule_idx: int, rule: FaultRule, patient, stem, index, lane
    ) -> bool:
        # keyed, not sequential: the draw depends only on the plan seed and
        # the check's identity (lane included — a serving fleet's lane
        # thread scheduling must not change which dispatches a rate rule
        # hits), so thread interleaving cannot change the injection set
        rng = random.Random(
            f"{self.seed}:{rule_idx}:{rule.site}:{patient}:{stem}:{index}:{lane}"
        )
        return rng.random() < rule.rate

    def fire(
        self, site: str, obs=None, patient=None, stem=None, index=None,
        lane=None, lane_only=False, kinds=None,
    ):
        """Return the first rule firing at this check site, else None.

        ``lane_only`` restricts the check to rules that EXPLICITLY select a
        lane — rules without a ``lane`` selector are skipped entirely
        (their ordinal/budget state untouched). The serving probation
        probes use it: an off-request-path canary must keep failing on a
        deliberately-wedged card, but must never consume a generic
        dispatch rule's ``count``/``after`` budget meant for request
        traffic.

        ``kinds`` restricts the check to rules of the listed kinds, with
        the same budget-untouched skip semantics. It exists for sites
        whose kinds live at DIFFERENT call points (the fleet router's
        health poll vs its proxy path): without it, a ``proxy_io_error``
        rule would match — and consume its ``count`` budget at — every
        health-poll check it was never meant for.

        Consumes ordinal (``after``) and budget (``count``) state; emits the
        ``resilience_faults_injected_total`` counter + ``fault_injected``
        event through ``obs`` when given. The caller maps rule.kind to the
        actual fault (raise / hang / corrupt / SIGTERM).
        """
        if site not in self._sites:
            return None
        hit = None
        with self._lock:
            for i, r in enumerate(self.rules):
                if lane_only and r.lane is None:
                    continue
                if kinds is not None and r.kind not in kinds:
                    continue
                if r.site != site or not r.selectors_match(
                    patient, stem, index, lane
                ):
                    continue
                r._seen += 1
                if r.after is not None and r._seen < r.after:
                    continue
                if r.count is not None and r._fired >= r.count:
                    continue
                if r.rate is not None and not self._draw(
                    i, r, patient, stem, index, lane
                ):
                    continue
                r._fired += 1
                hit = r
                break
        if hit is not None and obs is not None:
            try:
                obs.fault_injected(
                    site=site, kind=hit.kind,
                    patient=patient, stem=stem, index=index, lane=lane,
                )
            except Exception:  # noqa: BLE001 — telemetry never blocks a fault
                pass
        return hit

    def fired_total(self) -> int:
        with self._lock:
            return sum(r._fired for r in self.rules)


# -- fault actions ----------------------------------------------------------


def corrupt_bytes(raw: bytes, seed: int, key: str = "") -> bytes:
    """Deterministically corrupt a DICOM file image in memory.

    Overwrites a 64-byte window over the Part-10 magic and the start of the
    file meta group with seeded garbage AND truncates the tail (so even a
    parse that realigns onto valid elements hits a PixelData length
    overrun) — the *real* parser exercises its rejection path on every
    input, without touching the file on disk.
    """
    rng = random.Random(f"{seed}:corrupt:{key}")
    start = min(128, max(0, len(raw) - 1))
    garbage = bytes(rng.randrange(1, 255) for _ in range(64))
    out = raw[:start] + garbage + raw[start + len(garbage):]
    return out[: max(192, len(out) // 2)]


def execute_hang(rule: FaultRule, cancel: Optional[threading.Event] = None) -> None:
    """Simulate a wedged dispatch: block for ``rule.hang_s`` seconds.

    When the supervisor abandons the dispatch (deadline expiry) it sets
    ``cancel``; this raises :class:`FaultAbandoned` so the orphaned worker
    thread exits promptly instead of sleeping out the hang and then running
    the real dispatch whose results nobody will read.
    """
    t_end = time.monotonic() + rule.hang_s
    while time.monotonic() < t_end:
        if cancel is not None:
            if cancel.wait(timeout=0.05):
                raise FaultAbandoned("hang abandoned by dispatch supervisor")
        else:
            time.sleep(min(0.05, max(t_end - time.monotonic(), 0.0)))


def deliver_sigterm() -> None:
    """The crash drill: deliver SIGTERM to this process and wait to die.

    The sleep guarantees the injection point is a hard interruption (the
    default SIGTERM disposition terminates the process before the sleep
    ends); if a test harness traps SIGTERM instead, the fault degrades to a
    raised :class:`InjectedExportError` so the run cannot sail on.
    """
    import signal

    os.kill(os.getpid(), signal.SIGTERM)
    time.sleep(10.0)
    raise InjectedExportError("SIGTERM fault delivered but process survived")
