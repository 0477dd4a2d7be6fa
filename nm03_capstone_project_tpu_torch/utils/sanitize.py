"""``--sanitize`` for the port: the runtime twins of the nm03-lint rules.

The port's counterpart of the JAX package's ``utils/sanitize.py``. Static
analysis catches the hazards visible in source; these checks catch the
same hazard *classes* where only execution can see them
(docs/STATIC_ANALYSIS_TORCH.md pairs each rule with its twin):

* **non-finite stages** (the twin of ``jax_debug_nans``) — the f32 output
  of every stage on the path (edge extension, the fused preprocess
  kernel's output as one stage, or normalize, clip, median and sharpen
  apart) is held to ``torch.isfinite``, and the first stage with a NaN or
  an infinity raises :class:`NonFiniteStage` naming it, instead of
  surfacing as a garbage mask three stages later. Eagerly a check is a
  host sync right after the stage; inside a CUDA graph capture (where a
  sync is illegal) the stage's flag is recorded as one more output of the
  graph, and :func:`raise_if_nonfinite` checks it after each replay's
  fetch;
* a **recompile watchdog** — the port compiles nothing per call, but it
  has two compile-like events: a CUDA graph capture
  (``serving/graphs.py``) and a kernel library load (``kernels/build.py``,
  one ``ctypes.CDLL`` a library and process). Each one after
  :func:`mark_warm` counts into ``pipeline_recompiles_total``
  (docs/OBSERVABILITY_TORCH.md), the runtime face of NM311/NM312: a steady
  state stays at 0, and a growing counter is work the warm-up missed;
* the **upload guard** around dispatch (the twin of
  ``jax.transfer_guard_host_to_device("disallow")``) — inside a
  :func:`guard_dispatch` block, a CPU tensor or a numpy array that reaches
  a pipeline entry meant for the card raises :class:`ImplicitUpload`
  naming the guarded site: the batch drivers stage their slices through
  ``ingest/`` (NM401), so an upload inside the window is a hidden
  re-stage. The guard is upload-only and per thread: it is a check at the
  pipeline's input on the dispatching thread (the supervisor re-arms it in
  its worker), not ``torch.cuda.set_sync_debug_mode``, which is
  process-wide and would also trip the other threads' sanctioned fetches.

Stdlib-only at import (an import-contract module): torch is imported inside
the checks that need it. Nothing here costs anything unless :func:`enable`
ran: every hook first reads one module global.
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Optional, Tuple

# canonical name home is obs.metrics (NM392); aliased for the call sites
from nm03_capstone_project_tpu_torch.obs.metrics import (
    PIPELINE_RECOMPILES_TOTAL as RECOMPILES_TOTAL,
)

_HELP = ("CUDA graph captures and kernel library loads after warm-up, counted "
         "by the --sanitize watchdog (growth = work the warm-up missed; see "
         "docs/STATIC_ANALYSIS_TORCH.md NM312)")

_ACTIVE: Optional["SanitizeState"] = None
_tls = threading.local()


class NonFiniteStage(FloatingPointError):
    """A pipeline stage produced a NaN or an infinity (``--sanitize``)."""

    def __init__(self, stage: str, detail: str = ""):
        self.stage = stage
        super().__init__(f"--sanitize: stage {stage!r} produced non-finite values{detail}")


class ImplicitUpload(RuntimeError):
    """A host array reached a dispatch meant for the card (``--sanitize``)."""

    def __init__(self, site: str, what: str):
        self.site = site
        super().__init__(
            f"--sanitize: implicit host->card upload of {what} inside the guarded "
            f"dispatch {site} — stage it through ingest/ first")


class SanitizeState:
    """One enabled sanitize session: the watchdog's counts."""

    def __init__(self, registry=None):
        self.registry = registry
        self._lock = threading.Lock()
        self.warm = False
        self.warmup_compiles = 0  # before mark_warm: the warm-up's own work
        self.recompiles = 0  # after mark_warm: pipeline_recompiles_total
        self.events: List[Tuple[str, str]] = []  # (kind, what) after warm-up

    def note_compile(self, kind: str, what: str) -> None:
        with self._lock:
            if not self.warm:
                self.warmup_compiles += 1
                return
            self.recompiles += 1
            self.events.append((kind, what))
        if self.registry is not None:
            try:
                self.registry.counter(RECOMPILES_TOTAL, help=_HELP).inc()
            except Exception:  # noqa: BLE001 — telemetry never costs the run
                pass


def active() -> bool:
    """True when enable() ran in this process (and disable() did not)."""
    return _ACTIVE is not None


def state() -> Optional[SanitizeState]:
    return _ACTIVE


def enable(registry=None) -> SanitizeState:
    """Turn the runtime twins on in this process.

    The lock-order twin (NM421/NM422) rides the same opt-in but stays gated
    on ``NM03_LOCKDEP=1``: instrumented locks only help when this runs
    before the threaded objects exist, and the variable is that assertion.
    A repeat call starts a fresh session for the new ``registry``. The
    counter is created at 0 at once, so a sanitized run's snapshot always
    carries it, even when nothing is ever captured or loaded.
    """
    from nm03_capstone_project_tpu_torch.utils import lockdep

    lockdep.install_from_env()
    global _ACTIVE
    _ACTIVE = SanitizeState(registry)
    if registry is not None:
        registry.counter(RECOMPILES_TOTAL, help=_HELP).inc(0)
    return _ACTIVE


def disable() -> Optional[SanitizeState]:
    """End the session (in-process callers running several drivers, tests);
    returns the finished state."""
    global _ACTIVE
    st, _ACTIVE = _ACTIVE, None
    return st


def mark_warm() -> None:
    """The warm-up is over: every later capture or library load counts."""
    st = _ACTIVE
    if st is not None:
        with st._lock:
            st.warm = True


def note_compile(kind: str, what: str) -> None:
    """A graph capture (``kind="graph"``) or a kernel library load
    (``kind="library"``) happened; a no-op unless sanitize is on."""
    st = _ACTIVE
    if st is not None:
        st.note_compile(kind, what)


# -- non-finite stages ---------------------------------------------------------


def check_finite(stage: str, t) -> None:
    """Raise :class:`NonFiniteStage` when ``t`` holds a NaN or an infinity.

    Inside a CUDA graph capture the flag joins :func:`capture_checks`'
    list instead (a sync there is illegal), for a check after each replay.
    """
    if _ACTIVE is None:
        return
    import torch

    flag = torch.isfinite(t).all()
    if t.is_cuda and torch.cuda.is_current_stream_capturing():
        pending = getattr(_tls, "captured", None)
        if pending is not None:
            pending.append((stage, flag))
        return
    if not bool(flag):
        raise NonFiniteStage(stage, _where(t))


def _where(t) -> str:
    import torch

    bad = (~torch.isfinite(t)).nonzero()
    return f" ({int(bad.shape[0])} values, first at index {bad[0].tolist()})"


@contextlib.contextmanager
def capture_checks():
    """Collect the stage flags :func:`check_finite` records while this
    thread captures a graph; yields the list of ``(stage, flag)``."""
    prev = getattr(_tls, "captured", None)
    flags: List[tuple] = []
    _tls.captured = flags
    try:
        yield flags
    finally:
        _tls.captured = prev


def raise_if_nonfinite(flags) -> None:
    """After a replay: raise for the first captured stage flag that is False."""
    if _ACTIVE is None:
        return
    for stage, flag in flags:
        if not bool(flag):
            raise NonFiniteStage(stage, " (inside a CUDA graph replay)")


# -- the upload guard ----------------------------------------------------------


@contextlib.contextmanager
def guard_dispatch(site: str):
    """Guard this thread's dispatch window at ``site``: a host array that
    reaches a pipeline entry for the card raises. A no-op unless sanitize
    is on, so call sites wrap their dispatch unconditionally."""
    if _ACTIVE is None:
        yield
        return
    prev = getattr(_tls, "site", None)
    _tls.site = site
    try:
        yield
    finally:
        _tls.site = prev


def current_site() -> Optional[str]:
    """The guarded site of this thread's dispatch window, if any (the
    supervisor re-arms it on its worker thread)."""
    return getattr(_tls, "site", None) if _ACTIVE is not None else None


def check_upload(value, device, what: str = "the pixels") -> None:
    """Raise :class:`ImplicitUpload` when ``value`` is host data bound for a
    CUDA ``device`` inside a guarded dispatch window of this thread."""
    site = current_site()
    if site is None:
        return
    import torch

    if torch.device(device).type != "cuda":
        return
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            return
        kind = "a CPU tensor"
    else:
        kind = f"a host {type(value).__name__}"
    raise ImplicitUpload(site, f"{what} ({kind})")
