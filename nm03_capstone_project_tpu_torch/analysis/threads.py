"""NM33x — shared-state race heuristic for the port's threaded subsystems.

The serving stack is a deliberate thread topology: N HTTP handler threads,
one batcher thread, supervisor worker threads, a drain thread spawned from
a signal handler — all sharing objects (queue, executor, app state). The
codebase's own discipline (batcher.py's "single consumer" docstring, the
supervisor's ``_lock``) is that cross-thread attributes are lock-guarded,
Queue/Event-mediated, or explicitly annotated. This rule makes that
discipline checkable.

Heuristic, scoped to stay honest: within the port's files registered as
threaded (:data:`THREADED_FILES`), a class that creates threads or owns
synchronization primitives is "concurrent"; any plain attribute it writes
*outside* ``__init__`` and outside a ``with self.<lock>:`` block is flagged.
Attributes whose initializer is itself a synchronization object (Event,
Lock, Condition, Queue, deque) are exempt — mutation happens through their
own thread-safe APIs. CPython's GIL makes most of these benign as *tearing*
goes; the hazard the rule actually guards is ordering (a reader observing
``warm = True`` before the state the flag advertises) and lost updates —
and one unguarded flag that "was fine" is how the next refactor inherits a
race.

False positives are expected and wanted as *documented suppressions*: the
single-thread-confined attribute with a ``disable=NM331 <why>`` annotation
is the cheapest possible concurrency documentation.

Rules:
  NM331  plain attribute written outside a lock in a concurrent class
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from nm03_capstone_project_tpu_torch.analysis.core import Finding, SourceFile

# files whose classes participate in the cross-thread object graph
THREADED_FILES: Tuple[str, ...] = (
    # handler threads, the batcher, the lane workers, the volume gang's
    # thread and, across a job, the follower rank's loop (serving/follower.py)
    "nm03_capstone_project_tpu_torch/serving/",
    "nm03_capstone_project_tpu_torch/resilience/supervisor.py",
    # rings written by executor/batcher/lane threads, read by scrapes
    "nm03_capstone_project_tpu_torch/obs/saturation.py",
    # the device-time ledger's sampler thread shares the accounts with the
    # executor's lanes and the scrape handlers
    "nm03_capstone_project_tpu_torch/obs/ledger.py",
    # feeder/stager/decode-pool threads share the ring and counters
    "nm03_capstone_project_tpu_torch/ingest/",
    # handler threads, the health poller and the drain thread share the
    # replica table and the routing weights
    "nm03_capstone_project_tpu_torch/fleet/",
    # the result tier: filled by handler threads, evicted by scrapes
    "nm03_capstone_project_tpu_torch/cache/",
    # parallel/distributed.py owns no thread: its collectives run on the
    # caller's (the gang's or the follower's), so it is not registered
)

_SYNC_TYPE_NAMES = {
    "Event", "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
    "Barrier", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "deque", "local", "AdmissionQueue",
}


def _call_type_name(node: ast.expr) -> Optional[str]:
    """Rightmost name of a Call's constructor (threading.Lock -> 'Lock')."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _lockish(name: str) -> bool:
    return "lock" in name.lower() or "cond" in name.lower()


class _ClassFacts:
    def __init__(self, node: ast.ClassDef):
        self.node = node
        self.spawns_thread = False
        self.lock_attrs: Set[str] = set()
        self.sync_attrs: Set[str] = set()  # attrs holding sync objects
        self.init_writes: Set[str] = set()
        # attr -> [(method, line, guarded, source_line)]
        self.writes: Dict[str, List[Tuple[str, int, bool, str]]] = {}


def _field_default_type(node: ast.expr) -> Optional[str]:
    """Type name behind dataclasses.field(default_factory=X) / direct calls."""
    if isinstance(node, ast.Call):
        name = _call_type_name(node)
        if name == "field":
            for kw in node.keywords:
                if kw.arg == "default_factory":
                    v = kw.value
                    if isinstance(v, ast.Attribute):
                        return v.attr
                    if isinstance(v, ast.Name):
                        return v.id
            return None
        return name
    return None


def _gather(src: SourceFile, cls: ast.ClassDef) -> _ClassFacts:
    facts = _ClassFacts(cls)
    # dataclass-style fields
    for stmt in cls.body:
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            tname = _field_default_type(stmt.value) if stmt.value is not None else None
            if tname in _SYNC_TYPE_NAMES:
                facts.sync_attrs.add(stmt.target.id)
                if tname in ("Lock", "RLock", "Condition"):
                    facts.lock_attrs.add(stmt.target.id)
            facts.init_writes.add(stmt.target.id)
            # annotation alone (e.g. `done: threading.Event`) also marks sync
            ann = stmt.annotation
            ann_name = ann.attr if isinstance(ann, ast.Attribute) else (
                ann.id if isinstance(ann, ast.Name) else None
            )
            if ann_name in _SYNC_TYPE_NAMES:
                facts.sync_attrs.add(stmt.target.id)

    for method in cls.body:
        if not isinstance(method, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        in_init = method.name == "__init__"

        # guarded line spans: every `with self.<lockish>:` body
        guarded_ranges: List[Tuple[int, int]] = []
        for sub in ast.walk(method):
            if isinstance(sub, ast.With):
                for item in sub.items:
                    ctx = item.context_expr
                    attr = None
                    if isinstance(ctx, ast.Attribute) and isinstance(
                        ctx.value, ast.Name
                    ) and ctx.value.id == "self":
                        attr = ctx.attr
                    if attr is not None and (
                        attr in facts.lock_attrs or _lockish(attr)
                    ):
                        end = getattr(sub, "end_lineno", None) or max(
                            (
                                getattr(n, "end_lineno", 0) or 0
                                for n in ast.walk(sub)
                                if hasattr(n, "lineno")
                            ),
                            default=sub.lineno,
                        )
                        guarded_ranges.append((sub.lineno, end))

        def is_guarded(line: int) -> bool:
            return any(a <= line <= b for a, b in guarded_ranges)

        for sub in ast.walk(method):
            if isinstance(sub, ast.Call):
                name = _call_type_name(sub)
                if name == "Thread":
                    facts.spawns_thread = True
            targets: List[ast.expr] = []
            if isinstance(sub, ast.Assign):
                targets = list(sub.targets)
                vtype = _call_type_name(sub.value)
            elif isinstance(sub, ast.AugAssign):
                targets = [sub.target]
                vtype = None
            else:
                continue
            for t in targets:
                # self.x[...] = / += mutates the container behind self.x:
                # the same shared-state write one indirection deeper
                if isinstance(t, ast.Subscript):
                    t = t.value
                if not (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    continue
                attr = t.attr
                if in_init:
                    facts.init_writes.add(attr)
                    if vtype in _SYNC_TYPE_NAMES:
                        facts.sync_attrs.add(attr)
                        if vtype in ("Lock", "RLock", "Condition"):
                            facts.lock_attrs.add(attr)
                    if _lockish(attr) and vtype in (
                        "Lock", "RLock", "Condition", None
                    ):
                        facts.lock_attrs.add(attr)
                else:
                    facts.writes.setdefault(attr, []).append(
                        (
                            method.name,
                            sub.lineno,
                            is_guarded(sub.lineno),
                            src.line_text(sub.lineno),
                        )
                    )
    return facts


def _concurrent(facts: _ClassFacts) -> bool:
    return facts.spawns_thread or bool(facts.lock_attrs) or bool(
        facts.sync_attrs
    )


def check_thread_shared_state(files: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        if src.tree is None:
            continue
        if not any(
            src.relpath == t or src.relpath.startswith(t) for t in THREADED_FILES
        ):
            continue
        for cls in src.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            facts = _gather(src, cls)
            if not _concurrent(facts):
                continue
            for attr, writes in sorted(facts.writes.items()):
                if attr in facts.sync_attrs or attr in facts.lock_attrs:
                    continue
                for method, line, guarded, source_line in writes:
                    if guarded:
                        continue
                    findings.append(
                        Finding(
                            rule="NM331",
                            path=src.relpath,
                            line=line,
                            message=(
                                f"{cls.name}.{attr} written in {method}() "
                                "without holding a lock, in a class shared "
                                "across threads — guard it, route it through "
                                "a Queue/Event, or annotate why it is "
                                "single-thread confined"
                            ),
                            source_line=source_line,
                        )
                    )
    return findings
