"""The program's own stage spans in a traced pass: what the card idles behind.

The port names each stage of an entry call once and, while a
``StageRecorder`` is open on the dispatch thread
(``nm03_capstone_project_tpu_torch.pipeline.stage_spans``), records it as
a span ``(start_ns, end_ns, name, parent)`` on the wall clock of the
profiler's records, with two counters of the 3D growth (``grow3d.steps``,
``grow3d.syncs``). :func:`traced_pass` is the harness's traced pass with
that recorder open around the loop (and only there: a timed window keeps
it off). The program's spans join the loop's as
``portbench.dispatch/<span>``, so ``trace.summarize`` puts each idle gap
of the card down to the stage the dispatch thread was in
(``dispatch/seeds``, ``dispatch/grow3d.block``, ...); the ``entry`` span
itself stays out, so the entry's own time reads ``dispatch`` as before.

That breakdown puts a whole gap down to where it began: a gap that opens
inside a ``grow3d.sync`` (the popcount came back) runs on while the host
launches the next block. :func:`idle_by_span` splits the card's idle time
by the dispatch thread's innermost span over each instant instead, the
entry's own time as ``dispatch/entry``; the metrics read that split.

A program without the recorder (an older checkout) gives no spans: the
pass runs as the harness's own, and every reader of :class:`Program`
reads nothing.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from portbench import trace as tracemod

DISPATCH = tracemod.HARNESS_PREFIX + "dispatch"
ENTRY = "entry"
SYNC = "grow3d.sync"


@dataclasses.dataclass
class Program:
    """The program's spans and counters over a traced pass of ``studies``,
    and the hand-written kernels' launches in it."""

    spans: List[Tuple[int, int, str, int]]
    counters: Dict[str, int]
    studies: int
    launches: Dict[str, int]
    idle_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    def host_ms(self, name: str, under: Optional[str] = None) -> float:
        """Host milliseconds in the spans named ``name`` (those with an
        ancestor named ``under``, where given)."""
        total = 0
        for s, e, n, parent in self.spans:
            if n == name and (under is None or self._has_ancestor(parent, under)):
                total += e - s
        return total * 1e-6

    def _has_ancestor(self, i: int, name: str) -> bool:
        while i >= 0:
            _, _, n, i2 = self.spans[i]
            if n == name:
                return True
            i = i2
        return False

    def block(self) -> dict:
        """The result line's ``program`` block: each span's count and host
        ms a study, each counter a study, each kernel's launches a study."""
        per = max(self.studies, 1)
        spans: Dict[str, dict] = {}
        for s, e, n, _ in self.spans:
            d = spans.setdefault(n, {"count": 0, "host_ms_per_study": 0.0})
            d["count"] += 1
            d["host_ms_per_study"] += (e - s) * 1e-6 / per
        return {"studies": self.studies, "spans": spans,
                "counters": {k: v / per for k, v in self.counters.items()},
                "launches_per_study": {k: v / per for k, v in self.launches.items()},
                "idle_s": dict(sorted(self.idle_s.items(), key=lambda kv: -kv[1]))}


def merge(loop_spans, program_spans) -> List[Tuple[int, int, str]]:
    """The loop's ``(start_ns, end_ns, name)`` spans and the program's, the
    program's renamed ``portbench.dispatch/<name>``; ``entry`` left out."""
    return list(loop_spans) + [(s, e, f"{DISPATCH}/{n}") for s, e, n, _ in program_spans
                               if n != ENTRY]


def _name(span: str) -> str:
    return span.removeprefix(tracemod.HARNESS_PREFIX)


def launch_idle_s(idle_s: Dict[str, float]) -> float:
    """Idle seconds of the card while the dispatch thread was inside a
    program span other than a ``grow3d.sync``: the host launching."""
    prefix = _name(DISPATCH) + "/"
    return sum(v for k, v in idle_s.items() if k.startswith(prefix) and k != prefix + SYNC)


def _innermost_pieces(host: List[Tuple[int, int, str]], w0: int, w1: int):
    """``[(t0, t1, name)]`` tiling ``[w0, w1)``: the innermost of the nested
    ``host`` spans over each piece, ``loop`` where there is none."""
    pieces, stack, t = [], [], w0

    def upto(until, name):
        nonlocal t
        until = min(until, w1)
        if until > t:
            pieces.append((t, until, name))
            t = until

    for s, e, n in sorted(host, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, name = stack.pop()
            upto(end, name)
        upto(s, stack[-1][1] if stack else "loop")
        stack.append((e, n))
    while stack:
        end, name = stack.pop()
        upto(end, name)
    upto(w1, "loop")
    return pieces


def idle_by_span(device: List[Tuple[int, int, str]], loop_spans, program_spans,
                 w0: int, w1: int) -> Dict[str, float]:
    """Seconds of ``[w0, w1)`` in which the card ran none of ``device``, by
    the dispatch thread's innermost span: the loop's by their names less
    ``portbench.``, the program's as ``dispatch/<name>``."""
    host = [(s, e, _name(n)) for s, e, n in loop_spans if n != tracemod.PASS]
    host += [(s, e, f"{_name(DISPATCH)}/{n}") for s, e, n, _ in program_spans]
    idle, cursor = [], w0
    for s, e, _ in sorted(device):
        if s > cursor:
            idle.append((cursor, min(s, w1)))
        cursor = max(cursor, e)
    if w1 > cursor:
        idle.append((cursor, w1))
    out: Dict[str, float] = {}
    pieces, i = _innermost_pieces(host, w0, w1), 0
    for a, b in idle:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            s, e, n = pieces[j]
            overlap = min(b, e) - max(a, s)
            if overlap > 0:
                out[n] = out.get(n, 0.0) + overlap * 1e-9
            j += 1
    return out


def device_records(prof, w0: int, w1: int) -> List[Tuple[int, int, str]]:
    """The kernels, copies and memsets of the trace inside ``[w0, w1)``,
    ``(start_ns, end_ns, name)`` in start order."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda and tracemod._device_work(ev.name()):
            s, e = ev.start_ns(), ev.end_ns()
            if e > w0 and s < w1:
                out.append((s, e, ev.name()))
    return sorted(out)


def traced_pass(h, studies: int):
    """``h.traced_pass(studies)`` with the program's recorder open around
    the loop: ``(summary, program, device records)``; ``program`` None
    where the program has no recorder."""
    from contextlib import nullcontext

    from torch.profiler import profile

    import nm03_capstone_project_tpu_torch as port
    from nm03_capstone_project_tpu_torch.ops.launches import launch_counts

    from portbench.harness import Spans

    try:
        from nm03_capstone_project_tpu_torch.obs.spans import StageRecorder
        from nm03_capstone_project_tpu_torch.pipeline import stage_spans
    except ImportError:  # a program without the recorder
        rec, opened = None, nullcontext()
    else:
        rec = StageRecorder()
        opened = stage_spans(rec)
    spans = Spans()
    before = launch_counts()
    with profile(activities=h._activities()) as prof:
        with spans(tracemod.PASS), opened:
            h.drive(studies=studies, sample=True, spans=spans)
    after = launch_counts()
    w0, w1 = next((s, e) for s, e, n in spans.items if n == tracemod.PASS)
    device = device_records(prof, w0, w1)
    prog = None if rec is None else Program(
        spans=list(rec.spans), counters=dict(rec.counters), studies=studies,
        launches={k: after[k] - before.get(k, 0) for k in after},
        idle_s=idle_by_span(device, spans.items, rec.spans, w0, w1) if device else {})
    merged = merge(spans.items, prog.spans if prog else [])
    summary = tracemod.summarize(prof, studies, tracemod.handwritten_kernels(
        Path(port.__file__).parent), merged)
    return summary, prog, device
