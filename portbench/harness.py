"""Drive one cell: a closed loop of studies through the program's entry.

One host thread dispatches. A study is staged from pinned host memory onto
the card on a copy stream while the study before it computes (``depth``
studies in flight at most, 2 in every mix so far), its entry call is
enqueued on the default stream behind the staging, and its mask and
converged flags are copied back into pinned host memory. Before a study
is staged into an input slot, the host waits for the study that last used
the slot to be done: that wait is the loop's only back pressure.

Each study carries three CUDA events: ``start`` (its staging began),
``staged`` and ``done`` (its outputs are in host memory). A study's
latency is ``start`` to ``done`` on the device's clock; its completion
time is ``done`` measured from the window's start event.

Answers are sampled for the check by reservoir sampling, drawn from the
seed: the k-th answer of the run takes a fixed pinned output slot with
probability slots / k, decided when it is dispatched, so the sample is
uniform over every answer dispatched, with no copy made after the fact.
Every other answer lands in a scratch slot.

On the CPU (tests only) the streams are absent, the copies synchronous
and the events host timestamps; the benchmark's own runs refuse the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from portbench import data
from portbench import trace as tracemod

WARM_STUDIES = 3
DRAIN_S = 60.0  # how long after the window an answer may still come
LIMITS = {"mask_voxels_differ": 0, "converged_differ": 0, "answers_missing": 0}


class _HostEvent:
    """A CUDA event's interface on the CPU, where every op is synchronous."""

    t = 0.0

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def query(self):
        return True

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Spans:
    """Host spans of the dispatch thread, ``(start_ns, end_ns, name)`` on
    the wall clock (ns since the epoch) that the profiler's records use."""

    def __init__(self):
        self.items: List[tuple] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self.items.append((t, time.time_ns(), name))


def _no_span(name: str):
    return contextlib.nullcontext()


@dataclasses.dataclass
class Study:
    study: int  # index in the cohort
    planes: int
    slot: int
    start: object
    staged: object
    done: object = None
    out: int = -1
    dispatch_s: float = 0.0
    latency_ms: Optional[float] = None
    done_ms: Optional[float] = None
    came: bool = False


class Harness:
    """One cell's data, program and loop at one seed.

    ``engine``: ``"program"`` (the port's entry) or ``"control"`` (the
    plain reference one precision below the configuration's, in the
    program's place).
    """

    def __init__(self, cell: dict, seed: int, device, engine: str = "program"):
        self.cell, self.seed = cell, int(seed)
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.entry = cell["entry"]
        self.pipeline = dict(cell["config"]["pipeline"])
        cohort = cell["config"]["cohort"]
        self.depth = int(cell["traffic"]["depth"])
        self.n_slots = int(cell["traffic"]["sample"])
        planes, canvas = int(cohort["planes"]), int(cohort["canvas"])
        self.shape = (planes, canvas, canvas)

        self.host_px, self.host_dims = [], []
        for st in data.make_cohort(cohort, self.seed, self.dev):
            px = torch.empty(self.shape, dtype=torch.float32, pin_memory=self.cuda)
            px.copy_(st.pixels)
            self.host_px.append(px)
            self.host_dims.append(self.entry.stage_dims(st.dims, planes).pin_memory()
                                  if self.cuda else self.entry.stage_dims(st.dims, planes))
        self.order = data.study_order(len(self.host_px), self.seed)
        self.px_slots = [torch.empty(self.shape, dtype=torch.float32, device=self.dev)
                         for _ in range(self.depth)]
        self.dims_slots = [torch.empty_like(self.host_dims[0], device=self.dev)
                           for _ in range(self.depth)]
        self.copy_stream = torch.cuda.Stream(self.dev) if self.cuda else None
        self.engine = (self.entry.program(self.pipeline) if engine == "program"
                       else self.entry.reference(self.pipeline, torch.bfloat16))
        self.masks = self.convs = None
        self.owner: List[Optional[Study]] = [None] * self.n_slots
        self.sampled = 0
        self.rng = random.Random(self.seed * 7919 + 17)
        self.missing = 0

    # -- the loop ---------------------------------------------------------------

    def _event(self):
        return torch.cuda.Event(enable_timing=True) if self.cuda else _HostEvent()

    def _on_copy_stream(self):
        return torch.cuda.stream(self.copy_stream) if self.cuda else contextlib.nullcontext()

    def _stage(self, n: int, rf) -> Study:
        s = self.order[n % len(self.order)]
        rec = Study(study=s, planes=self.shape[0], slot=n % self.depth,
                    start=self._event(), staged=self._event())
        with rf("portbench.stage"), self._on_copy_stream():
            rec.start.record()
            self.px_slots[rec.slot].copy_(self.host_px[s], non_blocking=True)
            self.dims_slots[rec.slot].copy_(self.host_dims[s], non_blocking=True)
            rec.staged.record()
        return rec

    def _out_slot(self, sample: bool) -> int:
        if not sample:
            return self.n_slots
        k, self.sampled = self.sampled, self.sampled + 1
        if k < self.n_slots:
            return k
        j = self.rng.randrange(k + 1)
        return j if j < self.n_slots else self.n_slots

    def _compute(self, rec: Study, sample: bool, rf) -> None:
        if self.cuda:
            torch.cuda.current_stream(self.dev).wait_event(rec.staged)
        with rf("portbench.dispatch"):
            t = time.perf_counter()
            out = self.engine(self.px_slots[rec.slot], self.dims_slots[rec.slot])
            rec.dispatch_s = time.perf_counter() - t
        with rf("portbench.fetch"):
            mask, conv = out["mask"], out["grow_converged"].reshape(-1)
            if self.masks is None:
                self.masks = [torch.empty(mask.shape, dtype=mask.dtype, pin_memory=self.cuda)
                              for _ in range(self.n_slots + 1)]
                self.convs = [torch.empty(conv.shape, dtype=conv.dtype, pin_memory=self.cuda)
                              for _ in range(self.n_slots + 1)]
            rec.out = self._out_slot(sample)
            if rec.out < self.n_slots:
                self.owner[rec.out] = rec
            self.masks[rec.out].copy_(mask, non_blocking=True)
            self.convs[rec.out].copy_(conv, non_blocking=True)
            rec.done = self._event()
            rec.done.record()

    def drive(self, studies: Optional[int] = None, seconds: Optional[float] = None,
              sample: bool = True, spans: Optional[Spans] = None):
        """Run studies until ``studies`` were dispatched or ``seconds`` have
        passed; wait for every answer. Returns ``(records, t0)``, ``t0``
        the host time the first study was staged. ``spans`` records the
        loop's steps (``portbench.stage``, ``.dispatch``, ``.fetch``,
        ``.wait``)."""
        rf = spans or _no_span
        recs: List[Study] = []
        window = self._event()
        t0 = time.perf_counter()
        with self._on_copy_stream():
            window.record()
        pending = self._stage(0, rf)
        while True:
            rec = pending
            self._compute(rec, sample, rf)
            recs.append(rec)
            n = len(recs)
            if (studies is not None and n >= studies) or (
                    seconds is not None and time.perf_counter() - t0 >= seconds):
                break
            if n >= self.depth:
                with rf("portbench.wait"):
                    recs[n - self.depth].done.synchronize()
            pending = self._stage(n, rf)
        deadline = time.perf_counter() + DRAIN_S
        with rf("portbench.wait"):
            for rec in recs:
                while not rec.done.query() and time.perf_counter() < deadline:
                    time.sleep(0.001)
        for rec in recs:
            rec.came = bool(rec.done.query())
            if rec.came:
                rec.latency_ms = rec.start.elapsed_time(rec.done)
                rec.done_ms = window.elapsed_time(rec.done)
            else:
                self.missing += 1
        return recs, t0

    def traced_pass(self, studies: int) -> Optional[tracemod.TraceSummary]:
        """``studies`` whole studies under torch.profiler; their summary.

        Only the device's activity is recorded: recording every host
        operator as well halved the host's dispatch rate on the card's
        host, and the idle share would read the profiler. The host's side
        is the loop's own spans."""
        from torch.profiler import profile

        import nm03_capstone_project_tpu_torch as port

        spans = Spans()
        with profile(activities=self._activities()) as prof:
            with spans(tracemod.PASS):
                self.drive(studies=studies, sample=True, spans=spans)
        return tracemod.summarize(prof, studies, tracemod.handwritten_kernels(
            Path(port.__file__).parent), spans.items)

    def _activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CUDA] if self.cuda else [ProfilerActivity.CPU]

    def warm_profiler(self) -> None:
        """Start the profiler once, so its first start costs no pass."""
        from torch.profiler import profile

        with profile(activities=self._activities()):
            torch.zeros(1, device=self.dev).add_(1)
            if self.cuda:
                torch.cuda.synchronize(self.dev)

    # -- the check ----------------------------------------------------------------

    def release(self) -> None:
        """Free the program's device state before the reference runs."""
        self.px_slots = self.dims_slots = None
        self.engine = None
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, dict]:
        """Every sampled answer against the plain reference on the same
        study, in float32: voxels whose mask differs, converged flags that
        differ, and answers that never came."""
        ref = self.entry.reference(self.pipeline, torch.float32)
        refs: Dict[int, tuple] = {}
        voxels = flags = compared = 0
        for slot, rec in enumerate(self.owner):
            if rec is None or not rec.came:
                continue
            if rec.study not in refs:
                out = ref(self.host_px[rec.study].to(self.dev), self.host_dims[rec.study].to(self.dev))
                refs[rec.study] = (out["mask"].cpu(), out["grow_converged"].reshape(-1).cpu())
                del out
            want_mask, want_conv = refs[rec.study]
            voxels += int((self.masks[slot] != want_mask).sum())
            flags += int((self.convs[slot] != want_conv).sum())
            compared += 1
        values = {"mask_voxels_differ": voxels, "converged_differ": flags,
                  "answers_missing": self.missing}
        checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}
        checks["answers_compared"] = {"value": compared, "min": 1}
        return checks


def correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values() if "limit" in c) and all(
        c["value"] >= c["min"] for c in checks.values() if "min" in c)


@dataclasses.dataclass
class RunView:
    """What a metric's reader reads: the cell, a study's shape, the
    window's studies and seconds, the set-up seconds and, in a traced run,
    the profiled pass's summary."""

    cell: dict
    shape: tuple
    seconds: float
    setup_s: float
    window: List[Study]
    trace: Optional[tracemod.TraceSummary]

    @property
    def pipeline(self) -> dict:
        return self.cell["config"]["pipeline"]

    @property
    def volume(self) -> bool:
        return bool(self.cell["entry"].VOLUME)

    def completed(self) -> List[Study]:
        """The studies whose outputs reached the host inside the window."""
        return [r for r in self.window if r.came and r.done_ms <= self.seconds * 1e3]
