"""What a profiled pass did on the device, read from torch.profiler's trace.

The benchmark opens the profiler around a pass of whole studies (its
``portbench.pass`` span) and records the device's activity only. From
the trace it keeps:

* every kernel, copy and memset the device ran inside the pass, by the
  kernel's base name (``void fused_kernel<7, 16>(...)`` -> ``fused_kernel``);
* the device's busy time: the union of those intervals;
* the idle gaps between them, each put down to what the host's dispatch
  thread was doing when it began: the benchmark's own span (``stage``,
  ``dispatch``, ``fetch``, ``wait``; ``loop`` between them). The spans are
  taken on the wall clock in nanoseconds, the clock of the profiler's
  records.

The program's hand-written kernels are the ``__global__`` functions of its
CUDA sources; every other kernel is one of PyTorch's.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

PASS = "portbench.pass"
HARNESS_PREFIX = "portbench."

_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def handwritten_kernels(package_dir: Path) -> frozenset:
    """Names of the ``__global__`` functions in the program's CUDA sources."""
    names = set()
    for src in sorted((Path(package_dir) / "csrc").glob("*.cu")):
        names.update(_GLOBAL.findall(src.read_text()))
    return frozenset(names)


def base_name(name: str) -> str:
    """A device kernel's name without its return type, template arguments
    and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = [i for i in (name.find("<"), name.find("(")) if i >= 0]
    return name[:min(cut)] if cut else name


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


@dataclasses.dataclass
class TraceSummary:
    studies: int
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    copy_s: float
    handwritten: frozenset
    idle_by_host: Dict[str, float]
    staged_copies: int

    @property
    def complete(self) -> bool:
        """Whether every study's two staging copies (pixels and sizes) are
        in the trace: a profiler that drops records drops these too."""
        return self.staged_copies >= 2 * self.studies

    def breakdown(self, top: int = 10) -> dict:
        ops = dict(self.kernel_s)
        if self.copy_s:
            ops["copies"] = self.copy_s
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa: E731
        return {"device_ops": [[k, v] for k, v in order(ops)],
                "idle_gaps": [[k, v] for k, v in order(self.idle_by_host)]}


def _device_work(name: str) -> bool:
    """A kernel, copy or memset record; not a synchronisation record or a
    span's shadow on the device's timeline."""
    return not ("Sync" in name or name.startswith(HARNESS_PREFIX))


def _innermost(spans: List[Tuple[int, int, str]], starts: List[int], t: int) -> Optional[str]:
    """The latest-begun span of ``spans`` (sorted by start) covering ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 64, -1), -1):
        s, e, name = spans[j]
        if e > t:
            return name
    return None


def summarize(prof, studies: int, handwritten: frozenset,
              spans: List[Tuple[int, int, str]]) -> Optional[TraceSummary]:
    """The pass's summary, or None where ``spans`` hold no pass or the
    trace no device record inside it."""
    cuda = torch.autograd.DeviceType.CUDA
    window = next(((s, e) for s, e, n in spans if n == PASS), None)
    if window is None:
        return None
    w0, w1 = window
    device: List[Tuple[int, int, str]] = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda and _device_work(ev.name()):
            s, e = ev.start_ns(), ev.end_ns()
            if e > w0 and s < w1:
                device.append((max(s, w0), min(e, w1), ev.name()))
    if not device:
        return None
    kernel_s: Dict[str, float] = {}
    copy_s = 0.0
    for s, e, n in device:
        if is_copy(n):
            copy_s += (e - s) * 1e-9
            continue
        b = base_name(n)
        kernel_s[b] = kernel_s.get(b, 0.0) + (e - s) * 1e-9

    device.sort()
    host = sorted(x for x in spans if x[2] != PASS)
    starts = [s for s, _, _ in host]
    busy, idle, cursor = 0, {}, w0

    def gap(a: int, b: int):
        if b > a:
            where = (_innermost(host, starts, a) or "portbench.loop").removeprefix(HARNESS_PREFIX)
            idle[where] = idle.get(where, 0.0) + (b - a) * 1e-9

    for s, e, _ in device:
        if s > cursor:
            gap(cursor, s)
            busy += e - s
            cursor = e
        elif e > cursor:
            busy += e - cursor
            cursor = e
    gap(cursor, w1)
    return TraceSummary(
        studies=studies, window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
        kernel_s=kernel_s, copy_s=copy_s, handwritten=handwritten, idle_by_host=idle,
        staged_copies=sum(1 for _, _, n in device if n.startswith("Memcpy HtoD")))
