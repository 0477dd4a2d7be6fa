"""Wall-clock sections and the results JSON.

The port's copy of the JAX package's ``utils/timing.py::write_results_json``
and ``git_sha``. The JAX package times sections with ``obs/spans.py``'s
``SpanRecorder``, which also feeds the metrics registry; the port keeps a
plain recorder with the same ``section(name)``/``report()`` contract until
the metrics layer is ported.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_text


class SpanRecorder:
    """Named wall-clock sections, accumulated (thread-safe).

    ``section(name)`` adds the seconds spent inside it to ``sections[name]``;
    ``report()`` returns the sums.
    It measures the host's time: device work enqueued inside a section is
    charged to it only where the section waits for the result.
    """

    def __init__(self):
        self.sections: Dict[str, float] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.sections[name] = self.sections.get(name, 0.0) + dt

    def report(self) -> Dict[str, float]:
        with self._lock:
            return dict(sorted(self.sections.items()))


def git_sha() -> str:
    """Short SHA of HEAD (+ ``-dirty``) of the repo holding this package, or
    ``"unknown"`` outside a git checkout: every results file carries the
    code it measured."""
    root = Path(__file__).resolve().parents[2]
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10, cwd=root,
        ).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain"],
            capture_output=True, text=True, timeout=10, cwd=root,
        ).stdout.strip()
        return sha + ("-dirty" if dirty else "") if sha else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def write_results_json(path: str, payload: dict) -> None:
    """Write the drivers' results JSON atomically, stamped with the git SHA."""
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = {**payload, "git_sha": payload.get("git_sha", git_sha())}
    atomic_write_text(p, json.dumps(payload, indent=1, sort_keys=True) + "\n")
