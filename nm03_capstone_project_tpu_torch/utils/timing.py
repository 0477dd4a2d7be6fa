"""The results JSON and the git SHA it carries.

The port's copy of the JAX package's ``utils/timing.py::write_results_json``
and ``git_sha``. Wall-clock sections are timed with
:class:`~nm03_capstone_project_tpu_torch.obs.spans.SpanRecorder`.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_text


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
