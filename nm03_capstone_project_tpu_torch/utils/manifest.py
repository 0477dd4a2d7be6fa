"""Output manifest + resume.

The reference has no checkpoint/resume: every rerun wipes each patient's
output directory (``rm -rf *`` in setupOutputDirectory,
main_sequential.cpp:35-37) and recomputes everything. This is the
resumable manifest the JAX package adds (its ``utils/manifest.py``, copied
here byte for byte in behaviour, so both packages write the same file): a
JSON file per output root
recording per-patient, per-slice status, written atomically after every
patient so an interrupted run restarts where it stopped (``--resume``).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

MANIFEST_NAME = "manifest.json"

STATUS_DONE = "done"
STATUS_FAILED = "failed"
# exported pair exists, but the region-growing cap truncated the mask: NOT
# "done" for --resume purposes, so a rerun with a raised --grow-max-iters
# actually recomputes it (the warning's advertised remedy)
STATUS_TRUNCATED = "truncated"


class Manifest:
    """Per-run record: {patient_id: {slice_stem: status}}."""

    def __init__(self, out_root: str | os.PathLike):
        self.path = Path(out_root) / MANIFEST_NAME
        self.data: Dict[str, Dict[str, str]] = {}

    @classmethod
    def load_or_create(cls, out_root: str | os.PathLike) -> "Manifest":
        m = cls(out_root)
        if m.path.exists():
            try:
                m.data = json.loads(m.path.read_text())
            except (json.JSONDecodeError, OSError):
                m.data = {}
        return m

    def record(self, patient_id: str, stem: str, status: str) -> None:
        self.data.setdefault(patient_id, {})[stem] = status

    def is_done(self, patient_id: str, stem: str) -> bool:
        return self.data.get(patient_id, {}).get(stem) == STATUS_DONE

    def flush(self) -> None:
        """Atomic write (tmp + rename) so a crash never corrupts the manifest."""
        self.path.parent.mkdir(parents=True, exist_ok=True)
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(self.data, indent=1, sort_keys=True))
        os.replace(tmp, self.path)
