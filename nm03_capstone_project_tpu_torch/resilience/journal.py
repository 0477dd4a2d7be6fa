"""Per-patient journal of completed stems: crash-safe resume at slice grain.

The manifest (utils/manifest.py) flushes once per *patient*, so a SIGTERM /
kill / wedge mid-patient forgets every slice the interrupted patient already
exported and ``--resume`` redoes them. The journal closes that window: one
append-only JSON-lines file per patient directory, one line per completed
slice, written (and flushed to the OS) the moment the slice's JPEG pair is
verified on disk. On ``--resume`` the driver folds the journal back into the
manifest before computing the todo list.

Crash-safety properties:

* append-only writes of single short lines — a crash can at worst tear the
  FINAL line, which :meth:`entries` skips (every completed line is intact);
* lives inside the patient's output directory, so the fresh-run
  ``clean_directory`` wipe resets it together with the outputs it indexes;
* thread-safe — the parallel driver journals from IO-pool export threads.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Dict

JOURNAL_NAME = "slices.journal"


class PatientJournal:
    """Append-only ``{stem, status}`` JSONL record for one patient dir."""

    def __init__(self, patient_dir: str | os.PathLike):
        self.path = Path(patient_dir) / JOURNAL_NAME
        self._lock = threading.Lock()
        self._fh = None

    def record(self, stem: str, status: str) -> None:
        """Append one completion record and flush it to the OS."""
        line = json.dumps({"stem": str(stem), "status": str(status)}) + "\n"
        with self._lock:
            if self._fh is None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(line)
            self._fh.flush()

    def entries(self) -> Dict[str, str]:
        """Replay the journal: {stem: last status}. Torn/corrupt lines (the
        one a crash can leave unfinished) are skipped, not fatal."""
        out: Dict[str, str] = {}
        try:
            with open(self.path) as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail line from a crash mid-write
                    if isinstance(rec, dict) and "stem" in rec and "status" in rec:
                        out[str(rec["stem"])] = str(rec["status"])
        except OSError:
            return {}
        return out

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                finally:
                    self._fh = None
