"""Dataset discovery: the cohort layout contract.

The port's copy of the JAX package's ``data/discovery.py``. Re-implements
the reference's filesystem contract (src/sequential/main_sequential.cpp:93-168, duplicated in
main_parallel.cpp:233-308 — here it exists once):

* patients are directories named ``PGBM-*`` directly under the cohort root,
  processed in sorted order;
* each patient holds series subdirectories; the *first* series is used
  (sorted order here — the reference takes filesystem iteration order, which
  is unspecified; sorting makes runs reproducible);
* slices are the ``.dcm`` files in that series, ordered by the integer
  between the last ``-`` and the ``.dcm`` suffix (``1-14.dcm`` -> 14); names
  that don't parse sort with key 1000 (the reference's sentinel,
  main_sequential.cpp:18-30).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import List

PATIENT_PREFIX = "PGBM-"
PARSE_FAILURE_KEY = 1000  # reference sentinel for unparseable names


def extract_file_number(filename: str) -> int:
    """Sort key for slice filenames, mirroring extractFileNumber.

    The integer between the final '-' and the '.dcm' extension; 1000 when the
    name doesn't follow the pattern (reference main_sequential.cpp:18-30).
    """
    m = re.match(r".*-(\d+)\.dcm$", filename)
    if m is None:
        return PARSE_FAILURE_KEY
    try:
        return int(m.group(1))
    except ValueError:  # pragma: no cover - \d+ always parses
        return PARSE_FAILURE_KEY


def find_patient_dirs(base_path: str | os.PathLike) -> List[str]:
    """Sorted patient IDs (directory names starting with ``PGBM-``)."""
    base = Path(base_path)
    if not base.is_dir():
        raise FileNotFoundError(f"cohort root does not exist: {base}")
    return sorted(
        p.name for p in base.iterdir() if p.is_dir() and p.name.startswith(PATIENT_PREFIX)
    )


def load_dicom_files_for_patient(
    base_path: str | os.PathLike, patient_id: str
) -> List[Path]:
    """Slice paths for one patient: first series dir, numerically sorted."""
    patient = Path(base_path) / patient_id
    series_dirs = sorted(p for p in patient.iterdir() if p.is_dir())
    if not series_dirs:
        raise FileNotFoundError(f"no series directories found for patient: {patient_id}")
    series = series_dirs[0]
    files = [p for p in series.iterdir() if p.suffix == ".dcm"]
    files.sort(key=lambda p: (extract_file_number(p.name), p.name))
    return files
