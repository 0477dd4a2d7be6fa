"""Atomic artifact writes — THE tmp+rename idiom, in one place.

The port's copy of the JAX package's ``utils/atomicio.py``. Every artifact
the drivers promise to readers (results JSON, written DICOM files) is
written complete-or-not-at-all: a SIGTERM/SIGKILL/ENOSPC mid-write may
leave a stray ``<path>.tmp``, never a torn file that parses as truth.

stdlib-only by design.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from pathlib import Path


def atomic_write_bytes(path: str | os.PathLike, payload: bytes) -> None:
    """Write ``payload`` to ``path`` atomically (private tmp + os.replace).

    The tmp file comes from ``mkstemp`` in the target's directory, so two
    concurrent writers of the same artifact each write a PRIVATE temp and
    the outcome is last-complete-writer-wins — a fixed ``<path>.tmp``
    sibling would let one writer rename the other's half-written bytes
    into place (two racing synthetic-cohort generators, two runs updating
    the same results JSON).
    """
    p = Path(path)
    fd, tmp = tempfile.mkstemp(dir=p.parent, prefix=p.name + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        # mkstemp creates 0600; published artifacts should carry the same
        # umask-derived mode a plain open() would have given them
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        os.replace(tmp, p)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def atomic_write_text(path: str | os.PathLike, text: str) -> None:
    """Write ``text`` to ``path`` atomically; see :func:`atomic_write_bytes`."""
    atomic_write_bytes(path, text.encode("utf-8"))
