"""Build-on-first-use for the ctypes-bound host C++ layers.

The port's copy of the JAX package's ``native/buildlib.py``, used by both
shims (``csrc/host/nm03native.cpp`` via :mod:`.` and
``csrc/host/nm03gdcm.cpp`` via :mod:`..data.gdcm_fallback`): output keyed
by a source hash so edits rebuild, compiled to a process-private temp name
and published atomically so a concurrent process never CDLL-loads a
half-written library, stale builds of older source revisions pruned. Every
failure (missing toolchain, compile error, read-only build dir) is logged
and returns None; the native layer then raises, the optional GDCM shim
stays off.
"""

from __future__ import annotations

import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional, Sequence


def build_shared_library(
    src: Path,
    build_dir: Path,
    stem: str,
    extra_flags: Sequence[str],
    log: logging.Logger,
    timeout_s: float = 180.0,
    failure_level: int = logging.WARNING,
) -> Optional[Path]:
    """Compile ``src`` to ``build_dir/lib{stem}-{hash}.so``; None on failure.

    ``failure_level``: severity for build failures — WARNING for mandatory
    fast paths (a fallback exists but the operator should know), INFO for
    deliberately-optional shims whose absence is expected behavior.
    """
    try:
        if not src.exists():
            log.log(failure_level, "native source %s not found", src)
            return None
        tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
        out = build_dir / f"lib{stem}-{tag}.so"
        if out.exists():
            return out
        build_dir.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        # read-only install etc. — degrade, never crash the caller's contract
        log.info("build dir unavailable for %s: %s", stem, e)
        return None
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [
        "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
        str(src), *extra_flags, "-o", str(tmp),
    ]
    try:
        # callers hold their one-shot load lock across this build on purpose:
        # peers wait for the artifact instead of racing g++ for the same .so
        # nm03-lint: disable=NM422 callers hold their one-shot load lock across this build on purpose: peers wait for the artifact instead of racing g++ for the same .so
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s)
    except (OSError, subprocess.TimeoutExpired) as e:
        log.log(failure_level, "build of %s failed to run: %s", stem, e)
        return None
    if proc.returncode != 0:
        log.log(failure_level, "build of %s failed:\n%s", stem, proc.stderr[-2000:])
        tmp.unlink(missing_ok=True)
        return None
    try:
        os.replace(tmp, out)
        for old in build_dir.glob(f"lib{stem}-*.so"):
            if old != out:
                try:
                    old.unlink()
                except OSError:
                    pass
    except OSError as e:
        log.info("publish of %s failed: %s", stem, e)
        return None
    return out
