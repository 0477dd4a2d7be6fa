"""Optional GDCM-backed fallback for JPEG 2000 transfer syntaxes.

The port's copy of the JAX package's ``data/gdcm_fallback.py``.

The in-tree importer owns every syntax the cohort uses (uncompressed LE/BE,
RLE, JPEG lossless, JPEG-LS, baseline JPEG — all with externally-produced
conformance vectors). JPEG 2000 (1.2.840.10008.1.2.4.90/.91/.92/.93) is the
one family this repo deliberately does not reimplement: its EBCOT arithmetic
coder is a multi-thousand-line codec where a from-scratch build buys no
exactness over the system libraries — the same judgment the reference makes
by sitting on DCMTK for its entire importer (FAST_directives.hpp:30).

When the system has the gdcm-3.0 development headers + libraries (as GKE
images with python3-gdcm do), ``csrc/host/nm03gdcm.cpp`` is compiled on demand
(same atomic-publish scheme as the main native layer) and ``read_dicom``
routes J2K files through it. Without GDCM the importer keeps its existing
behavior: a DicomParseError naming the transcode remedy.

``NM03_NO_GDCM=1`` disables the fallback explicitly (tests use it to pin
the rejection path on hosts where GDCM exists).

12-bit JPEG Extended (1.2.840.10008.1.2.4.51) was evaluated for the same
routing and deliberately EXCLUDED: GDCM does not round-trip its own .51
encode (every sample comes back +32768 — a signed-bias quirk in its 12-bit
DCT path), and this environment has no independent implementation to
arbitrate whether the fault is encoder- or decoder-side. A clean rejection
with a transcode remedy is safer than possibly-biased intensities.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_log = logging.getLogger("nm03_torch.gdcm")

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "host" / "nm03gdcm.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build" / "host"
_GDCM_INCLUDE = Path("/usr/include/gdcm-3.0")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False

# J2K family: lossless, lossy, and the Part-2 multi-component variants
J2K_SYNTAXES = {
    "1.2.840.10008.1.2.4.90",
    "1.2.840.10008.1.2.4.91",
    "1.2.840.10008.1.2.4.92",
    "1.2.840.10008.1.2.4.93",
}


def _compile() -> Optional[Path]:
    try:
        if not _GDCM_INCLUDE.is_dir():
            return None  # no gdcm dev files on this host
    except OSError:
        return None
    from nm03_capstone_project_tpu_torch.native.buildlib import build_shared_library

    return build_shared_library(
        _SRC, _BUILD_DIR, "nm03gdcm",
        [f"-I{_GDCM_INCLUDE}", "-lgdcmMSFF", "-lgdcmDSED", "-lgdcmCommon"],
        _log,
        failure_level=logging.INFO,  # the shim is optional by design
    )


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        if os.environ.get("NM03_NO_GDCM") == "1":
            return None
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            _log.info("gdcm fallback load failed: %s", e)
            return None
        lib.nm03_gdcm_last_error.restype = ctypes.c_char_p
        lib.nm03_gdcm_read.restype = ctypes.c_int
        lib.nm03_gdcm_read.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        _log.info("gdcm J2K fallback loaded (%s)", path.name)
        return _lib


def available() -> bool:
    """True when the GDCM shim compiled + loaded on this host."""
    return _load() is not None


# scalar-type codes the shim reports (nm03gdcm.cpp) -> numpy raw dtypes
_SCALAR_DTYPES = {
    0: np.dtype("u1"),
    1: np.dtype("i1"),
    2: np.dtype("<u2"),
    3: np.dtype("<i2"),
}


def read_j2k(path: str | os.PathLike, rows: int, cols: int):
    """Decode a JPEG 2000 DICOM file via GDCM.

    ``rows``/``cols`` come from the caller's own header parse, so the
    destination buffer is exactly sized (no fixed 64 MiB scratch) and a
    frame disagreeing with its header is rejected by the shim's cap check.
    Returns (float32 (rows, cols) rescaled pixels, raw numpy dtype).
    Raises RuntimeError when the fallback is unavailable, ValueError when
    GDCM rejects the file (both mapped to DicomParseError by the caller).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("gdcm fallback unavailable")
    buf = np.empty(rows * cols, np.float32)
    r = ctypes.c_long(0)
    c = ctypes.c_long(0)
    st = ctypes.c_int(-1)
    rc = lib.nm03_gdcm_read(
        os.fspath(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        buf.size,
        ctypes.byref(r),
        ctypes.byref(c),
        ctypes.byref(st),
    )
    if rc != 0:
        err = lib.nm03_gdcm_last_error().decode("utf-8", "replace")
        raise ValueError(f"gdcm J2K decode failed: {err}")
    if (r.value, c.value) != (rows, cols):
        raise ValueError(
            f"gdcm frame is ({r.value}, {c.value}), header says ({rows}, {cols})"
        )
    dtype = _SCALAR_DTYPES.get(st.value, np.dtype("<u2"))
    return buf.reshape(rows, cols), dtype
