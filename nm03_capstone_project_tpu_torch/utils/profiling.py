"""In-tree profiling harness: ``torch.profiler`` captures, one at a time.

The port's counterpart of the JAX package's ``utils/profiling.py``:

* :func:`profile_trace` — capture a Chrome trace of a block into a
  directory (view it in Perfetto or ``chrome://tracing``);
* :func:`capture_profile` — the on-demand capture behind ``GET
  /debug/profile`` and the ledger's sampler: a ``duration_ms`` window of
  every thread's ops and, on a card, its kernels, returned as a zipped
  Chrome trace with the JAX package's size cap and server-side keep rule;
* :func:`exclusive_profiler` — the same one-at-a-time lock for any other
  profiled section of the process (the executor's warmup recording, a
  smoke script's timed sections).

``torch.profiler`` is process-global on a card (one CUPTI session): two
sessions at once would fail or corrupt each other, so every capture goes
through one lock and a second caller gets :class:`ProfileBusy` instead of
waiting.
"""

from __future__ import annotations

import contextlib
import threading
from pathlib import Path

from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

_log = get_logger("profiling")


class ProfileBusy(RuntimeError):
    """A capture is already in flight (the profiler is process-global)."""


# one capture at a time: the ledger sampler skips (and counts) a busy lock,
# an HTTP pull gets 409, so two captures can never race
_CAPTURE_LOCK = threading.Lock()

MIN_CAPTURE_MS = 10
MAX_CAPTURE_MS = 10_000
# past this, the zip is kept SERVER-SIDE (the response names its path and
# carries the file listing) instead of riding the wire — a remote pull
# must not OOM the replica it is debugging, but a post-mortem capture
# must never be destroyed either
MAX_ZIP_BYTES = 32 << 20
TRACE_NAME = "nm03.pt.trace.json"


@contextlib.contextmanager
def exclusive_profiler(**kwargs):
    """A started ``torch.profiler.profile`` under the capture lock; raises
    :class:`ProfileBusy` when another capture holds it.

    It records the CPU and, when there is one, the card, and the ops of
    every thread, not only the thread that starts it: the server's ops run
    on its batcher and lane threads.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not _CAPTURE_LOCK.acquire(blocking=False):
        raise ProfileBusy("a profiler capture is already in flight")
    try:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            kwargs.setdefault("experimental_config",
                              torch._C._profiler._ExperimentalConfig(profile_all_threads=True))
        except (AttributeError, TypeError):  # an older torch: this thread only
            pass
        with profile(activities=activities, **kwargs) as prof:
            yield prof
    finally:
        _CAPTURE_LOCK.release()


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """Capture a Chrome trace of the block into ``trace_dir`` (no-op when
    None), under the capture lock."""
    if not trace_dir:
        yield
        return
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    _log.info("capturing profiler trace to %s", out)
    with exclusive_profiler() as prof:
        yield
    prof.export_chrome_trace(str(out / TRACE_NAME))
    _log.info("profiler trace written to %s", out)


def capture_profile(duration_ms: int, zip_cap_bytes: int = MAX_ZIP_BYTES) -> dict:
    """On-demand profiler capture for the remote debug pull and the ledger.

    Records ``duration_ms`` (REJECTED outside [10, 10000] ms — a capture is
    a live-process intrusion, bounded by construction), exports the Chrome
    trace, zips it in memory and returns a JSON-able dict: ``{duration_ms,
    files: [{name, bytes}], zip_b64, zip_bytes}``. When the archive exceeds
    ``zip_cap_bytes`` the base64 payload is dropped (``zip_dropped: true``)
    and the archive is saved server-side under ``zip_path``. Raises
    :class:`ProfileBusy` when a capture is already running (the HTTP layer
    maps it to 409), ``ValueError`` on an out-of-bounds duration.
    """
    ms = int(duration_ms)
    if not MIN_CAPTURE_MS <= ms <= MAX_CAPTURE_MS:
        raise ValueError(
            f"profile duration must be in [{MIN_CAPTURE_MS}, {MAX_CAPTURE_MS}] ms, got {ms}"
        )
    import base64
    import io
    import os
    import shutil
    import tempfile
    import time
    import zipfile

    with exclusive_profiler() as prof:
        time.sleep(ms / 1e3)
    tmp = tempfile.mkdtemp(prefix="nm03_profile_")
    try:
        prof.export_chrome_trace(os.path.join(tmp, TRACE_NAME))
        files = []
        buf = io.BytesIO()
        with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
            for name in sorted(os.listdir(tmp)):
                full = os.path.join(tmp, name)
                files.append({"name": name, "bytes": os.path.getsize(full)})
                zf.write(full, name)
        out = {"duration_ms": ms, "files": files}
        data = buf.getvalue()
        out["zip_bytes"] = len(data)
        if len(data) <= zip_cap_bytes:
            out["zip_b64"] = base64.b64encode(data).decode("ascii")
        else:
            fd, zip_path = tempfile.mkstemp(prefix="nm03_profile_", suffix=".zip")
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            out["zip_dropped"] = True
            out["zip_path"] = zip_path
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
