"""Host-side JPEG export.

The port's copy of the JAX package's ``render/export.py``, the equivalent of
FAST ``ImageFileExporter`` (reference main_sequential.cpp:61-73: two JPEGs
per slice, ``<stem>_original.jpg`` and ``<stem>_processed.jpg``). Encoding
runs on a small host thread pool that overlaps the next batch's device
compute. The resilience layer's export fault hook and retry policy ride
every export call, as in the JAX package.

Encoder preference, as in the JAX package: PIL first (libjpeg-turbo), the
host C++ encoder (:mod:`..native`) where PIL is not installed. The two give
different bytes, so a CPU comparison with the JAX package holds only where
both packages pick the same encoder (they share the order). With neither,
export raises.
"""

from __future__ import annotations

import concurrent.futures as cf
import os
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

_log = get_logger("export")


def _pil_image():
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def jpeg_encoder() -> str:
    """Which encoder :func:`encode_jpeg_bytes` uses here: ``"PIL"`` or
    ``"native"``. Raises RuntimeError when neither is available."""
    from nm03_capstone_project_tpu_torch import native

    if _pil_image() is not None:
        return "PIL"
    if native.available():
        return "native"
    raise RuntimeError(
        "no JPEG encoder available: PIL is not installed and the native "
        "layer is disabled (NM03_NO_NATIVE=1)"
    )


def save_jpeg(image: np.ndarray, path: str | os.PathLike, quality: int = 90) -> None:
    """Write a uint8 grayscale (H, W) array as JPEG, atomically.

    Atomic tmp+rename (the crash-safe resume contract): a SIGTERM/kill/
    ENOSPC mid-encode can leave a stray ``.jpg.tmp`` but never a torn
    ``.jpg``, so ``--resume`` may trust every final-named file on disk.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    try:
        tmp.write_bytes(encode_jpeg_bytes(image, quality))
        os.replace(tmp, path)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise


def encode_jpeg_bytes(image: np.ndarray, quality: int = 90) -> bytes:
    """Encode a uint8 grayscale (H, W) array to JPEG bytes, in memory
    (the encoder :func:`jpeg_encoder` names)."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f"expected uint8 image, got {arr.dtype}")
    Image = _pil_image()
    if Image is not None:
        import io

        buf = io.BytesIO()
        Image.fromarray(arr, mode="L").save(buf, format="JPEG", quality=quality)
        return buf.getvalue()
    from nm03_capstone_project_tpu_torch import native

    if arr.ndim != 2 or not native.available():
        raise RuntimeError(
            "no JPEG encoder available (PIL missing, native layer disabled)"
        )
    return bytes(native.encode_jpeg_gray(arr, quality))


def _write_pair(out: Path, stem: str, orig: np.ndarray, proc: np.ndarray) -> str:
    save_jpeg(orig, out / f"{stem}_original.jpg")
    save_jpeg(proc, out / f"{stem}_processed.jpg")
    return stem


def _export_many(
    write_one,
    items: Sequence,
    out_dir,
    max_workers: int,
    fault_hook=None,
    retry=None,
    success_hook=None,
) -> List[str]:
    """Concurrent per-slice export with containment; the shared scaffold.

    ``write_one(item) -> stem`` runs per slice on a thread pool; failures are
    contained and logged per slice (the reference's catch-and-continue at the
    export stage, main_sequential.cpp:267-271). Returns sorted stems written.

    ``fault_hook(stem)`` is the chaos-injection point (resilience.FaultPlan):
    called before each slice writes, it may raise to simulate an export I/O
    failure. ``retry`` (a resilience.RetryPolicy) retries OSError-class
    write failures — the transient-disk case — before declaring the slice
    failed; injected faults are OSErrors too, so persistent fault rules
    exercise the retry path on their way to a contained failure.
    ``success_hook(stem)`` fires the moment a slice's pair is on disk (the
    journal's per-slice hook); its own failures are contained (a journaling
    error must not un-succeed a written slice).
    """
    Path(out_dir).mkdir(parents=True, exist_ok=True)

    def attempt(item):
        # the hook fires per ATTEMPT, inside the retry: a count-limited
        # fault rule models a transient disk error (healed by retry), an
        # unlimited rule a persistent one (retries exhaust, slice fails)
        if fault_hook is not None:
            fault_hook(item[0])
        return write_one(item)

    def one(item):
        if retry is not None:
            stem = retry.call(attempt, item, cause="export", retryable=(OSError,))
        else:
            stem = attempt(item)
        if success_hook is not None:
            try:
                success_hook(stem)
            except Exception as e:  # noqa: BLE001 — journal must not cost a slice
                _log.warning("export success hook failed for %s: %s", stem, e)
        return stem

    done: List[str] = []
    with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {pool.submit(one, item): item[0] for item in items}
        for fut in cf.as_completed(futures):
            try:
                done.append(fut.result())
            except Exception as e:  # noqa: BLE001 - per-slice containment
                _log.warning("export failed for %s: %s", futures[fut], e)
    return sorted(done)


def export_pairs(
    items: Sequence[Tuple[str, np.ndarray, np.ndarray]],
    out_dir: str | os.PathLike,
    max_workers: int = 8,
    fault_hook=None,
    retry=None,
    success_hook=None,
) -> List[str]:
    """Write (stem, original, processed) triples as JPEG pairs concurrently."""
    out = Path(out_dir)
    return _export_many(
        lambda it: _write_pair(out, it[0], it[1], it[2]),
        items, out, max_workers, fault_hook=fault_hook, retry=retry,
        success_hook=success_hook,
    )


def render_export_pairs(
    items: Sequence[Tuple[str, np.ndarray, np.ndarray, np.ndarray]],
    out_dir: str | os.PathLike,
    cfg,
    max_workers: int = 8,
    fault_hook=None,
    retry=None,
    success_hook=None,
) -> List[str]:
    """Render host-side, then write the JPEG pair, per (stem, pixels, mask, dims).

    The batch drivers' default export path: only the mask crossed back from
    the device; the 512x512 renders are computed here, in the thread pool
    that JPEG-encodes them, overlapped with the next batch's device compute.
    The C++ renderer (byte-identical to :func:`..host_render.host_render_pair`)
    releases the GIL, so the pool overlaps on a multi-core host; with the
    native layer disabled the NumPy renderer runs.
    """
    from nm03_capstone_project_tpu_torch import native
    from nm03_capstone_project_tpu_torch.render.host_render import host_render_pair

    out = Path(out_dir)
    use_native = native.available()

    def write_one(item):
        stem, pixels, mask, dims = item
        if use_native:
            gray, seg = native.render_pair_native(pixels, mask, dims, cfg)
        else:
            gray, seg = host_render_pair(pixels, mask, dims, cfg)
        return _write_pair(out, stem, gray, seg)

    return _export_many(write_one, items, out, max_workers, fault_hook=fault_hook,
                        retry=retry, success_hook=success_hook)


def clean_directory(path: str | os.PathLike) -> None:
    """Recreate a directory empty.

    The reference does ``mkdir -p X && cd X && rm -rf *`` via system()
    (main_sequential.cpp:32-47); this is the same destructive clean-recreate
    without a shell.
    """
    import shutil

    p = Path(path)
    if p.exists():
        shutil.rmtree(p)
    p.mkdir(parents=True, exist_ok=True)
