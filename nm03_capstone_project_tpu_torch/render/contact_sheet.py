"""Multi-pane contact sheet — the headless MultiViewWindow.

The port's copy of the JAX package's ``render/contact_sheet.py``.

The reference's test driver shows its 5 stage renders side by side in a
blocking Qt window (``MultiViewWindow::create(5, Color::Black(), 2300, 450,
false)`` then ``run()``, src/test/test_pipeline.cpp:148-158). A batch job
has no display, so the equivalent is a composed image: every pane
resized to a square cell on a black strip, in order, one file a human can
eyeball exactly like the reference's window.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape
    ys = np.minimum((np.arange(size) * h) // size, h - 1)
    xs = np.minimum((np.arange(size) * w) // size, w - 1)
    return img[np.ix_(ys, xs)]


def contact_sheet(
    panels: Sequence[np.ndarray],
    pane_size: int = 450,
    pad: int = 10,
    background: int = 0,
    labels: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """Compose uint8 grayscale panels into one horizontal strip.

    Mirrors the reference window's geometry: N panes across (5 panes in a
    2300x450 window ≈ 450 px panes + padding). ``labels`` is only
    length-checked — captions are the caller's concern (e.g. a sidecar text
    file); passing it here keeps the two lists in sync.
    """
    if not panels:
        raise ValueError("contact_sheet needs at least one panel")
    if labels is not None and len(labels) != len(panels):
        raise ValueError(f"{len(labels)} labels for {len(panels)} panels")
    cells: List[np.ndarray] = []
    for p in panels:
        arr = np.asarray(p)
        if arr.dtype != np.uint8 or arr.ndim != 2:
            raise ValueError(
                f"panels must be uint8 (H, W), got {arr.dtype} {arr.shape}"
            )
        cells.append(_resize_nearest(arr, pane_size))
    n = len(cells)
    out = np.full(
        (pane_size + 2 * pad, n * pane_size + (n + 1) * pad),
        np.uint8(background),
        np.uint8,
    )
    for i, cell in enumerate(cells):
        x0 = pad + i * (pane_size + pad)
        out[pad : pad + pane_size, x0 : x0 + pane_size] = cell
    return out
