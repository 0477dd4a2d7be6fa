"""Canvas padding policy.

DICOM slice sizes vary across the cohort, so every slice is padded on the
host (bottom/right, zeros) to a fixed canvas and moved to the device once.
The true dims travel with the pixels so downstream ops can mask the padding.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.core.backend import resolve_device
from nm03_capstone_project_tpu_torch.core.image import SliceBatch


def pad_to_canvas(
    arrays: Sequence[np.ndarray], canvas_hw: Tuple[int, int], device=None
) -> SliceBatch:
    """Pad host 2D arrays to a common canvas; a SliceBatch on ``device``.

    ``device`` follows :func:`core.backend.resolve_device` (CUDA unless
    ``"cpu"`` is asked for). Raises ValueError if any slice exceeds the
    canvas.
    """
    dev = resolve_device(device)
    h, w = canvas_hw
    batch = np.zeros((len(arrays), h, w), dtype=np.float32)
    dims = np.zeros((len(arrays), 2), dtype=np.int32)
    for i, a in enumerate(arrays):
        if a.ndim != 2:
            raise ValueError(f"slice {i}: expected 2D array, got shape {a.shape}")
        if a.shape[0] > h or a.shape[1] > w:
            raise ValueError(
                f"slice {i}: shape {a.shape} exceeds canvas {canvas_hw}"
            )
        batch[i, : a.shape[0], : a.shape[1]] = a.astype(np.float32)
        dims[i] = a.shape
    return SliceBatch(
        pixels=torch.from_numpy(batch).to(dev), dims=torch.from_numpy(dims).to(dev)
    )
