"""Containers, padding and device choice."""

from nm03_capstone_project_tpu_torch.core.backend import resolve_device  # noqa: F401
from nm03_capstone_project_tpu_torch.core.image import SliceBatch, valid_mask  # noqa: F401
from nm03_capstone_project_tpu_torch.core.padding import pad_to_canvas  # noqa: F401
