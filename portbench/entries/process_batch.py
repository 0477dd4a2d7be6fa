"""A study as one ``process_batch`` call: its planes are the batch.

Each slice is grown on its own (one converged flag a slice), as the
batch drivers hand a patient's series to the card.
"""

from __future__ import annotations

import torch

from portbench import reference as ref

VOLUME = False


def stage_dims(dims, planes: int) -> torch.Tensor:
    """The (planes, 2) int32 true sizes the entry takes."""
    return torch.tensor([list(dims)] * planes, dtype=torch.int32)


def program(pipeline: dict):
    """The program's call on staged (B, H, W) pixels and (B, 2) sizes."""
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.pipeline import process_batch

    cfg = PipelineConfig(**pipeline)
    return lambda px, dims: process_batch(px, dims, cfg, device=px.device)


def reference(pipeline: dict, dtype=torch.float32):
    """The plain reference's call, intensity stages in ``dtype``."""
    return lambda px, dims: ref.process_batch(px, dims, pipeline, dtype)
