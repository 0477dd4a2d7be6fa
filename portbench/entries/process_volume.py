"""A study as one ``process_volume`` call: its planes are one volume.

The volume is grown as one 6-connected body (one converged flag), as the
volume CLI and the served studies hand a series to the card.
"""

from __future__ import annotations

import torch

from portbench import reference as ref

VOLUME = True


def stage_dims(dims, planes: int) -> torch.Tensor:
    """The (2,) int32 true size the entry takes."""
    return torch.tensor(list(dims), dtype=torch.int32)


def program(pipeline: dict):
    """The program's call on staged (D, H, W) pixels and (2,) sizes."""
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.pipeline import process_volume

    cfg = PipelineConfig(**pipeline)
    return lambda px, dims: process_volume(px, dims, cfg, device=px.device)


def reference(pipeline: dict, dtype=torch.float32):
    """The plain reference's call, intensity stages in ``dtype``."""
    return lambda px, dims: ref.process_volume(px, dims, pipeline, dtype)
