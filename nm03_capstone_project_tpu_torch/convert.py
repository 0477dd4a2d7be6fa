"""Carry the reference's parameters across to the port.

The 2D pipeline has no learned weights: its state is the configuration and
the gaussian taps it derives (``ops.sharpen.gaussian_kernel_1d``). A JAX
``PipelineConfig`` or ``BatchConfig`` is handed over as the plain dict of
``dataclasses.asdict``, so this module needs nothing of the JAX package.
"""

from __future__ import annotations

from typing import Any, Dict

from nm03_capstone_project_tpu_torch.config import BatchConfig, PipelineConfig


def config_from_jax(d: Dict[str, Any]) -> PipelineConfig:
    """The port's :class:`PipelineConfig` for a JAX config's ``asdict``.

    ``use_pallas`` becomes ``use_kernels``; every other field keeps its name.
    An unknown key raises ``TypeError``, so a field added on one side only
    is caught rather than dropped.
    """
    fields = dict(d)
    if "use_pallas" in fields:
        fields["use_kernels"] = bool(fields.pop("use_pallas"))
    return PipelineConfig(**fields)


def batch_config_from_jax(d: Dict[str, Any]) -> BatchConfig:
    """The port's :class:`BatchConfig` for a JAX ``BatchConfig``'s ``asdict``:
    every field keeps its name; an unknown key raises ``TypeError``."""
    return BatchConfig(**d)
