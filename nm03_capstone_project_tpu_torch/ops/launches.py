"""The port's kernel wrappers, by the names ``chip_smoke.py`` and PERF.md use.

Each wrapper counts its own launches in ``.launches``; the drivers'
results JSON (``kernel_launches``) and the serving graphs report them by
these names. ``median_select`` and ``grow_global`` are the routes of the
median and grow wrappers past the generated plans and past one cluster.
"""

from __future__ import annotations

from typing import Dict

from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg

KERNELS = {
    "fused": hm.fused_preprocess_kernel,
    "grow": hg.region_grow_kernel,
    "median": hm.vector_median_filter_kernel,
    "median_select": hm.vector_median_select_kernel,
    "grow_global": hg.region_grow_global_kernel,
}


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch count so far."""
    return {k: fn.launches for k, fn in KERNELS.items()}
