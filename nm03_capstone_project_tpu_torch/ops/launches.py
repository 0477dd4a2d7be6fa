"""The port's kernel wrappers, by the names ``chip_smoke.py`` and PERF.md use.

Each wrapper counts its own launches in ``.launches``; the drivers'
results JSON (``kernel_launches``) and the serving graphs report them by
these names. ``median_select`` and ``median_wide`` are the routes of the
median wrapper past the generated plans and past the select kernel's
planes, ``grow_global`` the grow wrapper's past one cluster. ``sharpen``
is the second launch of the fused wrapper's ``split`` route (the first is
the window's median route, counted under its own name). ``grow3d`` is the
3D grow kernel of the volume path, one launch a growth (the cooperative
run of every block; its pack and unpack launches beside it are not
counted). ``seeds``
(the seed and valid masks) and ``finish`` (the final dilation cut to the
true size) launch once an entry call each, before and after the growth.
"""

from __future__ import annotations

from typing import Dict

from nm03_capstone_project_tpu_torch.ops import hopper_masks as hk
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
from nm03_capstone_project_tpu_torch.ops import hopper_volume as hv

KERNELS = {
    "fused": hm.fused_preprocess_kernel,
    "grow": hg.region_grow_kernel,
    "median": hm.vector_median_filter_kernel,
    "median_select": hm.vector_median_select_kernel,
    "median_wide": hm.vector_median_wide_kernel,
    "grow_global": hg.region_grow_global_kernel,
    "sharpen": hm.sharpen_filter_kernel,
    "grow3d": hv.region_grow_3d_kernel,
    "seeds": hk.seed_valid_masks_kernel,
    "finish": hk.finish_mask_kernel,
}


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launch count so far."""
    return {k: fn.launches for k, fn in KERNELS.items()}
