"""The operator set, in PyTorch.

Counterparts of the JAX package's ``ops/`` modules, under the same module
names. The hand-written Hopper kernels and their dispatchers live in
:mod:`.hopper_median` (the median and fused preprocess kernels) and
:mod:`.hopper_region_growing` (the grow kernel); every other module is
plain PyTorch and doubles as those kernels' plain versions.
"""

from nm03_capstone_project_tpu_torch.ops.regionprops import (  # noqa: F401
    bounding_box,
    connected_components,
    region_properties,
)
