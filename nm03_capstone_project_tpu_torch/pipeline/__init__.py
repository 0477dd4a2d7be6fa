"""The 2D slice pipeline."""

from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import (  # noqa: F401
    check_min_dims,
    preprocess,
    process_batch,
    process_slice,
    process_slice_stages,
    segment,
)
