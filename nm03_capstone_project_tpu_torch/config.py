"""Typed configuration covering every constant the reference hard-codes.

The port's own copy of the JAX package's ``config.py``: the same field
names and defaults, so a configuration carries across unchanged
(:func:`nm03_capstone_project_tpu_torch.convert.config_from_jax` and
:func:`~nm03_capstone_project_tpu_torch.convert.batch_config_from_jax`).
:class:`BatchConfig` is copied as it is; :class:`PipelineConfig` has three
differences:

* ``use_pallas`` is ``use_kernels`` and defaults to True: on a CUDA tensor
  the hot ops run the hand-written Hopper kernels (``csrc/``); on a CPU
  tensor they run their plain PyTorch versions.
* ``grow_algorithm="jump"`` raises ``NotImplementedError`` (the
  pointer-jumping fill is not ported yet).
* ``median_impl`` other than ``"pruned"`` raises ``NotImplementedError``
  (the merge and sort comparison medians are not ported yet).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# slices per batch: the reference's "maximum number of slices per patient"
# (src/parallel/main_parallel.cpp:31-33), the JAX BatchConfig.batch_size
DEFAULT_BATCH_SIZE = 25


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Hyper-parameters of the 5-stage segmentation pipeline.

    Defaults reproduce the reference's behavioral contract exactly.
    """

    # -- Intensity normalization -------------------------------------------
    # reference: IntensityNormalization::create(0.5f, 2.5f, 0.0f, 10000.0f)
    # (src/test/test_pipeline.cpp:55, src/sequential/main_sequential.cpp:195-196)
    norm_low: float = 0.5
    norm_high: float = 2.5
    norm_intensity_min: float = 0.0
    norm_intensity_max: float = 10000.0

    # -- Intensity clipping -------------------------------------------------
    # reference: IntensityClipping::create(0.68f, 4000.0f)
    # (src/test/test_pipeline.cpp:60, main_sequential.cpp:200)
    clip_low: float = 0.68
    clip_high: float = 4000.0

    # -- Vector median filter -----------------------------------------------
    # reference: VectorMedianFilter::create(7) (test_pipeline.cpp:65-66)
    median_window: int = 7

    # -- Unsharp sharpening --------------------------------------------------
    # reference: ImageSharpening::create(2.0f, 0.5f, 9) (test_pipeline.cpp:71)
    sharpen_gain: float = 2.0
    sharpen_sigma: float = 0.5
    sharpen_kernel: int = 9

    # -- Seeded region growing ----------------------------------------------
    # reference: SeededRegionGrowing::create(0.74f, 0.91f, seeds)
    # (test_pipeline.cpp:98, main_sequential.cpp:232-233)
    grow_low: float = 0.74
    grow_high: float = 0.91

    # -- Morphology -----------------------------------------------------------
    # reference: Dilation::create(3) / Erosion::create(3)
    # (test_pipeline.cpp:119-125, main_sequential.cpp:250)
    morph_size: int = 3

    # -- Guards ---------------------------------------------------------------
    # reference: width/height < 100 -> exception (main_sequential.cpp:189-192)
    min_dim: int = 100

    # -- Render / export -------------------------------------------------------
    # reference: RenderToImage::create(Color::Black(), 512, 512)
    # (test_pipeline.cpp:164, main_sequential.cpp:258); SegmentationRenderer
    # (labelColors={1: White}, opacity 0.6, borderOpacity 1.0, borderRadius 2)
    # (test_pipeline.cpp:136-146)
    render_size: int = 512
    overlay_opacity: float = 0.6
    overlay_border_opacity: float = 1.0
    overlay_border_radius: int = 2

    # -- Compute policy (no reference equivalent) ------------------------------
    # Canvas the variable-size DICOM slices are padded to, so one batch holds
    # slices of every size.
    canvas: int = 256
    # Region-growing fixpoint: dilations per convergence check and a hard cap.
    grow_block_iters: int = 16
    grow_max_iters: int = 1024
    # Convergence schedule of the 2D fill: "dilate" = one ring per step
    # (sequential depth = region diameter, truncated at grow_max_iters).
    # "jump" (pointer-jumping label merge) is not ported yet.
    grow_algorithm: str = "dilate"
    # Run the hot ops through the hand-written CUDA kernels on a CUDA
    # tensor (ops.hopper_median, ops.hopper_region_growing). A CPU tensor
    # always takes the plain PyTorch versions.
    use_kernels: bool = True
    # Median implementation: only 'pruned' (the liveness-pruned selection
    # network of ops.selection_network) is ported.
    median_impl: str = "pruned"
    # Fuse normalize->clip->median->sharpen into one kernel (one read and
    # one write of the image); False runs the stages one after another,
    # with the standalone median kernel.
    fuse_preprocess: bool = True
    # Fused device render (not ported yet; carried so configurations
    # round-trip).
    render_fused: bool = True

    def __post_init__(self):
        if self.median_window < 1 or self.median_window % 2 == 0:
            raise ValueError(
                f"median_window must be odd and >= 1, got {self.median_window}"
            )
        if self.sharpen_kernel < 1 or self.sharpen_kernel % 2 == 0:
            raise ValueError(
                f"sharpen_kernel must be odd and >= 1, got {self.sharpen_kernel}"
            )
        if self.morph_size < 1 or self.morph_size % 2 == 0:
            raise ValueError(
                f"morph_size must be odd and >= 1, got {self.morph_size}"
            )
        if not self.grow_low <= self.grow_high:
            raise ValueError(
                f"grow band is empty: [{self.grow_low}, {self.grow_high}]"
            )
        if self.canvas < 1:
            raise ValueError(f"canvas must be positive, got {self.canvas}")
        if self.grow_block_iters < 1 or self.grow_max_iters < 1:
            raise ValueError("grow iteration counts must be positive")
        if self.grow_algorithm not in ("dilate", "jump"):
            raise ValueError(
                f"grow_algorithm must be 'dilate' or 'jump', got "
                f"{self.grow_algorithm!r}"
            )
        if self.grow_algorithm == "jump":
            raise NotImplementedError(
                "grow_algorithm='jump' is not ported yet; use 'dilate'"
            )
        if self.median_impl not in ("pruned", "merge", "sort"):
            raise ValueError(
                f"median_impl must be 'pruned', 'merge' or 'sort', got "
                f"{self.median_impl!r}"
            )
        if self.median_impl != "pruned":
            raise NotImplementedError(
                f"median_impl={self.median_impl!r} is not ported yet; use 'pruned'"
            )

    @property
    def canvas_hw(self) -> Tuple[int, int]:
        return (self.canvas, self.canvas)


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Batch-orchestration knobs of the drivers.

    The reference fixes DEFAULT_BATCH_SIZE = 25 ("maximum number of slices
    per patient", src/parallel/main_parallel.cpp:31-33) and 16 OpenMP
    threads (main_parallel.cpp:401). Here the batch is the leading axis of
    the tensors the kernels take.
    """

    batch_size: int = DEFAULT_BATCH_SIZE
    prefetch_depth: int = 2  # staged (device-side) lookahead: double buffering
    io_workers: int = 8  # DICOM decode thread pool
    # streaming ingest (ingest/): ring capacity in host batches decoded
    # ahead of the card — the backpressure bound (decode can never outrun
    # the device by more than ingest_depth + in-flight decodes +
    # prefetch_depth batches)
    ingest_depth: int = 3
    # decode pool size for the ingest pipeline; 0 = use io_workers
    ingest_decode_workers: int = 0
    use_native: bool = True  # C++ batch decoder (csrc/host/)
    # 'host': the device returns only the mask (65 KB/slice) and the
    # 512x512 export renders are computed host-side in the IO pool (the
    # default). 'device': render on the card (render.render_pair).
    render_stage: str = "host"

    def __post_init__(self):
        if self.render_stage not in ("host", "device"):
            raise ValueError(
                f"render_stage must be 'host' or 'device', got {self.render_stage!r}"
            )
        if self.ingest_depth < 1:
            raise ValueError(
                f"ingest_depth must be >= 1, got {self.ingest_depth}"
            )
        if self.ingest_decode_workers < 0:
            raise ValueError(
                f"ingest_decode_workers must be >= 0 (0 = io_workers), "
                f"got {self.ingest_decode_workers}"
            )


DEFAULT_CONFIG = PipelineConfig()
DEFAULT_BATCH = BatchConfig()
