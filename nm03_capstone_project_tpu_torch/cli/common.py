"""Shared CLI plumbing of the port's drivers.

The port's copy of the JAX package's ``cli/common.py``: the common,
pipeline, batch, ingest and render-stage argument groups, with the same
flag names and meanings, and the same cohort resolution. Two flags differ:

* ``--device`` takes ``cuda`` (the default) or ``cpu``; ``cuda`` without a
  GPU raises (:func:`..core.backend.resolve_device`). There is no ``auto``.
* ``--no-kernels`` (the JAX package's ``--use-pallas`` turned around: the
  port's kernels are on by default) runs the plain PyTorch ops, for a
  comparison run.

Flags whose layers are not ported are not accepted: ``--model`` (the
U-Net students), ``--distributed`` and its group (multi-process cohorts),
the observability and resilience groups and ``--profile-dir``.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from nm03_capstone_project_tpu_torch.config import BatchConfig, PipelineConfig

# The reference resolves its cohort as Config::getTestDataPath() +
# "Brain-Tumor-Progression/T1-Post-Combined-P001-P020"
# (main_sequential.cpp:83-84). The env var is this framework's equivalent of
# FAST's configured test-data path.
DATA_PATH_ENV = "NM03_DATA_PATH"
DEFAULT_COHORT_SUBPATH = "Brain-Tumor-Progression/T1-Post-Combined-P001-P020"


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where the pipeline runs: the GPU (default; raises without one) "
        "or, on request, the CPU with the plain PyTorch ops",
    )


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--base-path",
        default=None,
        help="cohort root (defaults to $NM03_DATA_PATH/"
        f"{DEFAULT_COHORT_SUBPATH}); ignored with --synthetic",
    )
    parser.add_argument(
        "--synthetic",
        type=int,
        default=0,
        metavar="N",
        help="generate an N-patient synthetic cohort instead of reading real data",
    )
    parser.add_argument(
        "--synthetic-slices", type=int, default=8, help="slices per synthetic patient"
    )
    add_device_arg(parser)
    parser.add_argument("--resume", action="store_true", help="skip slices already in the manifest")
    parser.add_argument("--verbose", action="store_true", help="enable INFO logging")
    parser.add_argument(
        "--no-native",
        action="store_true",
        help="use the pure-Python decode/render path instead of the host C++ "
        "layer (csrc/host/); JPEG encoding then needs PIL",
    )
    parser.add_argument(
        "--results-json",
        default=None,
        help="write a timing/success results JSON (in-tree replacement for the "
        "reference's out-of-tree hyperfine artifacts)",
    )


def add_pipeline_args(parser: argparse.ArgumentParser) -> None:
    d = PipelineConfig()
    g = parser.add_argument_group("pipeline", "every constant the reference hard-codes")
    g.add_argument("--norm-low", type=float, default=d.norm_low)
    g.add_argument("--norm-high", type=float, default=d.norm_high)
    g.add_argument("--norm-min", type=float, default=d.norm_intensity_min)
    g.add_argument("--norm-max", type=float, default=d.norm_intensity_max)
    g.add_argument("--clip-low", type=float, default=d.clip_low)
    g.add_argument("--clip-high", type=float, default=d.clip_high)
    g.add_argument("--median-window", type=int, default=d.median_window)
    g.add_argument("--sharpen-gain", type=float, default=d.sharpen_gain)
    g.add_argument("--sharpen-sigma", type=float, default=d.sharpen_sigma)
    g.add_argument("--sharpen-kernel", type=int, default=d.sharpen_kernel)
    g.add_argument("--grow-low", type=float, default=d.grow_low)
    g.add_argument("--grow-high", type=float, default=d.grow_high)
    g.add_argument("--morph-size", type=int, default=d.morph_size)
    g.add_argument("--min-dim", type=int, default=d.min_dim)
    g.add_argument("--render-size", type=int, default=d.render_size)
    g.add_argument("--canvas", type=int, default=d.canvas)
    g.add_argument(
        "--no-kernels",
        action="store_true",
        help="run the plain PyTorch ops instead of the hand-written CUDA "
        "kernels (a comparison run; on the CPU the plain ops run anyway)",
    )
    g.add_argument(
        "--median-impl",
        choices=["pruned", "merge", "sort"],
        default=d.median_impl,
        help="median implementation; only the pruned selection network is "
        "ported (the others raise)",
    )
    g.add_argument(
        "--no-preprocess-fuse",
        action="store_true",
        help="run normalize, clip, the standalone median kernel and sharpen "
        "one after another instead of the fused preprocess kernel",
    )
    g.add_argument(
        "--no-render-fuse",
        action="store_true",
        help="render the export pair as two independent device passes "
        "instead of the fused shared-geometry pass (pixel-identical)",
    )
    g.add_argument(
        "--grow-algorithm",
        choices=["dilate", "jump"],
        default=d.grow_algorithm,
        help="2D region-growing convergence schedule; only 'dilate' is "
        "ported ('jump' raises)",
    )
    g.add_argument(
        "--grow-block-iters", type=int, default=d.grow_block_iters,
        help="dilation steps per region-growing convergence check",
    )
    g.add_argument(
        "--grow-max-iters", type=int, default=d.grow_max_iters,
        help="hard cap on region growth in one-ring dilate steps; a capped "
        "slice is counted as truncated in the summary and warned per patient",
    )


def pipeline_config_from_args(args: argparse.Namespace) -> PipelineConfig:
    return PipelineConfig(
        norm_low=args.norm_low,
        norm_high=args.norm_high,
        norm_intensity_min=args.norm_min,
        norm_intensity_max=args.norm_max,
        clip_low=args.clip_low,
        clip_high=args.clip_high,
        median_window=args.median_window,
        sharpen_gain=args.sharpen_gain,
        sharpen_sigma=args.sharpen_sigma,
        sharpen_kernel=args.sharpen_kernel,
        grow_low=args.grow_low,
        grow_high=args.grow_high,
        morph_size=args.morph_size,
        min_dim=args.min_dim,
        render_size=args.render_size,
        canvas=args.canvas,
        use_kernels=not args.no_kernels,
        median_impl=args.median_impl,
        fuse_preprocess=not args.no_preprocess_fuse,
        render_fused=not args.no_render_fuse,
        grow_algorithm=args.grow_algorithm,
        grow_block_iters=args.grow_block_iters,
        grow_max_iters=args.grow_max_iters,
    )


def add_render_stage_arg(parser: argparse.ArgumentParser) -> None:
    """--render-stage, for the drivers that export JPEG pairs."""
    parser.add_argument(
        "--render-stage",
        choices=["host", "device"],
        default=BatchConfig.render_stage,
        help="where the 512x512 export renders are computed: 'host' fetches "
        "only the mask from the device and renders in the IO pool (default), "
        "'device' renders on the card (render.render_pair)",
    )


def add_batch_args(parser: argparse.ArgumentParser) -> None:
    d = BatchConfig()
    parser.add_argument(
        "--batch-size",
        type=int,
        default=d.batch_size,
        help="slices per device batch (reference DEFAULT_BATCH_SIZE=25, "
        "main_parallel.cpp:31-33)",
    )
    parser.add_argument("--io-workers", type=int, default=d.io_workers)
    parser.add_argument("--prefetch-depth", type=int, default=d.prefetch_depth)


def add_ingest_args(parser: argparse.ArgumentParser) -> None:
    """The streaming-ingest knobs (ingest/); both batch drivers take them."""
    d = BatchConfig()
    g = parser.add_argument_group("ingest", "host->device streaming pipeline")
    g.add_argument(
        "--ingest-depth",
        type=int,
        default=d.ingest_depth,
        help="staging-ring capacity: host batches decoded ahead of the "
        "card. The backpressure bound — decode blocks when the ring is "
        "full, so host memory for staged batches is capped at roughly "
        "(ingest-depth + decode workers + prefetch-depth) batches",
    )
    g.add_argument(
        "--ingest-decode-workers",
        type=int,
        default=d.ingest_decode_workers,
        help="decode pool size for the ingest pipeline (0 = --io-workers). "
        "The same pool streams result fetch/export back while the next "
        "batch computes",
    )


def batch_config_from_args(args: argparse.Namespace) -> BatchConfig:
    """The drivers' BatchConfig; flags a driver lacks keep their defaults."""
    d = BatchConfig()
    return BatchConfig(
        batch_size=getattr(args, "batch_size", d.batch_size),
        io_workers=getattr(args, "io_workers", d.io_workers),
        prefetch_depth=getattr(args, "prefetch_depth", d.prefetch_depth),
        ingest_depth=getattr(args, "ingest_depth", d.ingest_depth),
        ingest_decode_workers=getattr(args, "ingest_decode_workers", d.ingest_decode_workers),
        use_native=not getattr(args, "no_native", False),
        render_stage=getattr(args, "render_stage", d.render_stage),
    )


def apply_native_flag(args: argparse.Namespace) -> None:
    """--no-native disables the whole host C++ layer (decode, render, encode)."""
    if getattr(args, "no_native", False):
        os.environ["NM03_NO_NATIVE"] = "1"


def resolve_base_path(args: argparse.Namespace, tmp_root: Path | None = None) -> Path:
    """Cohort root: --synthetic generates one; else --base-path or env."""
    if args.synthetic > 0:
        from nm03_capstone_project_tpu_torch.data.synthetic import write_synthetic_cohort

        # key the directory by its parameters so changing --synthetic /
        # --synthetic-slices / --canvas regenerates instead of reusing a
        # stale cohort. Slices are sized to fit the canvas: the generator's
        # 256px default under a smaller --canvas would fail the size guard
        # for every slice, a silently empty run.
        size = min(256, int(getattr(args, "canvas", 256)))
        name = f"synthetic-cohort-{args.synthetic}x{args.synthetic_slices}-{size}"
        root = (tmp_root or Path(args.output)) / name
        if not (root.exists() and any(root.iterdir())):
            write_synthetic_cohort(
                root,
                n_patients=args.synthetic,
                n_slices=args.synthetic_slices,
                height=size,
                width=size,
            )
        return root
    if args.base_path:
        return Path(args.base_path)
    env = os.environ.get(DATA_PATH_ENV)
    if env:
        return Path(env) / DEFAULT_COHORT_SUBPATH
    raise SystemExit(
        "no data: pass --base-path, set $NM03_DATA_PATH, or use --synthetic N"
    )
