"""Shared CLI plumbing of the port's drivers.

The port's copy of the JAX package's ``cli/common.py``: the common,
pipeline, batch, ingest and render-stage argument groups, with the same
flag names and meanings, and the same cohort resolution. Two flags differ:

* ``--device`` takes ``cuda`` (the default) or ``cpu``; ``cuda`` without a
  GPU raises (:func:`..core.backend.resolve_device`). There is no ``auto``.
* ``--no-kernels`` (the JAX package's ``--use-pallas`` turned around: the
  port's kernels are on by default) runs the plain PyTorch ops, for a
  comparison run.

The resilience group (:func:`add_resilience_args`) gives the batch drivers
the JAX drivers' ``--retry-max``, ``--retry-backoff-s``,
``--dispatch-timeout-s`` and ``--fault-plan`` with the semantics the JAX
drivers have under ``--no-fallback-cpu``: a dispatch whose retries are
exhausted or whose deadline expires fails its slices, which are counted;
nothing is recomputed on the CPU.

The observability group (:func:`add_observability_args`) gives every
driver the JAX drivers' ``--metrics-out``, ``--log-json`` and
``--heartbeat-s`` (:func:`make_run_context` builds the run's
:class:`..obs.RunContext` from them), and ``--profile-dir`` captures a
``torch.profiler`` trace of the run (:func:`..utils.profiling.profile_trace`).

``--model`` deploys a student checkpoint written by the port's
``cli.train`` (:func:`load_model_checkpoint`, with the JAX package's three
refusals).

The distributed group (:func:`add_distributed_args`) gives the drivers
and ``cli.train`` ``--distributed`` and its three flags over ``torch.distributed``
(:mod:`..parallel.distributed`): :func:`init_distributed` joins the job,
:func:`resolve_base_path_sync` writes a synthetic cohort on rank 0 behind
a barrier, :func:`shard_patients` deals the patients round-robin and
:func:`allgather_cluster_counts` sums the counters at the end.

Flags of the JAX drivers whose layers are not ported are refused by name,
with the reason and the ROADMAP item (:data:`NOT_PORTED`), and exit 2 as
argparse does.
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


# flags of the JAX drivers whose layers the port does not have (yet), each
# with the reason it is refused, grouped as the JAX drivers take them
NOT_PORTED = {
    "observability": {
        "--sanitize": "the JAX transfer guard has no counterpart in the port",
    },
    "resilience": {
        "--fallback-cpu": "the port has no CPU fallback",
        "--no-fallback-cpu": "the port has no CPU fallback; it always fails fast",
    },
}


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        reasons = {f: r for group in NOT_PORTED.values() for f, r in group.items()}
        parser.error(f"{option_string}: {reasons[option_string]}")


def add_not_ported_args(parser: argparse.ArgumentParser, *groups: str) -> None:
    """Accept the flags of ``groups`` of :data:`NOT_PORTED` only to refuse
    them, each with its reason (exit 2), hidden from ``--help``."""
    for group in groups:
        for flag in NOT_PORTED[group]:
            parser.add_argument(flag, nargs="?", action=_NotPorted, help=argparse.SUPPRESS)


def add_observability_args(parser: argparse.ArgumentParser) -> None:
    """--metrics-out / --log-json / --heartbeat-s / --profile-dir, as every
    JAX driver takes them (``--sanitize`` stays refused:
    :func:`add_not_ported_args` with ``"observability"``)."""
    g = parser.add_argument_group("observability", "structured run telemetry")
    g.add_argument(
        "--metrics-out", default=None, metavar="JSON",
        help="write the run's metrics snapshot here (counters, gauges, "
        "per-stage latency histograms; schema nm03.metrics.v1)",
    )
    g.add_argument(
        "--log-json", default=None, metavar="JSONL",
        help="write structured JSON-lines events here (run id + git SHA on "
        "every record, one terminal outcome event per patient; schema "
        "nm03.events.v1; one run per file, truncated at start)",
    )
    g.add_argument(
        "--heartbeat-s", type=float, default=30.0, metavar="SEC",
        help="heartbeat event period for --log-json streams (uptime + live "
        "counter totals; 0 disables)",
    )
    g.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the run here (a Chrome/"
        "Perfetto JSON with the card's kernels by name)",
    )


def make_run_context(args: argparse.Namespace, driver: str, argv=None, rank: int = 0):
    """The driver's :class:`..obs.RunContext` from its parsed flags, with
    the info gauge of the median and render paths the run takes.

    Only rank 0 of a multi-process job gets the file sinks: every rank
    would otherwise write the same ``--metrics-out`` and ``--log-json``
    paths. The other ranks keep their metrics in memory."""
    from nm03_capstone_project_tpu_torch.obs import RunContext

    sink = rank == 0
    ctx = RunContext.create(
        driver,
        metrics_out=getattr(args, "metrics_out", None) if sink else None,
        log_json=getattr(args, "log_json", None) if sink else None,
        heartbeat_s=getattr(args, "heartbeat_s", 0.0) or 0.0,
        argv=argv,
    )
    if hasattr(args, "median_impl"):
        from nm03_capstone_project_tpu_torch.ops.selection_network import comparator_counts

        # the kernels run only on the card: a CPU run takes the plain ops
        # whatever --no-kernels says, and the label must say so
        ctx.record_pipeline_paths(
            median_impl=args.median_impl,
            render_fused=not getattr(args, "no_render_fuse", False),
            fuse_preprocess=not getattr(args, "no_preprocess_fuse", False),
            use_kernels=args.device == "cuda" and not getattr(args, "no_kernels", False),
            comparators=comparator_counts(args.median_window),
        )
    return ctx


def add_resilience_args(parser: argparse.ArgumentParser) -> None:
    """--retry-max / --retry-backoff-s / --dispatch-timeout-s / --fault-plan,
    as the JAX batch drivers take them (the sequential and parallel ones)."""
    from nm03_capstone_project_tpu_torch.resilience import ResilienceConfig

    d = ResilienceConfig()
    g = parser.add_argument_group("resilience", "supervised execution + chaos testing")
    g.add_argument(
        "--retry-max", type=int, default=d.retry_max,
        help="retries per transient device/export error (0 disables; a per-cause "
        "run budget caps the total)",
    )
    g.add_argument(
        "--retry-backoff-s", type=float, default=d.retry_backoff_s,
        help="initial retry backoff; doubles per attempt with deterministic jitter",
    )
    g.add_argument(
        "--dispatch-timeout-s", type=float, default=d.dispatch_timeout_s, metavar="SEC",
        help="wall-clock deadline per device dispatch (0 disables supervision). On "
        "expiry the dispatch is abandoned and its slices fail (counted); the "
        "result fetch moves inside the deadline, trading the fetch/compute "
        "overlap for wedge immunity",
    )
    g.add_argument(
        "--fault-plan", default=None, metavar="SPEC",
        help="seeded deterministic fault plan: a JSON file path or inline JSON "
        "(resilience.faultinject), also honoured from $NM03_FAULT_PLAN when the "
        "flag is unset; chaos testing only (decode, dispatch, export and ingest sites)",
    )


def resilience_config_from_args(args: argparse.Namespace):
    from nm03_capstone_project_tpu_torch.resilience import FaultPlan, ResilienceConfig

    d = ResilienceConfig()
    return ResilienceConfig(
        retry_max=getattr(args, "retry_max", d.retry_max),
        retry_backoff_s=getattr(args, "retry_backoff_s", d.retry_backoff_s),
        dispatch_timeout_s=getattr(args, "dispatch_timeout_s", d.dispatch_timeout_s),
        fault_plan=FaultPlan.from_spec(getattr(args, "fault_plan", None)),
    )


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
    add_observability_args(parser)


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
        help="plain median implementation (all give the same bits): the pruned "
        "selection network, the full odd-even merge or a sort; the kernels run "
        "their own pruned plan whatever this says",
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
        help="region-growing convergence schedule: 'dilate' (one ring a "
        "step; the grow kernel on the card) or 'jump' (pointer-jumping "
        "label merge, O(log) rounds; torch ops, no kernel)",
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


def add_model_arg(parser: argparse.ArgumentParser) -> None:
    """--model, for the drivers that can deploy a student."""
    parser.add_argument(
        "--model",
        default=None,
        metavar="CKPT",
        help="run the distilled U-Net student from this checkpoint (written "
        "by python -m nm03_capstone_project_tpu_torch.cli.train) instead of "
        "the classical pipeline: the network replaces everything downstream "
        "of normalize+clip",
    )


def load_model_checkpoint(args: argparse.Namespace, cfg, want_3d: bool = False, device=None):
    """Load + validate the --model checkpoint onto ``device``; None when the
    flag is unset. Refuses a 2D/3D mismatch, another canvas and other
    normalize/clip constants, with the JAX package's messages."""
    if not getattr(args, "model", None):
        return None
    from nm03_capstone_project_tpu_torch.models.checkpoint import load_params

    model, meta = load_params(args.model, device=device)
    meta = meta or {}
    if bool(meta.get("model_3d")) != want_3d:
        have = "3D" if meta.get("model_3d") else "2D"
        need = "3D" if want_3d else "2D"
        raise SystemExit(
            f"--model {args.model} holds the {have} student; this driver "
            f"deploys the {need} one"
        )
    ck = meta.get("canvas")
    if ck and int(ck) != cfg.canvas:
        raise SystemExit(
            f"--model was trained at canvas {ck}; pass --canvas {ck}"
        )
    # the student only works on the input distribution it was trained on:
    # normalize+clip constants are part of the model, not free flags
    want_norm = [cfg.norm_low, cfg.norm_high, cfg.norm_intensity_min, cfg.norm_intensity_max]
    want_clip = [cfg.clip_low, cfg.clip_high]
    for key, want in (("norm", want_norm), ("clip", want_clip)):
        got = meta.get(key)
        if got is not None and [float(v) for v in got] != [float(v) for v in want]:
            raise SystemExit(
                f"--model was trained with {key} constants {got}; this run "
                f"uses {want} — the student's input space must match its "
                "training (drop the conflicting flags or retrain)"
            )
    return model


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


def add_distributed_args(parser: argparse.ArgumentParser, extra_help: str = "") -> None:
    """The multi-process job flags (the drivers that take --distributed)."""
    d = parser.add_argument_group(
        "distributed",
        "multi-process cohort processing over torch.distributed: one process "
        "a device (nccl on the card, gloo with --device cpu). " + extra_help,
    )
    d.add_argument(
        "--distributed",
        action="store_true",
        help="join a torch.distributed job (reads torchrun's MASTER_ADDR/"
        "MASTER_PORT/WORLD_SIZE/RANK; pass the explicit flags elsewhere)",
    )
    d.add_argument("--coordinator-address", default=None, metavar="HOST:PORT")
    d.add_argument("--num-processes", type=int, default=None)
    d.add_argument("--process-id", type=int, default=None)


def init_distributed(args: argparse.Namespace) -> tuple[int, int]:
    """Join the job per the --distributed flags; (rank, world).

    An explicitly requested multi-process job that joined nothing is a hard
    error: every worker silently processing the whole cohort into the same
    tree is the worst failure a launcher can hand back.
    """
    if not getattr(args, "distributed", False):
        return 0, 1
    import sys

    from nm03_capstone_project_tpu_torch.parallel import distributed

    distributed.initialize(
        coordinator_address=getattr(args, "coordinator_address", None),
        num_processes=getattr(args, "num_processes", None),
        process_id=getattr(args, "process_id", None),
        device=getattr(args, "device", None),
    )
    info = distributed.process_info()
    rank, world = info["process_index"], info["process_count"]
    want = getattr(args, "num_processes", None)
    if want and want > 1 and world == 1:
        raise RuntimeError(
            f"--distributed --num-processes {want} requested but this process "
            "joined no job (world=1); check the coordinator address / "
            "process ids"
        )
    if world == 1 and not distributed.is_initialized():
        print(
            "--distributed: no cluster detected; running single-process",
            file=sys.stderr,
        )
    return rank, world


def finish_distributed(args: argparse.Namespace) -> None:
    """Leave the job that :func:`init_distributed` joined (no-op otherwise)."""
    if getattr(args, "distributed", False):
        from nm03_capstone_project_tpu_torch.parallel import distributed

        distributed.shutdown()


def resolve_base_path_sync(
    args: argparse.Namespace, rank: int, world: int, tmp_root: Path | None = None
) -> Path:
    """resolve_base_path, with rank 0 generating any synthetic cohort behind
    a barrier so other ranks never list a half-written tree."""
    if world > 1 and args.synthetic > 0:
        from nm03_capstone_project_tpu_torch.parallel import distributed

        base = None
        if rank == 0:
            base = resolve_base_path(args, tmp_root=tmp_root)
        distributed.barrier()
        if rank != 0:
            base = resolve_base_path(args, tmp_root=tmp_root)
        return base
    return resolve_base_path(args, tmp_root=tmp_root)


def shard_patients(patients: list, rank: int, world: int) -> list:
    """Deterministic round-robin patient shard (discovery sorts the list, so
    every rank computes the same split with no communication)."""
    if world <= 1:
        return patients
    mine = patients[rank::world]
    print(f"process {rank}/{world}: {len(mine)} patients assigned")
    return mine


def allgather_cluster_counts(counts: "dict[str, int]", world: int) -> dict:
    """Allgather each rank's counters; cluster totals + per-process rows.

    The one collective of a patient-sharded run (the reference's
    end-of-run accounting, main_parallel.cpp:349). Every rank must call it.
    The counters travel as int64 (voxel-level sums pass 2^31).
    """
    from nm03_capstone_project_tpu_torch.parallel import distributed

    keys = sorted(counts)
    vals = [int(counts[k]) for k in keys]
    if any(v < 0 for v in vals):
        raise ValueError(f"counters must be non-negative, got {counts}")
    per_rank = distributed.allgather(vals).reshape(world, len(keys))
    out = {k: int(per_rank[:, i].sum()) for i, k in enumerate(keys)}
    out["per_process"] = {
        str(r): {k: int(per_rank[r, i]) for i, k in enumerate(keys)}
        for r in range(world)
    }
    return out


def warn_resume_topology(out_root: Path, process_count: int, warn) -> None:
    """Warn when --resume runs under a different process count than the
    manifests on disk: the round-robin shard reassigns patients to ranks
    whose manifests never saw them, so done work is redone (correctness is
    unaffected)."""
    prior_ranks = len(list(Path(out_root).glob("manifest.rank*.json")))
    prior_single = (Path(out_root) / "manifest.json").exists()
    if process_count > 1 and (prior_single or prior_ranks not in (0, process_count)):
        warn(
            "resuming with %d processes but prior manifests suggest a "
            "different topology (%s) — patients may be reprocessed",
            process_count,
            f"{prior_ranks} rank manifests" if prior_ranks else "single-process run",
        )
    elif process_count == 1 and prior_ranks:
        warn(
            "resuming single-process over a %d-rank output tree — prior rank "
            "manifests are ignored and patients will be reprocessed",
            prior_ranks,
        )
