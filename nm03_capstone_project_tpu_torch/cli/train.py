"""Distillation training driver for the U-Net students.

The port of the JAX package's ``nm03-train``: it reads a cohort as the
batch drivers do (the same discovery contract, the same synthetic option),
labels it by running the classical pipeline as the teacher (the fused and
grow kernels on the card), trains the 2D student (or, with ``--model-3d``,
the 3D one on volumes of ``--volume-depth`` planes), reports the student's
IoU against the teacher, and writes a checkpoint that ``--restore``
continues from, ``--eval-only`` scores and the drivers' ``--model``
deploys. Run it as

    python -m nm03_capstone_project_tpu_torch.cli.train --synthetic 4

It trains on the GPU unless ``--device cpu`` is given, in one of three
ways, as the JAX driver does:

* in a ``--distributed`` job of several processes, pure data parallelism
  (:func:`..models.fit_distributed`; the 2D student only): every rank
  loads the same cohort, labels its ``rank::world`` share of the slices,
  pads it to the size every rank agreed on and trains on it; the IoU is
  summed over the ranks, and rank 0 alone writes the checkpoint and the
  results;
* on several local devices, the 2D student data x tensor parallel over
  all of them (:func:`..models.fit_sharded`; tensor parallel 2 ways when
  their count is even), the mesh starting at ``--device``;
* otherwise on the one device (:func:`..models.fit`).

The flags, their defaults and order of checks, the results JSON's keys
and the checkpoint's ``meta.json`` keys are the JAX driver's. ``--seed``
seeds a CPU ``torch.Generator``, which gives the same weights on the card
and on the CPU but not JAX's weights.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from nm03_capstone_project_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nm03-train", description=__doc__.strip().splitlines()[0]
    )
    p.add_argument("--output", default="out-train", help="checkpoint/results root")
    # the batch drivers' flags minus the ones training has no use for
    # (--resume is the manifest's concept, --no-native the decode path's)
    p.add_argument(
        "--base-path",
        default=None,
        help="cohort root (defaults to $NM03_DATA_PATH/"
        f"{common.DEFAULT_COHORT_SUBPATH}); ignored with --synthetic",
    )
    p.add_argument(
        "--synthetic", type=int, default=0, metavar="N",
        help="generate an N-patient synthetic cohort instead of reading real data",
    )
    p.add_argument(
        "--synthetic-slices", type=int, default=8, help="slices per synthetic patient"
    )
    common.add_device_arg(p)
    p.add_argument("--verbose", action="store_true", help="enable INFO logging")
    p.add_argument(
        "--results-json", default=None, help="write a training-results JSON"
    )
    # --profile-dir captures the training loop alone, as in the JAX driver
    common.add_observability_args(p)
    common.add_pipeline_args(p)
    t = p.add_argument_group("training")
    t.add_argument("--steps", type=int, default=300)
    t.add_argument("--lr", type=float, default=3e-3)
    t.add_argument("--base-channels", type=int, default=16)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument(
        "--max-slices", type=int, default=256, help="cap on training slices loaded"
    )
    t.add_argument("--restore", default=None, help="checkpoint to continue from")
    t.add_argument(
        "--model-3d",
        action="store_true",
        help="train the volumetric U-Net (models/unet3d.py) against the 3D "
        "pipeline teacher instead of the per-slice 2D student",
    )
    t.add_argument(
        "--volume-depth", type=int, default=8,
        help="slices per training volume with --model-3d (divisible by 4; "
        "patients with fewer usable slices are skipped)",
    )
    t.add_argument(
        "--eval-only",
        action="store_true",
        help="skip training; just score --restore against the teacher",
    )
    t.add_argument(
        "--bf16", action="store_true",
        help="bfloat16 compute (the tensor cores' precision; parameters stay float32)",
    )
    common.add_not_ported_args(p, "observability")
    common.add_distributed_args(
        p, "Pure data parallelism across processes (the 2D student): each rank "
        "labels and trains on its share of the slices.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return run(args)
    except Exception as e:  # noqa: BLE001
        print(f"Fatal error: {e}", file=sys.stderr)
        return 1


def _load_cohort(args, cfg, rank: int = 0, world: int = 1):
    """(pixels, dims) float32/int32 host arrays, padded to the canvas; in a
    job every rank loads the whole cohort (rank 0 writes a synthetic one
    first)."""
    import numpy as np

    from nm03_capstone_project_tpu_torch.cli.runner import decode_and_guard
    from nm03_capstone_project_tpu_torch.data.discovery import (
        find_patient_dirs,
        load_dicom_files_for_patient,
    )

    base = common.resolve_base_path_sync(args, rank, world, tmp_root=Path(args.output))
    pixels, dims = [], []
    for patient_id in find_patient_dirs(base):
        for f in load_dicom_files_for_patient(base, patient_id):
            if len(pixels) >= args.max_slices:
                break
            # the batch drivers' containment contract: a slice that fails
            # decode or the size guards is skipped
            px = decode_and_guard(f, cfg)
            if px is None:
                continue
            h, w = px.shape
            canvas = np.zeros((cfg.canvas, cfg.canvas), np.float32)
            canvas[:h, :w] = px
            pixels.append(canvas)
            dims.append((h, w))
    if not pixels:
        raise SystemExit(f"no usable slices under {base}")
    return np.stack(pixels), np.asarray(dims, np.int32)


def _load_cohort_volumes(args, cfg):
    """(volumes, dims): (P, depth, canvas, canvas) float32 + (P, 2) int32.

    One training volume per patient: the first ``--volume-depth`` usable
    slices in anatomical order, assembled by the volume driver's loader
    and truncated to the common depth. Patients with fewer usable slices
    are skipped and counted.
    """
    import numpy as np

    from nm03_capstone_project_tpu_torch.cli.volume import _load_volume
    from nm03_capstone_project_tpu_torch.data.discovery import find_patient_dirs

    base = common.resolve_base_path(args, tmp_root=Path(args.output))
    depth = args.volume_depth
    vols, dims, skipped = [], [], 0
    for patient_id in find_patient_dirs(base):
        if len(vols) * depth >= args.max_slices:
            break
        try:
            vol, pdims, _stems, _skips = _load_volume(base, patient_id, cfg)
        except ValueError:
            skipped += 1
            continue
        if vol.shape[0] < depth:
            skipped += 1
            continue
        vols.append(vol[:depth])
        dims.append(pdims)
    if skipped:
        print(f"skipped {skipped} patients with < {depth} usable slices")
    if not vols:
        raise SystemExit(f"no patient under {base} has {depth} usable slices")
    return np.stack(vols), np.asarray(dims, np.int32)


def run(args: argparse.Namespace) -> int:
    from nm03_capstone_project_tpu_torch.utils.reporter import configure_reporting

    configure_reporting(verbose=args.verbose)
    rank, world = common.init_distributed(args)
    run_ctx = common.make_run_context(args, "train", rank=rank)
    try:
        rc = _train(args, rank, world, run_ctx)
        run_ctx.close(status="ok" if rc == 0 else "error")
        return rc
    except BaseException as e:  # SystemExit validation paths included
        run_ctx.close(status="error", error_class=type(e).__name__)
        raise
    finally:
        common.finish_distributed(args)
        common.end_sanitize(args)


def _local_mesh(device):
    """A ``('data', 'model')`` mesh of every local device, starting at
    ``device`` (tensor parallel 2 ways when their count is even), or None
    on one device."""
    from nm03_capstone_project_tpu_torch.parallel.mesh import local_devices_from, make_mesh

    devs = local_devices_from(device)
    n = len(devs)
    if n <= 1:
        return None
    tp = 2 if n % 2 == 0 else 1
    return make_mesh(n, ("data", "model"), (n // tp, tp), devices=devs)


def _train(args: argparse.Namespace, rank: int, world: int, run_ctx) -> int:
    import numpy as np
    import torch

    from nm03_capstone_project_tpu_torch.core.backend import resolve_device
    from nm03_capstone_project_tpu_torch.core.image import valid_mask
    from nm03_capstone_project_tpu_torch.models import (
        distill_batch,
        distill_volume,
        fit,
        fit_distributed,
        fit_sharded,
        init_unet,
        init_unet3d,
        pad_local_shard,
        predict_mask,
        predict_mask3d,
        prepare_student_inputs,
    )
    from nm03_capstone_project_tpu_torch.models.checkpoint import load_params, save_params
    from nm03_capstone_project_tpu_torch.obs.metrics import (
        TRAIN_FINAL_LOSS,
        TRAIN_IOU_VS_TEACHER,
    )
    from nm03_capstone_project_tpu_torch.parallel import distributed
    from nm03_capstone_project_tpu_torch.utils.profiling import profile_trace
    from nm03_capstone_project_tpu_torch.utils.timing import write_results_json

    spans = run_ctx.spans
    cfg = common.pipeline_config_from_args(args)
    if world > 1 and args.model_3d:
        raise SystemExit("--distributed training supports the 2D student only")
    # a job trains the 2D student data parallel across its ranks, a world
    # of 1 too (its collectives then run on the one card), each rank on its
    # own device: its card under NCCL, the CPU under gloo
    across_ranks = distributed.is_initialized() and not args.model_3d
    device = distributed.local_device(args.device) if across_ranks else resolve_device(args.device)
    common.sanitize_warmup(args, device)
    if cfg.canvas % 4:
        raise SystemExit("--canvas must be divisible by 4 (two U-Net poolings)")
    if args.eval_only and not args.restore:
        raise SystemExit("--eval-only needs --restore (nothing to score otherwise)")
    if args.model_3d and (args.volume_depth <= 0 or args.volume_depth % 4):
        raise SystemExit(
            "--volume-depth must be positive and divisible by 4 (two 3D poolings)"
        )
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    # restore (and model-dimension sanity) BEFORE the expensive cohort load +
    # teacher distillation: a mismatched checkpoint must fail in milliseconds
    if args.restore:
        model, meta = load_params(args.restore, device=device)
        print(f"restored checkpoint {args.restore} (meta: {meta})")
        meta = meta or {}
        if bool(meta.get("model_3d", False)) != args.model_3d:
            raise SystemExit(
                f"checkpoint {args.restore} holds a "
                f"{'3D' if meta.get('model_3d') else '2D'} model; pass "
                f"{'--model-3d' if meta.get('model_3d') else 'no --model-3d'}"
            )
    else:
        init = init_unet3d if args.model_3d else init_unet
        model = init(torch.Generator().manual_seed(args.seed), base=args.base_channels,
                     device=device)

    if args.model_3d:
        with spans.span("load_cohort"):
            volumes, dims = _load_cohort_volumes(args, cfg)
        print(
            f"cohort: {volumes.shape[0]} volumes of {args.volume_depth} x "
            f"{cfg.canvas}x{cfg.canvas}"
        )
        px = torch.from_numpy(volumes).to(device)
        dm = torch.from_numpy(dims).to(device)
        print("distilling teacher labels (volumetric pipeline)...")
        # per-volume teacher: 6-connected 3D growing + 3D morphology
        with spans.span("distill"):
            labels = torch.stack([distill_volume(v, d, cfg, device=device)
                                  for v, d in zip(px, dm)])
    else:
        with spans.span("load_cohort"):
            pixels, dims = _load_cohort(args, cfg, rank, world)
        print(f"cohort: {pixels.shape[0]} slices at {cfg.canvas}x{cfg.canvas}")
        if across_ranks:
            # every rank loaded the same cohort, so every rank raises alike:
            # a rank that raised alone would strand the others at the next
            # collective
            if pixels.shape[0] < world:
                raise SystemExit(
                    f"cohort has {pixels.shape[0]} usable slices < {world} processes "
                    "— shrink the job or grow the cohort"
                )
            # shard before distillation: the teacher is the expensive part
            pixels, dims = pixels[rank::world], dims[rank::world]
            print(f"process {rank}/{world}: {pixels.shape[0]} slices assigned")
        px = torch.from_numpy(np.ascontiguousarray(pixels)).to(device)
        dm = torch.from_numpy(np.ascontiguousarray(dims)).to(device)
        print("distilling teacher labels (classical pipeline)...")
        with spans.span("distill"):
            labels = distill_batch(px, dm, cfg, device=device)
    x = prepare_student_inputs(px, cfg)

    losses = []
    if not args.eval_only:
        mesh = None if across_ranks or args.model_3d else _local_mesh(device)
        with profile_trace(args.profile_dir), spans.span("train"):
            if across_ranks:
                # pure data parallelism across the ranks: each pads its
                # shard to the size every rank agreed on (one device a rank)
                counts = distributed.allgather([x.shape[0]])
                # nm03-lint: disable=NM321 counts is a host tensor from a gloo/NCCL all_gather read back once before training
                per_rank = int(counts.max())
                x_l, lb_l, dm_l = pad_local_shard(x, labels, dm, per_rank)
                print(f"training {args.steps} steps at lr={args.lr} over {world} "
                      f"processes x 1 device (global batch {world * per_rank})...")
                model, losses = fit_distributed(model, x_l, lb_l, dm_l, steps=args.steps,
                                                lr=args.lr, compute_dtype=dtype)
            elif mesh is not None:
                dp, tp = mesh.shape["data"], mesh.shape["model"]
                print(f"training {args.steps} steps at lr={args.lr} on {dp * tp} "
                      f"devices (dp={dp} x tp={tp})...")
                model, losses = fit_sharded(model, x, labels, dm, mesh, steps=args.steps,
                                            lr=args.lr, compute_dtype=dtype)
                # nm03-lint: disable=NM401 one-time weight placement: parameters are not the data path
                model = model.to(device)
            else:
                print(f"training {args.steps} steps at lr={args.lr}...")
                model, losses = fit(model, x, labels, dm, steps=args.steps, lr=args.lr,
                                    compute_dtype=dtype)
        if losses:
            print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    # score only where the loss trained the student: canvas padding holds
    # untrained logits and must not pollute the metric
    vmask = valid_mask(dm, cfg.canvas_hw)
    if args.model_3d:
        vmask = vmask[:, None].expand(px.shape)
        pred = predict_mask3d(model, x, dtype).bool() & vmask
    else:
        pred = predict_mask(model, x, dtype).bool() & vmask
    truth = labels.bool() & vmask
    inter = int((pred & truth).sum())
    union = int((pred | truth).sum())
    n_scored = int(pred.shape[0])
    if across_ranks:
        # each rank scored its own unpadded shard; one allgather gives the
        # cohort's IoU, which every rank agrees on
        agg = common.allgather_cluster_counts(
            {"inter": inter, "union": union, "n": n_scored}, world)
        inter, union, n_scored = agg["inter"], agg["union"], agg["n"]
    iou = inter / union if union else 1.0
    unit = "volumes" if args.model_3d else "slices"
    if rank == 0:
        print(f"student-vs-teacher IoU over {n_scored} {unit}: {iou:.3f}")
    run_ctx.registry.gauge(
        TRAIN_IOU_VS_TEACHER, help="student-vs-teacher IoU"
    ).set(iou)
    if losses:
        run_ctx.registry.gauge(
            TRAIN_FINAL_LOSS, help="last training-step loss"
        ).set(float(losses[-1]))
    run_ctx.events.emit(
        "train_scored", iou_vs_teacher=iou, n_scored=n_scored, unit=unit
    )

    if rank != 0:
        return 0  # the ranks' models are equal: rank 0 writes for the job
    ckpt = Path(args.output) / "checkpoint"
    if not args.eval_only:
        save_params(
            ckpt,
            model,
            meta={
                "base_channels": args.base_channels,
                "steps": args.steps,
                "lr": args.lr,
                "canvas": cfg.canvas,
                # the student's input space: deployment must reproduce the
                # exact normalize+clip the network was trained behind
                "norm": [
                    cfg.norm_low,
                    cfg.norm_high,
                    cfg.norm_intensity_min,
                    cfg.norm_intensity_max,
                ],
                "clip": [cfg.clip_low, cfg.clip_high],
                "model_3d": args.model_3d,
                "iou_vs_teacher": iou,
            },
        )
        print(f"checkpoint written to {ckpt}")
    if args.results_json:
        write_results_json(
            args.results_json,
            {
                unit: n_scored,
                "model": "unet3d" if args.model_3d else "unet2d",
                "steps": 0 if args.eval_only else args.steps,
                "final_loss": losses[-1] if losses else None,
                "iou_vs_teacher": iou,
                "metrics": run_ctx.metrics_snapshot(),
            },
        )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
