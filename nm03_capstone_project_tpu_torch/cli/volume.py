"""Volumetric batch driver: one 3D segmentation per patient series.

The port of the JAX package's ``nm03-volume`` (BASELINE.json config 4):
each patient's series is stacked into a (D, H, W) volume and goes through
:func:`..pipeline.volume_pipeline.process_volume`, whose preprocessing is
one launch of the fused preprocess kernel over the D planes on the card
and whose region growing and dilation run with true 3D connectivity (one
6-connected lesion body across slices). Run it as

    python -m nm03_capstone_project_tpu_torch.cli.volume --synthetic 20 --synthetic-slices 25

It runs on the GPU unless ``--device cpu`` is given. Outputs keep the batch
drivers' contract (a JPEG pair a plane, the manifest with ``truncated``
for a capped fixpoint, ``--resume``, catch-and-continue per patient) plus
``--export-mhd``: each patient's 3D mask as MetaImage (``mask.mhd`` with
``.raw``, or ``.zraw`` under ``--mhd-compressed``).

``--model`` deploys a 3D student written by ``cli.train --model-3d``: each
volume's depth is padded to the student's pooling multiple, the student
replaces everything after normalize+clip, and the mask is cropped back.

The telemetry flags are the JAX driver's: ``--metrics-out``,
``--log-json`` (one ``patient_outcome`` a patient, a ``grow_truncated``
record a capped volume), ``--heartbeat-s`` and ``--profile-dir``; the
results JSON carries the run's ``metrics`` snapshot.

``--z-shard`` on one device is ignored with the JAX driver's message; with
more than one visible device it is refused (the z-sharded decomposition
is not ported yet), and with ``--model`` it is refused as the JAX driver
refuses it. ``--distributed`` is refused with its reason.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from nm03_capstone_project_tpu_torch.cli import common

ZSHARD_REFUSAL = "z-sharding is not ported yet (ROADMAP A6)"
MODEL_ZSHARD_REFUSAL = (
    "--model with --z-shard is unsupported: the 3D student runs whole volumes "
    "(drop --z-shard)"
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nm03-volume", description=__doc__.strip().splitlines()[0]
    )
    p.add_argument("--output", default="out-volume", help="output root directory")
    common.add_common_args(p)
    common.add_pipeline_args(p)
    p.add_argument(
        "--z-shard",
        action="store_true",
        help="shard each volume along z across devices; ignored on one device, "
        f"refused on several ({ZSHARD_REFUSAL})",
    )
    p.add_argument(
        "--export-mhd",
        action="store_true",
        help="also write each patient's 3D mask as MetaImage (<patient>/mask.mhd)",
    )
    p.add_argument(
        "--mhd-compressed",
        action="store_true",
        help="zlib-compress the MetaImage pixel payload (.zraw); binary masks "
        "compress ~100x",
    )
    common.add_render_stage_arg(p)
    common.add_model_arg(p)
    common.add_not_ported_args(p, "observability", "distributed")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return run(args)
    except Exception as e:  # noqa: BLE001 - reference: fatal-error catch in main
        print(f"Fatal error: {e}", file=sys.stderr)
        return 1


def _file_sources(f, cfg):
    """[(stem, guarded-pixels-or-None)] for one series file, frames expanded.

    Real archives store series both ways: one file per slice, and
    multi-frame files (NumberOfFrames > 1) whose frames are z-planes. Every
    file expands through :func:`..data.dicomlite.read_dicom_frames`: a
    single-frame file yields its one slice under the plain file stem, a
    multi-frame file yields ``<stem>_fNNN`` per frame, and a frame whose
    decode fails is contained to that frame.
    """
    from nm03_capstone_project_tpu_torch.cli.runner import guard_pixels, log
    from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom_frames

    try:
        slices = read_dicom_frames(f, strict=False)
    except Exception as e:  # noqa: BLE001 - per-file containment
        log.warning("failed to read %s: %s", f.name, e)
        return [(f.stem, None)]
    if len(slices) == 1:
        s = slices[0]
        if isinstance(s, Exception):
            log.warning("failed to read %s: %s", f.name, s)
            return [(f.stem, None)]
        return [(f.stem, guard_pixels(s.pixels, f.name, cfg))]
    out = []
    for k, s in enumerate(slices):
        stem = f"{f.stem}_f{k:03d}"
        if isinstance(s, Exception):
            log.warning("skipping frame %d of %s: %s", k, f.name, s)
            out.append((stem, None))
        else:
            out.append((stem, guard_pixels(s.pixels, stem, cfg)))
    return out


def _load_volume(base, patient_id, cfg):
    """Stack one patient's series onto the canvas; (volume, dims, stems, skipped).

    The per-slice guards are the batch drivers' (``runner.guard_pixels``);
    the volume driver adds the series-uniformity check: a volume needs all
    slices at one in-plane size, and a slice of another size is skipped.
    """
    import numpy as np

    from nm03_capstone_project_tpu_torch.data.discovery import load_dicom_files_for_patient

    files = load_dicom_files_for_patient(base, patient_id)
    # one file's frames at a time: the decoded series and the canvas stack
    # are never both held whole
    sources = (sf for f in files for sf in _file_sources(f, cfg))

    planes, stems, skipped, hw = [], [], [], None
    for stem, px in sources:
        if px is None:
            skipped.append(stem)
            continue
        h, w = px.shape
        if hw is None:
            hw = (h, w)
        elif (h, w) != hw:
            print(
                f"  skipping {stem}: {w}x{h} != series {hw[1]}x{hw[0]}",
                file=sys.stderr,
            )
            skipped.append(stem)
            continue
        canvas = np.zeros((cfg.canvas, cfg.canvas), np.float32)
        canvas[:h, :w] = px
        planes.append(canvas)
        stems.append(stem)
    if not planes:
        raise ValueError(f"no usable slices for {patient_id}")
    return np.stack(planes), np.asarray(hw, np.int32), stems, skipped


def _make_student_volume_fn(model, cfg):
    """The 3D student standing in for ``process_volume``: (D, H, W) volume,
    (2,) dims -> (D, H, W) uint8 mask. Depth is padded with zero planes to
    the student's pooling multiple and the mask cropped back; the rest is
    the 2D drivers' :func:`..cli.runner._student_batch_mask` on a batch of
    one volume."""
    import torch.nn.functional as F

    from nm03_capstone_project_tpu_torch.cli.runner import _student_batch_mask

    multiple = 2**model.levels  # one halving a level

    def f(vol, dims):
        depth = vol.shape[0]
        vp = F.pad(vol, (0, 0, 0, 0, 0, (-depth) % multiple))
        return _student_batch_mask(model, vp[None], dims[None], cfg)[0, :depth]

    return f


def run(args: argparse.Namespace) -> int:
    """The volume cohort loop; 0 when every patient is ok, else 1."""
    run_ctx = common.make_run_context(args, "volume")
    try:
        rc = _run_inner(args, run_ctx)
    except BaseException as e:
        run_ctx.close(status="error", error_class=type(e).__name__)
        raise
    run_ctx.close(status="error")  # a no-op unless a refusal returned early
    return rc


def _run_inner(args: argparse.Namespace, run_ctx) -> int:
    import torch

    from nm03_capstone_project_tpu_torch.cli.runner import device_label
    from nm03_capstone_project_tpu_torch.core.backend import resolve_device
    from nm03_capstone_project_tpu_torch.data.discovery import (
        find_patient_dirs,
        load_dicom_files_for_patient,
    )
    from nm03_capstone_project_tpu_torch.data.imageio import write_metaimage
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
    from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
    from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import process_volume
    from nm03_capstone_project_tpu_torch.render.export import (
        clean_directory,
        export_pairs,
        render_export_pairs,
    )
    from nm03_capstone_project_tpu_torch.render.render import render_pair
    from nm03_capstone_project_tpu_torch.utils.manifest import (
        STATUS_DONE,
        STATUS_FAILED,
        STATUS_TRUNCATED,
        Manifest,
    )
    from nm03_capstone_project_tpu_torch.utils.profiling import profile_trace
    from nm03_capstone_project_tpu_torch.utils.reporter import configure_reporting
    from nm03_capstone_project_tpu_torch.utils.timing import write_results_json

    configure_reporting(verbose=args.verbose)
    common.apply_native_flag(args)
    device = resolve_device(args.device)
    cfg = common.pipeline_config_from_args(args)
    model = common.load_model_checkpoint(args, cfg, want_3d=True, device=device)
    if model is not None and args.z_shard:
        raise SystemExit(MODEL_ZSHARD_REFUSAL)
    student_fn = None if model is None else _make_student_volume_fn(model, cfg)
    if args.z_shard:
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        if n_dev > 1:
            # never one device quietly where the user asked for a mesh
            print(f"--z-shard refused: {n_dev} devices visible; {ZSHARD_REFUSAL}",
                  file=sys.stderr)
            return 2
        print("--z-shard ignored: single device", file=sys.stderr)
    kernels = {
        "fused": hm.fused_preprocess_kernel,
        "grow": hg.region_grow_kernel,
        "median": hm.vector_median_filter_kernel,
    }
    before = {k: fn.launches for k, fn in kernels.items()}

    out_root = Path(args.output)
    base = common.resolve_base_path(args, tmp_root=out_root)
    manifest = Manifest.load_or_create(out_root) if args.resume else Manifest(out_root)
    host_render = args.render_stage == "host"
    # the context's span recorder: the results JSON's timings and the
    # stage latency histograms
    timer = run_ctx.spans

    def emit_outcome(pid, status, **fields):
        """Guarded terminal telemetry: a telemetry failure must never
        reclassify or fail a patient."""
        try:
            if not run_ctx.has_outcome(pid):
                run_ctx.patient_outcome(pid, status, **fields)
        except Exception as e:  # noqa: BLE001 — telemetry never costs a run
            print(f"warning: patient {pid}: outcome telemetry failed: {e}", file=sys.stderr)

    patients = find_patient_dirs(base)
    print(f"=== Volumetric processing: {len(patients)} patients ===")

    t0 = time.perf_counter()
    ok_patients, results = 0, {}
    truncated_patients: list = []
    with profile_trace(args.profile_dir):
        for pid in patients:
            try:
                if args.resume:
                    # the listing alone decides that a patient was fully visited
                    listed = [f.stem for f in load_dicom_files_for_patient(base, pid)]
                    if listed and manifest.patient_accounted(pid, listed):
                        print(f"Patient {pid}: already complete, skipping")
                        ok_patients += 1
                        emit_outcome(pid, "ok", skipped=True)
                        continue
                with timer.section(f"load/{pid}"):
                    vol, dims, stems, skipped = _load_volume(base, pid, cfg)
                for stem in skipped:
                    # load-time rejects, recorded so --resume can account for them
                    manifest.record(pid, stem, STATUS_FAILED)
                depth = vol.shape[0]
                with timer.section(f"compute/{pid}"):
                    px = torch.from_numpy(vol).to(device)
                    dm = torch.from_numpy(dims).to(device)
                    if student_fn is not None:
                        mask_t, conv = student_fn(px, dm), True  # no growing fixpoint
                    else:
                        out = process_volume(px, dm, cfg, device=device)
                        mask_t, conv = out["mask"], bool(out["grow_converged"])
                    mask = mask_t.cpu().numpy()  # waits for the card
                    gray = seg = None
                    if not host_render:
                        g, s = render_pair(px, mask_t, dm.expand(depth, 2), cfg)
                        gray, seg = g.cpu().numpy(), s.cpu().numpy()
                if not conv:
                    truncated_patients.append(pid)
                    print(
                        f"WARNING: patient {pid}: region growing hit its "
                        "iteration cap; the 3D mask under-covers "
                        "(raise --grow-max-iters)",
                        file=sys.stderr,
                    )
                    try:  # count=1: the whole volume's fixpoint truncated
                        run_ctx.grow_truncated(pid, count=1, scope="volume")
                    except Exception as e:  # noqa: BLE001 — telemetry never costs a run
                        print(f"warning: patient {pid}: truncation telemetry failed: {e}",
                              file=sys.stderr)
                with timer.section(f"export/{pid}"):
                    if not args.resume:
                        clean_directory(out_root / pid)
                    if host_render:
                        done = render_export_pairs(
                            [(stems[i], vol[i], mask[i], dims) for i in range(depth)],
                            out_root / pid,
                            cfg,
                        )
                    else:
                        done = export_pairs(
                            [(stems[i], gray[i], seg[i]) for i in range(depth)],
                            out_root / pid,
                        )
                    # a cap-truncated volume's pairs exist but the mask
                    # under-covers: TRUNCATED makes --resume with a raised cap
                    # recompute this patient
                    status = STATUS_TRUNCATED if pid in truncated_patients else STATUS_DONE
                    for stem in done:
                        manifest.record(pid, stem, status)
                    manifest.flush()
                    if args.export_mhd:
                        write_metaimage(
                            mask, out_root / pid / "mask.mhd", compressed=args.mhd_compressed
                        )
                missing = sorted(set(stems) - set(done))
                for stem in missing:
                    manifest.record(pid, stem, STATUS_FAILED)
                if missing:
                    manifest.flush()
                    # success is "the JPEG pair exists" (the drivers' contract)
                    print(f"Patient {pid}: {len(missing)} slices failed to export",
                          file=sys.stderr)
                else:
                    ok_patients += 1
                results[pid] = {
                    "slices": depth,
                    "exported": len(done),
                    "mask_voxels": int(mask.sum()),
                    "grow_truncated": pid in truncated_patients,
                }
                emit_outcome(
                    pid,
                    "ok" if not missing else "failed",
                    slices_total=depth + len(skipped),
                    slices_ok=len(done),
                    slices_failed=len(missing) + len(skipped),
                    slices_truncated=len(done) if pid in truncated_patients else 0,
                    grow_truncated=pid in truncated_patients,
                )
                print(f"Patient {pid}: {depth} slices, mask {int(mask.sum())} voxels")
            except Exception as e:  # noqa: BLE001 - per-patient containment
                print(f"Patient {pid} failed: {e}", file=sys.stderr)
                emit_outcome(pid, "failed", error_class=type(e).__name__)
    wall_s = time.perf_counter() - t0
    print("\n=== All Processing Completed ===\n")
    print(f"Successfully processed {ok_patients}/{len(patients)} patients.")
    if args.results_json:
        write_results_json(args.results_json, {
            "mode": "volume",
            "grow_truncated_patients": truncated_patients,
            "backend": device.type,
            "backend_requested": args.device,
            "backend_actual": device.type,
            "device_name": device_label(device),
            "z_sharded": False,
            "patients": results,
            "timings_s": timer.report(),
            # the patients' loop end to end: load, compute, render, export
            "wall_s": round(wall_s, 3),
            "kernel_launches": {k: fn.launches - before[k] for k, fn in kernels.items()},
            "metrics": run_ctx.metrics_snapshot(),
        })
    all_ok = ok_patients == len(patients)
    run_ctx.close(status="ok" if all_ok else "error")
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
