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

``--z-shard`` splits each volume along z over the local devices
(:func:`..parallel.process_volume_zsharded`, halo exchange between
neighbours), or with ``--distributed`` over one device of every rank of
the job; the depth is padded with zero filler planes (which segment
empty) to a multiple of the shard count and cut back afterwards. The
z-sharded path always grows by dilation, and says so to a ``--grow-algorithm
jump`` run. On one device ``--z-shard`` is ignored with the JAX driver's
message; with ``--model`` it is refused as the JAX driver refuses it.

``--distributed`` without ``--z-shard`` deals the patients round-robin to
the ranks, each on its own device with its own ``manifest.rank{r}.json``;
with ``--z-shard`` every rank computes its slab of every volume and rank 0
exports and keeps the manifest. Every rank then reaches the export-outcome
collective of every patient, even when rank 0's export fails, so no rank
waits on a collective its peers skipped.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

from nm03_capstone_project_tpu_torch.cli import common

MODEL_ZSHARD_REFUSAL = (
    "--model with --z-shard is unsupported: the 3D student runs whole volumes "
    "(drop --z-shard; --distributed patient sharding still applies)"
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
        help="shard each volume along z across the local devices (with "
        "--distributed: one device of every rank); ignored on one device",
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
    common.add_distributed_args(
        p,
        "Without --z-shard, patients are round-robin sharded across "
        "processes, each on its own device. WITH --z-shard, every process "
        "computes its z-slab of every volume and rank 0 exports.",
    )
    common.add_not_ported_args(p, "observability")
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
    try:
        rank, world = common.init_distributed(args)
        run_ctx = common.make_run_context(args, "volume", rank=rank)
        try:
            rc = _run_inner(args, run_ctx, rank, world)
        except BaseException as e:
            run_ctx.close(status="error", error_class=type(e).__name__)
            raise
        run_ctx.close(status="error")  # a no-op unless a refusal returned early
        return rc
    finally:
        common.finish_distributed(args)


def _run_inner(args: argparse.Namespace, run_ctx, rank: int = 0, world: int = 1) -> int:
    import numpy as np
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
    from nm03_capstone_project_tpu_torch.parallel import distributed
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

    # two multi-process layouts: with --z-shard the whole job cooperates
    # volume by volume over one device of every rank (rank 0 exports and
    # keeps the manifest); without it, patients shard across ranks, each
    # on its own device, like the batch drivers
    global_zshard = bool(args.z_shard) and world > 1
    patient_sharded = world > 1 and not global_zshard
    i_export = rank == 0 or patient_sharded
    mesh = None
    if args.z_shard:
        from nm03_capstone_project_tpu_torch.parallel import make_mesh
        from nm03_capstone_project_tpu_torch.parallel.mesh import local_devices

        # one device of every rank with a global z-shard, else the local ones
        mesh = (distributed.global_mesh(("z",)) if global_zshard
                else make_mesh(axis_names=("z",), devices=local_devices(device)))
        if mesh.shape["z"] == 1:
            # never a mesh quietly dropped to one device: say so
            print("--z-shard ignored: single device", file=sys.stderr)
            mesh = None
        else:
            if cfg.grow_algorithm != "dilate":
                # the z-sharded decomposition implements only the
                # halo-exchange dilation fixpoint: no "jump" timing that
                # was secretly dilate
                print(
                    "warning: --grow-algorithm jump applies to single-device "
                    "volumes; the z-sharded path always runs the halo-exchange "
                    "dilation fixpoint",
                    file=sys.stderr,
                )
            print(f"z-sharding volumes over {mesh.shape['z']} "
                  f"{'global' if global_zshard else 'local'} devices")
    kernels = {
        "fused": hm.fused_preprocess_kernel,
        "grow": hg.region_grow_kernel,
        "median": hm.vector_median_filter_kernel,
    }
    before = {k: fn.launches for k, fn in kernels.items()}

    out_root = Path(args.output)
    base = common.resolve_base_path_sync(args, rank, world, tmp_root=out_root)
    manifest_name = f"manifest.rank{rank}.json" if patient_sharded else "manifest.json"
    if args.resume and rank == 0:
        # rank 0 only: the ranks share out_root, one warning is enough
        common.warn_resume_topology(
            out_root, world if patient_sharded else 1,
            lambda m, *a: print("warning: " + (m % a), file=sys.stderr),
        )
    manifest = (Manifest.load_or_create(out_root, manifest_name) if args.resume
                else Manifest(out_root, manifest_name))
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

    def all_ranks_ok(ok: bool) -> bool:
        """Collective: True iff every rank reports ok."""
        return bool(distributed.allgather([int(ok)]).all())

    patients = find_patient_dirs(base)
    if patient_sharded:
        patients = common.shard_patients(patients, rank, world)
    print(f"=== Volumetric processing: {len(patients)} patients ===")

    t0 = time.perf_counter()
    ok_patients, results = 0, {}
    truncated_patients: list = []
    with profile_trace(args.profile_dir):
        for pid in patients:
            try:
                # with a global z-shard every branch below is taken the same
                # way on every rank: a rank that skips a patient while
                # another enters its collectives would hang the job. So the
                # resume decision is rank 0's, broadcast, and a load failure
                # on any rank fails the patient on all of them
                skip = False
                if args.resume:
                    if i_export:
                        try:
                            # the listing alone decides that a patient was fully visited
                            listed = [f.stem for f in load_dicom_files_for_patient(base, pid)]
                            skip = bool(listed and manifest.patient_accounted(pid, listed))
                        except Exception:  # noqa: BLE001
                            if not global_zshard:
                                raise
                            # skip stays False: the load below fails on every rank
                    if global_zshard:
                        skip = bool(distributed.broadcast_one_to_all([int(skip)])[0])
                if skip:
                    print(f"Patient {pid}: already complete, skipping")
                    ok_patients += 1
                    emit_outcome(pid, "ok", skipped=True)
                    continue
                load_error = None
                try:
                    with timer.section(f"load/{pid}"):
                        vol, dims, stems, skipped = _load_volume(base, pid, cfg)
                except Exception as e:  # noqa: BLE001 — judged collectively
                    load_error = e
                if global_zshard and not all_ranks_ok(load_error is None):
                    raise load_error or RuntimeError(f"{pid}: load failed on another rank")
                if load_error is not None:
                    raise load_error
                for stem in skipped:
                    # load-time rejects, recorded so --resume can account for them
                    manifest.record(pid, stem, STATUS_FAILED)
                depth = vol.shape[0]
                with timer.section(f"compute/{pid}"):
                    # only work every rank takes the same way: the exporting
                    # rank's device render waits for the guarded export below
                    dm = torch.from_numpy(dims).to(device)
                    if student_fn is not None:
                        px = torch.from_numpy(vol).to(device)
                        mask_t, conv = student_fn(px, dm), True  # no growing fixpoint
                    elif mesh is not None:
                        from nm03_capstone_project_tpu_torch.parallel import (
                            process_volume_zsharded,
                        )

                        n = mesh.shape["z"]
                        pad = (-depth) % n
                        # zero filler planes: normalize(0) lands outside the
                        # grow band, so they segment empty and are cut off
                        padded = np.concatenate(
                            [vol, np.zeros((pad,) + vol.shape[1:], vol.dtype)]) if pad else vol
                        out = process_volume_zsharded(padded, dims, cfg, mesh)
                        mask_t = out["mask"][:depth]
                        px = out["original"][:depth]
                        dm = dm.to(mask_t.device)
                        conv = bool(out["grow_converged"])
                    else:
                        px = torch.from_numpy(vol).to(device)
                        out = process_volume(px, dm, cfg, device=device)
                        mask_t, conv = out["mask"], bool(out["grow_converged"])
                    mask = mask_t.cpu().numpy()  # waits for the card
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
                if not i_export:
                    # global z-shard, rank != 0: rank 0 exports. Learn its
                    # outcome (the collective below pairs with rank 0's) so
                    # that every rank counts alike and exits alike
                    export_ok = all_ranks_ok(True)
                    results[pid] = {"slices": depth, "mask_voxels": int(mask.sum())}
                    if export_ok:
                        ok_patients += 1
                    else:
                        print(f"Patient {pid}: export failed on the exporting rank",
                              file=sys.stderr)
                    emit_outcome(
                        pid, "ok" if export_ok else "failed", slices_total=depth,
                        grow_truncated=pid in truncated_patients,
                        error_class=None if export_ok else "RemoteExportError",
                    )
                    continue
                export_error, missing, done = None, [], []
                try:
                    with timer.section(f"export/{pid}"):
                        gray = seg = None
                        if not host_render:
                            g, sg = render_pair(px, mask_t, dm.expand(depth, 2), cfg)
                            gray, seg = g.cpu().numpy(), sg.cpu().numpy()
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
                        # under-covers: TRUNCATED makes --resume with a raised
                        # cap recompute this patient
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
                except Exception as e:  # noqa: BLE001 — judged collectively
                    # an export failure must still reach the outcome
                    # collective, or the waiting ranks would hang
                    export_error = e
                if global_zshard:
                    all_ranks_ok(export_error is None and not missing)
                if export_error is not None:
                    raise export_error
                if missing:
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
    cluster = None
    if patient_sharded:
        # the batch drivers' one collective: cohort-wide totals
        cluster = common.allgather_cluster_counts(
            {"patients_ok": ok_patients, "patients_total": len(patients)}, world
        )
        if rank == 0:
            print(
                f"Cluster totals: {cluster['patients_ok']}/"
                f"{cluster['patients_total']} patients across {world} processes."
            )
    if args.results_json and rank == 0:
        record = {
            "mode": "volume",
            "grow_truncated_patients": truncated_patients,
            "backend": device.type,
            "backend_requested": args.device,
            "backend_actual": device.type,
            "device_name": device_label(device),
            "z_sharded": mesh is not None,
            "z_global": global_zshard,
            "z_shards": mesh.shape["z"] if mesh is not None else 1,
            "patients": results,
            "timings_s": timer.report(),
            # the patients' loop end to end: load, compute, render, export
            "wall_s": round(wall_s, 3),
            "kernel_launches": {k: fn.launches - before[k] for k, fn in kernels.items()},
            "metrics": run_ctx.metrics_snapshot(),
        }
        if cluster is not None:
            record["cluster"] = cluster
            record["process_count"] = world
        write_results_json(args.results_json, record)
    all_ok = ok_patients == len(patients)
    run_ctx.close(status="ok" if all_ok else "error")
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
