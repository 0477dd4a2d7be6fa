"""Sequential batch driver.

The port of the JAX package's ``nm03-sequential``, mirroring the
reference's ``img_processing_sequential`` (src/sequential/main_sequential.cpp:
346-363): all patients, one slice at a time, per-slice JPEG pair export,
catch-and-continue fault tolerance, success accounting — plus ``--device``,
flags for every constant, ``--resume``, ``--synthetic`` cohorts and a
results JSON, ``--model`` to deploy a trained student, the supervised
dispatch and fault-plan flags (``--retry-max``, ``--dispatch-timeout-s``,
``--fault-plan``), and the JAX drivers' telemetry (``--metrics-out``,
``--log-json``, ``--heartbeat-s``, ``--profile-dir``), and
``--distributed`` (a multi-process job over ``torch.distributed``: the
patients are dealt round-robin to the ranks, each rank writes
``manifest.rank{r}.json``, and rank 0's results JSON carries the
``cluster`` totals). Run it as

    python -m nm03_capstone_project_tpu_torch.cli.sequential --synthetic 2

It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys

from nm03_capstone_project_tpu_torch.cli import common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nm03-sequential", description=__doc__.strip().splitlines()[0]
    )
    p.add_argument("--output", default="out-sequential", help="output root directory")
    common.add_common_args(p)
    common.add_pipeline_args(p)
    common.add_ingest_args(p)
    common.add_render_stage_arg(p)
    common.add_model_arg(p)
    common.add_resilience_args(p)
    common.add_distributed_args(p)
    common.add_not_ported_args(p, "observability", "resilience")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return run(args, mode="sequential")


def run(args: argparse.Namespace, mode: str) -> int:
    """Drive the cohort in ``mode``; 0 on a completed run, 1 on a fatal error."""
    import time
    from pathlib import Path

    from nm03_capstone_project_tpu_torch.cli.runner import CohortProcessor, device_label
    from nm03_capstone_project_tpu_torch.core.backend import resolve_device
    from nm03_capstone_project_tpu_torch.obs.metrics import (
        PIPELINE_FEED_STALL_RATIO,
        RUN_WALL_SECONDS,
    )
    from nm03_capstone_project_tpu_torch.ops import launches
    from nm03_capstone_project_tpu_torch.render.export import jpeg_encoder
    from nm03_capstone_project_tpu_torch.utils.profiling import profile_trace
    from nm03_capstone_project_tpu_torch.utils.reporter import configure_reporting
    from nm03_capstone_project_tpu_torch.utils.timing import write_results_json

    configure_reporting(verbose=args.verbose)
    common.apply_native_flag(args)
    kernels = launches.KERNELS
    run_ctx = None
    try:
        rank, world = common.init_distributed(args)
        run_ctx = common.make_run_context(args, mode, rank=rank)
        device = resolve_device(args.device)
        common.sanitize_warmup(args, device)
        cfg = common.pipeline_config_from_args(args)
        batch_cfg = common.batch_config_from_args(args)
        encoder = jpeg_encoder()
        base = common.resolve_base_path_sync(args, rank, world, tmp_root=Path(args.output))
        model = common.load_model_checkpoint(args, cfg, device=device)
        proc = CohortProcessor(
            base, args.output, cfg=cfg, batch_cfg=batch_cfg, mode=mode,
            resume=args.resume, device=device, model=model,
            obs=run_ctx,
            resilience=common.resilience_config_from_args(args),
            process_rank=rank, process_count=world,
        )
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        with profile_trace(args.profile_dir):
            summary = proc.process_all_patients()
        wall_s = time.perf_counter() - t0
        cluster = None
        if world > 1:
            # the one collective of the whole run: a rank that died earlier
            # fails the others here (gloo) or at the group's timeout (nccl)
            cluster = common.allgather_cluster_counts(
                {
                    "patients_ok": summary.patients_ok,
                    "patients_total": len(summary.patients),
                    "slices_ok": summary.succeeded_slices,
                    "slices_total": summary.total_slices,
                },
                world,
            )
            if rank == 0:
                print(
                    f"\nCluster totals: {cluster['patients_ok']}/"
                    f"{cluster['patients_total']} patients, "
                    f"{cluster['slices_ok']}/{cluster['slices_total']} slices "
                    f"across {world} processes."
                )
        run_ctx.registry.gauge(RUN_WALL_SECONDS, help="end-to-end driver wall clock").set(wall_s)
        # the fraction of wall no device dispatch was in flight: how long
        # the card waited on the host feed
        feed_stall = proc.feed.report()
        if feed_stall["feed_stall_ratio"] is not None:
            run_ctx.registry.gauge(
                PIPELINE_FEED_STALL_RATIO,
                help="fraction of wall time no device dispatch was in "
                "flight (obs.saturation; a lower bound: the dispatch "
                "interval is enqueue->fetch complete)",
            ).set(feed_stall["feed_stall_ratio"])
        run_ctx.events.emit("feed_stall", mode=mode, **feed_stall)
        ingest_rep = proc.publish_ingest()
        if ingest_rep is not None:
            run_ctx.events.emit("ingest_drained", mode=mode, **ingest_rep)
        if args.results_json and rank == 0:
            record = {
                "mode": mode,
                "backend": device.type,
                "device_name": device_label(device),
                # the port has no degraded mode: a failure on the card is a
                # failed slice, batch or patient in the summary
                "backend_degraded": False,
                "summary": summary.as_dict(),
                # wall_s is the number to compare across drivers and modes:
                # in the parallel driver device compute overlaps the export
                # wait, so the per-section times don't partition it
                "wall_s": round(wall_s, 3),
                "timing_s": proc.timer.report(),
                # per-phase busy unions and the device-starvation headline
                "feed_stall": feed_stall,
                "ingest": ingest_rep,
                "jpeg_encoder": encoder,
                "kernel_launches": {k: fn.launches - before[k] for k, fn in kernels.items()},
                # the run's metrics snapshot, as the JAX drivers embed it
                "metrics": run_ctx.metrics_snapshot(),
            }
            if cluster is not None:
                record["cluster"] = cluster  # rank 0's summary and timing above
                record["process_count"] = world
            write_results_json(args.results_json, record)
        run_ctx.close(status="ok", wall_s=round(wall_s, 3))
        return 0
    except Exception as e:  # noqa: BLE001 - reference: fatal-error catch in main
        print(f"Fatal error: {e}", file=sys.stderr)
        if run_ctx is not None:
            run_ctx.close(status="error", error_class=type(e).__name__)
        return 1
    finally:
        common.finish_distributed(args)
        common.end_sanitize(args)


if __name__ == "__main__":
    raise SystemExit(main())
