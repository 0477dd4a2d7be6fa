"""Sequential batch driver.

The port of the JAX package's ``nm03-sequential``, mirroring the
reference's ``img_processing_sequential`` (src/sequential/main_sequential.cpp:
346-363): all patients, one slice at a time, per-slice JPEG pair export,
catch-and-continue fault tolerance, success accounting — plus ``--device``,
flags for every constant, ``--resume``, ``--synthetic`` cohorts and a
results JSON. Run it as

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
    from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
    from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
    from nm03_capstone_project_tpu_torch.render.export import jpeg_encoder
    from nm03_capstone_project_tpu_torch.utils.reporter import configure_reporting
    from nm03_capstone_project_tpu_torch.utils.timing import write_results_json

    configure_reporting(verbose=args.verbose)
    common.apply_native_flag(args)
    kernels = {
        "fused": hm.fused_preprocess_kernel,
        "grow": hg.region_grow_kernel,
        "median": hm.vector_median_filter_kernel,
    }
    try:
        device = resolve_device(args.device)
        cfg = common.pipeline_config_from_args(args)
        batch_cfg = common.batch_config_from_args(args)
        encoder = jpeg_encoder()
        base = common.resolve_base_path(args, tmp_root=Path(args.output))
        proc = CohortProcessor(
            base, args.output, cfg=cfg, batch_cfg=batch_cfg, mode=mode,
            resume=args.resume, device=device,
        )
        before = {k: fn.launches for k, fn in kernels.items()}
        t0 = time.perf_counter()
        summary = proc.process_all_patients()
        wall_s = time.perf_counter() - t0
        if args.results_json:
            write_results_json(args.results_json, {
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
                "ingest": proc.ingest_report(),
                "jpeg_encoder": encoder,
                "kernel_launches": {k: fn.launches - before[k] for k, fn in kernels.items()},
            })
        return 0
    except Exception as e:  # noqa: BLE001 - reference: fatal-error catch in main
        print(f"Fatal error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
