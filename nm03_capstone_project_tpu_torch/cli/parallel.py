"""Parallel batch driver.

The port of the JAX package's ``nm03-parallel``, mirroring the reference's
``img_processing_parallel`` (src/parallel/main_parallel.cpp:389-411). The
reference parallelizes with 16 OpenMP threads over a <=25-slice batch and
serializes exports through one shared Qt render target; here a batch of up
to 25 slices is the leading axis of the tensors the CUDA kernels take, the
DICOM decode runs on an IO thread pool, and render + JPEG encode overlap
the next batch's device compute. Same contract, and the same output as the
sequential driver. Run it as

    python -m nm03_capstone_project_tpu_torch.cli.parallel --synthetic 20 --synthetic-slices 25

It runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

from nm03_capstone_project_tpu_torch.cli import common
from nm03_capstone_project_tpu_torch.cli.sequential import run


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nm03-parallel", description=__doc__.strip().splitlines()[0]
    )
    p.add_argument("--output", default="out-parallel", help="output root directory")
    common.add_common_args(p)
    common.add_pipeline_args(p)
    common.add_batch_args(p)
    common.add_ingest_args(p)
    common.add_render_stage_arg(p)
    common.add_model_arg(p)
    common.add_resilience_args(p)
    common.add_not_ported_args(p, "observability", "resilience", "distributed")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return run(args, mode="parallel")


if __name__ == "__main__":
    raise SystemExit(main())
