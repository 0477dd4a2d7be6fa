"""A throwaway benchmark root on the CPU, for the benchmark's tests."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

# a cell at a size the CPU runs in a second: 3 studies of 6 planes at 64 x 64
TINY_CONFIG = {
    "name": "tiny-phantom-64",
    "source": "https://arxiv.org/abs/2107.02314",
    "precision": "float32",
    "reduced": [],
    "pipeline": {
        "norm_low": 0.5, "norm_high": 2.5, "norm_intensity_min": 0.0,
        "norm_intensity_max": 10000.0, "clip_low": 0.68, "clip_high": 4000.0,
        "median_window": 7, "sharpen_gain": 2.0, "sharpen_sigma": 0.5, "sharpen_kernel": 9,
        "grow_low": 0.74, "grow_high": 0.91, "morph_size": 3, "canvas": 64,
        "grow_block_iters": 16, "grow_max_iters": 1024, "grow_algorithm": "dilate",
    },
    "cohort": {
        "studies": 3, "planes": 6, "canvas": 64, "dims": [[64, 64], [61, 53], [57, 64]],
        "profile": "sin", "skull": True, "noise": 40.0, "voxel_noise": 25.0,
        "intensity": {"tissue": 800.0, "skull": 6000.0, "ventricle": 350.0,
                      "lesion_core": 1900.0, "lesion_rim": 1150.0},
        "lesions": [{"r": 0.2}],
    },
}
TINY_TRAFFIC = {"entry": "process_batch", "depth": 2, "sample": 4, "trace_seconds": 0.2}
TINY_METRIC = '''"""Studies completed in the window: a throwaway metric of the tests."""


def read(run):
    return float(len(run.completed()))
'''


@pytest.fixture()
def tiny_root(tmp_path) -> Path:
    return make_tiny_root(tmp_path)


def make_tiny_root(tmp_path: Path) -> Path:
    """A benchmark root holding a copy of ``portbench/`` and, added as
    files and entries only, a throwaway configuration, traffic mix, cell
    and metric."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs" / "tiny-phantom-64.json").write_text(json.dumps(TINY_CONFIG))
    (root / "portbench" / "traffic" / "tiny_mix.json").write_text(json.dumps(TINY_TRAFFIC))
    (root / "portbench" / "metrics" / "tiny_studies.py").write_text(TINY_METRIC)
    bench["configs"].append({"name": "tiny-phantom-64", "source": TINY_CONFIG["source"],
                             "file": "portbench/configs/tiny-phantom-64.json", "reduced": [],
                             "why": "tests"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny-phantom-64",
                               "traffic": "tiny_mix", "chips": 1, "why": "tests"})
    for group in ("end_to_end", "per_layer"):
        for m in bench[group]:
            if "workloads" in m and m["name"] != "study_latency_p95_ms":
                m["workloads"].append("tiny.cell")
    bench["per_layer"].append({"name": "tiny_studies", "unit": "studies", "better": "higher",
                               "source": "host_clock", "layer": "pipeline entry",
                               "moves": "slices_per_s", "workloads": ["tiny.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
