"""The benchmark on the card: a short run of each cell, and the control.

Marked ``cuda``; each test skips where no CUDA device is visible. Run on
the card with ``python3 -m pytest --noconftest portbench/tests/test_card.py
-m cuda -q`` (the repository's test configuration is not needed there).
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.run import ROOT, point_caches, run_cell

CELLS = ["tcia256.study_slices", "brats240.study_volume", "brats240.study_slices"]


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card only")
    point_caches()
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_traced_run_is_correct_and_reads_every_metric(card, name):
    """In a process of its own, as a check runs it: a process's later
    profiler windows lose device records."""
    from portbench import catalog

    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", name, "--seed",
                          str(2**31 + 101), "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    want = {m["name"] for m in catalog.cell(name)["per_layer"]}
    assert set(result["metrics"]) == want
    for m, v in result["metrics"].items():
        if m.endswith("_roofline"):
            assert 0 < v["value"] <= 100, (m, v)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [61, 62, 63])
def test_the_control_at_the_cell_s_size_is_not_correct(card, name, seed):
    result, _ = run_cell(name, seed, 2.0, False, device=card, engine="control")
    assert not result["correct"]
    assert result["checks"]["mask_voxels_differ"]["value"] > 0
