"""Nothing the benchmark loads for a cell is JAX or the JAX package."""

from __future__ import annotations

import json
import subprocess
import sys

from portbench.run import forbidden_modules
from portbench.tests.tiny import REPO

# run a tiny cell on the CPU in a fresh interpreter, then list every module
# loaded, by its top-level name
_PROBE = """
import json, sys, pathlib
from portbench.tests.tiny import make_tiny_root
from portbench.run import run_cell
root = make_tiny_root(pathlib.Path(sys.argv[1]))
result, _ = run_cell("tiny.cell", 3, 0.3, True, device="cpu", root=root)
print(json.dumps({"correct": result["correct"],
                  "modules": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_the_rule_compares_whole_top_level_names():
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                              "nm03_capstone_project_tpu", "nm03_capstone_project_tpu.ops"]) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "nm03_capstone_project_tpu",
        "nm03_capstone_project_tpu.ops"]
    assert forbidden_modules(["nm03_capstone_project_tpu_torch",
                              "nm03_capstone_project_tpu_torch.pipeline", "jaxtyping",
                              "portbench.run", "torch"]) == []


def test_a_cell_s_run_loads_no_jax(tmp_path):
    out = subprocess.run([sys.executable, "-c", _PROBE, str(tmp_path)], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert "nm03_capstone_project_tpu_torch" in got["modules"]
    assert forbidden_modules(got["modules"]) == []


def test_without_a_card_the_run_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                          "tcia256.study_slices", "--seed", "1", "--seconds", "1"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
