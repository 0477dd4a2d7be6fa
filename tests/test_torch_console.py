"""The port's console names (``pyproject.toml`` ``[project.scripts]``).

Each command of the JAX package (``nm03-<name>``) has a port twin,
``nm03-torch-<name>``, that names the same module in the port's package:
importing it finds the port's ``main`` and loads neither ``jax`` nor the
JAX package. The JAX names stay as they were.
"""

import subprocess
import sys
import tomllib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
JAX_PKG, PORT_PKG = "nm03_capstone_project_tpu", "nm03_capstone_project_tpu_torch"
JAX_NAMES = {
    "test-pipeline": "cli.test_pipeline", "sequential": "cli.sequential",
    "parallel": "cli.parallel", "train": "cli.train", "volume": "cli.volume",
    "serve": "serving.server", "loadgen": "serving.loadgen", "lint": "analysis.cli",
    "trace": "obs.trace", "cache": "compilehub.cache_cli", "top": "serving.top",
    "fleet": "fleet.cli",
}

_PROBE = (
    "import importlib, sys\n"
    "mod, attr = sys.argv[1].split(':')\n"
    "fn = getattr(importlib.import_module(mod), attr)\n"
    "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', '%s'))\n"
    "print(fn.__module__, callable(fn), bad)\n" % JAX_PKG
)


def test_the_jax_names_are_unchanged():
    for name, mod in JAX_NAMES.items():
        assert SCRIPTS[f"nm03-{name}"] == f"{JAX_PKG}.{mod}:main"


def test_every_jax_command_has_a_port_twin():
    port = {k for k in SCRIPTS if k.startswith("nm03-torch-")}
    assert port == {f"nm03-torch-{name}" for name in JAX_NAMES}
    assert len(SCRIPTS) == 2 * len(JAX_NAMES)


@pytest.mark.parametrize("name", sorted(JAX_NAMES))
def test_a_port_name_resolves_to_the_ports_main_without_jax(name):
    target = SCRIPTS[f"nm03-torch-{name}"]
    assert target == f"{PORT_PKG}.{JAX_NAMES[name]}:main"
    out = subprocess.run([sys.executable, "-c", _PROBE, target], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split() == [f"{PORT_PKG}.{JAX_NAMES[name]}", "True", "[]"]
