"""Find a cell's parts by the names in ``BENCHMARK.json``.

Nothing here names a configuration, a traffic mix or a metric: each is a
file found by its name, so a later cell, configuration or metric is added
as files and entries only.

* configuration: the ``file`` of its entry in ``configs`` (JSON);
* traffic mix: ``portbench/traffic/<traffic>.json``;
* entry point the mix drives: ``portbench/entries/<entry>.py``, which
  gives the program's call and the plain reference's;
* metric: ``portbench/metrics/<name>.py``, whose ``read(run)`` returns
  the number or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> dict:
    """The workload ``name``: its entry, configuration, traffic mix, entry
    module and the metrics it reports (``end_to_end``, ``per_layer``)."""
    root = Path(root)
    bench = benchmark(root)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; known: {sorted(by_name)}")
    work = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((root / "portbench" / "traffic" / f"{work['traffic']}.json").read_text())
    return {
        "name": name,
        "workload": work,
        "config": config,
        "traffic": traffic,
        "entry": load_module(root / "portbench" / "entries" / f"{traffic['entry']}.py"),
        "end_to_end": [m for m in bench["end_to_end"] if _applies(m, name)],
        "per_layer": [m for m in bench["per_layer"] if _applies(m, name)],
        "root": root,
    }


def workloads(root: Path = ROOT) -> List[str]:
    return [w["name"] for w in benchmark(root)["workloads"]]


_MODULES: Dict[Path, ModuleType] = {}


def load_module(path: Path) -> ModuleType:
    """The module in the file ``path``, loaded once a process."""
    path = Path(path).resolve()
    if path not in _MODULES:
        mod_name = f"portbench_{path.parent.name}_{path.stem}".replace("-", "_").replace(".", "_")
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or spec.loader is None:
            raise ImportError(f"cannot load {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return _MODULES[path]


def reader(root: Path, metric: str):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    return load_module(Path(root) / "portbench" / "metrics" / f"{metric}.py").read
