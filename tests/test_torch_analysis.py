"""The port's nm03-lint (``nm03_capstone_project_tpu_torch/analysis``).

* a red/green fixture pair per rule of the port's catalog;
* parity with the JAX package's rules: the same plain-Python fixture (no
  torch in it) through the JAX rule under the JAX package's path and
  through the port's rule under the port's path gives the same
  ``(rule, line)`` set, for core, contracts, atomicio, threads and
  lockorder, and findings fingerprint alike;
* the package prefixes stay apart: a JAX-package file in a port fixture
  tree is not port code to the port's rules;
* the real port tree is clean against ``nm03lint_torch_baseline.json``,
  one test per rule family, and the gate passes as a subprocess;
* the analysis package imports neither torch nor numpy;
* the kernel build's key changes with every build input (NM381's subject).
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

from nm03_capstone_project_tpu.analysis import collect_files as jax_collect
from nm03_capstone_project_tpu.analysis import run_rules as jax_run
from nm03_capstone_project_tpu.analysis.atomicio import check_atomic_io as jax_atomic_io
from nm03_capstone_project_tpu.analysis.atomicio import check_obs_dump_io as jax_obs_dump_io
from nm03_capstone_project_tpu.analysis.contracts import (
    check_import_contracts as jax_contracts,
)
from nm03_capstone_project_tpu.analysis.core import Finding as JaxFinding
from nm03_capstone_project_tpu.analysis.lockorder import check_lock_order as jax_lock_order
from nm03_capstone_project_tpu.analysis.threads import (
    check_thread_shared_state as jax_threads,
)
from nm03_capstone_project_tpu_torch.analysis import (
    ALL_RULES,
    RULE_CATALOG,
    collect_files,
    run_rules,
)
from nm03_capstone_project_tpu_torch.analysis import cli as port_cli
from nm03_capstone_project_tpu_torch.analysis.atomicio import (
    check_atomic_io,
    check_obs_dump_io,
)
from nm03_capstone_project_tpu_torch.analysis.cachekey import check_cache_key
from nm03_capstone_project_tpu_torch.analysis.compilehome import check_compile_home
from nm03_capstone_project_tpu_torch.analysis.contracts import (
    CONTRACT_REGISTRY,
    check_import_contracts,
    check_no_jax,
)
from nm03_capstone_project_tpu_torch.analysis.core import (
    Finding,
    apply_baseline,
    load_baseline,
)
from nm03_capstone_project_tpu_torch.analysis.dtypes import check_dtype_discipline
from nm03_capstone_project_tpu_torch.analysis.hostsync import check_host_sync
from nm03_capstone_project_tpu_torch.analysis.lockorder import (
    build_lock_graph,
    check_lock_order,
    explain_witness,
)
from nm03_capstone_project_tpu_torch.analysis.metricsdocs import check_metrics_docs
from nm03_capstone_project_tpu_torch.analysis.retrace import check_retrace
from nm03_capstone_project_tpu_torch.analysis.staginghome import check_staging_home
from nm03_capstone_project_tpu_torch.analysis.threads import check_thread_shared_state

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "nm03_capstone_project_tpu_torch"
JAXP = "nm03_capstone_project_tpu"


def write_tree(root: pathlib.Path, files: dict) -> None:
    (root / "pyproject.toml").write_text("[project]\nname='x'\n")
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))


def lint_tree(tmp_path, files, rules=ALL_RULES, collect=collect_files, run=run_rules):
    """Write {relpath: source} under tmp_path and lint it as a root."""
    write_tree(tmp_path, files)
    return run(collect([tmp_path], tmp_path), rules)


def rule_lines(findings, rule=None):
    return sorted((f.rule, f.line) for f in findings if rule is None or f.rule == rule)


# -- one red/green pair per rule ------------------------------------------------

_THREADED = """
import threading

class Worker:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0

    def bump(self):
        {body}
"""

_BUILD = """
import hashlib
from pathlib import Path

from compilehub.persist import PersistKey

CSRC = Path("csrc")
SOURCES = ("a",)
FLAGS = ("-O3",)
WINDOWS = (3, 5)

def header():
    return "".join(str(k) for k in WINDOWS)

def persist_key():
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    {key_extra}
    return PersistKey(h.hexdigest())

def build_dir():
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(header().encode())
    return Path("_build") / h.hexdigest()

def build_all():
    out = build_dir()
    text = header()
    return [out, text, *FLAGS, *SOURCES, str(CSRC)]
"""

# rule -> (rule function, red tree, green tree); each tree is {relpath: source}
PAIRS = {
    "NM301": (check_import_contracts,
              {f"{PORT}/obs/leak.py": "import torch\n"},
              {f"{PORT}/obs/leak.py": "def f():\n    import torch\n    return torch\n"}),
    "NM302": (check_import_contracts,
              {f"{PORT}/ops/other.py": "X = 1\n"},
              {f"{PORT}/{k.split('.', 1)[1].replace('.', '/')}.py": "X = 1\n"
               for k in CONTRACT_REGISTRY}),
    "NM303": (check_no_jax,
              {f"{PORT}/ops/x.py": "def f():\n    import jax\n    return jax\n"},
              {f"{PORT}/ops/x.py": "def f():\n    import torch\n    return torch\n"}),
    "NM311": (check_retrace,
              {f"{PORT}/serving/cap.py": """
                import torch
                def capture(g, x):
                    with torch.cuda.graph(g):
                        t = torch.tensor([1.0, 2.0])
                        return x * t
                """},
              {f"{PORT}/serving/cap.py": """
                import torch
                def capture(g, x, t):
                    with torch.cuda.graph(g):
                        return x * t
                """}),
    "NM312": (check_retrace,
              {f"{PORT}/serving/comp.py": """
                import torch
                def step(x, k):
                    return x * k
                fast = torch.compile(step)
                def run(x):
                    return fast(x, 3)
                """},
              {f"{PORT}/serving/comp.py": """
                import torch
                def step(x, k):
                    return x * k
                fast = torch.compile(step, dynamic=True)
                def run(x):
                    return fast(x, 3)
                """}),
    "NM321": (check_host_sync,
              {f"{PORT}/cli/x.py": """
                def f(spans, t):
                    with spans.span("fetch"):
                        return t.item()
                """},
              {f"{PORT}/cli/x.py": """
                def f(spans, t):
                    v = t.item()
                    with spans.span("fetch"):
                        return v
                """}),
    "NM322": (check_host_sync,
              {f"{PORT}/serving/executor.py": """
                class WarmExecutor:
                    def run_batch(self, t):
                        return t.cpu()
                """},
              {f"{PORT}/serving/executor.py": """
                class WarmExecutor:
                    def run_batch(self, t):
                        def primary():
                            return t.cpu()
                        return primary
                """}),
    "NM331": (check_thread_shared_state,
              {f"{PORT}/serving/w.py": _THREADED.format(body="self.count += 1")},
              {f"{PORT}/serving/w.py": _THREADED.format(
                  body="with self._lock:\n            self.count += 1")}),
    "NM341": (check_dtype_discipline,
              {f"{PORT}/ops/f.py": "import torch\ndef f(x):\n    return x.to(torch.float64)\n"},
              {f"{PORT}/ops/f.py": "import torch\ndef f(x):\n    return x.to(torch.float32)\n"}),
    "NM342": (check_dtype_discipline,
              {f"{PORT}/ops/u.py": "import torch\ndef f(x):\n    return x.to(torch.uint8) > 300\n"},
              {f"{PORT}/ops/u.py": "import torch\ndef f(x):\n    return x.to(torch.uint8) > 200\n"}),
    "NM351": (check_atomic_io,
              {f"{PORT}/utils/w.py": "def f(p, s):\n    p.write_text(s)\n"},
              {f"{PORT}/utils/w.py": "import os\ndef f(p, s):\n    t = p.with_suffix('.tmp')\n"
                                     "    t.write_text(s)\n    os.replace(t, p)\n"}),
    "NM361": (check_compile_home,
              {f"{PORT}/ops/g.py": "import torch\ndef f():\n    return torch.cuda.CUDAGraph()\n"},
              {f"{PORT}/serving/graphs.py": "import torch\ndef f():\n"
                                            "    return torch.cuda.CUDAGraph()\n"}),
    "NM371": (check_obs_dump_io,
              {f"{PORT}/obs/trace.py": "def f(p, s):\n    p.write_text(s)\n"},
              {f"{PORT}/obs/trace.py": "from x import atomic_write_text\ndef f(p, s):\n"
                                       "    atomic_write_text(p, s)\n"}),
    "NM381": (check_cache_key,
              {f"{PORT}/kernels/build.py": _BUILD.format(key_extra="pass")},
              {f"{PORT}/kernels/build.py": _BUILD.format(key_extra="h.update(header().encode())")}),
    "NM401": (check_staging_home,
              {f"{PORT}/cli/s.py": "def f(x, device):\n    return x.to(device)\n"},
              {f"{PORT}/ingest/s.py": "def f(x, device):\n    return x.to(device)\n"}),
    "NM421": (check_lock_order,
              {f"{PORT}/serving/pair.py": """
                import threading
                lock_a = threading.Lock()
                lock_b = threading.Lock()
                def forward():
                    with lock_a:
                        with lock_b:
                            pass
                def backward():
                    with lock_b:
                        with lock_a:
                            pass
                """},
              {f"{PORT}/serving/pair.py": """
                import threading
                lock_a = threading.Lock()
                lock_b = threading.Lock()
                def forward():
                    with lock_a:
                        with lock_b:
                            pass
                def again():
                    with lock_a:
                        with lock_b:
                            pass
                """}),
    "NM422": (check_lock_order,
              {f"{PORT}/serving/sync.py": """
                import threading
                import torch
                lock = threading.Lock()
                def f(t):
                    with lock:
                        torch.cuda.synchronize()
                """},
              {f"{PORT}/serving/sync.py": """
                import threading
                import torch
                lock = threading.Lock()
                def f(t):
                    torch.cuda.synchronize()
                    with lock:
                        pass
                """}),
    "NM423": (check_lock_order,
              {f"{PORT}/serving/bare.py": """
                import threading
                _lock = threading.Lock()
                def f():
                    _lock.acquire()
                    _lock.release()
                """},
              {f"{PORT}/serving/bare.py": """
                import threading
                _lock = threading.Lock()
                def f():
                    _lock.acquire()
                    try:
                        pass
                    finally:
                        _lock.release()
                """}),
    "NM390": (check_dtype_discipline,
              {f"{PORT}/ops/f.py": "import torch\ndef f(x):\n"
                                   "    return x.double()  # nm03-lint: disable=NM341\n"},
              {f"{PORT}/ops/f.py": "import torch\ndef f(x):\n"
                                   "    return x.double()  # nm03-lint: disable=NM341 exact taps\n"}),
    "NM399": (check_dtype_discipline,
              {f"{PORT}/ops/broken.py": "def f(:\n"},
              {f"{PORT}/ops/broken.py": "def f():\n    pass\n"}),
}


def test_every_catalog_rule_has_a_fixture_pair():
    # NM392 reads a docs file beside the tree: its pair is its own test below
    assert set(PAIRS) | {"NM392"} == set(RULE_CATALOG)


@pytest.mark.parametrize("rule", sorted(PAIRS))
def test_rule_red_and_green(rule, tmp_path):
    fn, red, green = PAIRS[rule]
    (tmp_path / "red").mkdir()
    (tmp_path / "green").mkdir()
    assert rule in {f.rule for f in lint_tree(tmp_path / "red", red, rules=(fn,))}
    assert rule not in {f.rule for f in lint_tree(tmp_path / "green", green, rules=(fn,))}


def test_nm392_red_and_green(tmp_path):
    """metrics<->docs drift in both directions, against the port's own table."""
    src = {f"{PORT}/obs/metrics.py": 'A_TOTAL = "a_total"\nB_RATIO = "b_ratio"\n'}
    (tmp_path / "docs").mkdir(parents=True)
    doc = tmp_path / "docs" / "OBSERVABILITY_TORCH.md"
    doc.write_text("| name | type |\n|---|---|\n| `a_total` | counter |\n| `c_gone` | gauge |\n")
    red = lint_tree(tmp_path, src, rules=(check_metrics_docs,))
    assert sorted((f.path, f.rule) for f in red) == [
        ("docs/OBSERVABILITY_TORCH.md", "NM392"), (f"{PORT}/obs/metrics.py", "NM392")]
    doc.write_text("| name | type |\n|---|---|\n| `a_total` | counter |\n| `b_ratio` | gauge |\n")
    assert lint_tree(tmp_path, src, rules=(check_metrics_docs,)) == []
    # the JAX package's table is not the port's: it documents nothing here
    doc.unlink()
    (tmp_path / "docs" / "OBSERVABILITY.md").write_text(
        "| `a_total` | counter |\n| `b_ratio` | gauge |\n")
    assert {f.rule for f in lint_tree(tmp_path, src, rules=(check_metrics_docs,))} == {"NM392"}


# -- the torch spellings each rule knows ---------------------------------------


@pytest.mark.parametrize("expr,flagged", [
    ("t.item()", True), ("t.cpu()", True), ("t.numpy()", True), ("t.tolist()", True),
    ("float(t.sum())", True), ("bool(t.any())", True), ("np.asarray(t)", True),
    ("torch.cuda.synchronize()", True), ("int(t.shape[0])", False), ("len(t)", False),
])
def test_nm322_torch_syncs(expr, flagged, tmp_path):
    fs = lint_tree(tmp_path, {f"{PORT}/serving/executor.py": f"""
        import numpy as np
        import torch
        class WarmExecutor:
            def run_batch(self, t):
                return {expr}
        """}, rules=(check_host_sync,))
    assert (rule_lines(fs) == [("NM322", 6)]) is flagged


@pytest.mark.parametrize("call,flagged", [
    ("torch.cuda.synchronize()", True), ("ev.synchronize()", True), ("t.item()", True),
    ("t.cpu()", True), ("t.tolist()", True), ("g.replay()", True),
    ("dist.all_reduce(t)", True), ("dist.barrier()", True),
    ("fused_preprocess_kernel(t)", True), ("t.add(1)", False),
])
def test_nm422_torch_blocking_calls(call, flagged, tmp_path):
    fs = lint_tree(tmp_path, {f"{PORT}/serving/b.py": f"""
        import threading
        import torch
        import torch.distributed as dist
        from x import fused_preprocess_kernel
        lock = threading.Lock()
        def f(t, ev, g):
            with lock:
                {call}
        """}, rules=(check_lock_order,))
    assert ("NM422" in {f.rule for f in fs}) is flagged


@pytest.mark.parametrize("expr,flagged", [
    ("x.cuda()", True), ("x.to('cuda:0')", True), ("x.to(device)", True),
    ("x.to(self.device)", True), ("x.to(torch.device('cuda'))", True),
    ("torch.as_tensor(a, device=device)", True), ("x.pin_memory()", True),
    ("y.copy_(x, non_blocking=True)", True), ("x.to('cpu')", False),
    ("x.to(torch.uint8)", False), ("x.to(x.dtype)", False),
    ("torch.as_tensor(a, device='cpu')", False), ("y.copy_(x)", False),
])
def test_nm401_torch_staging(expr, flagged, tmp_path):
    fs = lint_tree(tmp_path, {f"{PORT}/cli/s.py": f"""
        import torch
        def f(self, x, y, a, device):
            return {expr}
        """}, rules=(check_staging_home,))
    assert bool(fs) is flagged


@pytest.mark.parametrize("ref,flagged", [
    ("torch.cuda.graph(g)", True), ("torch.cuda.make_graphed_callables(f, (x,))", True),
    ("torch.compile(f)", True), ("ctypes.CDLL('x.so')", True),
    ("subprocess.run(['nvcc', 'a.cu'])", True), ("subprocess.run(['g++', 'a.cpp'])", False),
    ("torch.cuda.graph_pool_handle()", False),
])
def test_nm361_homes(ref, flagged, tmp_path):
    fs = lint_tree(tmp_path, {f"{PORT}/ops/h.py": f"""
        import ctypes
        import subprocess
        import torch
        def f(g, x):
            return {ref}
        """}, rules=(check_compile_home,))
    assert bool(fs) is flagged
    home = "kernels/build.py" if ("CDLL" in ref or "nvcc" in ref) else "serving/graphs.py"
    (tmp_path / "home").mkdir()
    assert lint_tree(tmp_path / "home", {f"{PORT}/{home}": f"""
        import ctypes
        import subprocess
        import torch
        def f(g, x):
            return {ref}
        """}, rules=(check_compile_home,)) == []


# -- parity with the JAX package's rules -----------------------------------------

PARITY = {
    "atomicio": ((jax_atomic_io, jax_obs_dump_io), (check_atomic_io, check_obs_dump_io), {
        "{P}/utils/w.py": "import os\ndef bad(p, s):\n    p.write_text(s)\n"
                          "def good(p, s):\n    t = p.with_suffix('.tmp')\n"
                          "    t.write_text(s)\n    os.replace(t, p)\n"
                          "def mode(p):\n    with open(p, 'w') as f:\n        f.write('x')\n",
        "{P}/obs/flightrec.py": "import os\ndef dump(p, s):\n    p.write_text(s)\n"
                                "    os.replace(p, p)\n",
    }),
    "threads": ((jax_threads,), (check_thread_shared_state,), {
        "{P}/serving/w.py": _THREADED.format(body="self.count += 1\n        self.seen = 1"),
        "{P}/serving/ok.py": _THREADED.format(
            body="with self._lock:\n            self.count += 1"),
        "{P}/ops/out_of_scope.py": _THREADED.format(body="self.count += 1"),
    }),
    "lockorder": ((jax_lock_order,), (check_lock_order,), {
        "{P}/serving/locks.py": """
            import threading
            import time

            lock_a = threading.Lock()
            lock_b = threading.Lock()

            def forward():
                with lock_a:
                    with lock_b:
                        time.sleep(0.1)

            def backward():
                with lock_b:
                    with lock_a:
                        pass

            class W:
                def __init__(self):
                    self._lock = threading.Lock()

                def outer(self):
                    with self._lock:
                        self.inner()

                def inner(self):
                    with self._lock:
                        pass

                def bare(self):
                    self._lock.acquire()
                    self._lock.release()
            """,
    }),
    "contracts": ((jax_contracts,), (check_import_contracts,), {
        "{P}/obs/a.py": "import {P}.obs.b\n",
        "{P}/obs/b.py": "import numpy\n",
        "{P}/obs/lazy.py": "def f():\n    import numpy\n    return numpy\n",
        "{P}/ops/free.py": "import numpy\n",
    }),
    "core": ((jax_atomic_io,), (check_atomic_io,), {
        "{P}/utils/s.py": "def a(p, s):\n    p.write_text(s)  # nm03-lint: disable=NM351\n"
                          "def b(p, s):\n    # nm03-lint: disable=NM351 a scratch file\n"
                          "    p.write_text(s)\n"
                          "def c(p, s):\n    p.write_text(s)\n",
        "{P}/utils/broken.py": "def f(:\n",
    }),
}


def _tree_for(pkg: str, files: dict) -> dict:
    return {k.format(P=pkg): textwrap.dedent(v).replace("{P}", pkg) for k, v in files.items()}


@pytest.mark.parametrize("family", sorted(PARITY))
def test_parity_with_the_jax_rules(family, tmp_path):
    jax_rules, port_rules, files = PARITY[family]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_fs = lint_tree(tmp_path / "jax", _tree_for(JAXP, files), rules=jax_rules,
                       collect=jax_collect, run=jax_run)
    port_fs = lint_tree(tmp_path / "port", _tree_for(PORT, files), rules=port_rules)

    def key(fs, pkg):
        # NM302 names each registry's own missing modules: the registries differ
        return sorted((f.rule, f.path.replace(pkg + "/", ""), f.line)
                      for f in fs if f.rule != "NM302")

    assert key(port_fs, PORT) == key(jax_fs, JAXP)
    assert key(port_fs, PORT), "the fixture exercised nothing"


def test_fingerprint_scheme_is_the_jax_one():
    args = dict(rule="NM351", path="x/y.py", line=3, message="m",
                source_line="  p.write_text(s)   ")
    assert Finding(**args).fingerprint == JaxFinding(**args).fingerprint
    moved = dict(args, line=30, source_line="p.write_text(s)")
    assert Finding(**moved).fingerprint == Finding(**args).fingerprint


# -- the package prefixes stay apart ---------------------------------------------


def test_a_jax_package_file_is_not_port_code(tmp_path):
    """``nm03_capstone_project_tpu`` is a prefix of the port's name: every
    path and module test must use the separator."""
    files = {
        # JAX-package files that would each be a finding in the port
        f"{JAXP}/obs/leak.py": "import torch\nimport numpy\n",
        f"{JAXP}/ops/j.py": "import jax\nfrom nm03_capstone_project_tpu.ops import x\n",
        f"{JAXP}/serving/w.py": _THREADED.format(body="self.count += 1"),
        f"{JAXP}/ops/f.py": "import torch\ndef f(x):\n    return x.double()\n",
        f"{JAXP}/cli/s.py": "def f(x, device):\n    return x.cuda()\n",
        f"{JAXP}/obs/trace.py": "def f(p, s):\n    p.write_text(s)\n",
        # and a clean port file beside them
        f"{PORT}/ops/clean.py": "X = 1\n",
    }
    fs = lint_tree(tmp_path, files)
    assert [f for f in fs if f.path.startswith(JAXP + "/")] == []
    assert {f.relpath for f in collect_files([tmp_path], tmp_path)} == {f"{PORT}/ops/clean.py"}
    witness = {"sites": [{"id": "s1", "path": f"{JAXP}/serving/w.py", "line": 6},
                         {"id": "s2", "path": f"{JAXP}/serving/v.py", "line": 7}],
               "edges": [{"src": "s1", "dst": "s2", "count": 1}], "inversions": []}
    graph = build_lock_graph(collect_files([tmp_path], tmp_path))
    assert explain_witness(witness, graph) == []  # identity-mapped, not port sites


def test_a_port_site_missing_from_the_registry_fails_the_witness(tmp_path):
    write_tree(tmp_path, {f"{PORT}/serving/w.py": _THREADED.format(body="pass")})
    graph = build_lock_graph(collect_files([tmp_path], tmp_path))
    witness = {"sites": [{"id": "a", "path": f"{PORT}/serving/w.py", "line": 6},
                         {"id": "b", "path": f"{PORT}/serving/w.py", "line": 99}],
               "edges": [], "inversions": []}
    problems = explain_witness(witness, graph)
    assert len(problems) == 1 and ":99 is not in the static lock registry" in problems[0]


# -- the real port tree ----------------------------------------------------------


@pytest.fixture(scope="module")
def real_tree():
    return collect_files(port_cli.default_paths(REPO), REPO)


@pytest.fixture(scope="module")
def baseline():
    return load_baseline(REPO / "nm03lint_torch_baseline.json")


@pytest.mark.parametrize("rule_fn", ALL_RULES, ids=lambda fn: fn.__module__.rsplit(".", 1)[1]
                         + "." + fn.__name__)
def test_real_port_tree_is_clean_against_the_baseline(rule_fn, real_tree, baseline):
    findings = run_rules(real_tree, (rule_fn,))
    new, _ = apply_baseline(findings, baseline)
    assert new == [], "\n".join(f.render() for f in new)


def test_default_paths_are_the_port(real_tree):
    rels = {f.relpath for f in real_tree}
    assert "chip_smoke.py" in rels
    assert any(r.startswith("scripts/torch_") for r in rels)
    assert not any(r.startswith(JAXP + "/") or r == "bench.py" for r in rels)


def test_the_baseline_holds_no_deadlock():
    entries = json.loads((REPO / "nm03lint_torch_baseline.json").read_text())["entries"]
    assert entries and not [e for e in entries if e["rule"] == "NM421"]


def test_the_real_tree_has_no_static_lock_cycle(real_tree):
    assert [f for f in check_lock_order(real_tree) if f.rule == "NM421"] == []


def test_an_nm421_is_never_absorbed_by_a_baseline(tmp_path, capsys):
    _, red, _ = PAIRS["NM421"]
    write_tree(tmp_path, red)
    base = tmp_path / "b.json"
    argv = [str(tmp_path), "--root", str(tmp_path), "--baseline", str(base),
            "--select", "NM42"]
    assert port_cli.main(argv + ["--update-baseline"]) == 0
    assert json.loads(base.read_text())["entries"] == []
    # a hand-made entry for the cycle absorbs nothing either
    base.write_text(json.dumps({"version": 1, "entries": [
        {"rule": f.rule, "path": f.path, "fingerprint": f.fingerprint}
        for f in run_rules(collect_files([tmp_path], tmp_path), (check_lock_order,))]}))
    capsys.readouterr()
    assert port_cli.main(argv) == 1
    assert "NM421" in capsys.readouterr().out


def test_the_gate_passes_as_a_subprocess():
    proc = subprocess.run(
        [sys.executable, "-m", f"{PORT}.analysis.gate", "--skip-ruff"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "nm03-lint: 0 new finding(s)" in proc.stdout and "gate: OK" in proc.stdout


def test_cli_json_lists_the_catalog_and_scans_the_port():
    proc = subprocess.run([sys.executable, "-m", f"{PORT}.analysis.cli", "--format", "json"],
                          capture_output=True, text=True, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    payload = json.loads(proc.stdout)
    assert payload["findings"] == [] and payload["files_scanned"] > 100
    listed = subprocess.run([sys.executable, "-m", f"{PORT}.analysis.cli", "--list-rules"],
                            capture_output=True, text=True, cwd=REPO, timeout=60).stdout
    assert all(rid in listed for rid in RULE_CATALOG)


def test_analysis_imports_neither_torch_nor_numpy():
    code = ("import sys\n"
            f"import {PORT}.analysis, {PORT}.analysis.gate, {PORT}.analysis.cli\n"
            f"import {PORT}.utils.lockdep, {PORT}.utils.sanitize\n"
            "bad = sorted(m for m in ('torch', 'numpy', 'jax') if m in sys.modules)\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr


# -- NM381's subject: the build key ------------------------------------------------


@pytest.mark.parametrize("change", ["NVCC_FLAGS", "MEDIAN_WINDOWS", "source", "FUSED_RUNS"])
def test_every_build_input_changes_the_kernel_key(change, monkeypatch, tmp_path):
    from nm03_capstone_project_tpu_torch.kernels import build, median_runs

    before = build.build_dir()
    if change == "NVCC_FLAGS":
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    elif change == "MEDIAN_WINDOWS":
        monkeypatch.setattr(build, "MEDIAN_WINDOWS", build.MEDIAN_WINDOWS[:-1])
    elif change == "source":
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for name in build.SOURCES:
            text = (build.CSRC / f"{name}.cu").read_text()
            (csrc / f"{name}.cu").write_text(text + ("// edited\n" if name == "grow" else ""))
        monkeypatch.setattr(build, "CSRC", csrc)
    else:
        runs = dict(median_runs.FUSED_RUNS)
        runs[7] = runs[7] + 1
        monkeypatch.setattr(median_runs, "FUSED_RUNS", runs)
    assert build.build_dir() != before
    assert build.build_dir().parent == before.parent
