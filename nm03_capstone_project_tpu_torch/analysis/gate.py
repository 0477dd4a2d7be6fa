"""The port's one-command static gate: nm03-lint, ruff and the lockdep witness.

The counterpart of the JAX package's ``scripts/check_static.py``, kept in
the package (the JAX lint scans ``scripts/`` against its own baseline).
Run from anywhere with the repository importable::

    python -m nm03_capstone_project_tpu_torch.analysis.gate
    python -m nm03_capstone_project_tpu_torch.analysis.gate --update-baseline
    python -m nm03_capstone_project_tpu_torch.analysis.gate --skip-ruff
    python -m nm03_capstone_project_tpu_torch.analysis.gate --lockdep-witness W.json

Phases (each reported on its own, all must pass):

1. **parse** — every file of the port (its package, ``chip_smoke.py``,
   ``scripts/torch_*.py``) compiles;
2. **nm03-lint** — the port's rules (docs/STATIC_ANALYSIS_TORCH.md) against
   ``nm03lint_torch_baseline.json``, in a subprocess; any NEW finding
   fails (``--update-baseline`` forwards to the linter: the baseline diff
   is the review artifact);
3. **ruff** — the general-purpose layer, only when ruff is installed; when
   it is not, the phase says SKIPPED loudly instead of passing silently;
4. **lockdep witness** (``--lockdep-witness PATH``) — a
   ``lockdep_witness.json`` from an instrumented run (``NM03_LOCKDEP=1``,
   :mod:`..utils.lockdep`) against the port's static may-hold graph: zero
   inversions, zero observed cycles, every observed edge statically
   derivable or targeting an ``obs/`` leaf lock.

Exit 0 when every phase passes, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path
from typing import List

REPO = Path(__file__).resolve().parents[2]
PKG_DIR = REPO / "nm03_capstone_project_tpu_torch"


def port_paths() -> List[Path]:
    """What the gate covers: the lint's default paths."""
    from nm03_capstone_project_tpu_torch.analysis.cli import default_paths

    return default_paths(REPO)


def run_parse_phase() -> int:
    """py_compile every file of the port; count failures."""
    import py_compile

    failures = 0
    for root in port_paths():
        files = [root] if root.is_file() else sorted(root.rglob("*.py"))
        for f in files:
            if "__pycache__" in f.parts or "_build" in f.parts:
                continue
            try:
                py_compile.compile(str(f), cfile=None, doraise=True)
            except py_compile.PyCompileError as e:
                print(f"parse: {e.msg}")
                failures += 1
    return failures


def run_lint_phase(update_baseline: bool) -> int:
    cmd = [sys.executable, "-m", "nm03_capstone_project_tpu_torch.analysis.cli",
           "--root", str(REPO)]
    cmd += ["--update-baseline"] if update_baseline else ["--format", "json"]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO, timeout=300)
    if update_baseline:
        print(proc.stdout.strip() or proc.stderr.strip())
        return proc.returncode
    try:
        payload = json.loads(proc.stdout)
    except json.JSONDecodeError:
        print(f"nm03-lint: unparseable output (rc={proc.returncode}):")
        print(proc.stdout[-2000:] or proc.stderr[-2000:])
        return 1
    for f in payload.get("findings", []):
        print(f"nm03-lint: {f['path']}:{f['line']}: {f['rule']} {f['message']}")
    n = len(payload.get("findings", []))
    print(f"nm03-lint: {n} new finding(s), {payload.get('baselined', 0)} baselined, "
          f"{payload.get('files_scanned', 0)} files")
    return n


def run_ruff_phase(skip: bool) -> int:
    """``ruff check`` over the port when available; a loud SKIP when not."""
    if skip:
        print("ruff: skipped (--skip-ruff)")
        return 0
    probe = subprocess.run([sys.executable, "-m", "ruff", "--version"],
                           capture_output=True, text=True)
    if probe.returncode != 0:
        print("ruff: SKIPPED — not installed in this environment "
              "(pyproject.toml [tool.ruff] is the config it will use)")
        return 0
    proc = subprocess.run(
        [sys.executable, "-m", "ruff", "check", *[str(p) for p in port_paths()]],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        print(((proc.stdout or "") + (proc.stderr or "")).strip())
        return 1
    print("ruff: clean")
    return 0


def check_witness(witness: dict) -> List[str]:
    """The problems of ``witness`` against the port's static graph."""
    from nm03_capstone_project_tpu_torch.analysis import lockorder
    from nm03_capstone_project_tpu_torch.analysis.core import collect_files

    graph = lockorder.build_lock_graph(collect_files(port_paths(), REPO))
    return lockorder.explain_witness(witness, graph)


def run_lockdep_phase(witness_path) -> int:
    """Gate an observed-lock-order witness against the static graph."""
    if not witness_path:
        return 0
    p = Path(witness_path)
    if not p.exists():
        print(f"lockdep: witness file not found: {p}")
        return 1
    try:
        witness = json.loads(p.read_text())
    except json.JSONDecodeError as e:
        print(f"lockdep: unparseable witness {p}: {e}")
        return 1
    problems = check_witness(witness)
    for prob in problems:
        print(f"lockdep: {prob}")
    if problems:
        return len(problems)
    print(f"lockdep: witness OK — {len(witness.get('edges', []))} edge(s) over "
          f"{len(witness.get('sites', []))} site(s), 0 inversions, 0 cycles")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m nm03_capstone_project_tpu_torch.analysis.gate",
        description=__doc__.splitlines()[0])
    p.add_argument("--update-baseline", action="store_true",
                   help="forward to nm03-lint: absorb current findings into the baseline")
    p.add_argument("--skip-ruff", action="store_true", help="skip the ruff phase")
    p.add_argument("--lockdep-witness", default=None, metavar="JSON",
                   help="gate a utils/lockdep.py witness against the static "
                   "may-hold graph (analysis/lockorder.py)")
    args = p.parse_args(argv)

    failures = run_parse_phase()
    print(f"parse: {'clean' if not failures else f'{failures} failure(s)'}")
    failures += run_lint_phase(args.update_baseline)
    failures += run_ruff_phase(args.skip_ruff)
    failures += run_lockdep_phase(args.lockdep_witness)
    if failures:
        print(f"gate: FAIL ({failures} problem(s))")
        return 1
    print("gate: OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
