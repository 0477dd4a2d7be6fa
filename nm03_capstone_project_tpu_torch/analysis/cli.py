"""The port's ``nm03-lint`` — the static gate over the PyTorch port.

Runs every NM3xx/NM4xx rule family over the port (its package,
``chip_smoke.py`` and ``scripts/torch_*.py``) and reports findings
*relative to the checked-in baseline* (``nm03lint_torch_baseline.json``):
exit 0 when nothing is new, 1 when something is, 2 on usage errors.

Usage:
    python -m nm03_capstone_project_tpu_torch.analysis.cli
    ... --format json              # machine-readable (the gate's interface)
    ... --select NM301,NM331 nm03_capstone_project_tpu_torch/serving/
    ... --update-baseline          # absorb current findings (review the diff!)
    ... --list-rules               # the catalog (docs/STATIC_ANALYSIS_TORCH.md)
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from nm03_capstone_project_tpu_torch.analysis.atomicio import (
    check_atomic_io,
    check_obs_dump_io,
)
from nm03_capstone_project_tpu_torch.analysis.cachekey import check_cache_key
from nm03_capstone_project_tpu_torch.analysis.compilehome import check_compile_home
from nm03_capstone_project_tpu_torch.analysis.contracts import (
    check_import_contracts,
    check_no_jax,
)
from nm03_capstone_project_tpu_torch.analysis.core import (
    DEFAULT_BASELINE_NAME,
    Finding,
    apply_baseline,
    collect_files,
    find_repo_root,
    load_baseline,
    prune_baseline,
    run_rules,
    write_baseline,
)
from nm03_capstone_project_tpu_torch.analysis.dtypes import check_dtype_discipline
from nm03_capstone_project_tpu_torch.analysis.hostsync import check_host_sync
from nm03_capstone_project_tpu_torch.analysis.lockorder import check_lock_order
from nm03_capstone_project_tpu_torch.analysis.metricsdocs import check_metrics_docs
from nm03_capstone_project_tpu_torch.analysis.retrace import check_retrace
from nm03_capstone_project_tpu_torch.analysis.staginghome import check_staging_home
from nm03_capstone_project_tpu_torch.analysis.threads import check_thread_shared_state

ALL_RULES = (
    check_import_contracts,
    check_no_jax,
    check_retrace,
    check_host_sync,
    check_thread_shared_state,
    check_dtype_discipline,
    check_atomic_io,
    check_obs_dump_io,
    check_compile_home,
    check_cache_key,
    check_metrics_docs,
    check_staging_home,
    check_lock_order,
)

RULE_CATALOG = {
    "NM301": "import-contract: torch/numpy imported at import time by a contract module",
    "NM302": "import-contract: registry names a module missing from the tree",
    "NM303": "import-contract: the port imports jax or the JAX package",
    "NM311": "graph-bake: tensor built from Python data inside a CUDA graph capture",
    "NM312": "graph-bake: captured/graph-keyed callable called with a numeric literal",
    "NM321": "host-sync: implicit device->host sync inside an obs span",
    "NM322": "host-sync: implicit device->host sync in a serving dispatch-path function",
    "NM331": "threads: unguarded attribute write in a cross-thread class",
    "NM341": "dtype: float64 introduction in the f32 ops pipeline",
    "NM342": "dtype: uint8-cast comparison against an out-of-range literal",
    "NM351": "atomic-io: truncating artifact write without tmp+rename",
    "NM361": "compile-home: CUDA graph/torch.compile/CDLL/nvcc outside its home",
    "NM371": "obs-io: flight-recorder/trace module writes without atomic_write_*",
    "NM381": "cache-key: kernel build input not consumed by build_dir()'s key",
    "NM392": "metrics-docs: metric name and docs/OBSERVABILITY_TORCH.md table drifted",
    "NM401": "staging-home: host->card copy outside ingest/",
    "NM421": "lock-order: cycle in the may-hold graph (static deadlock)",
    "NM422": "lock-order: blocking call (dispatch/sync/collective/IO/sleep/join) under a lock",
    "NM423": "lock-order: bare acquire() without release() in a try/finally",
    "NM390": "meta: suppression without a reason",
    "NM399": "meta: file does not parse",
}

# rules no baseline may absorb: a lock-order cycle is a deadlock to repair
NEVER_BASELINED = ("NM421",)


def default_paths(root: Path) -> List[Path]:
    """The port: its package, ``chip_smoke.py`` and ``scripts/torch_*.py``."""
    paths = [root / "nm03_capstone_project_tpu_torch"]
    smoke = root / "chip_smoke.py"
    if smoke.exists():
        paths.append(smoke)
    paths.extend(sorted((root / "scripts").glob("torch_*.py")))
    return paths


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nm03_capstone_project_tpu_torch.analysis.cli",
        description=__doc__.strip().splitlines()[0],
    )
    p.add_argument(
        "paths",
        nargs="*",
        help="files/directories to scan (default: the port package, "
        "chip_smoke.py, scripts/torch_*.py)",
    )
    p.add_argument(
        "--root",
        default=None,
        help="repo root for relative paths and the default baseline "
        "(default: nearest ancestor of the first path with a "
        "pyproject.toml)",
    )
    p.add_argument(
        "--baseline",
        default=None,
        metavar="JSON",
        help=f"baseline file (default: <root>/{DEFAULT_BASELINE_NAME}; "
        "missing file = empty baseline)",
    )
    p.add_argument(
        "--update-baseline",
        action="store_true",
        help="write the current findings as the new baseline and exit 0 "
        "(the diff is the review artifact)",
    )
    p.add_argument(
        "--prune-baseline",
        action="store_true",
        help="drop baseline entries whose finding no longer reproduces, "
        "then exit 0 (the baseline must only ever shrink without review; "
        "growth goes through --update-baseline and its diff)",
    )
    p.add_argument(
        "--no-baseline",
        action="store_true",
        help="report every finding, ignoring the baseline",
    )
    p.add_argument(
        "--select",
        default=None,
        metavar="RULES",
        help="comma list of rule-id prefixes to run (e.g. NM30,NM331)",
    )
    p.add_argument(
        "--format",
        choices=["text", "json"],
        default="text",
        help="output format (json is the gate's interface)",
    )
    p.add_argument(
        "--list-rules", action="store_true", help="print the rule catalog"
    )
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rid, desc in sorted(RULE_CATALOG.items()):
            print(f"{rid}  {desc}")
        return 0

    if args.root:
        root = Path(args.root).resolve()
    else:
        anchor = Path(args.paths[0]) if args.paths else Path.cwd()
        anchor = anchor if anchor.is_dir() else anchor.parent
        root = find_repo_root(anchor)
    paths = [Path(p) for p in args.paths] or default_paths(root)
    for p in paths:
        if not p.exists():
            print(f"nm03-lint: no such path: {p}", file=sys.stderr)
            return 2

    try:
        files = collect_files(paths, root)
    except ValueError as e:
        print(f"nm03-lint: {e} (is --root an ancestor of every path?)", file=sys.stderr)
        return 2
    select = (
        [s.strip() for s in args.select.split(",") if s.strip()]
        if args.select
        else None
    )
    findings = run_rules(files, ALL_RULES, select=select)

    baseline_path = (
        Path(args.baseline) if args.baseline else root / DEFAULT_BASELINE_NAME
    )
    if args.update_baseline:
        if (args.select or args.paths) and not args.baseline:
            # the default baseline is whole-tree truth: rewriting it from a
            # --select/path-narrowed run would silently DELETE every entry
            # the narrowed run didn't reproduce, and the next full gate
            # run would fail on previously-accepted findings. An explicit
            # --baseline opts out (fixture trees, scratch files).
            print(
                "nm03-lint: refusing --update-baseline on a narrowed run "
                "(--select/path arguments present); rerun with the default "
                "scope, or pass an explicit --baseline",
                file=sys.stderr,
            )
            return 2
        write_baseline(
            baseline_path, [f for f in findings if f.rule not in NEVER_BASELINED])
        print(
            f"nm03-lint: baseline updated with {len(findings)} finding(s) "
            f"at {baseline_path}"
        )
        return 0

    if args.prune_baseline:
        if (args.select or args.paths) and not args.baseline:
            # same whole-tree-truth rule as --update-baseline: a narrowed
            # run reproduces only a slice of the findings and would prune
            # every entry outside that slice
            print(
                "nm03-lint: refusing --prune-baseline on a narrowed run "
                "(--select/path arguments present); rerun with the default "
                "scope, or pass an explicit --baseline",
                file=sys.stderr,
            )
            return 2
        kept, dropped = prune_baseline(baseline_path, findings)
        print(
            f"nm03-lint: baseline pruned: {dropped} stale entr"
            f"{'y' if dropped == 1 else 'ies'} dropped, {kept} kept"
        )
        return 0

    if args.no_baseline:
        new, matched = list(findings), 0
    else:
        try:
            baseline = load_baseline(baseline_path)
        except (ValueError, json.JSONDecodeError) as e:
            print(f"nm03-lint: bad baseline: {e}", file=sys.stderr)
            return 2
        new, matched = apply_baseline(
            [f for f in findings if f.rule not in NEVER_BASELINED], baseline)
        new = sorted(new + [f for f in findings if f.rule in NEVER_BASELINED],
                     key=lambda f: (f.path, f.line, f.rule))

    if args.format == "json":
        print(
            json.dumps(
                {
                    "files_scanned": len(files),
                    "findings": [f.to_json() for f in new],
                    "baselined": matched,
                },
                indent=1,
            )
        )
    else:
        for f in new:
            print(f.render())
        suffix = f" ({matched} baselined)" if matched else ""
        print(
            f"nm03-lint: {len(new)} new finding(s) across "
            f"{len(files)} file(s){suffix}"
        )
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
