"""NM392 — metrics<->docs drift in the port: every registered metric name is
documented in docs/OBSERVABILITY_TORCH.md, every documented name exists.

The port's copy of the JAX package's ``analysis/metricsdocs.py``. The
telemetry contract is three-sided: producers register series, the docs
table tells operators what each series means, and ``check_telemetry.py``
gates the schema. The weakest side is the docs. This rule leans on the
convention the port's metric-name modules follow: **every module-level
UPPERCASE string constant in ``serving/metrics.py`` and ``obs/metrics.py``
whose value is a Prometheus-legal lowercase name IS a metric name**
(schema strings like ``nm03.metrics.v1`` self-exclude via the dots).

The docs side is every table row of the port's own
``docs/OBSERVABILITY_TORCH.md`` whose second cell is a metric type::

    | `serving_mfu` | gauge | — | ... |

(``docs/OBSERVABILITY.md`` is the JAX package's table and is not read.)
Both directions are findings: a constant with no row anchors at the
constant's declaration; a row with no constant anchors at the docs line.
Fixture trees work the same way: any ``serving/metrics.py`` /
``obs/metrics.py`` under a scanned root is checked against THAT root's
``docs/OBSERVABILITY_TORCH.md``.

Rules:
  NM392  metric name registered-but-undocumented / documented-but-unregistered
"""

from __future__ import annotations

import ast
import posixpath
import re
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from nm03_capstone_project_tpu_torch.analysis.core import Finding, SourceFile

DOC_RELPATH = "docs/OBSERVABILITY_TORCH.md"

# the name-owning modules: <anything>/serving/metrics.py, <anything>/obs/metrics.py
_NAME_MODULE_DIRS = ("serving", "obs")

# a metric name as this codebase writes them: lowercase Prometheus-legal.
# Deliberately excludes dotted schema ids ("nm03.metrics.v1") and anything
# with uppercase (label-value enums etc. are not plain string constants).
_METRIC_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")
_METRIC_TYPES = ("counter", "gauge", "histogram")


def _is_name_module(relpath: str) -> bool:
    parts = relpath.split("/")
    return (
        len(parts) >= 2
        and parts[-1] == "metrics.py"
        and parts[-2] in _NAME_MODULE_DIRS
    )


def _module_constants(src: SourceFile) -> Dict[str, Tuple[int, str]]:
    """{metric name: (line, constant identifier)} of one name module.

    Only module-level ``UPPER_CASE = "literal"`` assignments count; a
    re-export (``from obs.metrics import X``) deliberately does not — the
    DEFINITION site is the single owner the rule binds to docs.
    """
    out: Dict[str, Tuple[int, str]] = {}
    if src.tree is None:
        return out
    for node in src.tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        target = node.targets[0]
        if not (
            isinstance(target, ast.Name)
            and target.id.isupper()
            and not target.id.startswith("_")  # module-private: not a contract
        ):
            continue
        if not (
            isinstance(node.value, ast.Constant)
            and isinstance(node.value.value, str)
        ):
            continue
        value = node.value.value
        if _METRIC_NAME_RE.match(value):
            out[value] = (node.lineno, target.id)
    return out


def _doc_metric_rows(doc_path: Path) -> Dict[str, Tuple[int, str]]:
    """{metric name: (line, raw line)} from the docs' metric tables.

    A metric row is a markdown table row whose first cell is a backticked
    Prometheus-shaped name and whose second cell is a bare metric type —
    exactly the shape every docs/OBSERVABILITY_TORCH.md metric table uses, and
    nothing else in the file (endpoint tables carry paths, span tables
    carry scopes in cell two).
    """
    out: Dict[str, Tuple[int, str]] = {}
    try:
        text = doc_path.read_text(encoding="utf-8", errors="replace")
    except OSError:
        return out
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped.startswith("|"):
            continue
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        if len(cells) < 2 or cells[1] not in _METRIC_TYPES:
            continue
        name = cells[0].strip("`").strip()
        if _METRIC_NAME_RE.match(name) and name not in out:
            out[name] = (lineno, line)
    return out


def check_metrics_docs(files: Sequence[SourceFile]) -> List[Finding]:
    # group the name modules by scan root: a fixture tree is its own
    # universe with its own docs file
    by_root: Dict[Path, List[SourceFile]] = {}
    for src in files:
        if _is_name_module(src.relpath):
            by_root.setdefault(src.root, []).append(src)

    findings: List[Finding] = []
    for root, modules in sorted(by_root.items(), key=lambda kv: str(kv[0])):
        doc_path = root / DOC_RELPATH
        registered: Dict[str, Tuple[SourceFile, int, str]] = {}
        for src in sorted(modules, key=lambda s: s.relpath):
            for name, (line, ident) in _module_constants(src).items():
                registered.setdefault(name, (src, line, ident))
        if not registered:
            continue
        if not doc_path.exists():
            src = min(modules, key=lambda s: s.relpath)
            findings.append(
                Finding(
                    rule="NM392",
                    path=src.relpath,
                    line=1,
                    message=(
                        f"metric name module has no {DOC_RELPATH} to "
                        "document against — every registered series must "
                        "have a docs table row (docs/STATIC_ANALYSIS_TORCH.md "
                        "NM392)"
                    ),
                    source_line=src.line_text(1),
                )
            )
            continue
        documented = _doc_metric_rows(doc_path)
        doc_rel = posixpath.join(*DOC_RELPATH.split("/"))
        for name, (src, line, ident) in sorted(registered.items()):
            if name in documented:
                continue
            findings.append(
                Finding(
                    rule="NM392",
                    path=src.relpath,
                    line=line,
                    message=(
                        f"metric {name!r} ({ident}) has no row in "
                        f"{DOC_RELPATH} — a series must ship documented "
                        "(name | type | labels | meaning) "
                        "(docs/STATIC_ANALYSIS_TORCH.md NM392)"
                    ),
                    source_line=src.line_text(line),
                )
            )
        for name, (lineno, raw) in sorted(documented.items()):
            if name in registered:
                continue
            findings.append(
                Finding(
                    rule="NM392",
                    path=doc_rel,
                    line=lineno,
                    message=(
                        f"documented metric {name!r} is not registered in "
                        "any metric-name module (serving/metrics.py, "
                        "obs/metrics.py) — a rename or removal left a "
                        "stale docs row (docs/STATIC_ANALYSIS_TORCH.md NM392)"
                    ),
                    source_line=raw,
                )
            )
    return findings
