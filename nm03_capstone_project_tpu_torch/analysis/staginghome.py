"""NM401 — staging home of the port: host->card copies live in ingest/.

The streaming-ingest subsystem exists because scattered staging already
cost the JAX package its headline (serial per-driver ``device_put`` loops
left the device starved), and the port keeps the discipline: the batch
drivers' slices reach the card through ``ingest/`` (pinned host buffers,
``non_blocking`` copies on the stager's stream, the ring's occupancy and
the upload-overlap telemetry). A staging call elsewhere is one refactor
away from an upload the ingest telemetry cannot see and the ``--sanitize``
upload guard cannot attribute.

In torch the host->card entry points are:

* ``.cuda()``;
* ``.to(<device>)`` — a positional or ``device=`` argument that names a
  device: a ``"cuda..."`` string, ``torch.device(...)``, or a name or
  attribute spelled like one (``dev``, ``device``, ``self.device``,
  ``x.device``); ``.to("cpu")`` and dtype-only ``.to(torch.uint8)`` are
  not staging;
* ``torch.as_tensor(..., device=...)`` / ``torch.tensor(..., device=...)``
  with a device other than ``"cpu"``;
* ``.pin_memory()``;
* ``.copy_(..., non_blocking=True)``.

Sanctioned homes (no finding): ``ingest/`` — THE staging home — and
``utils/sanitize.py``, the runtime twin that polices this very hazard.
Everything else suppresses with a reason (docs/STATIC_ANALYSIS_TORCH.md)
or sits in the baseline: a CUDA graph's static input buffers (the graph's
own staging, in ``serving/graphs.py``), one-time weight placement, moves
between devices of a mesh, and the entry points' ``device=`` argument,
where a caller's host array becomes the pipeline's input.

Rule:
  NM401  a host->card copy outside ingest/
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Set, Tuple

from nm03_capstone_project_tpu_torch.analysis.compilehome import annotation_nodes
from nm03_capstone_project_tpu_torch.analysis.core import Finding, SourceFile

_PKG = "nm03_capstone_project_tpu_torch/"
_SANCTIONED_PREFIXES = (
    f"{_PKG}ingest/",
    f"{_PKG}utils/sanitize.py",
)
_TENSOR_CTORS = {"as_tensor", "tensor"}


def _terminal(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _names_device(node: ast.expr) -> bool:
    """True when an argument visibly names a (non-CPU) device."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    if isinstance(node, ast.Call):
        fn = node.func
        if _terminal(fn) == "device":
            return not (node.args and isinstance(node.args[0], ast.Constant)
                        and node.args[0].value == "cpu")
        return False
    name = _terminal(node)
    if name is None:
        return False
    low = name.lower()
    if "dtype" in low:
        return False
    return low in ("dev", "device", "devs", "target") or low.endswith("_dev") \
        or low.endswith("device") or low.startswith("dev_")


def _staging(node: ast.Call) -> Optional[str]:
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    m = func.attr
    if m == "cuda":
        return ".cuda()"
    if m == "pin_memory" and not node.args:
        return ".pin_memory()"
    if m == "copy_":
        for kw in node.keywords:
            if kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is True:
                return ".copy_(..., non_blocking=True)"
        return None
    if m == "to":
        cands = list(node.args[:1]) + [kw.value for kw in node.keywords if kw.arg == "device"]
        if any(_names_device(c) for c in cands):
            return ".to(<device>)"
        return None
    if m in _TENSOR_CTORS and _terminal(func.value) == "torch":
        for kw in node.keywords:
            if kw.arg == "device" and not (
                isinstance(kw.value, ast.Constant) and kw.value.value == "cpu"
            ) and not (isinstance(kw.value, ast.Constant) and kw.value.value is None):
                return f"torch.{m}(..., device=...)"
    return None


def check_staging_home(files: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        if src.tree is None or src.relpath.startswith(_SANCTIONED_PREFIXES):
            continue
        if not src.relpath.startswith(_PKG):
            continue  # chip_smoke.py and scripts/ measure: the upload is their subject
        in_annotation = annotation_nodes(src.tree)
        seen: Set[Tuple[int, str]] = set()
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or id(node) in in_annotation:
                continue
            what = _staging(node)
            if what is None or (node.lineno, what) in seen:
                continue
            seen.add((node.lineno, what))
            findings.append(
                Finding(
                    rule="NM401",
                    path=src.relpath,
                    line=node.lineno,
                    message=(
                        f"{what} outside ingest/ — host->card staging belongs "
                        "to the streaming-ingest subsystem (ingest.staging's "
                        "Stager); graph inputs, weight placement and mesh "
                        "moves suppress with a reason "
                        "(docs/STATIC_ANALYSIS_TORCH.md)"
                    ),
                    source_line=src.line_text(node.lineno),
                )
            )
    return findings
