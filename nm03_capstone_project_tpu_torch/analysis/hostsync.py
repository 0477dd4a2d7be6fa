"""NM32x — implicit device->host syncs where they corrupt telemetry or stall
the dispatch thread, in the port.

The port's copy of the JAX package's ``analysis/hostsync.py``. In eager
PyTorch a kernel launch returns at once and the card runs ahead of the
host; an implicit sync in the wrong place serializes the whole pipeline
and silently poisons the numbers used to detect exactly that. The implicit
device->host syncs of torch are ``.item()``, ``.cpu()``, ``.numpy()``,
``.tolist()``, ``float()``/``int()``/``bool()`` of a tensor expression,
``np.asarray``/``np.array`` of a tensor and ``torch.cuda.synchronize()``
(any ``.synchronize()``). Two scopes carry the hazard:

* **obs span bodies** (``with ....span(...)`` / ``.section(...)``): a sync
  inside a span blocks on the stream, so the span's histogram stops
  measuring the stage and starts measuring the backlog;
* **serving dispatch paths**: the batcher's loop and chunk path, the warm
  executor's ``run_batch`` (the supervised primary and its fetch are the
  sanctioned home: nested defs are not walked), a bucket graph's
  ``launch`` (the replay) and the volume gang's dispatch. One stray sync
  on the dispatch thread stalls every queued request behind it.

Both scopes have deliberate syncs today; those carry inline suppressions
with reasons or baseline entries, which is the point: where the syncs are
is written down, not tribal knowledge.

Rules:
  NM321  implicit device->host sync inside an obs span body
  NM322  implicit device->host sync in a serving dispatch-path function
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Tuple

from nm03_capstone_project_tpu_torch.analysis.core import Finding, SourceFile

# functions forming the serving dispatch path: relpath -> qualified names
DISPATCH_PATHS: Dict[str, Tuple[str, ...]] = {
    "nm03_capstone_project_tpu_torch/serving/batcher.py": (
        "DynamicBatcher._run",
        "DynamicBatcher.execute",
        "DynamicBatcher._dispatch",
        # the per-lane chunk path: a stray sync stalls that lane's chunk
        "DynamicBatcher._execute_chunk",
    ),
    "nm03_capstone_project_tpu_torch/serving/executor.py": (
        "WarmExecutor.run_batch",
    ),
    # the graph replay: four async copies and one cudaGraphLaunch
    "nm03_capstone_project_tpu_torch/serving/graphs.py": (
        "BucketGraph.launch",
    ),
    # the gang's dispatch of a study over the lanes (or the job's ranks)
    "nm03_capstone_project_tpu_torch/serving/volumes.py": (
        "VolumeGang._dispatch_volume",
        "VolumeGang._dispatch_across_job",
    ),
}

_TRANSFER_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_TRANSFER_CALLS = {
    ("np", "asarray"), ("np", "array"),
    ("numpy", "asarray"), ("numpy", "array"),
}


def _attr_pair(func: ast.expr) -> Optional[Tuple[str, str]]:
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        return (func.value.id, func.attr)
    return None


def _sync_description(node: ast.Call, rule: str) -> Optional[str]:
    """Human name of the sync this call performs, or None."""
    if isinstance(node.func, ast.Attribute) and node.func.attr in _TRANSFER_ATTRS:
        return f".{node.func.attr}()"
    pair = _attr_pair(node.func)
    if pair in _TRANSFER_CALLS:
        return f"{pair[0]}.{pair[1]}()"
    if isinstance(node.func, ast.Name):
        # print() is only a hazard on the dispatch thread (NM322): driver
        # spans print host strings; the batcher thread must never block on
        # console IO (or format a device array) between batches
        if rule == "NM322" and node.func.id == "print" and node.args and not all(
            isinstance(a, ast.Constant) for a in node.args
        ):
            return "print() of a runtime value"
        if node.func.id in ("float", "int", "bool") and node.args and isinstance(
            node.args[0], (ast.Call, ast.Subscript)
        ):
            if _is_shape_access(node.args[0]):
                return None  # shapes are host metadata, never a transfer
            return f"{node.func.id}() of an expression"
    return None


def _is_shape_access(node: ast.expr) -> bool:
    """x.shape[i] / len-like metadata reads that never touch the device."""
    if isinstance(node, ast.Subscript) and isinstance(node.value, ast.Attribute):
        return node.value.attr in ("shape", "dims")
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id == "len"
    return False


def _walk_same_execution(body: List[ast.stmt]):
    """Walk statements WITHOUT descending into nested defs/lambdas: a
    closure defined in a span body does not execute in it (the supervised
    ``primary()`` is the sanctioned home for fetches)."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _findings_in(
    src: SourceFile, body: List[ast.stmt], rule: str, where: str
) -> List[Finding]:
    out: List[Finding] = []
    for sub in _walk_same_execution(body):
        if not isinstance(sub, ast.Call):
            continue
        desc = _sync_description(sub, rule)
        if desc is None:
            continue
        hint = (
            "sync before the span opens, or suppress with why the wait "
            "belongs to this stage"
            if rule == "NM321"
            else "fetch inside the supervised primary, not on the "
            "dispatch thread"
        )
        out.append(
            Finding(
                rule=rule,
                path=src.relpath,
                line=sub.lineno,
                message=(
                    f"{desc} inside {where} forces a device sync — {hint}"
                ),
                source_line=src.line_text(sub.lineno),
            )
        )
    return out


def _is_span_with(node: ast.With) -> bool:
    for item in node.items:
        ctx = item.context_expr
        if isinstance(ctx, ast.Call) and isinstance(ctx.func, ast.Attribute):
            if ctx.func.attr in ("span", "section"):
                return True
    return False


def check_host_sync(files: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        if src.tree is None:
            continue

        # NM321 — span bodies anywhere in the tree
        for node in ast.walk(src.tree):
            if isinstance(node, ast.With) and _is_span_with(node):
                findings.extend(
                    _findings_in(src, node.body, "NM321", "an obs span body")
                )

        # NM322 — the registered serving dispatch-path functions
        wanted = DISPATCH_PATHS.get(src.relpath)
        if not wanted:
            continue
        for cls in src.tree.body:
            if not isinstance(cls, ast.ClassDef):
                continue
            for fn in cls.body:
                if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                qual = f"{cls.name}.{fn.name}"
                if qual in wanted:
                    findings.extend(
                        _findings_in(
                            src, fn.body, "NM322", f"dispatch path {qual}"
                        )
                    )
    # span-body findings can double-report a call that is ALSO in a
    # dispatch function; keep the more specific NM322 in that case
    nm322_sites = {(f.path, f.line) for f in findings if f.rule == "NM322"}
    return [
        f
        for f in findings
        if not (f.rule == "NM321" and (f.path, f.line) in nm322_sites)
    ]
