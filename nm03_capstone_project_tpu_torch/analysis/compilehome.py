"""NM361 — compile homes of the port: CUDA graphs in serving/graphs.py, the
kernel build in kernels/build.py and native/buildlib.py.

The JAX package keeps jit/pjit/shard_map in its compile hub because a
scattered compile site is one upgrade away from an AttributeError and, more
quietly, from a program the hub's warmup and accounting cannot see. Eager
PyTorch has no jit, but the port has the same two kinds of "compile", each
with one home:

* **CUDA graphs** — ``torch.cuda.graph``, ``torch.cuda.CUDAGraph``,
  ``torch.cuda.make_graphed_callables`` (and ``torch.compile``, which
  builds graphs of its own) belong to ``serving/graphs.py``: its capture
  rules (eager warm iterations first, one memory pool a lane, no host read
  at replay) are what make a replay equal to the eager run, and the
  executor's warmup, ``/readyz`` and the ``--sanitize`` recompile watchdog
  only see the graphs it captures;
* **native libraries** — ``ctypes.CDLL`` and an ``nvcc`` subprocess
  belong to ``kernels/build.py`` (the CUDA kernels, keyed by NM381) and
  ``native/buildlib.py`` (the host C++ layer): a library loaded elsewhere
  escapes the build key and the watchdog's count of library loads.

References are AST attribute/name references (a decorator, a call, a
``functools.partial`` argument alike), so strings and docstrings never
trip the rule. The host C++ shims that load what ``native/buildlib.py``
built (``native/__init__.py``, ``data/gdcm_fallback.py``) carry reasoned
suppressions.

Rule:
  NM361  CUDA graph / torch.compile / CDLL / nvcc referenced outside its home
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from nm03_capstone_project_tpu_torch.analysis.core import Finding, SourceFile

_PKG = "nm03_capstone_project_tpu_torch/"
_GRAPH_HOMES = (f"{_PKG}serving/graphs.py",)
_BUILD_HOMES = (f"{_PKG}kernels/build.py", f"{_PKG}native/buildlib.py")

# dotted references (after alias resolution) -> the home they belong to
_GRAPH_REFS = {
    "torch.cuda.graph", "torch.cuda.CUDAGraph", "torch.cuda.make_graphed_callables",
    "torch.compile", "torch.cuda.graphs.graph", "torch.cuda.graphs.CUDAGraph",
    "torch.cuda.graphs.make_graphed_callables",
}
_BUILD_REFS = {"ctypes.CDLL", "ctypes.cdll.LoadLibrary", "ctypes.PyDLL"}
_SUBPROCESS_CALLS = {"run", "Popen", "call", "check_call", "check_output"}


def _dotted(node: ast.expr) -> Optional[str]:
    """'torch.cuda.graph' for a Name/Attribute chain; None otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def _module_aliases(tree: ast.AST, roots: Tuple[str, ...]) -> Dict[str, str]:
    """Local names bound to ``roots`` modules or their members:
    ``import torch.cuda as tc`` -> {'tc': 'torch.cuda'}; ``from torch.cuda
    import graph`` -> {'graph': 'torch.cuda.graph'}."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] in roots:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            if node.module.split(".")[0] in roots:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _resolve(node: ast.expr, aliases: Dict[str, str]) -> Optional[str]:
    base = _dotted(node)
    if base is None:
        return None
    head = base.split(".")[0]
    if head in aliases:
        base = aliases[head] + base[len(head):]
    return base


def annotation_nodes(tree: ast.AST) -> Set[int]:
    """ids of every node inside a type annotation: naming a type is not
    using it (``Optional[ctypes.CDLL]`` loads nothing)."""
    out: Set[int] = set()
    for node in ast.walk(tree):
        anns: List[Optional[ast.expr]] = []
        if isinstance(node, ast.AnnAssign):
            anns.append(node.annotation)
        elif isinstance(node, ast.arg):
            anns.append(node.annotation)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            anns.append(node.returns)
        for ann in anns:
            if ann is not None:
                out.update(id(sub) for sub in ast.walk(ann))
    return out


def _names_nvcc(call: ast.Call) -> bool:
    """A subprocess call whose argv visibly names nvcc."""
    for sub in ast.walk(call):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and "nvcc" in sub.value:
            return True
        if isinstance(sub, ast.Name) and "nvcc" in sub.id.lower():
            return True
    return False


def check_compile_home(files: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        if src.tree is None:
            continue
        graph_home = src.relpath in _GRAPH_HOMES
        build_home = src.relpath in _BUILD_HOMES
        if graph_home and build_home:
            continue
        aliases = _module_aliases(src.tree, ("torch", "ctypes", "subprocess"))
        in_annotation = annotation_nodes(src.tree)
        seen: Set[Tuple[int, str]] = set()

        def emit(line: int, what: str, home: str) -> None:
            if (line, what) in seen:
                return
            seen.add((line, what))
            findings.append(
                Finding(
                    rule="NM361",
                    path=src.relpath,
                    line=line,
                    message=(
                        f"{what} referenced outside {home} — graph capture and "
                        "native builds each have one home, where warmup, the "
                        "build key and the --sanitize watchdog see them; call "
                        "into the home, or suppress with a reason "
                        "(docs/STATIC_ANALYSIS_TORCH.md)"
                    ),
                    source_line=src.line_text(line),
                )
            )

        for node in ast.walk(src.tree):
            if id(node) in in_annotation:
                continue
            if isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    full = f"{node.module}.{a.name}"
                    if full in _GRAPH_REFS and not graph_home:
                        emit(node.lineno, full, "serving/graphs.py")
                    elif full in _BUILD_REFS and not build_home:
                        emit(node.lineno, full, "kernels/build.py")
            elif isinstance(node, ast.Attribute) or (
                isinstance(node, ast.Name) and node.id in aliases
            ):
                full = _resolve(node, aliases)
                if full in _GRAPH_REFS and not graph_home:
                    emit(node.lineno, full, "serving/graphs.py")
                elif full in _BUILD_REFS and not build_home:
                    emit(node.lineno, full, "kernels/build.py")
            elif isinstance(node, ast.Call) and not build_home:
                fn = _resolve(node.func, aliases)
                if fn and fn.startswith("subprocess.") \
                        and fn.split(".")[-1] in _SUBPROCESS_CALLS and _names_nvcc(node):
                    emit(node.lineno, "an nvcc subprocess", "kernels/build.py")
    return findings
