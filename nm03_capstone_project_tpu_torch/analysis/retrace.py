"""NM31x — baked-in values in the port's CUDA graphs.

Eager PyTorch does not trace, so the JAX package's retrace hazard has no
literal counterpart. A CUDA graph has the same hazard turned around: a
capture records the work once, with every value the host supplied at
capture time baked into the graph, and a replay re-runs exactly that work.
Where jit re-traces (slow, but right), a replay silently re-uses (fast,
and wrong). The two statically visible forms:

* **NM311** — building a tensor from Python data inside a capture body:
  ``torch.tensor(...)``, ``torch.as_tensor(...)``, ``torch.from_numpy``,
  ``np.array``/``np.asarray`` inside ``with torch.cuda.graph(...)`` (or in
  a module-local function that body calls). The upload happens at capture
  time only; a replay never redoes it, so the graph keeps the value of the
  first batch. The idiom is a static input buffer filled before each
  replay (``BucketGraph``'s pinned twins and ``copy_``).
* **NM312** — a Python numeric literal passed to a captured or
  graph-keyed callable: a function called inside a capture body, or a
  name bound to ``torch.cuda.make_graphed_callables(...)`` /
  ``torch.compile(...)`` (or decorated with ``@torch.compile``). The
  literal is recorded into the graph (or specializes the compiled
  program) but is not part of the key the graph is looked up by — the
  executor keys its graphs by (lane, bucket) — so a caller passing another
  value replays the first value's work. ``torch.compile(dynamic=True)``
  marks the argument as part of the program's key and is exempt, as
  ``static_argnames`` is in the JAX rule.

Analysis is module-local by design, like the JAX rule: a capture and its
callee in different files resolve only at run time.

Rules:
  NM311  tensor construction from Python data inside a CUDA graph capture
  NM312  captured or graph-keyed callable called with a Python numeric literal
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from nm03_capstone_project_tpu_torch.analysis.core import Finding, SourceFile

_TENSOR_CTORS = {
    ("torch", "tensor"), ("torch", "as_tensor"), ("torch", "from_numpy"),
    ("np", "array"), ("np", "asarray"), ("numpy", "array"), ("numpy", "asarray"),
}
_GRAPHED = {"make_graphed_callables", "compile"}


def _attr_pair(func: ast.expr) -> Optional[Tuple[str, str]]:
    """('torch', 'tensor') for ``torch.tensor``; ('', 'f') for bare ``f``."""
    if isinstance(func, ast.Attribute) and isinstance(func.value, ast.Name):
        return (func.value.id, func.attr)
    if isinstance(func, ast.Name):
        return ("", func.id)
    return None


def _is_capture(ctx: ast.expr) -> bool:
    """``torch.cuda.graph(...)`` / ``cuda.graph(...)``."""
    if not isinstance(ctx, ast.Call):
        return False
    f = ctx.func
    if isinstance(f, ast.Attribute) and f.attr == "graph":
        return isinstance(f.value, (ast.Attribute, ast.Name)) and (
            (isinstance(f.value, ast.Attribute) and f.value.attr == "cuda")
            or (isinstance(f.value, ast.Name) and f.value.id == "cuda")
        )
    return False


def _graphed_call(node: ast.expr) -> Optional[bool]:
    """For ``torch.compile(...)``/``make_graphed_callables(...)``: True
    when the call marks arguments dynamic (exempt), False otherwise; None
    for any other expression."""
    if not isinstance(node, ast.Call):
        return None
    pair = _attr_pair(node.func)
    if pair is None or pair[1] not in _GRAPHED:
        return None
    if pair[1] == "compile" and pair[0] not in ("torch", ""):
        return None
    for kw in node.keywords:
        if kw.arg == "dynamic" and isinstance(kw.value, ast.Constant) and kw.value.value:
            return True
    return False


def _is_number_literal(node: ast.expr) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return not isinstance(node.value, bool)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub, ast.UAdd)):
        return _is_number_literal(node.operand)
    return False


def _walk_same_execution(nodes):
    stack = list(nodes)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def check_retrace(files: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        if src.tree is None:
            continue
        defs: Dict[str, ast.AST] = {
            n.name: n for n in ast.walk(src.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        }
        # graph-keyed names: bound to make_graphed_callables/torch.compile
        graphed: Dict[str, bool] = {}
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Assign):
                dyn = _graphed_call(node.value)
                if dyn is not None:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            graphed[t.id] = dyn
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    dyn = _graphed_call(dec)
                    if dyn is None and _attr_pair(dec) in (("torch", "compile"),):
                        dyn = False
                    if dyn is not None:
                        graphed[node.name] = dyn

        # capture bodies, and the module-local functions they call
        bodies: List[List[ast.stmt]] = []
        for node in ast.walk(src.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)) and any(
                _is_capture(item.context_expr) for item in node.items
            ):
                bodies.append(node.body)
        reported: Set[Tuple[str, int]] = set()

        def emit(rule: str, line: int, message: str) -> None:
            if (rule, line) in reported:
                return
            reported.add((rule, line))
            findings.append(Finding(rule=rule, path=src.relpath, line=line,
                                    message=message, source_line=src.line_text(line)))

        frontier = list(bodies)
        visited: Set[int] = set()
        while frontier:
            body = frontier.pop()
            for sub in _walk_same_execution(body):
                if not isinstance(sub, ast.Call):
                    continue
                pair = _attr_pair(sub.func)
                if pair in _TENSOR_CTORS:
                    emit("NM311", sub.lineno,
                         f"{pair[0]}.{pair[1]}() inside a CUDA graph capture: the "
                         "upload runs at capture only and every replay reuses the "
                         "captured value — fill a static input buffer before the "
                         "replay instead")
                if pair is not None and pair[0] == "" and pair[1] in defs:
                    fn = defs[pair[1]]
                    if id(fn) not in visited:
                        visited.add(id(fn))
                        frontier.append(fn.body)
                    if any(_is_number_literal(a) for a in sub.args):
                        emit("NM312", sub.lineno,
                             f"{pair[1]}() called with a Python numeric literal inside "
                             "a CUDA graph capture — the value is baked into the "
                             "graph, which is keyed by (lane, bucket) only; pass it "
                             "as a tensor in a static buffer or key the graph by it")

        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Name):
                continue
            dyn = graphed.get(node.func.id)
            if dyn is None or dyn:
                continue
            if any(_is_number_literal(a) for a in node.args):
                emit("NM312", node.lineno,
                     f"graph-keyed {node.func.id}() called with a Python numeric "
                     "literal — a graphed callable bakes it in, a compiled one "
                     "specializes on it; pass a tensor or mark it dynamic")
    return findings
