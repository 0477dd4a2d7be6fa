"""NM30x — import contracts of the port: the stdlib-only registry, and no JAX.

Several of the port's modules declare, in prose, that importing them must
never import torch or numpy: the resilience package (its supervisor,
policy and fault plans are unit-testable without a backend), the obs
package (telemetry importable from any process, the flight recorder from a
wedged one), ``ops.selection_network`` (the median planner is consumed by
the kernel build, which generates CUDA headers from it), the serving
queue, metric names, lane state machine and ``nm03-top``, the fleet
front-end and the result tier (the router must start in milliseconds), the
ingest ring and pipeline (torch enters only through ``ingest.staging``,
which imports numpy and torch at import time and is therefore NOT
registered), the lockdep witness and the ``--sanitize`` state, and this
analysis package itself — the gate gates itself.

The rule walks *module-level* imports only: a lazy ``import torch`` inside
a function is the sanctioned pattern and is not an import-time cost.
``if TYPE_CHECKING:`` blocks are exempt for the same reason. Transitivity
is enforced over project-internal edges: a contract module importing a
sibling that imports torch is the same violation one hop later.

The port never imports JAX or anything of the JAX package
(``nm03_capstone_project_tpu``), at import time or lazily: NM303 is the
static face of ``tests/test_torch_guards.py``. Package names are matched
with their separator — ``nm03_capstone_project_tpu`` is a prefix of
``nm03_capstone_project_tpu_torch``, and a bare ``startswith`` would
confuse the two.

Rules:
  NM301  contract module (transitively) imports a banned package at
         import time
  NM302  registry drift: a registered module/package no longer exists in
         the scanned tree (the contract would silently stop being checked)
  NM303  the port (its package or ``chip_smoke.py``) imports ``jax`` or
         the JAX package, anywhere in a file
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Sequence, Set, Tuple

from nm03_capstone_project_tpu_torch.analysis.core import Finding, SourceFile

# module-or-package-prefix -> banned top-level packages. A key matches
# itself and (for packages) every submodule under it.
_P = "nm03_capstone_project_tpu_torch"
CONTRACT_REGISTRY: Dict[str, Tuple[str, ...]] = {
    f"{_P}.resilience": ("torch", "numpy"),
    f"{_P}.obs": ("torch", "numpy"),
    # pinned on top of the obs entry: a move out of obs/ must trip NM302
    # rather than shed the contract (dumps from wedged processes)
    f"{_P}.obs.trace": ("torch", "numpy"),
    f"{_P}.obs.flightrec": ("torch", "numpy"),
    # the kernel build generates the median headers from it
    f"{_P}.ops.selection_network": ("torch", "numpy"),
    # the serving package's __init__ is lazy, so these hold numpy out too
    f"{_P}.serving.queue": ("torch", "numpy"),
    f"{_P}.serving.metrics": ("torch", "numpy"),
    f"{_P}.serving.lanes": ("torch", "numpy"),
    f"{_P}.serving.top": ("torch", "numpy"),
    f"{_P}.utils.reporter": ("torch", "numpy"),
    # ring and pipeline only: ingest.staging imports numpy and torch at
    # import time (it is the stage callable), so it is not registered
    f"{_P}.ingest.ring": ("torch", "numpy"),
    f"{_P}.ingest.pipeline": ("torch", "numpy"),
    f"{_P}.fleet": ("torch", "numpy"),
    f"{_P}.cache": ("torch", "numpy"),
    # the compile cache and its CLI: the key comes from kernels/build.py,
    # imported only where a key is computed
    f"{_P}.compilehub": ("torch", "numpy"),
    # the runtime twins: importable (and the witness dumpable) without a
    # backend; sanitize imports torch inside the checks that need it
    f"{_P}.utils.lockdep": ("torch", "numpy"),
    f"{_P}.utils.sanitize": ("torch", "numpy"),
    # the gate gates itself
    f"{_P}.analysis": ("torch", "numpy"),
}

# the JAX package's name, banned in the port (NM303)
JAX_PACKAGE = "nm03_capstone_project_tpu"
NM303_FILES = ("chip_smoke.py",)

PROJECT_PREFIX = _P


class _ImportEdge:
    __slots__ = ("target", "line", "source_line")

    def __init__(self, target: str, line: int, source_line: str):
        self.target = target
        self.line = line
        self.source_line = source_line


def _module_level_imports(src: SourceFile) -> List[_ImportEdge]:
    """Imports executed when the module is imported.

    Walks the top level plus import-time bodies (if/try at module scope,
    class bodies); skips function bodies and TYPE_CHECKING guards.
    """
    edges: List[_ImportEdge] = []
    if src.tree is None:
        return edges

    def is_type_checking(test: ast.expr) -> bool:
        return (isinstance(test, ast.Name) and test.id == "TYPE_CHECKING") or (
            isinstance(test, ast.Attribute) and test.attr == "TYPE_CHECKING"
        )

    def relative_base(level: int) -> str:
        """The package a level-N relative import resolves against.

        For pkg/mod.py (module 'pkg.mod') level 1 is 'pkg' — strip one
        component; for pkg/__init__.py the module name 'pkg' already IS
        the package, so level 1 strips zero components (stripping one
        would resolve 'from .events import X' against pkg's PARENT and
        silently drop the edge from the contract graph).
        """
        strip = level - 1 if src.is_package else level
        name = src.module_name
        for _ in range(strip):
            name = name.rsplit(".", 1)[0] if "." in name else ""
        return name

    def walk(body: Iterable[ast.stmt]) -> None:
        for node in body:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    edges.append(
                        _ImportEdge(alias.name, node.lineno, src.line_text(node.lineno))
                    )
            elif isinstance(node, ast.ImportFrom):
                if node.level and node.module is None:
                    # `from . import x` — resolve against the package
                    pkg = relative_base(node.level)
                    for alias in node.names:
                        edges.append(
                            _ImportEdge(
                                f"{pkg}.{alias.name}" if pkg else alias.name,
                                node.lineno,
                                src.line_text(node.lineno),
                            )
                        )
                elif node.module:
                    mod = node.module
                    if node.level:
                        base = relative_base(node.level)
                        mod = f"{base}.{mod}" if base else mod
                    edges.append(
                        _ImportEdge(mod, node.lineno, src.line_text(node.lineno))
                    )
            elif isinstance(node, ast.If):
                if not is_type_checking(node.test):
                    walk(node.body)
                walk(node.orelse)
            elif isinstance(node, (ast.Try, ast.With)):
                for sub in ast.iter_child_nodes(node):
                    if isinstance(sub, ast.stmt):
                        walk([sub])
                if isinstance(node, ast.Try):
                    for h in node.handlers:
                        walk(h.body)
            elif isinstance(node, ast.ClassDef):
                walk(node.body)
            # FunctionDef / AsyncFunctionDef bodies are lazy: not walked
    walk(src.tree.body)
    return edges


def _in_package(module: str, package: str) -> bool:
    """``module`` is ``package`` or below it — matched with the separator."""
    return module == package or module.startswith(package + ".")


def _registered_bans(module: str) -> Tuple[str, ...]:
    bans: Set[str] = set()
    for prefix, banned in CONTRACT_REGISTRY.items():
        if _in_package(module, prefix):
            bans.update(banned)
    return tuple(sorted(bans))


def check_import_contracts(files: Sequence[SourceFile]) -> List[Finding]:
    by_module: Dict[str, SourceFile] = {f.module_name: f for f in files}
    imports: Dict[str, List[_ImportEdge]] = {
        name: _module_level_imports(f) for name, f in by_module.items()
    }

    def resolve_internal(target: str) -> List[str]:
        """Project-internal modules a dotted import EXECUTES ([] if external).

        ``from pkg.mod import name`` may name either pkg.mod.name (a module)
        or an attribute of pkg.mod; importing either executes pkg.mod — and
        Python also executes every ancestor package ``__init__`` on the way
        down, so the whole chain joins the contract graph (a banned import
        hidden in an ancestor ``__init__`` is the same import-time cost).
        """
        hits: List[str] = []
        candidates = [target]
        if "." in target:
            candidates.append(target.rsplit(".", 1)[0])
        for cand in candidates:
            while cand:
                if cand in by_module and cand not in hits:
                    hits.append(cand)
                cand = cand.rsplit(".", 1)[0] if "." in cand else ""
        return hits

    findings: List[Finding] = []
    seen_keys: Set[Tuple[str, str, int]] = set()

    for prefix in CONTRACT_REGISTRY:
        if not any(_in_package(m, prefix) for m in by_module):
            # only report drift when the scan plausibly covers the tree the
            # registry describes (a fixture dir with its own modules should
            # not fail for missing THIS repo's files)
            if any(_in_package(m, PROJECT_PREFIX) for m in by_module):
                anchor = next((f for f in files
                               if _in_package(f.module_name, PROJECT_PREFIX)), None)
                findings.append(
                    Finding(
                        rule="NM302",
                        path=anchor.relpath if anchor else "<registry>",
                        line=1,
                        message=(
                            f"import-contract registry names {prefix!r} but no "
                            "such module is in the scanned tree — update "
                            "analysis.contracts.CONTRACT_REGISTRY"
                        ),
                    )
                )

    for module, src in by_module.items():
        bans = _registered_bans(module)
        if not bans:
            continue
        # BFS over project-internal import-time edges from this module
        stack: List[Tuple[str, List[str]]] = [(module, [])]
        visited: Set[str] = set()
        while stack:
            cur, chain = stack.pop()
            if cur in visited:
                continue
            visited.add(cur)
            for edge in imports.get(cur, ()):
                top = edge.target.split(".")[0]
                if top in bans:
                    # report at the root module's matching import when the
                    # violation is direct; otherwise at the offending hop
                    where = by_module[cur]
                    via = " -> ".join(chain + [cur]) if chain else None
                    msg = (
                        f"{module} is declared {'/'.join(bans)}-free at import "
                        f"time but imports {edge.target!r}"
                    )
                    if via:
                        msg += f" (via {via})"
                    key = (module, edge.target, edge.line)
                    if key not in seen_keys:
                        seen_keys.add(key)
                        findings.append(
                            Finding(
                                rule="NM301",
                                path=where.relpath,
                                line=edge.line,
                                message=msg,
                                source_line=edge.source_line,
                            )
                        )
                    continue
                for internal in resolve_internal(edge.target):
                    if internal not in visited:
                        stack.append((internal, chain + [cur]))
    return findings


def _bans_jax(target: str) -> bool:
    top = target.split(".")[0]
    return top == "jax" or top == JAX_PACKAGE


def check_no_jax(files: Sequence[SourceFile]) -> List[Finding]:
    """NM303: every import in the port's files, at any depth — the port
    keeps its own copy of whatever it needs of the JAX package."""
    findings: List[Finding] = []
    for src in files:
        if src.tree is None:
            continue
        if not (_in_package(src.module_name, PROJECT_PREFIX)
                or src.relpath in NM303_FILES):
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Import):
                targets = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                targets = [node.module]
            else:
                continue
            for target in targets:
                if _bans_jax(target):
                    findings.append(
                        Finding(
                            rule="NM303",
                            path=src.relpath,
                            line=node.lineno,
                            message=(
                                f"the port imports {target!r} — it never imports "
                                "jax or the JAX package, not even lazily; keep a "
                                "copy of what it needs in the port"
                            ),
                            source_line=src.line_text(node.lineno),
                        )
                    )
                    break
    return findings
