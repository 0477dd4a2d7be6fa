"""NM35x — artifact writes in the port must use the tmp+rename idiom.

A result JSON, manifest, journal snapshot, or exported JPEG is a *promise*:
``--resume`` folds it into the manifest, ``check_telemetry.py`` validates
it, a judge diffs it. PR 3 established the discipline — write to
``<path>.tmp``, then ``os.replace`` — so a SIGTERM/ENOSPC mid-write leaves
either the old artifact or a stray ``.tmp``, never a torn file that parses
as truth. This rule catches the writes that bypass it.

Heuristic: any truncating write (``open(..., "w"/"wb")``,
``Path.write_text``, ``Path.write_bytes``) is a candidate; it is exempt
when the enclosing function visibly completes the idiom (an ``os.replace``
call in the same function) or the target expression names a tmp file.
Append-mode opens are exempt by design — the journal's torn-tail-safe
append IS the other sanctioned idiom. Long-lived streaming sinks (the
JSONL event log) are real exceptions and carry inline suppressions with
the reason, which doubles as their documentation.

Rules:
  NM351  truncating artifact write without the tmp+rename idiom
  NM371  flight-recorder/trace module writes a file without atomic_write_*
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence

from nm03_capstone_project_tpu_torch.analysis.core import Finding, SourceFile


def _literal_mode(node: ast.Call) -> Optional[str]:
    """The mode of an open() call when statically known ('r' default)."""
    if len(node.args) >= 2:
        m = node.args[1]
        if isinstance(m, ast.Constant) and isinstance(m.value, str):
            return m.value
        return None  # dynamic mode: cannot judge
    for kw in node.keywords:
        if kw.arg == "mode":
            if isinstance(kw.value, ast.Constant) and isinstance(
                kw.value.value, str
            ):
                return kw.value.value
            return None
    return "r"


def _names_tmp(node: ast.expr) -> bool:
    """True when the path expression visibly names a tmp target."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if "tmp" in sub.value.lower():
                return True
        if isinstance(sub, ast.Name) and "tmp" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "tmp" in sub.attr.lower():
            return True
    return False


def _enclosing_function(
    tree: ast.AST, lineno: int
) -> Optional[ast.AST]:
    best = None
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            end = getattr(node, "end_lineno", None) or node.lineno
            if node.lineno <= lineno <= end:
                if best is None or node.lineno > best.lineno:
                    best = node
    return best


def _has_replace(scope: ast.AST) -> bool:
    """os.replace/os.rename, or <tmp-ish>.replace()/.rename() — NOT a bare
    str.replace, which must not count as completing the idiom."""
    for node in ast.walk(scope):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            base = node.func.value
            if attr in ("replace", "rename"):
                if isinstance(base, ast.Name) and base.id == "os":
                    return True
                if _names_tmp(base):
                    return True
    return False


# NM371 — the post-mortem modules' write discipline is stricter than
# NM351: a flight-recorder dump races the very crash it documents, and a
# trace export may be cut by the next SIGTERM, so BOTH must route every
# write through utils.atomicio.atomic_write_* — no hand-rolled tmp+rename
# (which NM351 would accept) and no direct write primitives at all.
OBS_DUMP_MODULES: tuple = (
    "nm03_capstone_project_tpu_torch/obs/flightrec.py",
    "nm03_capstone_project_tpu_torch/obs/trace.py",
)

_DIRECT_WRITE_ATTRS = ("write_text", "write_bytes")
_HAND_ROLLED = ("replace", "rename", "mkstemp", "NamedTemporaryFile")


_MODE_CHARS = set("rwaxbtU+")


def _attr_open_mode(node: ast.Call) -> Optional[str]:
    """Best-effort mode of an attribute-style open call.

    Covers BOTH calling conventions: ``Path(p).open(mode, ...)`` (mode
    first) and ``io.open(path, mode, ...)`` (path first) — any string
    literal among the first two positionals that *looks like* a mode
    string counts, so a literal path (``io.open("debug.json", "w")``)
    can never masquerade as a read mode. None = statically unjudgeable,
    which the caller flags — strictness is this rule's contract.
    """
    for kw in node.keywords:
        if kw.arg == "mode":
            if isinstance(kw.value, ast.Constant) and isinstance(
                kw.value.value, str
            ):
                return kw.value.value
            return None
    candidates = []
    saw_non_literal = False
    for a in node.args[:2]:
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            v = a.value
            if v and set(v) <= _MODE_CHARS and len(v) <= 4:
                candidates.append(v)
        else:
            saw_non_literal = True
    if candidates:
        for v in candidates:  # the most write-looking candidate decides
            if any(c in v for c in "wax+"):
                return v
        return candidates[0]
    if saw_non_literal:
        return None
    return "r"


def _hand_rolled_bindings(tree: ast.AST):
    """Names that reach the hand-rolled write primitives in this module.

    NM371's contract is ANY spelling: ``import os as _os`` and
    ``from os import replace as rp`` must not slip past a matcher pinned
    to the literal attribute form ``os.replace``. Returns
    (module_aliases, bare_names): local names bound to the os/tempfile
    modules, and local names bound directly to a hand-rolled primitive
    (mapped back to its canonical ``module.attr`` for the message).
    """
    module_aliases = set()
    bare_names = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname is None:
                    # `import os.path` binds the TOP-LEVEL name `os`
                    if a.name.split(".")[0] in ("os", "tempfile"):
                        module_aliases.add(a.name.split(".")[0])
                elif a.name in ("os", "tempfile"):
                    # `import os.path as p` binds p to os.path, whose
                    # attrs are not the hand-rolled primitives — only a
                    # whole-module alias counts
                    module_aliases.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module in ("os", "tempfile"):
                for a in node.names:
                    if a.name in _HAND_ROLLED:
                        bare_names[a.asname or a.name] = (
                            f"{node.module}.{a.name}"
                        )
    return module_aliases, bare_names


def check_obs_dump_io(files: Sequence[SourceFile]) -> List[Finding]:
    """NM371: obs.trace / obs.flightrec must write via atomic_write_*."""
    findings: List[Finding] = []
    for src in files:
        if src.relpath not in OBS_DUMP_MODULES or src.tree is None:
            continue
        mod_aliases, bare_hand_rolled = _hand_rolled_bindings(src.tree)
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            what = None
            if isinstance(node.func, ast.Name) and node.func.id == "open":
                mode = _literal_mode(node)
                if mode is None or any(c in (mode or "") for c in "wax+"):
                    what = f'open(..., "{mode}")' if mode else "open(...) with a non-read mode"
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in bare_hand_rolled
            ):
                what = f"{bare_hand_rolled[node.func.id]}() (from-import)"
            elif isinstance(node.func, ast.Attribute):
                if node.func.attr in _DIRECT_WRITE_ATTRS:
                    what = f".{node.func.attr}()"
                elif node.func.attr == "open":
                    # Path.open / io.open are the same primitive wearing an
                    # attribute: flag any non-read (or statically unknown)
                    # mode. NOTE Path.open takes mode as its FIRST
                    # positional, unlike builtin open(path, mode).
                    mode = _attr_open_mode(node)
                    if mode is None or any(c in (mode or "") for c in "wax+"):
                        what = (
                            f'.open(..., "{mode}")' if mode
                            else ".open(...) with a non-read mode"
                        )
                elif node.func.attr in _HAND_ROLLED and isinstance(
                    node.func.value, ast.Name
                ) and node.func.value.id in mod_aliases:
                    what = f"{node.func.value.id}.{node.func.attr}()"
                elif node.func.attr == "rename":
                    # Path(...).rename(target) — receiver-agnostic: these
                    # modules have no legitimate rename of any kind
                    what = ".rename()"
                elif (
                    node.func.attr == "replace"
                    and len(node.args) == 1
                    and not node.keywords
                ):
                    # Path(...).replace(target) takes ONE positional;
                    # str.replace(old, new) takes two, so stays clean
                    what = ".replace(target) (pathlib-style rename)"
            if what is None:
                continue
            findings.append(
                Finding(
                    rule="NM371",
                    path=src.relpath,
                    line=node.lineno,
                    message=(
                        f"{what} in a flight-recorder/trace module — dumps "
                        "and exports race the crash/drain they document and "
                        "must route through utils.atomicio.atomic_write_* "
                        "(the idiom's single point of correctness), never a "
                        "direct or hand-rolled write"
                    ),
                    source_line=src.line_text(node.lineno),
                )
            )
    return findings


def check_atomic_io(files: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        if src.tree is None:
            continue
        if src.relpath.startswith("tests/"):
            continue  # test fixtures write scratch files on purpose
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            path_expr: Optional[ast.expr] = None
            what = None
            if isinstance(node.func, ast.Name) and node.func.id == "open":
                mode = _literal_mode(node)
                if mode is None or not mode.startswith("w"):
                    continue
                path_expr = node.args[0] if node.args else None
                what = f'open(..., "{mode}")'
            elif isinstance(node.func, ast.Attribute) and node.func.attr in (
                "write_text",
                "write_bytes",
            ):
                path_expr = node.func.value
                what = f".{node.func.attr}()"
            else:
                continue
            if path_expr is not None and _names_tmp(path_expr):
                continue
            scope = _enclosing_function(src.tree, node.lineno)
            if scope is not None and _has_replace(scope):
                continue
            findings.append(
                Finding(
                    rule="NM351",
                    path=src.relpath,
                    line=node.lineno,
                    message=(
                        f"{what} truncates the target in place — a kill or "
                        "full disk mid-write leaves a torn artifact; write "
                        "to <path>.tmp and os.replace() it (docs/"
                        "RESILIENCE.md), or suppress with why tearing is "
                        "acceptable here"
                    ),
                    source_line=src.line_text(node.lineno),
                )
            )
    return findings
