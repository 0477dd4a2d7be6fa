"""NM381 — the kernel libraries' key covers every input of the build.

``kernels/build.py`` compiles ``csrc/<name>.cu`` into ``lib<name>.so`` and
finds a built library by a key: ``persist_key()`` derives the persistent
cache's (:class:`compilehub.persist.PersistKey`: the sources and the
generated median headers by digest, the nvcc flags, the arch, ``nvcc
--version``, the port's version), which names and checks its entries, and
``build_dir()`` the key of ``_build/<key>/`` beside the package. A library
is only the one its key names while the key covers everything that makes
two libraries differ. The moment someone adds an input to the build (a
flag constant spliced into the nvcc command, a new source, a new window
the generated headers enumerate) WITHOUT folding it into both, two
different builds share one key: a cache entry or a ``_build`` directory
built from the old input loads, and the stale library runs the old
kernel. Silently: the masks go wrong under green telemetry,
the worst failure this codebase can have, and invisible to tests until the
exact collision is constructed. (The JAX package's NM381 guards the same
hazard for its persistent executable cache.)

The rule, statically, in any ``kernels/build.py`` of a scanned tree
(fixture trees too) that defines ``build_all`` and a key derivation:

* the **build inputs** are the module-level UPPERCASE constants that the
  build (``build_all``) reads, transitively through the module's own
  functions — the nvcc flags, the source list, the source directory and
  every constant the header generators enumerate (``MEDIAN_WINDOWS``) —
  apart from :data:`_OUTPUTS`, where the build writes;
* the **key derivations** are ``persist_key`` and ``build_dir``, each with
  every module function it calls, transitively (``headers()`` ->
  ``median_plans_header()`` reads ``MEDIAN_WINDOWS``, so hashing the
  header text covers the windows);
* a build input a key derivation never reads is a finding, anchored at
  the constant's definition — where the input was added is where the
  omission gets fixed.

``build_all`` naming its directory by ``build_dir`` makes every read of
that key a build read too; only the converse can fail, which is the point.

Rules:
  NM381  a kernel build input not consumed by ``persist_key`` or ``build_dir``
"""

from __future__ import annotations

import ast
import posixpath
from typing import Dict, List, Sequence, Set

from nm03_capstone_project_tpu_torch.analysis.core import Finding, SourceFile

_BUILD_FILE = "build.py"
_BUILD_DIRNAME = "kernels"
_KEY_FNS = ("persist_key", "build_dir")
_BUILD_FN = "build_all"
# where the build writes, not what it reads
_OUTPUTS = {"BUILD_ROOT"}


def _module_constants(tree: ast.Module) -> Dict[str, int]:
    """{UPPERCASE module-level name: definition line}."""
    out: Dict[str, int] = {}
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name) and t.id.isupper():
                out.setdefault(t.id, node.lineno)
    return out


def _functions(tree: ast.Module) -> Dict[str, ast.FunctionDef]:
    return {
        node.name: node
        for node in tree.body
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _reads(root: ast.FunctionDef, fns: Dict[str, ast.FunctionDef]) -> Set[str]:
    """Every name ``root`` loads, and those of the module functions it
    reaches by name (calls, or a function passed along), transitively."""
    seen: Set[str] = set()
    names: Set[str] = set()
    frontier = [root]
    while frontier:
        fn = frontier.pop()
        if fn.name in seen:
            continue
        seen.add(fn.name)
        for node in ast.walk(fn):
            if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
                names.add(node.id)
                callee = fns.get(node.id)
                if callee is not None and callee.name not in seen:
                    frontier.append(callee)
    return names


def check_cache_key(files: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        if src.tree is None or posixpath.basename(src.relpath) != _BUILD_FILE:
            continue
        if posixpath.basename(posixpath.dirname(src.relpath)) != _BUILD_DIRNAME:
            continue
        fns = _functions(src.tree)
        key_fns = [fn for fn in _KEY_FNS if fn in fns]
        if not key_fns or _BUILD_FN not in fns:
            continue  # a build.py without a key/build pair is not the contract file
        constants = _module_constants(src.tree)
        built = _reads(fns[_BUILD_FN], fns)
        for key_fn in key_fns:
            keyed = _reads(fns[key_fn], fns)
            for name, line in sorted(constants.items(), key=lambda kv: kv[1]):
                if name not in built or name in _OUTPUTS or name in keyed:
                    continue
                findings.append(
                    Finding(
                        rule="NM381",
                        path=src.relpath,
                        line=line,
                        message=(
                            f"build input {name!r} is read by {_BUILD_FN}() but not "
                            f"by the key derivation {key_fn}() — two builds that "
                            f"differ only in {name!r} share one key and the stale "
                            f"library runs; fold it into {key_fn}() "
                            "(docs/STATIC_ANALYSIS_TORCH.md NM381)"
                        ),
                        source_line=src.line_text(line),
                    )
                )
    return findings
