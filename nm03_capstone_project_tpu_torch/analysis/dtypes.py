"""NM34x — dtype discipline at the uint8/f32 boundary in the port's ops/.

The pipeline's numeric contract is narrow and deliberate: slices enter as
f32, the mask leaves as uint8, and every op in between stays in f32 (the
kernels are held bitwise to the plain ops, which are held to the JAX
package in f32). The two statically visible ways that contract erodes:

* a float64 introduction — in torch ``torch.float64``/``torch.double`` as
  a dtype (``dtype=``, ``.to(...)``), ``.double()``, and on the numpy side
  ``dtype=float``, ``astype(float)``, ``np.float64(...)`` — which upcasts a
  whole expression under promotion, so the plain ops, the kernels and the
  JAX reference stop agreeing in the last ulp;
* a comparison against a literal that cannot be represented on the uint8
  side of a cast (``mask.to(torch.uint8) > 300``, ``.byte()``,
  ``astype(np.uint8)``) — constant-foldable nonsense that reads like a
  real threshold.

Scope is the port's ``ops/`` and ``render/``, where the boundary lives; a
deliberate f64 intermediate (a constant computed once at full precision,
then cast) is a one-line suppression with the reason attached.

Rules:
  NM341  float64 introduction (torch.float64/double, .double(), dtype=float,
         np.float64)
  NM342  comparison crossing a uint8 cast against an out-of-range literal
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence, Tuple

from nm03_capstone_project_tpu_torch.analysis.core import Finding, SourceFile

SCOPED_DIRS: Tuple[str, ...] = (
    "nm03_capstone_project_tpu_torch/ops/",
    "nm03_capstone_project_tpu_torch/render/",
)


def _attr_pair(node: ast.expr) -> Optional[Tuple[str, str]]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return (node.value.id, node.attr)
    return None


def _is_f64_expr(node: ast.expr) -> bool:
    pair = _attr_pair(node)
    if pair and pair[1] in ("float64", "double"):
        return True
    if isinstance(node, ast.Constant) and node.value in ("float64", "double"):
        return True
    if isinstance(node, ast.Name) and node.id == "float":
        return True  # numpy maps the python float type to float64
    return False


def _is_u8_cast(node: ast.expr) -> bool:
    """x.astype(uint8-ish), x.to(torch.uint8), x.byte() or np.uint8(x)."""
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and node.func.attr == "byte" \
                and not node.args:
            return True
        if isinstance(node.func, ast.Attribute) and node.func.attr in ("astype", "to"):
            if node.args:
                a = node.args[0]
                pair = _attr_pair(a)
                if (pair and pair[1] == "uint8") or (
                    isinstance(a, ast.Constant) and a.value == "uint8"
                ):
                    return True
        pair = _attr_pair(node.func)
        if pair and pair[1] == "uint8":
            return True
    return False


def check_dtype_discipline(files: Sequence[SourceFile]) -> List[Finding]:
    findings: List[Finding] = []
    for src in files:
        if src.tree is None:
            continue
        if not any(src.relpath.startswith(d) for d in SCOPED_DIRS):
            continue
        for node in ast.walk(src.tree):
            # NM341 — float64 introductions
            if isinstance(node, ast.Call):
                pair = _attr_pair(node.func)
                if (pair and pair[1] == "float64") or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "double"
                    and not node.args
                ):
                    what = f"{pair[0]}.float64()" if pair and pair[1] == "float64" \
                        else ".double()"
                    findings.append(
                        Finding(
                            rule="NM341",
                            path=src.relpath,
                            line=node.lineno,
                            message=(
                                f"{what} constructs f64 in the "
                                "f32 pipeline — compute in f32, or suppress "
                                "with the precision rationale"
                            ),
                            source_line=src.line_text(node.lineno),
                        )
                    )
                    continue
                is_astype = (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("astype", "to")
                )
                dtype_args = list(node.args[:1]) if is_astype else []
                for kw in node.keywords:
                    if kw.arg == "dtype":
                        dtype_args.append(kw.value)
                for a in dtype_args:
                    if _is_f64_expr(a):
                        findings.append(
                            Finding(
                                rule="NM341",
                                path=src.relpath,
                                line=node.lineno,
                                message=(
                                    "float64 dtype in the f32 pipeline "
                                    "(dtype=float is float64 under numpy) — "
                                    "use torch.float32/np.float32, or suppress "
                                    "with the precision rationale"
                                ),
                                source_line=src.line_text(node.lineno),
                            )
                        )
                        break

            # NM342 — uint8 cast compared against out-of-range literal
            if isinstance(node, ast.Compare):
                sides = [node.left, *node.comparators]
                has_u8 = any(_is_u8_cast(s) for s in sides)
                if not has_u8:
                    continue
                for s in sides:
                    if isinstance(s, ast.Constant) and isinstance(
                        s.value, (int, float)
                    ) and not isinstance(s.value, bool):
                        if not (0 <= s.value <= 255):
                            findings.append(
                                Finding(
                                    rule="NM342",
                                    path=src.relpath,
                                    line=node.lineno,
                                    message=(
                                        f"comparison of a uint8-cast value "
                                        f"against {s.value!r}, which is "
                                        "outside [0, 255] — the comparison "
                                        "is constant and the threshold is "
                                        "not doing what it reads like"
                                    ),
                                    source_line=src.line_text(node.lineno),
                                )
                            )
    return findings
