"""nm03-lint core for the port: findings, suppressions, baselines, the walk.

The port's copy of the JAX package's ``analysis/core.py``, with the same
logic. The analyzer is a *project* linter: every rule is pinned to an
invariant the port documents in prose (stdlib-only import contracts, the
port never importing JAX, lock-guarded shared state across the serving
threads, host syncs and uploads on the dispatch path, the CUDA graph and
kernel build homes, the tmp+rename export idiom). General linters cannot
see those contracts; this one encodes them.

Deliberately stdlib-only: the linter runs in processes that must never pay
a torch import, and it registers its own modules in the import-contract
registry — the gate gates itself.

Machinery shared by every rule family:

* :class:`Finding` — one diagnostic: stable rule id, path, line, message,
  plus a content-addressed fingerprint (rule + path + normalized source
  line) so baselines survive unrelated line-number drift;
* suppressions — ``# nm03-lint: disable=NM301,NM331 <reason>`` on the
  finding's line or on a comment line directly above it. A suppression
  *must* carry a reason: a bare disable is itself a finding (NM390) so the
  suppression inventory stays auditable;
* baselines — a checked-in JSON set of fingerprints
  (``nm03lint_torch_baseline.json``); the gate fails only on findings
  *not* in the baseline.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import json
import os
import re
import tokenize
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*nm03-lint:\s*disable=(?P<rules>[A-Z0-9, ]+?)(?:\s+(?P<reason>\S.*))?$"
)

# directories never worth parsing (build junk, artifacts, foreign code)
SKIP_DIRS = {
    ".git", "__pycache__", ".pytest_cache", "build", "dist",
    "results", "csrc", "node_modules", ".eggs", "_build",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. ``fingerprint`` is the baseline identity."""

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    message: str
    source_line: str = ""

    @property
    def fingerprint(self) -> str:
        norm = " ".join(self.source_line.split())
        h = hashlib.sha1(
            f"{self.rule}|{self.path}|{norm}".encode()
        ).hexdigest()
        return h[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }


@dataclasses.dataclass
class Suppression:
    line: int
    rules: Tuple[str, ...]
    reason: str


class SourceFile:
    """One parsed file: AST + source lines + suppression table.

    Parsed once, handed to every rule family — the walk is the expensive
    part, the rules are visitors over it.
    """

    def __init__(self, path: Path, root: Path):
        self.abspath = path
        self.root = root
        self.relpath = path.relative_to(root).as_posix()
        self.text = path.read_text(encoding="utf-8", errors="replace")
        self.lines = self.text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(self.text, filename=str(path))
        except SyntaxError as e:  # surfaced as NM399 by the engine
            self.parse_error = f"{e.msg} (line {e.lineno})"
        self.suppressions: Dict[int, Suppression] = {}
        self._collect_suppressions()

    @property
    def is_package(self) -> bool:
        """True for __init__.py files (their module IS their package)."""
        return self.relpath.endswith("/__init__.py") or self.relpath == "__init__.py"

    @property
    def module_name(self) -> str:
        """Dotted module path relative to the scan root (bench.py -> bench)."""
        rel = self.relpath
        if rel.endswith("/__init__.py"):
            rel = rel[: -len("/__init__.py")]
        elif rel.endswith(".py"):
            rel = rel[:-3]
        return rel.replace("/", ".")

    def _collect_suppressions(self) -> None:
        # tokenize, not regex-over-lines: '# nm03-lint:' inside a string
        # literal must not become a suppression
        try:
            tokens = tokenize.generate_tokens(iter(self.text.splitlines(True)).__next__)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                rules = tuple(
                    r.strip() for r in m.group("rules").split(",") if r.strip()
                )
                self.suppressions[tok.start[0]] = Suppression(
                    line=tok.start[0],
                    rules=rules,
                    reason=(m.group("reason") or "").strip(),
                )
        except (tokenize.TokenError, IndentationError, SyntaxError):
            pass  # unparseable files already carry NM399

    def suppression_for(self, rule: str, line: int) -> Optional[Suppression]:
        """Same-line suppression, or one on the directly preceding
        comment-only line (for statements too long to annotate inline)."""
        for cand in (line, line - 1):
            s = self.suppressions.get(cand)
            if s is None:
                continue
            if cand == line - 1:
                text = self.lines[cand - 1].strip() if cand - 1 < len(self.lines) else ""
                if not text.startswith("#"):
                    continue  # trailing comment of the previous statement
            if rule in s.rules:
                return s
        return None

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


# the JAX package's top-level directory: its own lint covers it, and the
# port's rules never see it (matched as a whole path component, since the
# name is a prefix of the port's)
FOREIGN_PACKAGE = "nm03_capstone_project_tpu"


def collect_files(paths: Sequence[str | os.PathLike], root: Path) -> List[SourceFile]:
    """Expand files/directories into parsed :class:`SourceFile` objects
    (never the JAX package's files)."""
    seen: Dict[Path, None] = {}
    root_res = Path(root).resolve()
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for sub in sorted(p.rglob("*.py")):
                if any(part in SKIP_DIRS for part in sub.parts):
                    continue
                seen.setdefault(sub.resolve(), None)
        elif p.suffix == ".py":
            seen.setdefault(p.resolve(), None)

    def foreign(path: Path) -> bool:
        try:
            rel = path.relative_to(root_res)
        except ValueError:
            return False
        return bool(rel.parts) and rel.parts[0] == FOREIGN_PACKAGE

    return [SourceFile(p, root) for p in seen if not foreign(p)]


def find_repo_root(start: Path) -> Path:
    """Nearest ancestor holding pyproject.toml (else ``start`` itself)."""
    start = start.resolve()
    for cand in (start, *start.parents):
        if (cand / "pyproject.toml").exists():
            return cand
    return start


# -- the engine --------------------------------------------------------------


def run_rules(
    files: Iterable[SourceFile],
    rules,
    select: Optional[Sequence[str]] = None,
) -> List[Finding]:
    """Run every rule family over the parsed files.

    Each rule is ``callable(files) -> Iterable[Finding]`` operating on the
    whole file set (the import-contract rule needs the cross-file graph;
    per-file rules just loop). Suppressions are applied here, centrally,
    and a suppression with no reason degrades into an NM390 finding at the
    same site — suppressing is allowed, hiding *why* is not.
    """
    files = list(files)
    by_path = {f.relpath: f for f in files}
    findings: List[Finding] = []
    for f in files:
        if f.parse_error is not None:
            findings.append(
                Finding(
                    rule="NM399",
                    path=f.relpath,
                    line=1,
                    message=f"file does not parse: {f.parse_error}",
                )
            )
    for rule_fn in rules:
        findings.extend(rule_fn(files))
    out: List[Finding] = []
    for fd in findings:
        if select and not any(fd.rule.startswith(s) for s in select):
            continue
        src = by_path.get(fd.path)
        if src is not None:
            sup = src.suppression_for(fd.rule, fd.line)
            if sup is not None:
                if not sup.reason:
                    out.append(
                        Finding(
                            rule="NM390",
                            path=fd.path,
                            line=sup.line,
                            message=(
                                f"suppression of {fd.rule} has no reason; write "
                                "'# nm03-lint: disable=RULE <why this is safe>'"
                            ),
                            source_line=src.line_text(sup.line),
                        )
                    )
                continue
        out.append(fd)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


# -- baseline ----------------------------------------------------------------

BASELINE_VERSION = 1
DEFAULT_BASELINE_NAME = "nm03lint_torch_baseline.json"


def load_baseline(path: Path) -> Dict[str, int]:
    """fingerprint -> allowed count. Missing file = empty baseline."""
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}; "
            f"this nm03-lint writes version {BASELINE_VERSION}"
        )
    counts: Dict[str, int] = {}
    for e in data.get("entries", []):
        counts[e["fingerprint"]] = counts.get(e["fingerprint"], 0) + 1
    return counts


def write_baseline(path: Path, findings: Sequence[Finding]) -> None:
    entries = [
        {
            "rule": f.rule,
            "path": f.path,
            "fingerprint": f.fingerprint,
            # message kept for humans diffing the baseline, not for matching
            "message": f.message,
        }
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    ]
    payload = {"version": BASELINE_VERSION, "entries": entries}
    tmp = Path(f"{path}.tmp")
    tmp.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
    os.replace(tmp, path)


def prune_baseline(path: Path, findings: Sequence[Finding]) -> Tuple[int, int]:
    """Drop baseline entries whose finding no longer reproduces.

    ``findings`` must come from a FULL default-scope run (the CLI refuses
    narrowed runs for the same reason --update-baseline does): an entry is
    kept only up to the multiplicity the current tree still produces, so a
    fixed finding leaves the baseline the moment it is fixed instead of
    accreting forever. Returns ``(kept, dropped)``; the file is rewritten
    (tmp+rename) only when something was dropped.
    """
    if not path.exists():
        return (0, 0)
    data = json.loads(path.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {data.get('version')!r}; "
            f"this nm03-lint writes version {BASELINE_VERSION}"
        )
    live: Dict[str, int] = {}
    for f in findings:
        live[f.fingerprint] = live.get(f.fingerprint, 0) + 1
    kept: List[dict] = []
    dropped = 0
    for e in data.get("entries", []):
        if live.get(e.get("fingerprint"), 0) > 0:
            live[e["fingerprint"]] -= 1
            kept.append(e)
        else:
            dropped += 1
    if dropped:
        payload = {"version": BASELINE_VERSION, "entries": kept}
        tmp = Path(f"{path}.tmp")
        tmp.write_text(json.dumps(payload, indent=1, sort_keys=True) + "\n")
        os.replace(tmp, path)
    return (len(kept), dropped)


def apply_baseline(
    findings: Sequence[Finding], baseline: Dict[str, int]
) -> Tuple[List[Finding], int]:
    """(new findings, matched count): baseline entries absorb matching
    findings up to their recorded multiplicity."""
    remaining = dict(baseline)
    new: List[Finding] = []
    matched = 0
    for f in findings:
        if remaining.get(f.fingerprint, 0) > 0:
            remaining[f.fingerprint] -= 1
            matched += 1
        else:
            new.append(f)
    return new, matched
