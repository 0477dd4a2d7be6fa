"""``nm03-cache``: the admin surface of the port's compile cache and result tier.

    python -m nm03_capstone_project_tpu_torch.compilehub.cache_cli [--dir DIR] CMD

The port's copy of the JAX package's ``compilehub/cache_cli.py``: the same
flags, ``--format json`` schemas and exit codes, over the port's kernel
library cache (:mod:`.persist`). The cache defends itself at load time (a
corrupt or stale entry is a counted miss that rebuilds), but an operator
still needs to see it:

* ``ls``     — one row per entry: size, age, status, the toolkit that built
  it and the library (``<name> @<arch>``);
* ``verify`` — full checksum and key validation; exit 1 when any entry is
  corrupt (stale entries are expected after an upgrade and do not fail
  the check: they report, and ``gc`` reclaims them);
* ``gc``     — retention: corrupt and stale entries always go, and tmp
  files older than ten minutes (an aborted or killed store's), then
  anything older than ``--max-age``, then oldest first until under
  ``--max-bytes``;
* ``result`` — the result tier's ``ls`` / ``stats`` / ``evict`` against a
  live server's (or fleet front end's) ``/debug/result-cache``: that
  store lives in a serving process's memory, so its admin path is HTTP
  (``--url``), not ``--dir``.

Diagnostics go to stderr, results to stdout. Exit codes: 0 ok, 1 findings
(corrupt entries on ``verify``), 2 usage errors (no directory, an
unreadable one, an unreachable or tier-less server).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from nm03_capstone_project_tpu_torch.compilehub.persist import (
    ENTRY_SUFFIX,
    ENV_CACHE_DIR,
    cache_dir_from_env,
    gc_entries,
    scan_entries,
)


def _fmt_age(seconds: float) -> str:
    for unit, div in (("d", 86400.0), ("h", 3600.0), ("m", 60.0)):
        if seconds >= div:
            return f"{seconds / div:.1f}{unit}"
    return f"{seconds:.0f}s"


def _fmt_bytes(n: float) -> str:
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if n >= div:
            return f"{n / div:.1f} {unit}"
    return f"{int(n)} B"


def _nvcc_release(text) -> str:
    """'12.4' from ``nvcc --version``'s "release 12.4, V12.4.131"; '?' else."""
    for part in str(text or "").replace(",", " ").split():
        if part.startswith("V") and part[1:2].isdigit():
            return part[1:]
    return "?"


def _resolve_dir(arg_dir: Optional[str]) -> Path:
    # usage errors exit 2, never 1: a CI script must be able to tell "no
    # such directory" from "verify found corrupt entries"
    d = arg_dir or cache_dir_from_env()
    if not d:
        print(
            f"nm03-cache: no cache directory (pass --dir or set "
            f"${ENV_CACHE_DIR})",
            file=sys.stderr,
        )
        raise SystemExit(2)
    path = Path(d)
    if not path.is_dir():
        print(f"nm03-cache: {path} is not a directory", file=sys.stderr)
        raise SystemExit(2)
    return path


def _parse_bytes(text: str) -> int:
    """'512m', '2g', '100k' or plain bytes -> int."""
    t = text.strip().lower()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(t[-1:], None)
    if mult is not None:
        t = t[:-1]
    try:
        return int(float(t) * (mult or 1))
    except ValueError as e:
        raise argparse.ArgumentTypeError(
            f"bad byte size {text!r} (want e.g. 512m, 2g, 1048576)"
        ) from e


def _parse_age(text: str) -> float:
    """'7d', '12h', '30m', '90s' or plain seconds -> float seconds."""
    t = text.strip().lower()
    mult = {"s": 1.0, "m": 60.0, "h": 3600.0, "d": 86400.0}.get(t[-1:], None)
    if mult is not None:
        t = t[:-1]
    try:
        return float(t) * (mult or 1.0)
    except ValueError as e:
        raise argparse.ArgumentTypeError(
            f"bad age {text!r} (want e.g. 7d, 12h, 3600)"
        ) from e


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m nm03_capstone_project_tpu_torch.compilehub.cache_cli",
        description=__doc__.strip().splitlines()[0],
    )
    p.add_argument(
        "--dir",
        default=None,
        metavar="DIR",
        help=f"cache directory (default: ${ENV_CACHE_DIR})",
    )
    p.add_argument(
        "--format",
        choices=["text", "json"],
        default="text",
        help="output format",
    )
    sub = p.add_subparsers(dest="command", required=True)
    sub.add_parser("ls", help="list entries with size/age/identity/status")
    sub.add_parser(
        "verify",
        help="checksum + key validation; exit 1 on corrupt entries",
    )
    gc = sub.add_parser("gc", help="apply the retention policy")
    gc.add_argument(
        "--max-bytes",
        type=_parse_bytes,
        default=None,
        metavar="N",
        help="total size budget (suffixes k/m/g); oldest entries beyond it go",
    )
    gc.add_argument(
        "--max-age",
        type=_parse_age,
        default=None,
        metavar="AGE",
        help="entry age cap (suffixes s/m/h/d)",
    )
    gc.add_argument(
        "--dry-run",
        action="store_true",
        help="report what WOULD be removed without touching the directory",
    )
    res = sub.add_parser(
        "result",
        help="administer a live process's content-addressed result store",
        description="The result tier's admin surface: ls/stats "
        "read GET /debug/result-cache on a replica started with "
        "--result-cache-bytes (or an nm03-fleet front-end); evict POSTs "
        "/debug/result-cache/evict — one --digest, or everything without "
        "it. Invalidation normally needs neither: the program version in "
        "every key retires stale results by construction.",
    )
    res.add_argument(
        "action", choices=["ls", "stats", "evict"],
        help="ls = entry rows hot-to-cold; stats = counters + hit ratio; "
        "evict = drop one --digest (or all entries when omitted)",
    )
    res.add_argument(
        "--url", required=True, metavar="URL",
        help="base URL of the replica or fleet front-end to administer",
    )
    res.add_argument(
        "--digest", default=None, metavar="D",
        help="result-key digest to evict (evict only; omit to drop all)",
    )
    res.add_argument(
        "--timeout-s", type=float, default=10.0, help="HTTP timeout",
    )
    return p


def _cmd_ls(rows: List[dict], fmt: str) -> int:
    if fmt == "json":
        print(json.dumps({"entries": rows}, indent=1))
        return 0
    if not rows:
        print("(empty cache)")
        return 0
    header = f"{'SIZE':>9}  {'AGE':>7}  {'STATUS':8}  {'NVCC':10}  ENTRY"
    print(header)
    for r in rows:
        ident = r["file"]
        if r.get("name"):
            ident = f"lib{r['name']}.so @{r.get('arch')}"
        print(
            f"{_fmt_bytes(r['bytes']):>9}  {_fmt_age(r['age_s']):>7}  "
            f"{r['status']:8}  {_nvcc_release(r.get('nvcc_version')):10}  {ident}"
        )
    total = sum(r["bytes"] for r in rows)
    print(f"{len(rows)} entries, {_fmt_bytes(total)} total")
    return 0


def _cmd_verify(rows: List[dict], fmt: str) -> int:
    corrupt = [r for r in rows if r["status"] == "corrupt"]
    stale = [r for r in rows if r["status"] == "stale"]
    # reported but NOT a failure and never gc-fodder: the entry may be
    # healthy under the service uid (permissions mismatch, NFS blip)
    unreadable = [r for r in rows if r["status"] == "unreadable"]
    ok = len(rows) - len(corrupt) - len(stale) - len(unreadable)
    if fmt == "json":
        print(
            json.dumps(
                {
                    "entries": len(rows),
                    "ok": ok,
                    "stale": [r["file"] for r in stale],
                    "unreadable": [
                        {"file": r["file"], "error": r.get("error")}
                        for r in unreadable
                    ],
                    "corrupt": [
                        {"file": r["file"], "error": r.get("error")}
                        for r in corrupt
                    ],
                },
                indent=1,
            )
        )
    else:
        for r in corrupt:
            print(f"corrupt: {r['file']}: {r.get('error')}")
        for r in unreadable:
            print(f"unreadable: {r['file']}: {r.get('error')}")
        for r in stale:
            print(
                f"stale:   {r['file']}: differs in "
                f"{', '.join(r.get('stale_fields') or [])} (built by nvcc "
                f"{_nvcc_release(r.get('nvcc_version'))}, port {r.get('nm03_version')})"
            )
        print(
            f"nm03-cache: {len(rows)} entries — "
            f"{ok} ok, {len(stale)} stale, {len(unreadable)} unreadable, "
            f"{len(corrupt)} corrupt"
        )
    return 1 if corrupt else 0


def _cmd_gc(root: Path, args: argparse.Namespace, fmt: str) -> int:
    report = gc_entries(
        root,
        max_bytes=args.max_bytes,
        max_age_s=args.max_age,
        dry_run=args.dry_run,
    )
    if fmt == "json":
        report["dry_run"] = args.dry_run
        print(json.dumps(report, indent=1))
        return 0
    verb = "would remove" if args.dry_run else "removed"
    for name in report["removed"]:
        print(f"{verb}: {name}")
    print(
        f"nm03-cache: {verb} {len(report['removed'])} entries "
        f"({_fmt_bytes(report['freed_bytes'])}); kept {report['kept']} "
        f"({_fmt_bytes(report['kept_bytes'])})"
    )
    return 0


def _cmd_result(args: argparse.Namespace) -> int:
    """The result tier's admin actions: HTTP, never ``--dir``.

    Exit codes keep the sibling discipline: 0 ok, 2 usage/unreachable —
    a disabled tier is a usage error (the operator pointed the admin
    surface at a process that runs no store), never a silent empty list.
    """
    import urllib.error
    import urllib.request

    base = args.url.rstrip("/")
    try:
        if args.action == "evict":
            q = f"?digest={args.digest}" if args.digest else ""
            req = urllib.request.Request(
                f"{base}/debug/result-cache/evict{q}", data=b"",
                method="POST",
            )
        else:
            req = urllib.request.Request(
                f"{base}/debug/result-cache", method="GET"
            )
        with urllib.request.urlopen(req, timeout=args.timeout_s) as resp:
            payload = json.loads(resp.read() or b"{}")
    except urllib.error.HTTPError as e:
        detail = (e.read() or b"")[:200].decode(errors="replace")
        print(
            f"nm03-cache result: {base} answered HTTP {e.code}: {detail}",
            file=sys.stderr,
        )
        return 2
    except Exception as e:  # noqa: BLE001 — unreachable is a usage error
        print(f"nm03-cache result: {base} unreachable: {e}", file=sys.stderr)
        return 2
    if payload.get("enabled") is False:
        print(
            f"nm03-cache result: the result tier is disabled on {base} "
            "(start the process with --result-cache-bytes)",
            file=sys.stderr,
        )
        return 2
    if args.format == "json":
        print(json.dumps(payload, indent=1))
        return 0
    if args.action == "evict":
        print(
            f"nm03-cache result: evicted {payload.get('evicted')} entr"
            f"{'y' if payload.get('evicted') == 1 else 'ies'}"
        )
        return 0
    if args.action == "stats":
        hr = payload.get("hit_ratio")
        print(
            f"entries {payload.get('entries')}  "
            f"bytes {_fmt_bytes(payload.get('bytes') or 0)} / "
            f"{_fmt_bytes(payload.get('max_bytes') or 0)}  "
            f"hits {payload.get('hits')}  misses {payload.get('misses')}  "
            f"fills {payload.get('fills')}  "
            f"evictions {payload.get('evictions')} "
            f"(corrupt {payload.get('corrupt_evictions')})  "
            f"hit_ratio {'-' if hr is None else round(hr, 4)}  "
            f"program {payload.get('program_version') or '?'}"
        )
        return 0
    rows = payload.get("ls") or []
    if not rows:
        print("(empty result store)")
        return 0
    print(f"{'SIZE':>9}  {'AGE':>7}  {'HITS':>5}  {'ALGO':<15}  DIGEST")
    for r in rows:
        print(
            f"{_fmt_bytes(r['bytes']):>9}  {_fmt_age(r['age_s']):>7}  "
            f"{r['hits']:>5}  {r['algo']:<15}  {r['digest']}"
        )
    total = sum(r["bytes"] for r in rows)
    print(f"{len(rows)} entries, {_fmt_bytes(total)} total")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "result":
        # the result tier lives in a serving process, not a directory —
        # no --dir resolution, no filesystem scan
        return _cmd_result(args)
    root = _resolve_dir(args.dir)
    # one guard around every directory read: an unreadable dir is a usage
    # error (exit 2) on ANY subcommand, never a traceback or a fake
    # "findings" exit 1
    try:
        rows: List[dict] = []
        if args.command != "gc":
            # ls is header-only (length-checked, not hashed) — a listing
            # must not read a multi-GiB cache end to end; verify hashes.
            # gc scans inside gc_entries — scanning here too would read
            # the whole cache twice
            rows = scan_entries(root, checksum=args.command != "ls")
        stray = [
            p.name
            for p in root.iterdir()
            if p.is_file() and not p.name.endswith(ENTRY_SUFFIX)
            and not p.name.endswith(".tmp")  # gc reclaims orphaned temps
        ]
        if stray:
            print(
                f"nm03-cache: ignoring {len(stray)} non-cache file(s) in "
                f"{root} (e.g. {stray[0]})",
                file=sys.stderr,
            )
        if args.command == "ls":
            return _cmd_ls(rows, args.format)
        if args.command == "verify":
            return _cmd_verify(rows, args.format)
        return _cmd_gc(root, args, args.format)
    except OSError as e:
        print(f"nm03-cache: cannot read {root}: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
