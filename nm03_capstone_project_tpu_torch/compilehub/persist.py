"""The persistent, verified cache of the port's nvcc-built kernel libraries.

The port's counterpart of the JAX package's ``compilehub/persist.py``. There
a second process start deserializes its XLA executables instead of
compiling them; here it loads the three CUDA kernel libraries
(``lib{median,fused,grow}.so``, :mod:`..kernels.build`) from an operator's
directory instead of running ``nvcc`` again at every start.

Layers:

* :class:`PersistKey` — the versioned identity of one library: the schema,
  the library's name, the digest of the three ``.cu`` sources and of the
  generated headers, the exact ``nvcc`` flags, the target arch, the output
  of ``nvcc --version`` and the port's version. Only
  :func:`..kernels.build.persist_key` builds one, and the port's lint
  (NM381, ``analysis/cachekey.py``) holds it to every module constant the
  build reads.
* :class:`KernelCache` — the on-disk store, the counterpart of the JAX
  ``ExecutableCache``: ``store(name, built_path)`` publishes
  ``<dir>/<name>-<digest>.nm03lib`` (a JSON header line, then the
  library's bytes) through a private tmp file and a rename, so a reader
  never sees a partial entry and concurrent writers need no lock;
  ``load(name)`` checks the header's key and the payload's sha256 BEFORE
  anything is loaded, copies the payload to the process's private build
  directory and returns that path. An absent, stale, torn or corrupt
  entry is a counted miss: the caller builds the same kernel with
  ``nvcc``. None of this is a fallback from the kernel; the same CUDA code
  runs either way. A cache never crashes the process it speeds up.
* :func:`scan_entries` / :func:`gc_entries` — the workhorses of
  ``python -m nm03_capstone_project_tpu_torch.compilehub.cache_cli``
  (``ls``, ``verify``, ``gc --max-bytes/--max-age``).

The toolkit is checked, not named. :meth:`PersistKey.digest` covers every
field, as in the JAX package, but :meth:`PersistKey.filename` names an
entry by :meth:`PersistKey.identity_digest`, which leaves out
``nvcc_version``: a host without ``nvcc`` (which could not build anyway)
still finds the entry. The toolkit is then held against the header: a
different ``nvcc`` makes the entry ``stale`` (a miss that rebuilds and
overwrites it); a host with no ``nvcc`` accepts the entry built by whatever
toolkit built it.

``config_digest`` and ``result_version`` of the JAX module live in the
port's ``cache/keys.py``. ``attach_jax_compilation_cache`` and
``jax_cache_stats`` have no counterpart: eager PyTorch has no compilation
cache of its own to attach.

Trust boundary: a library is machine code the process maps and runs. The
checksum defends against corruption, not tampering: point
``--compile-cache-dir`` at a directory with the trust level of the
installed package.

Stdlib only.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import tempfile
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_bytes
from nm03_capstone_project_tpu_torch.utils.reporter import get_logger

log = get_logger("compilehub")

__all__ = [
    "ENTRY_SUFFIX",
    "ENV_CACHE_DIR",
    "KernelCache",
    "PersistKey",
    "cache_dir_from_env",
    "gc_entries",
    "scan_entries",
]

SCHEMA = "nm03.lib.v1"
ENTRY_SUFFIX = ".nm03lib"
ENV_CACHE_DIR = "NM03_COMPILE_CACHE_DIR"
FORMAT_SO = "cuda-so"

# the key fields whose mismatch means "built by another toolkit or package"
# (`stale`: expected after an upgrade) rather than bit rot (`corrupt`)
_VERSION_FIELDS = ("nvcc_version", "nm03_version")
# fields an entry's filename does not name: checked against the header
_UNNAMED_FIELDS = ("nvcc_version",)

_SAFE_CHARS = re.compile(r"[^A-Za-z0-9_.-]+")


def cache_dir_from_env(environ=os.environ) -> Optional[str]:
    """The ``NM03_COMPILE_CACHE_DIR`` value, or None when unset or empty."""
    return environ.get(ENV_CACHE_DIR) or None


@dataclasses.dataclass(frozen=True)
class PersistKey:
    """The versioned identity of one kernel library: the contract.

    ``nvcc_version`` is None on a host without ``nvcc``: such a host
    cannot build, and accepts an entry whatever toolkit built it.
    """

    schema: str
    name: str
    sources_sha256: str
    headers_sha256: str
    nvcc_flags: Tuple[str, ...]
    arch: str
    nvcc_version: Optional[str]
    nm03_version: str

    def to_json(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["nvcc_flags"] = list(self.nvcc_flags)
        return d

    def digest(self) -> str:
        return hashlib.sha256(
            json.dumps(self.to_json(), sort_keys=True).encode()
        ).hexdigest()[:20]

    def identity_digest(self) -> str:
        """The digest of every field but the toolkit's (the entry's name)."""
        d = {k: v for k, v in self.to_json().items() if k not in _UNNAMED_FIELDS}
        return hashlib.sha256(json.dumps(d, sort_keys=True).encode()).hexdigest()[:20]

    def filename(self) -> str:
        """``<name>-<arch>-<identity digest>.nm03lib``: ls-able, collision-free."""
        prefix = _SAFE_CHARS.sub("_", f"{self.name}-{self.arch}")[:80]
        return f"{prefix}-{self.identity_digest()}{ENTRY_SUFFIX}"


class CacheEntryError(Exception):
    """An unusable on-disk entry; ``kind`` classifies it for stats and the CLI."""

    def __init__(self, kind: str, message: str):
        super().__init__(message)
        self.kind = kind  # corrupt | stale | mismatch


# One header-size contract at both ends: _compose_entry refuses to write a
# header past the cap, so the header-only readers (ls, gc) may call anything
# larger corrupt without disagreeing with load() or verify. A real header is
# about 1 KiB.
_HEADER_CAP = 1 << 16


def _compose_entry(key: PersistKey, payload: bytes) -> bytes:
    header = {
        "schema": SCHEMA,
        "format": FORMAT_SO,
        "key": key.to_json(),
        "payload_sha256": hashlib.sha256(payload).hexdigest(),
        "payload_len": len(payload),
        "created_unix": time.time(),
    }
    line = json.dumps(header, sort_keys=True).encode()
    if len(line) + 1 > _HEADER_CAP:
        raise ValueError(
            f"entry header of {len(line)} bytes exceeds the {_HEADER_CAP} cap; "
            "entry not persisted"
        )
    return line + b"\n" + payload


def _parse_header(head: bytes) -> dict:
    """The one header grammar, shared by the full and header-only readers."""
    try:
        header = json.loads(head.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise CacheEntryError("corrupt", f"unparseable header: {e}") from e
    if not isinstance(header, dict) or header.get("schema") != SCHEMA:
        raise CacheEntryError(
            "corrupt", f"bad schema {header.get('schema')!r}"
            if isinstance(header, dict) else "header is not an object"
        )
    return header


def _split_entry(raw: bytes) -> Tuple[dict, bytes]:
    """Parse the header and verify the checksum; CacheEntryError otherwise."""
    head, sep, payload = raw.partition(b"\n")
    if not sep:
        raise CacheEntryError("corrupt", "no header/payload separator")
    header = _parse_header(head)
    if header.get("payload_len") != len(payload):
        raise CacheEntryError(
            "corrupt",
            f"payload is {len(payload)} bytes, header says "
            f"{header.get('payload_len')} (truncated write?)",
        )
    if hashlib.sha256(payload).hexdigest() != header.get("payload_sha256"):
        raise CacheEntryError("corrupt", "payload checksum mismatch")
    if header.get("format") != FORMAT_SO:
        raise CacheEntryError("corrupt", f"unknown payload format {header.get('format')!r}")
    return header, payload


def _drift(want: dict, got: dict) -> List[str]:
    """The fields where ``got`` differs from ``want``; an unknown toolkit
    on this side (no ``nvcc``) is no drift."""
    out = []
    for f, v in want.items():
        if f in _UNNAMED_FIELDS and v is None:
            continue
        if got.get(f) != v:
            out.append(f)
    return out


def _classify_key_mismatch(want: dict, got: Any) -> Optional[CacheEntryError]:
    """None when ``got`` is the key wanted; else stale, corrupt or mismatch."""
    if not isinstance(got, dict):
        return CacheEntryError("corrupt", "header key is not an object")
    drift = _drift(want, got)
    if not drift:
        return None
    versions = [f for f in drift if f in _VERSION_FIELDS]
    if versions:
        pairs = ", ".join(f"{f}={got.get(f)!r} (want {want.get(f)!r})" for f in versions)
        return CacheEntryError("stale", f"built by a different toolchain: {pairs}")
    return CacheEntryError(
        "mismatch", "key digest collision or tampered header (entry ignored)"
    )


class KernelCache:
    """The on-disk library store behind :func:`..kernels.build.load`.

    ``key_fn(name)`` gives a library's :class:`PersistKey` (default:
    :func:`..kernels.build.persist_key`). Thread-safe; every failure mode is
    a counted miss or store error, never an exception to the caller.
    ``fault_hook`` is the chaos point (fault plan site ``cache``, kind
    ``io_error``): called with the entry's filename after its bytes are in
    a tmp file and before the rename that publishes them, so an injected
    fault aborts the publish as a process killed there would, and leaves
    the tmp file for ``gc``.
    """

    def __init__(
        self,
        root: "str | os.PathLike",
        key_fn: Optional[Callable[[str], PersistKey]] = None,
        fault_hook: Optional[Callable[[str], None]] = None,
    ):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._key_fn = key_fn
        self._fault_hook = fault_hook
        self._lock = threading.Lock()
        self._stats = {
            "hits": 0,
            "misses": 0,
            "corrupt": 0,
            "stale": 0,
            "stores": 0,
            "store_errors": 0,
            "bytes_read": 0,
            "bytes_written": 0,
            "load_seconds": 0.0,
        }

    def key(self, name: str) -> PersistKey:
        if self._key_fn is not None:
            return self._key_fn(name)
        from nm03_capstone_project_tpu_torch.kernels import build

        return build.persist_key(name)

    def _bump(self, **deltas: float) -> None:
        with self._lock:
            for k, v in deltas.items():
                self._stats[k] += v

    def stats(self) -> Dict[str, float]:
        with self._lock:
            out = dict(self._stats)
        out["load_seconds"] = round(out["load_seconds"], 4)
        return out

    def readyz_stats(self) -> Dict[str, float]:
        """The ``/readyz`` ``compile_hub`` cache fields (the JAX names)."""
        s = self.stats()
        return {
            "cache_hits": s["hits"],
            "cache_misses": s["misses"],
            "cache_bytes": s["bytes_read"] + s["bytes_written"],
            "cache_load_seconds": s["load_seconds"],
        }

    # -- load / store ------------------------------------------------------

    def load(self, name: str, dest_dir: "str | os.PathLike") -> Optional[Path]:
        """The verified library ``dest_dir/lib<name>.so``, or None (a miss).

        The entry is read once; its key and its payload's sha256 are
        checked in memory, and only those checked bytes are written to
        ``dest_dir`` (the process's private directory): what the caller
        then loads is what was verified.
        """
        t0 = time.perf_counter()
        try:
            key = self.key(name)
            path = self.root / key.filename()
            try:
                raw = path.read_bytes()
            except OSError:
                self._bump(misses=1)
                return None
            header, payload = _split_entry(raw)
            err = _classify_key_mismatch(key.to_json(), header.get("key"))
            if err is not None:
                raise err
            out = Path(dest_dir) / f"lib{name}.so"
            atomic_write_bytes(out, payload)
        except CacheEntryError as e:
            self._bump(misses=1, **({e.kind: 1} if e.kind in ("corrupt", "stale") else {}))
            log.warning("compile cache: ignoring %s entry for lib%s.so: %s", e.kind, name, e)
            return None
        except Exception as e:  # noqa: BLE001 — a cache must never crash a build
            self._bump(misses=1, corrupt=1)
            log.warning("compile cache: load failed for lib%s.so (rebuilding): %s", name, e)
            return None
        self._bump(hits=1, bytes_read=len(raw), load_seconds=time.perf_counter() - t0)
        return out

    def store(self, name: str, built_path: "str | os.PathLike") -> bool:
        """Publish one built library; False (counted) on any failure."""
        tmp = None
        try:
            key = self.key(name)
            entry_name = key.filename()
            entry = _compose_entry(key, Path(built_path).read_bytes())
            fd, tmp = tempfile.mkstemp(dir=self.root, prefix=entry_name + ".", suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    f.write(entry)
                umask = os.umask(0)
                os.umask(umask)
                os.chmod(tmp, 0o666 & ~umask)
            except BaseException:
                with contextlib.suppress(OSError):
                    os.unlink(tmp)
                raise
            if self._fault_hook is not None:
                self._fault_hook(entry_name)
            os.replace(tmp, self.root / entry_name)
        except Exception as e:  # noqa: BLE001 — persistence is best-effort
            self._bump(store_errors=1)
            log.warning(
                "compile cache: store failed for lib%s.so (entry skipped%s): %s",
                name, f", {Path(tmp).name} left for gc" if tmp and os.path.exists(tmp) else "", e,
            )
            return False
        self._bump(stores=1, bytes_written=len(entry))
        return True


# -- the admin surface's helpers (cache_cli) ---------------------------------


def _read_header_only(path: Path, file_size: int) -> dict:
    """The header and a length check, without reading the payload.

    Size arithmetic catches every torn write (the file must be exactly the
    header line, its newline and ``payload_len`` bytes); only same-length
    bit rot needs the full checksum (``cache_cli verify``).
    """
    with open(path, "rb") as f:
        head = f.readline(_HEADER_CAP)
    if not head.endswith(b"\n"):
        raise CacheEntryError("corrupt", "no header/payload separator")
    header = _parse_header(head[:-1])
    want = len(head) + header.get("payload_len", -1)
    if want != file_size:
        raise CacheEntryError(
            "corrupt", f"file is {file_size} bytes, header promises {want} (truncated write?)"
        )
    return header


def _current_keys() -> Dict[str, Dict[str, Any]]:
    """This process's key of each library, by name."""
    from nm03_capstone_project_tpu_torch.kernels import build

    return {name: build.persist_key(name).to_json() for name in build.SOURCES}


def scan_entries(
    root: "str | os.PathLike",
    checksum: bool = True,
    current: Optional[Dict[str, Dict[str, Any]]] = None,
) -> List[Dict[str, Any]]:
    """One row per ``*.nm03lib`` file: header facts and integrity status.

    ``status`` is ``ok`` (it parses, its length, and with ``checksum`` its
    payload hash, verify, and its key is the one this tree would build),
    ``stale`` (it verifies but another toolkit, package version, source,
    header or flag set built it: ``stale_fields`` names which), ``corrupt``,
    or ``unreadable`` (an I/O error reading it: possibly healthy, e.g. a
    permissions mismatch; ``gc`` keeps these). ``current`` maps a library
    name to its key (default: this tree's, :func:`_current_keys`).
    ``checksum=False`` reads only headers. Never raises on an entry's
    content; an unreadable directory raises OSError to the caller.
    """
    rows: List[Dict[str, Any]] = []
    want_keys = current
    for path in sorted(Path(root).glob(f"*{ENTRY_SUFFIX}")):
        try:
            st = path.stat()
        except OSError:
            continue  # vanished between glob and stat (a concurrent gc)
        row: Dict[str, Any] = {
            "file": path.name,
            "bytes": st.st_size,
            "age_s": max(0.0, time.time() - st.st_mtime),
            "mtime": st.st_mtime,
        }
        try:
            try:
                if checksum:
                    header, _payload = _split_entry(path.read_bytes())
                else:
                    header = _read_header_only(path, st.st_size)
            except OSError as e:
                # EACCES/EIO: the ENTRY may be healthy (gc under an account
                # that cannot read the service's files). Not corrupt: gc
                # deletes corrupt entries, and a janitor must never destroy
                # a fleet's warm cache over a permissions problem
                row["status"] = "unreadable"
                row["error"] = f"{type(e).__name__}: {e}"
                rows.append(row)
                continue
            key = header.get("key") or {}
            row.update(
                {
                    "name": key.get("name"),
                    "arch": key.get("arch"),
                    "format": header.get("format"),
                    "nvcc_version": key.get("nvcc_version"),
                    "nm03_version": key.get("nm03_version"),
                    "created_unix": header.get("created_unix"),
                }
            )
            if want_keys is None:
                want_keys = _current_keys()
            want = want_keys.get(key.get("name"))
            drift = _drift(want, key) if want is not None else ["name"]
            row["status"] = "stale" if drift else "ok"
            if drift:
                row["stale_fields"] = drift
        except CacheEntryError as e:
            row["status"] = "corrupt"
            row["error"] = str(e)
        except Exception as e:  # noqa: BLE001 — one bad entry never hides the rest
            row["status"] = "corrupt"
            row["error"] = f"{type(e).__name__}: {e}"
        rows.append(row)
    return rows


# how old an orphaned tmp file must be before gc reclaims it: a real store's
# tmp lives milliseconds, so anything past this is the leavings of a killed
# or aborted store, not a writer in flight
TMP_ORPHAN_GRACE_S = 600.0


def gc_entries(
    root: "str | os.PathLike",
    max_bytes: Optional[int] = None,
    max_age_s: Optional[float] = None,
    dry_run: bool = False,
    current: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    """Delete dead and expired entries, then the oldest to the byte budget.

    The JAX package's policy: orphaned ``*.tmp`` files older than
    :data:`TMP_ORPHAN_GRACE_S`, and corrupt and stale entries, always go
    (they can only ever miss for this tree; do not run gc from one side of
    a directory shared on purpose by fleets of different versions); then
    anything older than ``max_age_s``; then the oldest by mtime until the
    total fits ``max_bytes``. Unreadable entries are never removed. The
    scan reads headers only. Returns ``{"removed": [names], "freed_bytes":
    n, "kept": n, "kept_bytes": n}``.
    """
    rows = scan_entries(root, checksum=False, current=current)
    removed: List[str] = []
    freed = 0
    now = time.time()
    for tmp in sorted(Path(root).glob("*.tmp")):
        try:
            st = tmp.stat()
        except OSError:
            continue
        if now - st.st_mtime <= TMP_ORPHAN_GRACE_S:
            continue  # possibly a live writer's tmp: not ours to take
        if not dry_run:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
        removed.append(tmp.name)
        freed += st.st_size

    def drop(row: Dict[str, Any]) -> None:
        nonlocal freed
        if not dry_run:
            with contextlib.suppress(OSError):
                os.unlink(Path(root) / row["file"])
        removed.append(row["file"])
        freed += row["bytes"]

    keep: List[Dict[str, Any]] = []
    protected: List[Dict[str, Any]] = []  # unreadable: exempt from every branch
    for row in rows:
        if row["status"] == "unreadable":
            protected.append(row)
        elif row["status"] in ("corrupt", "stale"):
            drop(row)
        elif max_age_s is not None and row["age_s"] > max_age_s:
            drop(row)
        else:
            keep.append(row)
    if max_bytes is not None:
        keep.sort(key=lambda r: r["mtime"])  # oldest first
        total = sum(r["bytes"] for r in keep)
        while keep and total > max_bytes:
            victim = keep.pop(0)
            total -= victim["bytes"]
            drop(victim)
    keep += protected
    return {
        "removed": removed,
        "freed_bytes": freed,
        "kept": len(keep),
        "kept_bytes": sum(r["bytes"] for r in keep),
    }
