"""The port's compile home (``compilehub/``) against the JAX package's.

CPU only: no ``nvcc`` here, so a "library" is a stub file of bytes, and the
build's compile step and ``ctypes.CDLL`` are stand-ins where the resolution
order of ``kernels/build.py`` is under test. Held against the JAX package:
the entry grammar's row and retention semantics (``scan_entries``,
``gc_entries``) on the same file layout, the ``cache_cli`` exit codes and
JSON, ``cache_cli result`` against a live port server, and the fleet's
``_relaunch_argv``. The card test (a real build published and reloaded)
is ``tests/test_torch_card.py::test_a_cached_library_runs_bitwise_like_a_fresh_build``.
"""

import hashlib
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

from nm03_capstone_project_tpu.compilehub import cache_cli as jcli  # noqa: F401 (jax)
from nm03_capstone_project_tpu.compilehub import persist as jpersist
from nm03_capstone_project_tpu.fleet import manager as jmanager
from nm03_capstone_project_tpu_torch import __version__
from nm03_capstone_project_tpu_torch.compilehub import cache_cli, persist
from nm03_capstone_project_tpu_torch.compilehub.persist import KernelCache, PersistKey
from nm03_capstone_project_tpu_torch.fleet import manager
from nm03_capstone_project_tpu_torch.kernels import build, median_runs
from nm03_capstone_project_tpu_torch.native import buildlib
from nm03_capstone_project_tpu_torch.resilience import FaultPlan

REPO = pathlib.Path(__file__).resolve().parents[1]
CHECKER = REPO / "scripts" / "check_telemetry.py"
NVCC = "Cuda compilation tools, release 12.4, V12.4.131"
HOUR = 3600.0


def _stub_key(name: str, **over) -> PersistKey:
    fields = dict(schema=persist.SCHEMA, name=name, sources_sha256="5" * 64,
                  headers_sha256="4" * 64, nvcc_flags=("-O3",), arch="sm_90a",
                  nvcc_version=NVCC, nm03_version=__version__)
    fields.update(over)
    return PersistKey(**fields)


def _stub_lib(path: pathlib.Path, name: str, size: int = 4096) -> pathlib.Path:
    rng = np.random.default_rng(sum(name.encode()))
    path.write_bytes(b"\x7fELF" + name.encode() + rng.bytes(size))
    return path


def _flip(path: pathlib.Path, offset_from_end: int = 10) -> None:
    raw = bytearray(path.read_bytes())
    raw[-offset_from_end] ^= 0xFF
    path.write_bytes(bytes(raw))


class _Log:
    """Records warnings (the port's loggers need not propagate to caplog)."""

    def __init__(self):
        self.lines = []

    def warning(self, msg, *args):
        self.lines.append(msg % args)


def _age(path: pathlib.Path, seconds: float) -> None:
    t = time.time() - seconds
    os.utime(path, (t, t))


# -- the key ---------------------------------------------------------------------


@pytest.fixture
def fake_nvcc(monkeypatch):
    monkeypatch.setattr(build, "nvcc_version", lambda: NVCC)


@pytest.mark.parametrize("change", ["NVCC_FLAGS", "ARCH", "MEDIAN_WINDOWS", "source",
                                    "FUSED_RUNS", "nvcc_version", "nm03_version", "name"])
def test_the_key_moves_with_each_input(change, monkeypatch, tmp_path, fake_nvcc):
    before = build.persist_key("fused")
    name = "fused"
    if change == "NVCC_FLAGS":
        monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    elif change == "ARCH":
        monkeypatch.setattr(build, "ARCH", "sm_100a")
    elif change == "MEDIAN_WINDOWS":
        monkeypatch.setattr(build, "MEDIAN_WINDOWS", build.MEDIAN_WINDOWS[:-1])
    elif change == "source":
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for n in build.SOURCES:
            text = (build.CSRC / f"{n}.cu").read_text()
            (csrc / f"{n}.cu").write_text(text + ("// edited\n" if n == "median" else ""))
        monkeypatch.setattr(build, "CSRC", csrc)
    elif change == "FUSED_RUNS":
        runs = dict(median_runs.FUSED_RUNS)
        runs[7] = runs[7] + 1
        monkeypatch.setattr(median_runs, "FUSED_RUNS", runs)
    elif change == "nvcc_version":
        monkeypatch.setattr(build, "nvcc_version", lambda: NVCC.replace("12.4", "12.6"))
    elif change == "nm03_version":
        monkeypatch.setattr(build, "__version__", "0.2.0")
    else:
        name = "grow"
    after = build.persist_key(name)
    assert after.digest() != before.digest()
    if change == "nvcc_version":
        # the toolkit is checked against the header, not named: a host
        # without nvcc must still find the entry
        assert after.filename() == before.filename()
    else:
        assert after.filename() != before.filename()
    if change != "name":
        assert build.persist_key(name) == after  # deterministic


def test_key_layout_mirrors_the_jax_key(fake_nvcc, monkeypatch):
    key = build.persist_key("median")
    assert key.schema == persist.SCHEMA and key.arch == build.ARCH == "sm_90a"
    assert key.nvcc_flags == build.NVCC_FLAGS and key.nm03_version == __version__
    # digest(): sha256 of the canonical JSON form, 20 hex, as in the JAX key
    want = hashlib.sha256(json.dumps(key.to_json(), sort_keys=True).encode()).hexdigest()
    assert key.digest() == want[:20]
    assert key.filename() == f"median-sm_90a-{key.identity_digest()}{persist.ENTRY_SUFFIX}"
    assert persist.ENV_CACHE_DIR == jpersist.ENV_CACHE_DIR == "NM03_COMPILE_CACHE_DIR"
    for env in ({}, {"NM03_COMPILE_CACHE_DIR": ""}, {"NM03_COMPILE_CACHE_DIR": "/c"}):
        assert persist.cache_dir_from_env(env) == jpersist.cache_dir_from_env(env)
    # _build/<key> keeps its own key: the toolkit is a cache's check
    local = build.build_dir()
    monkeypatch.setattr(build, "nvcc_version", lambda: None)
    assert build.build_dir() == local and build.persist_key("median") != key


# -- the store --------------------------------------------------------------------


def test_cold_store_then_warm_hit(tmp_path):
    root, dest = tmp_path / "cache", tmp_path / "dest"
    dest.mkdir()
    lib = _stub_lib(tmp_path / "libmedian.so", "median")
    cold = KernelCache(root, key_fn=_stub_key)
    assert cold.load("median", dest) is None
    assert cold.store("median", lib)
    entry = root / _stub_key("median").filename()
    assert entry.exists() and not list(root.glob("*.tmp"))
    assert cold.stats()["misses"] == 1 and cold.stats()["stores"] == 1
    warm = KernelCache(root, key_fn=_stub_key)
    got = warm.load("median", dest)
    assert got == dest / "libmedian.so" and got.read_bytes() == lib.read_bytes()
    s = warm.stats()
    assert (s["hits"], s["misses"], s["corrupt"], s["stale"]) == (1, 0, 0, 0)
    assert s["bytes_read"] == entry.stat().st_size and s["load_seconds"] >= 0
    # the /readyz fields carry the JAX names
    jstats = jpersist.ExecutableCache(tmp_path / "jax").readyz_stats()
    assert set(warm.readyz_stats()) == set(jstats)


@pytest.mark.parametrize("damage", ["flipped_byte", "truncated", "no_separator",
                                    "bad_schema", "other_toolkit", "tampered_key"])
def test_a_bad_entry_is_a_counted_miss(damage, tmp_path):
    root, dest = tmp_path / "cache", tmp_path / "dest"
    dest.mkdir()
    lib = _stub_lib(tmp_path / "libgrow.so", "grow")
    key_fn = _stub_key
    if damage == "other_toolkit":
        KernelCache(root, key_fn=lambda n: _stub_key(n, nvcc_version="V12.3.107")).store(
            "grow", lib)
    else:
        KernelCache(root, key_fn=key_fn).store("grow", lib)
    entry = root / _stub_key("grow").filename()
    if damage == "flipped_byte":
        _flip(entry)
    elif damage == "truncated":
        entry.write_bytes(entry.read_bytes()[:-100])
    elif damage == "no_separator":
        entry.write_bytes(b"x" * 64)
    elif damage == "bad_schema":
        head, _, payload = entry.read_bytes().partition(b"\n")
        header = json.loads(head)
        header["schema"] = "nm03.exe.v1"
        entry.write_bytes(json.dumps(header).encode() + b"\n" + payload)
    elif damage == "tampered_key":
        head, _, payload = entry.read_bytes().partition(b"\n")
        header = json.loads(head)
        header["key"]["headers_sha256"] = "0" * 64
        entry.write_bytes(json.dumps(header).encode() + b"\n" + payload)
    cache = KernelCache(root, key_fn=key_fn)
    assert cache.load("grow", dest) is None
    assert not (dest / "libgrow.so").exists()  # nothing unverified reaches a dlopen
    s = cache.stats()
    assert s["misses"] == 1 and s["hits"] == 0
    assert s["stale"] == (damage == "other_toolkit")
    assert s["corrupt"] == (damage not in ("other_toolkit", "tampered_key"))
    # the rebuild's store replaces the entry, and it then loads
    assert cache.store("grow", lib) and cache.load("grow", dest) is not None


def test_a_host_without_nvcc_accepts_the_entry(tmp_path):
    root, dest = tmp_path / "cache", tmp_path / "dest"
    dest.mkdir()
    lib = _stub_lib(tmp_path / "libfused.so", "fused")
    assert KernelCache(root, key_fn=_stub_key).store("fused", lib)
    blind = KernelCache(root, key_fn=lambda n: _stub_key(n, nvcc_version=None))
    assert blind.load("fused", dest).read_bytes() == lib.read_bytes()
    assert blind.stats()["hits"] == 1


def test_concurrent_stores_leave_one_valid_entry(tmp_path):
    root = tmp_path / "cache"
    libs = [_stub_lib(tmp_path / f"lib{i}.so", "median") for i in range(6)]
    caches = [KernelCache(root, key_fn=_stub_key) for _ in libs]
    threads = [threading.Thread(target=c.store, args=("median", lib))
               for c, lib in zip(caches, libs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert [p.name for p in root.iterdir()] == [_stub_key("median").filename()]
    rows = persist.scan_entries(root, current={"median": _stub_key("median").to_json()})
    assert [r["status"] for r in rows] == ["ok"]


def test_io_error_aborts_the_publish_and_gc_reclaims_the_tmp(tmp_path):
    from nm03_capstone_project_tpu_torch.serving.server import _cache_fault_hook

    root = tmp_path / "cache"
    lib = _stub_lib(tmp_path / "libmedian.so", "median")
    plan = FaultPlan.from_spec({"faults": [{"site": "cache", "kind": "io_error",
                                            "count": 1}]})
    cache = KernelCache(root, key_fn=_stub_key, fault_hook=_cache_fault_hook(plan, None))
    assert cache.store("median", lib) is False
    assert plan.fired_total() == 1 and cache.stats()["store_errors"] == 1
    tmps = list(root.glob("*.tmp"))
    assert len(tmps) == 1 and not list(root.glob(f"*{persist.ENTRY_SUFFIX}"))
    current = {"median": _stub_key("median").to_json()}
    # a fresh tmp may be a live writer's: kept; past the grace it is reclaimed
    assert persist.gc_entries(root, current=current)["removed"] == []
    _age(tmps[0], persist.TMP_ORPHAN_GRACE_S + 60)
    report = persist.gc_entries(root, current=current)
    assert report["removed"] == [tmps[0].name] and not tmps[0].exists()
    # the plan's one fire is spent: the next store publishes
    assert cache.store("median", lib) and cache.stats()["stores"] == 1


def test_an_unusable_directory_raises_oserror(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    with pytest.raises(OSError):
        KernelCache(blocker)


# -- where build.load finds a library --------------------------------------------


class _Lib:
    def __init__(self, path):
        self.path = str(path)
        for fns in build.ARGTYPES.values():
            for fn in fns:
                setattr(self, fn, type("F", (), {})())


@pytest.fixture
def stub_build(monkeypatch, tmp_path):
    """The build with its compile step and dlopen stubbed, its process
    state fresh, ``_build`` under tmp_path, no cache variable."""
    compiled = []

    def fake_compile(names, out_dir):
        names = list(names)
        compiled.append((names, pathlib.Path(out_dir)))
        for n in names:
            _stub_lib(pathlib.Path(out_dir) / f"lib{n}.so", n)
        return {n: 0.25 for n in names}

    monkeypatch.delenv(persist.ENV_CACHE_DIR, raising=False)
    monkeypatch.setattr(build, "nvcc_version", lambda: NVCC)
    monkeypatch.setattr(build, "_compile", fake_compile)
    monkeypatch.setattr(build.ctypes, "CDLL", _Lib)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "_build")
    (tmp_path / "private").mkdir()
    fresh_process(monkeypatch, tmp_path / "private")
    yield compiled
    build.load.cache_clear()


def fresh_process(monkeypatch, private):
    """Forget every load, as a new process would."""
    monkeypatch.setattr(build, "_STATE", {"cache": None, "private": False,
                                          "env_checked": False})
    monkeypatch.setattr(build, "_RECORDS", {})
    monkeypatch.setattr(build, "_PRIVATE_DIR", [private])
    build.load.cache_clear()


def _load_all():
    return {n: build.load(n) for n in build.SOURCES}


def test_without_a_cache_libraries_build_and_load_beside_the_package(stub_build):
    libs = _load_all()
    out_dir = build.build_dir()
    assert stub_build == [(list(build.SOURCES), out_dir)]
    assert {n: pathlib.Path(lib.path) for n, lib in libs.items()} == {
        n: out_dir / f"lib{n}.so" for n in build.SOURCES}
    recs = build.records()
    assert {r["source"] for r in recs.values()} == {"local"}
    assert all(r["build_s"] == 0.25 and r["entry"] is None for r in recs.values())


@pytest.mark.parametrize("reached,recorded,rebuilds", [
    (NVCC, NVCC, False),  # the toolkit that built it: loaded
    ("Cuda compilation tools, release 12.8, V12.8.93", NVCC, True),  # another: rebuilt
    (NVCC, None, True),  # no record of its toolkit: rebuilt
    (None, NVCC, False),  # no nvcc in reach: loaded as it is
    (None, None, False),
])
def test_build_dir_follows_the_reachable_toolkit(stub_build, monkeypatch, reached, recorded,
                                                 rebuilds):
    out_dir = build.build_dir()
    out_dir.mkdir(parents=True)
    for n in build.SOURCES:
        _stub_lib(out_dir / f"lib{n}.so", n)
    if recorded is not None:
        (out_dir / "nvcc_version.txt").write_text(recorded)
    monkeypatch.setattr(build, "nvcc_version", lambda: reached)
    libs = _load_all()
    assert stub_build == ([(list(build.SOURCES), out_dir)] if rebuilds else [])
    assert {pathlib.Path(lib.path).parent for lib in libs.values()} == {out_dir}
    record = out_dir / "nvcc_version.txt"
    assert (record.read_text() if record.exists() else None) == (reached if rebuilds
                                                                 else recorded)
    # a second process with the same toolkit loads what the first left
    fresh_process(monkeypatch, out_dir.parent / "private")
    _load_all()
    assert len(stub_build) == (1 if rebuilds else 0)


def test_cold_then_warm_through_the_cache(stub_build, monkeypatch, tmp_path):
    root = tmp_path / "cache"
    cold = KernelCache(root)
    build.attach_cache(cold)
    libs = _load_all()
    (names, where), = stub_build
    assert names == list(build.SOURCES) and where == tmp_path / "private"
    assert not build.BUILD_ROOT.exists()  # nothing beside the package
    n = len(build.SOURCES)
    s = cold.stats()
    assert (s["misses"], s["hits"], s["stores"]) == (n, 0, n)
    assert {r["source"] for r in build.records().values()} == {"built"}
    built = {n: pathlib.Path(lib.path).read_bytes() for n, lib in libs.items()}
    assert [r["status"] for r in persist.scan_entries(root)] == ["ok"] * n

    fresh_process(monkeypatch, tmp_path / "private2")
    (tmp_path / "private2").mkdir()
    warm = KernelCache(root)
    build.attach_cache(warm)
    libs = _load_all()
    assert len(stub_build) == 1  # no build
    s = warm.stats()
    assert (s["hits"], s["misses"], s["stores"]) == (len(build.SOURCES), 0, 0)
    recs = build.records()
    assert {r["source"] for r in recs.values()} == {"cache"}
    assert all(r["build_s"] is None and r["load_s"] > 0 and r["entry"] for r in recs.values())
    assert {n: pathlib.Path(lib.path).read_bytes() for n, lib in libs.items()} == built


def test_the_variable_is_read_and_an_attached_cache_wins(stub_build, monkeypatch, tmp_path):
    monkeypatch.setenv(persist.ENV_CACHE_DIR, str(tmp_path / "env"))
    _load_all()
    assert len(list((tmp_path / "env").glob(f"*{persist.ENTRY_SUFFIX}"))) == len(build.SOURCES)
    fresh_process(monkeypatch, tmp_path / "private")
    build.attach_cache(KernelCache(tmp_path / "flag"))
    _load_all()
    assert len(list((tmp_path / "flag").glob(f"*{persist.ENTRY_SUFFIX}"))) == len(build.SOURCES)
    assert build.records()["median"]["source"] == "built"  # not the variable's


def test_an_unusable_cache_dir_builds_privately(stub_build, monkeypatch, tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    monkeypatch.setenv(persist.ENV_CACHE_DIR, str(blocker))
    monkeypatch.setattr(build, "log", _Log())
    _load_all()
    assert stub_build[0][1] == tmp_path / "private"
    assert not build.BUILD_ROOT.exists()
    assert {r["source"] for r in build.records().values()} == {"built"}
    assert any("unusable" in line for line in build.log.lines)


def test_a_corrupt_entry_rebuilds_that_library_only(stub_build, monkeypatch, tmp_path):
    root = tmp_path / "cache"
    build.attach_cache(KernelCache(root))
    _load_all()
    _flip(root / build.persist_key("median").filename())
    assert cache_cli.main(["--dir", str(root), "verify"]) == 1
    fresh_process(monkeypatch, tmp_path / "private")
    cache = KernelCache(root)
    build.attach_cache(cache)
    _load_all()
    assert stub_build[-1][0] == ["median"]
    s = cache.stats()
    assert (s["hits"], s["misses"], s["corrupt"], s["stores"]) == (len(build.SOURCES) - 1, 1, 1, 1)
    assert build.records()["median"]["source"] == "built"
    assert cache_cli.main(["--dir", str(root), "verify"]) == 0


def test_a_failed_store_serves_from_the_private_build(stub_build, tmp_path):
    from nm03_capstone_project_tpu_torch.serving.server import _cache_fault_hook

    root = tmp_path / "cache"
    plan = FaultPlan.from_spec({"faults": [{"site": "cache", "kind": "io_error",
                                            "stem": build.persist_key("grow").filename()}]})
    cache = KernelCache(root, fault_hook=_cache_fault_hook(plan, None))
    build.attach_cache(cache)
    libs = _load_all()
    assert pathlib.Path(libs["grow"].path).exists()
    assert build.records()["grow"] == {"source": "built", "build_s": 0.25,
                                       "load_s": build.records()["grow"]["load_s"],
                                       "entry": None}
    s = cache.stats()
    n = len(build.SOURCES)
    assert (s["misses"], s["stores"], s["store_errors"]) == (n, n - 1, 1)
    assert len(list(root.glob("*.tmp"))) == 1
    assert {r["name"] for r in persist.scan_entries(root)} == set(build.SOURCES) - {"grow"}


# -- scan and gc against the JAX functions ----------------------------------------

ROLES = ("ok_old", "ok_new", "flipped", "torn", "stale", "garbage")


def _jax_layout(root: pathlib.Path) -> dict:
    root.mkdir()
    versions = jpersist._versions()

    def key(name, **over):
        fields = dict(name=name, variant="v", shape=(1, 8, 8), mesh=None, device=None,
                      device_kind=None, platform="cpu", lane=None, backend=None,
                      donate=False, cfg_digest="c" * 16, **versions)
        fields.update(over)
        return jpersist.PersistKey(**fields)

    keys = {"ok_old": key("a"), "ok_new": key("b"), "flipped": key("c"), "torn": key("d"),
            "stale": key("e", jaxlib_version="0.0.1"), "garbage": key("f")}
    return {role: _write(root, k.filename(), jpersist._compose_entry(
        k, jpersist.FORMAT_PJRT, np.random.default_rng(i).bytes(3000)))
        for i, (role, k) in enumerate(keys.items())}


def _port_layout(root: pathlib.Path) -> tuple:
    root.mkdir()
    keys = {"ok_old": _stub_key("median"), "ok_new": _stub_key("fused"),
            "flipped": _stub_key("grow"), "torn": _stub_key("a"),
            "stale": _stub_key("b", nvcc_version="V0"), "garbage": _stub_key("c")}
    current = {k.name: _stub_key(k.name).to_json() for k in keys.values()}
    files = {role: _write(root, k.filename(), persist._compose_entry(
        k, np.random.default_rng(i).bytes(3000)))
        for i, (role, k) in enumerate(keys.items())}
    return files, current


def _write(root, name, data):
    path = root / name
    path.write_bytes(data)
    return path


def _damage(files: dict, root: pathlib.Path) -> None:
    _flip(files["flipped"])
    files["torn"].write_bytes(files["torn"].read_bytes()[:-50])
    files["garbage"].write_bytes(b"\x00\x01 not an entry\n" + b"x" * 100)
    for role, age in (("ok_old", 3 * HOUR), ("ok_new", 60.0), ("flipped", 120.0),
                      ("torn", 120.0), ("stale", 120.0), ("garbage", 120.0)):
        _age(files[role], age)
    for name, age in (("old.nm03.tmp", persist.TMP_ORPHAN_GRACE_S + 60), ("new.nm03.tmp", 1)):
        p = root / name
        p.write_bytes(b"partial")
        _age(p, age)


def _by_role(files: dict, rows) -> dict:
    names = {p.name: role for role, p in files.items()}
    return {names[r["file"]]: r["status"] for r in rows}


@pytest.fixture
def layouts(tmp_path):
    jfiles = _jax_layout(tmp_path / "jax")
    pfiles, current = _port_layout(tmp_path / "port")
    _damage(jfiles, tmp_path / "jax")
    _damage(pfiles, tmp_path / "port")
    return jfiles, pfiles, current


@pytest.mark.parametrize("checksum", [True, False])
def test_scan_rows_match_the_jax_scan(layouts, checksum):
    jfiles, pfiles, current = layouts
    jrows = jpersist.scan_entries(next(iter(jfiles.values())).parent, checksum=checksum)
    prows = persist.scan_entries(next(iter(pfiles.values())).parent, checksum=checksum,
                                 current=current)
    assert _by_role(pfiles, prows) == _by_role(jfiles, jrows)
    # header-only scans see the torn entry, only the checksum the flipped one
    assert _by_role(pfiles, prows)["flipped"] == ("corrupt" if checksum else "ok")
    common = {"file", "bytes", "age_s", "mtime", "status"}
    for jr, pr in zip(sorted(jrows, key=lambda r: r["status"]),
                      sorted(prows, key=lambda r: r["status"])):
        assert common <= set(jr) & set(pr)
        if pr["status"] in ("ok", "stale"):
            shared = {"name", "format", "nm03_version", "created_unix"}
            assert shared <= set(jr) and shared <= set(pr)
        if pr["status"] == "stale":
            assert set(pr["stale_fields"]) == {"nvcc_version"}
            assert "stale_fields" in jr


@pytest.mark.parametrize("policy", ["none", "max_age", "max_bytes", "dry_run"])
def test_gc_retention_matches_the_jax_gc(layouts, policy):
    jfiles, pfiles, current = layouts
    reports = {}
    for pkg, files in (("jax", jfiles), ("port", pfiles)):
        root = next(iter(files.values())).parent
        kw = {}
        if policy == "max_age":
            kw["max_age_s"] = HOUR
        elif policy == "max_bytes":
            kw["max_bytes"] = files["ok_new"].stat().st_size  # room for the newest only
        elif policy == "dry_run":
            kw["dry_run"] = True
        if pkg == "jax":
            report = jpersist.gc_entries(root, **kw)
        else:
            report = persist.gc_entries(root, current=current, **kw)
        names = {p.name: role for role, p in files.items()}
        removed = sorted(names.get(n, n) for n in report["removed"])
        left = sorted(names.get(p.name, p.name) for p in root.iterdir())
        reports[pkg] = (removed, report["kept"], left, set(report))
    assert reports["port"] == reports["jax"]
    removed, kept, left, keys = reports["port"]
    assert keys == {"removed", "freed_bytes", "kept", "kept_bytes"}
    assert {"torn", "stale", "garbage", "old.nm03.tmp"} <= set(removed)
    assert "new.nm03.tmp" not in removed
    if policy == "dry_run":
        assert len(left) == len(ROLES) + 2


# -- the CLI against the JAX CLI --------------------------------------------------


def _run_cli(mod, argv, capsys):
    try:
        rc = mod.main(argv)
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("case", ["ls_empty", "verify_empty", "gc_empty", "ls_mixed",
                                  "verify_mixed", "gc_mixed", "no_dir", "missing_dir",
                                  "bad_bytes", "bad_age"])
def test_cli_exit_codes_and_json_match_the_jax_cli(case, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv(persist.ENV_CACHE_DIR, raising=False)
    monkeypatch.setattr(build, "nvcc_version", lambda: NVCC)
    jroot, proot = tmp_path / "jax", tmp_path / "port"
    if case.endswith("_mixed"):
        jfiles = _jax_layout(jroot)
        proot.mkdir()
        pfiles = {}
        for role, name in (("ok_old", "median"), ("ok_new", "fused"), ("flipped", "grow")):
            key = build.persist_key(name)
            pfiles[role] = _write(proot, key.filename(), persist._compose_entry(
                key, np.random.default_rng(len(name)).bytes(3000)))
        stale = _stub_key("median", nm03_version="0.0.1")
        pfiles["stale"] = _write(proot, stale.filename(), persist._compose_entry(stale, b"s"))
        pfiles["torn"] = _write(proot, "torn" + persist.ENTRY_SUFFIX, b"{}\n")
        pfiles["garbage"] = _write(proot, "garbage" + persist.ENTRY_SUFFIX, b"\x00")
        jfiles["torn"].write_bytes(jfiles["torn"].read_bytes()[:-50])
        jfiles["garbage"].write_bytes(b"\x00")
        for files, root in ((jfiles, jroot), (pfiles, proot)):
            _flip(files["flipped"])
            (root / "stray.txt").write_text("not ours")
    else:
        jroot.mkdir()
        proot.mkdir()
    sub = case.split("_")[0]
    if case == "no_dir":
        jargv = pargv = ["ls"]
    elif case == "missing_dir":
        jargv, pargv = (["--dir", str(tmp_path / "nowhere"), "verify"],) * 2
    elif case == "bad_bytes":
        jargv, pargv = (["--dir", str(r), "gc", "--max-bytes", "12q"] for r in (jroot, proot))
    elif case == "bad_age":
        jargv, pargv = (["--dir", str(r), "gc", "--max-age", "soon"] for r in (jroot, proot))
    else:
        jargv, pargv = (["--dir", str(r), "--format", "json", sub] for r in (jroot, proot))
    jrc, jout, jerr = _run_cli(jcli, jargv, capsys)
    prc, pout, perr = _run_cli(cache_cli, pargv, capsys)
    assert prc == jrc
    assert (prc, case) in {(0, "ls_empty"), (0, "verify_empty"), (0, "gc_empty"),
                           (0, "ls_mixed"), (1, "verify_mixed"), (0, "gc_mixed"),
                           (2, "no_dir"), (2, "missing_dir"), (2, "bad_bytes"),
                           (2, "bad_age")}
    assert ("ignoring 1 non-cache file" in perr) == ("ignoring 1 non-cache file" in jerr)
    if not jout.strip():
        assert not pout.strip()
        return
    jdoc, pdoc = json.loads(jout), json.loads(pout)
    assert set(pdoc) == set(jdoc)
    if sub == "verify":
        for field in ("entries", "ok"):
            assert pdoc[field] == jdoc[field]
        for field in ("stale", "corrupt", "unreadable"):
            assert len(pdoc[field]) == len(jdoc[field]), field
    elif sub == "ls":
        assert [r["status"] for r in pdoc["entries"]].count("ok") == \
            [r["status"] for r in jdoc["entries"]].count("ok")
    else:
        assert len(pdoc["removed"]) == len(jdoc["removed"])
        assert pdoc["kept"] == jdoc["kept"] and pdoc["dry_run"] == jdoc["dry_run"]


def test_cli_text_ls_names_the_library_and_its_toolkit(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(build, "nvcc_version", lambda: NVCC)
    key = build.persist_key("fused")
    _write(tmp_path, key.filename(), persist._compose_entry(key, b"lib"))
    assert cache_cli.main(["--dir", str(tmp_path), "ls"]) == 0
    out = capsys.readouterr().out
    assert "libfused.so @sm_90a" in out and "12.4.131" in out and "1 entries" in out


@pytest.fixture(scope="module")
def port_server():
    """A port server on the CPU with the result tier, two slices filled."""
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp, serve_in_thread

    apps = []
    urls = {}
    for name, tier in (("tier", 1 << 24), ("none", 0)):
        app = ServingApp(cfg=PipelineConfig(canvas=128), buckets=(1,), device="cpu",
                         result_cache_bytes=tier)
        httpd, _, port = serve_in_thread(app)
        apps.append((app, httpd))
        urls[name] = f"http://127.0.0.1:{port}"
    for seed in (1, 2):
        body = phantom_slice(120, 112, seed=seed).astype("<f4").tobytes()
        req = urllib.request.Request(
            urls["tier"] + "/v1/segment?output=mask", data=body, method="POST",
            headers={"Content-Type": "application/octet-stream", "X-Nm03-Height": "120",
                     "X-Nm03-Width": "112"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
    yield urls
    for app, httpd in apps:
        httpd.shutdown()
        httpd.server_close()
        app.begin_drain()
        app.close()


def _strip_age(doc):
    if isinstance(doc, dict) and "ls" in doc:
        doc = dict(doc, ls=[{k: v for k, v in r.items() if k != "age_s"} for r in doc["ls"]])
    return doc


@pytest.mark.parametrize("action", ["ls", "stats"])
@pytest.mark.parametrize("fmt", ["json", "text"])
def test_cache_cli_result_matches_the_jax_cli(port_server, action, fmt, capsys):
    argv = ["--format", fmt, "result", action, "--url", port_server["tier"]]
    jrc, jout, _ = _run_cli(jcli, argv, capsys)
    prc, pout, _ = _run_cli(cache_cli, argv, capsys)
    assert prc == jrc == 0
    if fmt == "json":
        assert _strip_age(json.loads(pout)) == _strip_age(json.loads(jout))
    elif action == "stats":
        assert pout == jout
    else:  # the AGE column moves between the two calls
        assert [line.split()[-1] for line in pout.splitlines()] == \
            [line.split()[-1] for line in jout.splitlines()]


def test_cache_cli_result_evict_and_refusals_match_the_jax_cli(port_server, capsys):
    base = port_server["tier"]
    _, out, _ = _run_cli(cache_cli, ["--format", "json", "result", "ls", "--url", base], capsys)
    digests = [r["digest"] for r in json.loads(out)["ls"]]
    assert len(digests) == 2
    # one digest each: the same answer for the same state
    prc, pout, _ = _run_cli(cache_cli, ["--format", "json", "result", "evict", "--url", base,
                                        "--digest", digests[0]], capsys)
    jrc, jout, _ = _run_cli(jcli, ["--format", "json", "result", "evict", "--url", base,
                                   "--digest", digests[1]], capsys)
    assert prc == jrc == 0 and json.loads(pout) == json.loads(jout)
    assert json.loads(pout)["evicted"] == 1
    for argv in (["result", "stats", "--url", port_server["none"]],
                 ["result", "ls", "--url", "http://127.0.0.1:9"],
                 ["result", "evict"]):
        jrc, _, jerr = _run_cli(jcli, argv, capsys)
        prc, _, perr = _run_cli(cache_cli, argv, capsys)
        assert prc == jrc == 2
        assert ("disabled" in perr) == ("disabled" in jerr)


# -- the fleet's relaunch ---------------------------------------------------------


@pytest.mark.parametrize("argv,cache_dir", [
    (["py", "-m", "srv", "--port", "8081"], None),
    (["py", "-m", "srv", "--port", "8081"], "/c"),
    (["py", "-m", "srv", "--compile-cache-dir", "/old", "--port", "8081"], "/c"),
    (["py", "-m", "srv", "--compile-cache-dir"], "/c"),
    (["py", "-m", "srv", "--compile-cache-dir", "/old"], None),
])
def test_relaunch_argv_equals_the_jax_one(argv, cache_dir):
    got = manager._relaunch_argv(argv, cache_dir)
    assert got == jmanager._relaunch_argv(argv, cache_dir)
    assert got is not argv and argv[:3] == ["py", "-m", "srv"]  # the recipe is a copy
    if cache_dir and argv[-1] != "--compile-cache-dir":
        assert got[got.index("--compile-cache-dir") + 1] == cache_dir


def test_rolling_restart_takes_the_cache_dir_where_the_jax_one_does():
    import inspect

    assert list(inspect.signature(manager.rolling_restart).parameters)[:2] == \
        list(inspect.signature(jmanager.rolling_restart).parameters)[:2] == \
        ["targets", "compile_cache_dir"]


# -- a server with a cache on the CPU ---------------------------------------------


def _checker(*argv):
    return subprocess.run([sys.executable, str(CHECKER), *map(str, argv)],
                          capture_output=True, text=True, timeout=60)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_a_server_with_a_cache_publishes_the_counters(start, stub_build, monkeypatch,
                                                      tmp_path):
    """On the card the warmup's captures load every library; on the CPU
    nothing loads, so the test loads them where the warmup would."""
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.obs import RunContext
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp

    root = tmp_path / "cache"
    if start == "warm":  # a first process filled the cache
        build.attach_cache(KernelCache(root))
        _load_all()
        fresh_process(monkeypatch, tmp_path / "private")
    metrics = tmp_path / "m.json"
    app = ServingApp(cfg=PipelineConfig(canvas=128), buckets=(1,), device="cpu",
                     compile_cache_dir=str(root),
                     obs=RunContext.create("serve", metrics_out=str(metrics)))
    try:
        assert build.attached_cache() is app._attached_cache
        _load_all()
        app.start()
        st = app.status()
        n = len(build.SOURCES)
        hits = n if start == "warm" else 0
        assert st["replica"]["compile_cache_hits"] == hits
        hub = st["compile_hub"]
        assert (hub["cache_hits"], hub["cache_misses"]) == (hits, n - hits)
        assert hub["cache_dir"] == str(root) and hub["builds"] == n - hits
        assert hub["cache_loads"] == hits
        assert {r["source"] for r in hub["libraries"].values()} == {
            "cache" if hits else "built"}
        app.begin_drain()
    finally:
        app.close()
    assert build.attached_cache() is None  # the app detached its cache
    res = _checker("--metrics", metrics,
                   "--expect-counter", f"compile_cache_hits_total=={hits}",
                   "--expect-counter", f"compile_cache_misses_total=={n - hits}")
    assert res.returncode == 0, res.stdout + res.stderr


def test_a_server_without_a_cache_publishes_no_cache_series(tmp_path):
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.serving.metrics import COMPILE_CACHE_HITS_TOTAL
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp

    app = ServingApp(cfg=PipelineConfig(canvas=128), buckets=(1,), device="cpu")
    try:
        app.start()
        assert app.registry.get(COMPILE_CACHE_HITS_TOTAL) is None
        st = app.status()
        assert st["replica"]["compile_cache_hits"] is None
        assert "cache_hits" not in st["compile_hub"]
    finally:
        app.begin_drain()
        app.close()


def test_an_unusable_cache_dir_leaves_the_server_serving(tmp_path, monkeypatch):
    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.serving import server
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp

    monkeypatch.setattr(build, "_STATE", {"cache": None, "private": False,
                                          "env_checked": False})
    monkeypatch.setattr(server, "log", _Log())
    blocker = tmp_path / "file"
    blocker.write_text("x")
    app = ServingApp(cfg=PipelineConfig(canvas=128), buckets=(1,), device="cpu",
                     compile_cache_dir=str(blocker))
    try:
        assert any("unusable" in line for line in server.log.lines)
        assert app._attached_cache is None and build._STATE["private"] is True
        app.start()
        assert app.ready and app.status()["compile_hub"]["cache_dir"] is None
    finally:
        app.begin_drain()
        app.close()


# -- the host shims' build key ----------------------------------------------------


class TestHostShimKey:
    def test_a_changed_flag_or_compiler_moves_the_path(self, monkeypatch, tmp_path):
        import logging

        src = tmp_path / "shim.cpp"
        src.write_text("extern \"C\" int f() { return 1; }\n")
        version = ["g++ 12.2.0"]
        ran = []

        def fake_run(cmd, **kw):
            if cmd[-1] == "--version":
                return subprocess.CompletedProcess(cmd, 0, stdout=version[0], stderr="")
            ran.append(cmd)
            pathlib.Path(cmd[-1]).write_bytes(b"so")
            return subprocess.CompletedProcess(cmd, 0, stdout="", stderr="")

        monkeypatch.setattr(buildlib.subprocess, "run", fake_run)
        buildlib.compiler_version.cache_clear()
        log = logging.getLogger("test")
        try:
            a = buildlib.build_shared_library(src, tmp_path / "b", "shim", ["-DA=1"], log)
            again = buildlib.build_shared_library(src, tmp_path / "b", "shim", ["-DA=1"], log)
            b = buildlib.build_shared_library(src, tmp_path / "b", "shim", ["-DA=2"], log)
            buildlib.compiler_version.cache_clear()
            version[0] = "g++ 13.1.0"
            c = buildlib.build_shared_library(src, tmp_path / "b", "shim", ["-DA=2"], log)
        finally:
            buildlib.compiler_version.cache_clear()
        assert a == again and len({a, b, c}) == 3
        assert len(ran) == 3  # the unchanged build was found, not rebuilt
        assert all(p.name.startswith("libshim-") for p in (a, b, c))
        assert ran[0][:5] == [buildlib.CXX, *buildlib.CXX_FLAGS]

    def test_the_key_names_source_flags_and_compiler(self, monkeypatch):
        monkeypatch.setattr(buildlib, "compiler_version", lambda: "g++ 12")
        base = buildlib.build_tag(b"src", ["-lz"])
        assert base == buildlib.build_tag(b"src", ["-lz"])
        assert base != buildlib.build_tag(b"src2", ["-lz"])
        assert base != buildlib.build_tag(b"src", ["-lz", "-g"])
        monkeypatch.setattr(buildlib, "compiler_version", lambda: "g++ 13")
        assert base != buildlib.build_tag(b"src", ["-lz"])
