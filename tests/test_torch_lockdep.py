"""The port's runtime lockdep (``nm03_capstone_project_tpu_torch/utils/lockdep.py``).

* the wrapper: creation-site scoping (the port's package only, not the JAX
  package whose name is a prefix of the port's), RLock reentrancy,
  Condition pass-through, hold budgets, the atomic witness dump, and the
  server's ``NM03_LOCKDEP=1`` gate;
* the ABBA battery: opposite orders on two threads record one inversion
  naming both stacks, and the port's gate refuses the witness;
* the serving drill: a four-lane port server with the volume gang, built
  inside the lockdep window on the CPU, answers mixed slice and study
  traffic; its witness gates clean against the port's static graph, in
  process and through ``python -m nm03_capstone_project_tpu_torch.analysis.gate``,
  and the same witness with one edge inverted fails.

Every test uninstalls: the factory patch is process-global.
"""

from __future__ import annotations

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
import torch

from nm03_capstone_project_tpu_torch.analysis import gate
from nm03_capstone_project_tpu_torch.analysis.core import collect_files
from nm03_capstone_project_tpu_torch.analysis.lockorder import (
    build_lock_graph,
    explain_witness,
)
from nm03_capstone_project_tpu_torch.utils import lockdep

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = "nm03_capstone_project_tpu_torch"
HERE = pathlib.Path(__file__).resolve().parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def installed():
    """Lockdep installed with this test file's directory instrumented."""
    st = lockdep.install(extra_prefixes=(str(HERE),))
    try:
        yield st
    finally:
        lockdep.uninstall()


@pytest.fixture(scope="module")
def static_graph():
    return build_lock_graph(collect_files(gate.port_paths(), REPO))


class TestWrapperUnit:
    def test_package_frame_scoping_and_uninstall(self, installed):
        lock = threading.Lock()  # created HERE -> instrumented
        assert type(lock).__name__ == "_InstrumentedLock"
        with lock:
            assert lock.locked()
        assert not lock.locked()
        lockdep.uninstall()
        assert threading.Lock().__class__.__module__ == "_thread"
        assert lockdep.uninstall() is None  # idempotent
        lockdep.install(extra_prefixes=(str(HERE),))  # the fixture rebalances

    def test_port_locks_are_instrumented_and_jax_package_locks_are_not(self):
        """The JAX package's directory name is a prefix of the port's: the
        creation-site filter matches the port's directory with its separator."""
        from nm03_capstone_project_tpu.serving.queue import AdmissionQueue as JaxQueue
        from nm03_capstone_project_tpu_torch.serving.queue import AdmissionQueue

        st = lockdep.install()
        try:
            port_q = AdmissionQueue(4)
            jax_q = JaxQueue(4)
            assert type(port_q._lock).__name__ == "_InstrumentedLock"
            assert type(jax_q._lock).__module__ == "_thread"
            paths = {s["path"] for s in st.snapshot()["sites"]}
            assert paths == {f"{PORT}/serving/queue.py"}
        finally:
            lockdep.uninstall()

    def test_stdlib_event_and_thread_locks_not_misattributed(self, installed):
        ev = threading.Event()
        t = threading.Thread(target=lambda: None)
        t.start()
        t.join()
        ev.set()
        assert "test_torch_lockdep" not in json.dumps(installed.snapshot()["sites"])

    def test_torch_made_locks_are_not_port_sites(self, installed):
        """torch creates locks and threads of its own (here: a CPU profiler
        window); none may claim a site."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]):
            torch.ones(4).sum()
        assert installed.snapshot()["sites"] == []

    def test_rlock_reentrancy_records_no_self_edge(self, installed):
        r = threading.RLock()
        assert type(r).__name__ == "_InstrumentedRLock"
        with r:
            with r:
                assert r.locked()
        assert all(e["src"] != e["dst"] for e in installed.snapshot()["edges"])

    def test_condition_wait_flows_through_tracked_path(self, installed):
        inner = threading.Lock()
        cond = threading.Condition(inner)
        done = []

        def waiter():
            with cond:
                cond.wait(timeout=5)
                done.append(True)

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.05)
        with cond:
            cond.notify()
        t.join(timeout=5)
        assert done == [True]
        probe = threading.Lock()
        with probe:
            pass
        assert all(e["src"] != e["dst"] for e in installed.snapshot()["edges"])

    def test_hold_budget_flags_slow_hold(self):
        st = lockdep.install(budget_s=0.001, extra_prefixes=(str(HERE),))
        try:
            slow = threading.Lock()
            with slow:
                time.sleep(0.02)
            assert any(o["held_s"] >= 0.01 for o in st.snapshot()["over_budget"])
        finally:
            lockdep.uninstall()

    def test_witness_dump_is_atomic_and_versioned(self, installed, tmp_path):
        lock = threading.Lock()
        with lock:
            pass
        out = lockdep.dump_witness(tmp_path / "w" / "witness.json", installed)
        payload = json.loads(out.read_text())
        assert payload["version"] == 1
        assert not (tmp_path / "w" / "witness.json.tmp").exists()
        assert any(s["acquires"] >= 1 for s in payload["sites"])

    @pytest.mark.parametrize("flag", ["", "1"])
    def test_the_server_installs_from_the_environment(self, flag, monkeypatch):
        """``NM03_LOCKDEP=1``: installed before any serving object exists;
        unset: nothing patched."""
        from nm03_capstone_project_tpu_torch.serving import server

        seen = {}

        def fake_serve(args, argv):
            seen["active"] = lockdep.active()
            seen["lock"] = threading.Lock
            return 0

        monkeypatch.setenv("NM03_LOCKDEP", flag)
        monkeypatch.delenv("NM03_LOCKDEP_WITNESS", raising=False)
        monkeypatch.setattr(server, "_serve", fake_serve)
        orig = threading.Lock
        try:
            assert server.main(["--device", "cpu"]) == 0
        finally:
            lockdep.uninstall()
        assert seen["active"] is bool(flag)
        assert (seen["lock"] is orig) is not bool(flag)


class TestAbbaBattery:
    def test_inversion_names_both_stacks(self, installed):
        a = threading.Lock()
        b = threading.Lock()

        def forward_path():
            with a:
                with b:
                    pass

        def backward_path():
            with b:
                with a:
                    pass

        for fn in (forward_path, backward_path):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
        snap = installed.snapshot()
        assert len(snap["inversions"]) == 1
        inv = snap["inversions"][0]
        assert any("backward_path" in fr for fr in inv["stack"]), inv
        assert any("forward_path" in fr for fr in inv["prior_stack"]), inv

    def test_the_gate_refuses_the_abba_witness(self, installed, static_graph):
        a = threading.Lock()
        b = threading.Lock()

        def nested(first, second):
            with first:
                with second:
                    pass

        for order in ((a, b), (b, a)):
            t = threading.Thread(target=nested, args=order)
            t.start()
            t.join()
        problems = explain_witness(installed.snapshot(), static_graph)
        assert any("inversion" in p for p in problems)
        assert any("cycle" in p for p in problems)

    def test_consistent_order_gates_clean(self, installed, static_graph):
        a = threading.Lock()
        b = threading.Lock()
        for _ in range(3):
            with a:
                with b:
                    pass
        assert explain_witness(installed.snapshot(), static_graph) == []


class TestServingDrill:
    """Four lanes and the volume gang on the CPU, built inside the window."""

    @pytest.fixture(scope="class")
    def drill_witness(self, tmp_path_factory):
        from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume

        st = lockdep.install()
        try:
            from nm03_capstone_project_tpu_torch.config import PipelineConfig
            from nm03_capstone_project_tpu_torch.obs import flightrec
            from nm03_capstone_project_tpu_torch.serving.loadgen import (
                LoadResult,
                _make_payloads,
                run_load,
            )
            from nm03_capstone_project_tpu_torch.serving.server import (
                ServingApp,
                serve_in_thread,
            )

            flightrec.configure(dump_dir=str(tmp_path_factory.mktemp("flight")))
            app = ServingApp(cfg=PipelineConfig(canvas=64, min_dim=16), buckets=(1, 2),
                             device="cpu", lane_devices=["cpu"] * 4, max_wait_s=0.005,
                             volume_serving=True, volume_depth_buckets=(8,),
                             result_cache_bytes=1 << 30)
            httpd, _, port = serve_in_thread(app)
            base = f"http://127.0.0.1:{port}"
            vol = np.asarray(phantom_volume(6, 64, 64, seed=9), np.float32)
            result = {}

            def volume_worker():
                req = urllib.request.Request(
                    base + "/v1/segment-volume?output=summary",
                    data=vol.astype("<f4").tobytes(),
                    headers={"Content-Type": "application/octet-stream",
                             "X-Nm03-Depth": "6", "X-Nm03-Height": "64",
                             "X-Nm03-Width": "64"},
                    method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    result["status"] = r.status
                    result["z_shards"] = json.loads(r.read())["z_shards"]

            vt = threading.Thread(target=volume_worker)
            vt.start()
            summary = run_load(base + "/v1/segment?output=mask",
                               _make_payloads(64, 64, n_distinct=2, dicom=False),
                               n_requests=8, concurrency=4, rate_rps=0.0, timeout_s=120.0,
                               result=LoadResult())
            vt.join(timeout=120)
            app.begin_drain(reason="lockdep-drill")
            httpd.shutdown()
            httpd.server_close()
            app.close()
            out = tmp_path_factory.mktemp("w") / "lockdep_witness.json"
            lockdep.dump_witness(out, st)
        finally:
            lockdep.uninstall()
        assert result == {"status": 200, "z_shards": 4}
        assert summary["requests_ok"] == 8, summary["statuses"]
        return out

    def test_witness_covers_the_serving_locks(self, drill_witness):
        payload = json.loads(drill_witness.read_text())
        paths = {s["path"] for s in payload["sites"]}
        assert {f"{PORT}/serving/batcher.py", f"{PORT}/serving/executor.py",
                f"{PORT}/serving/volumes.py"} <= paths
        assert payload["edges"] and payload["inversions"] == []

    def test_witness_gates_clean_against_the_static_graph(self, drill_witness):
        problems = gate.check_witness(json.loads(drill_witness.read_text()))
        assert problems == [], "\n".join(problems)

    def test_the_gate_subprocess_passes_the_witness(self, drill_witness):
        proc = subprocess.run(
            [sys.executable, "-m", f"{PORT}.analysis.gate", "--skip-ruff",
             "--lockdep-witness", str(drill_witness)],
            capture_output=True, text=True, cwd=REPO, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "lockdep: witness OK" in proc.stdout and "0 inversions, 0 cycles" in proc.stdout

    def test_an_inverted_witness_fails_the_gate(self, drill_witness, tmp_path):
        witness = json.loads(drill_witness.read_text())
        e = dict(witness["edges"][0])
        witness["edges"].append({"src": e["dst"], "dst": e["src"], "count": 1,
                                 "stack": ["fabricated:1 in drill"]})
        bad = tmp_path / "bad_witness.json"
        bad.write_text(json.dumps(witness))
        assert any("cycle" in p for p in gate.check_witness(witness))
        proc = subprocess.run(
            [sys.executable, "-m", f"{PORT}.analysis.gate", "--skip-ruff",
             "--lockdep-witness", str(bad)],
            capture_output=True, text=True, cwd=REPO, timeout=300,
            env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert proc.returncode != 0 and "gate: FAIL" in proc.stdout
