"""The port's driver telemetry, held against the JAX drivers'.

One synthetic DICOM cohort (written by the JAX package's writer: three
patients at 128 x 120, one with a corrupt slice) goes through the JAX
drivers and the port's drivers with ``--log-json``, ``--metrics-out`` and
``--results-json``: sequential, parallel and volume, with the default
region-growing cap and with a cap low enough to truncate. Per patient,
the event stream must carry the same events in the same order with the
same fields (the run envelope — run id, git SHA, sequence number, times —
aside), the terminal ``patient_outcome`` records must be equal, and both
packages' outputs must pass ``scripts/check_telemetry.py
--expect-patients 3``. The batch drivers' results JSON carries
``feed_stall`` with a ratio in [0, 1], as the JAX drivers' does, and the
final metrics snapshot carries the ``ingest_*`` gauges. Every comparison
is exact.
"""

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402,F401
import torch  # noqa: E402

from nm03_capstone_project_tpu.cli import parallel as jax_parallel  # noqa: E402
from nm03_capstone_project_tpu.cli import sequential as jax_sequential  # noqa: E402
from nm03_capstone_project_tpu.cli import volume as jax_volume  # noqa: E402
from nm03_capstone_project_tpu.data.synthetic import (  # noqa: E402
    write_synthetic_cohort as jax_write_cohort,
)
from nm03_capstone_project_tpu_torch.cli import parallel, sequential, volume  # noqa: E402

CHECKER = REPO / "scripts" / "check_telemetry.py"
DRIVERS = {"sequential": (jax_sequential, sequential), "parallel": (jax_parallel, parallel),
           "volume": (jax_volume, volume)}
# batches of 8: the JAX parallel driver rounds its batch to its mesh (8 host
# CPU devices under the test settings), so both cut the same batches
FLAGS = {"sequential": ["--canvas", "128"],
         "parallel": ["--canvas", "128", "--batch-size", "8", "--io-workers", "2"],
         "volume": ["--canvas", "128"]}
CAPS = {"default": [], "truncating": ["--grow-block-iters", "1", "--grow-max-iters", "2"]}
# the run envelope, which differs by construction between two runs
ENVELOPE = {"schema", "run_id", "git_sha", "seq", "ts_unix", "mono_s"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.setenv("NM03_NO_NATIVE", "0")
    monkeypatch.delenv("NM03_FAULT_PLAN", raising=False)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    jax_write_cohort(root, n_patients=3, n_slices=5, height=128, width=120)
    # one unreadable slice: a failed slice in the 2D drivers' outcome
    bad = sorted((root / "PGBM-0002").rglob("*.dcm"))[1]
    bad.write_bytes(b"not a dicom file")
    return root


def run(module, cohort, out, mode, *extra, jax_side=False):
    paths = {k: out.parent / f"{out.name}.{k}" for k in ("results", "metrics", "events")}
    argv = ["--base-path", str(cohort), "--output", str(out), "--device", "cpu",
            "--results-json", str(paths["results"]), "--metrics-out", str(paths["metrics"]),
            "--log-json", str(paths["events"]), "--heartbeat-s", "0", *FLAGS[mode], *extra]
    if jax_side and mode != "volume":
        argv.append("--no-fallback-cpu")
    rc = module.main(argv)
    events = [json.loads(line) for line in paths["events"].read_text().splitlines()]
    return rc, json.loads(paths["results"].read_text()), events, paths


def per_patient(events) -> dict:
    """``{patient: [event without its envelope, ...]}`` in stream order."""
    out = {}
    for e in events:
        if "patient_id" in e:
            out.setdefault(e["patient_id"], []).append(
                {k: v for k, v in e.items() if k not in ENVELOPE})
    return out


def check(paths, n_patients):
    return subprocess.run(
        [sys.executable, str(CHECKER), "--events", str(paths["events"]),
         "--metrics", str(paths["metrics"]), "--expect-patients", str(n_patients)],
        capture_output=True, text=True, timeout=60)


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("mode", list(DRIVERS))
def test_same_events_per_patient_and_both_pass_the_checker(mode, cap, cohort, tmp_path):
    jax_mod, port_mod = DRIVERS[mode]
    want_rc, want, want_events, want_paths = run(jax_mod, cohort, tmp_path / "jax", mode,
                                                 *CAPS[cap], jax_side=True)
    got_rc, got, got_events, got_paths = run(port_mod, cohort, tmp_path / "port", mode,
                                             *CAPS[cap])
    assert got_rc == want_rc
    assert per_patient(got_events) == per_patient(want_events)
    outcomes = [e for e in got_events if e["event"] == "patient_outcome"]
    assert sorted(e["patient_id"] for e in outcomes) == ["PGBM-0001", "PGBM-0002", "PGBM-0003"]
    if cap == "truncating":
        assert any(e["event"] == "grow_truncated" for e in got_events)
    for paths in (want_paths, got_paths):
        res = check(paths, 3)
        assert res.returncode == 0, res.stdout + res.stderr
    assert got_events[0]["event"] == "run_started" and got_events[-1]["event"] == "run_finished"
    assert got_events[-1]["status"] == want_events[-1]["status"]
    if mode != "volume":
        for rec in (want, got):
            ratio = rec["feed_stall"]["feed_stall_ratio"]
            assert ratio is not None and 0.0 <= ratio <= 1.0
        assert set(got["feed_stall"]) == set(want["feed_stall"])
        assert set(got["feed_stall"]["busy_s"]) == set(want["feed_stall"]["busy_s"])
        assert [e["event"] for e in got_events if e["event"] in ("feed_stall", "ingest_drained")] \
            == [e["event"] for e in want_events if e["event"] in ("feed_stall", "ingest_drained")]
        gauges = {m["name"] for m in got["metrics"]["metrics"] if m["type"] == "gauge"}
        assert {"pipeline_feed_stall_ratio", "ingest_ring_occupancy_ratio",
                "ingest_decode_queue_depth", "nm03_run_wall_seconds"} <= gauges
    else:
        assert "metrics" in got and got["metrics"]["schema"] == "nm03.metrics.v1"


def test_counters_equal(cohort, tmp_path):
    """The per-patient and per-slice counters of the two snapshots agree."""
    def counters(rec):
        keep = ("nm03_patient_outcomes_total", "nm03_slices_total",
                "pipeline_grow_truncated_total")
        return sorted((m["name"], tuple(sorted(m["labels"].items())), m["value"])
                      for m in rec["metrics"]["metrics"] if m["name"] in keep)

    _, want, _, _ = run(jax_parallel, cohort, tmp_path / "jax", "parallel",
                        *CAPS["truncating"], jax_side=True)
    _, got, _, _ = run(parallel, cohort, tmp_path / "port", "parallel", *CAPS["truncating"])
    assert counters(got) == counters(want) and counters(got)
