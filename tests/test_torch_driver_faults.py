"""The port's batch drivers under fault plans, held against the JAX package's.

One synthetic DICOM cohort (2 patients x 10 slices at 128 x 120, written by
the JAX package's writer) goes through the JAX drivers with
``--no-fallback-cpu --fault-plan P`` and through the port's with
``--device cpu --fault-plan P``, sequential and parallel. The same plan
must fail, retry and export the same slices: equal summaries, equal
``resilience_retries_total`` and ``resilience_faults_injected_total`` in the
results JSON, byte-identical JPEG pairs and manifests for what was
exported. The ``ingest`` site's ``decode_error`` is contained and counted;
an ``export``/``sigterm`` drill killed mid-run and finished with
``--resume`` ends byte-identical to a clean run. Then what only the port
does: a dispatch that outlives ``--dispatch-timeout-s`` fails its slices,
counted, and nothing is recomputed on the CPU.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402,F401
import torch  # noqa: E402

from nm03_capstone_project_tpu.cli import parallel as jax_parallel  # noqa: E402
from nm03_capstone_project_tpu.cli import sequential as jax_sequential  # noqa: E402
from nm03_capstone_project_tpu.data.synthetic import (  # noqa: E402
    write_synthetic_cohort as jax_write_cohort,
)
from nm03_capstone_project_tpu_torch.cli import parallel, sequential  # noqa: E402

DRIVERS = {"sequential": (jax_sequential, sequential), "parallel": (jax_parallel, parallel)}
# batches of 8: the JAX parallel driver rounds its batch to its mesh (8
# host CPU devices under the test settings), so both cut the same batches
FLAGS = {"sequential": ["--canvas", "128"],
         "parallel": ["--canvas", "128", "--batch-size", "8", "--io-workers", "2"]}

# every site the batch drivers fire, with stem, patient and index selectors
PLAN = {"seed": 3, "faults": [
    {"site": "decode", "kind": "error", "patient": "PGBM-0001", "stem": "1-02"},
    {"site": "decode", "kind": "corrupt", "stem": "1-05"},
    {"site": "dispatch", "kind": "transient", "count": 2},
    {"site": "export", "kind": "io_error", "stem": "1-03", "count": 5},
    {"site": "ingest", "kind": "decode_error", "index": 1, "patient": "PGBM-0002"},
]}
# the retry budget spent, a rate rule, and a stall the ring absorbs
PLAN_RATES = {"seed": 8, "faults": [
    {"site": "dispatch", "kind": "transient", "rate": 0.5, "count": 2},
    {"site": "export", "kind": "io_error", "patient": "PGBM-0002", "rate": 0.6},
    {"site": "ingest", "kind": "stall", "index": 0, "hang_s": 0.2},
]}
# the failed and retried counts the drill plan gives on the CPU (the
# operate phase of chip_smoke.py holds the card's run to the same plan)
PINNED = {
    ("parallel", "plan"): {"slices_ok": 14, "retries": {"dispatch": 2, "export": 4}},
    ("sequential", "plan"): {"slices_ok": 15, "retries": {"dispatch": 2, "export": 4}},
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _no_env_plan(monkeypatch):
    monkeypatch.delenv("NM03_FAULT_PLAN", raising=False)
    monkeypatch.setenv("NM03_NO_NATIVE", "0")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    jax_write_cohort(root, n_patients=2, n_slices=10, height=128, width=120)
    return root


def tree(root) -> dict:
    """``{relative path: bytes}`` of the JPEG pairs and the manifest."""
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.suffix == ".jpg" or p.name == "manifest.json"}


def counters(results: dict) -> dict:
    """The resilience counters of a results JSON's metrics snapshot."""
    out = {}
    for m in results["metrics"]["metrics"]:
        if m["name"] in ("resilience_retries_total", "resilience_faults_injected_total"):
            out[(m["name"], tuple(sorted(m["labels"].items())))] = m["value"]
    return out


def run(module, cohort, out, *extra, jax_side=False):
    results = out.parent / (out.name + ".json")
    mode = module.__name__.rsplit(".", 1)[-1]
    argv = ["--base-path", str(cohort), "--output", str(out), "--device", "cpu",
            "--results-json", str(results), *FLAGS[mode], *extra]
    if jax_side:
        argv.append("--no-fallback-cpu")
    assert module.main(argv) == 0
    return json.loads(results.read_text())


@pytest.mark.parametrize("mode", ["sequential", "parallel"])
@pytest.mark.parametrize("name,plan", [pytest.param("plan", PLAN, id="plan"),
                                       pytest.param("rates", PLAN_RATES, id="rates")])
def test_same_plan_same_fires_same_pairs(mode, name, plan, cohort, tmp_path):
    jax_mod, port_mod = DRIVERS[mode]
    spec = json.dumps(plan)
    want = run(jax_mod, cohort, tmp_path / "jax", "--fault-plan", spec, jax_side=True)
    got = run(port_mod, cohort, tmp_path / "port", "--fault-plan", spec)
    assert got["summary"] == want["summary"]
    assert counters(got) == counters(want)
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    assert got["backend_degraded"] is False and want["backend_degraded"] is False
    summary = got["summary"]
    assert summary["slices_total"] == 20 and summary["slices_ok"] < 20
    if (mode, name) in PINNED:
        pin = PINNED[(mode, name)]
        retries = {dict(k[1])["cause"]: v for k, v in counters(got).items()
                   if k[0] == "resilience_retries_total"}
        assert summary["slices_ok"] == pin["slices_ok"] and retries == pin["retries"]
        faults = {(dict(k[1])["site"], dict(k[1])["kind"]): v for k, v in counters(got).items()
                  if k[0] == "resilience_faults_injected_total"}
        # the ingest decode_error is contained (the run finished) and counted
        assert faults[("ingest", "decode_error")] == 1
        assert faults[("dispatch", "transient")] == 2


def test_environment_plan_reaches_the_drivers(cohort, tmp_path, monkeypatch):
    monkeypatch.setenv("NM03_FAULT_PLAN", json.dumps(
        {"faults": [{"site": "decode", "kind": "error", "stem": "1-01"}]}))
    got = run(parallel, cohort, tmp_path / "env")
    assert got["summary"]["slices_ok"] == 18
    assert counters(got)[("resilience_faults_injected_total",
                          (("kind", "error"), ("site", "decode")))] == 2


def _subprocess_driver(mode, cohort, out, *extra):
    env = dict(os.environ, OMP_NUM_THREADS="1", NM03_NO_NATIVE="0")
    env.pop("NM03_FAULT_PLAN", None)
    return subprocess.run(
        [sys.executable, "-m", f"nm03_capstone_project_tpu_torch.cli.{mode}",
         "--base-path", str(cohort), "--output", str(out), "--device", "cpu", *FLAGS[mode],
         *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("mode", ["sequential", "parallel"])
def test_sigterm_then_resume_ends_byte_identical(mode, cohort, tmp_path):
    jax_mod, port_mod = DRIVERS[mode]
    clean = tmp_path / "clean"
    run(jax_mod, cohort, clean, jax_side=True)
    drill = tmp_path / "drill"
    plan = json.dumps({"faults": [{"site": "export", "kind": "sigterm", "after": 5}]})
    killed = _subprocess_driver(mode, cohort, drill, "--fault-plan", plan)
    assert killed.returncode == -signal.SIGTERM, killed.stdout + killed.stderr
    partial = tree(drill)
    assert 0 < len([k for k in partial if k.endswith(".jpg")]) < 40
    resumed = run(port_mod, cohort, drill, "--resume")
    assert resumed["summary"]["slices_ok"] == 20
    assert tree(drill) == tree(clean)


@pytest.mark.parametrize("mode", ["sequential", "parallel"])
def test_a_dispatch_past_its_deadline_fails_its_slices(mode, cohort, tmp_path):
    _, port_mod = DRIVERS[mode]
    plan = json.dumps({"faults": [
        {"site": "dispatch", "kind": "hang", "patient": "PGBM-0002", "index": 0,
         "hang_s": 20.0}]})
    got = run(port_mod, cohort, tmp_path / "hang", "--fault-plan", plan,
              "--dispatch-timeout-s", "1.0", "--retry-max", "0")
    lost = 1 if mode == "sequential" else 8  # slice 0, or batch 0 (8 slices)
    per = got["summary"]["per_patient"]
    assert per["PGBM-0001"] == {"ok": 10, "total": 10, "truncated": 0}
    assert per["PGBM-0002"]["ok"] == 10 - lost
    assert got["summary"]["patients_ok"] == 2  # contained: the patient finished
    failed = [k for k, v in json.loads((tmp_path / "hang" / "manifest.json").read_text())
              ["PGBM-0002"].items() if v == "failed"]
    assert len(failed) == lost
    assert got["backend_degraded"] is False


def test_the_card_drill_plan_gives_the_pinned_counts(tmp_path):
    # chip_smoke.py's driver drill runs DRIVER_DRILL_PLAN over its 20 x 25
    # cohort on the card and requires DRIVER_DRILL_COUNTS: the counts depend
    # on patients, stems and batches only, so a cohort of the same names at
    # a small size gives them on the CPU
    import chip_smoke
    from nm03_capstone_project_tpu_torch.data.synthetic import write_synthetic_cohort

    n_pat, n_sl, _ = chip_smoke.DRIVER_COHORT
    root = tmp_path / "cohort"
    write_synthetic_cohort(root, n_patients=n_pat, n_slices=n_sl, height=32, width=32)
    out, results = tmp_path / "drill", tmp_path / "drill.json"
    assert parallel.main(["--base-path", str(root), "--output", str(out), "--device", "cpu",
                          "--canvas", "32", "--min-dim", "16", "--render-size", "32",
                          "--results-json", str(results),
                          "--fault-plan", json.dumps(chip_smoke.DRIVER_DRILL_PLAN)]) == 0
    rec = json.loads(results.read_text())
    counts = {"slices_ok": rec["summary"]["slices_ok"], "retries": {}, "faults": {}}
    for (name, labels), value in counters(rec).items():
        labels = dict(labels)
        if name == "resilience_retries_total":
            counts["retries"][labels["cause"]] = value
        else:
            counts["faults"][f"{labels['site']}/{labels['kind']}"] = value
    assert counts == chip_smoke.DRIVER_DRILL_COUNTS
    assert rec["summary"]["slices_total"] == n_pat * n_sl
    assert len(list(out.rglob("*.jpg"))) == 2 * counts["slices_ok"]
