"""The port's batch drivers held against the JAX package's, on the CPU.

One synthetic DICOM cohort (2 patients x 4 slices at 128 x 120, written once
per module by the JAX package's writer) goes through the JAX package's
``nm03-sequential`` on the CPU and through the port's ``nm03-sequential``
and ``nm03-parallel`` with ``--device cpu``. The trees of file names, the
JPEG pairs byte for byte, ``manifest.json`` and the summaries must be
identical, with host and with device render. The JAX side runs with its
defaults (``use_pallas=False``: its plain XLA path). Both packages encode
with PIL here, in the same preference order.

Also the drivers' containment (a corrupt ``.dcm``, the undersized-slice
guard, an empty patient), ``--resume``, and the per-slice journal. The
journal's lines come in export order, which threads make run-dependent, so
it is compared as a set. No test depends on which items the ingest pipeline
yields before a stage raises.

Pins ``nm03_capstone_project_tpu_torch/testdata/driver_golden.json``, the
golden ``chip_smoke.py`` holds the card's driver run against: the first 50
slices of its 20 x 25 DICOM cohort at 256, masks and host renders hashed,
recomputed here with the JAX package. Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_driver.py --write
"""

import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import torch  # noqa: E402

from nm03_capstone_project_tpu.cli import sequential as jax_sequential  # noqa: E402
from nm03_capstone_project_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from nm03_capstone_project_tpu.core import pad_to_canvas as jax_pad  # noqa: E402
from nm03_capstone_project_tpu.data.dicomlite import read_dicom as jax_read_dicom  # noqa: E402
from nm03_capstone_project_tpu.data.synthetic import (  # noqa: E402
    write_synthetic_cohort as jax_write_cohort,
)
from nm03_capstone_project_tpu.pipeline import process_batch as jax_process_batch  # noqa: E402
from nm03_capstone_project_tpu.render.host_render import (  # noqa: E402
    host_render_pair as jax_host_render_pair,
)
from nm03_capstone_project_tpu_torch.cli import parallel, sequential  # noqa: E402
from nm03_capstone_project_tpu_torch.cli.runner import CohortProcessor  # noqa: E402
from nm03_capstone_project_tpu_torch.config import BatchConfig, PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.data.synthetic import write_synthetic_cohort  # noqa: E402
from nm03_capstone_project_tpu_torch.resilience.journal import PatientJournal  # noqa: E402

GOLDEN = (
    pathlib.Path(__file__).resolve().parents[1]
    / "nm03_capstone_project_tpu_torch" / "testdata" / "driver_golden.json"
)
GOLDEN_PATIENTS, GOLDEN_SLICES, GOLDEN_SIZE = 2, 25, 256
CFG = PipelineConfig(canvas=128)
BCFG = BatchConfig(batch_size=3, io_workers=2)
SIZE_FLAGS = ["--canvas", "128"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    # --no-native sets NM03_NO_NATIVE=1 for the process; monkeypatch puts
    # back the variable's state from before the test
    monkeypatch.setenv("NM03_NO_NATIVE", "0")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    jax_write_cohort(root, n_patients=2, n_slices=4, height=128, width=120)
    return root


def tree(root) -> dict:
    """``{relative path: bytes}`` of the JPEG pairs and the manifest, and
    each patient's journal as a set of lines."""
    root = pathlib.Path(root)
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        if p.suffix == ".jpg" or p.name == "manifest.json":
            out[rel] = p.read_bytes()
        elif p.name == "slices.journal":
            out[rel] = frozenset(p.read_text().splitlines())
    return out


def run_jax(cohort, out, *extra):
    results = out.parent / (out.name + ".json")
    rc = jax_sequential.main(
        ["--base-path", str(cohort), "--output", str(out), "--device", "cpu",
         "--results-json", str(results), *SIZE_FLAGS, *extra]
    )
    assert rc == 0
    return json.loads(results.read_text())


def run_port(driver, cohort, out, *extra):
    results = out.parent / (out.name + ".json")
    rc = driver.main(
        ["--base-path", str(cohort), "--output", str(out), "--device", "cpu",
         "--results-json", str(results), *SIZE_FLAGS, *extra]
    )
    assert rc == 0
    return json.loads(results.read_text())


@pytest.fixture(scope="module")
def jax_runs(cohort, tmp_path_factory):
    """The JAX sequential driver's output, host and device render."""
    root = tmp_path_factory.mktemp("jax")
    runs = {}
    for stage in ("host", "device"):
        out = root / stage
        rec = run_jax(cohort, out, "--render-stage", stage)
        runs[stage] = (tree(out), rec["summary"])
    return runs


class TestAgainstJax:
    @pytest.mark.parametrize("stage", ["host", "device"])
    @pytest.mark.parametrize("driver", [sequential, parallel], ids=["sequential", "parallel"])
    def test_tree_byte_identical(self, jax_runs, cohort, tmp_path, driver, stage):
        want_tree, want_summary = jax_runs[stage]
        extra = ["--render-stage", stage]
        if driver is parallel:
            extra += ["--batch-size", "3", "--io-workers", "2"]
        rec = run_port(driver, cohort, tmp_path / "out", *extra)
        got = tree(tmp_path / "out")
        assert sorted(got) == sorted(want_tree)
        assert len([k for k in got if k.endswith(".jpg")]) == 16
        for name in want_tree:
            assert got[name] == want_tree[name], name
        assert rec["summary"] == want_summary
        assert rec["summary"]["slices_ok"] == 8
        assert rec["backend"] == "cpu" and rec["backend_degraded"] is False
        assert rec["jpeg_encoder"] == "PIL"
        assert rec["kernel_launches"] == {"fused": 0, "grow": 0, "median": 0,
                                          "median_select": 0, "grow_global": 0}
        assert rec["ingest"]["counts"]["yielded"] > 0

    def test_python_decode_path_is_identical(self, jax_runs, cohort, tmp_path):
        # --no-native: the pure-Python decoder and renderer, same bytes
        run_port(parallel, cohort, tmp_path / "out", "--no-native", "--batch-size", "3")
        assert tree(tmp_path / "out") == jax_runs["host"][0]


class TestContainment:
    def test_corrupt_slice_contained(self, tmp_path):
        root = tmp_path / "cohort"
        write_synthetic_cohort(root, n_patients=1, n_slices=3, height=128, width=128)
        series = next((root / "PGBM-0001").iterdir())
        (series / "1-02.dcm").write_bytes(b"\x00" * 200)  # corrupt
        for mode in ("parallel", "sequential"):
            proc = CohortProcessor(root, tmp_path / mode, cfg=CFG, batch_cfg=BCFG,
                                   mode=mode, device="cpu")
            summary = proc.process_all_patients()
            assert summary.patients_ok == 1  # the patient still succeeds overall
            p = summary.patients[0]
            assert p.total == 3 and p.succeeded == 2
            assert p.failed_slices == ["1-02"]
            manifest = json.loads((tmp_path / mode / "manifest.json").read_text())
            assert manifest == {"PGBM-0001": {"1-01": "done", "1-02": "failed",
                                              "1-03": "done"}}
            assert len(list((tmp_path / mode).rglob("*.jpg"))) == 4

    @pytest.mark.parametrize("mode", ["sequential", "parallel"])
    def test_undersized_slice_guard(self, tmp_path, mode):
        root = tmp_path / "c"
        write_synthetic_cohort(root, n_patients=1, n_slices=2, height=64, width=128)
        proc = CohortProcessor(root, tmp_path / "o", cfg=CFG, batch_cfg=BCFG, mode=mode,
                               device="cpu")
        summary = proc.process_all_patients()
        # 64 < min_dim 100: every slice fails the reference's dimension guard
        assert summary.succeeded_slices == 0
        assert summary.patients[0].total == 2
        assert sorted(summary.patients[0].failed_slices) == ["1-01", "1-02"]

    def test_missing_series_dir_is_patient_failure(self, tmp_path):
        root = tmp_path / "c"
        write_synthetic_cohort(root, n_patients=1, n_slices=2, height=128, width=128)
        (root / "PGBM-0002").mkdir()  # a patient with no series
        proc = CohortProcessor(root, tmp_path / "o", cfg=CFG, mode="sequential",
                               device="cpu")
        summary = proc.process_all_patients()
        assert summary.patients_ok == 1
        assert len(summary.patients) == 2
        assert summary.patients[1].patient_id == "PGBM-0002"
        assert summary.patients[1].total == 0


class TestResume:
    @pytest.mark.parametrize("mode", ["sequential", "parallel"])
    def test_resume_skips_done(self, cohort, tmp_path, mode):
        out = tmp_path / "res"
        CohortProcessor(cohort, out, cfg=CFG, batch_cfg=BCFG, mode=mode,
                        device="cpu").process_all_patients()
        stamp = {p: p.stat().st_mtime_ns for p in out.rglob("*.jpg")}
        seen = []
        proc = CohortProcessor(cohort, out, cfg=CFG, batch_cfg=BCFG, mode=mode, resume=True,
                               device="cpu", mask_sink=lambda *a: seen.append(a[1]))
        summary = proc.process_all_patients()
        assert summary.succeeded_slices == 8  # counted as done
        assert seen == []  # nothing recomputed
        assert proc.ingest_report()["counts"]["yielded"] == 0
        for p in out.rglob("*.jpg"):
            assert p.stat().st_mtime_ns == stamp[p]  # nothing rewritten

    def test_resume_redoes_a_truncated_slice(self, cohort, tmp_path):
        # a cap of 2 steps truncates the growing lesions: those slices are
        # "truncated", not "done", and a rerun with the default cap redoes
        # exactly them
        out = tmp_path / "res"
        capped = PipelineConfig(canvas=128, grow_block_iters=2, grow_max_iters=2)
        first = CohortProcessor(cohort, out, cfg=capped, batch_cfg=BCFG, mode="parallel",
                                device="cpu").process_all_patients()
        truncated = {(p.patient_id, s) for p in first.patients for s in p.truncated_slices}
        assert truncated and first.truncated_slices == len(truncated)
        manifest = json.loads((out / "manifest.json").read_text())
        assert {(p, s) for p, d in manifest.items() for s, v in d.items()
                if v == "truncated"} == truncated
        redone = []
        second = CohortProcessor(
            cohort, out, cfg=CFG, batch_cfg=BCFG, mode="parallel", resume=True,
            device="cpu", mask_sink=lambda pid, stem, m: redone.append((pid, stem)),
        ).process_all_patients()
        assert set(redone) == truncated
        assert second.succeeded_slices == 8 and second.truncated_slices == 0
        manifest = json.loads((out / "manifest.json").read_text())
        assert {v for d in manifest.values() for v in d.values()} == {"done"}

    def test_journal_folds_into_resume(self, cohort, tmp_path):
        # a run killed after the pairs hit disk but before the manifest
        # flush: the journal alone says which slices are done
        out = tmp_path / "res"
        CohortProcessor(cohort, out, cfg=CFG, mode="sequential",
                        device="cpu").process_all_patients()
        (out / "manifest.json").unlink()
        entries = PatientJournal(out / "PGBM-0001").entries()
        assert entries == {f"1-0{i}": "done" for i in range(1, 5)}
        redone = []
        summary = CohortProcessor(
            cohort, out, cfg=CFG, mode="sequential", resume=True, device="cpu",
            mask_sink=lambda pid, stem, m: redone.append(pid),
        ).process_all_patients()
        assert summary.succeeded_slices == 8
        assert redone == []


def golden_records(patient, stems, px, dims, masks, conv, cfg, render):
    """One record per slice: sha256 of the uint8 canvas mask and of its two
    host renders (C order), mask area, converged."""
    out = []
    for i, stem in enumerate(stems):
        gray, seg = render(px[i], masks[i], dims[i], cfg)
        out.append({
            "patient": patient,
            "stem": stem,
            "dims": [int(dims[i, 0]), int(dims[i, 1])],
            "mask_sha256": hashlib.sha256(np.ascontiguousarray(masks[i]).tobytes()).hexdigest(),
            "area": int(masks[i].sum()),
            "converged": bool(conv[i]),
            "gray_sha256": hashlib.sha256(np.ascontiguousarray(gray).tobytes()).hexdigest(),
            "seg_sha256": hashlib.sha256(np.ascontiguousarray(seg).tobytes()).hexdigest(),
        })
    return out


def jax_golden(root) -> dict:
    """The golden recomputed with the JAX package: its writer, its reader,
    its ``process_batch`` (a batch of 25 a patient) and its host renderer."""
    jax_write_cohort(root, n_patients=GOLDEN_PATIENTS, n_slices=GOLDEN_SLICES,
                     height=GOLDEN_SIZE, width=GOLDEN_SIZE)
    jcfg = JaxConfig(canvas=GOLDEN_SIZE)
    run = jax.jit(lambda p, d: jax_process_batch(p, d, jcfg))
    records = []
    for p in range(GOLDEN_PATIENTS):
        pid = f"PGBM-{p + 1:04d}"
        files = sorted(next((root / pid).iterdir()).glob("*.dcm"))
        b = jax_pad([jax_read_dicom(f).pixels for f in files], (GOLDEN_SIZE, GOLDEN_SIZE))
        out = run(b.pixels, b.dims)
        records += golden_records(
            pid, [f.stem for f in files], np.asarray(b.pixels), np.asarray(b.dims),
            np.asarray(out["mask"]), np.asarray(out["grow_converged"]), jcfg,
            jax_host_render_pair,
        )
    return {
        "what": "masks and host renders (gray, seg) of the first 50 slices of "
                "write_synthetic_cohort(n_patients=20, n_slices=25, 256 x 256), the "
                "chip_smoke driver cohort, made by the JAX package on the CPU",
        "canvas": GOLDEN_SIZE,
        "slices": records,
    }


class TestDriverGolden:
    def test_golden_is_current(self, tmp_path):
        assert json.loads(GOLDEN.read_text()) == jax_golden(tmp_path / "cohort")

    def test_port_driver_matches_golden(self, tmp_path):
        from nm03_capstone_project_tpu_torch.render.host_render import host_render_pair

        golden = json.loads(GOLDEN.read_text())
        root = tmp_path / "cohort"
        write_synthetic_cohort(root, n_patients=GOLDEN_PATIENTS, n_slices=GOLDEN_SLICES,
                               height=GOLDEN_SIZE, width=GOLDEN_SIZE)
        masks = {}
        cfg = PipelineConfig(canvas=GOLDEN_SIZE)
        proc = CohortProcessor(root, tmp_path / "out", cfg=cfg, mode="parallel", device="cpu",
                               mask_sink=lambda pid, stem, m: masks.__setitem__((pid, stem),
                                                                                m.copy()))
        summary = proc.process_all_patients()
        assert summary.succeeded_slices == GOLDEN_PATIENTS * GOLDEN_SLICES
        manifest = json.loads((tmp_path / "out" / "manifest.json").read_text())
        from nm03_capstone_project_tpu_torch.data.dicomlite import read_dicom

        for g in golden["slices"]:
            f = next((root / g["patient"]).iterdir()) / f"{g['stem']}.dcm"
            a = read_dicom(f).pixels
            px = np.zeros((GOLDEN_SIZE, GOLDEN_SIZE), np.float32)
            px[: a.shape[0], : a.shape[1]] = a
            dims = np.asarray(a.shape, np.int32)
            m = masks[(g["patient"], g["stem"])]
            converged = manifest[g["patient"]][g["stem"]] == "done"
            got = golden_records(g["patient"], [g["stem"]], px[None], dims[None], m[None],
                                 [converged], cfg, host_render_pair)[0]
            assert got == g


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_driver.py --write")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        GOLDEN.write_text(json.dumps(jax_golden(pathlib.Path(tmp)), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
