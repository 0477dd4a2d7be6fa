"""The port's volume driver held against the JAX package's ``nm03-volume``.

One synthetic DICOM cohort (2 patients x 4 slices at 128 x 120, written once
per module by the JAX package's writer) goes through the JAX package's
volume driver on the CPU (its defaults: ``use_pallas=False``, its XLA path)
and through the port's with ``--device cpu``: the JPEG pairs, the manifest
and ``mask.mhd`` with ``.raw`` or ``.zraw`` must be identical byte for byte,
and so must the results JSON's ``patients`` and
``grow_truncated_patients``, with host and with device render. Also:
``--resume`` (a capped patient recorded ``truncated`` is recomputed with a
raised cap; complete patients are skipped), a multi-frame file expanded to
a z-stack, a corrupt file contained to its stem, a wrecked patient
contained to itself, and ``--z-shard`` on one device. Both packages encode
with PIL here.
"""

import json
import pathlib
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from nm03_capstone_project_tpu.cli import volume as jax_volume_cli  # noqa: E402
from nm03_capstone_project_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from nm03_capstone_project_tpu.data.synthetic import (  # noqa: E402
    write_synthetic_cohort as jax_write_cohort,
)
from nm03_capstone_project_tpu_torch.cli import volume  # noqa: E402
from nm03_capstone_project_tpu_torch.config import PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.data.imageio import read_metaimage  # noqa: E402

MULTIFRAME = pathlib.Path(__file__).parent / "golden" / "dicom" / "gdcm16_multiframe.dcm"
SIZE_FLAGS = ["--canvas", "128"]
VARIANTS = {
    "host_raw": ["--export-mhd"],
    "device_zraw": ["--render-stage", "device", "--export-mhd", "--mhd-compressed"],
    "capped": ["--grow-block-iters", "1", "--grow-max-iters", "2", "--export-mhd"],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.setenv("NM03_NO_NATIVE", "0")


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    root = tmp_path_factory.mktemp("cohort")
    jax_write_cohort(root, n_patients=2, n_slices=4, height=128, width=120)
    return root


def tree(root) -> dict:
    """``{relative path: bytes}`` of the JPEG pairs, the manifest and the
    MetaImage files under ``root``."""
    root = pathlib.Path(root)
    return {
        str(p.relative_to(root)): p.read_bytes()
        for p in sorted(root.rglob("*"))
        if p.suffix in (".jpg", ".mhd", ".raw", ".zraw") or p.name == "manifest.json"
    }


def run(main, base, out, *extra):
    results = out.parent / (out.name + ".json")
    rc = main(["--base-path", str(base), "--output", str(out), "--device", "cpu",
               "--results-json", str(results), *SIZE_FLAGS, *extra])
    return rc, json.loads(results.read_text())


@pytest.fixture(scope="module")
def jax_runs(cohort, tmp_path_factory):
    """The JAX volume driver's output for each variant."""
    root = tmp_path_factory.mktemp("jax")
    runs = {}
    for name, extra in VARIANTS.items():
        rc, rec = run(jax_volume_cli.main, cohort, root / name, *extra)
        assert rc == 0
        runs[name] = (tree(root / name), rec)
    return runs


class TestAgainstJax:
    @pytest.mark.parametrize("variant", list(VARIANTS))
    def test_outputs_byte_identical(self, jax_runs, cohort, tmp_path, variant):
        want_tree, want = jax_runs[variant]
        rc, rec = run(volume.main, cohort, tmp_path / "out", *VARIANTS[variant])
        assert rc == 0
        got = tree(tmp_path / "out")
        assert sorted(got) == sorted(want_tree)
        assert len([k for k in got if k.endswith(".jpg")]) == 16
        assert len([k for k in got if k.endswith("mask.mhd")]) == 2
        for name in want_tree:
            assert got[name] == want_tree[name], name
        assert rec["patients"] == want["patients"]
        assert rec["grow_truncated_patients"] == want["grow_truncated_patients"]
        assert rec["mode"] == "volume" and rec["z_sharded"] is False
        assert rec["backend_requested"] == rec["backend_actual"] == "cpu"
        assert rec["kernel_launches"] == {"fused": 0, "grow": 0, "median": 0,
                                          "median_select": 0, "grow_global": 0}
        # the run's metrics snapshot, as the JAX driver's results JSON carries it
        assert rec["metrics"]["schema"] == want["metrics"]["schema"] == "nm03.metrics.v1"
        assert {k.split("/")[0] for k in rec["timings_s"]} == {"load", "compute", "export"}
        if variant == "capped":
            assert rec["grow_truncated_patients"] == ["PGBM-0001", "PGBM-0002"]
            manifest = json.loads((tmp_path / "out" / "manifest.json").read_text())
            assert {v for d in manifest.values() for v in d.values()} == {"truncated"}

    def test_mask_mhd_is_the_mask(self, jax_runs, cohort, tmp_path):
        run(volume.main, cohort, tmp_path / "out", *VARIANTS["device_zraw"])
        for pid, rec in jax_runs["device_zraw"][1]["patients"].items():
            mask, spacing = read_metaimage(tmp_path / "out" / pid / "mask.mhd")
            assert mask.dtype == np.uint8 and mask.shape == (4, 128, 128)
            assert int(mask.sum()) == rec["mask_voxels"] > 0 and spacing == (1.0, 1.0, 1.0)
            assert mask[:, :, 120:].sum() == 0  # nothing in the canvas padding


class TestResume:
    def test_truncated_patient_recomputed_on_resume(self, cohort, tmp_path, capsys):
        out = tmp_path / "out"
        rc, rec = run(volume.main, cohort, out, *VARIANTS["capped"])
        assert rc == 0 and rec["grow_truncated_patients"] == ["PGBM-0001", "PGBM-0002"]
        assert "hit its iteration cap" in capsys.readouterr().err
        rc, rec = run(volume.main, cohort, out, "--resume", "--export-mhd")
        assert rc == 0 and rec["grow_truncated_patients"] == []
        assert "already complete, skipping" not in capsys.readouterr().out
        manifest = json.loads((out / "manifest.json").read_text())
        assert {v for d in manifest.values() for v in d.values()} == {"done"}
        assert rec["patients"]["PGBM-0001"]["grow_truncated"] is False
        # a third run skips both patients and leaves their files alone
        stamp = {p: p.stat().st_mtime_ns for p in out.rglob("*.jpg")}
        rc, rec = run(volume.main, cohort, out, "--resume")
        assert rc == 0 and rec["patients"] == {}
        assert capsys.readouterr().out.count("already complete, skipping") == 2
        assert all(p.stat().st_mtime_ns == s for p, s in stamp.items())


class TestContainment:
    def test_multiframe_file_expands_to_a_z_stack(self, tmp_path):
        root = tmp_path / "cohort"
        series = root / "PGBM-0001" / "seriesA"
        series.mkdir(parents=True)
        shutil.copy(MULTIFRAME, series / "1-1.dcm")
        vol, dims, stems, skipped = volume._load_volume(
            root, "PGBM-0001", PipelineConfig(canvas=64, min_dim=16))
        jvol, jdims, jstems, jskipped = jax_volume_cli._load_volume(
            root, "PGBM-0001", JaxConfig(canvas=64, min_dim=16))
        assert vol.shape == (3, 64, 64) and list(dims) == [32, 28]
        assert stems == jstems == ["1-1_f000", "1-1_f001", "1-1_f002"]
        assert skipped == jskipped == []
        np.testing.assert_array_equal(vol, jvol)
        np.testing.assert_array_equal(dims, jdims)
        flags = ["--canvas", "64", "--min-dim", "16", "--export-mhd"]
        outs = {}
        for name, main in (("port", volume.main), ("jax", jax_volume_cli.main)):
            rc = main(["--base-path", str(root), "--output", str(tmp_path / name),
                       "--device", "cpu", *flags])
            assert rc == 0
            outs[name] = tree(tmp_path / name)
        assert outs["port"] == outs["jax"]
        assert len([k for k in outs["port"] if k.endswith(".jpg")]) == 6
        assert "PGBM-0001/1-1_f002_original.jpg" in outs["port"]

    def test_corrupt_file_contained(self, tmp_path):
        root = tmp_path / "cohort"
        jax_write_cohort(root, n_patients=1, n_slices=4, height=128, width=128)
        bad = sorted((root / "PGBM-0001").rglob("*.dcm"))[1]
        bad.write_bytes(b"\x00" * 200)
        outs = {}
        for name, main in (("port", volume.main), ("jax", jax_volume_cli.main)):
            rc, rec = run(main, root, tmp_path / name, "--export-mhd")
            assert rc == 0
            outs[name] = (tree(tmp_path / name), rec["patients"])
        assert outs["port"] == outs["jax"]
        manifest = json.loads((tmp_path / "port" / "manifest.json").read_text())
        assert manifest["PGBM-0001"]["1-02"] == "failed"
        assert outs["port"][1]["PGBM-0001"]["slices"] == 3

    def test_wrecked_patient_contained(self, cohort, tmp_path, capsys):
        root = tmp_path / "cohort"
        shutil.copytree(cohort, root)
        for f in (root / "PGBM-0001").rglob("*.dcm"):
            f.write_bytes(b"junk")
        rc, rec = run(volume.main, root, tmp_path / "out")
        assert rc == 1  # the failure is reported...
        assert list(rec["patients"]) == ["PGBM-0002"]  # ...and the run went on
        assert "Patient PGBM-0001 failed: no usable slices" in capsys.readouterr().err

    def test_z_shard_on_one_device_is_ignored(self, cohort, tmp_path, capsys):
        rc, rec = run(volume.main, cohort, tmp_path / "out", "--z-shard")
        assert rc == 0 and rec["z_sharded"] is False
        assert "--z-shard ignored: single device" in capsys.readouterr().err
        assert len(list((tmp_path / "out").rglob("*.jpg"))) == 16
