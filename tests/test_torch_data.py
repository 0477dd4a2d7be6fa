"""The port's data layer and host C++ decoder held against the JAX package's.

Every conformance vector in ``tests/golden/dicom/`` (written by GDCM and
CharLS, not by this repo) goes through both packages' readers: the same
pixels, or the same exception type. JPEG 2000 goes through the GDCM shim
where the host has GDCM's headers. The synthetic cohort writer must give
byte-identical files, so ``--synthetic N`` builds the same cohort in both
packages; the C++ batch decoder must agree with the JAX package's.
"""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from nm03_capstone_project_tpu import native as jax_native  # noqa: E402
from nm03_capstone_project_tpu.data import discovery as jax_discovery  # noqa: E402
from nm03_capstone_project_tpu.data.dicomlite import (  # noqa: E402
    read_dicom as jax_read_dicom,
    read_dicom_frames as jax_read_frames,
)
from nm03_capstone_project_tpu.data.synthetic import (  # noqa: E402
    write_synthetic_cohort as jax_write_cohort,
)
from nm03_capstone_project_tpu_torch import native  # noqa: E402
from nm03_capstone_project_tpu_torch.config import BatchConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.convert import batch_config_from_jax  # noqa: E402
from nm03_capstone_project_tpu_torch.data import discovery  # noqa: E402
from nm03_capstone_project_tpu_torch.data.dicomlite import (  # noqa: E402
    read_dicom,
    read_dicom_frames,
)
from nm03_capstone_project_tpu_torch.data.synthetic import write_synthetic_cohort  # noqa: E402
from nm03_capstone_project_tpu_torch.ingest.staging import stage_batch, wait_staged  # noqa: E402

VECTORS = pathlib.Path(__file__).resolve().parent / "golden" / "dicom"
VECTOR_NAMES = sorted(p.name for p in VECTORS.glob("*.dcm"))


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.setenv("NM03_NO_NATIVE", "0")


def _outcome(read, path):
    try:
        return read(path)
    except Exception as e:  # noqa: BLE001 — the outcome under test
        return e


@pytest.mark.parametrize("name", VECTOR_NAMES)
def test_reader_matches_jax_on_conformance_vectors(name):
    want = _outcome(jax_read_dicom, VECTORS / name)
    got = _outcome(read_dicom, VECTORS / name)
    if isinstance(want, Exception):
        assert type(got).__name__ == type(want).__name__, (got, want)
        return
    assert not isinstance(got, Exception), got
    assert got.pixels.dtype == want.pixels.dtype == np.float32
    np.testing.assert_array_equal(got.pixels, want.pixels)
    assert (got.rows, got.cols) == (want.rows, want.cols)


@pytest.mark.parametrize("name", ["gdcm16_multiframe.dcm", "gdcm16_multiframe_rle.dcm"])
def test_frames_match_jax(name):
    want = jax_read_frames(VECTORS / name)
    got = read_dicom_frames(VECTORS / name)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.pixels, w.pixels)


def test_j2k_goes_through_gdcm_where_it_exists():
    from nm03_capstone_project_tpu_torch.data import gdcm_fallback

    got = _outcome(read_dicom, VECTORS / "gdcm16_j2k.dcm")
    if gdcm_fallback.available():
        assert not isinstance(got, Exception), got
        assert got.pixels.shape == (60, 48) and got.pixels.max() > 0
    else:
        assert type(got).__name__ == "DicomParseError"


def test_synthetic_cohort_byte_identical(tmp_path):
    kw = dict(n_patients=2, n_slices=3, height=101, width=117, seed=4)
    assert write_synthetic_cohort(tmp_path / "port", **kw) == jax_write_cohort(
        tmp_path / "jax", **kw
    )
    port = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*"))
    jax_ = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*"))
    assert port == jax_ and len([p for p in port if p.suffix == ".dcm"]) == 6
    for rel in port:
        a, b = tmp_path / "port" / rel, tmp_path / "jax" / rel
        assert a.is_dir() == b.is_dir()
        if a.is_file():
            assert a.read_bytes() == b.read_bytes(), rel


def test_discovery_matches_jax(tmp_path):
    write_synthetic_cohort(tmp_path, n_patients=2, n_slices=12, height=100, width=100)
    (tmp_path / "not-a-patient").mkdir()
    series = next((tmp_path / "PGBM-0002").iterdir())
    (series / "odd-name.dcm").write_bytes(b"")
    assert discovery.find_patient_dirs(tmp_path) == jax_discovery.find_patient_dirs(tmp_path)
    for pid in ("PGBM-0001", "PGBM-0002"):
        assert discovery.load_dicom_files_for_patient(tmp_path, pid) == (
            jax_discovery.load_dicom_files_for_patient(tmp_path, pid)
        )
    for name in ("1-14.dcm", "1-2.dcm", "x.dcm", "a-b-007.dcm"):
        assert discovery.extract_file_number(name) == jax_discovery.extract_file_number(name)


def test_native_batch_decoder_matches_jax(tmp_path):
    write_synthetic_cohort(tmp_path, n_patients=1, n_slices=4, height=128, width=111)
    files = discovery.load_dicom_files_for_patient(tmp_path, "PGBM-0001")
    files.append(tmp_path / "missing.dcm")
    want = jax_native.load_batch_native(files, canvas=128, min_dim=100, threads=2)
    got = native.load_batch_native(files, canvas=128, min_dim=100, threads=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert list(got[2]) == [True] * 4 + [False]


def test_batch_config_carries_across():
    import dataclasses

    from nm03_capstone_project_tpu.config import BatchConfig as JaxBatchConfig

    for jcfg in (JaxBatchConfig(), JaxBatchConfig(batch_size=7, render_stage="device",
                                                  ingest_decode_workers=3)):
        cfg = batch_config_from_jax(dataclasses.asdict(jcfg))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert BatchConfig().batch_size == 25
    with pytest.raises(ValueError):
        BatchConfig(render_stage="gpu")
    with pytest.raises(TypeError):
        batch_config_from_jax({"batch_size": 4, "mesh": 2})


class TestStaging:
    def test_cpu_stage_is_a_copy_keeping_the_host_arrays(self):
        px = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
        dims = np.asarray([[3, 4]], np.int32)
        out = stage_batch({"pixels": px, "dims": dims, "stems": ["a"]}, "cpu")
        assert out["pixels_host"] is px and out["dims_host"] is dims
        assert out["stems"] == ["a"]
        np.testing.assert_array_equal(out["pixels"].numpy(), px)
        px[0, 0, 0] = -1  # a copy, not a view of the host array
        assert float(out["pixels"][0, 0, 0]) == 0.0
        wait_staged(out)  # nothing to wait for on the CPU

    def test_cuda_stage_needs_its_streams(self):
        with pytest.raises(ValueError, match="copy stream"):
            stage_batch({"pixels": np.zeros((1, 2, 2), np.float32)}, "cuda")


class TestNativeLayer:
    def test_disabled_on_request(self, monkeypatch):
        monkeypatch.setenv("NM03_NO_NATIVE", "1")
        assert native.available() is False
        with pytest.raises(RuntimeError, match="disabled"):
            native.encode_jpeg_gray(np.zeros((8, 8), np.uint8))

    def test_failed_build_raises(self, monkeypatch):
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_build_error", None)
        monkeypatch.setattr(native, "_compile", lambda: None)
        with pytest.raises(RuntimeError, match="did not build"):
            native.available()
