"""The port's renderers, JPEG encoder and test-pipeline driver held against
the JAX package's, on the CPU.

* the host renderer (NumPy) and the host C++ renderer: bit-identical to the
  JAX package's, on phantoms;
* the torch device renderer: bit-identical to the JAX renderer evaluated op
  by op (``jax.disable_jit``, as the host renderer and the card compute
  it), and to the jitted one on the driver's phantom sizes, where no lerp
  rounds (XLA:CPU's jit may contract ``a*b + c*d`` into a fused
  multiply-add; the port never does, so the card equals the host);
* the host C++ JPEG encoder: the JAX package's bytes; the C++ sources are
  byte-equal copies of ``csrc/``;
* ``nm03-test-pipeline``'s five stage renders: held to
  ``tests/golden/stage_renders_seed*.npz`` with ``tests/test_golden.py``'s
  tolerance (per pixel |diff| <= 3, mean <= 0.1).
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import torch  # noqa: E402

from nm03_capstone_project_tpu import native as jax_native  # noqa: E402
from nm03_capstone_project_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from nm03_capstone_project_tpu.core import pad_to_canvas as jax_pad  # noqa: E402
from nm03_capstone_project_tpu.pipeline import process_batch as jax_process_batch  # noqa: E402
from nm03_capstone_project_tpu.render import render as jax_render  # noqa: E402
from nm03_capstone_project_tpu.render.contact_sheet import (  # noqa: E402
    contact_sheet as jax_contact_sheet,
)
from nm03_capstone_project_tpu.render.host_render import (  # noqa: E402
    host_render_pair as jax_host_render_pair,
)
from nm03_capstone_project_tpu_torch import native  # noqa: E402
from nm03_capstone_project_tpu_torch.cli import test_pipeline  # noqa: E402
from nm03_capstone_project_tpu_torch.config import PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.convert import config_from_jax  # noqa: E402
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice  # noqa: E402
from nm03_capstone_project_tpu_torch.render import render  # noqa: E402
from nm03_capstone_project_tpu_torch.render.contact_sheet import contact_sheet  # noqa: E402
from nm03_capstone_project_tpu_torch.render.export import (  # noqa: E402
    encode_jpeg_bytes,
    jpeg_encoder,
)
from nm03_capstone_project_tpu_torch.render.host_render import host_render_pair  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
GOLDEN_DIR = REPO / "tests" / "golden"
STAGE_NAMES = ("original_image", "preprocessed_image", "segmentation",
               "erosion_result", "final_dilated_result")


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
def phantoms():
    """Masks from the JAX pipeline on mixed-size phantoms at canvas 256:
    (pixels, mask, dims), numpy. Float pixels with fractional lerps."""
    slices = [phantom_slice(251, 241, seed=1), phantom_slice(256, 199, seed=2),
              phantom_slice(197, 233, seed=3, lesion_radius=0.12),
              phantom_slice(256, 256, seed=4)]
    b = jax_pad(slices, (256, 256))
    out = jax_process_batch(b.pixels, b.dims, JaxConfig(canvas=256))
    return np.asarray(b.pixels), np.asarray(out["mask"]), np.asarray(b.dims)


CFGS = [
    JaxConfig(canvas=256),
    JaxConfig(canvas=256, render_size=300, overlay_opacity=0.35, overlay_border_radius=1),
]


@pytest.mark.parametrize("jcfg", CFGS, ids=["default", "odd"])
class TestHostRender:
    def test_numpy_renderer_equals_jax(self, phantoms, jcfg):
        cfg = config_from_jax(dataclasses.asdict(jcfg))
        for px, m, d in zip(*phantoms):
            for got, want in zip(host_render_pair(px, m, d, cfg),
                                 jax_host_render_pair(px, m, d, jcfg)):
                np.testing.assert_array_equal(got, want)

    def test_native_renderer_equals_jax(self, phantoms, jcfg):
        cfg = config_from_jax(dataclasses.asdict(jcfg))
        for px, m, d in zip(*phantoms):
            got = native.render_pair_native(px, m, d, cfg)
            want = jax_native.render_pair_native(px, m, d, jcfg)
            numpy_twin = host_render_pair(px, m, d, cfg)
            for g, w, n in zip(got, want, numpy_twin):
                np.testing.assert_array_equal(g, w)
                np.testing.assert_array_equal(g, n)


@pytest.mark.parametrize("jcfg", CFGS, ids=["default", "odd"])
class TestDeviceRender:
    def _torch(self, phantoms):
        return tuple(torch.from_numpy(np.array(a)) for a in phantoms)

    @pytest.mark.parametrize("fused", [True, False])
    def test_render_pair_bitwise_op_by_op(self, phantoms, jcfg, fused):
        jcfg = dataclasses.replace(jcfg, render_fused=fused)
        cfg = config_from_jax(dataclasses.asdict(jcfg))
        with jax.disable_jit():
            want = jax.vmap(lambda p, m, d: jax_render.render_pair(p, m, d, jcfg))(*phantoms)
        got = render.render_pair(*self._torch(phantoms), cfg)
        for g, w in zip(got, want):
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        # and the host renderer, slice by slice
        for i, (px, m, d) in enumerate(zip(*phantoms)):
            for g, h in zip(got, host_render_pair(px, m, d, cfg)):
                np.testing.assert_array_equal(g[i].numpy(), h)

    def test_single_renders_and_overlay_op_by_op(self, phantoms, jcfg):
        px, m, d = self._torch(phantoms)
        args = (jcfg.render_size, jcfg.overlay_opacity, jcfg.overlay_border_opacity,
                jcfg.overlay_border_radius)
        with jax.disable_jit():
            want_gray = jax.vmap(lambda p, dd: jax_render.render_gray(p, dd, jcfg.render_size))(
                phantoms[0], phantoms[2])
            want_seg = jax.vmap(lambda mm, dd: jax_render.render_segmentation(mm, dd, *args))(
                phantoms[1], phantoms[2])
            want_ov = jax.vmap(lambda p, mm, dd: jax_render.render_overlay(p, mm, dd, *args))(
                *phantoms)
        np.testing.assert_array_equal(render.render_gray(px, d, jcfg.render_size).numpy(),
                                      np.asarray(want_gray))
        np.testing.assert_array_equal(render.render_segmentation(m, d, *args).numpy(),
                                      np.asarray(want_seg))
        np.testing.assert_array_equal(render.render_overlay(px, m, d, *args).numpy(),
                                      np.asarray(want_ov))
        # one slice, no batch axis
        one = render.render_gray(px[1], d[1], jcfg.render_size)
        assert one.shape == (jcfg.render_size,) * 2
        np.testing.assert_array_equal(one.numpy(), np.asarray(want_gray[1]))

    def test_within_one_count_of_jit(self, phantoms, jcfg):
        cfg = config_from_jax(dataclasses.asdict(jcfg))
        want = jax.jit(jax.vmap(lambda p, m, d: jax_render.render_pair(p, m, d, jcfg)))(
            *phantoms)
        got = render.render_pair(*self._torch(phantoms), cfg)
        gray = np.abs(got[0].numpy().astype(int) - np.asarray(want[0]).astype(int))
        assert gray.max() <= 1 and (gray > 0).mean() < 1e-3
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_device_render_equals_jit_at_driver_sizes():
    # integer DICOM pixels at 128 x 120 and 256 x 256 into 512: every lerp
    # weight is exact, so the jitted JAX render is bit-identical too
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas
    from nm03_capstone_project_tpu_torch.pipeline import process_batch

    for hw, canvas in (((128, 120), 128), ((256, 256), 256)):
        slices = [np.round(phantom_slice(*hw, seed=s)) for s in range(2)]
        cfg = PipelineConfig(canvas=canvas)
        b = pad_to_canvas(slices, (canvas, canvas), device="cpu")
        mask = process_batch(b.pixels, b.dims, cfg, device="cpu")["mask"]
        assert int(mask.sum()) > 0
        jcfg = JaxConfig(canvas=canvas)
        want = jax.jit(jax.vmap(lambda p, m, d: jax_render.render_pair(p, m, d, jcfg)))(
            b.pixels.numpy(), mask.numpy(), b.dims.numpy())
        got = render.render_pair(b.pixels, mask, b.dims, cfg)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_contact_sheet_equals_jax():
    rng = np.random.default_rng(5)
    panels = [rng.integers(0, 256, (s, s), dtype=np.uint8) for s in (512, 300, 77)]
    for kw in ({}, {"pane_size": 128, "pad": 3, "background": 40}):
        np.testing.assert_array_equal(contact_sheet(panels, **kw),
                                      jax_contact_sheet(panels, **kw))
    with pytest.raises(ValueError):
        contact_sheet(panels, labels=["a"])


class TestJpeg:
    def test_native_encoder_equals_jax(self):
        rng = np.random.default_rng(6)
        images = [rng.integers(0, 256, (64, 48), dtype=np.uint8),
                  np.zeros((512, 512), np.uint8),
                  (np.indices((97, 131)).sum(0) % 256).astype(np.uint8)]
        for img in images:
            for q in (50, 90):
                assert native.encode_jpeg_gray(img, q) == jax_native.encode_jpeg_gray(img, q)

    def test_encoder_preference_is_pil_then_native(self, monkeypatch):
        from nm03_capstone_project_tpu_torch.render import export

        img = (np.indices((40, 40)).sum(0) * 3 % 256).astype(np.uint8)
        assert jpeg_encoder() == "PIL"
        monkeypatch.setattr(export, "_pil_image", lambda: None)
        assert jpeg_encoder() == "native"
        assert encode_jpeg_bytes(img) == jax_native.encode_jpeg_gray(img, 90)
        monkeypatch.setenv("NM03_NO_NATIVE", "1")
        with pytest.raises(RuntimeError, match="no JPEG encoder"):
            jpeg_encoder()
        with pytest.raises(RuntimeError, match="no JPEG encoder"):
            encode_jpeg_bytes(img)

    @pytest.mark.parametrize("name", ["nm03native.cpp", "nm03gdcm.cpp"])
    def test_cpp_copies_are_byte_equal(self, name):
        port = REPO / "nm03_capstone_project_tpu_torch" / "csrc" / "host" / name
        assert port.read_bytes() == (REPO / "csrc" / name).read_bytes()


@pytest.mark.parametrize("seed", [17, 3, 11])
def test_stage_renders_match_goldens(seed):
    # tests/golden/make_goldens.py's inputs, through the port's test driver
    radius = {17: 0.10, 3: 0.13, 11: 0.16}[seed]
    pixels = phantom_slice(256, 256, seed=seed, lesion_radius=radius)
    got = test_pipeline.stage_renders(pixels, np.asarray([256, 256], np.int32),
                                      PipelineConfig(canvas=256), device="cpu")
    golden = np.load(GOLDEN_DIR / f"stage_renders_seed{seed}.npz")
    assert sorted(got) == sorted(golden.files) == sorted(STAGE_NAMES)
    for name in STAGE_NAMES:
        want, have = golden[name], got[name]
        assert have.shape == want.shape and have.dtype == want.dtype, name
        diff = np.abs(have.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 3, (name, diff.max())
        assert diff.mean() <= 0.1, (name, diff.mean())
    assert (got["final_dilated_result"] > 0).sum() > (got["segmentation"] > 0).sum() > 0


def test_test_pipeline_cli_writes_the_stage_jpegs(tmp_path):
    out = tmp_path / "out-test"
    assert test_pipeline.main(["--device", "cpu", "--output", str(out)]) == 0
    names = sorted(p.name for p in out.glob("*.jpg"))
    assert names == sorted([f"{n}.jpg" for n in STAGE_NAMES] + ["pipeline_panel.jpg"])
