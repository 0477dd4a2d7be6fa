"""The port's 3D volume path held against the JAX package's, on the CPU.

The same numpy inputs (made from seeds) go through the JAX package's
``ops/volume.py``, ``region_grow_jump``, ``process_volume`` and
``data/imageio.py`` as its own tests run them (un-jitted, its XLA path:
no Pallas kernel computes any of these), and through the port's
counterparts with ``device="cpu"``. Every mask check is exact (bitwise);
``converged`` must be equal; the MetaImage files must be equal byte for
byte. Also the ``scipy.ndimage`` oracles for the morphology and the fills.

Pins ``nm03_capstone_project_tpu_torch/testdata/volume_golden.json``, the
golden ``chip_smoke.py`` holds the card's volume CLI run against: per
patient of the 20 x 25 DICOM cohort at 256 (``write_synthetic_cohort``),
the sha256 of the uint8 3D mask, its voxel count and ``grow_converged``,
made by the JAX package on the CPU. The cohort's patients share one
series shape and all but PGBM-0019 one mask, so the golden also holds
phantom volumes of four other shapes (``GOLDEN_PHANTOMS``), a mask each.
Here the first patient and the smallest phantom are recomputed with the
JAX package, and the first two patients and that phantom with the port.
Regenerate it with

    JAX_PLATFORMS=cpu python tests/test_torch_volume.py --write
"""

import dataclasses
import hashlib
import json
import pathlib
import sys

import numpy as np
import pytest
import torch
from scipy import ndimage

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax.numpy as jnp  # noqa: E402

from nm03_capstone_project_tpu.cli.volume import _load_volume as jax_load_volume  # noqa: E402
from nm03_capstone_project_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from nm03_capstone_project_tpu.core import pad_to_canvas as jax_pad_to_canvas  # noqa: E402
from nm03_capstone_project_tpu.data import imageio as jax_imageio  # noqa: E402
from nm03_capstone_project_tpu.data.synthetic import (  # noqa: E402
    phantom_volume as jax_phantom_volume,
)
from nm03_capstone_project_tpu.data.synthetic import (  # noqa: E402
    write_synthetic_cohort as jax_write_cohort,
)
from nm03_capstone_project_tpu.ops import region_growing as jax_rg  # noqa: E402
from nm03_capstone_project_tpu.ops import volume as jax_volume  # noqa: E402
from nm03_capstone_project_tpu.pipeline.volume_pipeline import (  # noqa: E402
    process_volume as jax_process_volume,
)
from nm03_capstone_project_tpu_torch.cli.volume import _load_volume  # noqa: E402
from nm03_capstone_project_tpu_torch.config import PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.core import pad_to_canvas  # noqa: E402
from nm03_capstone_project_tpu_torch.data import imageio  # noqa: E402
from nm03_capstone_project_tpu_torch.data.synthetic import (  # noqa: E402
    phantom_volume,
    write_synthetic_cohort,
)
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm  # noqa: E402
from nm03_capstone_project_tpu_torch.obs.spans import StageRecorder  # noqa: E402
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg  # noqa: E402
from nm03_capstone_project_tpu_torch.ops import hopper_volume as hv  # noqa: E402
from nm03_capstone_project_tpu_torch.ops import volume  # noqa: E402
from nm03_capstone_project_tpu_torch.ops.region_growing import (  # noqa: E402
    region_grow,
    region_grow_jump,
)
from nm03_capstone_project_tpu_torch.pipeline import process_volume, stage_spans  # noqa: E402
from tests.oracles import region_grow_oracle  # noqa: E402

GOLDEN = (
    pathlib.Path(__file__).resolve().parents[1]
    / "nm03_capstone_project_tpu_torch" / "testdata" / "volume_golden.json"
)
GOLDEN_PATIENTS, GOLDEN_SLICES, GOLDEN_SIZE = 20, 25, 256
# (depth, height, width, seed) of the golden's phantom volumes on the 256
# canvas; the phantom's seed does not change its mask, its shape does
GOLDEN_PHANTOMS = [(13, 200, 248, 11), (20, 192, 256, 4), (32, 240, 200, 3), (40, 256, 224, 7)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _helix():
    """A one-voxel path winding through all three axes (the JAX package's
    worst case for one-shell growth), band value 0.5, seed at its start."""
    vol = np.zeros((6, 10, 10), np.float32)
    for z in range(6):
        if z % 2 == 0:
            vol[z, z % 10, :9] = 0.5
        else:
            vol[z, z % 10, 8] = 0.5
            vol[z, (z + 1) % 10, 8] = 0.5
        if z + 1 < 6:
            vol[z, (z + 1) % 10, 0 if z % 2 else 8] = 0.5
            vol[z + 1, (z + 1) % 10, 0 if z % 2 else 8] = 0.5
    seeds = np.zeros_like(vol, dtype=bool)
    seeds[0, 0, 0] = True
    return vol, seeds


def _serpentine(hw):
    img = np.full((hw, hw), 0.8, np.float32)
    for r in range(1, hw, 2):
        img[r, :] = 0.5
        img[r, -1 if (r // 2) % 2 == 0 else 0] = 0.8
    return img


class TestPhantomVolume:
    @pytest.mark.parametrize("shape,seed", [((4, 64, 64), 0), ((3, 61, 53), 7)])
    def test_copy_pinned_to_jax(self, shape, seed):
        got = phantom_volume(*shape, seed=seed)
        want = jax_phantom_volume(*shape, seed=seed)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


class TestMorphology3D:
    @pytest.mark.parametrize("shape", ["cross", "box", "ball"])
    @pytest.mark.parametrize("size", [1, 3, 5])
    def test_footprints_equal_jax(self, size, shape):
        assert volume.footprint_offsets_3d(size, shape) == jax_volume.footprint_offsets_3d(
            size, shape)

    def test_cross_3_is_6_connected_and_unknown_raises(self):
        assert len(volume.footprint_offsets_3d(3, "cross")) == 7
        assert len(volume.footprint_offsets_3d(3, "box")) == 27
        with pytest.raises(ValueError, match="unknown footprint"):
            volume.footprint_offsets_3d(3, "hexagon")
        with pytest.raises(ValueError, match="unknown footprint"):
            volume.dilate3d(torch.zeros((2, 3, 3), dtype=torch.uint8), 3, "hexagon")

    @pytest.mark.parametrize("dtype", [np.bool_, np.uint8])
    @pytest.mark.parametrize("shape", ["cross", "box"])
    @pytest.mark.parametrize("op", ["dilate3d", "erode3d"])
    def test_equal_jax_and_scipy(self, op, shape, dtype):
        rng = np.random.default_rng(11)
        x = rng.random((2, 5, 9, 11)) > 0.6  # a leading batch axis
        if dtype == np.uint8:
            x = (x * rng.integers(1, 200, x.shape)).astype(np.uint8)
        got = getattr(volume, op)(t(x), 3, shape)
        want = np.asarray(getattr(jax_volume, op)(jnp.asarray(x), 3, shape))
        assert got.dtype == (torch.bool if dtype == np.bool_ else torch.uint8)
        np.testing.assert_array_equal(got.numpy(), want)
        conn = 1 if shape == "cross" else 3
        fp = ndimage.generate_binary_structure(3, conn)
        for b in range(x.shape[0]):
            if dtype == np.bool_:
                fn = ndimage.binary_dilation if op == "dilate3d" else ndimage.binary_erosion
                oracle = fn(x[b], structure=fp, border_value=0)
            else:
                fn = ndimage.grey_dilation if op == "dilate3d" else ndimage.grey_erosion
                oracle = fn(x[b], footprint=fp, mode="constant", cval=0)
            np.testing.assert_array_equal(got[b].numpy(), oracle)

    def test_shifted_stack_equal_jax(self):
        x = np.random.default_rng(2).random((3, 4, 5)).astype(np.float32)
        offs = volume.footprint_offsets_3d(3, "box")
        np.testing.assert_array_equal(
            volume.shifted_stack_3d(t(x), offs).numpy(),
            np.asarray(jax_volume.shifted_stack_3d(jnp.asarray(x), offs)))


class TestRegionGrow3D:
    """Masks and ``converged`` exactly equal to the JAX ops and the oracle."""

    def _case(self):
        rng = np.random.default_rng(4)
        vol = rng.random((8, 16, 16)).astype(np.float32)
        seeds = np.zeros_like(vol, dtype=bool)
        seeds[4, 8, 8] = seeds[2, 3, 12] = True
        return vol, seeds

    @pytest.mark.parametrize("connectivity", [6, 26])
    @pytest.mark.parametrize("schedule", ["dilate", "jump"])
    def test_equal_jax_and_oracle(self, schedule, connectivity):
        vol, seeds = self._case()
        valid = np.ones_like(seeds)
        valid[:, :, 13:] = False
        if schedule == "dilate":
            kw = dict(valid=valid, connectivity=connectivity, block_iters=4, max_iters=512)
            got = volume.region_grow_3d(t(vol), t(seeds), 0.4, 0.9,
                                        **{**kw, "valid": t(valid)})
            want = jax_volume.region_grow_3d(jnp.asarray(vol), jnp.asarray(seeds), 0.4, 0.9,
                                             **{**kw, "valid": jnp.asarray(valid)})
        else:
            got = volume.region_grow_jump_3d(t(vol), t(seeds), 0.4, 0.9, valid=t(valid),
                                             connectivity=connectivity)
            want = jax_volume.region_grow_jump_3d(jnp.asarray(vol), jnp.asarray(seeds),
                                                  0.4, 0.9, valid=jnp.asarray(valid),
                                                  connectivity=connectivity)
        assert got[0].dtype == torch.uint8 and got[1].dim() == 0
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert bool(got[1]) is bool(want[1]) is True
        # the oracle's band: voxels outside valid read 0, below the band
        oracle = region_grow_oracle(np.where(valid, vol, 0), seeds, np.float32(0.4),
                                    np.float32(0.9), connectivity)
        np.testing.assert_array_equal(got[0].numpy(), oracle)

    @pytest.mark.parametrize("schedule", ["dilate", "jump"])
    def test_truncating_cap(self, schedule):
        vol = np.full((8, 24, 24), 0.8, np.float32)
        seeds = np.zeros(vol.shape, bool)
        seeds[0, 0, 0] = True
        if schedule == "dilate":
            got = volume.region_grow_3d(t(vol), t(seeds), 0.74, 0.91, block_iters=2,
                                        max_iters=4, return_steps=True)
            want = jax_volume.region_grow_3d(jnp.asarray(vol), jnp.asarray(seeds), 0.74,
                                             0.91, block_iters=2, max_iters=4)
            assert got[2] == 4
        else:
            got = volume.region_grow_jump_3d(t(vol), t(seeds), 0.74, 0.91, max_rounds=1,
                                             return_steps=True)
            want = jax_volume.region_grow_jump_3d(jnp.asarray(vol), jnp.asarray(seeds),
                                                  0.74, 0.91, max_rounds=1)
            assert got[2] == 1
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert bool(got[1]) is bool(want[1]) is False
        assert 0 < int(got[0].sum()) < vol.size

    @pytest.mark.parametrize("schedule", ["dilate", "jump"])
    def test_z_helix(self, schedule):
        vol, seeds = _helix()
        oracle = region_grow_oracle(vol, seeds, 0.4, 0.6, 6)
        if schedule == "dilate":
            got = volume.region_grow_3d(t(vol), t(seeds), 0.4, 0.6)
            want = jax_volume.region_grow_3d(jnp.asarray(vol), jnp.asarray(seeds), 0.4, 0.6)
        else:
            got = volume.region_grow_jump_3d(t(vol), t(seeds), 0.4, 0.6)
            want = jax_volume.region_grow_jump_3d(jnp.asarray(vol), jnp.asarray(seeds),
                                                  0.4, 0.6)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[0].numpy(), oracle)
        assert bool(got[1]) is bool(want[1]) is True

    def test_converged_is_one_scalar_over_a_batch(self):
        # region.sum() sums every axis: one flag for the whole input, as in JAX
        vol = np.full((2, 4, 12, 12), 0.8, np.float32)
        vol[1] = 0.5  # nothing to grow in the second volume
        seeds = np.zeros(vol.shape, bool)
        seeds[:, 0, 0, 0] = True
        got = volume.region_grow_3d(t(vol), t(seeds), 0.74, 0.91, block_iters=2,
                                    max_iters=2)
        want = jax_volume.region_grow_3d(jnp.asarray(vol), jnp.asarray(seeds), 0.74, 0.91,
                                         block_iters=2, max_iters=2)
        assert got[1].shape == () and np.asarray(want[1]).shape == ()
        assert bool(got[1]) is bool(want[1]) is False
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))

    def test_jump_rejects_batched_input(self):
        with pytest.raises(ValueError, match="per-volume"):
            volume.region_grow_jump_3d(torch.zeros((2, 4, 8, 8)),
                                       torch.zeros((2, 4, 8, 8), dtype=torch.bool), 0.0, 1.0)

    def test_bad_connectivity_raises(self):
        for fn in (volume.region_grow_3d, volume.region_grow_jump_3d):
            with pytest.raises(ValueError, match="connectivity"):
                fn(torch.zeros((2, 4, 4)), torch.zeros((2, 4, 4), dtype=torch.bool),
                   connectivity=8)


class TestRegionGrowJump2D:
    """The 2D pointer-jumping schedule: equal to the JAX op (vmapped over
    slices) and to the dilate schedule wherever both converge."""

    def _case(self):
        rng = np.random.default_rng(9)
        img = np.stack([_serpentine(16), (rng.random((16, 16)) * 0.3 + 0.68).astype(
            np.float32), np.full((16, 16), 0.8, np.float32)])
        seeds = np.zeros(img.shape, bool)
        seeds[0, 0, 0] = seeds[1, 8, 8] = seeds[1, 2, 12] = seeds[2, 3, 5] = True
        valid = np.ones(img.shape, bool)
        valid[2, :, 12:] = False
        return img, seeds, valid

    @pytest.mark.parametrize("connectivity", [4, 8])
    def test_equal_jax_and_dilate(self, connectivity):
        img, seeds, valid = self._case()
        got_m, got_c = region_grow_jump(t(img), t(seeds), 0.74, 0.91, valid=t(valid),
                                        connectivity=connectivity)
        dil_m, dil_c = region_grow(t(img), t(seeds), 0.74, 0.91, valid=t(valid),
                                   connectivity=connectivity, max_iters=4096)
        assert got_m.dtype == torch.uint8 and got_c.shape == (3,)
        assert bool(got_c.all()) and bool(dil_c.all())
        assert torch.equal(got_m, dil_m)
        for i in range(3):
            want_m, want_c = jax_rg.region_grow_jump(
                jnp.asarray(img[i]), jnp.asarray(seeds[i]), 0.74, 0.91,
                valid=jnp.asarray(valid[i]), connectivity=connectivity)
            np.testing.assert_array_equal(got_m[i].numpy(), np.asarray(want_m))
            assert bool(got_c[i]) == bool(want_c)

    def test_truncation_per_slice(self):
        img, seeds, valid = self._case()
        got_m, got_c = region_grow_jump(t(img), t(seeds), 0.74, 0.91, valid=t(valid),
                                        max_rounds=3)
        for i in range(3):
            want_m, want_c = jax_rg.region_grow_jump(
                jnp.asarray(img[i]), jnp.asarray(seeds[i]), 0.74, 0.91,
                valid=jnp.asarray(valid[i]), max_rounds=3)
            np.testing.assert_array_equal(got_m[i].numpy(), np.asarray(want_m))
            assert bool(got_c[i]) == bool(want_c)
        assert got_c.tolist()[0] is False  # the serpentine outruns 3 rounds

    def test_one_slice_gives_a_scalar(self):
        img, seeds, valid = self._case()
        m, c = region_grow_jump(t(img[2]), t(seeds[2]), 0.74, 0.91, valid=t(valid[2]))
        assert m.shape == (16, 16) and c.shape == ()

    def test_process_batch_with_jump_equals_dilate(self):
        from nm03_capstone_project_tpu_torch.core import pad_to_canvas
        from nm03_capstone_project_tpu_torch.data.synthetic import phantom_series
        from nm03_capstone_project_tpu_torch.pipeline import process_batch

        b = pad_to_canvas(phantom_series(3, 64, 60, seed=4), (64, 64), device="cpu")
        a = process_batch(b.pixels, b.dims, PipelineConfig(canvas=64), device="cpu")
        j = process_batch(b.pixels, b.dims, PipelineConfig(canvas=64, grow_algorithm="jump"),
                          device="cpu")
        assert torch.equal(a["mask"], j["mask"]) and int(a["mask"].sum()) > 0
        assert torch.equal(a["grow_converged"], j["grow_converged"])


VOLUME_CASES = {
    # (depth, true h, true w, canvas)
    "8x96x96": (8, 96, 96, 96),
    "6x64x64_on_96": (6, 64, 64, 96),
    "6x61x53_on_96": (6, 61, 53, 96),
}


def _volume_case(name):
    d, h, w, c = VOLUME_CASES[name]
    canvas = np.zeros((d, c, c), np.float32)
    canvas[:, :h, :w] = phantom_volume(d, h, w, seed=d + h)
    return canvas, np.asarray([h, w], np.int32), c


@pytest.fixture(scope="module")
def jax_volumes():
    """The JAX package's ``process_volume`` (un-jitted, its XLA path) per
    case and schedule; its ``fuse_preprocess`` matters only with Pallas."""
    out = {}
    for name in VOLUME_CASES:
        vol, dims, c = _volume_case(name)
        for alg in ("dilate", "jump"):
            r = jax_process_volume(jnp.asarray(vol), jnp.asarray(dims),
                                   JaxConfig(canvas=c, grow_algorithm=alg))
            out[name, alg] = (np.asarray(r["mask"]), bool(r["grow_converged"]))
    return out


class TestProcessVolume:
    @pytest.mark.parametrize("fuse", [True, False], ids=["fused", "unfused"])
    @pytest.mark.parametrize("alg", ["dilate", "jump"])
    @pytest.mark.parametrize("name", list(VOLUME_CASES))
    def test_bitwise_equal_jax(self, jax_volumes, name, alg, fuse):
        vol, dims, c = _volume_case(name)
        cfg = PipelineConfig(canvas=c, grow_algorithm=alg, fuse_preprocess=fuse)
        out = process_volume(vol, dims, cfg, device="cpu")
        want_mask, want_conv = jax_volumes[name, alg]
        assert out["mask"].dtype == torch.uint8 and out["mask"].shape == vol.shape
        np.testing.assert_array_equal(out["mask"].numpy(), want_mask)
        assert bool(out["grow_converged"]) is want_conv is True
        assert want_mask.sum() > 0
        h, w = dims
        assert want_mask[:, h:, :].sum() == 0 and want_mask[:, :, w:].sum() == 0

    def test_lesion_is_one_6_connected_body(self, jax_volumes):
        mask = jax_volumes["8x96x96", "dilate"][0]
        _, n = ndimage.label(mask, structure=ndimage.generate_binary_structure(3, 1))
        assert n == 1 and (mask.reshape(mask.shape[0], -1).sum(1) > 0).sum() >= 3

    def test_capped_volume_surfaces_truncation(self):
        vol, dims, c = _volume_case("6x64x64_on_96")
        jcfg = JaxConfig(canvas=c, grow_block_iters=1, grow_max_iters=2)
        want = jax_process_volume(jnp.asarray(vol), jnp.asarray(dims), jcfg)
        got = process_volume(vol, dims, PipelineConfig(
            canvas=c, grow_block_iters=1, grow_max_iters=2), device="cpu")
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
        assert bool(got["grow_converged"]) is bool(want["grow_converged"]) is False

    def test_rejects_other_shapes(self):
        vol, dims, _ = _volume_case("6x61x53_on_96")
        with pytest.raises(ValueError, match="process_volume takes"):
            process_volume(vol[0], dims, device="cpu")
        with pytest.raises(ValueError, match="process_volume takes"):
            process_volume(vol, np.stack([dims] * 5), device="cpu")

    def test_cpu_launches_no_kernel(self):
        vol, dims, c = _volume_case("6x61x53_on_96")
        kernels = (hm.fused_preprocess_kernel, hm.vector_median_filter_kernel,
                   hg.region_grow_kernel, hv.region_grow_3d_kernel)
        for fn in kernels:
            fn.launches = 0
        for fuse in (True, False):
            process_volume(vol, dims, PipelineConfig(canvas=c, fuse_preprocess=fuse),
                           device="cpu")
        assert tuple(fn.launches for fn in kernels) == (0, 0, 0, 0)

    @pytest.mark.parametrize("use_kernels", [True, False])
    def test_cpu_grows_by_the_torch_loop(self, use_kernels):
        # on the CPU, kernels asked for or not, the growth is the torch loop:
        # its blocks and syncs are counted, no 3D grow kernel launch is
        vol, dims, c = _volume_case("6x61x53_on_96")
        cfg = PipelineConfig(canvas=c, use_kernels=use_kernels)
        before = hv.region_grow_3d_kernel.launches
        rec = StageRecorder()
        with stage_spans(rec):
            out = process_volume(vol, dims, cfg, device="cpu")
        assert hv.region_grow_3d_kernel.launches == before
        assert rec.counters.get("grow3d.launches", 0) == 0
        assert rec.counters["grow3d.syncs"] > 0
        assert rec.counters["grow3d.syncs"] * cfg.grow_block_iters == rec.counters["grow3d.steps"]
        want = process_volume(vol, dims, PipelineConfig(canvas=c), device="cpu")
        assert torch.equal(out["mask"], want["mask"])


class TestMetaImage:
    @pytest.mark.parametrize("compressed", [False, True], ids=["raw", "zraw"])
    @pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.float32])
    @pytest.mark.parametrize("ndim", [2, 3])
    def test_bytes_equal_jax(self, tmp_path, ndim, dtype, compressed):
        rng = np.random.default_rng(ndim)
        a = (rng.random((3, 7, 5)[-ndim:]) * 100).astype(dtype)
        spacing = (2.5, 1.0, 0.5)[-ndim:]
        imageio.write_metaimage(a, tmp_path / "p" / "m", spacing=spacing, compressed=compressed)
        jax_imageio.write_metaimage(a, tmp_path / "j" / "m", spacing=spacing,
                                    compressed=compressed)
        names = sorted(f.name for f in (tmp_path / "p").iterdir())
        assert names == sorted(f.name for f in (tmp_path / "j").iterdir())
        assert names == ["m.mhd", "m.zraw" if compressed else "m.raw"]
        for n in names:
            assert (tmp_path / "p" / n).read_bytes() == (tmp_path / "j" / n).read_bytes()
        back, sp = imageio.read_metaimage(tmp_path / "j" / "m.mhd")
        np.testing.assert_array_equal(back, a)
        assert back.dtype == a.dtype and sp == spacing

    def test_rejects_size_mismatch(self, tmp_path):
        imageio.write_metaimage(np.zeros((4, 4), np.uint8), tmp_path / "m.mhd")
        raw = tmp_path / "m.raw"
        raw.write_bytes(raw.read_bytes()[:-1])
        with pytest.raises(ValueError, match="bytes"):
            imageio.read_metaimage(tmp_path / "m.mhd")

    def test_rejects_missing_field(self, tmp_path):
        (tmp_path / "bad.mhd").write_text("ObjectType = Image\nNDims = 2\n")
        with pytest.raises(ValueError, match="missing"):
            imageio.read_metaimage(tmp_path / "bad.mhd")

    def test_rejects_unsupported_dtype(self, tmp_path):
        with pytest.raises(ValueError, match="dtype"):
            imageio.write_metaimage(np.zeros((2, 2), np.complex64), tmp_path / "c.mhd")
        (tmp_path / "e.mhd").write_text(
            "NDims = 2\nDimSize = 2 2\nElementType = MET_LONG\nElementDataFile = e.raw\n")
        with pytest.raises(ValueError, match="unsupported ElementType"):
            imageio.read_metaimage(tmp_path / "e.mhd")

    def test_rejects_4d(self, tmp_path):
        with pytest.raises(ValueError, match="2D/3D"):
            imageio.write_metaimage(np.zeros((2, 2, 2, 2), np.uint8), tmp_path / "q.mhd")

    def test_rejects_corrupt_compressed_payload(self, tmp_path):
        vol = (np.random.default_rng(1).random((4, 8, 8)) * 100).astype(np.uint8)
        imageio.write_metaimage(vol, tmp_path / "c.mhd", compressed=True)
        zraw = tmp_path / "c.zraw"
        data = bytearray(zraw.read_bytes())
        data[:8] = b"\xff" * 8
        zraw.write_bytes(bytes(data))
        with pytest.raises(ValueError, match="corrupt compressed"):
            imageio.read_metaimage(tmp_path / "c.mhd")

    def test_rejects_what_jax_rejects(self, tmp_path):
        # big-endian, inline data, multi-file data: both readers refuse
        for i, extra in enumerate(("ElementByteOrderMSB = True\nElementDataFile = x.raw",
                                   "ElementDataFile = LOCAL", "ElementDataFile = LIST")):
            p = tmp_path / f"h{i}.mhd"
            p.write_text(f"NDims = 2\nDimSize = 2 2\nElementType = MET_UCHAR\n{extra}\n")
            for reader in (imageio.read_metaimage, jax_imageio.read_metaimage):
                with pytest.raises(ValueError):
                    reader(p)


def golden_record(pid, mask, converged):
    return {
        "patient": pid,
        "depth": int(mask.shape[0]),
        "mask_sha256": hashlib.sha256(np.ascontiguousarray(mask).tobytes()).hexdigest(),
        "voxels": int(mask.sum()),
        "grow_converged": bool(converged),
    }


def phantom_record(d, h, w, seed, mask, converged):
    rec = golden_record(None, mask, converged)
    del rec["patient"], rec["depth"]
    return {"shape": [d, h, w], "seed": seed, **rec}


def jax_phantom_record(d, h, w, seed):
    batch = jax_pad_to_canvas(list(jax_phantom_volume(d, h, w, seed=seed)),
                              (GOLDEN_SIZE, GOLDEN_SIZE))
    out = jax_process_volume(batch.pixels, batch.dims[0], JaxConfig(canvas=GOLDEN_SIZE))
    return phantom_record(d, h, w, seed, np.asarray(out["mask"]), out["grow_converged"])


def jax_golden(root, n_patients=GOLDEN_PATIENTS, phantoms=GOLDEN_PHANTOMS) -> dict:
    """The golden recomputed with the JAX package: its writer, its volume
    driver's loader and its ``process_volume``, default config at 256; and
    its ``phantom_volume`` padded by its ``pad_to_canvas``."""
    jax_write_cohort(root, n_patients=n_patients, n_slices=GOLDEN_SLICES,
                     height=GOLDEN_SIZE, width=GOLDEN_SIZE)
    cfg = JaxConfig(canvas=GOLDEN_SIZE)
    records = []
    for p in range(n_patients):
        pid = f"PGBM-{p + 1:04d}"
        vol, dims, _, _ = jax_load_volume(root, pid, cfg)
        out = jax_process_volume(jnp.asarray(vol), jnp.asarray(dims), cfg)
        records.append(golden_record(pid, np.asarray(out["mask"]), out["grow_converged"]))
    return {
        "what": "3D masks of write_synthetic_cohort(n_patients=20, n_slices=25, 256 x 256), "
                "the chip_smoke volume cohort, one volume a patient, made by the JAX "
                "package's process_volume on the CPU (default PipelineConfig)",
        "canvas": GOLDEN_SIZE,
        "patients": records,
        "phantoms_what": "3D masks of phantom_volume(depth, height, width, seed) zero-padded "
                         "to 256 x 256, made by the JAX package's process_volume on the CPU "
                         "(default PipelineConfig)",
        "phantoms": [jax_phantom_record(*ph) for ph in phantoms],
    }


class TestVolumeGolden:
    def test_golden_covers_the_cohort(self):
        golden = json.loads(GOLDEN.read_text())
        assert [g["patient"] for g in golden["patients"]] == [
            f"PGBM-{p + 1:04d}" for p in range(GOLDEN_PATIENTS)]
        assert {g["depth"] for g in golden["patients"]} == {GOLDEN_SLICES}
        assert all(g["voxels"] > 0 for g in golden["patients"])

    def test_golden_is_current(self, tmp_path):
        # the first patient and phantom, recomputed with the JAX package
        # (all of them take minutes)
        golden = json.loads(GOLDEN.read_text())
        got = jax_golden(tmp_path / "cohort", n_patients=1, phantoms=GOLDEN_PHANTOMS[:1])
        assert got["patients"] == golden["patients"][:1]
        assert got["phantoms"] == golden["phantoms"][:1]

    def test_golden_phantoms_are_distinct(self):
        golden = json.loads(GOLDEN.read_text())
        assert [ph["shape"] + [ph["seed"]] for ph in golden["phantoms"]] == [
            list(ph) for ph in GOLDEN_PHANTOMS]
        hashes = {ph["mask_sha256"] for ph in golden["phantoms"]}
        hashes |= {g["mask_sha256"] for g in golden["patients"]}
        assert len(hashes) == len(GOLDEN_PHANTOMS) + 2
        assert all(ph["voxels"] > 0 and ph["grow_converged"] for ph in golden["phantoms"])

    def test_port_matches_golden_phantom(self):
        golden = json.loads(GOLDEN.read_text())
        d, h, w, seed = GOLDEN_PHANTOMS[0]
        batch = pad_to_canvas(list(phantom_volume(d, h, w, seed=seed)),
                              (GOLDEN_SIZE, GOLDEN_SIZE), device="cpu")
        out = process_volume(batch.pixels, batch.dims[0], PipelineConfig(canvas=GOLDEN_SIZE),
                             device="cpu")
        assert phantom_record(d, h, w, seed, out["mask"].numpy(),
                              out["grow_converged"]) == golden["phantoms"][0]

    def test_port_matches_golden(self, tmp_path):
        golden = json.loads(GOLDEN.read_text())
        root = tmp_path / "cohort"
        write_synthetic_cohort(root, n_patients=2, n_slices=GOLDEN_SLICES,
                               height=GOLDEN_SIZE, width=GOLDEN_SIZE)
        cfg = PipelineConfig(canvas=GOLDEN_SIZE)
        for g in golden["patients"][:2]:
            vol, dims, _, _ = _load_volume(root, g["patient"], cfg)
            out = process_volume(vol, dims, cfg, device="cpu")
            assert golden_record(g["patient"], out["mask"].numpy(),
                                 out["grow_converged"]) == g

    def test_jump_schedule_matches_golden(self, tmp_path):
        golden = json.loads(GOLDEN.read_text())
        root = tmp_path / "cohort"
        write_synthetic_cohort(root, n_patients=1, n_slices=GOLDEN_SLICES,
                               height=GOLDEN_SIZE, width=GOLDEN_SIZE)
        cfg = dataclasses.replace(PipelineConfig(canvas=GOLDEN_SIZE), grow_algorithm="jump")
        vol, dims, _, _ = _load_volume(root, "PGBM-0001", cfg)
        out = process_volume(vol, dims, cfg, device="cpu")
        assert golden_record("PGBM-0001", out["mask"].numpy(),
                             out["grow_converged"]) == golden["patients"][0]


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_volume.py --write")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        GOLDEN.write_text(json.dumps(jax_golden(pathlib.Path(tmp)), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
