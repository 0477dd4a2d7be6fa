"""The port's plain PyTorch ops held against the JAX package's, op by op.

Inputs are made from a seed with numpy and go through both packages on the
CPU. Integer, boolean and min/max ops must be bit-identical. The arithmetic
ops are bit-identical to JAX evaluated op by op (each op rounded to
float32, as PyTorch rounds); against JAX's jitted form, where XLA:CPU may
contract ``a*b+c`` into one fused multiply-add, normalize + clip stays
within 2 ulp (one contraction, one rounding).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu import config as jax_config
from nm03_capstone_project_tpu.core import image as jax_image
from nm03_capstone_project_tpu.core import padding as jax_padding
from nm03_capstone_project_tpu.ops import elementwise as jax_elementwise
from nm03_capstone_project_tpu.ops import median as jax_median
from nm03_capstone_project_tpu.ops import morphology as jax_morphology
from nm03_capstone_project_tpu.ops import neighborhood as jax_neighborhood
from nm03_capstone_project_tpu.ops import region_growing as jax_region_growing
from nm03_capstone_project_tpu.ops import seeds as jax_seeds
from nm03_capstone_project_tpu.ops import selection_network as jax_selection
from nm03_capstone_project_tpu_torch import config
from nm03_capstone_project_tpu_torch.convert import config_from_jax
from nm03_capstone_project_tpu_torch.core import image, padding
from nm03_capstone_project_tpu_torch.ops import (
    elementwise,
    median,
    morphology,
    neighborhood,
    region_growing,
    seeds,
    selection_network,
    sharpen,
)

# the JAX ops package re-exports the function sharpen over its module name
jax_sharpen = importlib.import_module("nm03_capstone_project_tpu.ops.sharpen")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ulp(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


DIMS = np.asarray([[32, 32], [17, 29], [1, 5], [32, 1], [23, 31]], np.int32)


class TestCore:
    def test_valid_mask(self):
        want = np.asarray(jax.vmap(lambda d: jax_image.valid_mask(d, (32, 32)))(DIMS))
        got = image.valid_mask(torch.from_numpy(DIMS), (32, 32)).numpy()
        np.testing.assert_array_equal(got, want)

    def test_pad_to_canvas(self):
        rng = np.random.default_rng(1)
        arrays = [rng.random((h, w)).astype(np.float32) for h, w in DIMS]
        want = jax_padding.pad_to_canvas(arrays, (32, 32))
        got = padding.pad_to_canvas(arrays, (32, 32), device="cpu")
        np.testing.assert_array_equal(got.pixels.numpy(), want.pixels)
        np.testing.assert_array_equal(got.dims.numpy(), want.dims)
        assert got.batch == 5 and got.canvas_hw == (32, 32)
        with pytest.raises(ValueError, match="exceeds canvas"):
            padding.pad_to_canvas([np.zeros((40, 8))], (32, 32), device="cpu")


class TestNeighborhood:
    def test_extend_edges(self):
        x = np.random.default_rng(2).random((5, 32, 32)).astype(np.float32)
        want = np.asarray(jax_neighborhood.extend_edges(jnp.asarray(x), jnp.asarray(DIMS)))
        got = neighborhood.extend_edges(torch.from_numpy(x), torch.from_numpy(DIMS))
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("mode", ["edge", "constant"])
    def test_shifted_stack(self, mode):
        x = np.random.default_rng(3).random((2, 9, 11)).astype(np.float32)
        offs = neighborhood.window_offsets(5)
        want = np.asarray(jax_neighborhood.shifted_stack(jnp.asarray(x), offs, mode))
        got = neighborhood.shifted_stack(torch.from_numpy(x), offs, mode)
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("shape", ["box", "cross", "disk"])
    @pytest.mark.parametrize("size", [1, 3, 5])
    def test_offsets(self, shape, size):
        assert neighborhood.footprint_offsets(size, shape) == (
            jax_neighborhood.footprint_offsets(size, shape)
        )
        assert neighborhood.window_offsets(size) == jax_neighborhood.window_offsets(size)


class TestSeeds:
    def test_seed_mask(self):
        dims = np.concatenate([DIMS, [[256, 256], [251, 241], [100, 100]]]).astype(np.int32)
        want = np.asarray(jax.vmap(lambda d: jax_seeds.seed_mask(d, (256, 256)))(dims))
        got = seeds.seed_mask(torch.from_numpy(dims), (256, 256)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got[-2].sum() > 5


class TestElementwise:
    def _x(self):
        return (np.random.default_rng(4).random((3, 16, 16)) * 12000 - 1000).astype(np.float32)

    def test_normalize_clip_bitwise_op_by_op(self):
        x = self._x()
        want = jax_elementwise.clip_intensity(jax_elementwise.normalize(jnp.asarray(x)))
        got = elementwise.clip_intensity(elementwise.normalize(torch.from_numpy(x)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_normalize_clip_within_2_ulp_of_jit(self):
        x = self._x()
        f = jax.jit(lambda v: jax_elementwise.clip_intensity(jax_elementwise.normalize(v)))
        got = elementwise.clip_intensity(elementwise.normalize(torch.from_numpy(x)))
        assert _ulp(got.numpy(), f(jnp.asarray(x))) <= 2

    def test_cast_uint8(self):
        x = np.asarray([[0.0, 1.0, 0.0, 1.0]], np.float32)
        got = elementwise.cast_uint8(torch.from_numpy(x))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_elementwise.cast_uint8(x)))

    @pytest.mark.parametrize("low,high", [(0.74, 0.91), (0.5, 0.5), (2.0, 1.0)])
    def test_binary_threshold(self, low, high):
        x = np.random.default_rng(9).random((3, 17, 19)).astype(np.float32) * 2.5
        x[0, 0, :4] = [0.74, 0.91, 0.5, np.float32(0.74)]  # the band's edges
        got = elementwise.binary_threshold(torch.from_numpy(x), low, high)
        assert got.dtype == torch.uint8
        want = np.asarray(jax_elementwise.binary_threshold(jnp.asarray(x), low, high))
        np.testing.assert_array_equal(got.numpy(), want)


class TestMorphology:
    @pytest.mark.parametrize("op", ["dilate", "erode"])
    @pytest.mark.parametrize("shape", ["cross", "box"])
    @pytest.mark.parametrize("size", [3, 5])
    def test_bitwise(self, op, shape, size):
        x = (np.random.default_rng(size).random((2, 19, 23)) > 0.6).astype(np.uint8)
        want = np.asarray(getattr(jax_morphology, op)(jnp.asarray(x), size, shape))
        got = getattr(morphology, op)(torch.from_numpy(x), size, shape)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)

    def test_bool_input_keeps_dtype(self):
        x = np.random.default_rng(5).random((12, 12)) > 0.7
        want = np.asarray(jax_morphology.dilate(jnp.asarray(x), 3, "cross"))
        got = morphology.dilate(torch.from_numpy(x), 3, "cross")
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("dtype", ["bool", "uint8"])
    @pytest.mark.parametrize("op", ["dilate", "erode"])
    @pytest.mark.parametrize("size", [3, 5, 7])
    def test_disk_bitwise(self, size, op, dtype):
        # JAX folds disk 3 and 7 and decomposes disk 5 as box 3 then cross
        # 3; the port folds every disk: the same bits
        x = np.random.default_rng(10 + size).random((2, 21, 18)) > 0.55
        x = x if dtype == "bool" else (x * np.uint8(3)).astype(np.uint8)
        want = np.asarray(getattr(jax_morphology, op)(jnp.asarray(x), size, "disk"))
        got = getattr(morphology, op)(torch.from_numpy(x), size, "disk")
        assert str(got.dtype) == f"torch.{dtype}"
        np.testing.assert_array_equal(got.numpy(), want)


class TestSelectionNetwork:
    @pytest.mark.parametrize("k", [3, 5, 7, 9])
    def test_copy_pinned_to_original(self, k):
        for share in (False, True):
            assert selection_network.median_merge_plan(k, share=share) == (
                jax_selection.median_merge_plan(k, share=share)
            )
        assert selection_network.comparator_counts(k) == jax_selection.comparator_counts(k)


class TestMedian:
    @pytest.mark.parametrize("size", [1, 3, 5, 7])
    def test_bitwise_random(self, size):
        x = np.random.default_rng(size).random((2, 21, 26)).astype(np.float32)
        want = np.asarray(jax_median.vector_median_filter(jnp.asarray(x), size))
        got = median.vector_median_filter(torch.from_numpy(x), size)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_ties(self):
        x = np.random.default_rng(6).integers(0, 4, (24, 24)).astype(np.float32)
        want = np.asarray(jax_median.vector_median_filter(jnp.asarray(x), 7))
        got = median.vector_median_filter(torch.from_numpy(x), 7)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_even_window_raises(self):
        with pytest.raises(ValueError):
            median.vector_median_filter(torch.zeros((8, 8)), 4)

    @pytest.mark.parametrize("impl", ["merge", "sort"])
    @pytest.mark.parametrize("size", [3, 5, 7, 9, 11, 13, 15])
    def test_merge_and_sort_bitwise(self, impl, size):
        x = np.random.default_rng(20 + size).random((2, 19, 23)).astype(np.float32)
        x[0, 3:9, 4:10] = 0.5  # a run of ties
        fn = f"vector_median_filter_{impl}"
        want = np.asarray(getattr(jax_median, fn)(jnp.asarray(x), size))
        got = getattr(median, fn)(torch.from_numpy(x), size).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
        # and the same bits as the pruned plan the kernels are held against
        pruned = median.vector_median_filter(torch.from_numpy(x), size).numpy()
        np.testing.assert_array_equal(got.view(np.uint32), pruned.view(np.uint32))

    @pytest.mark.parametrize("size", [3, 5])
    def test_multichannel_exact_on_integer_values(self, size):
        # integer-valued samples: every L1 sum is exact, so the argmin and
        # its ties are the same in both packages
        x = np.random.default_rng(size).integers(0, 40, (2, 3, 15, 13)).astype(np.float32)
        want = np.asarray(jax_median.vector_median_filter_multichannel(jnp.asarray(x), size))
        got = median.vector_median_filter_multichannel(torch.from_numpy(x), size)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_multichannel_random_floats_differ_only_at_near_ties(self):
        size = 3
        x = np.random.default_rng(31).random((3, 24, 21)).astype(np.float32)
        want = np.asarray(jax_median.vector_median_filter_multichannel(jnp.asarray(x), size))
        got = median.vector_median_filter_multichannel(torch.from_numpy(x), size).numpy()
        # the window costs in float64: where the two packages pick different
        # samples, their two best costs lie within 1e-5 relative
        stack = neighborhood.shifted_stack(torch.from_numpy(x).double(),
                                           neighborhood.window_offsets(size)).numpy()
        cost = np.abs(stack[:, None] - stack[None, :]).sum(axis=-3).sum(axis=1)
        best2 = np.sort(cost, axis=0)[:2]
        differ = (got != want).any(axis=0)
        assert np.all(best2[1][differ] - best2[0][differ] <= 1e-5 * best2[0][differ])
        assert differ.mean() < 0.01

    @pytest.mark.parametrize("impl", ["merge", "sort"])
    @pytest.mark.parametrize("fuse", [True, False])
    def test_pipeline_selects_the_plain_median_by_impl(self, impl, fuse, monkeypatch):
        from nm03_capstone_project_tpu_torch.ops import hopper_median
        from nm03_capstone_project_tpu_torch.pipeline import process_batch

        calls = []
        real = hopper_median.PLAIN_MEDIANS[impl]
        monkeypatch.setitem(hopper_median.PLAIN_MEDIANS, impl,
                            lambda *a: calls.append(impl) or real(*a))
        px = np.random.default_rng(7).random((2, 40, 40)).astype(np.float32) * 3000
        dims = np.asarray([[40, 40], [33, 37]], np.int32)
        base = config.PipelineConfig(canvas=40, min_dim=8, fuse_preprocess=fuse)
        want = process_batch(px, dims, base, device="cpu")
        got = process_batch(px, dims, dataclasses.replace(base, median_impl=impl), device="cpu")
        assert calls == [impl]
        assert torch.equal(got["mask"], want["mask"])


class TestSharpen:
    @pytest.mark.parametrize("sigma,size", [(0.5, 9), (1.0, 5), (2.0, 3), (0.7, 1)])
    def test_taps_equal(self, sigma, size):
        np.testing.assert_array_equal(
            sharpen.gaussian_kernel_1d(sigma, size),
            jax_sharpen.gaussian_kernel_1d(sigma, size),
        )

    def test_sharpen_bitwise_op_by_op(self):
        x = (np.random.default_rng(7).random((2, 20, 17)) * 3 + 0.68).astype(np.float32)
        want = np.asarray(jax_sharpen.sharpen(jnp.asarray(x)))
        got = sharpen.sharpen(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want)


def _grow_case(n=3, hw=40):
    rng = np.random.default_rng(8)
    img = (rng.random((n, hw, hw)) * 0.3 + 0.68).astype(np.float32)  # ~half in band
    dims = np.asarray([[hw, hw], [hw - 3, hw - 7], [hw // 2, hw]], np.int32)[:n]
    sd = np.array(jax.vmap(lambda d: jax_seeds.seed_mask(d, (hw, hw)))(dims))
    valid = np.array(jax.vmap(lambda d: jax_image.valid_mask(d, (hw, hw)))(dims))
    return img, sd, valid


class TestRegionGrow:
    @pytest.mark.parametrize("connectivity", [4, 8])
    @pytest.mark.parametrize("block_iters,max_iters", [(4, 256), (2, 4)])
    def test_bitwise_per_slice(self, connectivity, block_iters, max_iters):
        img, sd, valid = _grow_case()
        kw = dict(connectivity=connectivity, block_iters=block_iters, max_iters=max_iters)
        want = jax.vmap(
            lambda i, s, v: jax_region_growing.region_grow(i, s, valid=v, **kw)
        )(img, sd, valid)
        got = region_growing.region_grow(
            torch.from_numpy(img), torch.from_numpy(sd), valid=torch.from_numpy(valid), **kw
        )
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].shape == (3,)

    def test_band_thresholds_are_float32(self):
        # 0.74 as float32 is 0.74000001: a pixel holding float32(0.74) is in
        # the band for both packages
        img = np.full((4, 4), np.float32(0.74), np.float32)
        sd = np.zeros((4, 4), bool)
        sd[1, 1] = True
        want = jax_region_growing.region_grow(jnp.asarray(img), jnp.asarray(sd))
        got = region_growing.region_grow(torch.from_numpy(img), torch.from_numpy(sd))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        assert got[0].sum() == 16


class TestConfig:
    def test_fields_and_defaults_match(self):
        jax_fields = {f.name: f.default for f in dataclasses.fields(jax_config.PipelineConfig)}
        port_fields = {f.name: f.default for f in dataclasses.fields(config.PipelineConfig)}
        assert jax_fields.pop("use_pallas") is False
        assert port_fields.pop("use_kernels") is True
        assert port_fields == jax_fields
        assert config.DEFAULT_BATCH_SIZE == jax_config.BatchConfig().batch_size == 25

    def test_convert_maps_use_pallas(self):
        jcfg = jax_config.PipelineConfig(canvas=128, median_window=5, use_pallas=True)
        cfg = config_from_jax(dataclasses.asdict(jcfg))
        assert cfg.use_kernels is True and cfg.canvas == 128 and cfg.median_window == 5
        off = config_from_jax(dataclasses.asdict(jax_config.PipelineConfig()))
        assert off.use_kernels is False
        with pytest.raises(TypeError, match="no_such_field"):
            config_from_jax({"no_such_field": 1})

    def test_unported_choices_raise(self):
        # grow_algorithm="jump" is ported (torch ops) and, unlike the JAX
        # package's use_pallas, allowed with the kernels on
        assert config.PipelineConfig(grow_algorithm="jump").use_kernels is True
        # merge and sort are ported (the plain medians; the kernels ignore them)
        for impl in ("merge", "sort"):
            assert config.PipelineConfig(median_impl=impl).median_impl == impl
        with pytest.raises(ValueError):
            config.PipelineConfig(median_impl="bogus")
        with pytest.raises(ValueError):
            config.PipelineConfig(median_window=4)
