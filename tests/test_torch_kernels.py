"""The plain versions of the three Hopper kernels held against the Pallas
kernels they replace, and the kernels themselves held against their plain
versions on the card.

On the CPU the JAX package's Pallas kernels run in interpret mode, as its
own tests run them; the same numpy inputs go through the port's plain
PyTorch version of each kernel:

* median: bit-identical for k in {3, 5, 7};
* fused preprocess: bit-identical to the JAX composition evaluated op by
  op, and within ``JIT_ULP`` of the Pallas kernel, which XLA compiles with
  fused multiply-adds (the unsharp update amplifies their last-bit
  differences; ``PYTHONPATH=. JAX_PLATFORMS=cpu python
  tests/test_torch_kernels.py`` prints the distances: 12 ulp on the
  phantoms below, 7-8 on the random inputs);
* grow: mask and per-slice ``converged`` bit-identical, with a truncating
  ``max_iters`` on a serpentine band.

The kernels themselves are held against their plain versions on the card
by ``tests/test_torch_card.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu.ops.pallas_median import (
    _fused_preprocess_xla,
    fused_preprocess_pallas,
    vector_median_filter_pallas,
)
from nm03_capstone_project_tpu.ops.pallas_region_growing import _grow_pallas_batched
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice
from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter
from nm03_capstone_project_tpu_torch.ops.region_growing import region_grow
from nm03_capstone_project_tpu_torch.ops.selection_network import comparator_counts

JIT_ULP = 16
PRE = dict(
    norm_low=0.5, norm_high=2.5, norm_min=0.0, norm_max=10000.0,
    clip_low=0.68, clip_high=4000.0, median_window=7,
    sharpen_gain=2.0, sharpen_sigma=0.5, sharpen_kernel=9,
)


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


class TestMedianPlain:
    @pytest.mark.parametrize("size", [3, 5, 7])
    @pytest.mark.parametrize("shape", [(2, 24, 40), (31, 29)])
    def test_bitwise_vs_pallas_interpret(self, size, shape):
        x = np.random.default_rng(size).random(shape).astype(np.float32)
        want = np.asarray(vector_median_filter_pallas(jnp.asarray(x), size, interpret=True))
        got = vector_median_filter(torch.from_numpy(x), size)
        np.testing.assert_array_equal(got.numpy(), want)

    def test_dispatch_takes_plain_on_cpu(self):
        x = torch.rand(2, 12, 12)
        hm.vector_median_filter_kernel.launches = 0
        out = hm.median_filter(x, 5, use_kernels=True)
        assert torch.equal(out, vector_median_filter(x, 5))
        assert hm.vector_median_filter_kernel.launches == 0


class TestFusedPlain:
    @pytest.mark.parametrize("shape", [(2, 40, 40), (37, 29), (64, 64)])
    def test_vs_pallas_interpret(self, shape):
        x = (np.random.default_rng(sum(shape)).random(shape) * 9000.0).astype(np.float32)
        want = np.asarray(fused_preprocess_pallas(jnp.asarray(x), interpret=True))
        got = hm._fused_preprocess_plain(torch.from_numpy(x), **PRE).numpy()
        assert _ulp(got, want) <= JIT_ULP

    def test_on_phantom_prime_canvas(self):
        x = phantom_slice(61, 53, seed=5)
        want = np.asarray(fused_preprocess_pallas(jnp.asarray(x), interpret=True))
        got = hm._fused_preprocess_plain(torch.from_numpy(x), **PRE).numpy()
        assert _ulp(got, want) <= JIT_ULP

    @pytest.mark.parametrize("shape", [(2, 40, 40), (37, 29)])
    def test_bitwise_vs_reference_op_by_op(self, shape):
        # the JAX composition, not jitted, rounds every op as the port does
        x = (np.random.default_rng(len(shape)).random(shape) * 9000.0).astype(np.float32)
        want = np.asarray(_fused_preprocess_xla(jnp.asarray(x), **PRE))
        got = hm._fused_preprocess_plain(torch.from_numpy(x), **PRE).numpy()
        np.testing.assert_array_equal(got, want)

    def test_dispatch_takes_plain_on_cpu(self):
        x = torch.rand(1, 16, 16) * 9000
        hm.fused_preprocess_kernel.launches = 0
        out = hm.fused_preprocess(x, use_kernels=True, **PRE)
        assert torch.equal(out, hm._fused_preprocess_plain(x, **PRE))
        assert hm.fused_preprocess_kernel.launches == 0


def _serpentine(hw: int) -> np.ndarray:
    """A band that is one path snaking down the image: walls on odd rows
    with the gap at alternating ends, so the region needs ~hw²/2 steps."""
    img = np.full((hw, hw), 0.8, np.float32)
    for r in range(1, hw, 2):
        img[r, :] = 0.5
        img[r, -1 if (r // 2) % 2 == 0 else 0] = 0.8
    return img


class TestGrowPlain:
    def _case(self):
        hw = 24
        rng = np.random.default_rng(9)
        img = np.stack([
            _serpentine(hw),
            (rng.random((hw, hw)) * 0.3 + 0.68).astype(np.float32),
            np.full((hw, hw), 0.8, np.float32),
        ])
        seeds = np.zeros((3, hw, hw), bool)
        seeds[0, 0, 0] = seeds[1, hw // 2, hw // 2] = seeds[2, 3, 5] = True
        seeds[1, 2, 20] = True
        valid = np.ones((3, hw, hw), bool)
        valid[2, :, hw - 4 :] = False
        return img, seeds, valid

    @pytest.mark.parametrize("connectivity", [4, 8])
    @pytest.mark.parametrize("block_iters,max_iters", [(8, 512), (4, 16)])
    def test_bitwise_vs_pallas_interpret(self, connectivity, block_iters, max_iters):
        img, seeds, valid = self._case()
        band = (img >= np.float32(0.74)) & (img <= np.float32(0.91)) & valid
        want_mask, want_conv = _grow_pallas_batched(
            jnp.asarray(band.astype(np.float32)), jnp.asarray(seeds.astype(np.float32)),
            connectivity, block_iters, max_iters, True,
        )
        got_mask, got_conv = region_grow(
            torch.from_numpy(img), torch.from_numpy(seeds), 0.74, 0.91,
            valid=torch.from_numpy(valid), connectivity=connectivity,
            block_iters=block_iters, max_iters=max_iters,
        )
        np.testing.assert_array_equal(
            got_mask.numpy(), np.asarray(want_mask).astype(np.uint8)
        )
        np.testing.assert_array_equal(got_conv.numpy(), np.asarray(want_conv) == 1)
        if max_iters == 16:
            # the cap cuts the serpentine (~300 steps) short
            assert got_conv.tolist()[0] is False
        else:
            assert bool(got_conv.all())

    def test_dispatch_takes_plain_on_cpu(self):
        img, seeds, valid = self._case()
        hg.region_grow_kernel.launches = 0
        out = hg.grow_dispatch(torch.from_numpy(img), torch.from_numpy(seeds), 0.74, 0.91,
                               valid=torch.from_numpy(valid), use_kernels=True)
        want = region_grow(torch.from_numpy(img), torch.from_numpy(seeds), 0.74, 0.91,
                           valid=torch.from_numpy(valid))
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
        assert hg.region_grow_kernel.launches == 0

    def test_jump_not_ported(self):
        # the jump schedule is ported as torch ops (no kernel in either
        # package): the dispatch runs it on the CPU with the JAX package's
        # log2 round budget and launches nothing; masks and converged equal
        # the JAX dispatch's, exactly
        from nm03_capstone_project_tpu.ops.pallas_region_growing import (
            grow_dispatch as jax_grow_dispatch,
        )

        img, seeds, valid = self._case()
        hg.region_grow_kernel.launches = 0
        for max_iters in (16, 1024):
            got_m, got_c = hg.grow_dispatch(
                torch.from_numpy(img), torch.from_numpy(seeds), 0.74, 0.91,
                valid=torch.from_numpy(valid), max_iters=max_iters, algorithm="jump")
            for i in range(img.shape[0]):
                want_m, want_c = jax_grow_dispatch(
                    jnp.asarray(img[i]), jnp.asarray(seeds[i]), 0.74, 0.91,
                    jnp.asarray(valid[i]), max_iters=max_iters, algorithm="jump")
                np.testing.assert_array_equal(got_m[i].numpy(), np.asarray(want_m))
                assert bool(got_c[i]) == bool(want_c)
        assert hg.region_grow_kernel.launches == 0

    @pytest.mark.parametrize("canvas", [256, 512])
    def test_canvas_256_and_512_fit_shared_memory(self, canvas):
        # the H100's opt-in limit per block is 227 KB (232,448 bytes)
        assert hg.grow_launch_shape(canvas, canvas)[2] <= 232448

    def test_canvas_1024_exceeds_shared_memory(self):
        # one CTA's shared memory cannot hold the slice: a cluster of 8 shares it
        cluster, rows, smem = hg.grow_launch_shape(1024, 1024)
        assert 3 * 1024 * 32 * 4 > 232448
        assert (cluster, rows) == (8, 128) and smem <= 232448

    @pytest.mark.parametrize("block_iters,max_iters", [(8, 512), (4, 16)])
    def test_steps_are_each_slices_own_loop(self, block_iters, max_iters):
        img, seeds, valid = (torch.from_numpy(a) for a in self._case())
        kw = dict(valid=valid, block_iters=block_iters, max_iters=max_iters,
                  return_steps=True)
        mask, conv, steps = region_grow(img, seeds, 0.74, 0.91, **kw)
        assert steps.dtype == torch.int32 and steps.shape == (3,)
        for i in range(3):
            kw["valid"] = valid[i]
            m, c, s = region_grow(img[i], seeds[i], 0.74, 0.91, **kw)
            assert torch.equal(m, mask[i]) and bool(c) == bool(conv[i])
            assert int(s) == int(steps[i])
            assert int(s) % block_iters == 0 and block_iters <= int(s) <= max(max_iters, block_iters)
        if max_iters == 16:
            assert int(steps[0]) == 16  # the serpentine runs to the cap


class TestGeneratedPlans:
    @pytest.mark.parametrize("k", build.MEDIAN_WINDOWS)
    def test_header_runs_the_unshared_plan(self, k):
        src = build.median_plans_header()
        body = src.split(f"median_plan<{k}>(const float* s, int ps) {{")[1].split("}")[0]
        n_ops = body.count("fminf(") + body.count("fmaxf(")
        want = 0 if k == 1 else comparator_counts(k)["merge_minmax_pruned"]
        assert n_ops == want

    def test_build_key_covers_the_generated_header(self, monkeypatch):
        key = build.build_dir()
        monkeypatch.setattr(build, "median_plans_header", lambda: "// changed\n")
        assert build.build_dir() != key


if __name__ == "__main__":
    # print the fused cases' ulp distance from the Pallas kernel (jitted, with
    # FMA) and from the op-by-op reference
    cases = {f"random{s}": (np.random.default_rng(sum(s)).random(s) * 9000.0).astype(np.float32)
             for s in [(2, 40, 40), (37, 29), (64, 64)]}
    cases.update({f"phantom{h}x{w}": phantom_slice(h, w, seed=5) for h, w in [(61, 53), (64, 64)]})
    for name, x in cases.items():
        got = hm._fused_preprocess_plain(torch.from_numpy(x), **PRE).numpy()
        pallas = np.asarray(fused_preprocess_pallas(jnp.asarray(x), interpret=True))
        eager = np.asarray(_fused_preprocess_xla(jnp.asarray(x), **PRE))
        print(f"{name}: {_ulp(got, pallas)} ulp from Pallas, {_ulp(got, eager)} from op by op")
