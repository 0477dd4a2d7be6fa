"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (the kernels have no CPU mode). This file imports nothing of JAX, so
it runs on a machine with the card but without JAX, skipping the JAX-bound
``tests/conftest.py``:

    python -m pytest --noconftest tests/test_torch_card.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.core import pad_to_canvas
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter
from nm03_capstone_project_tpu_torch.ops.region_growing import region_grow
from nm03_capstone_project_tpu_torch.pipeline import process_batch

pytestmark = pytest.mark.cuda

PRE = dict(
    norm_low=0.5, norm_high=2.5, norm_min=0.0, norm_max=10000.0,
    clip_low=0.68, clip_high=4000.0, median_window=7,
    sharpen_gain=2.0, sharpen_sigma=0.5, sharpen_kernel=9,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _grow_case(hw=24):
    """A serpentine band (one path snaking down the image, ~hw²/2 steps
    long), a random half-in-band field, and an open field cut by valid."""
    serp = np.full((hw, hw), 0.8, np.float32)
    for r in range(1, hw, 2):
        serp[r, :] = 0.5
        serp[r, -1 if (r // 2) % 2 == 0 else 0] = 0.8
    rng = np.random.default_rng(9)
    img = np.stack([serp, (rng.random((hw, hw)) * 0.3 + 0.68).astype(np.float32),
                    np.full((hw, hw), 0.8, np.float32)])
    seeds = np.zeros((3, hw, hw), bool)
    seeds[0, 0, 0] = seeds[1, hw // 2, hw // 2] = seeds[2, 3, 5] = True
    valid = np.ones((3, hw, hw), bool)
    valid[2, :, hw - 4 :] = False
    return img, seeds, valid


def test_median(cuda):
    x = (torch.rand(3, 251, 241) * 4000 + 0.68).to(cuda)
    for k in (1, 3, 5, 7, 9, 11, 13, 15):
        assert torch.equal(hm.vector_median_filter_kernel(x, k), vector_median_filter(x, k))


def test_fused(cuda):
    x = (torch.rand(3, 251, 241) * 9000).to(cuda)
    assert torch.equal(hm.fused_preprocess_kernel(x, **PRE), hm._fused_preprocess_plain(x, **PRE))


@pytest.mark.parametrize("k", [1, 3, 5, 9, 11, 13, 15])
def test_fused_windows(cuda, k):
    # duplicate-heavy data on a shape whose tiles are ragged in both directions
    x = (torch.randint(0, 4, (2, 61, 300)).float() * 3000).to(cuda)
    kw = dict(PRE, median_window=k)
    assert torch.equal(hm.fused_preprocess_kernel(x, **kw), hm._fused_preprocess_plain(x, **kw))


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("max_iters", [16, 1024])
def test_grow(cuda, connectivity, max_iters):
    img, seeds, valid = (torch.from_numpy(a).to(cuda) for a in _grow_case())
    kw = dict(valid=valid, connectivity=connectivity, block_iters=4, max_iters=max_iters,
              return_steps=True)
    got = hg.region_grow_kernel(img, seeds, 0.74, 0.91, **kw)
    want = region_grow(img, seeds, 0.74, 0.91, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[1].all()) == (max_iters == 1024)


def test_grow_broadcasts_seeds_and_valid(cuda):
    # one (H, W) seeds and valid for a (B, H, W) image, as the plain op takes them
    img, seeds, valid = (torch.from_numpy(a).to(cuda) for a in _grow_case())
    img = torch.stack([img[2]] * 4)
    img[1:, 10:, :] = 0.5
    seeds, valid = seeds[2].float() * 3, valid[2]
    kw = dict(valid=valid, block_iters=4)
    got = hg.region_grow_kernel(img, seeds, 0.74, 0.91, **kw)
    want = region_grow(img, seeds, 0.74, 0.91, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0][0].sum()) > int(got[0][1].sum()) > 0


def test_grow_refuses_what_it_cannot_take(cuda):
    img, seeds, valid = (torch.from_numpy(a).to(cuda) for a in _grow_case())
    with pytest.raises(ValueError, match="seeds is on cpu"):
        hg.region_grow_kernel(img, seeds.cpu())
    # canvas 1024 grows, as a cluster of CTAs, equal to the plain op
    big = torch.full((1, 1024, 1024), 0.8, device=cuda)
    big[0, 300:310, :] = 0.5
    seeds = torch.zeros_like(big, dtype=torch.bool)
    seeds[0, 5, 7] = True
    kw = dict(block_iters=64, max_iters=2048, return_steps=True)
    got = hg.region_grow_kernel(big, seeds, **kw)
    want = region_grow(big, seeds, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[0].sum()) == 300 * 1024
    # past the cluster's capacity: refused before launch
    huge = torch.full((1, 4096, 4096), 0.8, device=cuda)
    launches = hg.region_grow_kernel.launches
    with pytest.raises(ValueError, match="4096x4096"):
        hg.region_grow_kernel(huge, huge > 0.9)
    assert hg.region_grow_kernel.launches == launches


@pytest.mark.parametrize("hw", [(2048, 2048), (97, 1000), (1000, 33)])
def test_grow_large_and_odd_canvases(cuda, hw):
    # random half-in-band fields: many short fixpoints, every cluster edge crossed
    g = torch.Generator().manual_seed(hw[0])
    img = (torch.rand((2, *hw), generator=g) * 0.3 + 0.68).to(cuda)
    seeds = (torch.rand((2, *hw), generator=g) < 0.001).to(cuda)
    valid = (torch.rand((2, *hw), generator=g) < 0.95).to(cuda)
    for conn in (4, 8):
        kw = dict(valid=valid, connectivity=conn, block_iters=4, return_steps=True)
        got = hg.region_grow_kernel(img, seeds, **kw)
        want = region_grow(img, seeds, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_pipeline_kernels_equal_plain(cuda):
    slices = [phantom_slice(256, 256, seed=1), phantom_slice(251, 241, seed=2)]
    b = pad_to_canvas(slices, (256, 256), device=cuda)
    for fuse in (True, False):
        got = process_batch(b.pixels, b.dims, PipelineConfig(fuse_preprocess=fuse))
        want = process_batch(b.pixels, b.dims, PipelineConfig(use_kernels=False))
        assert torch.equal(got["mask"], want["mask"])
        assert torch.equal(got["grow_converged"], want["grow_converged"])


@pytest.mark.parametrize("mode", ["parallel", "sequential"])
@pytest.mark.parametrize("stage", ["host", "device"])
def test_driver_kernels_equal_plain(cuda, tmp_path, mode, stage):
    # a 2 x 4 DICOM cohort through the driver with the kernels and with the
    # plain ops: the kernels launch, and masks and JPEG pairs are equal
    from nm03_capstone_project_tpu_torch.cli.runner import CohortProcessor
    from nm03_capstone_project_tpu_torch.config import BatchConfig
    from nm03_capstone_project_tpu_torch.data.synthetic import write_synthetic_cohort

    write_synthetic_cohort(tmp_path / "cohort", n_patients=2, n_slices=4, height=128,
                           width=120)
    runs = {}
    for name, cfg in (("kernels", PipelineConfig(canvas=128)),
                      ("plain", PipelineConfig(canvas=128, use_kernels=False))):
        masks = {}
        before = (hm.fused_preprocess_kernel.launches, hg.region_grow_kernel.launches)
        proc = CohortProcessor(
            tmp_path / "cohort", tmp_path / name, cfg=cfg, mode=mode,
            batch_cfg=BatchConfig(batch_size=3, render_stage=stage),
            mask_sink=lambda pid, stem, m, masks=masks: masks.__setitem__((pid, stem),
                                                                          m.copy()),
        )
        summary = proc.process_all_patients()
        torch.cuda.synchronize()
        after = (hm.fused_preprocess_kernel.launches, hg.region_grow_kernel.launches)
        assert summary.succeeded_slices == 8
        files = {str(p.relative_to(tmp_path / name)): p.read_bytes()
                 for p in sorted((tmp_path / name).rglob("*.jpg"))}
        runs[name] = (masks, files, [a - b for a, b in zip(after, before)])
    (km, kf, kl), (pm, pf, pl) = runs["kernels"], runs["plain"]
    assert all(n > 0 for n in kl) and pl == [0, 0]
    assert len(km) == 8 and sorted(km) == sorted(pm)
    for key in km:
        assert np.array_equal(km[key], pm[key]), key
    assert len(kf) == 16 and kf == pf


SERVE_DIMS = [(256, 256), (251, 241), (256, 199), (227, 256), (197, 233)]


def _serve_batch(b: int, seed: int):
    dims = [SERVE_DIMS[(seed + i) % len(SERVE_DIMS)] for i in range(b)]
    slices = [phantom_slice(h, w, seed=seed + i) for i, (h, w) in enumerate(dims)]
    batch = pad_to_canvas(slices, (256, 256), device="cpu")
    return batch.pixels.numpy(), batch.dims.numpy()


@pytest.mark.parametrize("fuse", [True, False])
def test_bucket_graphs_equal_eager_and_plain(cuda, fuse):
    # one CUDA graph per serving bucket, sharing a pool: each replay bitwise
    # equal to eager _process with the kernels and to the plain ops
    from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import _process
    from nm03_capstone_project_tpu_torch.serving.graphs import BucketGraph, kernel_launches

    cfg = PipelineConfig(fuse_preprocess=fuse)
    plain = PipelineConfig(fuse_preprocess=fuse, use_kernels=False)
    pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(cuda)
    graphs = {b: BucketGraph(cfg, b, cuda, pool, stream) for b in (1, 2, 4, 8, 16)}
    for g in graphs.values():
        assert g.capture() > 0
        assert g.kernels == ({"fused": 1, "grow": 1} if fuse else {"median": 1, "grow": 1})
    for rnd in range(2):  # the static inputs take new data on every replay
        for b, g in graphs.items():
            px, dm = _serve_batch(b, seed=10 * rnd + b)
            before = kernel_launches()
            g.launch(px, dm)
            mask, conv = g.fetch()
            assert kernel_launches() == before  # replays do not run the wrappers
            x, d = torch.from_numpy(px).to(cuda), torch.from_numpy(dm).to(cuda)
            for want_cfg in (cfg, plain):
                want = _process(x, d, want_cfg)
                assert np.array_equal(mask, want["mask"].cpu().numpy()), (b, rnd, want_cfg)
                assert np.array_equal(conv, want["grow_converged"].cpu().numpy())
            assert int(mask.sum()) > 0
    assert all(g.replays == 2 for g in graphs.values())


def test_served_masks_equal_plain(cuda):
    # the app on the card: warmup captures every bucket, requests replay them
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp

    app = ServingApp(buckets=(1, 2, 4), max_wait_s=0.0, result_cache_bytes=1 << 24)
    app.start()
    try:
        stats = app.status()["cuda_graphs"]
        assert stats["enabled"] and sorted(stats["lanes"]["0"]) == ["1", "2", "4"]
        px, dm = _serve_batch(3, seed=3)
        want = process_batch(torch.from_numpy(px).to(cuda), torch.from_numpy(dm).to(cuda),
                             PipelineConfig(use_kernels=False))["mask"].cpu().numpy()
        for i, (h, w) in enumerate(dm.tolist()):
            payload = app.segment(px[i, :h, :w].copy(), render=False)
            assert payload["shape"] == [h, w]
            assert payload["mask_pixels"] == int(want[i, :h, :w].sum())
        assert app.executor.replay_launches()["grow"] == 3
    finally:
        app.begin_drain(reason="test")
        app.close()
