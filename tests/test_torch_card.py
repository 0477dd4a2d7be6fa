"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (the kernels have no CPU mode). This file imports nothing of JAX, so
it runs on a machine with the card but without JAX, skipping the JAX-bound
``tests/conftest.py``:

    python -m pytest --noconftest tests/test_torch_card.py -m cuda -q
"""

import base64

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
    # past the global route's limit: refused before launch
    huge = torch.full((1, 16385, 2304), 0.8, device=cuda)
    launches = hg.region_grow_kernel.launches, hg.region_grow_global_kernel.launches
    with pytest.raises(ValueError, match="16385x2304"):
        hg.region_grow_kernel(huge, huge > 0.9)
    assert (hg.region_grow_kernel.launches, hg.region_grow_global_kernel.launches) == launches


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


@pytest.mark.parametrize("fuse", [True, False])
def test_graph_replay_under_the_profiler_names_the_kernels(cuda, fuse, tmp_path):
    # a replay is one cudaGraphLaunch: CUPTI must still report each kernel
    # node by name, or the ledger's stage pie cannot see median7 and grow
    import json

    from nm03_capstone_project_tpu_torch.obs import ledger
    from nm03_capstone_project_tpu_torch.serving.graphs import (
        BucketGraph,
        record_kernel_sequence,
    )
    from nm03_capstone_project_tpu_torch.utils import profiling

    cfg = PipelineConfig(fuse_preprocess=fuse)
    pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(cuda)
    g = BucketGraph(cfg, 4, cuda, pool, stream)
    g.capture()
    seq = record_kernel_sequence(cfg, 4, cuda, stream)
    px, dm = _serve_batch(4, seed=1)
    with profiling.exclusive_profiler() as prof:
        for _ in range(3):
            g.launch(px, dm)
            g.fetch()
    trace = tmp_path / "replays.json"
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    want = ("fused_kernel", "grow_kernel") if fuse else ("band_kernel", "grow_kernel")
    for name in want:
        assert sum(name in k for k in kernels) == 3, name
        assert any(name in n for n, _ in seq)
    labeled, stage_of, unmatched = ledger.label_trace_events(events, [seq])
    pie = ledger.reduce_trace_events(labeled, stage_of)
    assert pie.get("median7", 0) > 0 and pie.get("grow", 0) > 0
    assert unmatched == 0, unmatched


def test_ledger_conserves_over_a_served_run(cuda):
    import math
    import threading

    from nm03_capstone_project_tpu_torch.serving.server import ServingApp

    app = ServingApp(buckets=(1, 2, 4), max_wait_s=0.002)
    app.start()
    try:
        px, dm = _serve_batch(7, seed=5)
        threads = [threading.Thread(target=app.segment, args=(px[i, :h, :w].copy(),),
                                    kwargs={"render": False})
                   for i, (h, w) in enumerate(dm.tolist())]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = app.status()
        snap, sat = st["ledger"], st["saturation"]
        busy = app.executor.busy_seconds
        assert busy > 0 and snap["requests"]["count"] == 7
        assert math.isclose(snap["device_seconds_total"], busy, rel_tol=1e-8, abs_tol=1e-8)
        assert set(snap["hbm_bytes"]) == {1, 2, 4}
        assert all(k["peak"] >= k["argument"] + k["output"] for k in snap["hbm_bytes"].values())
        assert 0 < sat["busy_fraction"] <= 1 and sat["lanes"][0]["peak_flops"] == 67e12
    finally:
        app.begin_drain(reason="test")
        app.close()


def test_dispatch_hang_quarantines_and_the_probe_reinstates_the_lane(cuda):
    import time

    from nm03_capstone_project_tpu_torch.resilience import FaultPlan, ResilienceConfig
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp

    plan = FaultPlan.from_spec({"faults": [
        {"site": "dispatch", "kind": "hang", "index": 1, "hang_s": 20.0}]})
    app = ServingApp(buckets=(1,), max_wait_s=0.0, fault_plan=plan,
                     resilience=ResilienceConfig(dispatch_timeout_s=1.0),
                     lane_probe_interval_s=0.2)
    app.start()
    try:
        img = phantom_slice(256, 240, seed=2)
        assert app.segment(img, render=False)["mask_pixels"] > 0
        with pytest.raises(TimeoutError):  # DeadlineExceeded, after the quarantine
            app.segment(img, render=False)
        deadline = time.monotonic() + 15
        while not app.ready and time.monotonic() < deadline:
            time.sleep(0.05)
        assert app.ready and app.status()["capacity"] == 1.0
        assert app.segment(img, render=False)["mask_pixels"] > 0
        reg = app.registry
        assert reg.get("serving_lane_quarantines_total", lane="0", cause="deadline").value == 1
        assert reg.get("serving_lane_reinstated_total", lane="0").value == 1
    finally:
        app.begin_drain(reason="test")
        app.close()


@pytest.mark.parametrize("fuse,alg", [(True, "dilate"), (False, "dilate"), (True, "jump")])
def test_process_volume_kernels_equal_plain(cuda, fuse, alg):
    # one phantom study on the card: the preprocess kernel in ONE launch
    # over its D planes (the fused kernel, or the median kernel unfused),
    # masks and converged equal to the plain ops; the 2D grow kernel idle
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
    from nm03_capstone_project_tpu_torch.pipeline import process_volume

    vol = np.zeros((12, 256, 256), np.float32)
    vol[:, :240, :200] = phantom_volume(12, 240, 200, seed=3)
    dims = np.asarray([240, 200], np.int32)
    cfg = PipelineConfig(fuse_preprocess=fuse, grow_algorithm=alg)
    kernels = (hm.fused_preprocess_kernel, hm.vector_median_filter_kernel,
               hg.region_grow_kernel)
    for fn in kernels:
        fn.launches = 0
    got = process_volume(vol, dims, cfg)
    launches = tuple(fn.launches for fn in kernels)
    want = process_volume(vol, dims, PipelineConfig(fuse_preprocess=fuse, grow_algorithm=alg,
                                                    use_kernels=False))
    assert got["mask"].device.type == "cuda"
    assert torch.equal(got["mask"], want["mask"]) and int(got["mask"].sum()) > 0
    assert bool(got["grow_converged"]) is bool(want["grow_converged"]) is True
    assert launches == ((1, 0, 0) if fuse else (0, 1, 0))


@pytest.mark.parametrize("fuse", [True, False])
def test_served_volume_equals_plain_process_volume(cuda, fuse):
    # the volume gang on the card: its own stream on a thread of its own,
    # the study padded from 11 planes to the 16-plane bucket, cropped back
    # to the plain ops' mask; one preprocess launch, no grow launch
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
    from nm03_capstone_project_tpu_torch.pipeline import process_volume
    from nm03_capstone_project_tpu_torch.serving.server import ServingApp

    cfg = PipelineConfig(fuse_preprocess=fuse)
    app = ServingApp(cfg=cfg, buckets=(1,), volume_serving=True, volume_depth_buckets=(8, 16))
    app.start()
    kernels = (hm.fused_preprocess_kernel, hm.vector_median_filter_kernel,
               hg.region_grow_kernel)
    try:
        study = phantom_volume(11, 240, 200, seed=3)
        for fn in kernels:
            fn.launches = 0
        payload = app.segment_volume(study.copy())
        launches = tuple(fn.launches for fn in kernels)
    finally:
        app.begin_drain(reason="test")
        app.close()
    vol = np.zeros((11, 256, 256), np.float32)
    vol[:, :240, :200] = study
    want = process_volume(vol, np.asarray([240, 200], np.int32),
                          PipelineConfig(fuse_preprocess=fuse, use_kernels=False))
    got = np.frombuffer(base64.b64decode(payload["mask_b64"]), np.uint8)
    assert payload["shape"] == [11, 240, 200] and payload["z_shards"] == 1
    assert np.array_equal(got.reshape(11, 240, 200), want["mask"].cpu().numpy()[:, :240, :200])
    assert payload["grow_converged"] is bool(want["grow_converged"])
    assert launches == ((1, 0, 0) if fuse else (0, 1, 0))


@pytest.mark.parametrize("impl", ["merge", "sort"])
def test_plain_medians_agree_on_the_card(cuda, impl):
    from nm03_capstone_project_tpu_torch.ops import median

    x = (torch.rand((3, 61, 67), generator=torch.Generator().manual_seed(4)) * 4000).to(cuda)
    for k in (3, 7, 15):
        got = getattr(median, f"vector_median_filter_{impl}")(x, k)
        assert torch.equal(got, vector_median_filter(x, k))
        assert torch.equal(got, hm.vector_median_filter_kernel(x, k))


@pytest.mark.parametrize("ndim", [2, 3])
def test_student_forward_equals_the_cpu_with_tf32_on(cuda, ndim, monkeypatch):
    # the student's f32 convolutions must not run in TF32 even where the
    # caller allows it (1e-5 x max |logit|, which the same forward with the
    # model's guard bypassed must miss); its bf16 masks may differ from the
    # f32 ones only where |f32 logit| < 2 (the f32 student under 88 % sure)
    import contextlib

    from nm03_capstone_project_tpu_torch import models as pm
    from nm03_capstone_project_tpu_torch.models import unet as unet_mod

    init = pm.init_unet if ndim == 2 else pm.init_unet3d
    model = init(torch.Generator().manual_seed(0), base=16, device="cpu")
    slices = [phantom_slice(256, 256, seed=s, lesion_radius=0.12) for s in range(8)]
    x = pm.prepare_student_inputs(pad_to_canvas(slices, (256, 256), device="cpu").pixels)
    if ndim == 3:
        x = x[None]
    with torch.no_grad():
        want = model(x, torch.float32)
    card = model.to(cuda)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            f32 = card(x.to(cuda), torch.float32).cpu()
            assert torch.backends.cudnn.allow_tf32  # restored by the model
            bf16 = card(x.to(cuda), torch.bfloat16).cpu()
            monkeypatch.setattr(unet_mod, "conv_precision",
                                lambda dtype, device: contextlib.nullcontext())
            tf32 = card(x.to(cuda), torch.float32).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert f32.dtype == bf16.dtype == torch.float32
    bound = 1e-5 * float(want.abs().max())
    assert float((f32 - want).abs().max()) <= bound
    assert float((tf32 - want).abs().max()) > bound
    differ = (bf16 > 0) != (f32 > 0)
    assert not bool(differ[f32.abs() >= 2.0].any())


# one process's run of the three kernels on seeded inputs: each output's
# sha256, whether it equals its plain version, and where each library came from
_CACHE_RUN = r'''
import hashlib, json, sys
import torch
from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter
from nm03_capstone_project_tpu_torch.ops.region_growing import region_grow
pre = json.loads(sys.argv[1])
g = torch.Generator().manual_seed(11)
x = (torch.rand(3, 251, 241, generator=g) * 4000 + 0.68).cuda()
img = hm._fused_preprocess_plain(x, **pre)
seeds = torch.zeros(img.shape, dtype=torch.bool)
seeds[:, 120, 120] = True
seeds = seeds.cuda()
got = {"median": hm.vector_median_filter_kernel(x, 7),
       "fused": hm.fused_preprocess_kernel(x, **pre),
       "grow": hg.region_grow_kernel(img, seeds, 0.74, 0.91)[0]}
plain = {"median": vector_median_filter(x, 7), "fused": img,
         "grow": region_grow(img, seeds, 0.74, 0.91)[0]}
torch.cuda.synchronize()
print(json.dumps({
    "sha": {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest() for k, v in got.items()},
    "plain_equal": {k: bool(torch.equal(got[k], plain[k])) for k in got},
    "sources": {n: r["source"] for n, r in build.records().items()}}))
'''


def test_a_cached_library_runs_bitwise_like_a_fresh_build(cuda, tmp_path):
    """A real nvcc build published into a fresh cache, then loaded from it
    by a process that cannot reach nvcc, gives every kernel's output
    bitwise, and each equals its plain version."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    from nm03_capstone_project_tpu_torch.compilehub import ENV_CACHE_DIR, scan_entries

    repo = pathlib.Path(__file__).resolve().parents[1]
    cache = tmp_path / "cache"

    def run(env):
        proc = subprocess.run([sys.executable, "-c", _CACHE_RUN, json.dumps(PRE)], cwd=repo,
                              env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    env = dict(os.environ, **{ENV_CACHE_DIR: str(cache)})
    cold = run(env)
    assert cold["sources"] == {"fused": "built", "grow": "built", "median": "built"}
    assert [r["status"] for r in scan_entries(cache)] == ["ok"] * 3
    no_nvcc = dict(env, CUDA_HOME=str(tmp_path / "no-toolkit"), PATH=os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(p, "nvcc"))))
    warm = run(no_nvcc)
    assert warm["sources"] == {"fused": "cache", "grow": "cache", "median": "cache"}
    assert warm["sha"] == cold["sha"]
    assert all(cold["plain_equal"].values()) and all(warm["plain_equal"].values())


# -- the routes over the JAX package's whole envelope (tests/test_torch_envelope.py) --


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("k", [17, 21, 31])
def test_median_select_windows(cuda, k):
    x = (torch.rand(3, 251, 241) * 4000 + 0.68).to(cuda)
    dup = (torch.randint(-2, 3, (2, 61, 300)).float()).to(cuda)  # duplicates, both signs
    before = hm.vector_median_select_kernel.launches
    for inp in (x, dup):
        assert _same_bits(hm.vector_median_filter_kernel(inp, k), vector_median_filter(inp, k))
    assert hm.vector_median_select_kernel.launches == before + 2


@pytest.mark.parametrize("k", [7, 17])
def test_median_batch_past_the_grid_splits(cuda, k):
    x = (torch.rand(hm.MAX_BATCH + 100, 8, 8) * 4000).to(cuda)
    counters = (hm.vector_median_filter_kernel, hm.vector_median_select_kernel)
    before = sum(fn.launches for fn in counters)
    assert _same_bits(hm.vector_median_filter_kernel(x, k), vector_median_filter(x, k))
    assert sum(fn.launches for fn in counters) == before + 2


def test_median_select_signed_zeros_and_nan(cuda):
    rng = np.random.default_rng(5)
    z = torch.from_numpy(rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32),
                                    size=(4, 40, 40), p=[0.35, 0.35, 0.15, 0.15])).to(cuda)
    z[0, 5, 5] = float("nan")
    for k in (17, 19):
        got, want = hm.vector_median_filter_kernel(z, k), vector_median_filter(z, k)
        assert _same_bits(got, want)
        assert bool((torch.signbit(want) & (want == 0)).any()) and bool(torch.isnan(want).any())


@pytest.mark.parametrize("k,ks", [(17, 9), (7, 33), (31, 35)])
def test_fused_unfused_route(cuda, k, ks):
    x = (torch.rand(3, 251, 241) * 9000).to(cuda)
    kw = dict(PRE, median_window=k, sharpen_kernel=ks)
    fused = hm.fused_preprocess_kernel.launches
    assert _same_bits(hm.fused_preprocess_kernel(x, **kw), hm._fused_preprocess_plain(x, **kw))
    assert hm.fused_preprocess_kernel.launches == fused  # no fused launch: the unfused route


@pytest.mark.parametrize("hw", [(2304, 2304), (1024, 4096), (512, 8192)])
def test_grow_global_route(cuda, hw):
    g = torch.Generator().manual_seed(hw[1])
    img = (torch.rand((2, *hw), generator=g) * 0.3 + 0.68).to(cuda)
    seeds = (torch.rand((2, *hw), generator=g) < 0.0005).to(cuda)
    valid = (torch.rand((2, *hw), generator=g) < 0.95).to(cuda)
    assert hg.grow_launch_shape(*hw).route == "global"
    before = hg.region_grow_global_kernel.launches
    for conn in (4, 8):
        kw = dict(valid=valid, connectivity=conn, block_iters=4, return_steps=True)
        got = hg.region_grow_kernel(img, seeds, **kw)
        want = region_grow(img, seeds, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert hg.region_grow_global_kernel.launches == before + 2


@pytest.mark.parametrize("bi,mi", [(16, 1024), (2, 4), (3, 7)])
def test_grow_global_kernel_follows_the_schedule(cuda, bi, mi):
    # the global route on a slice the cluster kernel would take: the same
    # schedule's mask, flags and steps, a block cut short by max_iters too
    img, seeds, valid = (torch.from_numpy(a).to(cuda) for a in _grow_case())
    kw = dict(valid=valid, block_iters=bi, max_iters=mi, return_steps=True)
    got = hg.region_grow_global_kernel(img, seeds, 0.74, 0.91, **kw)
    want = region_grow(img, seeds, 0.74, 0.91, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_pipeline_at_canvas_3072_k17_equals_the_jax_golden(cuda):
    import hashlib
    import json
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    golden = json.loads(
        (root / "nm03_capstone_project_tpu_torch" / "testdata" / "envelope_golden.json")
        .read_text())
    case = golden["case"]
    slices = [phantom_slice(h, w, seed=s, lesion_radius=case["lesion_radius"])
              for (h, w), s in zip(case["dims"], case["seeds"])]
    c = case["canvas"]
    b = pad_to_canvas(slices, (c, c), device=cuda)
    out = process_batch(b.pixels, b.dims, PipelineConfig(canvas=c,
                                                         median_window=case["median_window"]))
    masks = out["mask"].cpu().numpy()
    got = [{"sha256": hashlib.sha256(m.tobytes()).hexdigest(), "area": int(m.sum()),
            "converged": bool(cv)} for m, cv in zip(masks, out["grow_converged"].tolist())]
    assert got == golden["slices"]
