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
    # past the old side limit of 16,384 the global route takes the slice
    # (seeds none: it grows nothing); an empty slice is refused before launch
    huge = torch.full((1, 16385, 2304), 0.8, device=cuda)
    launches = hg.region_grow_kernel.launches, hg.region_grow_global_kernel.launches
    mask, conv = hg.region_grow_kernel(huge, huge > 0.9)
    assert int(mask.sum()) == 0 and bool(conv.all())
    assert (hg.region_grow_kernel.launches, hg.region_grow_global_kernel.launches) == (
        launches[0], launches[1] + 1)
    with pytest.raises(ValueError, match="0x2304"):
        hg.region_grow_kernel(huge[:, :0], huge[:, :0] > 0.9)
    assert hg.region_grow_global_kernel.launches == launches[1] + 1


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
        # the seed/valid and finish kernels once a replay besides the path's
        assert g.kernels == ({"fused": 1, "grow": 1} if fuse else {"median": 1, "grow": 1}) | {
            "seeds": 1, "finish": 1}
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


# the profiler window of the test below, in a process of its own: after about
# a million launches outside profiler windows (the earlier card tests), a
# later window of the same process can lose kernel records
_REPLAY_WINDOW = """
import json, sys
from pathlib import Path
import numpy as np, torch
from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.serving.graphs import BucketGraph, record_kernel_sequence
from nm03_capstone_project_tpu_torch.utils import profiling
fuse, out = sys.argv[1] == "1", Path(sys.argv[2])
batch = np.load(out / "batch.npz")
cuda = torch.device("cuda")
cfg = PipelineConfig(fuse_preprocess=fuse)
pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(cuda)
g = BucketGraph(cfg, 4, cuda, pool, stream)
g.capture()
seq = record_kernel_sequence(cfg, 4, cuda, stream)
with profiling.exclusive_profiler() as prof:
    for _ in range(3):
        g.launch(batch["px"], batch["dm"])
        g.fetch()
prof.export_chrome_trace(str(out / "replays.json"))
(out / "seq.json").write_text(json.dumps(seq))
"""


@pytest.mark.parametrize("fuse", [True, False])
def test_graph_replay_under_the_profiler_names_the_kernels(cuda, fuse, tmp_path):
    # a replay is one cudaGraphLaunch: CUPTI must still report each kernel
    # node by name, or the ledger's stage pie cannot see median7 and grow.
    # The window runs first in a fresh process (_REPLAY_WINDOW)
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from nm03_capstone_project_tpu_torch.obs import ledger

    px, dm = _serve_batch(4, seed=1)
    np.savez(tmp_path / "batch.npz", px=px, dm=dm)
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(repo)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    res = subprocess.run([sys.executable, "-c", _REPLAY_WINDOW, "1" if fuse else "0",
                          str(tmp_path)], cwd=repo, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    events = json.loads((tmp_path / "replays.json").read_text())["traceEvents"]
    seq = [tuple(e) for e in json.loads((tmp_path / "seq.json").read_text())]
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
def test_process_volume_takes_the_wide_route(cuda, fuse):
    # k = 65: the volume path's preprocess reaches the wide median kernel,
    # once over the study's planes, through the split route (then the
    # sharpen kernel) or the median dispatch, with no code of its own;
    # masks equal to the plain ops
    from nm03_capstone_project_tpu_torch.pipeline import process_volume

    # lesions wide enough to outlive a 65 x 65 median (over 65 * 65 / 2 pixels)
    vol = np.zeros((4, 128, 128), np.float32)
    vol[:, :120, :112] = [phantom_slice(120, 112, lesion_radius=0.3, seed=5 + i)
                          for i in range(4)]
    dims = np.asarray([120, 112], np.int32)
    cfg = PipelineConfig(canvas=128, min_dim=32, median_window=65, fuse_preprocess=fuse)
    kernels = (hm.fused_preprocess_kernel, hm.vector_median_wide_kernel)
    before = tuple(fn.launches for fn in kernels)
    got = process_volume(vol, dims, cfg)
    ran = tuple(fn.launches - b for fn, b in zip(kernels, before))
    want = process_volume(vol, dims, PipelineConfig(canvas=128, min_dim=32, median_window=65,
                                                    fuse_preprocess=fuse, use_kernels=False))
    assert torch.equal(got["mask"], want["mask"]) and int(got["mask"].sum()) > 0
    assert bool(got["grow_converged"]) is bool(want["grow_converged"])
    assert ran == (0, 1)


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


# one process's run of the five kernel libraries on seeded inputs: each
# output's sha256, whether it equals its plain version, and where each
# library came from
_CACHE_RUN = r'''
import hashlib, json, sys
import torch
from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.ops import hopper_masks as hk
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
from nm03_capstone_project_tpu_torch.ops import hopper_volume as hv
from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter
from nm03_capstone_project_tpu_torch.ops.region_growing import region_grow
from nm03_capstone_project_tpu_torch.ops.volume import region_grow_3d
pre = json.loads(sys.argv[1])
g = torch.Generator().manual_seed(11)
x = (torch.rand(3, 251, 241, generator=g) * 4000 + 0.68).cuda()
img = hm._fused_preprocess_plain(x, **pre)
seeds = torch.zeros(img.shape, dtype=torch.bool)
seeds[:, 120, 120] = True
seeds = seeds.cuda()
dims = torch.tensor([[251, 241], [197, 233], [9, 5]], dtype=torch.int32).cuda()
grown = region_grow(img, seeds, 0.74, 0.91)[0]
got = {"median": hm.vector_median_filter_kernel(x, 7),
       "fused": hm.fused_preprocess_kernel(x, **pre),
       "grow": hg.region_grow_kernel(img, seeds, 0.74, 0.91)[0],
       "grow3d": hv.region_grow_3d_kernel(img, seeds, 0.74, 0.91)[0],
       "seeds": torch.stack(hk.seed_valid_masks_kernel(dims, (251, 241))),
       "finish": hk.finish_mask_kernel(grown, dims, 3)}
plain = {"median": vector_median_filter(x, 7), "fused": img, "grow": grown,
         "grow3d": region_grow_3d(img, seeds, 0.74, 0.91)[0],
         "seeds": torch.stack(hk.seed_valid_masks_plain(dims, (251, 241))),
         "finish": hk.finish_mask_plain(grown, dims, 3)}
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
    from nm03_capstone_project_tpu_torch.kernels import build

    repo = pathlib.Path(__file__).resolve().parents[1]
    cache = tmp_path / "cache"

    def run(env):
        proc = subprocess.run([sys.executable, "-c", _CACHE_RUN, json.dumps(PRE)], cwd=repo,
                              env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return json.loads(proc.stdout.strip().splitlines()[-1])

    env = dict(os.environ, **{ENV_CACHE_DIR: str(cache)})
    cold = run(env)
    assert cold["sources"] == dict.fromkeys(build.SOURCES, "built")
    assert [r["status"] for r in scan_entries(cache)] == ["ok"] * len(build.SOURCES)
    no_nvcc = dict(env, CUDA_HOME=str(tmp_path / "no-toolkit"), PATH=os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if not os.path.exists(os.path.join(p, "nvcc"))))
    warm = run(no_nvcc)
    assert warm["sources"] == dict.fromkeys(build.SOURCES, "cache")
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


def test_median_select_at_the_limit(cuda):
    # MAX_SELECT_WINDOW: the select kernel's largest shared tile (226,000 bytes)
    x = (torch.rand(2, 256, 256) * 4000 + 0.68).to(cuda)
    k = hm.MAX_SELECT_WINDOW
    before = hm.vector_median_select_kernel.launches
    assert _same_bits(hm.vector_median_filter_kernel(x, k), vector_median_filter(x, k))
    assert hm.vector_median_select_kernel.launches == before + 1


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


def _median_route(k):
    return (hm.vector_median_filter_kernel if k <= hm.MAX_WINDOW else
            hm.vector_median_select_kernel if k <= hm.MAX_SELECT_WINDOW else
            hm.vector_median_wide_kernel)


@pytest.mark.parametrize("k,ks", [(17, 9), (7, 33), (31, 35), (65, 9), (15, 65), (127, 33)])
def test_fused_split_route(cuda, k, ks):
    # two launches and no torch op: the window's median with normalize and
    # clip on load, then the sharpen kernel
    x = (torch.rand(3, 251, 241) * 9000).to(cuda)
    kw = dict(PRE, median_window=k, sharpen_kernel=ks)
    counters = (hm.fused_preprocess_kernel, _median_route(k), hm.sharpen_filter_kernel)
    before = [fn.launches for fn in counters]
    assert _same_bits(hm.fused_preprocess_kernel(x, **kw), hm._fused_preprocess_plain(x, **kw))
    assert [fn.launches - b for fn, b in zip(counters, before)] == [0, 1, 1]


@pytest.mark.parametrize("ks", range(1, 66, 2))
def test_sharpen_kernel_taps(cuda, ks):
    # odd canvases, and one shorter than the sharpen's halo on both sides
    from nm03_capstone_project_tpu_torch.ops.sharpen import sharpen

    g = torch.Generator().manual_seed(ks)
    for shape in [(3, 251, 241), (2, 37, 300), (2, 5, 7), (1, 1, 1)]:
        x = (torch.rand(shape, generator=g) * 4000 + 0.68).to(cuda)
        before = hm.sharpen_filter_kernel.launches
        got = hm.sharpen_filter_kernel(x, 2.0, 0.5, ks)
        assert _same_bits(got, sharpen(x, 2.0, 0.5, ks)), shape
        assert hm.sharpen_filter_kernel.launches == before + 1


@pytest.mark.parametrize("ks", [177, 179, 257, 1025])
def test_sharpen_kernel_past_the_staged_tile(cuda, ks):
    # past 177 taps: the rows of one pass staged, the median read through L1
    from nm03_capstone_project_tpu_torch.ops.sharpen import sharpen

    x = (torch.rand(2, 256, 256, generator=torch.Generator().manual_seed(ks)) * 4000).to(cuda)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert hm.sharpen_launch_shape(2, 256, 256, ks, n_sm).staged == (ks <= 177)
    assert _same_bits(hm.sharpen_filter_kernel(x, 2.0, 0.5, ks), sharpen(x, 2.0, 0.5, ks))


@pytest.mark.parametrize("ks,shape,tile_h,scratch", [
    (5001, (2, 37, 70), 8, False),  # V of 8-row tiles in shared memory
    (58201, (2, 3, 70), 1, True),  # one row of V a CTA in a device scratch
])
def test_sharpen_kernel_short_tiles_and_scratch(cuda, ks, shape, tile_h, scratch):
    from nm03_capstone_project_tpu_torch.ops.sharpen import sharpen

    x = (torch.rand(shape, generator=torch.Generator().manual_seed(ks)) * 4000).to(cuda)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    sl = hm.sharpen_launch_shape(*shape, ks, n_sm)
    assert (sl.staged, sl.tile_h, bool(sl.scratch)) == (False, tile_h, scratch)
    before = hm.sharpen_filter_kernel.launches
    assert _same_bits(hm.sharpen_filter_kernel(x, 2.0, 0.5, ks), sharpen(x, 2.0, 0.5, ks))
    assert hm.sharpen_filter_kernel.launches == before + 1


@pytest.mark.parametrize("ks", [1, 3, 9, 17, 33])
def test_sharpen_kernel_windowed_rows_and_walks(cuda, ks):
    # the windowed plan on widths with W % 4 = 0, 1, 2 and 3, canvases
    # shorter than the halo, a base 4 bytes past 16-byte alignment (every
    # row off it), and grids of 1 and 3 CTAs that walk every tile
    from nm03_capstone_project_tpu_torch.kernels import build
    from nm03_capstone_project_tpu_torch.ops.sharpen import sharpen

    g = torch.Generator().manual_seed(ks)
    lib = build.load("fused")
    taps = hm._device_taps(0.5, ks, cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for shape in [(2, 40, 256), (3, 37, 301), (2, 21, 302), (2, 70, 303), (2, 3, 5), (1, 2, 9)]:
        n = int(np.prod(shape))
        data = (torch.rand(n, generator=g) * 4000 + 0.68).to(cuda)
        base = torch.empty(n + 1, device=cuda)
        base[1:] = data
        for x in (data.view(shape), base[1:].view(shape)):
            want = sharpen(x, 2.0, 0.5, ks)
            before = hm.sharpen_filter_kernel.launches
            assert _same_bits(hm.sharpen_filter_kernel(x, 2.0, 0.5, ks), want), shape
            assert hm.sharpen_filter_kernel.launches == before + 1
            sl = hm.sharpen_launch_shape(*shape, ks, n_sm)
            assert sl.plan == "windowed"
            for grid in (1, 3):
                out = torch.full_like(x, float("nan"))
                build.check(lib.nm03_sharpen(
                    x.data_ptr(), out.data_ptr(), taps.data_ptr(), None, *shape, ks, 2.0,
                    sl.tile_h, sl.tile_w, hm.PLANS.index("windowed"), grid, stream),
                    "nm03_sharpen")
                torch.cuda.synchronize()
                assert _same_bits(out, want), (shape, grid, x.data_ptr() % 16)


def _prologue_case(k):
    """NaNs, infinities, signed zeros and ±1 that survive normalize (a low
    end of -0.0) and a clip around 0, so the median meets -0.0 and +0.0."""
    rng = np.random.default_rng(k)
    z = rng.choice(np.array([-0.0, 0.0, 1000.0, -1000.0, 5000.0], np.float32),
                   size=(4, 48, 80), p=[0.3, 0.3, 0.15, 0.15, 0.1])
    z[0, 5, 5] = np.float32("nan")
    z[1, 30, 60] = np.float32("inf")
    z[2, 7, 70] = np.float32("-inf")
    kw = dict(norm_low=-0.0, norm_high=2.0, norm_min=0.0, norm_max=4000.0, clip_low=-1.0,
              clip_high=1.0)
    return torch.from_numpy(z), kw


@pytest.mark.parametrize("k", [17, 65])
def test_the_median_prologue_with_nans_and_signed_zeros(cuda, k):
    from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize

    z, kw = _prologue_case(k)
    z = z.to(cuda)
    pro = hm.Prologue.of(**kw)
    want = vector_median_filter(clip_intensity(
        normalize(z, kw["norm_low"], kw["norm_high"], kw["norm_min"], kw["norm_max"]),
        kw["clip_low"], kw["clip_high"]), k)
    before = _median_route(k).launches
    got = hm.vector_median_filter_kernel(z, k, pro)
    assert _median_route(k).launches == before + 1
    assert _same_bits(got, want)
    zero = want == 0
    assert bool((zero & torch.signbit(want)).any()) and bool((zero & ~torch.signbit(want)).any())
    assert bool(torch.isnan(want).any())
    # the whole route over the same input: NaN spreads through the blur
    # the same way in both
    full = dict(PRE, **kw, median_window=k)
    assert _same_bits(hm.fused_preprocess_kernel(z, **full), hm._fused_preprocess_plain(z, **full))


@pytest.mark.parametrize("k,ks", [(17, 9), (65, 9), (7, 33)])
def test_split_replays_in_a_cuda_graph(cuda, k, ks):
    # the split route captured after one eager call on the capture stream
    # (the taps' device buffer and the kernels' attributes), its median
    # buffer from the graph's pool, replayed on new inputs bitwise
    kw = dict(PRE, median_window=k, sharpen_kernel=ks)
    g = torch.Generator(device="cpu").manual_seed(k + ks)
    static = (torch.rand(2, 256, 256, generator=g) * 9000).to(cuda)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        hm.fused_preprocess_kernel(static, **kw)
    torch.cuda.current_stream(cuda).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    counters = (_median_route(k), hm.sharpen_filter_kernel)
    before = [fn.launches for fn in counters]
    with torch.cuda.graph(graph, stream=stream):
        out = hm.fused_preprocess_kernel(static, **kw)
    assert [fn.launches - b for fn, b in zip(counters, before)] == [1, 1]
    for rnd in range(2):
        new = (torch.rand(2, 256, 256, generator=g) * 9000).to(cuda)
        static.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(out, hm._fused_preprocess_plain(new, **kw)), rnd


@pytest.mark.parametrize("hw", [(2304, 2304), (1024, 4096), (512, 8192), (16385, 2304),
                                (2304, 16385)])
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


def test_grow_global_past_the_resident_tiles(cuda):
    # 8192 x 8192 x 2: more tiles than SMs, so every CTA walks two a super-step
    g = torch.Generator().manual_seed(8192)
    img = (torch.rand((2, 8192, 8192), generator=g) * 0.2 + 0.72).to(cuda)
    seeds = torch.zeros((2, 8192, 8192), dtype=torch.bool)
    seeds[0, 4096, 4096] = seeds[1, 10, 8000] = True
    seeds = seeds.to(cuda)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert not hg.global_tiles(2, 8192, 8192, 16, n_sm).resident
    before = hg.region_grow_global_kernel.launches
    kw = dict(block_iters=16, max_iters=1024, return_steps=True)
    got = hg.region_grow_kernel(img, seeds, **kw)
    want = region_grow(img, seeds, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert hg.region_grow_global_kernel.launches == before + 1


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


# -- the last limits: the median past MAX_SELECT_WINDOW, grow at any size, every
# -- route inside the served graphs


@pytest.mark.parametrize("k,shape", [(65, (2, 256, 256)), (127, (1, 64, 64))])
def test_median_wide_windows(cuda, k, shape):
    x = (torch.rand(shape) * 4000 + 0.68).to(cuda)
    dup = torch.randint(-2, 3, shape).float().to(cuda)  # duplicates, both signs
    before = hm.vector_median_wide_kernel.launches
    assert hm.median_launch_shape(*shape, k).route == "wide" and hm.wide_shared(k)
    for inp in (x, dup):
        assert _same_bits(hm.vector_median_filter_kernel(inp, k), vector_median_filter(inp, k))
    assert hm.vector_median_wide_kernel.launches == before + 2


def test_median_wide_in_a_device_scratch(cuda):
    # k = 257: the segments do not fit a block, they sit in a device scratch.
    # The plain network at this window is some 5 million min/max, so the
    # plain sort median holds it: the same bits on finite data without
    # signed zeros (ops/median.py)
    from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter_sort

    x = (torch.rand(1, 64, 64) * 4000 + 0.68).to(cuda)
    assert not hm.wide_shared(257)
    before = hm.vector_median_wide_kernel.launches
    got = hm.vector_median_filter_kernel(x, 257)
    assert _same_bits(got, vector_median_filter_sort(x, 257))
    assert hm.vector_median_wide_kernel.launches == before + 1


def test_median_wide_signed_zeros_and_nan(cuda):
    rng = np.random.default_rng(65)
    z = torch.from_numpy(rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32),
                                    size=(4, 40, 40), p=[0.35, 0.35, 0.15, 0.15])).to(cuda)
    z[0, 5, 5] = float("nan")
    got, want = hm.vector_median_filter_kernel(z, 65), vector_median_filter(z, 65)
    assert _same_bits(got, want)
    assert bool((torch.signbit(want) & (want == 0)).any()) and bool(torch.isnan(want).any())


def _key_sort_median(x, k):
    """Each window's rank-(k*k // 2) order-preserving key (the kernels' keys,
    by kthvalue, not by their bisection); a NaN window's first NaN."""
    r, out = k // 2, torch.empty_like(x)
    for b in range(x.shape[0]):
        xp = torch.nn.functional.pad(x[b][None, None], (r, r, r, r), mode="replicate")
        meds = []
        for w in torch.nn.functional.unfold(xp, k)[0].t().split(1024):
            u = w.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
            key = torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
            mid = key.kthvalue((k * k) // 2 + 1, dim=1).values
            bits = torch.where(mid >= 0x80000000, mid & 0x7FFFFFFF, ~mid & 0xFFFFFFFF)
            med = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
            nan = torch.isnan(w)
            first = w.gather(1, nan.to(torch.uint8).argmax(dim=1, keepdim=True))[:, 0]
            meds.append(torch.where(nan.any(dim=1), first, med.view(torch.float32)))
        out[b] = torch.cat(meds).view(x.shape[-2:])
    return out


def _signed_keys(k):
    """(2, 24, 260) of signed zeros, ±1 and negatives; slice 0 holds a NaN
    at (10, 200) and a negative NaN at (2, 255): at k >= 223 windows with
    neither, with the first, and with both (the negative one first)."""
    rng = np.random.default_rng(k)
    z = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0, -3.5], np.float32), size=(2, 24, 260),
                   p=[0.25, 0.25, 0.2, 0.2, 0.1])
    z = np.where(z < -2, z + rng.random(z.shape).astype(np.float32), z)
    z[0, 10, 200] = np.float32("nan")
    z[0, 2, 255] = np.array(0xFFC00000, np.uint32).view(np.float32)
    return torch.from_numpy(z)


def _check_signed_keys(x, k):
    before = hm.vector_median_wide_kernel.launches
    got = hm.vector_median_filter_kernel(x, k)
    assert hm.vector_median_wide_kernel.launches == before + 1
    want = _key_sort_median(x, k)
    assert _same_bits(got, want)
    zero, nan = want == 0, torch.isnan(want)
    assert bool((zero & torch.signbit(want)).any()) and bool((zero & ~torch.signbit(want)).any())
    assert bool((nan & torch.signbit(want)).any()) and bool((nan & ~torch.signbit(want)).any())
    assert not bool(nan[1].any())


def test_median_wide_signed_keys_in_shared_memory(cuda):
    # k = 223, segments in shared memory: signed zeros, negatives and NaNs
    # of both signs against a sort of the same keys
    assert hm.wide_shared(223)
    _check_signed_keys(_signed_keys(223).to(cuda), 223)


@pytest.mark.parametrize("k", [65, 127, 223, 225, 227])
def test_the_wide_occupancy_comes_from_the_runtime(cuda, k):
    # the CTAs an SM holds at once with the segments in shared memory, as
    # the runtime counts them (threads, registers, shared memory): never
    # more than threads and shared memory allow; one where they are in scratch
    per_sm = hm._wide_ctas_per_sm(cuda.index or 0, k)
    if hm.wide_shared(k):
        assert 1 <= per_sm <= min(2048 // hm.WIDE_THREADS,
                                  233472 // (hm.wide_segment_bytes(k) + 1024))
    else:
        assert per_sm == 1
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert hm.wide_launch_shape(2, 256, 256, k, n_sm, per_sm).grid <= n_sm * per_sm


@pytest.mark.parametrize("k", [225, 227])
def test_median_wide_either_side_of_the_shared_memory_switch(cuda, k):
    # 225: the last window whose segments fit a block; 227: the first in the
    # device scratch. Random data against the plain sort median, and the
    # signed keys against a sort of the same keys
    from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter_sort

    assert hm.wide_shared(k) == (k == 225)
    x = (torch.rand(1, 64, 64) * 4000 + 0.68).to(cuda)
    assert _same_bits(hm.vector_median_filter_kernel(x, k), vector_median_filter_sort(x, k))
    _check_signed_keys(_signed_keys(k).to(cuda), k)


@pytest.mark.parametrize("k", [65, 227])
def test_median_wide_replays_in_a_cuda_graph(cuda, k):
    # the wide route captured (its scratch, where it has one, from the
    # graph's pool) and replayed on new inputs: each replay bitwise equal to
    # the eager call
    g = torch.Generator(device="cpu").manual_seed(k)
    shape = (2, 256, 256) if k == 65 else (1, 64, 64)
    static = (torch.rand(shape, generator=g) * 4000 + 0.68).to(cuda)
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        hm.vector_median_filter_kernel(static, k)  # warm: build, attributes
    torch.cuda.current_stream(cuda).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = hm.vector_median_wide_kernel.launches
    with torch.cuda.graph(graph, stream=stream):
        out = hm.vector_median_filter_kernel(static, k)
    assert hm.vector_median_wide_kernel.launches == before + 1
    for rnd in range(2):
        new = (torch.rand(shape, generator=g) * 4000 + 0.68).to(cuda)
        if rnd:
            new = torch.randint(-2, 3, shape, generator=g).float().to(cuda)
        static.copy_(new)
        graph.replay()
        torch.cuda.synchronize()
        assert _same_bits(out, hm.vector_median_filter_kernel(new, k)), rnd
    assert hm.vector_median_wide_kernel.launches == before + 3


def test_median_wide_batch_past_the_grid_splits(cuda):
    # 2 x 2 slices: the plain network's live values at k = 65 (thousands of
    # arrays of the input's size) must fit the card beside the kernel's
    x = (torch.rand(hm.MAX_BATCH + 100, 2, 2) * 4000).to(cuda)
    before = hm.vector_median_wide_kernel.launches
    assert _same_bits(hm.vector_median_filter_kernel(x, 65), vector_median_filter(x, 65))
    assert hm.vector_median_wide_kernel.launches == before + 2


def test_grow_past_two_to_the_31_pixels(cuda):
    # 6 slices of 20,000 x 20,000: 2.4e9 pixels in one launch, past 2^31, and
    # each slice past the old side limit of 16,384; held slice by slice to
    # the plain grow, which cannot hold the whole batch's temporaries
    b, h, w = 6, 20000, 20000
    g = torch.Generator(device=cuda).manual_seed(20000)
    img = torch.rand((b, h, w), generator=g, device=cuda) * 0.3 + 0.68
    seeds = torch.rand((b, h, w), generator=g, device=cuda) < 0.0005
    assert b * h * w > 2**31 and hg.grow_launch_shape(h, w).route == "global"
    before = hg.region_grow_global_kernel.launches
    kw = dict(block_iters=4, max_iters=64, return_steps=True)
    mask, conv, steps = hg.region_grow_kernel(img, seeds, **kw)
    assert hg.region_grow_global_kernel.launches == before + 1
    for i in range(b):
        want = region_grow(img[i:i + 1], seeds[i:i + 1], **kw)
        for got, ref in zip((mask[i:i + 1], conv[i:i + 1], steps[i:i + 1]), want):
            assert torch.equal(got, ref), i
        del want
    assert int(mask[-1, -1].sum()) > 0  # the last row of the last slice, past 2^31


def _phantom_batch(b, canvas, seed):
    """b phantoms on a canvas: the first of full size, the rest smaller."""
    dims = [(canvas, canvas)] + [(canvas - canvas // (8 + i), canvas - canvas // (5 + i))
                                 for i in range(b - 1)]
    slices = [phantom_slice(h, w, seed=seed + i, lesion_radius=0.12)
              for i, (h, w) in enumerate(dims)]
    batch = pad_to_canvas(slices, (canvas, canvas), device="cpu")
    return batch.pixels.numpy(), batch.dims.numpy()


@pytest.mark.parametrize("canvas,k,held", [
    (3072, 7, {"fused": 1, "grow_global": 1}),
    (3072, 17, {"median_select": 1, "sharpen": 1, "grow_global": 1}),
    (256, 65, {"median_wide": 1, "sharpen": 1, "grow": 1}),
])
def test_bucket_graphs_hold_every_route(cuda, canvas, k, held):
    # the global grow (a cooperative launch, its scratch zeroed inside the
    # graph), the split route's select and wide median (normalize and clip
    # on load) and its sharpen kernel, captured and replayed twice on new inputs: each replay
    # bitwise equal to eager _process with the kernels and to the plain ops
    from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import _process
    from nm03_capstone_project_tpu_torch.serving.graphs import BucketGraph

    cfg = PipelineConfig(canvas=canvas, median_window=k)
    plain = PipelineConfig(canvas=canvas, median_window=k, use_kernels=False)
    pool, stream = torch.cuda.graph_pool_handle(), torch.cuda.Stream(cuda)
    graphs = {b: BucketGraph(cfg, b, cuda, pool, stream) for b in (1, 2)}
    for g in graphs.values():
        assert g.capture() > 0 and g.kernels == held | {"seeds": 1, "finish": 1}
    for rnd in range(2):
        for b, g in graphs.items():
            px, dm = _phantom_batch(b, canvas, seed=40 + 10 * rnd + b)
            g.launch(px, dm)
            mask, conv = g.fetch()
            x, d = torch.from_numpy(px).to(cuda), torch.from_numpy(dm).to(cuda)
            for want_cfg in (cfg, plain):
                want = _process(x, d, want_cfg)
                assert np.array_equal(mask, want["mask"].cpu().numpy()), (b, rnd, want_cfg)
                assert np.array_equal(conv, want["grow_converged"].cpu().numpy())
            assert int(mask.sum()) > 0
    assert all(g.replays == 2 for g in graphs.values())


def test_two_lanes_serve_the_global_route_at_once(cuda):
    # two lanes on the one card, each with its own stream and graphs, four
    # requests in flight: cooperative grids of both lanes may run at once
    import hashlib
    from concurrent.futures import ThreadPoolExecutor

    from nm03_capstone_project_tpu_torch.serving.server import ServingApp

    canvas = 3072
    cfg = PipelineConfig(canvas=canvas)
    app = ServingApp(cfg=cfg, buckets=(1, 2), max_wait_s=0.05, lane_devices=[cuda, cuda],
                     result_cache_bytes=1 << 28)
    app.start()
    try:
        px, dm = _phantom_batch(4, canvas, seed=60)
        want = process_batch(torch.from_numpy(px).to(cuda), torch.from_numpy(dm).to(cuda),
                             PipelineConfig(canvas=canvas, use_kernels=False))["mask"]
        want = want.cpu().numpy()

        def one(i):
            h, w = dm[i].tolist()
            return app.segment(px[i, :h, :w].copy(), render=False)

        with ThreadPoolExecutor(4) as pool:
            payloads = list(pool.map(one, [0, 1, 2, 3, 0, 1, 2, 3]))
        for i, payload in enumerate(payloads):
            h, w = dm[i % 4].tolist()
            m = np.ascontiguousarray(want[i % 4, :h, :w])
            assert payload["mask_sha256"] == hashlib.sha256(m.tobytes()).hexdigest(), i
        assert app.executor.replay_launches().get("grow_global", 0) >= 2
        lanes = {p["lane"] for p in payloads}
        assert lanes == {0, 1}, lanes
    finally:
        app.begin_drain(reason="test")
        app.close()


# -- the 3D grow kernel (csrc/grow3d.cu) against the plain loop --------------------


def _maze3d(shape, cuda, seed, fill=0.45):
    """Voxels in band with probability ``fill`` (above the percolation
    threshold, so the growth winds for many blocks), a few seeds, and
    a valid mask of one plane cutting the last columns."""
    g = torch.Generator().manual_seed(seed)
    vol = torch.where(torch.rand(shape, generator=g) < fill, 0.8, 0.5)
    seeds = torch.rand(shape[-2:], generator=g) < 0.002
    seeds[0, 0] = True
    vol[..., 0, 0] = 0.8
    valid = torch.ones(shape[-2:], dtype=torch.bool)
    if shape[-1] > 4:
        valid[:, -3:] = False
    return (vol.float().to(cuda), seeds.expand(shape).to(cuda),
            valid.expand(shape).to(cuda))


def _grow3d_same(cuda, vol, seeds, valid, **kw):
    from nm03_capstone_project_tpu_torch.ops import hopper_volume as hv
    from nm03_capstone_project_tpu_torch.ops.volume import region_grow_3d

    kw = dict(kw, return_steps=True)
    before = hv.region_grow_3d_kernel.launches
    got = hv.region_grow_3d_kernel(vol, seeds, valid=valid, **kw)
    torch.cuda.synchronize()
    want = region_grow_3d(vol, seeds, valid=valid, **kw)
    assert got[0].dtype == torch.uint8 and got[0].shape == vol.shape
    assert got[1].device.type == "cuda" and got[1].shape == ()
    assert got[2].device.type == "cuda" and got[2].shape == () and got[2].dtype == torch.int32
    assert torch.equal(got[0], want[0])
    assert bool(got[1]) is bool(want[1]) and int(got[2]) == want[2]
    # one launch a growth, whatever the blocks: the card decides when to stop
    assert hv.region_grow_3d_kernel.launches - before == 1
    return got[0], got[1], int(got[2])


GROW3D_SHAPES = [(155, 256, 256), (25, 251, 241), (7, 33, 65), (1, 1, 1), (1, 40, 70),
                 (2, 9, 30, 50)]


@pytest.mark.parametrize("connectivity", [6, 26])
@pytest.mark.parametrize("shape", GROW3D_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_grow3d_kernel_equals_the_plain_loop(cuda, shape, connectivity):
    vol, seeds, valid = _maze3d(shape, cuda, seed=sum(shape))
    for bi, mi in ((16, 4096), (1, 4096), (7, 4096)):
        _grow3d_same(cuda, vol, seeds, valid, connectivity=connectivity, block_iters=bi,
                     max_iters=mi)


def test_grow3d_kernel_on_a_brats_study(cuda):
    # the benchmark's volume cell: one 155-plane phantom study on the 256
    # canvas through the pipeline's own grow inputs (expanded seed and
    # valid planes), grown to its fixpoint in blocks of 16
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
    from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import volume_grow_inputs

    vol = np.zeros((155, 256, 256), np.float32)
    vol[:, :240, :240] = phantom_volume(155, 240, 240, seed=21)
    cfg = PipelineConfig()
    pre, seeds, valid = volume_grow_inputs(torch.from_numpy(vol).to(cuda),
                                           torch.tensor([240, 240], dtype=torch.int32,
                                                        device=cuda), cfg)
    assert seeds.stride()[0] == 0 and valid.stride()[0] == 0
    got = _grow3d_same(cuda, pre, seeds, valid, low=cfg.grow_low, high=cfg.grow_high,
                       block_iters=16, max_iters=1024)
    assert int(got[0].sum()) > 0 and bool(got[1]) and got[2] >= 32


@pytest.mark.parametrize("max_iters", [16, 32])
@pytest.mark.parametrize("connectivity", [6, 26])
def test_grow3d_kernel_truncates_as_the_plain_loop(cuda, max_iters, connectivity):
    # a region still growing when the cap cuts it: converged False, the same mask
    vol, seeds, valid = _maze3d((25, 96, 96), cuda, seed=5, fill=0.6)
    got = _grow3d_same(cuda, vol, seeds, valid, connectivity=connectivity, block_iters=16,
                       max_iters=max_iters)
    assert not bool(got[1]) and got[2] == max_iters


@pytest.mark.parametrize("case", ["no_seeds", "all_in_band", "uint8_seeds", "no_valid"])
def test_grow3d_kernel_edge_inputs(cuda, case):
    vol, seeds, valid = _maze3d((9, 31, 47), cuda, seed=9)
    if case == "no_seeds":
        seeds = torch.zeros_like(seeds)
    elif case == "all_in_band":
        vol = torch.full_like(vol, 0.8)
        valid = torch.ones_like(valid)
    elif case == "uint8_seeds":
        seeds = seeds.to(torch.uint8) * 3
        valid = valid.float()
    else:
        valid = None
    got = _grow3d_same(cuda, vol, seeds, valid, block_iters=4)
    if case == "no_seeds":
        assert int(got[0].sum()) == 0 and bool(got[1]) and got[2] == 4
    if case == "all_in_band":
        assert int(got[0].sum()) == vol.numel()


def test_grow3d_kernel_refuses_what_it_cannot_take(cuda):
    from nm03_capstone_project_tpu_torch.ops import hopper_volume as hv

    vol, seeds, valid = _maze3d((3, 8, 8), cuda, seed=1)
    with pytest.raises(ValueError, match="connectivity"):
        hv.region_grow_3d_kernel(vol, seeds, connectivity=8)
    with pytest.raises(ValueError, match="positive"):
        hv.region_grow_3d_kernel(vol, seeds, block_iters=0)
    with pytest.raises(TypeError, match="float32"):
        hv.region_grow_3d_kernel(vol.double(), seeds)
    with pytest.raises(ValueError, match="CUDA"):
        hv.region_grow_3d_kernel(vol.cpu(), seeds.cpu())
    with pytest.raises(ValueError, match="seeds is on cpu"):
        hv.region_grow_3d_kernel(vol, seeds.cpu())


@pytest.mark.parametrize("block_iters,max_iters", [(7, 3), (7, 7), (7, 10), (7, 14), (5, 4096),
                                                   (16, 24)])
def test_grow3d_kernel_and_process_volume_make_no_host_sync(cuda, block_iters, max_iters):
    # odd blocks leave the region in either buffer by the blocks' parity,
    # and the cap falls below, at and between multiples of a block: the
    # card decides all of it, and the host waits on nothing
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
    from nm03_capstone_project_tpu_torch.ops import hopper_volume as hv
    from nm03_capstone_project_tpu_torch.ops.volume import region_grow_3d
    from nm03_capstone_project_tpu_torch.pipeline import process_volume

    vol, seeds, valid = _maze3d((25, 96, 96), cuda, seed=5, fill=0.6)
    kw = dict(valid=valid, block_iters=block_iters, max_iters=max_iters, return_steps=True)
    study = np.zeros((12, 256, 256), np.float32)
    study[:, :240, :200] = phantom_volume(12, 240, 200, seed=3)
    px = torch.from_numpy(study).to(cuda)
    dm = torch.tensor([240, 200], dtype=torch.int32, device=cuda)
    cfg = PipelineConfig(grow_block_iters=block_iters, grow_max_iters=max_iters)
    hv.region_grow_3d_kernel(vol, seeds, **kw)  # the build, outside the check
    process_volume(px, dm, cfg)
    torch.cuda.synchronize()
    before = hv.region_grow_3d_kernel.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = hv.region_grow_3d_kernel(vol, seeds, **kw)
        out = process_volume(px, dm, cfg)
        with pytest.raises(RuntimeError, match="synchroniz"):  # the check sees a host read
            got[2].item()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert hv.region_grow_3d_kernel.launches - before == 2
    want = region_grow_3d(vol, seeds, **kw)
    assert torch.equal(got[0], want[0]) and bool(got[1]) is bool(want[1])
    assert int(got[2]) == want[2]
    # the maze still grows past 32 steps (the truncation test above), so
    # every cap here but the last cuts it at its first block past the cap
    assert bool(want[1]) is (max_iters == 4096)
    if not bool(want[1]):
        assert want[2] == -(-max_iters // block_iters) * block_iters
    ref = process_volume(study, np.asarray([240, 200], np.int32), cfg, device="cpu")
    assert torch.equal(out["mask"].cpu(), ref["mask"])
    assert bool(out["grow_converged"]) is bool(ref["grow_converged"])


def test_grow3d_under_stage_spans_and_process_volume_equals_the_cpu(cuda):
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
    from nm03_capstone_project_tpu_torch.obs.spans import StageRecorder
    from nm03_capstone_project_tpu_torch.ops import hopper_volume as hv
    from nm03_capstone_project_tpu_torch.pipeline import process_volume, stage_spans

    vol = np.zeros((12, 256, 256), np.float32)
    vol[:, :240, :200] = phantom_volume(12, 240, 200, seed=3)
    dims = np.asarray([240, 200], np.int32)
    for bi in (16, 5):
        cfg = PipelineConfig(grow_block_iters=bi)
        before = hv.region_grow_3d_kernel.launches
        rec = StageRecorder()
        with stage_spans(rec):
            got = process_volume(vol, dims, cfg)
        launched = hv.region_grow_3d_kernel.launches - before
        c = rec.counters
        assert launched == c["grow3d.launches"] == 1 and c["grow3d.syncs"] == 0
        assert c["grow3d.blocks"] >= 1 and c["grow3d.blocks"] * bi == c["grow3d.steps"]
        names = [n for _, _, n, _ in rec.spans]
        assert names.count("grow3d.block") == 1 and "grow3d.sync" not in names
        want = process_volume(vol, dims, cfg, device="cpu")
        assert torch.equal(got["mask"].cpu(), want["mask"]) and int(want["mask"].sum()) > 0
        assert bool(got["grow_converged"]) is bool(want["grow_converged"])
