"""The seed/valid and finish kernels (``csrc/masks.cu``) against the torch ops.

On the CPU: what the kernels compute, written out in numpy as the CUDA
code does it (C division with the floor correction, wrapping int32, the
finish's 32-bit words shifted across with funnel shifts and a per-byte
max, the byte-by-byte path), held bitwise to :func:`seed_mask`,
:func:`valid_mask`, :func:`dilate` and :func:`dilate3d`; the routes
(the kernels only for CUDA tensors under ``use_kernels``); the library and
its launch counters named where the build and the drivers look.

Marked ``cuda``: the kernels themselves against the torch ops on the card,
over the TCIA sizes, sizes below 10 and 100, canvases of 256 and 512,
batches of 0 to 155, volumes of 1 to 155 planes, morph sizes 1 to 11, bool
and uint8 grown masks; one launch a stage inside ``process_batch`` and
``process_volume`` under the profiler; the served graphs replaying them.
This file imports nothing of JAX:

    python -m pytest --noconftest tests/test_torch_masks.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.core.image import valid_mask
from nm03_capstone_project_tpu_torch.kernels import build
from nm03_capstone_project_tpu_torch.ops import hopper_masks as hk
from nm03_capstone_project_tpu_torch.ops.elementwise import cast_uint8
from nm03_capstone_project_tpu_torch.ops.launches import KERNELS
from nm03_capstone_project_tpu_torch.ops.morphology import dilate
from nm03_capstone_project_tpu_torch.ops.seeds import seed_mask
from nm03_capstone_project_tpu_torch.ops.volume import dilate3d

# the TCIA cohort's true sizes, then sizes below 10, below 100, an empty
# one and sizes past the canvas
TCIA = [(256, 256), (251, 241), (256, 199), (227, 256), (197, 233)]
SMALL = [(1, 1), (3, 7), (9, 9), (5, 1), (10, 10), (2, 9), (0, 0), (0, 5)]
UNDER_100 = [(99, 99), (50, 73), (64, 17), (11, 99), (20, 30)]
PAST = [(300, 600), (700, 200)]
SIZES = TCIA + SMALL + UNDER_100 + PAST


def _dims(n, sizes=SIZES):
    return torch.tensor([sizes[i % len(sizes)] for i in range(n)],
                        dtype=torch.int32).reshape(n, 2)


def _grown(shape, dims, seed, dtype):
    """A grown mask: blobs and speckle, 0 outside the true size as the grow
    kernels leave it, plus a few stray voxels there (the kernel must not
    rely on it)."""
    g = torch.Generator().manual_seed(seed)
    speckle = torch.rand(shape, generator=g) < 0.02
    blob = torch.rand(shape, generator=g) < 0.6
    hh, ww = shape[-2:]
    rows = torch.arange(hh).view(hh, 1)
    cols = torch.arange(ww).view(1, ww)
    core = ((rows - hh // 2) ** 2 + (cols - ww // 3) ** 2) < (min(hh, ww) // 5) ** 2
    m = (speckle | (blob & core)) & valid_mask(dims, (hh, ww))
    m |= torch.rand(shape, generator=g) < 0.001
    return m if dtype == torch.bool else m.to(torch.uint8)


# -- the kernels' arithmetic in numpy ------------------------------------------------


def _c_div(a, b):
    """C's truncating division of int32 arrays by a positive int."""
    q = np.abs(a.astype(np.int64)) // b
    return np.where(a < 0, -q, q).astype(np.int32)


def _fdiv(a, b):
    """``fdiv`` of masks.cu: C division, one less where it truncated a
    negative quotient."""
    q = _c_div(a, b)
    rem = (a.astype(np.int64) - q.astype(np.int64) * b) != 0
    return np.where(rem & (a < 0), q - 1, q).astype(np.int32)


def _wrap(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31).astype(np.int32)


def seed_valid_model(dims, hw):
    """``seed_valid_kernel``: (P, H, W) bool seeds and valid."""
    hh, ww = hw
    d = np.asarray(dims, np.int32).reshape(-1, 2)
    r = np.arange(hh, dtype=np.int32).reshape(1, hh, 1)
    c = np.arange(ww, dtype=np.int32).reshape(1, 1, ww)
    h = d[:, 0].reshape(-1, 1, 1)
    w = d[:, 1].reshape(-1, 1, 1)
    cx, cy = _fdiv(w, 2), _fdiv(h, 2)
    ox, oy = _fdiv(w, 8), _fdiv(h, 8)
    xp, xm = _wrap(cx.astype(np.int64) + ox), _wrap(cx.astype(np.int64) - ox)
    yp, ym = _wrap(cy.astype(np.int64) + oy), _wrap(cy.astype(np.int64) - oy)
    sx, sy = np.maximum(_fdiv(w, 10), 1), np.maximum(_fdiv(h, 10), 1)
    x0, y0 = _fdiv(w, 4), _fdiv(h, 4)
    x1, y1 = _fdiv(_wrap(3 * w.astype(np.int64)), 4), _fdiv(_wrap(3 * h.astype(np.int64)), 4)
    fixed = (((c == cx) & (r == cy)) | ((c == xp) & (r == cy)) | ((c == xm) & (r == cy))
             | ((c == cx) & (r == yp)) | ((c == cx) & (r == ym)))
    # the row's test with C's remainder (zero exactly where the floor
    # remainder is); the column phase floored at the run's first column
    # (c0, 4 columns a run) and stepped from there
    grid_row = (r >= y0) & (r < y1) & (np.fmod(_wrap(r.astype(np.int64) - y0), sy) == 0)
    c0 = c // 4 * 4
    m = (np.mod(_wrap(c0.astype(np.int64) - x0), sx) + (c - c0)) % sx
    grid = grid_row & (m == 0) & (c >= x0) & (c < x1)
    inside = (r < h) & (c < w)
    return (fixed | grid) & inside, inside


def _funnel_rc(lo, hi, s):
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return (v >> np.uint64(min(s, 32))).astype(np.uint32)


def _funnel_lc(lo, hi, s):
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v << np.uint64(min(s, 32))) >> np.uint64(32)).astype(np.uint32)


def _vmaxu4(a, b):
    return np.maximum(a.view(np.uint8), b.view(np.uint8)).view(np.uint32)


def _keep(dims_of_plane, hh, ww):
    h, w = dims_of_plane
    return (np.arange(hh)[:, None] < h) & (np.arange(ww)[None, :] < w)


def finish_model(seg, dims, size, volume=False, vec4=True):
    """``finish_kernel`` over (P, H, W) bytes: the funnel-shift path of 4
    bytes a word (``vec4``, W % 4 == 0 and R <= 4) or the byte path."""
    seg = np.ascontiguousarray(np.asarray(seg, np.uint8))
    hh, ww = seg.shape[-2:]
    planes = seg.reshape(-1, hh, ww)
    depth = seg.shape[-3] if volume else 1
    d = np.asarray(dims, np.int32).reshape(-1, 2)
    step = 0 if len(d) == 1 else 1
    R = size // 2
    RZ = R if volume else 0
    out = np.zeros_like(planes)
    words = planes.view(np.uint32) if vec4 else None
    for p in range(len(planes)):
        z = p % depth
        keep = _keep(d[(p // depth) * step], hh, ww)
        acc = np.zeros((hh, ww // 4), np.uint32) if vec4 else np.zeros((hh, ww), np.uint8)
        for dz in range(-RZ, RZ + 1):
            if not 0 <= z + dz < depth:
                continue
            rz = R - abs(dz)
            for dr in range(-rz, rz + 1):
                reach = rz - abs(dr)
                rows = np.arange(hh) + dr
                ok = (rows >= 0) & (rows < hh)
                if vec4:
                    src = np.zeros((hh, ww // 4), np.uint32)
                    src[ok] = words[p + dz][rows[ok]]
                    acc = _vmaxu4(acc, src)
                    left = np.zeros_like(src)
                    left[:, 1:] = src[:, :-1]
                    right = np.zeros_like(src)
                    right[:, :-1] = src[:, 1:]
                    for k in range(1, reach + 1):
                        acc = _vmaxu4(acc, _funnel_rc(src, right, 8 * k))
                        acc = _vmaxu4(acc, _funnel_lc(left, src, 8 * k))
                else:
                    src = np.zeros((hh, ww), np.uint8)
                    src[ok] = planes[p + dz][rows[ok]]
                    for dc in range(-reach, reach + 1):
                        shifted = np.zeros_like(src)
                        lo, hi = max(dc, 0), ww + min(dc, 0)
                        shifted[:, lo - dc:hi - dc] = src[:, lo:hi]
                        acc = np.maximum(acc, shifted)
        acc = acc.view(np.uint8).reshape(hh, ww) if vec4 else acc
        out[p] = np.where(keep, acc, 0)
    return out.reshape(seg.shape)


@pytest.mark.parametrize("hw", [(256, 256), (64, 48), (37, 53), (16, 512)])
def test_the_seed_model_equals_the_torch_ops(hw):
    dims = _dims(len(SIZES))
    extreme = torch.tensor([[-7, 13], [13, -7], [-1, -1], [2**31 - 1, 5], [-(2**31), 3],
                            [2**30 + 5, 2**30 + 7]], dtype=torch.int32)
    dims = torch.cat([dims, extreme])
    seeds, valid = seed_valid_model(dims.numpy(), hw)
    np.testing.assert_array_equal(seeds, seed_mask(dims, hw).numpy())
    np.testing.assert_array_equal(valid, valid_mask(dims, hw).numpy())


@pytest.mark.parametrize("size", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("hw", [(24, 32), (17, 8)])
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_the_finish_model_equals_dilate_in_2d(size, hw, dtype):
    dims = _dims(6, [(24, 32), (17, 8), (9, 5), (1, 1), (0, 3), (30, 40)])
    seg = _grown((6, *hw), dims, size, dtype)
    want = (dilate(cast_uint8(seg), size) * valid_mask(dims, hw).to(torch.uint8)).numpy()
    for vec4 in ((True, False) if size <= 9 else (False,)):
        np.testing.assert_array_equal(finish_model(seg.numpy(), dims.numpy(), size,
                                                   vec4=vec4), want)
    np.testing.assert_array_equal(finish_model(seg.numpy(), dims[:1].numpy(), size),
                                  (dilate(cast_uint8(seg), size)
                                   * valid_mask(dims[0], hw).to(torch.uint8)).numpy())


@pytest.mark.parametrize("size", [1, 3, 5, 7])
@pytest.mark.parametrize("depth", [1, 2, 7])
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_the_finish_model_equals_dilate3d(size, depth, dtype):
    hw, dims = (20, 24), torch.tensor([17, 21], dtype=torch.int32)
    seg = _grown((depth, *hw), dims, depth + size, dtype)
    want = (dilate3d(cast_uint8(seg), size) * valid_mask(dims, hw).to(torch.uint8)).numpy()
    for vec4 in (True, False):
        np.testing.assert_array_equal(finish_model(seg.numpy(), dims.numpy(), size,
                                                   volume=True, vec4=vec4), want)


# -- routes, the library and its counters on the CPU ----------------------------------


class _OnCard:
    """A stand-in the routes take for a CUDA tensor."""

    is_cuda = True


def test_the_routes_take_the_kernels_only_on_the_card_under_use_kernels(monkeypatch):
    calls = []
    monkeypatch.setattr(hk, "seed_valid_masks_kernel", lambda *a: calls.append("seeds"))
    monkeypatch.setattr(hk, "finish_mask_kernel", lambda *a: calls.append("finish"))
    card = _OnCard()
    hk.seed_valid_masks(card, (8, 8), use_kernels=True)
    hk.finish_mask(card, card, 3, use_kernels=True)
    assert calls == ["seeds", "finish"]
    dims = torch.tensor([[6, 5]], dtype=torch.int32)
    seg = torch.zeros((1, 8, 8), dtype=torch.uint8)
    for use_kernels in (True, False):
        seeds, valid = hk.seed_valid_masks(dims, (8, 8), use_kernels)
        assert torch.equal(seeds, seed_mask(dims, (8, 8)))
        assert torch.equal(valid, valid_mask(dims, (8, 8)))
        assert hk.finish_mask(seg, dims, 3, use_kernels).dtype == torch.uint8
    assert calls == ["seeds", "finish"]


def test_the_kernel_wrappers_refuse_cpu_tensors():
    dims = torch.tensor([[6, 5]], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        hk.seed_valid_masks_kernel(dims, (8, 8))
    with pytest.raises(ValueError, match="CUDA"):
        hk.finish_mask_kernel(torch.zeros((1, 8, 8), dtype=torch.uint8), dims, 3)


@pytest.mark.parametrize("volume", [False, True])
def test_the_plain_finish_is_the_pipeline_s_old_chain(volume):
    dims = torch.tensor([13, 11], dtype=torch.int32)
    seg = _grown((3, 16, 16), dims, 5, torch.uint8)
    if volume:
        want = dilate3d(cast_uint8(seg), 5)
        want = want * valid_mask(dims, (16, 16)).expand(3, 16, 16).to(want.dtype)
    else:
        want = dilate(cast_uint8(seg), 5) * valid_mask(dims, (16, 16)).to(torch.uint8)
    assert torch.equal(hk.finish_mask_plain(seg, dims, 5, volume), want)


def test_the_pipelines_launch_nothing_on_the_cpu():
    from nm03_capstone_project_tpu_torch.pipeline import process_batch
    from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import process_volume

    cfg = PipelineConfig(canvas=32, min_dim=8)
    before = {k: fn.launches for k, fn in KERNELS.items()}
    px = torch.rand(2, 32, 32) * 3000
    dims = torch.tensor([[32, 30], [20, 25]], dtype=torch.int32)
    process_batch(px, dims, cfg, device="cpu")
    process_volume(px, dims[0], cfg, device="cpu")
    assert {k: fn.launches for k, fn in KERNELS.items()} == before


def test_the_library_and_its_counters_are_named():
    assert "masks" in build.SOURCES and len(build.SOURCES) == 5
    assert set(build.ARGTYPES["masks"]) == {"nm03_seed_valid", "nm03_finish"}
    assert KERNELS["seeds"] is hk.seed_valid_masks_kernel
    assert KERNELS["finish"] is hk.finish_mask_kernel
    src = (build.CSRC / "masks.cu").read_text()
    assert "__global__ void __launch_bounds__(THREADS)\nseed_valid_kernel(" in src
    assert "__global__ void __launch_bounds__(THREADS)\nfinish_kernel(" in src


# -- on the card ----------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


CANVASES = [(256, 256), (512, 512), (256, 512), (512, 256), (250, 254), (7, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw", CANVASES)
@pytest.mark.parametrize("batch", [0, 1, 25, 155])
def test_seed_valid_kernel_bitwise(cuda, hw, batch):
    dims = _dims(batch)
    before = hk.seed_valid_masks_kernel.launches
    seeds, valid = hk.seed_valid_masks_kernel(dims.to(cuda), hw)
    assert seeds.dtype == valid.dtype == torch.bool and seeds.is_contiguous()
    assert torch.equal(seeds.cpu(), seed_mask(dims, hw))
    assert torch.equal(valid.cpu(), valid_mask(dims, hw))
    assert hk.seed_valid_masks_kernel.launches == before + (batch > 0)


@pytest.mark.cuda
def test_seed_valid_kernel_one_plane_and_extreme_sizes(cuda):
    for dm in [(240, 240), (256, 256), (9, 3), (0, 0), (-7, 13), (2**31 - 1, 5),
               (-(2**31), 3), (2**30 + 5, 2**30 + 7)]:
        dims = torch.tensor(dm, dtype=torch.int32)
        seeds, valid = hk.seed_valid_masks_kernel(dims.to(cuda), (256, 256))
        assert seeds.shape == (256, 256)
        assert torch.equal(seeds.cpu(), seed_mask(dims, (256, 256))), dm
        assert torch.equal(valid.cpu(), valid_mask(dims, (256, 256))), dm


@pytest.mark.cuda
@pytest.mark.parametrize("hw", CANVASES)
@pytest.mark.parametrize("batch", [0, 1, 25, 155])
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_finish_kernel_bitwise_in_2d(cuda, hw, batch, dtype):
    dims = _dims(batch)
    seg = _grown((batch, *hw), dims, batch, dtype)
    valid = valid_mask(dims, hw).to(torch.uint8)
    dseg, ddims = seg.to(cuda), dims.to(cuda)
    for size in (1, 3, 5, 7, 9, 11):
        before = hk.finish_mask_kernel.launches
        got = hk.finish_mask_kernel(dseg, ddims, size)
        assert hk.finish_mask_kernel.launches == before + (batch > 0)
        assert got.dtype == torch.uint8
        assert torch.equal(got.cpu(), dilate(cast_uint8(seg), size) * valid), size
        # one size for every plane
        if batch:
            got = hk.finish_mask_kernel(dseg, ddims[0], size)
            want = dilate(cast_uint8(seg), size) * valid_mask(dims[0], hw).to(torch.uint8)
            assert torch.equal(got.cpu(), want), size


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 25, 155])
@pytest.mark.parametrize("hw", [(256, 256), (512, 256), (250, 254)])
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_finish_kernel_bitwise_in_3d(cuda, depth, hw, dtype):
    for dm in [(240, 240), hw, (197, 233), (9, 5)]:
        dims = torch.tensor(dm, dtype=torch.int32)
        seg = _grown((depth, *hw), dims, depth, dtype)
        valid = valid_mask(dims, hw).to(torch.uint8)
        dseg, ddims = seg.to(cuda), dims.to(cuda)
        for size in (1, 3, 5, 7):
            got = hk.finish_mask_kernel(dseg, ddims, size, volume=True)
            assert torch.equal(got.cpu(), dilate3d(cast_uint8(seg), size) * valid), (dm, size)


@pytest.mark.cuda
def test_the_kernels_refuse_what_they_cannot_take(cuda):
    dims = torch.tensor([[6, 5]], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        hk.finish_mask_kernel(torch.zeros((1, 8, 8), device=cuda), dims, 3)
    with pytest.raises(ValueError):
        hk.finish_mask_kernel(torch.zeros((2, 8, 8), dtype=torch.uint8, device=cuda),
                              torch.zeros((3, 2), dtype=torch.int32, device=cuda), 3)
    with pytest.raises(ValueError):
        hk.finish_mask_kernel(torch.zeros((2, 8, 8), dtype=torch.uint8, device=cuda), dims, 0)


# one process's profile of a process_batch and a process_volume call: the
# device kernels each launches, by the pipeline stage open at the kernel's
# launch on the host, {entry: {stage: {kernel: n}}}. Each stage is a
# record_function range here, so the ranges and the launches lie on the
# profiler's one host clock.
_STAGE_RUN = r'''
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.pipeline import process_batch, slice_pipeline, volume_pipeline
from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import process_volume


def ranged(name):
    return torch.profiler.record_function("stage:" + name)


slice_pipeline._stage = volume_pipeline._stage = ranged
CUDA = torch.autograd.DeviceType.CUDA


def stage_kernels(run):
    run()  # warm: the libraries loaded, the allocator's blocks held
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    stages = [(ev.start_ns(), ev.end_ns(), ev.name()[len("stage:"):]) for ev in events
              if ev.device_type() != CUDA and ev.name().startswith("stage:")]
    launches = {ev.correlation_id(): ev.start_ns() for ev in events
                if ev.device_type() != CUDA and "Launch" in ev.name()}
    out = {}
    for ev in events:
        name = ev.name()
        if ev.device_type() != CUDA or name.startswith(("Memcpy", "Memset", "stage:")):
            continue
        at = launches.get(ev.linked_correlation_id(), launches.get(ev.correlation_id()))
        if at is None:
            raise SystemExit(f"no launch found for {name}")
        inner = [(s, n) for s, e, n in stages if s <= at < e]
        stage = max(inner)[1] if inner else "none"
        base = name.replace("(anonymous namespace)::", "").removeprefix("void ")
        base = base.split("<")[0].split("(")[0]
        out.setdefault(stage, {}).setdefault(base, 0)
        out[stage][base] += 1
    return out


cfg = PipelineConfig()
g = torch.Generator().manual_seed(3)
px = (torch.rand(25, 256, 256, generator=g) * 3000).cuda()
dims = torch.tensor(json.loads(sys.argv[1]), dtype=torch.int32).cuda()
vol = (torch.rand(155, 256, 256, generator=g) * 3000).cuda()
vdims = torch.tensor([240, 240], dtype=torch.int32).cuda()
print(json.dumps({"batch": stage_kernels(lambda: process_batch(px, dims, cfg)),
                  "volume": stage_kernels(lambda: process_volume(vol, vdims, cfg))}))
'''


@pytest.mark.cuda
def test_one_launch_a_stage_in_process_batch_and_process_volume(cuda):
    """In a process of its own: after many launches a process's later
    profiler windows lose records."""
    import json
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", _STAGE_RUN, json.dumps(_dims(25, TCIA).tolist())],
                          cwd=repo, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    for entry in ("batch", "volume"):
        assert got[entry]["seeds"] == {"seed_valid_kernel": 1}, got
        assert got[entry]["morph"] == {"finish_kernel": 1}, got


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["dilate", "jump"])
def test_the_entries_equal_the_cpu_with_one_launch_of_each(cuda, algorithm):
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_series, phantom_volume
    from nm03_capstone_project_tpu_torch.pipeline import process_batch, process_slice_stages
    from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import process_volume

    cfg = PipelineConfig(grow_algorithm=algorithm)
    series = phantom_series(5, 256, 256, seed=4)
    px = torch.from_numpy(np.stack([np.asarray(s, np.float32) for s in series]))
    dims = _dims(5, TCIA)
    for i, (h, w) in enumerate(TCIA):
        px[i, h:, :] = 0
        px[i, :, w:] = 0
    before = {k: fn.launches for k, fn in KERNELS.items()}
    card = process_batch(px.to(cuda), dims.to(cuda), cfg)
    ran = {k: fn.launches - before[k] for k, fn in KERNELS.items()}
    assert ran["seeds"] == ran["finish"] == 1, ran
    plain = process_batch(px, dims, cfg, device="cpu")
    assert torch.equal(card["mask"].cpu(), plain["mask"])
    assert torch.equal(card["grow_converged"].cpu(), plain["grow_converged"])
    stages = process_slice_stages(px.to(cuda), dims.to(cuda), cfg)
    assert torch.equal(stages["final_dilated_result"].cpu(), plain["mask"])
    vol = torch.zeros(25, 256, 256)
    vol[:, :240, :240] = torch.from_numpy(np.asarray(phantom_volume(25, 240, 240, seed=5),
                                                     np.float32))
    vdims = torch.tensor([240, 240], dtype=torch.int32)
    before = {k: fn.launches for k, fn in KERNELS.items()}
    card = process_volume(vol.to(cuda), vdims.to(cuda), cfg)
    ran = {k: fn.launches - before[k] for k, fn in KERNELS.items()}
    assert ran["seeds"] == ran["finish"] == 1, ran
    plain = process_volume(vol, vdims, cfg, device="cpu")
    assert torch.equal(card["mask"].cpu(), plain["mask"])
    assert bool(card["grow_converged"]) == bool(plain["grow_converged"])


@pytest.mark.cuda
def test_a_served_graph_replays_the_new_launches_bitwise(cuda):
    from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import _process
    from nm03_capstone_project_tpu_torch.serving.graphs import BucketGraph

    cfg = PipelineConfig()
    graph = BucketGraph(cfg, 4, cuda, torch.cuda.graph_pool_handle(), torch.cuda.Stream())
    graph.capture()
    assert graph.kernels["seeds"] == graph.kernels["finish"] == 1, graph.kernels
    g = torch.Generator().manual_seed(8)
    for turn in range(3):
        px = torch.rand(4, 256, 256, generator=g) * 3000
        dims = _dims(4, TCIA[turn:] + TCIA[:turn])
        want = _process(px.to(cuda), dims.to(cuda), cfg)
        before = {k: fn.launches for k, fn in KERNELS.items()}
        graph.launch(px.numpy(), dims.numpy())
        mask, conv = graph.fetch()
        assert {k: fn.launches for k, fn in KERNELS.items()} == before  # replays only
        np.testing.assert_array_equal(mask, want["mask"].cpu().numpy())
        np.testing.assert_array_equal(conv, want["grow_converged"].cpu().numpy())
