"""The port's kernels over the JAX package's whole envelope, on the CPU.

The JAX package takes any odd median window, any sharpen length and any
canvas (its Pallas kernels hand a shape past VMEM to XLA). The port's
kernels take the same on the card by routes picked from the shape and the
config before launch (``ops/hopper_median.py``,
``ops/hopper_region_growing.py``):

* the median from k = 17 by exact selection (``select``) and past
  MAX_SELECT_WINDOW by the same selection over sorted column segments kept
  down a strip of rows (``wide``),
  the fused preprocess past its plans or taps by the median kernel with
  normalize and clip on load, then the sharpen kernel (``split``; its
  schedule: ``tests/test_torch_split.py``), grow past one cluster's shared memory with the
  region in global memory (``global``), at any slice size;
* the launch-shape functions name the route for every size and window of
  the envelope and never raise a KeyError;
* the wrappers take the route before launch and log its name (the ctypes
  library and the device are stand-ins here: there is no ``nvcc``);
* the global grow kernel's per-slice loop is run here in torch, as
  ``csrc/grow.cu`` does, against the plain ``region_grow`` (the select
  kernel's rule and the grow's tiled schedule in full:
  ``tests/test_torch_redesign.py``);
* the plain median at k = 17, 19, 65 and 127 against the JAX package's
  ``ops.median.vector_median_filter`` and a brute-force numpy median, on
  small arrays: the JAX network runs eagerly there (4,638 min/max at k =
  17 in about 2 s; 172,222 at k = 65 and 933,978 at k = 127 take most of
  this file's time), where its jit at canvas 64 takes minutes.

The kernels themselves run on the card: ``tests/test_torch_card.py -m
cuda`` and ``chip_smoke.py``'s ``envelope`` phase.
"""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu.ops.median import vector_median_filter as jax_median
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter
from nm03_capstone_project_tpu_torch.ops.morphology import dilate
from nm03_capstone_project_tpu_torch.ops.region_growing import grow_band, region_grow
from nm03_capstone_project_tpu_torch.utils import reporter

ENVELOPE_CANVASES = [(2304, 2304), (3072, 3072), (4096, 4096), (1024, 4096), (512, 8192)]
CLUSTER_CANVASES = [(256, 256), (1024, 1024), (2048, 2048), (2160, 2048), (8192, 64)]
N_SM = 132


def h100_wide_ctas_per_sm(index: int, k: int) -> int:
    """The wide CTAs an H100 SM holds by registers (65,536; ptxas gives the
    kernel 48 a thread on sm_90a), threads (2048) and shared memory
    (233,472 bytes, 1 KB a block reserved): the runtime's count on the card
    (5 at k = 65, 2 at 127); one where the segments are in scratch."""
    if not hm.wide_shared(k):
        return 1
    return min(65536 // (48 * hm.WIDE_THREADS), 2048 // hm.WIDE_THREADS,
               233472 // (hm.wide_segment_bytes(k) + 1024))


# -- the launch-shape functions ----------------------------------------------------


@pytest.mark.parametrize("hw", ENVELOPE_CANVASES)
def test_grow_past_one_cluster_takes_the_global_route(hw):
    shape = hg.grow_launch_shape(*hw)
    assert shape == (0, 0, 0) and shape.route == "global"


@pytest.mark.parametrize("hw", CLUSTER_CANVASES)
def test_slices_that_fit_a_cluster_keep_it(hw):
    shape = hg.grow_launch_shape(*hw)
    assert shape.route == "cluster" and shape.cluster in (2, 4, 8)
    assert shape.smem <= hg.SMEM_PER_BLOCK


@pytest.mark.parametrize("k", [17, 21, 31, 63])
def test_wide_windows_take_the_select_and_unfused_routes(k):
    for b, h, w in [(25, 256, 256), (2, 3072, 3072), (70000, 16, 16)]:
        med = hm.median_launch_shape(b, h, w, k)
        assert med == ("select", -(-b // hm.MAX_BATCH))
        fused = hm.fused_launch_shape(b, h, w, k, 9, N_SM)
        assert fused == hm.SPLIT and fused.route == "split"


def test_a_long_sharpen_takes_the_unfused_route():
    assert hm.fused_launch_shape(25, 256, 256, 7, 33, N_SM).route == "split"
    assert hm.fused_launch_shape(25, 256, 256, 7, 31, N_SM).route == "fused"
    # the main path's tiles are what they were
    assert hm.fused_launch_shape(25, 256, 256, 7, 9, N_SM) == (52, 256, 125, 134196)


@pytest.mark.parametrize("k", range(1, 64, 2))
def test_no_window_or_sharpen_length_raises_a_key_error(k):
    for ks in range(1, 66, 2):
        route = hm.fused_launch_shape(3, 97, 300, k, ks, N_SM).route
        assert route == ("fused" if k <= hm.MAX_WINDOW and ks <= hm.MAX_TAPS else "split")
    want = "network" if k <= hm.MAX_WINDOW else "select"
    assert hm.median_launch_shape(3, 97, 300, k).route == want


@pytest.mark.parametrize("k", range(hm.MAX_SELECT_WINDOW + 2, 302, 2))
def test_windows_past_the_select_take_the_wide_route(k):
    for b, h, w in [(2, 256, 256), (1, 64, 64), (70000, 16, 16)]:
        assert hm.median_launch_shape(b, h, w, k) == ("wide", -(-b // hm.MAX_BATCH))
        assert hm.fused_launch_shape(b, h, w, k, 9, N_SM) == hm.SPLIT
    # the CTA's k sorted segments of its strip's 32 + k - 1 columns (a plane
    # rounded up to 32 words) sit in shared memory where they fit a block:
    # up to k = 225 (230,400 bytes), in a device scratch past that
    pitch = -(-(hm.WIDE_COLS + k - 1) // 32) * 32
    assert hm.wide_segment_bytes(k) == 4 * k * pitch and pitch % 32 == 0
    assert hm.wide_shared(k) == (k <= 225) == (k <= hm.MAX_WIDE_SHARED_WINDOW)
    assert hm.wide_segment_bytes(225) == 230400 < hm.SMEM_PER_BLOCK < hm.wide_segment_bytes(227)
    shape = hm.wide_launch_shape(2, 256, 256, k, N_SM, h100_wide_ctas_per_sm(0, k))
    assert (shape.smem, shape.scratch) == ((hm.wide_segment_bytes(k), 0) if k <= 225 else
                                           (0, shape.grid * hm.wide_segment_bytes(k) // 4))


@pytest.mark.parametrize("k", [65, 16, 0])
def test_the_median_limit_is_named_before_launch(k):
    # past MAX_SELECT_WINDOW the wide route, named before launch; an even
    # or non-positive window is refused
    if k % 2:
        assert hm.median_launch_shape(1, 8, 8, k).route == "wide"
    else:
        with pytest.raises(ValueError, match="odd and positive"):
            hm.median_launch_shape(1, 8, 8, k)


@pytest.mark.parametrize("hw", [(16385, 2304), (2304, 16385), (20000, 20000), (0, 16)])
def test_the_grow_limit_is_named_before_launch(hw):
    # no side limit: past one cluster the global route at any size; an
    # empty slice is refused
    if 0 in hw:
        with pytest.raises(ValueError, match="empty slice"):
            hg.grow_launch_shape(*hw)
    else:
        assert hg.grow_launch_shape(*hw).route == "global"


# -- routes taken before launch, and named ---------------------------------------------


class _Fn:
    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


class _Lib:
    def __init__(self, calls):
        for fn in ("nm03_median_filter", "nm03_median_select", "nm03_median_wide",
                   "nm03_median_filter_pre", "nm03_median_select_pre", "nm03_median_wide_pre",
                   "nm03_fused_preprocess", "nm03_sharpen", "nm03_region_grow",
                   "nm03_region_grow_global"):
            setattr(self, fn, _Fn(calls, fn))


@pytest.fixture
def stand_in_card(monkeypatch, caplog):
    """The wrappers on CPU tensors: the device checks, the stream and the
    ctypes library are stand-ins that record each launch."""
    calls = []
    lib = _Lib(calls)

    def batched(x, what):
        return x.reshape(-1, x.shape[-2], x.shape[-1]).contiguous()

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(hm, "_batched", batched)
    monkeypatch.setattr(hm, "_sm_count", lambda index: N_SM)
    monkeypatch.setattr(hm, "_wide_ctas_per_sm", h100_wide_ctas_per_sm)
    monkeypatch.setattr(hg, "_sm_count", lambda index: N_SM)
    monkeypatch.setattr(hg, "_check_args", lambda *a: None)
    monkeypatch.setattr(hm.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(reporter, "_logged_once", set())
    logger = logging.getLogger("nm03_torch")
    monkeypatch.setattr(logger, "propagate", True)
    caplog.set_level(logging.INFO, logger="nm03_torch")
    for fn in (hm.vector_median_filter_kernel, hm.vector_median_select_kernel,
               hm.vector_median_wide_kernel, hm.fused_preprocess_kernel,
               hm.sharpen_filter_kernel, hg.region_grow_kernel, hg.region_grow_global_kernel):
        monkeypatch.setattr(fn, "launches", 0)
    return calls


def _routes(caplog):
    return [r.getMessage() for r in caplog.records if "route" in r.getMessage()]


def test_median_routes_by_window(stand_in_card, caplog):
    x = torch.rand(3, 40, 50)
    for k in (15, 17, 63, 65, 225, 227, 257):
        hm.vector_median_filter_kernel(x, k)
    assert [c[0] for c in stand_in_card] == (
        ["nm03_median_filter"] + ["nm03_median_select"] * 2 + ["nm03_median_wide"] * 4)
    name, args = stand_in_card[1]
    assert args[2:8] == (0, 3, 40, 50, 17, hm.MAX_SELECT_WINDOW)
    # the wide kernel: first slice, slices, h, w, k, band rows and grid; a
    # scratch pointer only where the segments do not fit shared memory. Two
    # strips a slice: 40 one-row bands where five CTAs share an SM (240
    # tiles), 20 two-row bands where one CTA takes an SM (120)
    assert [c[1][3:10] for c in stand_in_card[3:]] == [
        (0, 3, 40, 50, 65, 1, 240), (0, 3, 40, 50, 225, 2, 120), (0, 3, 40, 50, 227, 2, 120),
        (0, 3, 40, 50, 257, 2, 120)]
    assert [c[1][2] is None for c in stand_in_card[3:]] == [True, True, False, False]
    assert hm.vector_median_filter_kernel.launches == 1
    assert hm.vector_median_select_kernel.launches == 2
    assert hm.vector_median_wide_kernel.launches == 4
    assert _routes(caplog) == [
        "median: route select (k=17, 1 launch(es) of 3 slices)",
        "median: route wide (k=65, segments in shared memory, 1-row bands, "
        "1 launch(es) of 3 slices)"]


@pytest.mark.parametrize("k,route", [(7, "network"), (17, "select"), (65, "wide"),
                                     (257, "wide")])
def test_a_batch_past_the_grid_goes_in_several_launches(stand_in_card, k, route):
    x = torch.zeros(hm.MAX_BATCH + 5, 2, 3)
    hm.vector_median_filter_kernel(x, k)
    assert len(stand_in_card) == 2
    (_, first), (_, second) = stand_in_card
    if route == "network":  # pointers advance, counts split
        assert first[2] == hm.MAX_BATCH and second[2] == 5
        assert second[0] - first[0] == hm.MAX_BATCH * 2 * 3 * 4
    else:  # one base pointer, the first slice and the count of each grid
        at = 3 if route == "wide" else 2  # the wide kernel's scratch comes first
        assert first[at:at + 2] == (0, hm.MAX_BATCH) and second[at:at + 2] == (hm.MAX_BATCH, 5)
        assert first[0] == second[0]
        if route == "wide":  # one scratch for both grids, where there is one
            assert first[2] == second[2] and (first[2] is None) == hm.wide_shared(k)
    launched = {"network": hm.vector_median_filter_kernel, "select":
                hm.vector_median_select_kernel, "wide": hm.vector_median_wide_kernel}[route]
    assert launched.launches == 2


@pytest.mark.parametrize("k,ks", [(17, 9), (7, 33), (31, 41), (65, 9), (127, 33)])
def test_the_unfused_route_runs_the_median_kernel_between_torch_ops(stand_in_card, caplog,
                                                                    k, ks):
    x = torch.rand(2, 30, 40) * 9000
    hm.fused_preprocess_kernel(x, median_window=k, sharpen_kernel=ks)
    route = ("network" if k <= hm.MAX_WINDOW else
             "select" if k <= hm.MAX_SELECT_WINDOW else "wide")
    want = {"network": "nm03_median_filter_pre", "select": "nm03_median_select_pre",
            "wide": "nm03_median_wide_pre"}[route]
    assert [c[0] for c in stand_in_card] == [want, "nm03_sharpen"]
    assert hm.fused_preprocess_kernel.launches == 0
    assert hm.sharpen_filter_kernel.launches == 1
    assert _routes(caplog)[0] == (
        f"fused: route split (k={k}, {ks} sharpen taps: the {route} median with normalize "
        "and clip on load, then the sharpen kernel)")


def test_the_fused_route_is_untouched(stand_in_card, caplog):
    hm.fused_preprocess_kernel(torch.rand(25, 256, 256))
    ((name, args),) = stand_in_card
    assert name == "nm03_fused_preprocess" and args[-4:-1] == (52, 256, 125)
    assert hm.fused_preprocess_kernel.launches == 1 and not _routes(caplog)


@pytest.mark.parametrize("hw,route", [((256, 256), "cluster"), ((2304, 2304), "global")])
def test_grow_routes_by_slice_size(stand_in_card, caplog, hw, route):
    img = torch.zeros((2, *hw))
    hg.region_grow_kernel(img, img > 0, return_steps=True)
    want = "nm03_region_grow" if route == "cluster" else "nm03_region_grow_global"
    assert [c[0] for c in stand_in_card] == [want]
    assert hg.region_grow_kernel.launches == (route == "cluster")
    assert hg.region_grow_global_kernel.launches == (route == "global")
    msgs = _routes(caplog)
    assert msgs == ([] if route == "cluster" else
                    ["grow: route global (2304x2304 slices past one cluster's shared memory)"])


def test_a_global_batch_past_the_word_limit_goes_in_several_launches(stand_in_card,
                                                                     monkeypatch):
    monkeypatch.setattr(hg, "GLOBAL_MAX_WORDS", 2 * 2304 * 72)
    img = torch.zeros((5, 2304, 2304))
    hg.region_grow_kernel(img, img > 0)
    counts = [c[1][10] for c in stand_in_card]
    assert counts == [2, 2, 1] and hg.region_grow_global_kernel.launches == 3


def test_a_slice_past_the_word_limit_goes_alone(stand_in_card, monkeypatch):
    # one slice holds more packed words than a launch: each slice alone,
    # its tiles from global_tiles as for any slice
    monkeypatch.setattr(hg, "GLOBAL_MAX_WORDS", 1000)
    img = torch.zeros((3, 2304, 2304))
    hg.region_grow_kernel(img, img > 0)
    tiles = hg.global_tiles(1, 2304, 2304, 16, N_SM)
    assert [c[1][10] for c in stand_in_card] == [1, 1, 1]
    assert [c[1][18:23] for c in stand_in_card] == [
        (tiles.rows, tiles.words, tiles.halo, tiles.pitch, tiles.grid)] * 3
    assert hg.region_grow_global_kernel.launches == 3


@pytest.mark.parametrize("hw", [(16385, 2304), (2304, 16385), (20000, 20000)])
def test_slices_past_the_old_side_limit_launch_the_global_kernel(stand_in_card, caplog, hw):
    # torch.empty: the stand-in library reads nothing, so no page is touched
    img = torch.empty((1, *hw), dtype=torch.float32)
    hg.region_grow_kernel(img, torch.empty((1, *hw), dtype=torch.bool))
    ((name, args),) = stand_in_card
    t = hg.global_tiles(1, *hw, 16, N_SM)
    assert name == "nm03_region_grow_global" and args[10:13] == (1, *hw)
    assert args[18:23] == (t.rows, t.words, t.halo, t.pitch, t.grid)
    assert hg.region_grow_global_kernel.launches == 1


# -- the plain median at wide windows -------------------------------------------------


def _keys(x: np.ndarray) -> np.ndarray:
    u = x.view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _values(k: np.ndarray) -> np.ndarray:
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k).astype(np.uint32).view(np.float32)


def _windows(x: np.ndarray, k: int) -> np.ndarray:
    r = k // 2
    pad = np.pad(x, [(0, 0)] * (x.ndim - 2) + [(r, r), (r, r)], mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(pad, (k, k), axis=(-2, -1))
    return win.reshape(win.shape[:-2] + (k * k,))  # row-major within the window


def brute_median(x: np.ndarray, k: int) -> np.ndarray:
    """Rank k*k // 2 of each window by sorting its order-preserving keys."""
    win = _windows(_keys(np.ascontiguousarray(x, np.float32)), k)
    return _values(np.sort(win, -1)[..., (k * k) // 2])


@pytest.mark.parametrize("k,shape", [(17, (2, 24, 24)), (19, (2, 24, 24)), (65, (1, 12, 12)),
                                     (127, (1, 8, 8))])
def test_the_plain_median_at_wide_windows_equals_jax_and_brute_force(k, shape):
    # finite data without signed zeros: every exact rank selection agrees
    x = np.random.default_rng(17).random(shape).astype(np.float32)
    port = vector_median_filter(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(port, np.asarray(jax_median(jnp.asarray(x), k)))
    np.testing.assert_array_equal(port, brute_median(x, k))


# -- the global grow kernel's per-slice loop, as csrc/grow.cu runs it --------------------


def global_grow_emulated(image, seeds, low, high, valid, connectivity, block_iters,
                         max_iters):
    """``grow_global_kernel``'s loop over slices: every slice in lockstep, a
    stopped slice's region kept, one loop test a slice after each block
    from the counts of the last two blocks (its tiles:
    ``tests/test_torch_redesign.py``)."""
    band = grow_band(image, low, high, valid)
    shape = "cross" if connectivity == 4 else "box"
    region = seeds.bool() & band
    prev = region.sum(dim=(-2, -1))  # the count "after block -1"
    b = image.shape[0]
    act = torch.ones(b, dtype=torch.bool)
    steps = torch.zeros(b, dtype=torch.int32)
    conv = torch.zeros(b, dtype=torch.bool)
    j = 0
    while True:
        for _ in range(block_iters):
            stepped = dilate(region, 3, shape) & band
            region = torch.where(act[:, None, None], stepped, region)
        count = region.sum(dim=(-2, -1))
        go = act & (count != prev) & ((j + 1) * block_iters < max_iters)
        stop = act & ~go
        steps[stop] = (j + 1) * block_iters
        conv[stop] = (count == prev)[stop]
        act = go
        if not bool(act.any()):
            return region.to(torch.uint8), conv, steps
        prev = count
        j += 1


def _grow_case(hw=24):
    """A serpentine band (a long fixpoint), a random half-in-band field
    and an open field cut by valid."""
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
    valid[2, :, hw - 4:] = False
    return (torch.from_numpy(a) for a in (img, seeds, valid))


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("block_iters,max_iters", [(16, 1024), (2, 4), (3, 7), (5, 2), (1, 64)])
def test_the_global_loop_equals_the_plain_schedule(connectivity, block_iters, max_iters):
    img, seeds, valid = _grow_case()
    kw = dict(valid=valid, connectivity=connectivity, block_iters=block_iters,
              max_iters=max_iters)
    got = global_grow_emulated(img, seeds, 0.74, 0.91, **kw)
    want = region_grow(img, seeds, 0.74, 0.91, return_steps=True, **kw)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


# -- the golden of chip_smoke.py's envelope phase ----------------------------------------

GOLDEN = "nm03_capstone_project_tpu_torch/testdata/envelope_golden.json"
GOLDEN_CASE = dict(canvas=3072, median_window=17, seeds=(30, 31), lesion_radius=0.12)


def jax_envelope_golden() -> dict:
    """The JAX package's ``process_batch`` masks of two phantoms on a 3072
    canvas at k = 17, one of full size and one smaller (about 50 s and
    5 GB on the CPU)."""
    import hashlib

    import jax

    from nm03_capstone_project_tpu.config import PipelineConfig
    from nm03_capstone_project_tpu.core import pad_to_canvas
    from nm03_capstone_project_tpu.data.synthetic import phantom_slice
    from nm03_capstone_project_tpu.pipeline import process_batch

    c, k = GOLDEN_CASE["canvas"], GOLDEN_CASE["median_window"]
    dims = [(c, c), (c - c // 8, c - c // 5)]
    slices = [phantom_slice(h, w, seed=s, lesion_radius=GOLDEN_CASE["lesion_radius"])
              for (h, w), s in zip(dims, GOLDEN_CASE["seeds"])]
    b = pad_to_canvas(slices, (c, c))
    cfg = PipelineConfig(canvas=c, median_window=k)
    out = jax.jit(lambda p, d: process_batch(p, d, cfg))(b.pixels, b.dims)
    masks, conv = np.asarray(out["mask"]), np.asarray(out["grow_converged"])
    return {
        "what": "process_batch masks of two phantoms on a 3072 canvas at median window 17 "
                "(chip_smoke.py's envelope phase)",
        "made_by": "the JAX package on the CPU: python tests/test_torch_envelope.py --write",
        "case": {**GOLDEN_CASE, "seeds": list(GOLDEN_CASE["seeds"]),
                 "dims": [list(d) for d in dims]},
        "slices": [{"sha256": hashlib.sha256(m.tobytes()).hexdigest(), "area": int(m.sum()),
                    "converged": bool(cv)} for m, cv in zip(masks, conv)],
    }


WIDE_GOLDEN = "nm03_capstone_project_tpu_torch/testdata/envelope_wide_golden.json"
# a lesion wider than 0.12's: at k = 65 a disc of fewer than 65 * 65 / 2
# pixels is filtered away, and the check would hold an empty mask
WIDE_CASE = dict(canvas=256, median_window=65, median_impl="sort", seeds=(40, 41),
                 lesion_radius=0.2)


def jax_wide_golden() -> dict:
    """The JAX package's ``process_batch`` masks of two phantoms on a 256
    canvas at k = 65, past the port's select route, with its ``sort``
    median (``median_impl='sort'``; its docstring: bit-identical to the
    default network, whose 172,222 min/max at this window neither jit in
    reasonable time nor run eagerly under vmap in this host's memory)."""
    import hashlib

    import jax

    from nm03_capstone_project_tpu.config import PipelineConfig
    from nm03_capstone_project_tpu.core import pad_to_canvas
    from nm03_capstone_project_tpu.data.synthetic import phantom_slice
    from nm03_capstone_project_tpu.pipeline import process_batch

    c, k = WIDE_CASE["canvas"], WIDE_CASE["median_window"]
    dims = [(c, c), (c - c // 8, c - c // 5)]
    slices = [phantom_slice(h, w, seed=s, lesion_radius=WIDE_CASE["lesion_radius"])
              for (h, w), s in zip(dims, WIDE_CASE["seeds"])]
    b = pad_to_canvas(slices, (c, c))
    cfg = PipelineConfig(canvas=c, median_window=k, median_impl="sort")
    out = jax.jit(lambda p, d: process_batch(p, d, cfg))(b.pixels, b.dims)
    masks, conv = np.asarray(out["mask"]), np.asarray(out["grow_converged"])
    return {
        "what": "process_batch masks of two phantoms on a 256 canvas at median window 65, "
                "median_impl='sort' (chip_smoke.py's envelope phase: the wide route)",
        "made_by": "the JAX package on the CPU: python tests/test_torch_envelope.py --write-wide",
        "case": {**WIDE_CASE, "seeds": list(WIDE_CASE["seeds"]),
                 "dims": [list(d) for d in dims]},
        "slices": [{"sha256": hashlib.sha256(m.tobytes()).hexdigest(), "area": int(m.sum()),
                    "converged": bool(cv)} for m, cv in zip(masks, conv)],
    }


@pytest.mark.parametrize("path,canvas,k", [(GOLDEN, 3072, 17), (WIDE_GOLDEN, 256, 65)])
def test_the_envelope_golden_names_its_case(path, canvas, k):
    import json
    import pathlib

    golden = json.loads((pathlib.Path(__file__).resolve().parents[1] / path).read_text())
    assert golden["case"]["canvas"] == canvas and golden["case"]["median_window"] == k
    assert len(golden["slices"]) == 2 and all(s["area"] > 0 for s in golden["slices"])
    assert "JAX" in golden["made_by"]


def test_the_ports_process_batch_at_k65_equals_the_jax_golden():
    # the port's plain path (its default pruned network, 172,222 min/max at
    # k = 65) against the JAX package's sort median: every exact rank
    # selection gives the same bits on clipped finite data (about 13 s)
    import hashlib
    import json
    import pathlib

    from nm03_capstone_project_tpu_torch.config import PipelineConfig
    from nm03_capstone_project_tpu_torch.core import pad_to_canvas
    from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice
    from nm03_capstone_project_tpu_torch.pipeline import process_batch

    golden = json.loads((pathlib.Path(__file__).resolve().parents[1] / WIDE_GOLDEN).read_text())
    case = golden["case"]
    slices = [phantom_slice(h, w, seed=s, lesion_radius=case["lesion_radius"])
              for (h, w), s in zip(case["dims"], case["seeds"])]
    c = case["canvas"]
    b = pad_to_canvas(slices, (c, c), device="cpu")
    out = process_batch(b.pixels, b.dims,
                        PipelineConfig(canvas=c, median_window=case["median_window"]),
                        device="cpu")
    got = [{"sha256": hashlib.sha256(m.numpy().tobytes()).hexdigest(), "area": int(m.sum()),
            "converged": bool(cv)} for m, cv in zip(out["mask"], out["grow_converged"].tolist())]
    assert got == golden["slices"]


if __name__ == "__main__":
    import json
    import pathlib
    import sys

    writers = {"--write": (GOLDEN, jax_envelope_golden),
               "--write-wide": (WIDE_GOLDEN, jax_wide_golden)}
    if len(sys.argv) != 2 or sys.argv[1] not in writers:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_envelope.py "
                 "--write | --write-wide")
    rel, make = writers[sys.argv[1]]
    path = pathlib.Path(__file__).resolve().parents[1] / rel
    path.write_text(json.dumps(make(), indent=1) + "\n")
    print(f"wrote {path}")
