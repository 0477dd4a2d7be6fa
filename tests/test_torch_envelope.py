"""The port's kernels over the JAX package's whole envelope, on the CPU.

The JAX package takes any odd median window, any sharpen length and any
canvas (its Pallas kernels hand a shape past VMEM to XLA). The port's
kernels take the same on the card by routes picked from the shape and the
config before launch (``ops/hopper_median.py``,
``ops/hopper_region_growing.py``):

* the median from k = 17 by exact selection (``select``), the fused
  preprocess past its plans or taps by the median kernel between torch ops
  (``unfused``), grow past one cluster's shared memory with the region in
  global memory (``global``);
* the launch-shape functions name the route for every size and window of
  the envelope and never raise a KeyError;
* the wrappers take the route before launch and log its name (the ctypes
  library and the device are stand-ins here: there is no ``nvcc``);
* the select kernel's bisection and the global grow kernel's per-slice
  loop are run here in numpy/torch, step for step as ``csrc/median.cu``
  and ``csrc/grow.cu`` do, against a brute-force median and the plain
  ``region_grow``;
* the plain median at k = 17 against the JAX package's
  ``ops.median.vector_median_filter`` and a brute-force numpy median, on a
  (2, 24, 24) array: the JAX network's 4,638 min/max run eagerly there in
  about 2 s, where its jit at canvas 64 takes minutes.

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
        assert fused == hm.UNFUSED and fused.route == "unfused"


def test_a_long_sharpen_takes_the_unfused_route():
    assert hm.fused_launch_shape(25, 256, 256, 7, 33, N_SM).route == "unfused"
    assert hm.fused_launch_shape(25, 256, 256, 7, 31, N_SM).route == "fused"
    # the main path's tiles are what they were
    assert hm.fused_launch_shape(25, 256, 256, 7, 9, N_SM) == (52, 256, 125, 134196)


@pytest.mark.parametrize("k", range(1, 64, 2))
def test_no_window_or_sharpen_length_raises_a_key_error(k):
    for ks in range(1, 66, 2):
        route = hm.fused_launch_shape(3, 97, 300, k, ks, N_SM).route
        assert route == ("fused" if k <= hm.MAX_WINDOW and ks <= hm.MAX_TAPS else "unfused")
    want = "network" if k <= hm.MAX_WINDOW else "select"
    assert hm.median_launch_shape(3, 97, 300, k).route == want


@pytest.mark.parametrize("k", [65, 16, 0])
def test_the_median_limit_is_named_before_launch(k):
    with pytest.raises(ValueError, match="MAX_SELECT_WINDOW"):
        hm.median_launch_shape(1, 8, 8, k)


@pytest.mark.parametrize("hw", [(16385, 2304), (2304, 16385), (20000, 20000)])
def test_the_grow_limit_is_named_before_launch(hw):
    with pytest.raises(ValueError, match="GLOBAL_MAX_SIDE"):
        hg.grow_launch_shape(*hw)


# -- routes taken before launch, and named ---------------------------------------------


class _Fn:
    def __init__(self, calls, name):
        self.calls, self.name = calls, name

    def __call__(self, *args):
        self.calls.append((self.name, args))
        return 0


class _Lib:
    def __init__(self, calls):
        for fn in ("nm03_median_filter", "nm03_median_select", "nm03_fused_preprocess",
                   "nm03_region_grow", "nm03_region_grow_global"):
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
    monkeypatch.setattr(hg, "_check_args", lambda *a: None)
    monkeypatch.setattr(hm.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(reporter, "_logged_once", set())
    logger = logging.getLogger("nm03_torch")
    monkeypatch.setattr(logger, "propagate", True)
    caplog.set_level(logging.INFO, logger="nm03_torch")
    for fn in (hm.vector_median_filter_kernel, hm.vector_median_select_kernel,
               hm.fused_preprocess_kernel, hg.region_grow_kernel, hg.region_grow_global_kernel):
        monkeypatch.setattr(fn, "launches", 0)
    return calls


def _routes(caplog):
    return [r.getMessage() for r in caplog.records if "route" in r.getMessage()]


def test_median_routes_by_window(stand_in_card, caplog):
    x = torch.rand(3, 40, 50)
    hm.vector_median_filter_kernel(x, 15)
    hm.vector_median_filter_kernel(x, 17)
    assert [c[0] for c in stand_in_card] == ["nm03_median_filter", "nm03_median_select"]
    name, args = stand_in_card[1]
    assert args[2:8] == (0, 3, 40, 50, 17, hm.MAX_SELECT_WINDOW)
    assert hm.vector_median_filter_kernel.launches == 1
    assert hm.vector_median_select_kernel.launches == 1
    assert _routes(caplog) == ["median: route select (k=17, 1 launch(es) of 3 slices)"]


@pytest.mark.parametrize("k,route", [(7, "network"), (17, "select")])
def test_a_batch_past_the_grid_goes_in_several_launches(stand_in_card, k, route):
    x = torch.zeros(hm.MAX_BATCH + 5, 2, 3)
    hm.vector_median_filter_kernel(x, k)
    assert len(stand_in_card) == 2
    (_, first), (_, second) = stand_in_card
    if route == "network":  # pointers advance, counts split
        assert first[2] == hm.MAX_BATCH and second[2] == 5
        assert second[0] - first[0] == hm.MAX_BATCH * 2 * 3 * 4
    else:  # one base pointer, the first slice and the count of each grid
        assert first[2:4] == (0, hm.MAX_BATCH) and second[2:4] == (hm.MAX_BATCH, 5)
        assert first[0] == second[0]


@pytest.mark.parametrize("k,ks", [(17, 9), (7, 33), (31, 41)])
def test_the_unfused_route_runs_the_median_kernel_between_torch_ops(stand_in_card, caplog,
                                                                    k, ks):
    x = torch.rand(2, 30, 40) * 9000
    hm.fused_preprocess_kernel(x, median_window=k, sharpen_kernel=ks)
    want = "nm03_median_select" if k > hm.MAX_WINDOW else "nm03_median_filter"
    assert [c[0] for c in stand_in_card] == [want]
    assert hm.fused_preprocess_kernel.launches == 0
    assert _routes(caplog)[0] == (
        f"fused: route unfused (k={k}, {ks} sharpen taps: the median kernel between "
        "torch normalize, clip and sharpen)")


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


# -- the select kernel's algorithm, as csrc/median.cu runs it ---------------------------


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


def select_emulated(x: np.ndarray, k: int) -> np.ndarray:
    """``select_kernel``: extreme keys, first NaN, bisection from the top
    differing bit."""
    win = _windows(_keys(np.ascontiguousarray(x, np.float32)), k).astype(np.int64)
    rank = (k * k) // 2
    lo, hi = win.min(-1), win.max(-1)
    is_nan = (win > 0xFF800000) | (win < 0x007FFFFF)
    first_nan = np.take_along_axis(win, is_nan.argmax(-1)[..., None], -1)[..., 0]
    diff = lo ^ hi
    top = np.where(diff > 0, np.floor(np.log2(np.maximum(diff, 1))).astype(np.int64), -1)
    prefix = np.where(diff > 0, lo & ~((2 << top) - 1), lo)
    for bit in range(31, -1, -1):
        cand = prefix | (1 << bit)
        below = (win < cand[..., None]).sum(-1)
        prefix = np.where((bit <= top) & (below <= rank), cand, prefix)
    out = _values(prefix.astype(np.uint32))
    nan_vals = _values(first_nan.astype(np.uint32))
    return np.where(is_nan.any(-1), nan_vals, out)


def brute_median(x: np.ndarray, k: int) -> np.ndarray:
    """Rank k*k // 2 of each window by sorting its order-preserving keys."""
    win = _windows(_keys(np.ascontiguousarray(x, np.float32)), k)
    return _values(np.sort(win, -1)[..., (k * k) // 2])


@pytest.mark.parametrize("k", [1, 3, 17, 21, 31])
def test_the_select_bisection_is_an_exact_rank(k):
    rng = np.random.default_rng(k)
    cases = [
        (rng.random((2, 19, 23)) * 4000 + 0.68).astype(np.float32),
        rng.integers(-2, 3, (2, 19, 23)).astype(np.float32),  # duplicates, both signs
        rng.choice(np.array([-0.0, 0.0, 1.5, -2.0], np.float32), (2, 19, 23)),
        np.full((1, 7, 9), 0.68, np.float32),  # a window of one value: no bisection
        (rng.standard_normal((1, 9, 40)) * 1e-38).astype(np.float32),  # subnormals
    ]
    for x in cases:
        got = select_emulated(x, k)
        np.testing.assert_array_equal(got.view(np.uint32), brute_median(x, k).view(np.uint32))


def test_select_takes_the_windows_first_nan():
    x = np.random.default_rng(1).random((1, 20, 20)).astype(np.float32)
    a, b = np.float32("nan"), -np.float32("nan")
    x[0, 5, 5], x[0, 5, 7] = a, b
    got = select_emulated(x, 17)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(_windows(x, 17)).any(-1))
    # both NaNs in the window: the first in row-major order; one: that one
    assert got.view(np.uint32)[0, 0, 0] == a.view(np.uint32)
    assert got.view(np.uint32)[0, 0, 15] == b.view(np.uint32)


@pytest.mark.parametrize("k", [17, 19])
def test_the_plain_median_at_wide_windows_equals_jax_and_brute_force(k):
    # finite data without signed zeros: every exact rank selection agrees
    x = np.random.default_rng(17).random((2, 24, 24)).astype(np.float32)
    port = vector_median_filter(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(port, np.asarray(jax_median(jnp.asarray(x), k)))
    np.testing.assert_array_equal(port, brute_median(x, k))
    np.testing.assert_array_equal(port, select_emulated(x, k))


# -- the global grow kernel's per-slice loop, as csrc/grow.cu runs it --------------------


def global_grow_emulated(image, seeds, low, high, valid, connectivity, block_iters,
                         max_iters):
    """``grow_global_kernel``: every slice in lockstep, a stopped slice's
    words copied, one loop test a slice after each block from the counts of
    the last two blocks."""
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


@pytest.mark.parametrize("b,h,ww,threads", [(3, 5, 7, 4), (2, 9, 3, 50), (4, 2, 129, 1000),
                                            (1, 1, 1, 3)])
def test_the_word_walk_visits_words_as_division_would(b, h, ww, threads):
    """``WordWalk``: a thread's (slice, row, word) advanced by the grid's
    stride with one carry a level, no division."""
    per, total = h * ww, b * h * ww
    ds, rem = divmod(threads, per)
    dy, di = divmod(rem, ww)
    for tid in range(min(threads, total)):
        w = tid
        s, rem0 = divmod(w, per)
        y, i = divmod(rem0, ww)
        while w < total:
            assert (s, y, i) == (w // per, (w % per) // ww, w % ww)
            w, s, y, i = w + threads, s + ds, y + dy, i + di
            if i >= ww:
                i, y = i - ww, y + 1
            if y >= h:
                y, s = y - h, s + 1


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


def test_the_envelope_golden_names_its_case():
    import json
    import pathlib

    golden = json.loads((pathlib.Path(__file__).resolve().parents[1] / GOLDEN).read_text())
    assert golden["case"]["canvas"] == 3072 and golden["case"]["median_window"] == 17
    assert len(golden["slices"]) == 2 and all(s["area"] > 0 for s in golden["slices"])
    assert "JAX" in golden["made_by"]


if __name__ == "__main__":
    import json
    import pathlib
    import sys

    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_envelope.py --write")
    path = pathlib.Path(__file__).resolve().parents[1] / GOLDEN
    path.write_text(json.dumps(jax_envelope_golden(), indent=1) + "\n")
    print(f"wrote {path}")
