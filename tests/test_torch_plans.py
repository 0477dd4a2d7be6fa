"""The generated median run programs and the kernels' launch shapes, on the CPU.

The fused preprocess kernel runs ``MedianRun<k, R>``, generated from
:func:`kernels.median_runs.median_run_program`; :func:`median_runs.execute`
runs the same program in numpy, so these tests hold the card's exact
min/max sequence against a brute-force median and against the plain
:func:`ops.median.vector_median_filter`, bitwise, for every window the
kernels compile. The launch shapes of the grow and fused kernels are pure
Python and pinned here.
"""

import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu_torch.kernels import build, median_runs
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter
from nm03_capstone_project_tpu_torch.ops.selection_network import comparator_counts

WINDOWS = (3, 5, 7, 9, 11, 13, 15)
SMEM = 232448  # the H100's opt-in shared memory per block


def _data(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.random(shape).astype(np.float32)
    return rng.integers(0, 3, shape).astype(np.float32)  # duplicate-heavy


def _runs_over_image(prog, img: np.ndarray) -> np.ndarray:
    """The program over every run of every row of ``img``, with clamped
    rows and columns as the kernel stages them; (H, W) medians."""
    k, runs = prog.k, prog.runs
    r = k // 2
    h, w = img.shape
    n_runs = -(-w // runs)
    rows = np.clip(np.arange(h)[:, None] + np.arange(-r, r + 1)[None, :], 0, h - 1)
    starts = np.arange(n_runs) * runs
    cols = np.clip(starts[:, None] + np.arange(-r, runs + r)[None, :], 0, w - 1)
    win = img[rows[:, None, :, None], cols[None, :, None, :]]  # (h, n_runs, k, cols)
    out = median_runs.execute(prog, win)  # (h, n_runs, runs)
    return out.reshape(h, n_runs * runs)[:, :w]


@pytest.mark.parametrize("kind", ["random", "duplicates"])
@pytest.mark.parametrize("k", WINDOWS)
def test_run_program_equals_brute_force_median(k, kind):
    runs = median_runs.FUSED_RUNS[k]
    prog = median_runs.median_run_program(k, runs)
    win = _data(kind, (300, k, prog.cols), k)
    got = median_runs.execute(prog, win)
    want = np.stack(
        [np.median(win[:, :, j : j + k].reshape(len(win), -1), axis=1) for j in range(runs)], -1
    )
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["random", "duplicates"])
@pytest.mark.parametrize("k", WINDOWS)
def test_run_program_equals_vector_median_filter(k, kind):
    img = _data(kind, (23, 37), 100 + k)
    want = vector_median_filter(torch.from_numpy(img), k).numpy()
    for runs in sorted({1, 4, median_runs.FUSED_RUNS[k]}):
        got = _runs_over_image(median_runs.median_run_program(k, runs), img)
        np.testing.assert_array_equal(got, want)


def test_presort_is_the_counted_batcher_network():
    for k in WINDOWS:
        defs: dict = {}
        median_runs._presort(k, 0, [k], defs)
        assert len(defs) == comparator_counts(k)["presort_minmax"]
    assert comparator_counts(7)["presort_minmax"] == 32  # odd-even transposition: 42


@pytest.mark.parametrize("k", [5, 7])
def test_runs_share_the_plan(k):
    # the chosen run beats the unshared plan plus the shared presort per median
    # (at k = 3 the two plans are one; from k = 9 only runs too short to share
    # much stay within the register cap)
    c = comparator_counts(k)
    runs = median_runs.FUSED_RUNS[k]
    assert median_runs.ops_per_output(k, runs) < c["presort_minmax"] + c["merge_minmax_pruned"]
    assert median_runs.ops_per_output(7, 16) == 316.5


@pytest.mark.parametrize("k", WINDOWS)
def test_run_length_is_the_largest_within_the_register_cap(k):
    runs = median_runs.FUSED_RUNS[k]
    cap = median_runs.LIVE_CAP
    fits = [r for r in (1, 2, 4, 8, 16) if median_runs.max_live(k, r) <= cap]
    assert runs == (max(fits) if fits else 1)


@pytest.mark.parametrize("k", build.MEDIAN_WINDOWS)
def test_header_renders_each_run_program(k):
    runs = median_runs.FUSED_RUNS[k]
    prog = median_runs.median_run_program(k, runs)
    src = build.median_runs_header()
    body = src.split(f"struct MedianRun<{k}, {runs}> {{")[1].split("};")[0]
    assert f"OPS = {len(prog.ops)};" in body
    assert body.count("fminf(") + body.count("fmaxf(") == len(prog.ops)
    assert f"struct FusedRuns<{k}> {{ static constexpr int R = {runs}; }}" in src


@pytest.mark.parametrize(
    "hw,shape",
    [
        ((64, 64), (2, 32, 1792)),
        ((128, 128), (2, 64, 4864)),
        ((251, 241), (4, 63, 9376)),
        ((256, 256), (4, 64, 9472)),
        ((512, 512), (8, 64, 18688)),
        ((768, 768), (8, 96, 37120)),
        ((1024, 1024), (8, 128, 61696)),
        ((2048, 2048), (8, 256, 221440)),
        ((8192, 64), (8, 1024, 25600)),
    ],
)
def test_grow_launch_shape(hw, shape):
    assert hg.grow_launch_shape(*hw) == shape
    c, rows, smem = shape
    assert (c - 1) * rows < hw[0] <= c * rows and smem <= SMEM


# past one cluster the global route takes a slice (tests/test_torch_envelope.py);
# past its side limit, or empty, the slice is refused
@pytest.mark.parametrize("hw", [(16385, 2304), (2304, 16385), (0, 16)])
def test_grow_launch_shape_refuses(hw):
    with pytest.raises(ValueError, match=f"{hw[0]}x{hw[1]}"):
        hg.grow_launch_shape(*hw)


def test_fused_launch_shape_main_path():
    # 5 bands of 52 rows a slice: 125 tiles, one wave on 132 SMs
    assert hm.fused_launch_shape(25, 256, 256, 7, 9, 132) == (52, 256, 125, 134196)


@pytest.mark.parametrize(
    "args",
    [(3, 251, 241, 7, 9), (1, 5, 3, 15, 31), (4, 1024, 1024, 7, 9), (2, 2048, 2048, 15, 31),
     (25, 512, 512, 3, 1), (7, 61, 300, 11, 9)],
)
def test_fused_launch_shape_fits_and_covers(args):
    b, h, w, k, ks = args
    th, tw, grid, smem = hm.fused_launch_shape(*args, 132)
    tiles = b * -(-h // th) * -(-w // tw)
    assert smem <= SMEM and 1 <= grid <= min(tiles, 132)
    assert tw <= hm.MAX_TILE_W and -(-w // tw) * tw >= w and th <= h
