"""The fused stage's ``split`` route, modelled on the CPU.

Where the fused kernel does not take a config (a median window past 15 or
a sharpen past 31 taps; the JAX package runs XLA there), the port runs two
hand-written kernels and no torch op between them
(``ops/hopper_median.py``): the median kernel of the window's route with
normalize and clip in its prologue (``csrc/median.cu``, ``*_pre``), then
the sharpen kernel (``csrc/fused.cu``, ``nm03_sharpen``). The kernels run
only on the card (``tests/test_torch_card.py -m cuda``, ``chip_smoke.py``'s
``envelope`` phase); here, on seeded numpy inputs:

* a torch model of the sharpen kernel's schedules (``sharpen_scheme``):
  up to 33 taps the windowed plan, CTAs walking their tiles, a tile's rows
  copied in 16-byte chunks where they lie on the canvas and start aligned
  and in clamped 4-byte copies elsewhere (widths with W % 4 = 0 to 3,
  bases off alignment), V read 16 bytes at a time with the columns past
  its sums never summed, four outputs a store; past that tiles that do not
  divide the canvas, the staged tile cut at the canvas with every read past
  it clamped, the rows of one pass only where the tile does not fit, V in
  a device scratch. The taps summed in the plain order. Bitwise against
  the port's ``sharpen`` and the JAX package's (op by op), for 1 to 65 taps
  on canvases from 1 x 1 up, some shorter than the sharpen's halo;
* the prologue's arithmetic (``prologue_scheme``: each step rounded on its
  own, a NaN kept) against ``clip_intensity(normalize(x))``, with NaNs,
  infinities and signed zeros;
* the route's composition against ``_fused_preprocess_plain`` bitwise and
  within 16 ulp of the JAX package's jitted composition (XLA contracts
  FMAs under jit), at k = 17, 31 and 65;
* the routing over a grid of windows, sharpen lengths and shapes: the
  fused kernel exactly where it ran before, ``split`` everywhere else;
* the wrappers on stand-ins for the ctypes library and the device: two
  launches a call, the prologue's constants and the sharpen's tiles as
  the kernels receive them.
"""

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu.ops.elementwise import clip_intensity as jax_clip
from nm03_capstone_project_tpu.ops.elementwise import normalize as jax_normalize
from nm03_capstone_project_tpu.ops.pallas_median import _fused_preprocess_xla
from nm03_capstone_project_tpu.ops.sharpen import sharpen as jax_sharpen
from nm03_capstone_project_tpu_torch.kernels.median_runs import FUSED_RUNS
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize
from nm03_capstone_project_tpu_torch.ops.sharpen import gaussian_kernel_1d, sharpen
from nm03_capstone_project_tpu_torch.utils import reporter

N_SM = 132
JIT_ULP = 16  # the port against jitted JAX (XLA's FMAs in the blur and update)
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


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _ulp(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


# -- the sharpen kernel's schedule ----------------------------------------------------

def _vector(flat_start, offset: int) -> bool:
    """Whether element offsets ``flat_start`` (from a base ``offset``
    floats past 16-byte alignment) all start 16-byte chunks."""
    return bool(((torch.as_tensor(flat_start) + offset) % 4 == 0).all())


def _windowed_walk(m, taps, gain, ks, launch, out, copies, in_offset, out_offset):
    """``windowed_sharpen_kernel<ks>``: CTA c stages and blurs tiles c, c +
    grid, ... in turn. A staged tile is th + ks - 1 rows of tw + 2 rsp
    columns (rsp = ks // 2 rounded up to 4) in 4-float chunks: one 16-byte
    copy where the chunk lies on the canvas and the rows are aligned (W % 4
    == 0, an aligned base), else four 4-byte copies from clamped columns;
    every row from its clamped row. The vertical pass fills V's first tw +
    ks - 1 columns (the rest stay NaN: the horizontal pass's last 16-byte
    loads reach them and must sum none), the horizontal pass takes groups
    of 4 outputs, and only the outputs on the canvas are stored, 16 bytes
    at a time where the output rows are aligned."""
    b, h, w = m.shape
    TH, TW = launch.tile_h, launch.tile_w
    assert TH % hm.WIN_SEG == 0 and TW % 4 == 0 and ks <= hm.WIN_MAX_TAPS
    rs = ks // 2
    rsp, vw = (rs + 3) & ~3, 4 * ((ks + 6) // 4)  # staged halo columns; V read a group
    ss, vs, srows = TW + 2 * rsp, TW - 4 + vw, TH + ks - 1
    assert launch.smem == 4 * (srows * ss + TH * vs) and launch.scratch == 0
    assert vs >= TW + ks - 1 and (vw - 1) - 3 >= ks - 1  # a group's loads cover its taps
    n_r, n_c = -(-h // TH), -(-w // TW)
    tiles = b * n_r * n_c
    vec_in, vec_out = w % 4 == 0 and in_offset % 4 == 0, w % 4 == 0 and out_offset % 4 == 0
    for cta in range(launch.grid):
        for t in range(cta, tiles, launch.grid):
            copies["tiles_by_cta"][cta] = copies["tiles_by_cta"].get(cta, 0) + 1
            bi, y0, x0 = t // (n_c * n_r), (t // n_c) % n_r * TH, t % n_c * TW
            th, tw = min(TH, h - y0), min(TW, w - x0)
            rows = (torch.arange(srows) + y0 - rs).clamp(0, h - 1)
            S = torch.full((srows, ss), float("nan"))
            for q in range(ss // 4):
                cx = x0 - rsp + 4 * q
                if vec_in and 0 <= cx and cx + 4 <= w:
                    assert _vector((bi * h + rows) * w + cx, in_offset)
                    S[:, 4 * q:4 * q + 4] = m[bi][rows][:, cx:cx + 4]
                    copies["copy16"] += srows
                else:
                    cols = (torch.arange(4) + cx).clamp(0, w - 1)
                    S[:, 4 * q:4 * q + 4] = m[bi][rows][:, cols]
                    copies["copy4"] += 4 * srows
            src = S[:, rsp - rs:rsp - rs + TW + ks - 1]  # V column c: staged c + rsp - rs
            acc = None
            for k in range(ks):  # each output's taps in order, whatever its window's row
                term = taps[k] * src[k:k + TH]
                acc = term if acc is None else acc + term
            V = torch.full((TH, vs), float("nan"))
            V[:, :TW + ks - 1] = acc
            acc = None
            for k in range(ks):  # output column x sums V columns x .. x + ks - 1
                term = taps[k] * V[:, k:k + TW]
                acc = term if acc is None else acc + term
            c = S[rs:rs + TH, rsp:rsp + TW]
            o = c + gain * (c - acc)
            for xx in range(0, tw, 4):  # the groups with an output on the canvas
                n = min(4, tw - xx)
                if vec_out and n == 4:
                    starts = (bi * h + torch.arange(y0, y0 + th)) * w + x0 + xx
                    assert _vector(starts, out_offset)
                    copies["store16"] += th
                else:
                    copies["store4"] += th * n
            assert not torch.isnan(o[:th, :tw]).any() or torch.isnan(m[bi]).any()
            assert bool(torch.isnan(out[bi, y0:y0 + th, x0:x0 + tw]).all())  # each once
            out[bi, y0:y0 + th, x0:x0 + tw] = o[:th, :tw]


def _general_walk(m, taps, gain, ks, launch, out):
    """``sharpen_kernel<STAGED>``, past WIN_MAX_TAPS: tile by tile as
    ``launch`` cuts it, CTA c walking tiles c, c + grid, ...; a tile reads
    S, its outputs plus ks // 2 rows and columns each side, each at its
    canvas-clamped index (staged in shared memory, or read through L1 as the
    vertical pass needs it); the vertical pass fills V (the tile's rows over
    S's columns) and the horizontal pass reads V with no clamp."""
    b, h, w = m.shape
    rs = ks // 2
    TH, TW = launch.tile_h, launch.tile_w
    n_r, n_c = -(-h // TH), -(-w // TW)
    tiles = b * n_r * n_c
    order = [t for cta in range(launch.grid) for t in range(cta, tiles, launch.grid)]
    assert sorted(order) == list(range(tiles))  # every tile once
    SW = TW + 2 * rs  # the row stride of S and V
    assert launch.smem == (0 if launch.scratch else hm.sharpen_smem_bytes(ks, TH, TW,
                                                                          launch.plan))
    if launch.scratch:  # one V of TH x SW floats a CTA
        assert launch.scratch == launch.grid * TH * SW
    for t in order:
        tx, ty, bi = t % n_c, (t // n_c) % n_r, t // (n_c * n_r)
        y0, x0 = ty * TH, tx * TW
        th, tw = min(TH, h - y0), min(TW, w - x0)
        rows = (torch.arange(th + 2 * rs) + y0 - rs).clamp(0, h - 1)
        cols = (torch.arange(SW) + x0 - rs).clamp(0, w - 1)
        S = m[bi][rows][:, cols]  # (th + 2 rs, SW): at most the kernel's TH + 2 rs rows
        acc = None
        for i in range(ks):
            term = taps[i] * S[i:i + th, :]
            acc = term if acc is None else acc + term
        v = acc  # (th, SW), at most the kernel's TH rows
        acc = None
        for i in range(ks):
            term = taps[i] * v[:, i:i + tw]
            acc = term if acc is None else acc + term
        c = S[rs:rs + th, rs:rs + tw]
        assert torch.equal(c, m[bi, y0:y0 + th, x0:x0 + tw])
        out[bi, y0:y0 + th, x0:x0 + tw] = c + gain * (c - acc)


def sharpen_scheme(m: torch.Tensor, gain: float, sigma: float, ks: int,
                   launch: hm.SharpenLaunch, in_offset: int = 0, out_offset: int = 0,
                   copies: dict | None = None) -> torch.Tensor:
    """``nm03_sharpen`` of ``csrc/fused.cu`` on a (b, h, w) median image
    under ``launch``'s plan: :func:`_windowed_walk` or
    :func:`_general_walk`. Each pass sums its taps in order, every product
    and sum a float32 op of its own. ``in_offset`` and ``out_offset`` put
    the input's and the output's base that many floats past 16-byte
    alignment; ``copies`` (a dict) takes the windowed plan's count of
    16-byte and 4-byte copies and stores and each CTA's tiles."""
    taps = [float(t) for t in gaussian_kernel_1d(sigma, ks)]
    out = torch.full_like(m, float("nan"))
    if launch.plan == "windowed":
        tally = {"copy16": 0, "copy4": 0, "store16": 0, "store4": 0, "tiles_by_cta": {}}
        _windowed_walk(m, taps, gain, ks, launch, out, tally, in_offset, out_offset)
        if copies is not None:
            copies.update(tally)
    else:
        _general_walk(m, taps, gain, ks, launch, out)
    return out


SHARPEN_SHAPES = [(1, 1, 1), (2, 3, 5), (1, 9, 70), (2, 37, 53),
                  (2, 19, 72), (1, 11, 65), (2, 10, 66), (1, 9, 67)]  # W % 4 = 0, 1, 2, 3
SHARPEN_TAPS = [1, 3, 9, 33, 65]
TILINGS = ["launch", "ragged", "rows", "scratch", "windowed"]


def _tiling(name: str, shape, ks: int) -> hm.SharpenLaunch:
    b, h, w = shape
    if name == "launch":  # what the wrapper launches on an H100
        return hm.sharpen_launch_shape(b, h, w, ks, N_SM)
    tw = hm.SHARPEN_COLS
    if name == "ragged":  # the staged plan's 5 x 7 tiles, three CTAs walking them all
        tiles = b * -(-h // 5) * -(-w // 7)
        return hm.SharpenLaunch(5, 7, "staged", min(3, tiles),
                                hm.sharpen_smem_bytes(ks, 5, 7, "staged"), 0)
    if name == "rows":  # 4-row tiles of V, the median read where the pass needs it
        tiles = b * -(-h // 4) * -(-w // tw)
        return hm.SharpenLaunch(4, tw, "rows", tiles, hm.sharpen_smem_bytes(ks, 4, tw, "rows"),
                                0)
    if name == "windowed":  # 8 x 12 tiles, three CTAs walking them all
        return hm.SharpenLaunch(8, 12, "windowed", 3,
                                hm.sharpen_smem_bytes(ks, 8, 12, "windowed"), 0)
    # "scratch": one-row tiles, V in a device scratch, 3 CTAs walking them all
    grid = min(b * h * -(-w // tw), 3)
    return hm.SharpenLaunch(1, tw, "rows", grid, 0, grid * (tw + ks - 1))


@functools.lru_cache(maxsize=None)
def _sharpen_case(shape, ks: int):
    rng = np.random.default_rng(ks * 1000 + sum(shape))
    x = (rng.random(shape) * 4000 + 0.68).astype(np.float32)
    want = sharpen(torch.from_numpy(x), 2.0, 0.5, ks)
    jax_want = np.asarray(jax_sharpen(jnp.asarray(x), 2.0, 0.5, ks))
    return x, want, jax_want


@pytest.mark.parametrize("tiling", TILINGS)
@pytest.mark.parametrize("shape", SHARPEN_SHAPES)
@pytest.mark.parametrize("ks", SHARPEN_TAPS)
def test_the_sharpen_tiles_equal_the_plain_and_jax_sharpen(ks, shape, tiling):
    x, want, jax_want = _sharpen_case(shape, ks)
    if tiling == "windowed" and ks > hm.WIN_MAX_TAPS:
        tiling = "launch"  # no windowed kernel past 33 taps: the wrapper's plan
    got = sharpen_scheme(torch.from_numpy(x), 2.0, 0.5, ks, _tiling(tiling, shape, ks))
    assert _same_bits(got, want)
    np.testing.assert_array_equal(got.numpy().view(np.int32), jax_want.view(np.int32))


def test_a_canvas_shorter_than_the_halo_clamps_every_read():
    # 65 taps over a 2 x 3 canvas: every tap past the canvas reads its edge,
    # so the blur of a constant row is that constant and the update is 0;
    # the same at 33 taps through the windowed plan
    x = torch.tensor([[[1.0, 2.0, 3.0], [1.0, 2.0, 3.0]]])
    for ks in (65, 33):
        launch = hm.sharpen_launch_shape(1, 2, 3, ks, N_SM)
        assert launch.plan == ("windowed" if ks == 33 else "staged")
        got = sharpen_scheme(x, 2.0, 0.5, ks, launch)
        assert _same_bits(got, sharpen(x, 2.0, 0.5, ks))
        assert _same_bits(got[0, 0], got[0, 1])


@pytest.mark.parametrize("shape,in_offset,out_offset,vector_in,vector_out", [
    ((2, 19, 72), 0, 0, True, True),  # aligned rows: 16-byte copies inside, stores
    ((2, 19, 72), 1, 0, False, True),  # a base 4 bytes past alignment: every row off it
    ((2, 19, 72), 2, 3, False, False),
    ((1, 11, 65), 0, 0, False, False),  # W % 4 = 1, 2, 3: no row but the first aligned
    ((2, 10, 66), 0, 0, False, False),
    ((1, 9, 67), 0, 0, False, False),
    ((3, 5, 4), 0, 0, True, True),  # narrower than the halo: its own 4 columns in one copy
])
@pytest.mark.parametrize("ks", [1, 9, 33])
def test_the_windowed_copies_follow_the_row_alignment(ks, shape, in_offset, out_offset,
                                                       vector_in, vector_out):
    x, want, jax_want = _sharpen_case(shape, ks)
    copies = {}
    launch = hm.sharpen_launch_shape(*shape, ks, N_SM)
    got = sharpen_scheme(torch.from_numpy(x), 2.0, 0.5, ks, launch, in_offset, out_offset,
                         copies)
    assert _same_bits(got, want)
    np.testing.assert_array_equal(got.numpy().view(np.int32), jax_want.view(np.int32))
    assert (copies["copy16"] > 0) == vector_in
    # 4-byte copies: rows off alignment, the halo past the canvas, a last tile past its edge
    assert (copies["copy4"] > 0) == (not vector_in or ks > 1 or shape[2] % launch.tile_w > 0)
    assert (copies["store16"] > 0) == vector_out
    assert copies["store16"] * 4 + copies["store4"] == x.size  # every output stored once


@pytest.mark.parametrize("grid", [1, 2, 3, 7])
def test_a_windowed_cta_walks_every_grid_th_tile(grid):
    shape, ks = (2, 37, 53), 9
    x, want, _ = _sharpen_case(shape, ks)
    launch = hm.SharpenLaunch(8, 12, "windowed", grid,
                              hm.sharpen_smem_bytes(ks, 8, 12, "windowed"), 0)
    copies = {}
    assert _same_bits(sharpen_scheme(torch.from_numpy(x), 2.0, 0.5, ks, launch, copies=copies),
                      want)
    tiles = 2 * 5 * 5
    assert sorted(copies["tiles_by_cta"]) == list(range(grid))
    assert sum(copies["tiles_by_cta"].values()) == tiles
    assert max(copies["tiles_by_cta"].values()) == -(-tiles // grid)


# -- the launch shapes ------------------------------------------------------------------


@pytest.mark.parametrize("ks", range(1, 258, 2))
def test_the_sharpen_plan_fits_a_block(ks):
    for b, h, w in [(25, 256, 256), (2, 3072, 3072), (1, 1, 1), (70000, 16, 16)]:
        s = hm.sharpen_launch_shape(b, h, w, ks, N_SM)
        assert s.smem <= hm.SMEM_PER_BLOCK and s.scratch == 0
        assert s.smem == hm.sharpen_smem_bytes(ks, s.tile_h, s.tile_w, s.plan)
        # one tile a CTA wherever the shared memory holds V
        assert s.grid == b * -(-h // s.tile_h) * -(-w // s.tile_w)
        if ks <= hm.WIN_MAX_TAPS:
            # the windowed plan: its tile cut to the canvas
            assert s.plan == "windowed"
            assert (s.tile_h, s.tile_w) == (min(32, -(-h // 8) * 8), min(128, -(-w // 4) * 4))
            continue
        assert s.tile_w == hm.SHARPEN_COLS and 1 <= s.tile_h <= hm.SHARPEN_ROWS
        # the staged tile up to 177 taps, whatever the canvas
        full = 4 * (ks + (32 + ks - 1 + 32) * (64 + ks - 1))
        assert (s.plan == "staged") == (full <= hm.SMEM_PER_BLOCK) == (ks <= 177)
        assert s.staged or s.tile_h == hm.SHARPEN_ROWS  # V of 32 rows fits to here


def test_the_sharpen_rows_and_scratch_plans():
    # the windowed plan to 33 taps, the staged tile from 35 to 177
    shape = (25, 256, 256)
    assert hm.sharpen_launch_shape(*shape, 33, N_SM) == hm.SharpenLaunch(
        32, 128, "windowed", 400, hm.sharpen_smem_bytes(33, 32, 128, "windowed"), 0)
    assert hm.sharpen_smem_bytes(9, 32, 128, "windowed") == 4 * (40 * 136 + 32 * 136)
    assert hm.sharpen_launch_shape(*shape, 35, N_SM).plan == "staged"
    assert hm.sharpen_launch_shape(*shape, 177, N_SM).staged
    # the staged tile stops fitting at 179 taps
    rows = hm.sharpen_launch_shape(*shape, 179, N_SM)
    assert (rows.plan, rows.staged, rows.tile_h, rows.scratch) == ("rows", False, 32, 0)
    # a long sharpen: V shortened to fit
    s = hm.sharpen_launch_shape(1, 3072, 3072, 5001, N_SM)
    assert (s.staged, s.tile_h, s.smem) == (False, 8, 4 * 8 * (64 + 5000))
    # one row of V in shared memory up to 58,049 taps, then V in a device scratch
    s = hm.sharpen_launch_shape(1, 3072, 3072, 58049, N_SM)
    assert (s.staged, s.tile_h, s.scratch, s.smem) == (False, 1, 0, hm.SMEM_PER_BLOCK)
    s = hm.sharpen_launch_shape(1, 64, 600, 58201, N_SM)
    assert (s.staged, s.tile_h, s.grid, s.smem) == (False, 1, N_SM, 0)
    assert s.scratch == N_SM * (64 + 58200)  # one row of V a CTA
    assert hm.PLANS.index("rows") == 0 and hm.PLANS.index("windowed") == 2


GRID_SHAPES = [(1, 1, 1), (3, 17, 9), (25, 256, 256), (2, 1024, 1024), (1, 3072, 3072)]


@pytest.mark.parametrize("k", list(range(1, 66, 2)) + [127, 257])
def test_the_fused_kernel_keeps_its_configs_and_split_takes_the_rest(k):
    for b, h, w in GRID_SHAPES:
        for ks in range(1, 66, 2):
            shape = hm.fused_launch_shape(b, h, w, k, ks, N_SM)
            fused = k <= hm.MAX_WINDOW and ks <= hm.MAX_TAPS
            assert k not in FUSED_RUNS or fused == (ks <= hm.MAX_TAPS)
            assert shape.route == ("fused" if fused else "split")
            assert fused == bool(shape.grid) and (fused or shape == hm.SPLIT)
    assert not hasattr(hm, "UNFUSED")


# -- the prologue and the composition ---------------------------------------------------


def prologue_scheme(x: torch.Tensor, pro: hm.Prologue) -> torch.Tensor:
    """The median kernels' prologue (``Prologue`` in ``csrc/median.cu``):
    (x - norm_min) * scale + norm_low, each step a float32 op of its own,
    then a NaN kept and anything else clamped to [clip_low, clip_high]."""
    f = torch.float32
    n = (x - torch.tensor(pro.norm_min, dtype=f)) * torch.tensor(pro.scale, dtype=f)
    n = n + torch.tensor(pro.norm_low, dtype=f)
    return torch.where(torch.isnan(n), n, n.clamp_min(pro.clip_low).clamp_max(pro.clip_high))


def _prologue_input(seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = (rng.random((2, 19, 23)) * 12000 - 1000).astype(np.float32)
    x.flat[rng.choice(x.size, 40, replace=False)] = np.array(
        [np.nan, np.inf, -np.inf, 0.0, -0.0] * 8, np.float32)
    return torch.from_numpy(x)


@pytest.mark.parametrize("params", [
    dict(norm_low=0.5, norm_high=2.5, norm_min=0.0, norm_max=10000.0, clip_low=0.68,
         clip_high=4000.0),
    # signed zeros survive: a zero low end, a clip around zero
    dict(norm_low=-0.0, norm_high=2.0, norm_min=0.0, norm_max=4000.0, clip_low=-1.0,
         clip_high=1.0),
    dict(norm_low=-3.0, norm_high=3.0, norm_min=-100.0, norm_max=9000.0, clip_low=-2.5,
         clip_high=0.0),
])
def test_the_prologue_equals_normalize_then_clip(params):
    x = _prologue_input(int(params["norm_max"]))
    pro = hm.Prologue.of(**params)
    want = clip_intensity(normalize(x, params["norm_low"], params["norm_high"],
                                    params["norm_min"], params["norm_max"]),
                          params["clip_low"], params["clip_high"])
    got = prologue_scheme(x, pro)
    assert _same_bits(got, want)
    assert bool(torch.isnan(got).any())
    if params["clip_low"] < 0 < params["clip_high"]:
        assert bool((torch.signbit(got) & (got == 0)).any())  # a -0.0 came through


def sorted_middle(x: np.ndarray, k: int) -> np.ndarray:
    """The select and wide kernels' rule on NaN-free data: the middle of
    each clamp-to-edge window's keys in the key order (-0.0 below +0.0),
    which ``tests/test_torch_redesign.py`` holds to the kernels' schedules
    and ``tests/test_torch_envelope.py`` to the plain and JAX networks."""
    r = k // 2
    pad = np.pad(x, [(0, 0), (r, r), (r, r)], mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(pad, (k, k), axis=(-2, -1))
    u = np.ascontiguousarray(win.reshape(win.shape[:-2] + (k * k,))).view(np.uint32)
    keys = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    mid = np.sort(keys, axis=-1)[..., k * k // 2]
    return np.where(mid & 0x80000000, mid & 0x7FFFFFFF, ~mid).astype(np.uint32).view(np.float32)


def split_scheme(x: torch.Tensor, **kw) -> torch.Tensor:
    """The split route on the CPU: the median kernels' rule over the
    prologue's values, then the sharpen kernel's schedule at the wrapper's
    launch shape."""
    pro = hm.Prologue.of(kw["norm_low"], kw["norm_high"], kw["norm_min"], kw["norm_max"],
                         kw["clip_low"], kw["clip_high"])
    med = torch.from_numpy(sorted_middle(prologue_scheme(x, pro).numpy(), kw["median_window"]))
    ks = kw["sharpen_kernel"]
    return sharpen_scheme(med, kw["sharpen_gain"], kw["sharpen_sigma"], ks,
                          hm.sharpen_launch_shape(*med.shape, ks, N_SM))


@pytest.mark.parametrize("k", [17, 31, 65])
def test_the_split_composition_equals_the_plain_and_jitted_jax(k):
    rng = np.random.default_rng(k)
    x = (rng.random((1, 19, 26)) * 9000).astype(np.float32)
    kw = dict(PRE, median_window=k)
    got = split_scheme(torch.from_numpy(x), **kw)
    assert _same_bits(got, hm._fused_preprocess_plain(torch.from_numpy(x), **kw))
    assert _ulp(got.numpy(), _jitted_jax(x, k)) <= JIT_ULP


def _jitted_jax(x: np.ndarray, k: int) -> np.ndarray:
    """The JAX package's composition, jitted: ``_fused_preprocess_xla``
    itself at k = 17. Past that its pruned network takes XLA minutes to
    compile (and its sort median a minute at k = 65), so normalize and
    clip under one jit, the window's sorted middle key (the network's exact
    answer), then the sharpen under another: the same XLA contractions."""
    if k == 17:
        f = functools.partial(_fused_preprocess_xla, **dict(PRE, median_window=k))
        return np.asarray(jax.jit(f)(jnp.asarray(x)))
    pre = jax.jit(lambda v: jax_clip(jax_normalize(v, PRE["norm_low"], PRE["norm_high"],
                                                   PRE["norm_min"], PRE["norm_max"]),
                                     PRE["clip_low"], PRE["clip_high"]))
    sharp = jax.jit(lambda v: jax_sharpen(v, PRE["sharpen_gain"], PRE["sharpen_sigma"],
                                          PRE["sharpen_kernel"]))
    return np.asarray(sharp(jnp.asarray(sorted_middle(np.asarray(pre(jnp.asarray(x))), k))))


# -- the wrappers, on stand-ins for the library and the device ------------------------


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
                   "nm03_fused_preprocess", "nm03_sharpen"):
            setattr(self, fn, _Fn(calls, fn))


@pytest.fixture
def stand_in_card(monkeypatch, caplog):
    calls = []
    lib = _Lib(calls)

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(hm, "_batched",
                        lambda x, what: x.reshape(-1, x.shape[-2], x.shape[-1]).contiguous())
    monkeypatch.setattr(hm, "_sm_count", lambda index: N_SM)
    monkeypatch.setattr(hm, "_wide_ctas_per_sm", lambda index, k: 5)
    monkeypatch.setattr(hm.build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _Stream())
    monkeypatch.setattr(reporter, "_logged_once", set())
    logger = logging.getLogger("nm03_torch")
    monkeypatch.setattr(logger, "propagate", True)
    caplog.set_level(logging.INFO, logger="nm03_torch")
    for fn in (hm.vector_median_filter_kernel, hm.vector_median_select_kernel,
               hm.vector_median_wide_kernel, hm.fused_preprocess_kernel,
               hm.sharpen_filter_kernel):
        monkeypatch.setattr(fn, "launches", 0)
    return calls


@pytest.mark.parametrize("k,ks,median", [
    (17, 9, "nm03_median_select_pre"), (7, 33, "nm03_median_filter_pre"),
    (31, 41, "nm03_median_select_pre"), (65, 9, "nm03_median_wide_pre"),
    (127, 33, "nm03_median_wide_pre"), (15, 65, "nm03_median_filter_pre"),
])
def test_split_launches_the_median_with_its_prologue_then_the_sharpen(stand_in_card, caplog,
                                                                      k, ks, median):
    x = torch.rand(2, 30, 40) * 9000
    kw = dict(PRE, median_window=k, sharpen_kernel=ks)
    hm.fused_preprocess_kernel(x, **kw)
    (m_name, m_args), (s_name, s_args) = stand_in_card
    assert (m_name, s_name) == (median, "nm03_sharpen")
    # the prologue's five constants just before the stream, in float
    pro = hm.Prologue.of(kw["norm_low"], kw["norm_high"], kw["norm_min"], kw["norm_max"],
                         kw["clip_low"], kw["clip_high"])
    assert m_args[-6:-1] == tuple(pro) and pro.scale == 2.0 / 10000.0
    # the sharpen reads the median's output and writes the wrapper's
    out_ptr = m_args[1]
    assert s_args[0] == out_ptr and s_args[1] != out_ptr
    sl = hm.sharpen_launch_shape(2, 30, 40, ks, N_SM)
    assert s_args[3] is None and s_args[4:9] == (2, 30, 40, ks, 2.0)
    assert s_args[9:13] == (sl.tile_h, sl.tile_w, hm.PLANS.index(sl.plan), sl.grid)
    assert sl.plan == ("windowed" if ks <= hm.WIN_MAX_TAPS else "staged")
    launched = {"nm03_median_filter_pre": hm.vector_median_filter_kernel,
                "nm03_median_select_pre": hm.vector_median_select_kernel,
                "nm03_median_wide_pre": hm.vector_median_wide_kernel}[median]
    assert launched.launches == 1 and hm.sharpen_filter_kernel.launches == 1
    assert hm.fused_preprocess_kernel.launches == 0
    route = hm.median_launch_shape(2, 30, 40, k).route
    assert [r.getMessage() for r in caplog.records if "fused: route" in r.getMessage()] == [
        f"fused: route split (k={k}, {ks} sharpen taps: the {route} median with normalize "
        "and clip on load, then the sharpen kernel)"]


def test_the_taps_go_to_the_device_once(stand_in_card):
    hm._device_taps.cache_clear()
    x = torch.rand(1, 8, 8)
    for _ in range(3):
        hm.sharpen_filter_kernel(x, 2.0, 0.5, 33)
    taps = hm._device_taps(0.5, 33, x.device)
    assert hm._device_taps.cache_info().misses == 1
    assert [c[1][2] for c in stand_in_card] == [taps.data_ptr()] * 3
    assert torch.equal(taps, torch.from_numpy(gaussian_kernel_1d(0.5, 33)))


def test_a_sharpen_too_long_for_shared_memory_gets_a_scratch(stand_in_card, caplog):
    # torch.empty: the stand-in library reads nothing
    x = torch.empty(1, 2, 600)
    hm.sharpen_filter_kernel(x, 2.0, 0.5, 58201)
    ((name, args),) = stand_in_card
    sl = hm.sharpen_launch_shape(1, 2, 600, 58201, N_SM)
    assert name == "nm03_sharpen" and args[3] is not None and sl.scratch
    assert args[11:13] == (0, sl.grid) and sl.tile_h == 1 and sl.smem == 0
    assert any("sharpen: route rows" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("size", [0, 4, -3])
def test_the_sharpen_wrapper_refuses_an_even_or_empty_kernel(size):
    with pytest.raises(ValueError, match="odd and positive"):
        hm.sharpen_filter_kernel(torch.rand(1, 4, 4), size=size)


def test_chip_smokes_earlier_design_runs_the_staged_plan(stand_in_card):
    # chip_smoke.py times the earlier sharpen design beside the windowed one:
    # the staged plan at 32 x 64 tiles, one tile a CTA, counted apart from
    # the wrapper's launches
    import chip_smoke

    med = torch.rand(2, 70, 130)
    launch = chip_smoke.sharpen_earlier_design(med, PRE)
    launch()
    launch()
    ((name, args), _) = stand_in_card
    assert name == "nm03_sharpen" and args[0] == med.data_ptr() and args[3] is None
    assert args[4:13] == (2, 70, 130, 9, 2.0, 32, 64, hm.PLANS.index("staged"), 2 * 3 * 3)
    assert launch.launches == 2 and hm.sharpen_filter_kernel.launches == 0
