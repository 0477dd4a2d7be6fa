"""The schedules of the select, wide and global grow kernels, modelled on the CPU.

The two kernels that ``csrc/median.cu`` and ``csrc/grow.cu`` run past the
generated plans and past one cluster were rebuilt for the H100: the select
kernel counts over sorted column segments, the global grow kernel steps
tiles in shared memory between grid barriers. The kernels run only on the
card (``tests/test_torch_card.py -m cuda``, ``chip_smoke.py``'s
``envelope`` phase); here a small torch model of each scheme, written from
the source notes, runs on seeded numpy inputs:

* the tiled grow: tiles held with ``halo`` rows and a word each side, s
  local Jacobi steps with everything beyond the held tile 0, the own words
  written to the other of two global buffers, tiles whose 3 x 3
  neighbourhood kept its popcount left alone (not even copied), the
  per-slice counts taken at block ends. Its mask, ``converged`` and steps
  against the plain ``region_grow`` and the JAX package's, bitwise, for
  connectivity 4 and 8, on tiles that do not divide the canvas;
* the select: segments sorted once, padded to 2P - 1 keys, a count below a
  candidate by P, P/2, ..., 1 probes a segment, the bisection snapping to
  keys of the window. Against ``torch.sort``'s middle key, with signed
  zeros and NaNs, and against the plain median;
* the wide kernel (past MAX_SELECT_WINDOW): the select's rule over a
  whole window's keys (``wide_scheme``), and the kernel's schedule
  (``strip_scheme``): a strip's column segments sorted at the top of a
  band by a bitonic network, kept down the rows by one deletion and one
  insertion each (equal to a fresh sort at every row), counts by a binary
  search with no bound check (equal to the direct count). Against
  ``torch.sort``'s middle key at k = 65 and 127, with signed zeros and
  NaNs, and the plain median at k = 65;
* the launch-shape arithmetic: the select's shared bytes for every odd
  window up to MAX_SELECT_WINDOW, the wide segments' bytes for every odd
  window up to the switch to a device scratch and the bands of the
  envelope's shapes, the grow tiles and halo for canvases from 2161 to
  65,536 a side and for strips one pixel thin.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu.ops import region_growing as jax_region_growing
from nm03_capstone_project_tpu_torch.ops import hopper_median as hm
from nm03_capstone_project_tpu_torch.ops import hopper_region_growing as hg
from nm03_capstone_project_tpu_torch.ops.median import vector_median_filter
from nm03_capstone_project_tpu_torch.ops.morphology import dilate
from nm03_capstone_project_tpu_torch.ops.region_growing import grow_band, region_grow

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

# -- the tiled grow ------------------------------------------------------------------


def tiled_grow(image, seeds, low, high, valid, connectivity, block_iters, max_iters, rows,
               words, halo):
    """``grow_global_kernel``'s schedule on bool tensors, pixel for pixel.

    Returns ``(mask, converged, steps, stepped, visits)``: the last two
    count the tile super-steps stepped and those of running slices."""
    band = grow_band(image, low, high, valid)
    b, h, w = image.shape
    ww = -(-w // 32)
    ty, tx = -(-h // rows), -(-ww // words)
    shape = "cross" if connectivity == 4 else "box"
    gen = torch.Generator().manual_seed(0)
    # the second buffer starts as garbage: torch.empty in the wrapper
    buf = [seeds.bool() & band, torch.rand((b, h, w), generator=gen) < 0.5]

    def place(yi, xi):
        r0, r1 = yi * rows, min(h, yi * rows + rows)
        c0, c1 = xi * words, min(ww, xi * words + words)
        hr0, hr1 = max(0, r0 - halo), min(h, r1 + halo)
        hc0, hc1 = max(0, c0 - 1), min(ww, c1 + 1)
        return r0, r1, 32 * c0, min(w, 32 * c1), hr0, hr1, 32 * hc0, min(w, 32 * hc1)

    pop = torch.zeros((b, ty, tx), dtype=torch.int64)
    for sl, yi, xi in itertools.product(range(b), range(ty), range(tx)):
        r0, r1, p0, p1 = place(yi, xi)[:4]
        pop[sl, yi, xi] = int(buf[0][sl, r0:r1, p0:p1].sum())
    prev = pop.sum(dim=(1, 2))  # the count "after block -1"
    act = [True] * b
    conv, steps, par = [False] * b, [0] * b, [0] * b
    chg_prev = None
    p, gs, stepped, visits = 0, 0, 0, 0
    for j in itertools.count():
        done = 0
        while done < block_iters:
            s = min(halo, block_iters - done)
            chg = torch.zeros((b, ty, tx), dtype=torch.bool)
            for sl, yi, xi in itertools.product(range(b), range(ty), range(tx)):
                if not act[sl]:
                    continue
                visits += 1
                near = None if chg_prev is None else chg_prev[sl, max(0, yi - 1):yi + 2,
                                                              max(0, xi - 1):xi + 2]
                if near is not None and not bool(near.any()):
                    continue  # quiet: its words in buf[1 - p] are already these
                stepped += 1
                r0, r1, p0, p1, hr0, hr1, q0, q1 = place(yi, xi)
                held, hband = buf[p][sl, hr0:hr1, q0:q1], band[sl, hr0:hr1, q0:q1]
                for _ in range(s):  # beyond the held tile counts as 0
                    held = dilate(held, 3, shape) & hband
                own = held[r0 - hr0:r1 - hr0, p0 - q0:p1 - q0]
                buf[1 - p][sl, r0:r1, p0:p1] = own
                c = int(own.sum())
                chg[sl, yi, xi] = c != int(pop[sl, yi, xi])
                pop[sl, yi, xi] = c
            chg_prev = chg
            p ^= 1
            gs += 1
            done += s
        count = pop.sum(dim=(1, 2))
        for sl in range(b):
            if not act[sl]:
                continue
            if int(count[sl]) != int(prev[sl]) and (j + 1) * block_iters < max_iters:
                continue
            act[sl] = False
            conv[sl] = int(count[sl]) == int(prev[sl])
            steps[sl] = (j + 1) * block_iters
            par[sl] = p
        prev = count
        if not any(act):
            break
    mask = torch.stack([buf[par[sl]][sl] for sl in range(b)]).to(torch.uint8)
    return mask, torch.tensor(conv), torch.tensor(steps, dtype=torch.int32), stepped, visits


def _grow_case():
    """A serpentine band (a long fixpoint) and a half-in-band field, 40 x 70."""
    h, w = 40, 70
    serp = np.full((h, w), 0.8, np.float32)
    for r in range(1, h, 2):
        serp[r, :] = 0.5
        serp[r, -1 if (r // 2) % 2 == 0 else 0] = 0.8
    rng = np.random.default_rng(15)
    img = np.stack([serp, (rng.random((h, w)) * 0.3 + 0.68).astype(np.float32)])
    seeds = np.zeros((2, h, w), bool)
    seeds[0, 0, 0] = seeds[1, h // 2, w // 2] = seeds[1, 3, 60] = True
    valid = np.ones((2, h, w), bool)
    valid[1, :, w - 5:] = False
    return img, seeds, valid


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("block_iters,max_iters", [(16, 1024), (2, 4)])
@pytest.mark.parametrize("tiling", ["launch", "rows7_words1", "rows17_words2"])
def test_the_tiled_grow_equals_the_plain_and_jax_schedules(connectivity, block_iters,
                                                          max_iters, tiling):
    img, seeds, valid = _grow_case()
    b, h, w = img.shape
    if tiling == "launch":
        t = hg.global_tiles(b, h, w, block_iters, N_SM)
        rows, words, halo = t.rows, t.words, t.halo
    else:  # 40 rows and 3 words: tiles that do not divide the canvas
        rows, words = (7, 1) if tiling == "rows7_words1" else (17, 2)
        halo = min(block_iters, hg.GLOBAL_MAX_HALO, rows)
    kw = dict(connectivity=connectivity, block_iters=block_iters, max_iters=max_iters)
    ti, ts, tv = (torch.from_numpy(a) for a in (img, seeds, valid))
    mask, conv, steps, stepped, visits = tiled_grow(ti, ts, 0.74, 0.91, tv, rows=rows,
                                                    words=words, halo=halo, **kw)
    want = region_grow(ti, ts, 0.74, 0.91, valid=tv, return_steps=True, **kw)
    assert torch.equal(mask, want[0]) and torch.equal(conv, want[1])
    assert torch.equal(steps, want[2])
    jm, jc = jax.vmap(lambda i, s, v: jax_region_growing.region_grow(i, s, valid=v, **kw))(
        jnp.asarray(img), jnp.asarray(seeds), jnp.asarray(valid))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(jc))
    if block_iters == 16 and tiling != "launch":
        assert stepped < visits  # quiet tiles were left alone


def test_a_quiet_tile_keeps_its_words_where_a_stale_buffer_would_show():
    # two seeds far apart in one open field: the tiles between the fronts
    # stay quiet for super-steps while the buffer they would write holds
    # garbage from the start, so any tile stepped from (or left in) the
    # wrong buffer shows in the mask
    img = torch.full((1, 64, 96), 0.8)
    seeds = torch.zeros((1, 64, 96), dtype=torch.bool)
    seeds[0, 2, 2] = seeds[0, 60, 90] = True
    kw = dict(connectivity=4, block_iters=4, max_iters=1024)
    got = tiled_grow(img, seeds, 0.74, 0.91, None, rows=8, words=1, halo=4, **kw)
    want = region_grow(img, seeds, 0.74, 0.91, return_steps=True, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert int(got[0].sum()) == 64 * 96 and got[3] < got[4]


# -- the select ---------------------------------------------------------------------------


def _keys(x: np.ndarray) -> np.ndarray:
    u = x.view(np.uint32).astype(np.int64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _values(k: np.ndarray) -> np.ndarray:
    k = k.astype(np.int64)
    return np.where(k & 0x80000000, k & 0x7FFFFFFF, ~k & 0xFFFFFFFF).astype(
        np.uint32).view(np.float32)


def _windows(x: np.ndarray, k: int) -> np.ndarray:
    r = k // 2
    pad = np.pad(x, [(0, 0), (r, r), (r, r)], mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(pad, (k, k), axis=(-2, -1))
    return win.reshape(win.shape[:-2] + (k * k,))  # row-major within the window


def select_scheme(x: np.ndarray, k: int) -> np.ndarray:
    """``select_kernel``'s rule: each window's k column segments sorted and
    padded (plane -1 below every key, planes k .. 2P - 1 above), a count
    below a candidate by P, P/2, ..., 1 probes a segment, the lower end of
    the bisection snapping up to the least key at or above the candidate
    or the upper end down past the greatest below it; a NaN window's first
    NaN, row-major."""
    x = np.ascontiguousarray(x, np.float32)
    b, h, w = x.shape
    r, rank = k // 2, (k * k) // 2
    logp = k.bit_length() - 1
    keys = torch.from_numpy(_keys(np.pad(x, [(0, 0), (r, r), (r, r)], mode="edge")))
    seg = keys.unfold(1, k, 1).sort(dim=-1).values  # (b, h, w + 2r, k): segment (y, X)
    lo_pad = torch.zeros(seg.shape[:-1] + (1,), dtype=torch.int64)
    hi_pad = torch.full(seg.shape[:-1] + ((2 << logp) - k,), 0xFFFFFFFF, dtype=torch.int64)
    planes = torch.cat([lo_pad, seg, hi_pad], dim=-1)  # plane a at a + 1
    win = planes.unfold(2, k, 1).transpose(-1, -2)  # (b, h, w, k segments, 2P + 1 planes)
    lo, hi = win[..., 1].min(-1).values, win[..., k].max(-1).values
    l, u = lo.clone(), hi + 1
    run = u - l > 1
    while bool(run.any()):
        cand = l + (u - l) // 2
        pos = torch.zeros(win.shape[:-1], dtype=torch.int64)
        for lv in range(logp, -1, -1):
            probe = win.gather(-1, (pos + (1 << lv))[..., None])[..., 0]  # plane pos + 2^lv - 1
            pos += (probe < cand[..., None]) * (1 << lv)
        below = pos.sum(-1)
        succ = win.gather(-1, (pos + 1)[..., None])[..., 0].min(-1).values
        pred = win.gather(-1, pos[..., None])[..., 0].max(-1).values
        up = below <= rank
        l = torch.where(run & up, succ, l)
        u = torch.where(run & ~up, pred + 1, u)
        run = run & (u - l > 1)
    out = _values(l.numpy())
    xw = _windows(x, k)
    nan = np.isnan(xw)
    first = np.take_along_axis(xw, nan.argmax(-1)[..., None], -1)[..., 0]
    return np.where(nan.any(-1), first, out)


def sort_median(x: np.ndarray, k: int) -> np.ndarray:
    """``torch.sort``'s middle key of each window; a NaN window's first
    NaN, row-major."""
    xw = _windows(np.ascontiguousarray(x, np.float32), k)
    keys = torch.from_numpy(_keys(np.ascontiguousarray(xw)))
    med = _values(keys.sort(dim=-1).values[..., (k * k) // 2].numpy())
    nan = np.isnan(xw)
    first = np.take_along_axis(xw, nan.argmax(-1)[..., None], -1)[..., 0]
    return np.where(nan.any(-1), first, med)


def _select_cases(k):
    rng = np.random.default_rng(k)
    z = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32), (2, 21, 34),
                   p=[0.35, 0.35, 0.15, 0.15])
    z[0, 5, 5], z[1, 9, 20] = np.float32("nan"), -np.float32("nan")
    return {
        "noise": (rng.random((2, 19, 37)) * 4000 + 0.68).astype(np.float32),
        "duplicates": rng.integers(-2, 3, (2, 19, 23)).astype(np.float32),  # both signs
        "signed_zeros": rng.choice(np.array([-0.0, 0.0, 1.5, -2.0], np.float32), (2, 19, 23)),
        "signed_zeros_and_nan": z,
        "flat": np.full((1, 7, 9), 0.68, np.float32),  # a window of one value: no bisection
        "subnormals": (rng.standard_normal((1, 9, 40)) * 1e-38).astype(np.float32),
    }


SELECT_CASES = list(_select_cases(1))


@pytest.mark.parametrize("case", SELECT_CASES)
@pytest.mark.parametrize("k", [1, 3, 17, 21, 31, 63])
def test_the_select_rule_gives_the_sorted_middle_key(k, case):
    x = _select_cases(k)[case]
    got = select_scheme(x, k)
    np.testing.assert_array_equal(got.view(np.uint32), sort_median(x, k).view(np.uint32))


def test_select_takes_the_windows_first_nan():
    x = np.random.default_rng(1).random((1, 20, 20)).astype(np.float32)
    a, b = np.float32("nan"), -np.float32("nan")
    x[0, 5, 5], x[0, 5, 7] = a, b
    got = select_scheme(x, 17)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(_windows(x, 17)).any(-1))
    # both NaNs in the window: the first in row-major order; one: that one
    assert got.view(np.uint32)[0, 0, 0] == a.view(np.uint32)
    assert got.view(np.uint32)[0, 0, 15] == b.view(np.uint32)


@pytest.mark.parametrize("k", [17, 19, 31])
def test_the_select_rule_equals_the_plain_median(k):
    # finite data without signed zeros: every exact rank selection agrees
    x = np.random.default_rng(31).random((2, 24, 24)).astype(np.float32)
    plain = vector_median_filter(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(select_scheme(x, k), plain)


def wide_scheme(x: np.ndarray, k: int) -> np.ndarray:
    """``wide_kernel``'s rule: the select's bisection, each count below a
    candidate, least key at or above it and greatest below it taken over
    all k*k keys of the window; a NaN window's first NaN, row-major."""
    xw = _windows(np.ascontiguousarray(x, np.float32), k)
    keys = torch.from_numpy(_keys(np.ascontiguousarray(xw)))
    rank = (k * k) // 2
    nan = np.isnan(xw)
    l, u = keys.min(-1).values, keys.max(-1).values + 1
    run = (u - l > 1) & ~torch.from_numpy(nan.any(-1))
    while bool(run.any()):
        cand = (l + (u - l) // 2)[..., None]
        lt = keys < cand
        below = lt.sum(-1)
        succ = torch.where(lt, 0xFFFFFFFF, keys).min(-1).values
        pred = torch.where(lt, keys, 0).max(-1).values
        up = below <= rank
        l = torch.where(run & up, succ, l)
        u = torch.where(run & ~up, pred + 1, u)
        run = run & (u - l > 1)
    first = np.take_along_axis(xw, nan.argmax(-1)[..., None], -1)[..., 0]
    return np.where(nan.any(-1), first, _values(l.numpy()))


@pytest.mark.parametrize("case", SELECT_CASES)
@pytest.mark.parametrize("k", [3, 17, 65, 127])
def test_the_wide_rule_gives_the_sorted_middle_key(k, case):
    x = _select_cases(k)[case]
    if k > 65:  # the windows of every pixel cover most of these small slices
        x = x[:1, :9, :11]
    got = wide_scheme(x, k)
    np.testing.assert_array_equal(got.view(np.uint32), sort_median(x, k).view(np.uint32))


def test_the_wide_rule_equals_the_plain_median():
    # finite data without signed zeros: every exact rank selection agrees
    x = np.random.default_rng(65).random((1, 14, 16)).astype(np.float32)
    plain = vector_median_filter(torch.from_numpy(x), 65).numpy()
    np.testing.assert_array_equal(wide_scheme(x, 65), plain)


# -- the wide kernel's strip walk -----------------------------------------------------


def bitonic_stages(k: int) -> list:
    """``wide_kernel``'s sort of a k-key segment, stage by stage: for each
    block size 2, 4, ..., N (N the least power of 2 >= k) a mirrored stage
    (place i against i ^ (size - 1)), then half-cleaners (i against i | d,
    d = size / 4, ..., 1), every compare-exchange ascending. A pair whose
    upper place is past k would meet a +inf there: skipped."""
    n = 1 << max(0, (k - 1).bit_length())
    stages, size = [], 2
    while size <= n:
        d = size // 2
        while d:
            pairs = []
            for p in range(n // 2):
                i = ((p & ~(d - 1)) << 1) | (p & (d - 1))
                j = i ^ (size - 1) if d == size // 2 else i | d
                if j < k:
                    pairs.append((i, j))
            stages.append(np.array(pairs, dtype=np.int64).reshape(-1, 2))
            d //= 2
        size *= 2
    return stages


def bitonic_sort(seg: np.ndarray, stages: list) -> np.ndarray:
    """Each column of ``seg`` (k, n) through :func:`bitonic_stages`."""
    seg = seg.copy()
    for pairs in stages:
        i, j = pairs[:, 0], pairs[:, 1]
        a, b = seg[i], seg[j]
        seg[i], seg[j] = np.minimum(a, b), np.maximum(a, b)
    return seg


def count_below(seg: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The kernel's count of each sorted column of ``seg`` (k, n) below
    ``v`` (n,): a first probe at P - 1 (P the largest power of 2 <= k)
    leaves P places, then probes P/2, ..., 1 with no bound check (numpy
    raises on a probe past the column)."""
    k = seg.shape[0]
    p = 1 << (k.bit_length() - 1)
    cols = np.arange(seg.shape[1])
    pos = np.where(seg[p - 1] < v, k - p + 1, 0)
    step = p // 2
    while step:
        pos = pos + np.where(seg[pos + step - 1, cols] < v, step, 0)
        step //= 2
    return pos


def strip_walk(x: np.ndarray, k: int, rows: int):
    """``wide_kernel``'s segments as it walks: for each slice, strip of 32
    output columns and band of ``rows`` rows, the strip's 32 + k - 1 column
    segments of the band's first row sorted by :func:`bitonic_sort`, then
    each row down: every column drops its top key and takes the new bottom
    one, both places found by :func:`count_below` and the keys between
    shifted by one. Yields ``(slice, x0, y, segments (k, 32 + k - 1))``."""
    keys = _keys(np.ascontiguousarray(x, np.float32))
    b, h, w = x.shape
    r, iw = k // 2, 32 + k - 1
    stages = bitonic_stages(k)
    for sl, x0 in itertools.product(range(b), range(0, w, 32)):
        cols = np.clip(np.arange(x0 - r, x0 - r + iw), 0, w - 1)
        for y0 in range(0, h, rows):
            ys = np.clip(np.arange(y0 - r, y0 - r + k), 0, h - 1)
            seg = bitonic_sort(keys[sl][np.ix_(ys, cols)], stages)
            for y in range(y0, min(h, y0 + rows)):
                if y > y0:
                    ko = keys[sl, min(max(y - 1 - r, 0), h - 1), cols]
                    kn = keys[sl, min(max(y + r, 0), h - 1), cols]
                    p = count_below(seg, ko)
                    q = count_below(seg, kn) - (ko < kn)
                    for c in np.nonzero(ko != kn)[0]:
                        a, col = seg[:, c].copy(), seg[:, c]
                        if p[c] < q[c]:
                            col[p[c]:q[c]] = a[p[c] + 1:q[c] + 1]
                        else:
                            col[q[c] + 1:p[c] + 1] = a[q[c]:p[c]]
                        col[q[c]] = kn[c]
                yield sl, x0, y, seg


def strip_scheme(x: np.ndarray, k: int, rows: int) -> np.ndarray:
    """``wide_kernel``'s medians: along :func:`strip_walk`, each output's
    bisection over its k segments (the select's rule, a count by
    :func:`count_below` in each); a window whose least or greatest key is
    a NaN's takes its first NaN, row-major."""
    x = np.ascontiguousarray(x, np.float32)
    rank = (k * k) // 2
    out = np.empty(x.shape, np.uint32)
    flagged = np.zeros(x.shape, bool)
    for sl, x0, y, seg in strip_walk(x, k, rows):
        n = min(32, x.shape[2] - x0)
        win = seg[:, (np.arange(n)[:, None] + np.arange(k)[None, :]).ravel()]
        cols = np.arange(n * k)
        lo, hi = win[0].reshape(n, k).min(1), win[-1].reshape(n, k).max(1)
        nan = (lo < 0x007FFFFF) | (hi > 0xFF800000)
        l, u = lo.copy(), hi + 1
        run = (u - l > 1) & ~nan
        while run.any():
            cand = l + (u - l) // 2
            pos = count_below(win, np.repeat(cand, k))
            below = pos.reshape(n, k).sum(1)
            succ = np.where(pos < k, win[np.minimum(pos, k - 1), cols], 0xFFFFFFFF)
            pred = np.where(pos > 0, win[np.maximum(pos - 1, 0), cols], 0)
            up = below <= rank
            l = np.where(run & up, succ.reshape(n, k).min(1), l)
            u = np.where(run & ~up, pred.reshape(n, k).max(1) + 1, u)
            run &= u - l > 1
        out[sl, y, x0:x0 + n] = l
        flagged[sl, y, x0:x0 + n] = nan
    xw = _windows(x, k)
    nan = np.isnan(xw)
    assert np.array_equal(flagged, nan.any(-1))  # the extreme keys show every NaN window
    first = np.take_along_axis(xw, nan.argmax(-1)[..., None], -1)[..., 0]
    return np.where(flagged, first, _values(out))


STRIP_CASES = ["noise", "duplicates", "signed_zeros_and_nan"]


@pytest.mark.parametrize("case", STRIP_CASES)
@pytest.mark.parametrize("k,rows", [(3, 4), (65, 1), (65, 6), (65, 40), (127, 3)])
def test_strip_segments_kept_a_row_at_a_time_equal_a_fresh_sort(k, rows, case):
    x = _select_cases(k)[case]
    if k > 65:
        x = x[:1, :9, :40]
    keys = _keys(np.ascontiguousarray(x, np.float32))
    b, h, w = x.shape
    r, seen = k // 2, 0
    for sl, x0, y, seg in strip_walk(x, k, rows):
        cols = np.clip(np.arange(x0 - r, x0 + 32 + r), 0, w - 1)
        ys = np.clip(np.arange(y - r, y + r + 1), 0, h - 1)
        np.testing.assert_array_equal(seg, np.sort(keys[sl][np.ix_(ys, cols)], axis=0))
        seen += 1
    assert seen == b * h * -(-w // 32)


@pytest.mark.parametrize("k", [1, 3, 5, 63, 65, 127, 129, 225, 227, 257])
def test_the_bitonic_stages_sort_any_segment(k):
    rng = np.random.default_rng(k)
    seg = np.concatenate([rng.integers(0, 2**32, (k, 40)), rng.integers(0, 3, (k, 40))], 1)
    np.testing.assert_array_equal(bitonic_sort(seg, bitonic_stages(k)), np.sort(seg, axis=0))
    assert all(len(set(p.ravel())) == 2 * len(p) for p in bitonic_stages(k))  # disjoint pairs


@pytest.mark.parametrize("k", [1, 3, 65, 127, 225, 227])
def test_the_binary_search_count_equals_the_direct_count(k):
    rng = np.random.default_rng(k)
    seg = np.sort(rng.integers(0, 40, (k, 300)), axis=0)
    for cand in range(-1, 42):
        v = np.full(300, cand)
        np.testing.assert_array_equal(count_below(seg, v), (seg < v).sum(0))


@pytest.mark.parametrize("k", [3, 9, 65])
def test_chip_smokes_wide_counts_follow_the_schedule(k):
    # chip_smoke.py's operation count of the wide kernel (its floor) counts
    # the network's compare-exchanges and, for each column of each row but
    # a band's first where the keys that leave and enter differ, two binary
    # searches and the keys moved between their places
    import chip_smoke

    assert chip_smoke.bitonic_pairs(k) == sum(len(p) for p in bitonic_stages(k))
    x = _select_cases(k)["duplicates"]
    keys = _keys(np.ascontiguousarray(x, np.float32))
    b, h, w = x.shape
    r, lv, rows, want = k // 2, k.bit_length(), 4, 0
    for sl, x0 in itertools.product(range(b), range(0, w, 32)):
        for c in np.clip(np.arange(x0 - r, x0 + 32 + r), 0, w - 1):
            for y in (y for y in range(h) if y % rows):
                seg = keys[sl, np.clip(np.arange(y - 1 - r, y + r), 0, h - 1), c]
                ko, kn = seg[0], keys[sl, min(y + r, h - 1), c]
                if ko != kn:
                    p, q = (seg < ko).sum(), (seg < kn).sum() - (ko < kn)
                    want += 4 * lv + abs(p - q) + 1
    assert chip_smoke.wide_upkeep_ops(torch.from_numpy(x), k, rows) == want


@pytest.mark.parametrize("k", range(hm.MAX_SELECT_WINDOW + 2, 302, 2))
def test_a_band_start_costs_more_than_the_row_it_replaces(k):
    # a band's first row sorts each column; a later row moves one key by two
    # binary searches and at most k shifts: so the wide count is least at
    # one band a slice, the floor chip_smoke.py takes
    import chip_smoke

    assert 2 * chip_smoke.bitonic_pairs(k) > 4 * k.bit_length() + k + 1


@pytest.mark.parametrize("rows", [1, 2, 4, 11])
def test_chip_smokes_wide_count_is_least_at_one_band_a_slice(rows):
    import chip_smoke

    x = torch.from_numpy(_select_cases(65)["noise"][:1, :12].copy())  # two strips
    one_band = chip_smoke.wide_design_ops(x, 65, 12)
    banded = chip_smoke.wide_design_ops(x, 65, rows)
    assert one_band["tiles"] == 2 and banded["tiles"] == 2 * -(-12 // rows)
    assert one_band["ops"] < banded["ops"]
    sort = 2 * chip_smoke.bitonic_pairs(65) * (32 + 64) / x.numel()
    assert banded["sort_ops_per_output"] == banded["tiles"] * sort


@pytest.mark.parametrize("case", SELECT_CASES)
@pytest.mark.parametrize("k", [65, 127])
def test_the_strip_scheme_gives_the_sorted_middle_key(k, case):
    x = _select_cases(k)[case]
    if k > 65:  # the windows of every pixel cover most of these small slices
        x = x[:1, :9, :11]
    got = strip_scheme(x, k, rows=4)
    np.testing.assert_array_equal(got.view(np.uint32), sort_median(x, k).view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), wide_scheme(x, k).view(np.uint32))


def test_the_strip_scheme_equals_the_plain_median():
    # finite data without signed zeros: every exact rank selection agrees
    x = np.random.default_rng(65).random((1, 14, 40)).astype(np.float32)
    plain = vector_median_filter(torch.from_numpy(x), 65).numpy()
    np.testing.assert_array_equal(strip_scheme(x, 65, rows=5), plain)


@pytest.mark.parametrize("k", [3, 17, 31, 63])
def test_a_probe_count_is_a_binary_search(k):
    # the count below a candidate in one padded segment, by P, P/2, ..., 1
    rng = np.random.default_rng(k)
    logp = k.bit_length() - 1
    for _ in range(50):
        seg = np.sort(rng.integers(0, 40, k))
        padded = np.concatenate([seg, np.full((2 << logp) - 1 - k, 10**9)])
        for cand in range(-1, 42):
            pos, probed = 0, []
            for lv in range(logp, -1, -1):
                probed.append(pos + (1 << lv) - 1)
                if padded[probed[-1]] < cand:
                    pos += 1 << lv
            assert pos == int(np.searchsorted(seg, cand))
            assert max(probed) < len(padded)  # no probe needs a bound check


# -- the launch shapes --------------------------------------------------------------------


@pytest.mark.parametrize("k", range(1, hm.MAX_SELECT_WINDOW + 1, 2))
def test_the_select_tile_fits_a_block_for_every_window(k):
    assert hm.select_smem_bytes(k) <= hm.SMEM_PER_BLOCK == 232448


def test_the_select_tile_at_the_limit():
    # the limit is the layout's: the last odd window whose tile fits a block
    assert hm.MAX_SELECT_WINDOW == 63
    assert hm.select_smem_bytes(hm.MAX_SELECT_WINDOW) == 226000
    assert hm.select_smem_bytes(hm.MAX_SELECT_WINDOW + 2) > hm.SMEM_PER_BLOCK
    assert hm.select_smem_bytes(17) == 55296


@pytest.mark.parametrize("k", range(hm.MAX_SELECT_WINDOW + 2, hm.MAX_WIDE_SHARED_WINDOW + 1, 2))
def test_the_wide_segments_fit_a_block_below_the_switch(k):
    assert hm.wide_segment_bytes(k) <= hm.SMEM_PER_BLOCK == 232448
    assert hm.wide_shared(k)
    shape = hm.wide_launch_shape(2, 256, 256, k, N_SM, h100_wide_ctas_per_sm(0, k))
    assert shape.smem == hm.wide_segment_bytes(k) and shape.scratch == 0


def test_the_wide_switch_to_a_device_scratch():
    # the last odd window whose k x (32 + k - 1, rounded to 32) words fit a block
    assert hm.MAX_WIDE_SHARED_WINDOW == 225
    assert hm.wide_segment_bytes(225) == 4 * 225 * 256 == 230400
    assert hm.wide_segment_bytes(227) == 4 * 227 * 288 > hm.SMEM_PER_BLOCK
    assert hm.wide_segment_bytes(65) == 4 * 65 * 96 == 24960
    for k in (227, 257, 1001):
        shape = hm.wide_launch_shape(1, 64, 64, k, N_SM, h100_wide_ctas_per_sm(0, k))
        assert not hm.wide_shared(k) and shape.smem == 0
        assert shape.scratch == shape.grid * hm.wide_segment_bytes(k) // 4
        assert shape.grid == min(shape.tiles, N_SM)  # one CTA, one scratch, an SM


# the envelope's wide shapes: (b, h, w, k) -> (band rows, tiles)
WIDE_SHAPES = {(2, 256, 256, 65): (7, 592), (1, 256, 256, 65): (4, 512),
               (2, 256, 256, 127): (16, 256), (1, 64, 64, 127): (1, 128),
               (1, 64, 64, 257): (1, 128), (2, 24, 260, 223): (4, 108),
               (2, 24, 260, 227): (4, 108), (hm.MAX_BATCH + 100, 2, 2, 65): (2, hm.MAX_BATCH),
               (2, 3072, 3072, 65): (1024, 576), (4, 40, 40, 65): (1, 320)}


@pytest.mark.parametrize("shape", list(WIDE_SHAPES))
def test_the_wide_bands_fill_the_card_where_the_canvas_allows(shape):
    # the shortest band whose tiles all run at once: the slots are the CTAs
    # the SMs hold together (on an H100 by registers, threads and shared
    # memory; one an SM where the segments are in scratch), the whole height
    # where one band overflows
    b, h, w, k = shape
    per_sm = h100_wide_ctas_per_sm(0, k)
    t = hm.wide_launch_shape(b, h, w, k, N_SM, per_sm)
    strips, nb = -(-w // 32), min(b, hm.MAX_BATCH)
    slots = N_SM * per_sm

    def tiles(rows):
        return nb * -(-h // rows) * strips

    assert (t.rows, t.tiles) == WIDE_SHAPES[shape] and t.tiles == tiles(t.rows)
    if tiles(h) <= slots:
        assert t.tiles <= slots and (t.rows == 1 or tiles(t.rows - 1) > slots)
    else:
        assert t.rows == h
    assert t.grid == min(t.tiles, slots)
    assert t.tiles >= min(N_SM, nb * h * strips) or 2 * t.tiles > slots  # fills the card


GROW_CANVASES = [(2161, 2161), (2304, 2304), (3072, 3072), (4096, 4096), (2161, 16384),
                 (6000, 9000), (8192, 8192), (12000, 12000), (16384, 2161), (16384, 16384),
                 (16385, 2304), (2304, 16385), (20000, 20000), (32768, 1000), (65536, 65536),
                 (1, 100000), (100000, 1), (1, 300000), (300000, 1), (3, 65536)]


@pytest.mark.parametrize("hw", GROW_CANVASES)
@pytest.mark.parametrize("b", [1, 2, 5])
@pytest.mark.parametrize("block_iters", [16, 2, 64])
def test_the_grow_tiles_fit_and_cover_every_canvas(hw, b, block_iters):
    h, w = hw
    ww = -(-w // 32)
    t = hg.global_tiles(b, h, w, block_iters, N_SM)
    assert t.smem <= hg.SMEM_PER_BLOCK
    assert 1 <= t.halo <= min(hg.GLOBAL_MAX_HALO, block_iters, t.rows)
    assert t.rows >= min(block_iters, hg.GLOBAL_MAX_HALO, h)  # one super-step reaches only
    # the neighbouring tiles
    if ww <= hg.GLOBAL_WIDE_WORDS:
        assert t.words == ww
    else:
        assert t.words <= hg.GLOBAL_TILE_WORDS and -(-ww // t.words) * t.words >= ww
    assert t.tiles == b * -(-h // t.rows) * -(-ww // t.words)
    assert t.grid == min(t.tiles, N_SM) and t.resident == (t.tiles <= N_SM)
    held = ww if t.words == ww else min(ww, t.words + 2)
    assert held <= hg.GLOBAL_THREADS
    assert t.pitch % 2 == 0 and t.pitch >= held + 4  # 64-bit pairs, a zero border (the
    # kernel's own check of the pitch it is given)
    rows = min(h, t.rows + 2 * t.halo)
    assert t.smem == 4 * (3 * (rows + 2) * t.pitch + (b + 31) // 32 + hg.GLOBAL_RED)
    assert t.tiles <= 1 << 30  # the kernel's own bound on a launch's tiles


def test_the_main_grow_case_is_resident_and_the_double_one_is_not():
    t = hg.global_tiles(2, 4096, 4096, 16, N_SM)
    assert t == (63, 128, 16, 132, 132, 132, t.smem) and t.resident
    assert not hg.global_tiles(2, 8192, 8192, 16, N_SM).resident
