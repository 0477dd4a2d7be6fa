"""The 3D grow kernel's layout and schedule, on the CPU.

``csrc/grow3d.cu`` cannot run here. What it computes word for word is
written out below in numpy on the layout :func:`grow3d_layout` gives it
(the pack, the Jacobi steps over the stepped range with every neighbour
at a fixed offset, the block flag and the state words the card decides
by, the unpack from the buffer they name) and held bitwise to the
plain :func:`region_grow_3d` in mask, ``converged`` and steps: ragged
widths, one plane, one voxel, both connectivities, a batch axis, truncated
runs. The card tests (``tests/test_torch_card.py``) hold the kernel itself
to the plain loop. Also the route ``grow_volume`` takes off the CPU: the
kernel, which raises for a device that is not the card, never the torch
loop (``tests/test_torch_volume.py`` holds the CPU to the torch loop).
"""

import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.ops import hopper_volume as hv
from nm03_capstone_project_tpu_torch.ops.volume import region_grow_3d
from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import grow_volume

LOW, HIGH = 0.74, 0.91


def _hdilate(c, left, right):
    return c | (c << 1) | (left >> 31) | (c >> 1) | (right << 31)


def _word_index(lay, b, d, h, ww):
    """Each voxel word's index in the layout, shaped (b, d, h, ww)."""
    bb, zz, yy, ii = np.meshgrid(np.arange(b), np.arange(d), np.arange(h), np.arange(ww),
                                 indexing="ij")
    return lay.front + ((bb * (d + 1) + zz + 1) * (h + 1) + yy + 1) * lay.row + ii + 1


def _grow3d_words(vol, seeds, valid, connectivity, block_iters, max_iters):
    """The kernels' arithmetic in numpy: ``(mask, converged, steps)``."""
    lead, (d, h, w) = vol.shape[:-3], vol.shape[-3:]
    b = int(np.prod(lead, dtype=np.int64))
    lay = hv.grow3d_layout(b, d, h, w)
    ww = lay.row - 1
    assert lay.front >= lay.row + 33 and lay.front % 32 == 0
    v = vol.reshape(b, d, h, w)
    in_band = (v >= np.float32(LOW)) & (v <= np.float32(HIGH))
    in_band &= np.broadcast_to(valid, vol.shape).reshape(b, d, h, w)
    seeded = np.broadcast_to(seeds, vol.shape).reshape(b, d, h, w) & in_band

    def pack(bits):
        padded = np.zeros((b, d, h, ww * 32), bool)
        padded[..., :w] = bits
        weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
        return (padded.reshape(b, d, h, ww, 32) * weights).sum(-1).astype(np.uint32)

    at = _word_index(lay, b, d, h, ww)
    band = np.zeros(lay.total, np.uint32)
    band[at] = pack(in_band)
    bufs = np.zeros((2, lay.total), np.uint32)
    bufs[0][at] = bufs[1][at] = pack(seeded)

    # the stepped range, whole warps of 32 words
    lo = (lay.front + lay.plane) // 32 * 32
    hi = -(-(lay.front + b * (d + 1) * lay.plane) // 32) * 32
    words = np.arange(lo, hi)
    reach = lay.plane + lay.row + 1
    assert words[0] - reach >= 0 and words[-1] + reach < lay.total
    assert set(at.ravel()) <= set(words)

    def step(cur):
        def row(off):
            return _hdilate(cur[words + off], cur[words + off - 1], cur[words + off + 1])

        if connectivity == 26:
            grown = np.zeros(words.size, np.uint32)
            for dz in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    grown |= row(dz * lay.plane + dy * lay.row)
        else:
            grown = (row(0) | cur[words - lay.row] | cur[words + lay.row]
                     | cur[words - lay.plane] | cur[words + lay.plane])
        return grown & band[words]

    # the run: every block on the card, the state words as csrc/grow3d.cu
    # leaves them (the last block that changed a word, the steps, the
    # buffer that holds the region, the blocks)
    state = dict.fromkeys(hv.GROW3D_STATE, 0)
    cur = 0
    while True:
        state["blocks"] += 1
        changed = False
        for _ in range(block_iters):
            out = step(bufs[cur])
            changed |= bool((out != bufs[cur][words]).any())
            bufs[cur ^ 1][words] = out
            cur ^= 1
        state["steps"] += block_iters
        if changed:
            state["flag"] = state["blocks"]
        if state["flag"] < state["blocks"] or state["steps"] >= max_iters:
            break
    state["cur"] = cur
    # the unpack
    region = bufs[state["cur"]]
    # every border word is still 0
    border = np.ones(lay.total, bool)
    border[at] = False
    assert not region[border].any() and not band[border].any()
    bits = (region[at][..., None] >> np.arange(32, dtype=np.uint32)) & 1
    mask = bits.reshape(b, d, h, ww * 32)[..., :w].astype(np.uint8).reshape(vol.shape)
    return mask, state["flag"] != state["blocks"], state["steps"]


def _phantom(shape, seed, fill=0.55):
    """Random voxels in band with probability ``fill`` (a maze of paths at
    about the percolation threshold), one seed a volume, and a valid mask
    cutting a few columns."""
    rng = np.random.default_rng(seed)
    vol = np.where(rng.random(shape) < fill, 0.8, 0.5).astype(np.float32)
    vol[..., 0, 0, 0] = 0.8
    seeds = np.zeros(shape, bool)
    seeds[..., 0, 0, 0] = True
    valid = np.ones(shape[-2:], bool)
    if shape[-1] > 4:
        valid[:, -2:] = False
    return vol, seeds, valid


def _plain(vol, seeds, valid, connectivity, block_iters, max_iters):
    mask, conv, steps = region_grow_3d(
        torch.from_numpy(vol), torch.from_numpy(seeds), LOW, HIGH,
        valid=torch.from_numpy(valid), connectivity=connectivity, block_iters=block_iters,
        max_iters=max_iters, return_steps=True)
    return mask.numpy(), bool(conv), steps


SHAPES = [(7, 33, 65), (5, 25, 41), (1, 9, 31), (1, 1, 1), (2, 4, 12, 40), (3, 2, 3, 64)]


@pytest.mark.parametrize("connectivity", [6, 26])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_the_kernels_words_equal_the_plain_loop(shape, connectivity):
    vol, seeds, valid = _phantom(shape, seed=len(shape) * 100 + shape[-1])
    for block_iters, max_iters in ((16, 4096), (1, 4096), (7, 4096), (4, 8)):
        want = _plain(vol, seeds, valid, connectivity, block_iters, max_iters)
        got = _grow3d_words(vol, seeds, valid, connectivity, block_iters, max_iters)
        assert np.array_equal(got[0], want[0]), (block_iters, max_iters)
        assert got[1:] == want[1:], (block_iters, max_iters)


@pytest.mark.parametrize("block_iters,max_iters", [(7, 3), (7, 7), (7, 10), (7, 14), (5, 4096),
                                                   (16, 24)])
def test_the_card_stops_where_the_plain_loop_does(block_iters, max_iters):
    # odd blocks leave the region in either buffer by the blocks' parity,
    # and the cap falls below, at and between multiples of a block
    vol, seeds, valid = _phantom((9, 20, 37), seed=11, fill=0.6)
    want = _plain(vol, seeds, valid, 6, block_iters, max_iters)
    got = _grow3d_words(vol, seeds, valid, 6, block_iters, max_iters)
    assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
    # every cap here but the last cuts the growth at its first block past the cap
    assert got[1] is (max_iters == 4096)
    if not got[1]:
        assert got[2] == -(-max_iters // block_iters) * block_iters


def test_the_words_truncate_where_the_plain_loop_does():
    # a straight corridor along z, 40 planes long: 16 steps reach 17 planes
    vol = np.full((40, 3, 5), 0.5, np.float32)
    vol[:, 1, 2] = 0.8
    seeds = np.zeros_like(vol, dtype=bool)
    seeds[0, 1, 2] = True
    valid = np.ones((3, 5), bool)
    for max_iters in (16, 32, 4096):
        want = _plain(vol, seeds, valid, 6, 16, max_iters)
        got = _grow3d_words(vol, seeds, valid, 6, 16, max_iters)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
        assert want[1] is (max_iters == 4096)


def test_the_layout_leads_every_row_plane_and_volume_with_zeros():
    lay = hv.grow3d_layout(2, 155, 256, 256)
    assert (lay.row, lay.plane) == (9, 257 * 9)
    assert lay.front == 64 and lay.total == 2 * 64 + (2 * 156 + 1) * 257 * 9
    # 155 x 256 x 256: 1.45 MB a buffer, three of them in the 50 MB L2
    assert hv.grow3d_layout(1, 155, 256, 256).total * 4 == 1_453_076


def test_off_the_cpu_the_kernel_runs_or_raises():
    # a device that is neither the CPU nor CUDA: the kernel route, which
    # refuses it; no fall back to the torch loop
    vol, seeds, valid = _phantom((6, 20, 24), seed=3)
    pre, seeds, valid = (torch.from_numpy(np.broadcast_to(a, vol.shape).copy()).to("meta")
                         for a in (vol, seeds, valid))
    with pytest.raises(ValueError, match="region_grow_3d_kernel takes CUDA tensors"):
        grow_volume(pre, seeds, valid, PipelineConfig())
