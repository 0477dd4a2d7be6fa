"""The plain reference against the program's plain path, and the seeded data.

The reference imports nothing of the program; these tests import both and
hold them to the same bits on small phantoms on the CPU, where the
program runs its plain PyTorch ops (its kernels are held to those on the
card by the program's own tests).
"""

from __future__ import annotations

import copy

import pytest
import torch

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.core.image import valid_mask
from nm03_capstone_project_tpu_torch.ops.seeds import seed_mask
from nm03_capstone_project_tpu_torch.pipeline import process_batch, process_volume
from portbench import data, reference
from portbench.tests.tiny import TINY_CONFIG

SLICES = TINY_CONFIG
VOLUME = copy.deepcopy(TINY_CONFIG)
VOLUME["cohort"].update(planes=20, dims=[[60, 60], [64, 57]], profile="ellipsoid",
                        brain_half_planes=12.0, skull=False,
                        lesions=[{"r": 0.15, "half_planes": 4.0, "centre": 0.5},
                                 {"r": 0.2, "half_planes": 6.0, "centre": 0.4}])


def _batch_dims(study):
    return torch.tensor([list(study.dims)] * study.pixels.shape[0], dtype=torch.int32)


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_process_batch_equals_the_program(seed):
    p = SLICES["pipeline"]
    cfg = PipelineConfig(**p)
    for st in data.make_cohort(SLICES["cohort"], seed, "cpu"):
        dims = _batch_dims(st)
        want = process_batch(st.pixels, dims, cfg, device="cpu")
        got = reference.process_batch(st.pixels, dims, p)
        assert int(want["mask"].sum()) > 0
        assert torch.equal(got["mask"], want["mask"])
        assert torch.equal(got["grow_converged"], want["grow_converged"])


@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_process_volume_equals_the_program(seed):
    p = VOLUME["pipeline"]
    cfg = PipelineConfig(**p)
    for st in data.make_cohort(VOLUME["cohort"], seed, "cpu"):
        dims = torch.tensor(list(st.dims), dtype=torch.int32)
        want = process_volume(st.pixels, dims, cfg, device="cpu")
        got = reference.process_volume(st.pixels, dims, p)
        assert int(want["mask"].sum()) > 0
        assert torch.equal(got["mask"], want["mask"])
        assert bool(got["grow_converged"]) == bool(want["grow_converged"])


def test_a_truncated_growth_equals_the_program():
    p = dict(SLICES["pipeline"], grow_block_iters=2, grow_max_iters=4)
    st = data.make_study(SLICES["cohort"], 0, 9, "cpu")
    want = process_batch(st.pixels, _batch_dims(st), PipelineConfig(**p), device="cpu")
    got = reference.process_batch(st.pixels, _batch_dims(st), p)
    assert not bool(want["grow_converged"].all())
    assert torch.equal(got["mask"], want["mask"])
    assert torch.equal(got["grow_converged"], want["grow_converged"])


def test_seeds_and_valid_equal_the_program():
    dims = torch.tensor([[64, 64], [61, 53], [17, 9], [100, 3]], dtype=torch.int32)
    seeds, valid = reference.seeds_and_valid(dims, (100, 100))
    assert torch.equal(seeds, seed_mask(dims, (100, 100)))
    assert torch.equal(valid, valid_mask(dims, (100, 100)))


def test_the_control_differs_from_the_reference():
    """One precision below float32 moves voxels across the band's edge."""
    p = SLICES["pipeline"]
    diff = 0
    for st in data.make_cohort(SLICES["cohort"], 21, "cpu"):
        a = reference.process_batch(st.pixels, _batch_dims(st), p)
        b = reference.process_batch(st.pixels, _batch_dims(st), p, torch.bfloat16)
        diff += int((a["mask"] != b["mask"]).sum())
    assert diff > 0


def test_the_same_seed_makes_the_same_studies():
    a = data.make_cohort(SLICES["cohort"], 77, "cpu")
    b = data.make_cohort(SLICES["cohort"], 77, "cpu")
    c = data.make_cohort(SLICES["cohort"], 78, "cpu")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x.pixels, y.pixels) and x.dims == y.dims
        assert not torch.equal(x.pixels, z.pixels)
        assert x.dims == z.dims  # the seed changes the noise, not the set of sizes
    assert data.study_order(20, 77) == data.study_order(20, 77)
    assert sorted(data.study_order(20, 78)) == list(range(20))


def test_every_seed_holds_the_same_work():
    """Lesions and sizes are the configuration's: a seed changes only the
    noise, so the grown regions of two seeds differ at their edges only."""
    p = SLICES["pipeline"]
    for i in range(SLICES["cohort"]["studies"]):
        a, b = (data.make_study(SLICES["cohort"], i, s, "cpu") for s in (1, 2))
        ma = reference.process_batch(a.pixels, _batch_dims(a), p)["mask"].sum().item()
        mb = reference.process_batch(b.pixels, _batch_dims(b), p)["mask"].sum().item()
        assert abs(ma - mb) <= 0.1 * max(ma, mb)


def test_padding_is_zero_and_pixels_in_the_window():
    st = data.make_study(SLICES["cohort"], 1, 4, "cpu")
    h, w = st.dims
    assert st.pixels.dtype == torch.float32
    assert float(st.pixels[:, h:, :].abs().sum()) == 0.0
    assert float(st.pixels[:, :, w:].abs().sum()) == 0.0
    assert 0.0 <= float(st.pixels.min()) and float(st.pixels.max()) <= 10000.0
