"""The port's ``parallel/`` held against the JAX package's, on the CPU.

The same numpy inputs (made from seeds) go through the JAX package's
``parallel/`` on its 8 virtual CPU devices (``tests/conftest.py``) and
through the port's on meshes that name the CPU several times (``[cpu] *
4``), the port's counterpart of virtual devices. Every mask and every
``grow_converged`` flag compares bitwise (tolerance 0), against the JAX
function and against the port's single-device pipeline.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nm03_capstone_project_tpu.config import PipelineConfig as JaxConfig
from nm03_capstone_project_tpu.parallel import make_mesh as jax_make_mesh
from nm03_capstone_project_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from nm03_capstone_project_tpu.parallel import (
    process_batch_sharded as jax_process_batch_sharded,
)
from nm03_capstone_project_tpu.parallel import (
    process_volume_batch_zsharded as jax_process_volume_batch_zsharded,
)
from nm03_capstone_project_tpu.parallel import (
    process_volume_zsharded as jax_process_volume_zsharded,
)
from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice, phantom_volume
from nm03_capstone_project_tpu_torch.parallel import (
    batch_shards,
    gather_shards,
    make_mesh,
    pad_to_multiple,
    process_batch_sharded,
    process_volume_batch_zsharded,
    process_volume_zsharded,
    replicated,
)
from nm03_capstone_project_tpu_torch.pipeline import process_batch, process_volume

CPU = torch.device("cpu")
HW = 64
KW = dict(canvas=HW, min_dim=16, grow_block_iters=8, grow_max_iters=512)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(**kw):
    both = {**KW, **kw}
    return PipelineConfig(**both), JaxConfig(**both)


def _cpu_mesh(n, axis_names=("data",), axis_sizes=None):
    return make_mesh(devices=[CPU] * n, axis_names=axis_names, axis_sizes=axis_sizes)


def _batch(n, seed=0, exact=False):
    """``n`` phantoms of random true sizes; with ``exact`` integer pixels
    at the full canvas, where every render lerp weight is exact and the
    jitted JAX render is bit-identical to the port's (test_torch_render.py)."""
    rng = np.random.default_rng(seed)
    px = np.stack([phantom_slice(HW, HW, seed=seed + i, lesion_radius=0.12 + 0.01 * i)
                   for i in range(n)])
    dims = np.stack([rng.integers(40, HW + 1, 2) for _ in range(n)]).astype(np.int32)
    if exact:
        px, dims = np.round(px), np.full((n, 2), HW, np.int32)
    for i, (h, w) in enumerate(dims):
        px[i, h:, :] = 0
        px[i, :, w:] = 0
    return px, dims


def _volume(depth=16, seed=3):
    return phantom_volume(depth, HW, HW, seed=seed), np.asarray([HW, HW], np.int32)


class TestMesh:
    def test_make_mesh_shape(self):
        assert _cpu_mesh(4).shape == {"data": 4}
        assert make_mesh(device="cpu").shape == {"data": 1}

    def test_two_axis_mesh(self):
        m = _cpu_mesh(4, ("data", "z"), (2, 2))
        assert m.shape == {"data": 2, "z": 2} and m.devices.shape == (2, 2)
        assert m.axis_devices("z") == [CPU, CPU]

    def test_too_many_devices_and_bad_sizes_raise(self):
        with pytest.raises(ValueError, match="only 1 available"):
            make_mesh(2, device="cpu")
        with pytest.raises(ValueError, match="axis_sizes"):
            _cpu_mesh(4, ("data", "z"), (3, 2))

    @pytest.mark.parametrize("b,multiple", [(5, 8), (5, 5), (6, 4), (1, 3)])
    def test_pad_to_multiple_equals_the_jax_function(self, b, multiple):
        px, dims = _batch(b)
        got = pad_to_multiple(px, dims, multiple)
        want = jax_pad_to_multiple(px, dims, multiple)
        assert got[2] == want[2] == b
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].shape[0] % multiple == 0 and (got[1][b:] == 1).all()

    def test_split_and_gather_round_trip(self):
        x = torch.arange(24.0).reshape(6, 2, 2)
        mesh = _cpu_mesh(3)
        shards = batch_shards(x, mesh)
        assert [tuple(s.shape) for s in shards] == [(2, 2, 2)] * 3
        assert torch.equal(gather_shards(shards, CPU), x)
        assert all(torch.equal(r, x) for r in replicated(x, mesh))
        with pytest.raises(ValueError, match="not divisible"):
            batch_shards(x, _cpu_mesh(4))


class TestDataParallel:
    @pytest.mark.parametrize("mode", ["mask_only", "with_render"])
    def test_sharded_equals_process_batch_and_the_jax_function(self, mode):
        pcfg, jcfg = _cfgs()
        px, dims = _batch(8, seed=10, exact=mode == "with_render")
        flags = {mode: True}
        got = process_batch_sharded(px, dims, pcfg, _cpu_mesh(4), **flags)
        want = jax_process_batch_sharded(jnp.asarray(px), jnp.asarray(dims), jcfg,
                                         jax_make_mesh(8, axis_names=("data",)), **flags)
        assert set(got) == set(want)
        for key in got:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
        single = process_batch(px, dims, pcfg, device="cpu")
        np.testing.assert_array_equal(got["grow_converged"].numpy(),
                                      single["grow_converged"].numpy())
        if mode == "mask_only":
            np.testing.assert_array_equal(got["mask"].numpy(), single["mask"].numpy())

    def test_two_devices_with_fillers(self):
        pcfg, _ = _cfgs()
        px, dims = _batch(5, seed=20)
        ppx, pdims, real = pad_to_multiple(px, dims, 2)
        got = process_batch_sharded(ppx, pdims, pcfg, _cpu_mesh(2))
        single = process_batch(px, dims, pcfg, device="cpu")
        assert real == 5 and got["mask"].shape[0] == 6
        np.testing.assert_array_equal(got["mask"][:real].numpy(), single["mask"].numpy())
        np.testing.assert_array_equal(got["grow_converged"][:real].numpy(),
                                      single["grow_converged"].numpy())
        assert int(got["mask"][real:].sum()) == 0  # fillers segment empty

    def test_one_device_is_process_batch(self):
        pcfg, _ = _cfgs()
        px, dims = _batch(3, seed=30)
        got = process_batch_sharded(px, dims, pcfg, device="cpu")
        single = process_batch(px, dims, pcfg, device="cpu")
        for key in single:
            assert torch.equal(got[key], single[key])

    def test_indivisible_batch_raises(self):
        pcfg, _ = _cfgs()
        px, dims = _batch(3)
        with pytest.raises(ValueError, match="not divisible"):
            process_batch_sharded(px, dims, pcfg, _cpu_mesh(2))
        with pytest.raises(ValueError, match="mutually exclusive"):
            process_batch_sharded(px, dims, pcfg, _cpu_mesh(1), with_render=True,
                                  mask_only=True)


@pytest.fixture(scope="module")
def jax_zmesh():
    return jax_make_mesh(4, axis_names=("z",))


class TestStudentOverTheMesh:
    @pytest.mark.parametrize("n", [2, 3])
    def test_equals_one_device_bitwise(self, n):
        """The parallel driver's student over an n-way data mesh
        (:func:`map_batch_sharded` with the runner's student step): the
        masks of the one-device student, bit for bit."""
        from nm03_capstone_project_tpu_torch import models as pm
        from nm03_capstone_project_tpu_torch.cli.runner import _student_process
        from nm03_capstone_project_tpu_torch.parallel import map_batch_sharded

        pcfg, _ = _cfgs()
        model = pm.init_unet(torch.Generator().manual_seed(1), base=8, device="cpu")
        px, dims = _batch(6, seed=4)
        want = _student_process(model, torch.from_numpy(px), torch.from_numpy(dims), pcfg)
        got = map_batch_sharded(lambda dev, p, d: _student_process(model, p, d, pcfg),
                                px, dims, _cpu_mesh(n))
        assert torch.equal(got["mask"], want["mask"]) and int(want["mask"].sum()) > 0
        assert got["grow_converged"].all() and len(got["grow_converged"]) == 6


class TestZShard:
    @pytest.mark.parametrize("morph", [1, 3, 5])
    def test_equals_process_volume_and_the_jax_function(self, morph, jax_zmesh):
        pcfg, jcfg = _cfgs(morph_size=morph)
        vol, dims = _volume()
        want = jax_process_volume_zsharded(jnp.asarray(vol), jnp.asarray(dims), jcfg, jax_zmesh)
        single = process_volume(vol, dims, pcfg, device="cpu")
        assert int(single["mask"].sum()) > 0
        for n in (2, 4):
            got = process_volume_zsharded(vol, dims, pcfg, _cpu_mesh(n, ("z",)))
            np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
            assert torch.equal(got["mask"], single["mask"])
            assert bool(got["grow_converged"]) == bool(want["grow_converged"]) \
                == bool(single["grow_converged"])
            assert torch.equal(got["original"], torch.from_numpy(vol))

    def test_a_region_crossing_every_shard_boundary(self):
        """A lesion column through all 16 planes: the region grows across
        every boundary of a 4-way split, so every halo exchange carries it."""
        pcfg, _ = _cfgs()
        vol = np.full((16, HW, HW), 300.0, np.float32)
        yy, xx = np.mgrid[:HW, :HW]
        disk = (yy - HW // 2) ** 2 + (xx - HW // 2) ** 2 < 14 ** 2
        # a column bright enough for the grow band, thinning toward the
        # ends so the fixpoint takes several steps per shard
        for z in range(16):
            r = 6 + abs(z - 8)
            vol[z][disk & ((yy - HW // 2) ** 2 + (xx - HW // 2) ** 2 < r * r)] = 1900.0
        dims = np.asarray([HW, HW], np.int32)
        single = process_volume(vol, dims, pcfg, device="cpu")
        got = process_volume_zsharded(vol, dims, pcfg, _cpu_mesh(4, ("z",)))
        mask = single["mask"].numpy()
        for boundary in (4, 8, 12):
            assert mask[boundary - 1].any() and mask[boundary].any()
        assert torch.equal(got["mask"], single["mask"])
        assert bool(got["grow_converged"]) == bool(single["grow_converged"])

    def test_capped_growth_flag_equals_the_jax_flag(self, jax_zmesh):
        pcfg, jcfg = _cfgs(grow_block_iters=1, grow_max_iters=3)
        vol, dims = _volume(seed=5)
        want = jax_process_volume_zsharded(jnp.asarray(vol), jnp.asarray(dims), jcfg, jax_zmesh)
        got = process_volume_zsharded(vol, dims, pcfg, _cpu_mesh(4, ("z",)))
        assert bool(want["grow_converged"]) is False
        assert bool(got["grow_converged"]) is False
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))

    def test_shallow_halo_and_indivisible_depth_raise(self, jax_zmesh):
        pcfg, jcfg = _cfgs(morph_size=5)
        vol, dims = _volume(depth=4)
        with pytest.raises(ValueError, match="local shard depth 1 < dilation z-radius 2"):
            process_volume_zsharded(vol, dims, pcfg, _cpu_mesh(4, ("z",)))
        with pytest.raises(ValueError, match="local shard depth 1 < dilation z-radius 2"):
            jax_process_volume_zsharded(jnp.asarray(vol), jnp.asarray(dims), jcfg, jax_zmesh)
        vol, dims = _volume(depth=6)
        with pytest.raises(ValueError, match="depth 6 not divisible by z-axis size 4"):
            process_volume_zsharded(vol, dims, pcfg, _cpu_mesh(4, ("z",)))
        with pytest.raises(ValueError, match="depth 6 not divisible by z-axis size 4"):
            jax_process_volume_zsharded(jnp.asarray(vol), jnp.asarray(dims), jcfg, jax_zmesh)

    def test_zshard_grows_by_dilation_whatever_the_schedule(self):
        pcfg, _ = _cfgs(grow_algorithm="jump")
        vol, dims = _volume(seed=7)
        got = process_volume_zsharded(vol, dims, pcfg, _cpu_mesh(2, ("z",)))
        dilate = process_volume(vol, dims, dataclasses.replace(pcfg, grow_algorithm="dilate"),
                                device="cpu")
        assert torch.equal(got["mask"], dilate["mask"])


class TestBatchZShard:
    def test_two_by_two_mesh_equals_the_jax_function(self):
        pcfg, jcfg = _cfgs(grow_block_iters=2, grow_max_iters=24)
        vols = np.stack([phantom_volume(8, HW, HW, seed=s) for s in (1, 2, 3, 4)])
        dims = np.asarray([[HW, HW], [60, 56], [HW, 48], [52, HW]], np.int32)
        for i, (h, w) in enumerate(dims):
            vols[i, :, h:, :] = 0
            vols[i, :, :, w:] = 0
        want = jax_process_volume_batch_zsharded(
            jnp.asarray(vols), jnp.asarray(dims), jcfg,
            jax_make_mesh(4, axis_names=("data", "z"), axis_sizes=(2, 2)))
        got = process_volume_batch_zsharded(
            vols, dims, pcfg, _cpu_mesh(4, ("data", "z"), (2, 2)))
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
        np.testing.assert_array_equal(got["grow_converged"].numpy(),
                                      np.asarray(want["grow_converged"]))
        for i in range(4):
            single = process_volume(vols[i], dims[i], pcfg, device="cpu")
            assert torch.equal(got["mask"][i], single["mask"])
            assert bool(got["grow_converged"][i]) == bool(single["grow_converged"])

    @pytest.mark.parametrize("names", [("data", "z"), ("z", "data")])
    def test_a_process_group_mesh_of_one_equals_the_jax_function(self, names, monkeypatch):
        """The process-group form (one block a rank, slotted count
        reductions, the rows' agreement) in a world of 1 under gloo."""
        import socket

        from nm03_capstone_project_tpu_torch.parallel import Mesh, distributed

        for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "SLURM_STEP_NODELIST",
                    "OMPI_COMM_WORLD_SIZE"):
            monkeypatch.delenv(var, raising=False)
        pcfg, jcfg = _cfgs(grow_block_iters=2, grow_max_iters=24)
        vols = np.stack([phantom_volume(8, HW, HW, seed=s) for s in (5, 6)])
        dims = np.asarray([[HW, HW], [56, 60]], np.int32)
        for i, (h, w) in enumerate(dims):
            vols[i, :, h:, :] = 0
            vols[i, :, :, w:] = 0
        want = jax_process_volume_batch_zsharded(
            jnp.asarray(vols), jnp.asarray(dims), jcfg,
            jax_make_mesh(1, axis_names=("data", "z"), axis_sizes=(1, 1)))
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        assert distributed.initialize(f"127.0.0.1:{port}", 1, 0, device="cpu")
        try:
            g = distributed.global_mesh(names, (1, 1))
            got = process_volume_batch_zsharded(vols, dims, pcfg,
                                                Mesh(g.devices, names, process_group=True))
        finally:
            distributed.shutdown()
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
        np.testing.assert_array_equal(got["grow_converged"].numpy(),
                                      np.asarray(want["grow_converged"]))
        assert torch.equal(got["original"], torch.from_numpy(vols))

    def test_indivisible_batch_raises(self):
        pcfg, _ = _cfgs()
        vols = np.zeros((3, 8, HW, HW), np.float32)
        dims = np.full((3, 2), HW, np.int32)
        with pytest.raises(ValueError, match="batch 3 not divisible by data-axis size 2"):
            process_volume_batch_zsharded(vols, dims, pcfg, _cpu_mesh(4, ("data", "z"), (2, 2)))
