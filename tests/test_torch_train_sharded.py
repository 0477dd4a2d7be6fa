"""The port's data x tensor parallel training held against the JAX package's.

The JAX side runs on its 8 virtual CPU devices (``tests/conftest.py``), the
port's on a mesh that names the CPU eight times, as ``(data, model) = (4,
2)``. Weights are made by the JAX package and carried over with
``convert.unet_params_from_jax``; inputs are phantoms at canvas 64 with
base 8, labelled by the port's teacher (bitwise the JAX teacher's,
``tests/test_torch_models.py``). Bounds:

* one dp x tp step: the loss within rtol 1e-5 and the parameters within
  rtol 1e-4, atol 1e-6 of both JAX's sharded step and its plain
  ``train_step`` (the JAX package's own sharded-vs-plain bounds,
  ``tests/test_models.py``);
* ``pad_local_shard`` and ``param_shardings`` exactly the JAX copies';
* ``fit_sharded`` over a batch of 5 wraps it and learns (last loss below
  0.7x the first), as the JAX test does;
* ``fit_distributed`` in a world of 1 (gloo) against JAX
  ``fit_distributed`` over the 8 virtual devices, at the one-step bounds
  above for every loss of the curve and the final parameters
  (``tests/test_torch_distributed.py`` runs it over two ranks with padded
  shards).
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from nm03_capstone_project_tpu import models as jm  # noqa: E402
from nm03_capstone_project_tpu.parallel import make_mesh as jax_make_mesh  # noqa: E402
from nm03_capstone_project_tpu_torch import models as pm  # noqa: E402
from nm03_capstone_project_tpu_torch.config import PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.convert import (  # noqa: E402
    unet_params_from_jax,
    unet_params_to_jax,
)
from nm03_capstone_project_tpu_torch.core import pad_to_canvas  # noqa: E402
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_series  # noqa: E402
from nm03_capstone_project_tpu_torch.parallel import make_mesh  # noqa: E402

CANVAS = 64
CFG = PipelineConfig(canvas=CANVAS, grow_block_iters=8, grow_max_iters=128)
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_params(seed):
    """A JAX 2D student tree at base 8: He-normal kernels, small random
    biases (so that the bias path is exercised), from a numpy seed."""
    import functools

    shapes = jax.eval_shape(functools.partial(jm.init_unet, base=8), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        if len(s.shape) == 1:
            return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        fan_in = np.prod(s.shape[:-1])
        return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return jax.tree.map(leaf, shapes)


def _batch(n, seed):
    """(student inputs, teacher labels, dims) of n phantom slices, two sizes."""
    series = (phantom_series(n - n // 2, 64, 64, seed=seed)
              + phantom_series(n // 2, 60, 52, seed=seed + 1))
    b = pad_to_canvas(series, (CANVAS, CANVAS), device="cpu")
    x = pm.prepare_student_inputs(b.pixels, CFG)
    labels = pm.distill_batch(b.pixels, b.dims, CFG, device="cpu")
    return x, labels, b.dims


def _jax_mesh():
    assert len(jax.devices()) >= 8, "tests/conftest.py sets 8 virtual CPU devices"
    return jax_make_mesh(8, axis_names=("data", "model"), axis_sizes=(4, 2))


class TestPadLocalShard:
    @pytest.mark.parametrize("b,target", [(5, 5), (5, 8), (3, 7), (1, 4)])
    @pytest.mark.parametrize("kind", ["numpy", "tensor"])
    def test_equals_the_jax_copy(self, b, target, kind):
        rng = np.random.default_rng(b * 10 + target)
        px = rng.random((b, 4, 4), np.float32)
        lb = (rng.random((b, 4, 4)) < 0.5).astype(np.uint8)
        dm = rng.integers(1, 5, (b, 2)).astype(np.int32)
        want = jm.pad_local_shard(px, lb, dm, target)
        args = (px, lb, dm) if kind == "numpy" else tuple(torch.from_numpy(a) for a in
                                                          (px, lb, dm))
        got = pm.pad_local_shard(*args, target)
        for g, w in zip(got, want):
            g = g.numpy() if kind == "tensor" else g
            assert g.dtype == w.dtype and np.array_equal(g, w)

    def test_a_target_below_the_batch_raises(self):
        px = np.zeros((3, 2, 2), np.float32)
        with pytest.raises(ValueError, match="target 2 < local batch 3"):
            pm.pad_local_shard(px, px, np.zeros((3, 2), np.int32), 2)


class TestParamShardings:
    def test_the_same_leaves_split_as_in_jax(self):
        jp = _jax_params(0)
        jspec = jm.param_shardings(jp, _jax_mesh())
        model = unet_params_from_jax(jp, device="cpu")
        got = pm.param_shardings(model, make_mesh(8, ("data", "model"), (4, 2), devices=CPU8))
        # the port's names in the JAX tree's order (convert.unet_params_to_jax)
        names = []
        for part, n in (("enc", len(model.enc)), ("mid", None), ("dec", len(model.dec))):
            for i in (range(n) if n is not None else [None]):
                for c in ("c1", "c2"):
                    base = f"{part}.{i}.{c}" if i is not None else f"{part}.{c}"
                    names += [(base, "b"), (base, "w")]
        names += [("head", "b"), ("head", "w")]
        leaves = jax.tree_util.tree_leaves(jspec, is_leaf=lambda s: hasattr(s, "spec"))
        paths = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_leaves_with_path(jspec, is_leaf=lambda s: hasattr(s, "spec"))]
        assert len(leaves) == len(names) == len(got)
        for (base, kind), path, spec in zip(names, paths, leaves):
            assert path.endswith(f"['{kind}']"), (path, base)
            jax_split = "model" in tuple(spec.spec)
            port = got[f"{base}.{'weight' if kind == 'w' else 'bias'}"]
            assert (port == 0) == jax_split and port in (0, None), (base, kind, spec.spec)
        # as the JAX test pins: the head's kernel splits on out-channels
        assert tuple(jspec["head"]["w"].spec) == (None, None, None, "model")
        assert got["head.weight"] == 0 and got["head.bias"] == 0

    def test_nothing_splits_without_a_model_axis_or_when_it_does_not_divide(self):
        model = pm.init_unet(torch.Generator().manual_seed(0), base=8, device="cpu")
        one = pm.param_shardings(model, make_mesh(4, ("data",), devices=CPU8))
        three = pm.param_shardings(model, make_mesh(6, ("data", "model"), (2, 3),
                                                    devices=CPU8))
        assert set(one.values()) == {None}
        # base 8: widths 8, 16, 32 and the head's 8 do not divide by 3
        assert set(three.values()) == {None}


class TestShardedStep:
    def test_dp_tp_step_matches_jax(self):
        jmesh = _jax_mesh()
        jp = _jax_params(4)
        x, labels, dims = _batch(8, seed=3)
        jx, jl, jd = (jnp.asarray(t.numpy()) for t in (x, labels, dims))
        tx = jm.make_optimizer(1e-3)
        step_fn, place = jm.make_sharded_train_step(jmesh, jp, tx, compute_dtype=jnp.float32)
        sp = place(jp)
        new_sp, _, loss_sharded = step_fn(sp, tx.init(sp), jx, jl, jd)
        new_p, _, loss_plain = jm.train_step(jp, tx.init(jp), jx, jl, jd, tx=tx,
                                             compute_dtype=jnp.float32)

        mesh = make_mesh(8, ("data", "model"), (4, 2), devices=CPU8)
        step, student = pm.make_sharded_train_step(mesh, unet_params_from_jax(jp, device="cpu"),
                                                   lr=1e-3, compute_dtype=torch.float32)
        loss = float(step(x, labels, dims))
        got = unet_params_to_jax(student.gather())
        for want_loss, want_params in ((loss_sharded, new_sp), (loss_plain, new_p)):
            assert np.allclose(loss, float(want_loss), rtol=1e-5)
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want_params)):
                np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
        moved = max(np.abs(a - b).max() for a, b in zip(jax.tree.leaves(got),
                                                          jax.tree.leaves(jp)))
        assert moved > 1e-5  # the step changed the parameters

    def test_the_split_is_held_by_the_shards(self):
        """Split leaves live as one piece a model shard, each half the
        out-channels; the replicated ones whole; gather undoes the split."""
        model = pm.init_unet(torch.Generator().manual_seed(2), base=8, device="cpu")
        mesh = make_mesh(4, ("data", "model"), (2, 2), devices=CPU8)
        _, student = pm.make_sharded_train_step(mesh, model)
        head = student.masters["head.weight"]
        assert len(head) == 2 and [tuple(t.shape) for t in head] == [(4, 8, 1, 1)] * 2
        back = student.gather()
        assert all(torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                     model.state_dict().values()))

    def test_the_3d_student_is_refused(self):
        model = pm.init_unet3d(torch.Generator().manual_seed(0), base=8, device="cpu")
        with pytest.raises(ValueError, match="takes the 2D student"):
            pm.make_sharded_train_step(make_mesh(2, ("data", "model"), (1, 2), devices=CPU8),
                                       model)


class TestFitSharded:
    def test_wraps_an_odd_batch_and_learns(self):
        mesh = make_mesh(8, ("data", "model"), (4, 2), devices=CPU8)
        x, labels, dims = _batch(5, seed=7)
        model = unet_params_from_jax(_jax_params(6), device="cpu")
        trained, losses = pm.fit_sharded(model, x, labels, dims, mesh, steps=30, lr=3e-3)
        assert len(losses) == 30 and np.isfinite(losses).all()
        assert losses[-1] < losses[0] * 0.7, losses[::10]
        # the one-device layout: an ordinary student that save_params takes
        assert type(trained) is pm.UNet
        assert {k: tuple(v.shape) for k, v in trained.state_dict().items()} == {
            k: tuple(v.shape) for k, v in model.state_dict().items()}

    def test_equals_fit_on_a_one_by_one_mesh(self):
        """A (1, 1) mesh is the one-device loop: same losses, same weights."""
        x, labels, dims = _batch(4, seed=9)
        jp = _jax_params(8)
        _, want = pm.fit(unet_params_from_jax(jp, device="cpu"), x, labels, dims, steps=4,
                         lr=3e-3)
        mesh = make_mesh(1, ("data", "model"), (1, 1), devices=CPU8)
        _, got = pm.fit_sharded(unet_params_from_jax(jp, device="cpu"), x, labels, dims, mesh,
                                steps=4, lr=3e-3)
        np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.fixture
def world_of_one(monkeypatch):
    """A gloo job of this process alone, left again after the test."""
    import socket

    from nm03_capstone_project_tpu_torch.parallel import distributed

    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "SLURM_STEP_NODELIST",
                "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert distributed.initialize(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        yield distributed
    finally:
        distributed.shutdown()


class TestFitDistributed:
    def test_a_world_of_one_matches_jax_fit_distributed(self, world_of_one):
        """Every rank's loss part and gradient, summed by all_reduce, give
        JAX's data-parallel step over the whole batch: each loss of the
        curve and the final weights at the one-step bounds, at the rate of
        the step test above (the schedule's first step has a rate of 0,
        so three steps move the weights twice)."""
        x, labels, dims = _batch(8, seed=11)
        jp = _jax_params(10)
        want_p, want = jm.fit_distributed(jp, x.numpy(), labels.numpy(), dims.numpy(),
                                          steps=3, lr=1e-3)
        model, got = pm.fit_distributed(unet_params_from_jax(jp, device="cpu"), x, labels,
                                        dims, steps=3, lr=1e-3)
        assert world_of_one.process_count() == 1 and len(got) == len(want) == 3
        np.testing.assert_allclose(got, want, rtol=1e-5)
        got_p = unet_params_to_jax(model)
        for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(want_p)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6)
        moved = max(np.abs(a - b).max() for a, b in zip(jax.tree.leaves(got_p),
                                                          jax.tree.leaves(jp)))
        assert moved > 1e-4  # the two moving steps changed the weights
