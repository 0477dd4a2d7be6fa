"""The port's U-Net students held against the JAX package's, on the CPU.

Weights are made by the JAX package (``init_unet``/``init_unet3d``) and
carried over with ``convert.unet_params_from_jax``; inputs come from a
numpy seed. Tolerances, each measured well inside its bound here:

* f32 forward: max |logit difference| <= 1e-4 * max |logit| (measured
  ~1e-6 relative: the two conv libraries sum in different orders); masks
  equal wherever |JAX logit| is above that bound;
* bf16 forward: within one bf16 ulp of the largest logit (measured equal);
* loss: relative 1e-6; gradients: relative norm 1e-4 for every leaf;
* the optimiser, fed identical numpy gradients so that Adam's g/sqrt(v)
  cannot amplify gradient differences: the schedule relative 1e-6 at every
  step, parameters after three updates within 1e-6;
* ``fit(steps=5)`` losses relative 1e-3;
* the teacher labels (``distill_batch``, ``distill_volume``) and
  ``prepare_student_inputs`` bitwise.
"""

import functools
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from nm03_capstone_project_tpu import models as jm  # noqa: E402
from nm03_capstone_project_tpu.config import PipelineConfig as JaxConfig  # noqa: E402
from nm03_capstone_project_tpu.data.synthetic import phantom_series  # noqa: E402
from nm03_capstone_project_tpu_torch import models as pm  # noqa: E402
from nm03_capstone_project_tpu_torch.config import PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.convert import (  # noqa: E402
    unet_params_from_jax,
    unet_params_to_jax,
)
from nm03_capstone_project_tpu_torch.core import pad_to_canvas  # noqa: E402
from nm03_capstone_project_tpu_torch.models.train import lr_schedule  # noqa: E402

FWD_RTOL = 1e-4
CANVAS = 64
CFG = PipelineConfig(canvas=CANVAS, grow_block_iters=8, grow_max_iters=128)
JCFG = JaxConfig(canvas=CANVAS, grow_block_iters=8, grow_max_iters=128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_params(init, seed):
    """A JAX parameter tree of ``init``'s structure at base 8 (shapes from
    ``jax.eval_shape``, nothing compiled): He-normal kernels, small random
    biases so that the bias path is exercised."""
    shapes = jax.eval_shape(functools.partial(init, base=8), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def leaf(s):
        if len(s.shape) == 1:
            return (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
        fan_in = np.prod(s.shape[:-1])
        return (rng.standard_normal(s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return jax.tree.map(leaf, shapes)


@pytest.fixture(scope="module")
def nets():
    """{2: (JAX params, port model), 3: ...} at base 8."""
    j2, j3 = _jax_params(jm.init_unet, 0), _jax_params(jm.init_unet3d, 1)
    return {2: (j2, unet_params_from_jax(j2, device="cpu")),
            3: (j3, unet_params_from_jax(j3, device="cpu"))}


def _inputs(ndim, seed=0):
    """Student-range inputs: (3, 32, 32) slices or (1, 8, 16, 16) volumes."""
    shape = (3, 32, 32) if ndim == 2 else (1, 8, 16, 16)
    rng = np.random.default_rng(seed)
    return (rng.random(shape, np.float32) * 1.82 + 0.68).astype(np.float32)


def _japply(ndim):
    return jax.jit(jm.apply_unet if ndim == 2 else jm.apply_unet3d, static_argnums=2)


@pytest.fixture(scope="module")
def phantoms():
    """Six phantom slices of two sizes on the 64 canvas, as the CLI pads them."""
    series = phantom_series(4, 64, 64, seed=3) + phantom_series(2, 60, 52, seed=5)
    b = pad_to_canvas(series, (CANVAS, CANVAS), device="cpu")
    return b.pixels.numpy(), b.dims.numpy()


class TestForward:
    @pytest.mark.parametrize("ndim", [2, 3])
    def test_f32_matches_jax(self, nets, ndim):
        jp, model = nets[ndim]
        x = _inputs(ndim)
        want = np.asarray(_japply(ndim)(jp, jnp.asarray(x), jnp.float32))
        got = model(torch.from_numpy(x), torch.float32).detach().numpy()
        assert got.dtype == np.float32 and got.shape == x.shape
        tol = FWD_RTOL * np.abs(want).max()
        assert np.abs(got - want).max() <= tol
        sure = np.abs(want) > tol
        assert sure.mean() > 0.99
        assert np.array_equal((got > 0)[sure], (want > 0)[sure])

    @pytest.mark.parametrize("ndim", [2, 3])
    def test_bf16_runs_on_the_cpu_and_returns_f32(self, nets, ndim):
        jp, model = nets[ndim]
        x = _inputs(ndim, seed=1)
        got = model(torch.from_numpy(x), torch.bfloat16).detach()
        assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
        want = np.asarray(_japply(ndim)(jp, jnp.asarray(x), jnp.bfloat16))
        assert np.abs(got.numpy() - want).max() <= 2.0**-7 * np.abs(want).max()

    def test_predict_mask_is_uint8(self, nets):
        m = pm.predict_mask(nets[2][1], torch.from_numpy(_inputs(2)), torch.float32)
        assert m.dtype == torch.uint8 and set(m.unique().tolist()) <= {0, 1}
        m3 = pm.predict_mask3d(nets[3][1], torch.from_numpy(_inputs(3)), torch.float32)
        assert m3.dtype == torch.uint8 and m3.shape == (1, 8, 16, 16)

    def test_shapes_are_checked(self, nets):
        with pytest.raises(ValueError, match="divisible by 4"):
            nets[2][1](torch.zeros(1, 30, 32))
        with pytest.raises(ValueError, match=r"\(B, D, H, W\)"):
            nets[3][1](torch.zeros(1, 16, 16))
        with pytest.raises(ValueError, match="multiple of 8"):
            pm.UNet(base=12)

    def test_init_is_seeded_he_normal(self, monkeypatch):
        a = pm.init_unet(torch.Generator().manual_seed(5), base=8, device="cpu")
        b = pm.init_unet(torch.Generator().manual_seed(5), base=8, device="cpu")
        c = pm.init_unet3d(torch.Generator().manual_seed(5), base=8, device="cpu")
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                     b.state_dict().values()))
        w = a.dec[0].c1.weight  # (32, 32 + 16 ... ) in OIHW
        assert abs(float(w.detach().std()) / np.sqrt(2.0 / (w[0].numel())) - 1) < 0.05
        assert all(float(m.abs().sum()) == 0 for k, m in c.state_dict().items()
                   if k.endswith("bias"))
        # the JAX tree the model converts to has the JAX init's shapes
        ref = jax.eval_shape(functools.partial(jm.init_unet3d, base=8), jax.random.PRNGKey(0))
        assert jax.tree.map(np.shape, unet_params_to_jax(c)) == jax.tree.map(
            lambda s: s.shape, ref)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pm.init_unet(torch.Generator().manual_seed(5), base=8)


class TestLossAndGradients:
    @pytest.mark.parametrize("shape", [(3, 32, 32), (2, 4, 32, 32)])
    def test_loss_matches_jax(self, shape):
        rng = np.random.default_rng(7)
        logits = (rng.standard_normal(shape) * 3).astype(np.float32)
        labels = (rng.random(shape) < 0.3).astype(np.uint8)
        dims = np.asarray([[32, 32], [30, 21], [17, 32]][: shape[0]], np.int32)
        # jitted, as the JAX train step computes it (its eager reductions
        # sum less accurately: 2.4e-6 from the float64 value at (2, 4, 32, 32))
        want = float(jax.jit(jm.segmentation_loss)(jnp.asarray(logits), jnp.asarray(labels),
                                                   jnp.asarray(dims)))
        got = float(pm.segmentation_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                         torch.from_numpy(dims)))
        assert abs(got - want) <= 1e-6 * abs(want)

    @pytest.mark.parametrize("ndim", [2, 3])
    def test_gradients_match_jax(self, nets, ndim):
        jp, model = nets[ndim]
        x = _inputs(ndim, seed=2)
        rng = np.random.default_rng(3)
        labels = (rng.random(x.shape) < 0.2).astype(np.uint8)
        dims = np.asarray([[32, 29], [25, 32], [32, 32]][: x.shape[0]] if ndim == 2
                          else [[16, 13]], np.int32)
        apply = _japply(ndim)
        jgrad = jax.jit(jax.grad(lambda p: jm.segmentation_loss(
            apply(p, jnp.asarray(x), jnp.float32), jnp.asarray(labels), jnp.asarray(dims))))(jp)
        model.zero_grad(set_to_none=True)
        pm.segmentation_loss(model(torch.from_numpy(x), torch.float32),
                             torch.from_numpy(labels), torch.from_numpy(dims)).backward()
        got = unet_params_to_jax(_grads_as_model(model))
        for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(got),
                                     jax.tree_util.tree_leaves_with_path(_np(jgrad))):
            assert np.linalg.norm(g - w) <= 1e-4 * np.linalg.norm(w), path
        model.zero_grad(set_to_none=True)


def _grads_as_model(model):
    """A copy of ``model`` whose parameters are its gradients (to reuse the
    JAX-tree conversion)."""
    import copy

    g = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(g.parameters(), model.parameters()):
            p.copy_(q.grad)
    return g


class TestOptimizer:
    @pytest.mark.parametrize("total", [None, 1, 2, 20, 300])
    def test_schedule_equals_optax(self, total):
        lr = 3e-3
        sched, ref = lr_schedule(lr, total), _optax_schedule(lr, total)
        assert sched(0) == (0.0 if total else lr)
        for step in range((total or 10) + 3):
            want = float(ref(step)) if total else ref
            assert abs(sched(step) - want) <= 1e-6 * abs(want) + 1e-12, step

    @pytest.mark.parametrize("total", [None, 20])
    def test_three_updates_match_optax(self, nets, total):
        jp, model = nets[2]
        model = unet_params_from_jax(jp, device="cpu")  # a fresh copy to update
        tx = optax.chain(optax.clip_by_global_norm(1.0),
                         optax.adamw(_optax_schedule(3e-3, total), weight_decay=1e-4))
        opt = pm.make_optimizer(model.parameters(), 3e-3, total_steps=total)
        state, update = tx.init(jp), jax.jit(tx.update)
        params = jp
        rng = np.random.default_rng(11)
        for norm in (3.0, 0.5, 2.0):  # clipped, passed through, clipped
            g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), jp)
            gn = np.sqrt(sum(float((a.astype(np.float64) ** 2).sum())
                             for a in jax.tree.leaves(g)))
            g = jax.tree.map(lambda a: (a * (norm / gn)).astype(np.float32), g)
            updates, state = update(g, state, params)
            params = _np(optax.apply_updates(params, updates))
            grads = unet_params_from_jax(g, device="cpu")
            for p, q in zip(model.parameters(), grads.parameters()):
                p.grad = q.detach().clone()
            opt.step()
        got = unet_params_to_jax(model)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
            assert np.abs(a - b).max() <= 1e-6
        moved = [np.abs(a - b).max() for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp))]
        assert max(moved) > 1e-4  # the updates were not all zero


def _optax_schedule(lr, total):
    if not total:
        return lr
    warmup = max(1, total // 20)
    return optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1),
                                              end_value=lr * 0.01)


class TestDistillation:
    def test_prepare_student_inputs_bitwise(self, phantoms):
        px, _ = phantoms
        want = np.asarray(jm.prepare_student_inputs(jnp.asarray(px), JCFG))
        got = pm.prepare_student_inputs(torch.from_numpy(px), CFG).numpy()
        assert np.array_equal(got, want)
        assert got.min() >= CFG.clip_low and got.max() <= CFG.clip_high

    def test_distill_batch_bitwise(self, phantoms):
        px, dims = phantoms
        want = np.asarray(jm.distill_batch(jnp.asarray(px), jnp.asarray(dims), JCFG))
        got = pm.distill_batch(px, dims, CFG, device="cpu").numpy()
        assert got.dtype == np.uint8 and np.array_equal(got, want) and want.sum() > 0

    def test_distill_volume_bitwise(self, phantoms):
        px, dims = phantoms
        vol, dm = px[:4], dims[0]
        want = np.asarray(jm.distill_volume(jnp.asarray(vol), jnp.asarray(dm), JCFG))
        got = pm.distill_volume(vol, dm, CFG, device="cpu").numpy()
        assert np.array_equal(got, want) and want.sum() > 0

    def test_fit_matches_jax(self, nets, phantoms):
        px, dims = phantoms
        jp, _ = nets[2]
        x = pm.prepare_student_inputs(torch.from_numpy(px), CFG)
        labels = pm.distill_batch(px, dims, CFG, device="cpu")
        model = unet_params_from_jax(jp, device="cpu")
        _, got = pm.fit(model, x, labels, torch.from_numpy(dims), steps=5, lr=3e-3)
        _, want = jm.fit(jp, jnp.asarray(x.numpy()), jnp.asarray(labels.numpy()),
                         jnp.asarray(dims), steps=5, lr=3e-3)
        assert len(got) == 5 and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-3)
        assert got[0] == pytest.approx(want[0], rel=1e-6)  # same weights, same loss


class TestCheckpoint:
    def test_round_trip(self, nets, tmp_path):
        for ndim in (2, 3):
            jp, model = nets[ndim]
            meta = {"base_channels": 8, "model_3d": ndim == 3}
            pm.save_params(tmp_path / f"ck{ndim}", model, meta=meta)
            back, got_meta = pm.load_params(tmp_path / f"ck{ndim}", device="cpu")
            assert type(back) is type(model) and got_meta == meta
            assert all(torch.equal(a, b) for a, b in zip(back.state_dict().values(),
                                                         model.state_dict().values()))
            # written back without meta: no stale sidecar
            pm.save_params(tmp_path / f"ck{ndim}", back)
            assert pm.load_params(tmp_path / f"ck{ndim}", device="cpu")[1] is None
        assert sorted(p.name for p in (tmp_path / "ck2").iterdir()) == ["params.npz"]

    def test_missing_checkpoint_raises(self, tmp_path):
        with pytest.raises(FileNotFoundError, match="no checkpoint at"):
            pm.load_params(tmp_path / "nope", device="cpu")

    def test_weights_to_jax_give_the_ports_logits(self, tmp_path, phantoms):
        """A checkpoint's weights, carried to the JAX package's tree, give
        its logits: a fresh student's, and one trained data x tensor
        parallel (fit_sharded over a (2, 2) mesh), whose checkpoint has the
        one-device layout."""
        from nm03_capstone_project_tpu_torch.parallel import make_mesh

        model = pm.init_unet(torch.Generator().manual_seed(3), base=8, device="cpu")
        px, dims = phantoms
        xs = pm.prepare_student_inputs(torch.from_numpy(px), CFG)
        labels = pm.distill_batch(px, dims, CFG, device="cpu")
        mesh = make_mesh(4, ("data", "model"), (2, 2), devices=[torch.device("cpu")] * 4)
        sharded, _ = pm.fit_sharded(pm.init_unet(torch.Generator().manual_seed(3), base=8,
                                                 device="cpu"),
                                    xs, labels, torch.from_numpy(dims), mesh, steps=3, lr=3e-3)
        moved = max(float((a - b).abs().max()) for a, b in
                    zip(sharded.state_dict().values(), model.state_dict().values()))
        assert moved > 1e-4  # it did train
        x = _inputs(2, seed=4)
        for name, net in (("ck", model), ("sharded", sharded)):
            pm.save_params(tmp_path / name, net, meta={"model_3d": False})
            back, _ = pm.load_params(tmp_path / name, device="cpu")
            got = back(torch.from_numpy(x), torch.float32).detach().numpy()
            want = np.asarray(jm.apply_unet(unet_params_to_jax(back), jnp.asarray(x),
                                            jnp.float32))
            assert np.abs(got - want).max() <= FWD_RTOL * np.abs(want).max(), name
