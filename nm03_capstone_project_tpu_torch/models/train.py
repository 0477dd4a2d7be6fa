"""Distillation training for the segmentation students.

The port of the JAX package's ``models/train.py``. The teacher is the
classical pipeline (:func:`..pipeline.process_batch` for the 2D student,
:func:`..pipeline.process_volume` for the 3D one), so any cohort labels
itself: on the card the labels come from the fused and grow kernels. The
student is :mod:`.unet` or :mod:`.unet3d`; a step is forward, loss
(BCE-with-logits + soft Dice, both weighted by the slice's true extent),
backward and a clipped AdamW update.

The optimiser is optax's ``chain(clip_by_global_norm(1.0), adamw(...))``
written out as a ``torch.optim.Optimizer``: optax's clipping rule, its
warmup-cosine schedule (whose first step has a learning rate of 0), and
its AdamW arithmetic in its order. ``torch.nn.utils.clip_grad_norm_`` and
``torch.optim.AdamW`` compute close but different things.

Beyond one device, as the JAX package trains:

* :func:`fit_sharded` — data x tensor parallel over an in-process
  ``('data', 'model')`` mesh (:func:`make_sharded_train_step`). Each
  ``model`` shard holds the out-channel slice of every split weight and
  bias (:func:`.unet.param_shardings`) and computes its slice of each conv
  from the whole input; the slices ``cat`` on the channel dim. Each
  ``data`` row runs its part of the batch through its own shards. A mesh
  may name one device several times, which no library's sharded tensor
  allows, so the split is written here;
* :func:`fit_distributed` — data parallel across the ranks of a
  ``torch.distributed`` job, one device a rank, the gradients summed by
  one ``all_reduce`` a step.

Both compute the loss of the whole batch, not a mean of shard losses: the
BCE term is normalised by the valid pixels of the whole batch, which
differ from shard to shard. And both clip by the norm of the whole
gradient.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.core.image import valid_mask
from nm03_capstone_project_tpu_torch.models.unet import (
    Conv,
    UNet,
    conv_precision,
    param_shardings,
)


# optax's clip_by_global_norm(1.0) and adamw's defaults, as the JAX package
# fixes them
_MAX_NORM = 1.0
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def lr_schedule(lr: float, total_steps: Optional[int]) -> Callable[[int], float]:
    """The learning rate of step ``i`` (from 0), as the JAX package sets it.

    With ``total_steps``: optax's ``warmup_cosine_decay_schedule(0.0, lr,
    warmup, max(total_steps, warmup + 1), end_value=lr * 0.01)`` with
    ``warmup = max(1, total_steps // 20)``, so step 0 has a rate of 0.
    Without: the constant ``lr``. optax evaluates it in float32, op by op,
    and so does this copy (the cosine correctly rounded): near the end of
    the decay ``1 + cos`` cancels, and float64 would differ by ~1e-6.
    """
    if not total_steps:
        return lambda step: lr
    f32 = np.float32
    warmup = max(1, total_steps // 20)
    decay = max(total_steps, warmup + 1) - warmup
    alpha = 0.0 if lr == 0.0 else (lr * 0.01) / lr

    def schedule(step: int) -> float:
        if step < warmup:  # linear from 0 to lr
            frac = f32(1) - f32(min(max(step, 0), warmup)) / f32(warmup)
            return float(f32(0.0 - lr) * frac + f32(lr))
        count = f32(min(step - warmup, decay))
        cosine = f32(0.5) * (f32(1) + f32(math.cos(f32(math.pi) * count / f32(decay))))
        return float(f32(lr) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


class ClippedAdamW(torch.optim.Optimizer):
    """optax ``chain(clip_by_global_norm(1.0), adamw(schedule,
    weight_decay=weight_decay))`` over one parameter group.

    * clipping: ``g`` when ``||g|| < 1``, else ``g / ||g||`` (no epsilon in
      the denominator);
    * Adam: b1 0.9, b2 0.999, eps 1e-8 added outside the square root, none
      inside, bias correction by the step count;
    * weight decay on every parameter, biases included, added to the Adam
      direction and scaled by the step's learning rate.

    Everything stays on the device: a step never waits for the card.
    """

    def __init__(
        self, params, lr: float = 1e-3, weight_decay: float = 1e-4,
        total_steps: Optional[int] = None,
    ):
        super().__init__(params, dict(lr=lr))
        if len(self.param_groups) != 1:
            raise ValueError("ClippedAdamW takes one parameter group")
        self.schedule = lr_schedule(lr, total_steps)
        self.weight_decay = weight_decay
        self.count = 0  # steps taken: the host knows it, the card never syncs

    @torch.no_grad()
    def step(self, closure=None):
        params = self.param_groups[0]["params"]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        # the norm of the whole gradient, also where its pieces lie on
        # several devices (the shards of a tensor-parallel student)
        home = grads[0].device
        norm = torch.linalg.vector_norm(
            torch.stack([n.to(home) for n in torch._foreach_norm(grads)]))
        keep = norm < _MAX_NORM
        # under the limit both factors are 1 and the gradient passes exactly
        one = torch.ones_like(norm)
        denom = torch.where(keep, one, norm)
        scale = torch.where(keep, one, torch.full_like(norm, _MAX_NORM))
        grads = [g / denom.to(g.device) * scale.to(g.device) for g in grads]

        for p in params:
            if not self.state[p]:
                self.state[p] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
        b1, b2 = _B1, _B2
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, sq)

        lr = self.schedule(self.count)
        self.count += 1
        mu_hat = torch._foreach_div(mu, 1 - b1**self.count)
        den = torch._foreach_sqrt(torch._foreach_div(nu, 1 - b2**self.count))
        torch._foreach_add_(den, _EPS)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_add_(upd, torch._foreach_mul(params, self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(params, upd)


def make_optimizer(
    params, lr: float = 1e-3, weight_decay: float = 1e-4, total_steps: Optional[int] = None
) -> ClippedAdamW:
    """Clipped AdamW over ``params``; with ``total_steps`` the rate follows
    the warmup-cosine schedule (:func:`lr_schedule`)."""
    return ClippedAdamW(params, lr, weight_decay, total_steps)


def segmentation_loss(
    logits: torch.Tensor, labels: torch.Tensor, dims: torch.Tensor
) -> torch.Tensor:
    """BCE + soft Dice over each slice's true extent.

    ``labels`` is the teacher's uint8 mask and ``dims`` the (B, 2) true
    extents; both terms are weighted by the validity mask so the canvas
    padding teaches nothing. (B, H, W) slice logits and (B, D, H, W) volume
    logits both work: a volume's planes share its in-plane extent, and the
    weight is spread over depth before it is summed, so the BCE normaliser
    counts every valid voxel.
    """
    bce, w_sum, dice = _loss_terms(logits, labels, dims)
    return bce / torch.clamp(w_sum, min=1.0) + dice.mean()


def _loss_terms(logits, labels, dims):
    """:func:`segmentation_loss`'s sums over a part of the batch: (the BCE
    summed over its valid pixels, their count, each row's Dice loss), from
    which the loss of any union of parts follows."""
    w = valid_mask(dims, tuple(logits.shape[-2:])).float()
    if logits.dim() == w.dim() + 1:
        w = w[..., None, :, :].expand(logits.shape)
    y = labels.float()
    # optax.sigmoid_binary_cross_entropy
    bce = -y * F.logsigmoid(logits) - (1.0 - y) * F.logsigmoid(-logits)
    p = torch.sigmoid(logits) * w
    inter = (p * y).sum(dim=(-2, -1))
    denom = p.sum(dim=(-2, -1)) + (y * w).sum(dim=(-2, -1))
    dice = 1.0 - (2.0 * inter + 1.0) / (denom + 1.0)
    return (bce * w).sum(), w.sum(), dice


def train_step(
    model: UNet, opt: ClippedAdamW, pixels: torch.Tensor, labels: torch.Tensor,
    dims: torch.Tensor, compute_dtype=torch.float32,
) -> torch.Tensor:
    """One step on the whole batch; updates ``model`` in place and returns
    the loss, still on the device. The module's class selects 2D or 3D."""
    opt.zero_grad(set_to_none=True)
    # the backward convolutions, too, run without TF32 in float32
    with conv_precision(compute_dtype, pixels.device):
        loss = segmentation_loss(model(pixels, compute_dtype), labels, dims)
        loss.backward()
    opt.step()
    return loss.detach()


def prepare_student_inputs(
    pixels: torch.Tensor, cfg: Optional[PipelineConfig] = None
) -> torch.Tensor:
    """Normalize + clip raw intensities for the student (~[0.68, 2.5]).

    The pipeline's two cheap front stages; at deployment the student
    replaces everything after them (median, sharpening, the growing
    fixpoint and the morphology).
    """
    from nm03_capstone_project_tpu_torch.ops.elementwise import clip_intensity, normalize

    cfg = cfg or PipelineConfig()
    x = normalize(
        pixels, cfg.norm_low, cfg.norm_high, cfg.norm_intensity_min, cfg.norm_intensity_max
    )
    return clip_intensity(x, cfg.clip_low, cfg.clip_high)


def distill_batch(pixels, dims, cfg: Optional[PipelineConfig] = None, device=None) -> torch.Tensor:
    """Teacher labels: the classical pipeline's uint8 masks (the fused and
    grow kernels on the card; ``device`` as :func:`..pipeline.process_batch`
    takes it)."""
    from nm03_capstone_project_tpu_torch.pipeline import process_batch

    return process_batch(pixels, dims, cfg or PipelineConfig(), device=device)["mask"]


def fit(
    model: UNet, pixels: torch.Tensor, labels: torch.Tensor, dims: torch.Tensor,
    steps: int = 50, lr: float = 1e-3, compute_dtype=torch.float32,
) -> Tuple[UNet, List[float]]:
    """The single-device training loop: ``steps`` full-batch steps.

    Returns (model, losses). Each loss stays on the device until the loop
    ends, so the host never waits for the card between steps.
    """
    opt = make_optimizer(model.parameters(), lr, total_steps=steps)
    losses = [train_step(model, opt, pixels, labels, dims, compute_dtype) for _ in range(steps)]
    return model, torch.stack(losses).tolist() if losses else []


def pad_local_shard(pixels, labels, dims, target: int):
    """Wrap-pad a batch to exactly ``target`` rows by repeating its own
    slices in order (numpy arrays or tensors; the same kind comes back).

    Every rank of a job pads its shard to one agreed size, so the shards
    make an evenly split global batch, and :func:`fit_sharded` pads a batch
    to a multiple of the ``data`` axis. Repeated real slices only reweight
    the loss; degenerate filler would add spurious Dice terms.
    """
    b = pixels.shape[0]
    if target < b:
        raise ValueError(f"target {target} < local batch {b}")
    if target == b:
        return pixels, labels, dims
    idx = np.arange(target) % b
    if isinstance(pixels, torch.Tensor):
        idx = torch.as_tensor(idx, device=pixels.device)
    return pixels[idx], labels[idx], dims[idx]


class _ShardedConv(torch.nn.Module):
    """One conv of a ``data`` row of a tensor-parallel student.

    ``weights``/``biases`` are the conv's master pieces: one a ``model``
    shard when the conv splits, else one whole. Each piece is copied to
    its shard's device of this row (autograd carries the gradient back to
    the master, summing over rows), computes its out-channel slice from
    the whole input, and the slices concatenate on the input's device.
    """

    def __init__(self, conv: Conv, weights, biases, devices):
        super().__init__()
        # plain lists: the masters belong to the ShardedStudent, not here
        self.pieces = list(zip(weights, biases, devices))
        self.padding = conv.padding
        self._conv = conv._conv
        self._nd = weights[0].dim() - 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        home, outs = x.device, []
        for w, b, dev in self.pieces:
            xm = x.to(dev)
            out = self._conv(xm, w.to(dev).to(x.dtype), None, padding=self.padding)
            out = out + b.to(dev).to(x.dtype).view((1, -1) + (1,) * self._nd)
            outs.append(out.to(home))
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


class ShardedStudent:
    """A 2D student laid out over a ``('data', 'model')`` mesh.

    The master of each parameter lives on the mesh's ``data`` row 0: the
    pieces of a split leaf (:func:`.unet.param_shardings`) one a ``model``
    shard, on that shard's device, and a replicated leaf whole on the
    row's first device. :meth:`parameters` is what the optimiser updates.
    Each ``data`` row gets a forward skeleton of the model (built on the
    meta device, so it holds no weights) whose convs run on the row's
    shards.
    """

    def __init__(self, model: UNet, mesh):
        if model.ndim != 2:
            raise ValueError("data x tensor parallel training takes the 2D student")
        names = mesh.axis_names
        if set(names) != {"data", "model"}:
            raise ValueError(f"a ('data', 'model') mesh is needed, got axes {names}")
        grid = mesh.devices if names[0] == "data" else mesh.devices.T
        self.rows = [list(r) for r in grid]
        self.tp = len(self.rows[0])
        self.spec = param_shardings(model, mesh)
        self._skeleton_args = (model.base, model.levels, model.in_ch)
        self.masters: Dict[str, List[torch.Tensor]] = {}
        with torch.no_grad():
            for name, p in model.named_parameters():
                if self.spec[name] is None:
                    pieces = [p.detach().to(self.rows[0][0]).clone()]
                else:
                    pieces = [c.to(dev).clone() for c, dev in
                              zip(p.detach().chunk(self.tp, dim=0), self.rows[0])]
                self.masters[name] = [t.requires_grad_(True) for t in pieces]
        self.replicas = [self._row_skeleton(row) for row in self.rows]

    def _row_skeleton(self, row) -> UNet:
        with torch.device("meta"):
            net = UNet(*self._skeleton_args)
        convs = [(n, m) for n, m in net.named_modules() if isinstance(m, Conv)]
        for name, conv in convs:
            ws, bs = self.masters[f"{name}.weight"], self.masters[f"{name}.bias"]
            devs = row[:len(ws)]
            parent, _, attr = name.rpartition(".")
            setattr(net.get_submodule(parent) if parent else net, attr,
                    _ShardedConv(conv, ws, bs, devs))
        return net

    def parameters(self) -> List[torch.Tensor]:
        return [t for pieces in self.masters.values() for t in pieces]

    def loss(self, pixels, labels, dims, compute_dtype=torch.float32) -> torch.Tensor:
        """The loss of the whole batch; ``pixels``, ``labels`` and ``dims``
        are lists of one part a ``data`` row, each on its row's first
        device. The result lies on row 0's first device."""
        home = self.rows[0][0]
        bce, w_sum, dice = [], [], []
        for net, px, lb, dm in zip(self.replicas, pixels, labels, dims):
            b, w, d = _loss_terms(net(px, compute_dtype), lb, dm)
            bce.append(b.to(home))
            w_sum.append(w.to(home))
            dice.append(d.to(home))
        return (torch.stack(bce).sum() / torch.clamp(torch.stack(w_sum).sum(), min=1.0)
                + torch.cat(dice).mean())

    def gather(self, device=None) -> UNet:
        """The whole model, its split leaves concatenated back, on
        ``device`` (row 0's first device by default)."""
        device = torch.device(device) if device is not None else self.rows[0][0]
        model = UNet(*self._skeleton_args)
        with torch.no_grad():
            state = {n: torch.cat([t.detach().to(device) for t in pieces])
                     for n, pieces in self.masters.items()}
            model.load_state_dict(state)
        return model.to(device)


def make_sharded_train_step(mesh, model: UNet, lr: float = 1e-3,
                            total_steps: Optional[int] = None,
                            compute_dtype=torch.float32):
    """The train step over a ``('data', 'model')`` mesh.

    Returns ``(step, student)``: ``step(pixels, labels, dims)`` splits the
    batch over the ``data`` rows (the axis size must divide it), takes one
    clipped AdamW step on the sharded parameters and returns the loss,
    still on the device; ``student`` is the :class:`ShardedStudent`, whose
    :meth:`~ShardedStudent.gather` gives back the whole model. ``model``
    itself is not changed.
    """
    from nm03_capstone_project_tpu_torch.parallel.mesh import batch_shards

    student = ShardedStudent(model, mesh)
    opt = make_optimizer(student.parameters(), lr, total_steps=total_steps)
    home = student.rows[0][0]

    def step(pixels, labels, dims) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        with conv_precision(compute_dtype, home):
            # one part a data row, on the row's first device
            loss = student.loss(batch_shards(pixels, mesh, "data", torch.float32),
                                batch_shards(labels, mesh, "data"),
                                batch_shards(dims, mesh, "data"), compute_dtype)
            loss.backward()
        opt.step()
        return loss.detach()

    return step, student


def fit_sharded(
    model: UNet, pixels, labels, dims, mesh, steps: int = 50, lr: float = 1e-3,
    compute_dtype=torch.float32,
) -> Tuple[UNet, List[float]]:
    """:func:`fit` over a ``('data', 'model')`` mesh (the 2D student).

    A batch that the ``data`` axis does not divide is wrap-padded
    (:func:`pad_local_shard`). Returns the whole model, on the mesh's first
    device in the one-device layout (so ``save_params`` and
    ``convert.unet_params_to_jax`` see an ordinary student), and the
    per-step losses, read from the card once after the loop.
    """
    dp = mesh.shape["data"]
    b = pixels.shape[0]
    if b % dp:
        pixels, labels, dims = pad_local_shard(pixels, labels, dims, -(-b // dp) * dp)
    step, student = make_sharded_train_step(mesh, model, lr, steps, compute_dtype)
    losses = [step(pixels, labels, dims) for _ in range(steps)]
    return student.gather(), torch.stack(losses).tolist() if losses else []


def fit_distributed(
    model: UNet, local_pixels, local_labels, local_dims, steps: int = 50,
    lr: float = 1e-3, compute_dtype=torch.float32,
) -> Tuple[UNet, List[float]]:
    """Data-parallel training across the ranks of a ``torch.distributed``
    job (the 2D student), one device a rank.

    Every rank calls it together with its own shard of the batch, already
    labelled, padded to one size agreed by every rank
    (:func:`pad_local_shard`), and the same initial ``model``. Each step
    computes this rank's part of the whole batch's loss, takes its
    gradient and sums the parts over the ranks in one ``all_reduce`` (the
    loss rides in the same buffer), so every rank takes the same step.
    Returns ``(model, losses)``: the trained model, updated in place and
    equal on every rank, and the whole batch's per-step losses.
    """
    from nm03_capstone_project_tpu_torch.parallel import distributed

    device = next(model.parameters()).device
    px = torch.as_tensor(local_pixels).to(device, torch.float32)
    lb = torch.as_tensor(local_labels).to(device)
    dm = torch.as_tensor(local_dims).to(device, torch.int32)
    world = distributed.process_count()
    # the whole batch's normalisers: the valid pixels (they depend on the
    # dims alone) and the rows
    w_all = distributed.all_reduce_sum(valid_mask(dm, tuple(px.shape[-2:])).float().sum())
    w_all = torch.clamp(w_all, min=1.0)
    rows_all = px.shape[0] * world
    params = list(model.parameters())
    opt = make_optimizer(params, lr, total_steps=steps)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        with conv_precision(compute_dtype, device):
            bce, _, dice = _loss_terms(model(px, compute_dtype), lb, dm)
            part = bce / w_all + dice.sum() / rows_all
            part.backward()
        flat = torch.cat([p.grad.reshape(-1) for p in params] + [part.detach().reshape(1)])
        distributed.all_reduce_sum(flat)
        off = 0
        for p in params:
            p.grad.copy_(flat[off:off + p.numel()].view_as(p))
            off += p.numel()
        losses.append(flat[-1])
        opt.step()
    return model, torch.stack(losses).tolist() if losses else []
