"""Z-sharded volumes: the 3D pipeline split along z with halo exchange.

The port of the JAX package's ``parallel/zshard.py``. A long (D, H, W)
series splits along z over the mesh's ``z`` axis; each shard preprocesses
its own planes, and the 3D stencils exchange boundary planes with their
z-neighbours, so the result is :func:`..pipeline.process_volume`'s bit for
bit:

* 2D preprocessing — the port's batched ``_preprocess`` on the shard's
  planes, no communication (one fused-kernel launch a shard on a card, or
  the median kernel under ``fuse_preprocess=False``);
* 3D seeded region growing — each step dilates the local block padded with
  one plane from each neighbour (:func:`_halo_pad`; ring ends receive
  zeros, the constant background of the unsharded ``dilate3d``). A block
  of ``grow_block_iters`` steps ends in one global popcount, the
  convergence check of the JAX ``while_loop``, so every shard runs the
  same number of blocks;
* the final dilation — one more exchange, ``morph_size // 2`` planes deep.

The 3D growth and dilation here are torch ops, as they are XLA ops in the
JAX package: the sharded growth runs its own loop with the halo exchange
between steps, so neither the unsharded volume path's 3D grow kernel
(:mod:`..ops.hopper_volume`, which knows no halo) nor the 2D grow kernel
runs here. ``grow_algorithm="jump"`` has no sharded form: these paths
always grow by dilation.

Two transports sit behind the one :func:`_halo_pad` and the one count:

* **in process** (:class:`_InProcessRing`) — the shards are tensors, one
  on each mesh device; a halo plane goes to its neighbour with ``.to()``
  and the global count is the sum over the shards;
* **process group** (:class:`_ProcessGroupRing`, a mesh from
  :func:`.distributed.global_mesh`) — one shard a rank; halos move with
  ``torch.distributed.batch_isend_irecv`` (sends and receives posted
  together, so a ring of 2 cannot deadlock; the ring ends receive zeros,
  ``ppermute``'s semantics) and the counts with ``all_reduce``, on the
  card under NCCL and on the host under gloo.

Each padded block is built new by ``torch.cat`` (JAX's ``concatenate``):
on a mesh that names one device several times, ``.to()`` of a halo
returns a view of its neighbour's shard, and nothing here writes a shard
in place, so no view is ever corrupted.

:func:`zshard_volume_callable` is the one program the volume driver
(through :func:`process_volume_zsharded`) and the serving volume gang both
run, so a served mask equals the driver's by construction.
:func:`process_volume_batch_zsharded` runs a cohort over a ('data', 'z')
mesh on either transport; over a process group each ``data`` row is a
ring of ranks, and the rows agree once a check on whether any still grows.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from nm03_capstone_project_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig
from nm03_capstone_project_tpu_torch.core.image import valid_mask
from nm03_capstone_project_tpu_torch.ops.elementwise import cast_uint8
from nm03_capstone_project_tpu_torch.ops.region_growing import grow_band
from nm03_capstone_project_tpu_torch.ops.seeds import seed_mask
from nm03_capstone_project_tpu_torch.ops.volume import dilate3d
from nm03_capstone_project_tpu_torch.parallel.mesh import (
    Mesh,
    gather_shards,
    make_mesh,
    on_device,
    to_device,
)
from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import _preprocess

AXIS = "z"
Z = -3  # the z axis of a (D, H, W) block and of a (b, D, H, W) batch of them


class _InProcessRing:
    """One z ring whose shards all live in this process, one a device."""

    def __init__(self, devices: Sequence[torch.device]):
        self.devices = [torch.device(d) for d in devices]
        # a ring of one has no neighbour to exchange with
        self.alone = len(self.devices) == 1

    def halo_pad(self, blocks: List[torch.Tensor], halo: int) -> List[torch.Tensor]:
        n = len(blocks)
        out = []
        for i, (blk, dev) in enumerate(zip(blocks, self.devices)):
            d = blk.shape[Z]
            edge = blk.narrow(Z, 0, halo)
            below = (blocks[i - 1].narrow(Z, blocks[i - 1].shape[Z] - halo, halo).to(dev)
                     if i > 0 else torch.zeros_like(edge))
            above = (blocks[i + 1].narrow(Z, 0, halo).to(dev)
                     if i < n - 1 else torch.zeros_like(blk.narrow(Z, d - halo, halo)))
            out.append(torch.cat([below, blk, above], dim=Z))
        return out

    def z_sum(self, values: List[torch.Tensor]) -> torch.Tensor:
        dev0 = self.devices[0]
        total = values[0].to(dev0)
        for v in values[1:]:
            total = total + v.to(dev0)
        return total

    def any_growing(self, growing: bool, device) -> bool:
        return growing

    def gather(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        return gather_shards(blocks, self.devices[0], dim=Z)


class _ProcessGroupRing:
    """The z ring of a process group that holds this rank's shard.

    ``peers`` are the ranks of the ring in z order (every rank of the job
    on a ``('z',)`` mesh; this rank's ``data`` row on a ``('data', 'z')``
    one), and ``row``/``n_rows`` place the ring among the job's rows. A
    ring's count is summed over the whole job in one ``all_reduce`` with a
    slot a row, so no subgroup has to be formed.
    """

    def __init__(self, peers: Optional[Sequence[int]] = None, row: int = 0, n_rows: int = 1):
        import torch.distributed as dist

        from nm03_capstone_project_tpu_torch.parallel.distributed import data_group

        self.dist = dist
        # a served gang's data plane (its collectives bounded by the server's
        # volume timeout), else the job's group; it holds every rank, so
        # group ranks are the job's
        self.group = data_group()
        self.world = dist.get_world_size()
        self.peers = list(range(self.world)) if peers is None else list(peers)
        self.pos = self.peers.index(dist.get_rank())
        self.row, self.n_rows = row, n_rows
        self.alone = False  # the exchange always runs, so every rank pairs off

    def halo_pad(self, blocks: List[torch.Tensor], halo: int) -> List[torch.Tensor]:
        dist, i, peers = self.dist, self.pos, self.peers
        (blk,) = blocks
        d = blk.shape[Z]
        # bool goes as uint8: neither backend need carry bool
        wire = blk.to(torch.uint8) if blk.dtype == torch.bool else blk
        send_down = wire.narrow(Z, 0, halo).contiguous()  # to the shard below
        send_up = wire.narrow(Z, d - halo, halo).contiguous()  # to the shard above
        from_prev = torch.zeros_like(send_down)
        from_next = torch.zeros_like(send_up)
        ops = []
        if i > 0:
            ops += [dist.P2POp(dist.isend, send_down, peers[i - 1], self.group),
                    dist.P2POp(dist.irecv, from_prev, peers[i - 1], self.group)]
        if i < len(peers) - 1:
            ops += [dist.P2POp(dist.isend, send_up, peers[i + 1], self.group),
                    dist.P2POp(dist.irecv, from_next, peers[i + 1], self.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        padded = torch.cat([from_prev, wire, from_next], dim=Z)
        return [padded.bool() if blk.dtype == torch.bool else padded]

    def z_sum(self, values: List[torch.Tensor]) -> torch.Tensor:
        (v,) = values
        slots = torch.zeros((self.n_rows,) + tuple(v.shape), dtype=v.dtype, device=v.device)
        slots[self.row] = v
        self.dist.all_reduce(slots, group=self.group)
        return slots[self.row]

    def any_growing(self, growing: bool, device) -> bool:
        """Whether any row of the job still grows: every rank must run the
        same number of blocks, since each block holds collectives."""
        if self.n_rows == 1:  # one ring: every rank saw the same counts
            return growing
        flag = torch.tensor([int(growing)], dtype=torch.int32, device=device)
        self.dist.all_reduce(flag, op=self.dist.ReduceOp.MAX, group=self.group)
        return bool(flag.item())

    def gather(self, blocks: List[torch.Tensor]) -> torch.Tensor:
        """The whole job's blocks in rank order, joined along z (one ring)."""
        return torch.cat(self.gather_all(blocks), dim=Z)

    def gather_all(self, blocks: List[torch.Tensor]) -> List[torch.Tensor]:
        (blk,) = blocks
        parts = [torch.empty_like(blk) for _ in range(self.world)]
        self.dist.all_gather(parts, blk.contiguous(), group=self.group)
        return parts


def _ring(mesh: Mesh, devices: Sequence[torch.device]):
    return _ProcessGroupRing() if mesh.process_group else _InProcessRing(devices)


def _halo_pad(blocks: List[torch.Tensor], ring, halo: int = 1) -> List[torch.Tensor]:
    """Pad each local (..., d, H, W) block with ``halo`` planes from each
    z-neighbour.

    Shard i receives the last ``halo`` planes of shard i-1 below and the
    first ``halo`` planes of shard i+1 above; ring ends receive zeros
    (``ppermute``'s semantics for devices with no source), which reproduces
    the constant background padding of the unsharded 3D ops. Correct for a
    stencil of z-radius ``halo`` as long as ``halo <= d_local`` (checked at
    dispatch in :func:`process_volume_zsharded`).
    """
    return ring.halo_pad(blocks, halo)


def _dilate_halo(blocks: List[torch.Tensor], ring, size: int, shape: str = "cross"
                 ) -> List[torch.Tensor]:
    """``dilate3d`` of each block as a slab of the whole volume: over its
    z-neighbours' ``size // 2`` halo planes, cut back to the block. A ring
    of one in process has no neighbour, and ``dilate3d``'s own zero
    background is then the ring ends' halo, so it dilates the block alone
    (the serving gang's one-lane program pays no exchange)."""
    halo = size // 2
    if ring.alone or halo == 0:
        return [dilate3d(b, size, shape) for b in blocks]
    return [dilate3d(p, size, shape).narrow(Z, halo, p.shape[Z] - 2 * halo)
            for p in _halo_pad(blocks, ring, halo)]


def _region_grow_local(
    seeds: List[List[torch.Tensor]],
    band: List[List[torch.Tensor]],
    rings: list,
    block_iters: int,
    max_iters: int,
):
    """Distributed fixpoint flood fill over a grid of z-shard blocks.

    ``seeds`` and ``band`` hold one row a ``data`` index (one ring each,
    ``rings``), each row one (b, d, H, W) block a z shard. Returns
    ``(region, converged)``: the grid of bool blocks and one (b,) bool a
    row, False for a volume whose fixpoint ``max_iters`` truncated.

    The schedule is the JAX ``while_loop``'s: one unconditional block of
    ``block_iters`` steps, then blocks while a count changed and fewer
    than ``max_iters`` steps ran. Each check is one global popcount a
    volume (summed over the z ring), read back once. One loop carries every
    volume while any still grows (JAX ``_region_grow_local_batch``): extra
    blocks on a converged volume are fixpoint no-ops, and each volume's
    flag is its own popcount stability. On one volume (b = 1, one row) it
    is the JAX ``_region_grow_local``.
    """

    def grow_block(region):
        for _ in range(block_iters):
            region = [
                [g & b for g, b in zip(_dilate_halo(row, ring, 3), brow)]
                for row, brow, ring in zip(region, band, rings)
            ]
        return region

    def counts(region):
        return [ring.z_sum([blk.sum(dim=(-3, -2, -1)) for blk in row])
                for row, ring in zip(region, rings)]

    def growing(prev, cur) -> bool:
        # the loop's one read back to the host a check
        here = any(bool((c != p).any()) for p, c in zip(prev, cur))
        return rings[0].any_growing(here, cur[0].device)

    region0 = [[s & b for s, b in zip(srow, brow)] for srow, brow in zip(seeds, band)]
    region = grow_block(region0)
    prev, cur = counts(region0), counts(region)
    iters = block_iters
    while growing(prev, cur) and iters < max_iters:
        region = grow_block(region)
        prev, cur = cur, counts(region)
        iters += block_iters
    return region, [c == p for p, c in zip(prev, cur)]


def _pre_and_band(vol_local: torch.Tensor, dims: torch.Tensor, cfg: PipelineConfig):
    """Front half of one (b, d, H, W) block with (b, 2) dims: preprocess
    (the batched 2D stage on its b*d planes) and the seed, valid and band
    planes. No communication."""
    b, d = vol_local.shape[0], vol_local.shape[1]
    hw = tuple(vol_local.shape[-2:])
    plane_dims = dims[:, None].expand(b, d, 2).reshape(b * d, 2)
    pre = _preprocess(vol_local.reshape(b * d, *hw), plane_dims, cfg).reshape(b, d, *hw)
    seeds = seed_mask(dims, hw)[:, None].expand(b, d, *hw)
    valid = valid_mask(dims, hw)[:, None].expand(b, d, *hw)
    band = grow_band(pre, cfg.grow_low, cfg.grow_high, valid)
    return pre, seeds, valid, band


def _post_mask(region: List[torch.Tensor], valid: List[torch.Tensor], cfg: PipelineConfig,
               ring) -> List[torch.Tensor]:
    """Back half of one ring: cast, the halo-exchanged final dilation, the
    valid re-mask.

    The final dilation has z-radius ``morph_size // 2``: that many halo
    planes are exchanged (one plane is wrong for ``morph_size >= 5`` at
    shard boundaries). ``morph_size`` 1 has radius 0: no exchange.
    """
    mask = _dilate_halo([cast_uint8(r) for r in region], ring, cfg.morph_size)
    return [m * v.to(m.dtype) for m, v in zip(mask, valid)]


def _run_grid(vol_grid, dims_rows, dev_grid, rings, cfg: PipelineConfig):
    """The whole program on a grid of (b, d, H, W) blocks: rows over
    ``data``, columns over ``z``. Returns (mask grid, converged rows)."""
    pre_grid, seeds, valid, band = [], [], [], []
    for vrow, dm, drow in zip(vol_grid, dims_rows, dev_grid):
        srow, vrow_valid, brow = [], [], []
        for v, dev in zip(vrow, drow):
            with on_device(dev):
                _, s, va, b = _pre_and_band(v, dm.to(dev), cfg)
            srow.append(s)
            vrow_valid.append(va)
            brow.append(b)
        seeds.append(srow)
        valid.append(vrow_valid)
        band.append(brow)
    region, converged = _region_grow_local(
        seeds, band, rings, cfg.grow_block_iters, cfg.grow_max_iters
    )
    masks = [_post_mask(rrow, vrow, cfg, ring)
             for rrow, vrow, ring in zip(region, valid, rings)]
    return masks, converged


def zshard_volume_callable(mesh: Mesh, cfg: PipelineConfig):
    """The z-sharded volume program over ``mesh``'s ``z`` axis.

    Returns ``run(shards, dims)``: ``shards`` the (d, H, W) z-slabs of one
    volume in z order, each on its mesh device (this rank's one slab on a
    process-group mesh), ``dims`` its (2,) true in-plane size. ``run``
    returns ``{'original': shards, 'mask': mask slabs, 'grow_converged':
    0-d bool}``, the slabs in the shards' places. The one definition the
    volume driver (:func:`process_volume_zsharded`) and the serving volume
    gang both run, so the served mask equals the driver's by construction.
    """
    devices = mesh.axis_devices(AXIS)
    if mesh.process_group:
        from nm03_capstone_project_tpu_torch.parallel.distributed import local_device

        devices = [local_device()]
    ring = _ring(mesh, devices)

    def run(shards: List[torch.Tensor], dims) -> Dict[str, object]:
        if len(shards) != len(devices):
            raise ValueError(f"{len(shards)} z-slabs for a ring of {len(devices)} local shards")
        dm = torch.as_tensor(dims, dtype=torch.int32).reshape(1, 2)
        masks, conv = _run_grid([[s[None] for s in shards]], [dm], [devices], [ring], cfg)
        return {"original": shards, "mask": [m[0] for m in masks[0]],
                "grow_converged": conv[0][0]}

    return run


def _check_depth(depth: int, n_shards: int, cfg: PipelineConfig, what: str = "stack") -> None:
    if depth % n_shards != 0:
        raise ValueError(
            f"depth {depth} not divisible by z-axis size {n_shards}; pad the {what} first"
        )
    d_local = depth // n_shards
    halo = cfg.morph_size // 2
    if d_local < halo:
        raise ValueError(
            f"local shard depth {d_local} < dilation z-radius {halo} "
            f"(morph_size={cfg.morph_size}): the single-neighbor halo "
            "exchange would be incomplete; use fewer z-shards or a deeper "
            "volume"
        )


def split_volume(volume, mesh: Mesh) -> List[torch.Tensor]:
    """The z-slabs of a (D, H, W) volume that ``mesh`` holds locally, each
    on its device as float32: every slab in process, this rank's one on a
    process-group mesh."""
    n = mesh.shape[AXIS]
    d = volume.shape[0] // n
    if mesh.process_group:
        from nm03_capstone_project_tpu_torch.parallel.distributed import (
            local_device,
            process_index,
        )

        r = process_index()
        return [to_device(volume[r * d:(r + 1) * d], local_device(), torch.float32)]
    return [to_device(volume[i * d:(i + 1) * d], dev, torch.float32)
            for i, dev in enumerate(mesh.axis_devices(AXIS))]


def process_volume_zsharded(
    volume,
    dims,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Run the volumetric pipeline with z sharded across the mesh.

    Args:
      volume: (D, H, W) raw canvas volume (host array or tensor); the
        mesh's ``z`` axis size must divide D.
      dims: int32 (2,) true in-plane (height, width).
      mesh: mesh with a ``z`` axis (default: every device of
        :func:`.mesh.local_devices` of ``device`` on one ``z`` axis), or a
        process-group mesh from :func:`.distributed.global_mesh`, where
        every rank passes the whole volume and computes its own slab.

    Returns {'original', 'mask', 'grow_converged'} as
    :func:`..pipeline.process_volume` does, gathered on the first ``z``
    device (on every rank, for a process-group mesh).
    """
    if mesh is None:
        mesh = make_mesh(axis_names=(AXIS,), device=device)
    _check_depth(volume.shape[0], mesh.shape[AXIS], cfg)
    shards = split_volume(volume, mesh)
    dm = torch.as_tensor(dims, dtype=torch.int32)
    out = zshard_volume_callable(mesh, cfg)(shards, dm)
    if mesh.process_group:
        from nm03_capstone_project_tpu_torch.parallel.distributed import local_device

        ring, dev0 = _ProcessGroupRing(), local_device()
        mask = ring.gather(out["mask"])
        original = to_device(volume, dev0, torch.float32)
    else:
        dev0 = mesh.axis_devices(AXIS)[0]
        mask = gather_shards(out["mask"], dev0)
        original = gather_shards(shards, dev0)
    return {"original": original, "mask": mask,
            "grow_converged": out["grow_converged"].to(dev0)}


def process_volume_batch_zsharded(
    volumes,
    dims,
    cfg: PipelineConfig = DEFAULT_CONFIG,
    mesh: Optional[Mesh] = None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Run a (B, D, H, W) cohort of volumes over a ('data', 'z') mesh.

    B volumes split over ``data`` (independent) while each volume's D
    planes split over ``z`` (halo exchange and per-volume counts). The
    ``data`` size must divide B and the ``z`` size D. One growing loop
    carries every volume while any still grows (see
    :func:`_region_grow_local`). On a process-group mesh from
    :func:`.distributed.global_mesh` every rank passes the whole cohort and
    runs its own block.

    Returns {'original', 'mask', 'grow_converged'}, gathered on the mesh's
    first device (on every rank's own, over a process group);
    ``grow_converged`` is (B,), one flag a volume.
    """
    if mesh is None:
        mesh = make_mesh(axis_names=("data", AXIS), device=device)
    if volumes.ndim != 4:
        raise ValueError(f"expected (B, D, H, W) volumes, got {tuple(volumes.shape)}")
    n_data, n_z = mesh.shape["data"], mesh.shape[AXIS]
    if volumes.shape[0] % n_data != 0:
        raise ValueError(
            f"batch {volumes.shape[0]} not divisible by data-axis size "
            f"{n_data}; pad the cohort first"
        )
    _check_depth(volumes.shape[1], n_z, cfg, what="stacks")
    k = mesh.axis_names.index("data")
    grid = mesh.devices if k == 0 else mesh.devices.T
    b, d = volumes.shape[0] // n_data, volumes.shape[1] // n_z
    dm = torch.as_tensor(dims, dtype=torch.int32)
    if mesh.process_group:
        return _batch_over_process_group(volumes, dm, cfg, mesh, k, b, d)
    dev_grid = [list(row) for row in grid]
    vol_grid = [[to_device(volumes[i * b:(i + 1) * b, j * d:(j + 1) * d], dev, torch.float32)
                 for j, dev in enumerate(row)] for i, row in enumerate(dev_grid)]
    dims_rows = [dm[i * b:(i + 1) * b] for i in range(n_data)]
    rings = [_InProcessRing(row) for row in dev_grid]
    masks, conv = _run_grid(vol_grid, dims_rows, dev_grid, rings, cfg)
    dev0 = dev_grid[0][0]
    return {
        "original": gather_shards([gather_shards(r, dev0, dim=1) for r in vol_grid], dev0),
        "mask": gather_shards([gather_shards(r, dev0, dim=1) for r in masks], dev0),
        "grow_converged": gather_shards(conv, dev0),
    }


def _batch_over_process_group(volumes, dm: torch.Tensor, cfg: PipelineConfig, mesh: Mesh,
                              data_axis: int, b: int, d: int) -> Dict[str, torch.Tensor]:
    """:func:`process_volume_batch_zsharded` on a process-group mesh: this
    rank runs the block at its place in the ('data', 'z') grid, its ring
    the ranks of its ``data`` row. Every rank reaches every halo exchange
    and every count until the last volume of any row stops growing, and
    the blocks are gathered on every rank."""
    from nm03_capstone_project_tpu_torch.parallel.distributed import (
        local_device,
        process_count,
        process_index,
    )

    world, rank = process_count(), process_index()
    ranks = np.arange(world).reshape(mesh.devices.shape)
    ranks = ranks if data_axis == 0 else ranks.T  # rows over data, columns over z
    n_data = ranks.shape[0]
    i, j = (int(v[0]) for v in np.nonzero(ranks == rank))
    dev = local_device()
    block = to_device(volumes[i * b:(i + 1) * b, j * d:(j + 1) * d], dev, torch.float32)
    ring = _ProcessGroupRing(peers=[int(r) for r in ranks[i]], row=i, n_rows=n_data)
    masks, conv = _run_grid([[block]], [dm[i * b:(i + 1) * b]], [[dev]], [ring], cfg)
    parts = ring.gather_all(masks[0])
    # bool goes as uint8: neither backend need carry bool
    conv_rows = ring.gather_all([conv[0].to(dev, torch.uint8)])
    mask = torch.cat([torch.cat([parts[int(r)] for r in ranks[row]], dim=1)
                      for row in range(n_data)])
    converged = torch.cat([conv_rows[int(ranks[row][0])] for row in range(n_data)]).bool()
    return {"original": to_device(volumes, dev, torch.float32), "mask": mask,
            "grow_converged": converged}
