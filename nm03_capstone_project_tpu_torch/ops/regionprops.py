"""Connected components + region properties, plain PyTorch.

The port of the JAX package's ``ops/regionprops.py``: FAST
``RegionProperties`` and ``BoundingBox``, declared in the reference's API
surface (FAST_directives.hpp:2, :24) but never instantiated.

Connected-component labeling is the JAX package's fixpoint of min-label
propagation: every foreground pixel starts with its 1-based linear index
as label, each step takes the minimum over its (4- or 8-connected)
neighbourhood, and the fixpoint gives every component the smallest linear
index it contains. The schedule is the JAX one (one unconditional block of
``block_iters`` steps, then blocks while any label changed and fewer than
``max_iters`` steps ran), so a capped, truncated run gives the JAX labels
too. The loop reads one "anything changed" flag a block back to the host.

``region_properties`` ranks components by area, ties in ``lax.top_k``'s
order (the lower label first: a stable descending sort), and returns the
top ``max_regions`` with static shapes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nm03_capstone_project_tpu_torch.ops.neighborhood import (
    constant_shifted_views,
    footprint_offsets,
)

_BIG = torch.iinfo(torch.int32).max


def _neighbor_min(lab: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Min label over the 3x3 cross (4-conn) or full 3x3 (8-conn) window;
    the out-of-canvas border is int32 max, so it never wins."""
    offs = footprint_offsets(3, "cross" if connectivity == 4 else "box")
    out = None
    for view in constant_shifted_views(lab, offs, _BIG):
        out = view if out is None else torch.minimum(out, view)
    return out


def _minmax_box(m: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(y0, x0, y1, x1) of True pixels as float32, by masked min/max over
    the trailing two axes; +-inf where ``m`` is all False (callers mask
    that case out)."""
    inf = torch.tensor(float("inf"))
    return torch.stack(
        [
            torch.where(m, ys, inf).amin(dim=(-2, -1)),
            torch.where(m, xs, inf).amin(dim=(-2, -1)),
            torch.where(m, ys, -inf).amax(dim=(-2, -1)),
            torch.where(m, xs, -inf).amax(dim=(-2, -1)),
        ],
        dim=-1,
    )


def _grids(h: int, w: int, device) -> tuple:
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    return ys, xs


def bounding_box(mask: torch.Tensor) -> torch.Tensor:
    """(y0, x0, y1, x1) inclusive bounds of ALL foreground pixels, int32;
    -1s where the mask is empty. Leading axes are batch axes."""
    m = mask.bool()
    ys, xs = _grids(m.shape[-2], m.shape[-1], m.device)
    any_fg = m.any(dim=-1).any(dim=-1)
    box = _minmax_box(m, ys.expand_as(m), xs.expand_as(m))
    return torch.where(any_fg[..., None], box, torch.tensor(-1.0)).to(torch.int32)


def connected_components(
    mask: torch.Tensor,
    connectivity: int = 4,
    block_iters: int = 16,
    max_iters: Optional[int] = None,
) -> torch.Tensor:
    """Label connected components of a boolean mask (..., H, W).

    Returns int32 labels shaped like ``mask``: 0 for background and, for
    each component, the 1-based smallest linear index it contains (unique
    per component, not consecutive). ``max_iters`` defaults to h*w, a bound
    on any propagation path, so the fixpoint converges unless capped lower;
    the cap is checked at block granularity (``it < max_iters``).
    """
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    m = mask.bool()
    h, w = m.shape[-2], m.shape[-1]
    if max_iters is None:
        max_iters = h * w
    big = torch.tensor(_BIG, dtype=torch.int32, device=m.device)
    idx = (torch.arange(h * w, dtype=torch.int32, device=m.device) + 1).reshape(h, w)
    lab = torch.where(m, idx, big)

    def block(lab):
        for _ in range(block_iters):
            lab = torch.where(m, _neighbor_min(lab, connectivity), big)
        return lab

    prev, lab, it = lab, block(lab), 0
    while it < max_iters and bool((lab != prev).any()):
        prev, lab = lab, block(lab)
        it += block_iters
    return torch.where(m, lab, torch.zeros((), dtype=torch.int32, device=m.device))


def region_properties(
    mask: torch.Tensor, connectivity: int = 4, max_regions: int = 8
) -> Dict[str, torch.Tensor]:
    """Area / centroid / bbox of the ``max_regions`` largest components.

    One (H, W) mask. Every output leads with ``max_regions``; slots past
    the actual components have area 0 and -1 elsewhere:
      area      — pixel count, int32, descending
      centroid  — (y, x) float32 mean position
      bbox      — (y0, x0, y1, x1) int32 inclusive bounds
      label     — the component's label in :func:`connected_components`
    """
    if mask.dim() != 2:
        raise ValueError(
            f"region_properties expects a single (H, W) mask, got {tuple(mask.shape)}; "
            "call it once per mask"
        )
    labels = connected_components(mask, connectivity)
    h, w = labels.shape
    dev = labels.device
    counts = torch.bincount(labels.reshape(-1).long(), minlength=h * w + 1).to(torch.int32)
    counts[0] = 0  # background does not rank
    k = min(max_regions, h * w + 1)
    # lax.top_k's order: descending, the lower index first on a tie
    order = torch.sort(counts, descending=True, stable=True).indices[:k]
    area = counts[order]
    top_labels = order.to(torch.int32)
    if k < max_regions:
        area = torch.cat([area, area.new_zeros(max_regions - k)])
        top_labels = torch.cat([top_labels, top_labels.new_zeros(max_regions - k)])
    valid = area > 0
    top_labels = torch.where(valid, top_labels, torch.tensor(-1, dtype=torch.int32))

    ys, xs = _grids(h, w, dev)
    m = labels[None] == top_labels[:, None, None]  # (R, H, W)
    af = area.clamp(min=1).to(torch.float32)
    cy = torch.where(m, ys, 0.0).sum(dim=(-2, -1)) / af
    cx = torch.where(m, xs, 0.0).sum(dim=(-2, -1)) / af
    centroid = torch.where(valid[:, None], torch.stack([cy, cx], dim=-1), -1.0)
    bbox = _minmax_box(m, ys.expand(h, w), xs.expand(h, w)).to(torch.int32)
    bbox = torch.where(valid[:, None], bbox, torch.tensor(-1, dtype=torch.int32))
    return {"area": area, "centroid": centroid, "bbox": bbox, "label": top_labels}
