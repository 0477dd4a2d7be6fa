"""Vector median filter, plain PyTorch.

Equivalent of FAST ``VectorMedianFilter::create(7)`` (reference
src/test/test_pipeline.cpp:65-66). For single-channel data the vector median
(the window sample minimizing the summed L1 distance) is the scalar median
sample, so this computes a median of k².

:func:`vector_median_filter` is the column-presorted pruned selection
network: the k vertical neighbors are sorted once per column with a Batcher
network, then the plan of :mod:`.selection_network` merges the sorted
columns and selects rank k²//2 (346 min/max per pixel at k=7). It is the
plain version the two CUDA median kernels (``ops.hopper_median``) are held
against. Any exact rank selection gives the same bits: min/max return one
of their inputs, and the pipeline's median sees clipped finite data, where
neither NaN nor a signed zero occurs.

Boundary handling is clamp-to-edge, matching the OpenCL sampler addressing
the reference inherits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from nm03_capstone_project_tpu_torch.ops.neighborhood import pad, shifted_stack
from nm03_capstone_project_tpu_torch.ops.selection_network import (
    MedianPlan,
    median_merge_plan,
    next_pow2,
    oddeven_sort_pairs,
)

_PAD = None  # +inf sentinel; folded in Python before any op runs


def _apply_pairs(vals: List[Optional[torch.Tensor]], pairs) -> None:
    """Run compare-exchanges in place, folding the +inf sentinel in Python.

    CE(a, b) -> (min, max). With b = +inf it is a no-op; with a = +inf it is
    a pure swap; only real-real pairs emit torch.minimum/torch.maximum.
    """
    for i, j in pairs:
        a, b = vals[i], vals[j]
        if b is _PAD:
            continue
        if a is _PAD:
            vals[i], vals[j] = b, _PAD
            continue
        vals[i] = torch.minimum(a, b)
        vals[j] = torch.maximum(a, b)


def _sort_network(vals: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sort a small list of tensors elementwise with a Batcher network."""
    n = len(vals)
    p = next_pow2(n)
    padded: List[Optional[torch.Tensor]] = list(vals) + [_PAD] * (p - n)
    pairs: List[Tuple[int, int]] = []
    oddeven_sort_pairs(0, p, pairs)
    _apply_pairs(padded, pairs)
    return padded[:n]  # ascending; pads sorted to the tail


def _execute_plan(
    plan: MedianPlan, padded_rows: List[torch.Tensor], w_out: int
) -> torch.Tensor:
    """Run a selection-network plan over k presorted full-width rows.

    ``padded_rows`` are the ascending vertical-sort outputs, each padded by
    r = k//2 columns of edge replication on both sides, so the column
    domain [-r, w_out + r) exists for every input. Each plan node is
    computed once on the column interval its consumers read it at.
    """
    r = plan.k // 2
    # backward pass: the union of column shifts each value is consumed at
    need: Dict[int, set] = {plan.out[0]: {plan.out[1]}}
    for kind, out, a, ash, b, bsh in reversed(plan.ops):
        for s in need.get(out, ()):
            need.setdefault(a, set()).add(s + ash)
            need.setdefault(b, set()).add(s + bsh)
    dom = {i: (min(ss), max(ss)) for i, ss in need.items()}
    arrs: Dict[int, torch.Tensor] = {}
    los: Dict[int, int] = {}
    for i in range(plan.k):
        lo, hi = dom.get(i, (0, 0))
        arrs[i] = padded_rows[i][..., lo + r : hi + r + w_out]
        los[i] = lo
    # the last op reading each value: its array is dropped after it, so a
    # large input holds only the network's live values, not all of them
    last = {}
    for t, (kind, out, a, ash, b, bsh) in enumerate(plan.ops):
        if out in dom:
            last[a] = last[b] = t
    last[plan.out[0]] = len(plan.ops)
    for t, (kind, out, a, ash, b, bsh) in enumerate(plan.ops):
        if out not in dom:  # dead op of an unpruned plan
            continue
        lo, hi = dom[out]
        wn = w_out + hi - lo
        sa = lo + ash - los[a]
        sb = lo + bsh - los[b]
        av = arrs[a][..., sa : sa + wn]
        bv = arrs[b][..., sb : sb + wn]
        arrs[out] = torch.minimum(av, bv) if kind == "min" else torch.maximum(av, bv)
        los[out] = lo
        for v in (a, b):
            if last[v] == t:
                arrs.pop(v, None)
    oi, osh = plan.out
    s = osh - los[oi]
    return arrs[oi][..., s : s + w_out]


def _presorted_rows(x: torch.Tensor, k: int) -> List[torch.Tensor]:
    """The k ascending vertical neighbors per column (clamp-to-edge)."""
    r = k // 2
    rows = shifted_stack(x, [(dr, 0) for dr in range(-r, k - r)], pad_mode="edge")
    return _sort_network([rows[i] for i in range(k)])


def vector_median_filter(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """Median over a size x size clamp-to-edge window.

    ``x`` is (..., H, W) float; returns the same shape and dtype. Column
    presort, then the unshared pruned plan ``median_merge_plan(k)``.
    """
    if size % 2 != 1:
        raise ValueError(f"median window must be odd, got {size}")
    if size == 1:
        return x
    k = size
    r = k // 2
    padded = [pad(a, 0, r, "edge") for a in _presorted_rows(x, k)]
    return _execute_plan(median_merge_plan(k, share=False), padded, x.shape[-1])
