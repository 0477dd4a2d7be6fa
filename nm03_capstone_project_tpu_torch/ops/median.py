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
neither NaN nor a signed zero occurs. So do the JAX package's two
comparison medians, ported here for ``median_impl``:

* :func:`vector_median_filter_merge` — the full Batcher odd-even merge of
  the presorted runs, rank k²//2 read at the end (``median_impl='merge'``);
* :func:`vector_median_filter_sort` — sort the materialized window, the
  readable oracle (``median_impl='sort'``).

:func:`vector_median_filter_multichannel` is the true vector median of
multi-channel data: the window sample vector with the least summed L1
distance to the others.

Boundary handling is clamp-to-edge, matching the OpenCL sampler addressing
the reference inherits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from nm03_capstone_project_tpu_torch.ops.neighborhood import pad, shifted_stack, window_offsets
from nm03_capstone_project_tpu_torch.ops.selection_network import (
    MedianPlan,
    median_merge_plan,
    next_pow2,
    oddeven_merge_pairs,
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


def _merge_runs_take_median(sorted_rows: List[torch.Tensor], k: int, colslice) -> torch.Tensor:
    """Rank k²//2 of the k*k window from k vertically sorted row tensors,
    by the FULL odd-even merge (``median_impl='merge'``).

    ``colslice(a, j)`` extracts the j-th (0-based) horizontal window column
    of a sorted row tensor. Runs are +inf-padded to powers of two (folded in
    Python by :func:`_apply_pairs`) and merged with a Batcher odd-even merge
    tree.
    """
    p_run = next_pow2(k)  # slots per run, +inf padded
    n_runs = next_pow2(k)  # number of runs, all-+inf runs appended
    vals: List[Optional[torch.Tensor]] = []
    for j in range(k):
        vals.extend(colslice(a, j) for a in sorted_rows)
        vals.extend([_PAD] * (p_run - k))
    vals.extend([_PAD] * ((n_runs - k) * p_run))
    width = p_run
    total = p_run * n_runs
    while width < total:
        pairs: List[Tuple[int, int]] = []
        for lo in range(0, total, 2 * width):
            oddeven_merge_pairs(lo, 2 * width, 1, pairs)
        _apply_pairs(vals, pairs)
        width *= 2
    med = vals[(k * k) // 2]
    if med is _PAD:
        raise AssertionError("the merge network left the median slot empty")
    return med


def vector_median_filter_merge(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """Median via the full odd-even merge network; the same bits as
    :func:`vector_median_filter` (``median_impl='merge'``)."""
    if size % 2 != 1:
        raise ValueError(f"median window must be odd, got {size}")
    if size == 1:
        return x
    k = size
    r = k // 2
    w = x.shape[-1]
    # the rows edge-padded once; window column j is a width-w slice of each
    padded = [pad(a, 0, r, "edge") for a in _presorted_rows(x, k)]
    return _merge_runs_take_median(padded, k, lambda a, j: a[..., j : j + w])


def vector_median_filter_sort(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """Median by sorting each materialized window (``median_impl='sort'``)."""
    if size % 2 != 1:
        raise ValueError(f"median window must be odd, got {size}")
    stack = shifted_stack(x, window_offsets(size), pad_mode="edge")
    return torch.sort(stack, dim=0).values[stack.shape[0] // 2]


def vector_median_filter_multichannel(x: torch.Tensor, size: int = 7) -> torch.Tensor:
    """True vector median for multi-channel data (..., C, H, W).

    Picks, per pixel, the window sample vector minimizing the sum of L1
    distances to the other samples (the first such sample on a tie, as
    ``jnp.argmin`` picks).
    """
    if size % 2 != 1:
        raise ValueError(f"median window must be odd, got {size}")
    stack = shifted_stack(x, window_offsets(size), pad_mode="edge")  # (K, ..., C, H, W)
    # pairwise L1 distances between window samples, summed over channels
    diff = (stack[:, None] - stack[None, :]).abs().sum(dim=-3)  # (K, K, ..., H, W)
    cost = diff.sum(dim=1)  # (K, ..., H, W)
    return _select_sample(stack, torch.argmin(cost, dim=0))


def _select_sample(stack: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """stack[best[..., h, w], ..., :, h, w] -> (..., C, H, W), as the JAX
    package's one-hot product summed over the window axis."""
    k = stack.shape[0]
    onehot = torch.nn.functional.one_hot(best, k).movedim(-1, 0).to(stack.dtype)
    return (stack * onehot[:, ..., None, :, :]).sum(dim=0)
