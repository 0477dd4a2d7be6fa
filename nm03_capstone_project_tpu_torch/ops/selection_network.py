"""Comparator-network construction and trace-time pruning for the median.

Pure Python, deliberately **jax-free**: the network is a compile-time
artifact (a DAG of min/max ops over window samples), so its construction,
pruning and counting must be importable from processes that never touch
jax — bench.py's orchestrator records comparator metadata in the metrics
snapshot, and the obs registry is stdlib-only by contract.

The planner turns "median of a k x k window given k column-presorted rows"
into a DAG of min/max ops over *lane-shifted* array references, applying
three work-elimination ideas the full odd-even merge tree leaves on the
table:

* **Merge sharing across overlapping windows.** Adjacent output pixels
  share k-1 of their k sorted columns, so the merge of columns (x, x+1)
  is the merge of columns (x+2, x+3) shifted two lanes. Subtree merges
  are built once in canonical form and *referenced* at different shifts
  (each op in the plan carries per-operand lane shifts); the executor
  computes every node a single time on a slightly widened domain instead
  of re-merging per window position.
* **Rank selection instead of a final merge.** The filter needs rank
  k²//2, not a sort: the last (largest) merge level is replaced by the
  order-statistic identity

      rank_p(A ∪ B) = max_{i+j=p} min(A_i, B_j)      (+inf past the ends)

  (verified exhaustively against brute force, duplicates included, in the
  test suite) — ~40 ops where the odd-even final merge costs hundreds.
* **Backward liveness** from the single median output then removes every
  op that cannot reach it (dead sorted positions, and the dead half of
  compare-exchanges only one of whose outputs is consumed).

For k=7 the full odd-even merge tree emits 566 min/max ops per pixel; the
pruned plan emits 346 (1.64x fewer), and with cross-window sharing 262 —
2.16x fewer (3.14x at k=5, 3.90x at k=9; presort excluded: its outputs
all stay live and every path shares it; exact numbers per k come from
:func:`comparator_counts`, asserted in tests). The XLA path runs the
unshared pruned plan (sharing requires shifted reads of intermediates,
which XLA's producer-duplicating fusion turns into recompute — measured
~10x slower on XLA:CPU); the Pallas kernel runs the shared plan on
VMEM-resident values, where the op count is the cost. Every pruned-plan op
computes the same value as the full network (the rank identity is an
equality on values, not an approximation), so the median is bit-identical
on any input free of NaNs — the caveat all min/max networks share; the
pipeline's median consumes clipped finite data.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

_PAD = None  # +inf sentinel slot; folded in Python before any op is planned

Ref = Tuple[int, int]  # (value id, lane shift relative to the consumer)


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def oddeven_merge_pairs(lo: int, n: int, r: int, pairs: List[Tuple[int, int]]):
    """Batcher odd-even merge: positions [lo, lo+n) hold two sorted halves."""
    step = 2 * r
    if step < n:
        oddeven_merge_pairs(lo, n, step, pairs)
        oddeven_merge_pairs(lo + r, n, step, pairs)
        for i in range(lo + r, lo + n - r, step):
            pairs.append((i, i + r))
    else:
        pairs.append((lo, lo + r))


def oddeven_sort_pairs(lo: int, n: int, pairs: List[Tuple[int, int]]):
    """Batcher odd-even mergesort network for positions [lo, lo+n), n = 2^m."""
    if n > 1:
        m = n // 2
        oddeven_sort_pairs(lo, m, pairs)
        oddeven_sort_pairs(lo + m, m, pairs)
        oddeven_merge_pairs(lo, n, 1, pairs)


class MedianPlan(NamedTuple):
    """Executable min/max DAG for the merge phase of a k x k median.

    Value ids [0, k) are the k column-presorted rows (ascending: id a is
    the a-th smallest of the k vertical neighbors, as a full-width array);
    every other id is defined by one op. ``ops`` is topologically ordered:
    ``(kind, out_id, a_id, a_shift, b_id, b_shift)`` defines ``out_id`` as
    ``kind(a@a_shift, b@b_shift)`` where ``v@s`` reads value ``v`` at lane
    ``x + s`` for output lane ``x``. ``out`` is ``(id, shift)`` of the
    median. Shifts stay within [-(k//2), k//2].
    """

    k: int
    ops: Tuple[Tuple[str, int, int, int, int, int], ...]
    out: Ref


class _Builder:
    """Min/max DAG under construction; input ids are [0, n_in)."""

    def __init__(self, n_in: int):
        self.n_in = n_in
        self.nodes: Dict[int, Tuple[str, Ref, Ref]] = {}
        self._next = n_in

    def emit(self, kind: str, a: Ref, b: Ref) -> int:
        i = self._next
        self._next += 1
        self.nodes[i] = (kind, a, b)
        return i


def _merge_sorted_refs(
    bld: _Builder,
    a: List[Ref],
    b: List[Ref],
    memo: Optional[Dict],
) -> List[Ref]:
    """Odd-even merge of two ascending ref lists into one; returns the
    merged list. With ``memo``, structurally identical merges (same ref
    ids and *relative* shifts) are canonicalized, built once, and
    re-referenced at the caller's base shift — the cross-window sharing.
    Without ``memo`` no canonicalization happens, so intermediate nodes
    are only ever referenced at shift 0 (shifts appear exclusively on the
    k input rows) — the shape XLA fuses into one register-resident loop.
    """
    if not a:
        return list(b)
    if not b:
        return list(a)
    if memo is None:
        base = 0
        an, bn = tuple(a), tuple(b)
    else:
        base = min(s for _, s in a + b)
        an = tuple((i, s - base) for i, s in a)
        bn = tuple((i, s - base) for i, s in b)
    key = (an, bn)
    if memo is not None and key in memo:
        merged = memo[key]
    else:
        half = next_pow2(max(len(an), len(bn)))
        pos: List = list(an) + [_PAD] * (half - len(an))
        pos += list(bn) + [_PAD] * (half - len(bn))
        pairs: List[Tuple[int, int]] = []
        oddeven_merge_pairs(0, 2 * half, 1, pairs)
        for i, j in pairs:
            x, y = pos[i], pos[j]
            if y is _PAD:
                continue
            if x is _PAD:
                pos[i], pos[j] = y, _PAD
                continue
            pos[i] = (bld.emit("min", x, y), 0)
            pos[j] = (bld.emit("max", x, y), 0)
        merged = tuple(p for p in pos if p is not _PAD)
        assert len(merged) == len(an) + len(bn)
        if memo is not None:
            memo[key] = merged
    return [(i, s + base) for i, s in merged]


def _rank_select(bld: _Builder, a: List[Ref], b: List[Ref], rho: int) -> Ref:
    """rank_rho(a ∪ b) for ascending ref lists via max_{i+j=rho} min(a_i, b_j).

    Out-of-range positions are +inf: a term with one side past the end
    collapses to the other side's element alone, and consecutive collapsed
    terms are dominated by their largest (the lists are sorted), so each
    boundary contributes at most one bare term. The max accumulation is a
    balanced tree (min/max are commutative and associative, so shape is
    free; a tree keeps the dependency depth logarithmic for the VPU).
    """
    terms: List[Ref] = []
    if rho >= len(b):  # a-side terms whose b-side is exhausted
        terms.append(a[rho - len(b)])
    if rho >= len(a):
        terms.append(b[rho - len(a)])
    for i in range(max(0, rho - len(b) + 1), min(rho + 1, len(a))):
        terms.append((bld.emit("min", a[i], b[rho - i]), 0))
    while len(terms) > 1:
        nxt = [
            (bld.emit("max", terms[t], terms[t + 1]), 0)
            for t in range(0, len(terms) - 1, 2)
        ]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _build(k: int, prune: bool, share: bool) -> MedianPlan:
    r = k // 2
    n_runs = next_pow2(k)
    bld = _Builder(k)
    memo: Optional[Dict] = {} if share else None

    def subtree(q: int, span: int) -> List[Ref]:
        """Ascending merged refs of runs [q, q+span) (runs >= k are empty)."""
        if span == 1:
            if q >= k:
                return []
            return [(a, q - r) for a in range(k)]
        left = subtree(q, span // 2)
        right = subtree(q + span // 2, span // 2)
        return _merge_sorted_refs(bld, left, right, memo)

    left = subtree(0, n_runs // 2)
    right = subtree(n_runs // 2, n_runs // 2)
    if prune:
        out = _rank_select(bld, left, right, (k * k) // 2)
        live = set()
        stack = [out[0]]
        while stack:
            v = stack.pop()
            if v < k or v in live:
                continue
            live.add(v)
            _, (ai, _), (bi, _) = bld.nodes[v]
            stack.extend((ai, bi))
    else:
        out = _merge_sorted_refs(bld, left, right, memo)[(k * k) // 2]
        live = set(bld.nodes)
    ops = tuple(
        (kind, i, a[0], a[1], b[0], b[1])
        for i, (kind, a, b) in sorted(bld.nodes.items())
        if i in live
    )
    return MedianPlan(k=k, ops=ops, out=out)


@functools.lru_cache(maxsize=None)
def median_merge_plan(
    k: int, prune: bool = True, share: bool = False
) -> MedianPlan:
    """The merge-phase plan for a k x k median over k presorted rows.

    ``prune=False, share=False`` is the odd-even merge baseline: the full
    per-window merge tree, every compare-exchange emitting both outputs —
    the network this repo's median has always traced. ``prune=True`` adds
    rank-k²//2 selection in place of the final merge plus backward
    liveness; ``share=True`` additionally canonicalizes subtree merges so
    repeated structures are built once and referenced at lane shifts.

    The two fast variants serve different executors:

    * ``share=False`` (346 ops at k=7) keeps every intermediate at shift
      0, so the XLA path stays one pure elementwise DAG over input slices
      — the shape XLA fuses into a register-resident loop. (Measured on
      XLA:CPU: the shared plan's shifted intermediate reads defeat fusion
      and run ~10x slower despite fewer ops; XLA's producer-duplicating
      fusion recomputes sliced intermediates per consumer.)
    * ``share=True`` (262 ops at k=7) is for the Pallas kernel, where ops
      execute one-by-one on VMEM-resident values: there a node referenced
      at three shifts really is computed once, and the op count is the
      cost.

    All variants compute the same value on NaN-free inputs.
    """
    if k < 1 or k % 2 == 0:
        raise ValueError(f"median window must be odd and >= 1, got {k}")
    if k == 1:
        return MedianPlan(k=1, ops=(), out=(0, 0))
    return _build(k, prune, share)


def presort_minmax_count(k: int) -> int:
    """min/max ops of the column presort (a k-wide Batcher sort network).

    Every presorted output feeds the merge phase, so the presort never
    prunes; counted separately for the stage-table attribution.
    """
    p = next_pow2(k)
    pairs: List[Tuple[int, int]] = []
    oddeven_sort_pairs(0, p, pairs)
    pos: List = list(range(k)) + [_PAD] * (p - k)
    n_ce = 0
    for i, j in pairs:
        a, b = pos[i], pos[j]
        if b is _PAD:
            continue
        if a is _PAD:
            pos[i], pos[j] = b, _PAD
            continue
        n_ce += 1
        pos[i] = pos[j] = -1  # real nodes; ids irrelevant for counting
    return 2 * n_ce


def full_merge_minmax_count(k: int) -> int:
    """min/max ops of the historical odd-even merge baseline.

    Counts the exact network :func:`median.vector_median_filter_merge`
    traces: k runs padded to ``p = next_pow2(k)`` +inf slots, ``p`` runs
    total, the staged width-doubling merge run to a full sort, rank k²//2
    read at the end — every fold-surviving compare-exchange emitting both
    outputs, every window re-merged (no cross-window sharing). This is the
    denominator of the pruning claim, so it must count the baseline as
    traced, not as the planner would restructure it.
    """
    if k == 1:
        return 0
    p_run = next_pow2(k)
    total = p_run * p_run
    pos: List = []
    for j in range(k):
        pos.extend([j] * k)
        pos.extend([_PAD] * (p_run - k))
    pos.extend([_PAD] * ((p_run - k) * p_run))
    n_ce = 0
    width = p_run
    while width < total:
        pairs: List[Tuple[int, int]] = []
        for lo in range(0, total, 2 * width):
            oddeven_merge_pairs(lo, 2 * width, 1, pairs)
        for i, j in pairs:
            a, b = pos[i], pos[j]
            if b is _PAD:
                continue
            if a is _PAD:
                pos[i], pos[j] = b, _PAD
                continue
            n_ce += 1
        width *= 2
    return 2 * n_ce


@functools.lru_cache(maxsize=None)
def comparator_counts(k: int) -> Dict[str, int]:
    """min/max op counts of the k x k median's merge phase, full vs pruned.

    ``merge_minmax_full`` is the odd-even merge baseline (every
    compare-exchange emits both outputs, every window re-merged);
    ``merge_minmax_pruned`` the liveness-pruned selection network the XLA
    path traces; ``merge_minmax_pruned_shared`` the additionally
    cross-window-shared plan the Pallas kernel runs. ``presort_minmax``
    is the per-column vertical sort all paths share. Counts are the ops
    the respective program executes per pixel.
    """
    pruned = median_merge_plan(k, prune=True, share=False)
    shared = median_merge_plan(k, prune=True, share=True)
    return {
        "window": k,
        "presort_minmax": presort_minmax_count(k),
        "merge_minmax_full": full_merge_minmax_count(k),
        "merge_minmax_pruned": len(pruned.ops),
        "merge_minmax_pruned_shared": len(shared.ops),
    }
