"""Straight-line median programs for a run of R horizontally adjacent outputs.

The fused preprocess kernel (``csrc/fused.cu``) computes the k x k median
of R neighbouring pixels of one row together, in registers. Its program is
generated here, in pure Python, from the port's copy of the shared
selection plan, ``median_merge_plan(k, share=True)``:

1. **Presort.** The R + 2r window columns (r = k // 2) the run reads are
   each sorted with the Batcher odd-even merge network whose count
   :func:`.selection_network.presort_minmax_count` reports (32 min/max at
   k = 7, against 42 for odd-even transposition).
2. **Shared plan.** Every plan node is computed once at each lane the run
   needs it, so a merge that neighbouring windows share (the plan reads it
   at several shifts) is one register, not one per window. This is the
   sharing the Pallas kernel gets from shifted full-row reads.
3. **Liveness.** Every op that cannot reach one of the R medians is dropped,
   including the dead half of a compare-exchange.

The ops are then ordered to keep few values live at once (the generated
code is straight-line, so the order bounds the registers the compiler
needs), and :func:`cuda_source` renders the program as a device function.
:func:`execute` runs the same program on numpy arrays, so the CPU tests hold
the exact code the card runs against a brute-force median.

Value ids: ``d * k + a`` (``d < R + 2r``, ``a < k``) is the raw sample of
window column d (canvas column x0 - r + d) at row offset a; every other id
is defined by one op ``(kind, out, a, b)``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np

from nm03_capstone_project_tpu_torch.ops.selection_network import (
    median_merge_plan,
    next_pow2,
    oddeven_sort_pairs,
)

# The run length R of the fused kernel for each window k. The larger R,
# the more of the shared plan's sharing a thread keeps and the less of the
# presort it repeats (the R + 2r columns of a run), but the more values are
# live at once: each R is the largest of 1, 2, 4, 8, 16 whose estimated
# live set (:func:`max_live`) stays within LIVE_CAP registers, and 1 where
# none does (k >= 11). On the H100 ptxas spills none of them (PERF.md).
FUSED_RUNS = {1: 16, 3: 16, 5: 16, 7: 16, 9: 2, 11: 1, 13: 1, 15: 1}
LIVE_CAP = 170


class RunProgram(NamedTuple):
    """A liveness-pruned, ordered min/max program for R medians."""

    k: int
    runs: int
    cols: int  # window columns read: runs + 2 * (k // 2)
    ops: Tuple[Tuple[str, int, int, int], ...]  # (kind, out, a, b)
    outs: Tuple[int, ...]  # value id of median j, j < runs


def _presort(k: int, d: int, nxt: List[int], defs: Dict) -> List[int]:
    """Emit the Batcher sort of column d; its ascending value ids."""
    p = next_pow2(k)
    pairs: List[Tuple[int, int]] = []
    oddeven_sort_pairs(0, p, pairs)
    pos: List = [d * k + a for a in range(k)] + [None] * (p - k)
    for i, j in pairs:
        x, y = pos[i], pos[j]
        if y is None:
            continue
        if x is None:
            pos[i], pos[j] = y, None
            continue
        lo, hi = nxt[0], nxt[0] + 1
        nxt[0] += 2
        defs[lo] = ("min", x, y)
        defs[hi] = ("max", x, y)
        pos[i], pos[j] = lo, hi
    return pos[:k]


def _max_live(order: List[int], defs: Dict, outs: Tuple[int, ...]) -> int:
    """Most values live at once when ``order`` runs; a raw sample becomes
    live at its first use (the generated code loads it there)."""
    uses: Dict[int, int] = {}
    for o in order:
        for x in defs[o][1:]:
            uses[x] = uses.get(x, 0) + 1
    for o in outs:
        uses[o] = uses.get(o, 0) + 1
    live, peak = set(), 0
    for o in order:
        live.update(defs[o][1:])
        live.add(o)
        peak = max(peak, len(live))
        for x in defs[o][1:]:
            uses[x] -= 1
            if uses[x] == 0:
                live.discard(x)
    return peak


@functools.lru_cache(maxsize=None)
def _program(k: int, runs: int) -> Tuple[RunProgram, int]:
    r = k // 2
    cols = runs + 2 * r
    defs: Dict[int, Tuple[str, int, int]] = {}
    nxt = [cols * k]
    sorted_ids = [_presort(k, d, nxt, defs) for d in range(cols)]
    plan = median_merge_plan(k, share=True)
    # the lanes (output offsets in [-r, runs + r)) each plan node is read at
    need: Dict[int, set] = {plan.out[0]: {plan.out[1] + j for j in range(runs)}}
    for _, out, a, ash, b, bsh in reversed(plan.ops):
        for lane in need.get(out, ()):
            need.setdefault(a, set()).add(lane + ash)
            need.setdefault(b, set()).add(lane + bsh)
    ids: Dict[Tuple[int, int], int] = {}

    def vid(node: int, lane: int) -> int:
        return sorted_ids[lane + r][node] if node < k else ids[(node, lane)]

    plan_order = []
    for kind, out, a, ash, b, bsh in plan.ops:
        for lane in sorted(need.get(out, ())):
            ids[(out, lane)] = i = nxt[0]
            nxt[0] += 1
            defs[i] = (kind, vid(a, lane + ash), vid(b, lane + bsh))
            plan_order.append(i)
    outs = tuple(vid(plan.out[0], plan.out[1] + j) for j in range(runs))

    # two orders, each emitting an op's unmet operands depth first just before
    # it: outputs one by one, or the plan's own order; keep the leaner one
    def emit_from(roots) -> List[int]:
        done, order = set(), []

        def visit(v: int) -> None:
            stack = [(v, False)]
            while stack:
                x, expanded = stack.pop()
                if x in done or x not in defs:
                    continue
                if expanded:
                    done.add(x)
                    order.append(x)
                    continue
                stack.append((x, True))
                stack.extend((y, False) for y in reversed(defs[x][1:]))

        for v in roots:
            visit(v)
        return order

    best = None
    for roots in (list(outs), plan_order + list(outs)):
        order = emit_from(roots)
        live = _max_live(order, defs, outs)
        if best is None or live < best[1]:
            best = (order, live)
    order, live = best
    ops = tuple((defs[o][0], o, defs[o][1], defs[o][2]) for o in order)
    return RunProgram(k=k, runs=runs, cols=cols, ops=ops, outs=outs), live


def median_run_program(k: int, runs: int) -> RunProgram:
    """The program for ``runs`` adjacent k x k medians (odd k >= 1)."""
    if k < 1 or k % 2 == 0 or runs < 1:
        raise ValueError(f"median run needs odd k >= 1 and runs >= 1, got {k}, {runs}")
    return _program(k, runs)[0]


def max_live(k: int, runs: int) -> int:
    """Values live at once in the program's order: a register estimate."""
    return _program(k, runs)[1]


def ops_per_output(k: int, runs: int) -> float:
    """min/max the program runs per median, presort included."""
    return len(median_run_program(k, runs).ops) / runs


def execute(prog: RunProgram, window: np.ndarray) -> np.ndarray:
    """Run ``prog`` on ``window`` (..., k, cols): rows a, window columns d.

    Returns (..., runs): median j is that of columns j .. j + k - 1.
    """
    vals = {d * prog.k + a: window[..., a, d] for d in range(prog.cols) for a in range(prog.k)}
    for kind, out, a, b in prog.ops:
        vals[out] = (np.minimum if kind == "min" else np.maximum)(vals[a], vals[b])
    return np.stack([vals[o] for o in prog.outs], axis=-1)


def cuda_source(prog: RunProgram) -> str:
    """``MedianRun<k, R>::run(s, ps, m)``: s[a * ps + d] is the raw sample
    of window column d at row offset a; writes median j to m[j]."""
    k, cols = prog.k, prog.cols
    lines = [
        f"template <> struct MedianRun<{k}, {prog.runs}> {{",
        f"  static constexpr int OPS = {len(prog.ops)};",
        "  static __device__ __forceinline__ void run(const float* __restrict__ s, int ps,",
        "                                             float* __restrict__ m) {",
    ]
    loaded = set()

    def ref(v: int) -> str:
        if v < cols * k and v not in loaded:
            loaded.add(v)
            d, a = divmod(v, k)
            lines.append(f"    const float v{v} = s[{a} * ps + {d}];")
        return f"v{v}"

    for kind, out, a, b in prog.ops:
        ra, rb = ref(a), ref(b)
        fn = "fminf" if kind == "min" else "fmaxf"
        lines.append(f"    const float v{out} = {fn}({ra}, {rb});")
    for j, o in enumerate(prog.outs):
        lines.append(f"    m[{j}] = {ref(o)};")
    lines += ["  }", "};"]
    return "\n".join(lines)


if __name__ == "__main__":  # print ops per output and live values per (k, R)
    for k, runs in FUSED_RUNS.items():
        print(f"k={k} R={runs}: {ops_per_output(k, runs):.1f} min/max a median, "
              f"{max_live(k, runs)} live values")
