"""Frozen floors: the least time one H100 could take for a study's work.

Every count here is a pure function of the study's shape (planes, canvas
rows, canvas columns) and of the pipeline's parameters (median window,
sharpen taps, dilation size). None depends on which route or design the
program launches, so a later redesign is measured against the same work
and a share of a floor cannot pass 100 % because a count went stale.

The peaks are NVIDIA's data-sheet numbers for the H100 SXM at its full
700 W; a card set to a lower power limit reads a lower share, so every
reading keeps the card's limit beside it. A floor is the larger of the
bytes over the HBM peak and, for each kind of operation, its count over
the rate of the pipe it issues to (the kinds issue to separate pipes, so
the slowest kind bounds the operations).

The counts are frozen copies: the median's min/max a pixel is the count of
the column-presorted, liveness-pruned, window-shared selection network at
each odd window to 15 (32 + 262 = 294 at k = 7). Past 15 no count is
frozen and the median adds no operations to a floor (its bytes stay).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

# H100 SXM data sheet, dense, 700 W. Float32 outside the tensor cores is
# 67 TFLOP/s counting an FMA as two flops: one add or multiply issues at
# half of it. Min/max, 32-bit bitwise ops and compares issue at 64 per SM
# per clock against 128 float32 lanes: a quarter.
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12
OP_RATES = {"add_mul": PEAK_F32_FLOPS / 2, "minmax_bitwise": PEAK_F32_FLOPS / 4}

# min/max a pixel of the k x k median: column presort + shared merge plan
MEDIAN_MINMAX = {1: 0, 3: 22, 5: 90, 7: 294, 9: 408, 11: 842, 13: 1372, 15: 2266}


def bound_s(bytes_moved: float, ops: Dict[str, float]) -> Tuple[float, str]:
    """Least seconds for ``bytes_moved`` bytes and ``ops`` operations by
    kind of :data:`OP_RATES`, and whether ``"bytes"`` or ``"operations"``
    bound it."""
    t_bytes = bytes_moved / PEAK_BYTES
    t_ops = max((n / OP_RATES[kind] for kind, n in ops.items()), default=0.0)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def median_minmax(k: int) -> int:
    """min/max a pixel of the k x k median (0 where no count is frozen)."""
    return MEDIAN_MINMAX.get(int(k), 0)


def sharpen_add_mul(taps: int) -> int:
    """Adds and multiplies a pixel of the unsharp mask: two passes of
    ``taps`` products and ``taps - 1`` sums, then x + gain * (x - blur)."""
    return 2 * (2 * int(taps) - 1) + 3


def cross_neighbours(size: int, dims: int) -> int:
    """Cells of the city-block ball of radius size // 2 in ``dims``
    dimensions, less the centre: the max operations a pixel of a dilation."""
    r = int(size) // 2
    n = sum(1 for off in _cube(r, dims) if sum(abs(o) for o in off) <= r)
    return n - 1


def _cube(r: int, dims: int):
    if dims == 0:
        yield ()
        return
    for head in range(-r, r + 1):
        for tail in _cube(r, dims - 1):
            yield (head,) + tail


def _pixels(shape: Sequence[int]) -> int:
    return int(math.prod(shape))


def fused_floor_s(shape: Sequence[int], pipeline: dict) -> Tuple[float, str]:
    """Normalize -> clip -> median -> sharpen over a (B, H, W) stack: 4
    bytes read and 4 written a pixel; the median's min/max and the clip's
    two; normalize's three adds and multiplies and the sharpen's."""
    n = _pixels(shape)
    return bound_s(8 * n, {
        "minmax_bitwise": (median_minmax(pipeline["median_window"]) + 2) * n,
        "add_mul": (3 + sharpen_add_mul(pipeline["sharpen_kernel"])) * n,
    })


def grow_floor_s(shape: Sequence[int]) -> Tuple[float, str]:
    """The 2D grow over a (B, H, W) stack, by bytes alone: the image (4),
    seeds (1) and valid mask (1) read and the mask (1) written a pixel, and
    4 bytes a slice for its converged flag and steps. The least work of a
    fixpoint is not known, so no operations are counted."""
    b = int(shape[0])
    return bound_s(7 * _pixels(shape) + 4 * b, {})


def chain_floor_s(shape: Sequence[int], pipeline: dict, volume: bool) -> Tuple[float, str]:
    """The whole chain of one study, as any design would have to do it:
    the raw pixels read once (4 bytes) and the mask written once (1 byte)
    a pixel, and every stage's operations that do not depend on the data:
    normalize and the sharpen (adds and multiplies), the clip, the median,
    the band's two compares and its AND with the valid mask, the
    dilation's maxima and the final AND with the valid mask (min/max and
    bitwise). The growth's own steps depend on the data and are not
    counted. ``volume``: the dilation is 3D (6 neighbours), else 2D (4)."""
    n = _pixels(shape)
    minmax = (2 + median_minmax(pipeline["median_window"]) + 3
              + cross_neighbours(pipeline["morph_size"], 3 if volume else 2) + 1)
    add_mul = 3 + sharpen_add_mul(pipeline["sharpen_kernel"])
    return bound_s(5 * n, {"minmax_bitwise": minmax * n, "add_mul": add_mul * n})
