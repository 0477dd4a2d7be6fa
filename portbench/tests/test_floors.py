"""The frozen floors, pinned for the shapes of the benchmark's cells."""

from __future__ import annotations

import pytest

from portbench import floors

FAST = {"median_window": 7, "sharpen_kernel": 9, "morph_size": 3}
TCIA = (25, 256, 256)  # a TCIA series on the 256 canvas
BRATS = (155, 256, 256)  # a BraTS volume (240 x 240 planes) on the 256 canvas


def test_peaks_are_the_h100_sxm_data_sheet():
    assert floors.PEAK_BYTES == 3.35e12
    assert floors.OP_RATES == {"add_mul": 33.5e12, "minmax_bitwise": 16.75e12}


def test_frozen_counts():
    assert floors.MEDIAN_MINMAX == {1: 0, 3: 22, 5: 90, 7: 294, 9: 408, 11: 842,
                                    13: 1372, 15: 2266}
    assert floors.median_minmax(17) == 0  # no count frozen past 15
    assert floors.sharpen_add_mul(9) == 37
    assert floors.sharpen_add_mul(33) == 133
    assert [floors.cross_neighbours(3, 2), floors.cross_neighbours(3, 3),
            floors.cross_neighbours(5, 2), floors.cross_neighbours(1, 3)] == [4, 6, 12, 0]


@pytest.mark.parametrize("shape,seconds", [(TCIA, 296 * 1638400 / 16.75e12),
                                           (BRATS, 296 * 10158080 / 16.75e12)])
def test_fused_floor_is_the_median_operations(shape, seconds):
    assert floors.fused_floor_s(shape, FAST) == (pytest.approx(seconds, rel=1e-12), "operations")


def test_fused_floor_past_the_frozen_windows_is_bytes():
    assert floors.fused_floor_s(TCIA, dict(FAST, median_window=17)) == (
        pytest.approx(8 * 1638400 / 3.35e12, rel=1e-12), "bytes")


@pytest.mark.parametrize("shape,seconds", [(TCIA, (7 * 1638400 + 4 * 25) / 3.35e12),
                                           (BRATS, (7 * 10158080 + 4 * 155) / 3.35e12)])
def test_grow_floor_is_bytes(shape, seconds):
    assert floors.grow_floor_s(shape) == (pytest.approx(seconds, rel=1e-12), "bytes")


@pytest.mark.parametrize("shape,volume,minmax", [(TCIA, False, 304), (BRATS, False, 304),
                                                 (BRATS, True, 306)])
def test_chain_floor(shape, volume, minmax):
    n = shape[0] * shape[1] * shape[2]
    assert floors.chain_floor_s(shape, FAST, volume) == (
        pytest.approx(minmax * n / 16.75e12, rel=1e-12), "operations")


def test_a_floor_never_falls_below_either_bound():
    for shape in (TCIA, BRATS, (1, 16, 16)):
        s, _ = floors.chain_floor_s(shape, FAST, False)
        n = shape[0] * shape[1] * shape[2]
        assert s >= 5 * n / floors.PEAK_BYTES
        assert s <= floors.fused_floor_s(shape, FAST)[0] + floors.grow_floor_s(shape)[0] + \
            (3 + 4 + 1 + 2) * n / 16.75e12 + 5 * n / floors.PEAK_BYTES
