"""The port's saturation layer held against the JAX package's.

The same recorded dispatch, chunk and window stream (made from a numpy
seed, on a fake clock) goes into both packages' ``SaturationMonitor`` at the
CPU peak the two share: equal snapshots, equal published gauges. The same
busy intervals go into both ``PhaseAccountant``s: equal reports. The peak
table names NVIDIA cards only, and ``bucket_flops`` is the documented count.
"""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from nm03_capstone_project_tpu.obs import metrics as jmetrics  # noqa: E402
from nm03_capstone_project_tpu.obs import saturation as jsat  # noqa: E402
from nm03_capstone_project_tpu_torch.config import PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.obs import metrics  # noqa: E402
from nm03_capstone_project_tpu_torch.obs import saturation as sat  # noqa: E402
from nm03_capstone_project_tpu_torch.ops.selection_network import (  # noqa: E402
    comparator_counts,
)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _values(registry) -> dict:
    """{(name, labels): value or histogram counts} of a registry."""
    out = {}
    for m in registry.series():
        key = (m.name, tuple(sorted(m.labels.items())))
        out[key] = m.cumulative() if m.kind == "histogram" else m.value
    return out


def _stream(seed: int, n_lanes: int, buckets=(1, 2, 4, 8)):
    """A seeded serving history: (op, args) tuples with a clock time each."""
    rng = np.random.default_rng(seed)
    t, ops = 1000.0, []
    for _ in range(200):
        t += float(rng.uniform(0.0, 0.05))
        kind = int(rng.integers(3))
        if kind == 0:
            lane = int(rng.integers(n_lanes))
            t0 = t + float(rng.uniform(0.0, 0.01))
            t1 = t0 + float(rng.uniform(0.0005, 0.04))
            ops.append((t, "dispatch", (lane, t0, t1, int(rng.choice(buckets)),
                                        bool(rng.uniform() > 0.1))))
        elif kind == 1:
            b = int(rng.choice(buckets))
            ops.append((t, "chunk", (int(rng.integers(1, b + 1)), b)))
        else:
            ops.append((t, "window", (int(rng.integers(1, 17)), 8 * n_lanes)))
    return ops


def _replay(module, registry_cls, ops, n_lanes, window_s, max_entries):
    clock = FakeClock()
    reg = registry_cls()
    mon = module.SaturationMonitor(registry=reg, window_s=window_s,
                                   max_entries=max_entries, clock=clock)
    mon.set_lanes([("cpu", "")] * n_lanes)
    for lane in range(n_lanes):
        for b in (1, 2, 4, 8):
            mon.set_lane_bucket_flops(lane, b, 1e6 * b * (lane + 1))
    snaps = []
    for t, op, args in ops:
        clock.t = t
        if op == "dispatch":
            lane, t0, t1, b, ok = args
            mon.record_dispatch(lane, t0, t1, bucket=b, counted=ok)
        elif op == "chunk":
            mon.record_chunk(*args)
        else:
            mon.record_window(*args)
        if len(snaps) < 40 and op == "window":
            snaps.append(mon.publish())
    snaps.append(mon.publish(now=clock.t + 1.0))
    return snaps, _values(reg)


@pytest.mark.parametrize("seed,n_lanes,window_s,max_entries", [
    (1, 1, 60.0, 2048), (2, 2, 2.0, 2048), (3, 4, 0.5, 16), (4, 1, 5.0, 4),
])
def test_monitor_snapshots_and_gauges_equal(seed, n_lanes, window_s, max_entries):
    ops = _stream(seed, n_lanes)
    got = _replay(sat, metrics.MetricsRegistry, ops, n_lanes, window_s, max_entries)
    want = _replay(jsat, jmetrics.MetricsRegistry, ops, n_lanes, window_s, max_entries)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[0][-1]["lanes"][0]["peak_flops"] == sat.CPU_PEAK_FLOPS_ESTIMATE


def test_metric_names_are_the_jax_packages():
    for name in ("SERVING_LANE_BUSY_FRACTION", "SERVING_BUSY_FRACTION",
                 "SERVING_LANE_IDLE_GAP_SECONDS", "SERVING_LANE_MFU", "SERVING_MFU",
                 "SERVING_LANE_PEAK_FLOPS", "SERVING_PADDING_WASTE_RATIO",
                 "SERVING_WINDOW_OCCUPANCY_RATIO", "SERVING_BATCH_ROWS_TOTAL",
                 "SERVING_BUCKET_FILL_RATIO", "RESILIENCE_FAULTS_INJECTED_TOTAL",
                 "SERVING_DEVICE_SECONDS_TOTAL", "SERVING_DEVICE_SECONDS_PER_REQUEST",
                 "SERVING_DEVICE_SECONDS_PER_REQUEST_MEAN", "SERVING_DEVICE_TIME_SHARE",
                 "SERVING_EXECUTABLE_HBM_BYTES", "LEDGER_PROFILE_SKIPPED_TOTAL",
                 "SLO_ERROR_BUDGET_REMAINING", "SLO_BURN_RATE_FAST", "SLO_BURN_RATE_SLOW",
                 "SLO_OBJECTIVE_INFO"):
        assert getattr(metrics, name) == getattr(jmetrics, name), name
    assert sat.FILL_RATIO_BUCKETS == jsat.FILL_RATIO_BUCKETS
    assert sat.IDLE_GAP_BUCKETS == jsat.IDLE_GAP_BUCKETS
    assert (sat.DEFAULT_WINDOW_S, sat.DEFAULT_MAX_ENTRIES) == (
        jsat.DEFAULT_WINDOW_S, jsat.DEFAULT_MAX_ENTRIES)


def test_peak_table_names_nvidia_cards_only():
    assert sat.peak_flops_for("cpu") == jsat.peak_flops_for("cpu") == 2e12
    assert sat.peak_flops_for("cuda", "NVIDIA H100 80GB HBM3") == 67e12
    assert sat.peak_flops_for("cuda", "NVIDIA H100 PCIe") == 67e12
    assert sat.peak_flops_for("cuda", "NVIDIA A100-SXM4-80GB") is None
    for kind in ("TPU v4", "TPU v5 lite", "v6e"):
        assert sat.peak_flops_for("tpu", kind) is None
    assert not hasattr(sat, "TPU_PEAK_FLOPS")
    assert set(sat.CUDA_PEAK_FLOPS) == {"H100"}


def test_unknown_peak_publishes_no_mfu():
    reg = metrics.MetricsRegistry()
    mon = sat.SaturationMonitor(registry=reg, clock=FakeClock())
    mon.set_lanes([("cuda", "Some Future Card")])
    mon.set_lane_bucket_flops(0, 1, 1e9)
    mon.record_dispatch(0, 999.0, 999.5, bucket=1)
    snap = mon.publish()
    assert snap["mfu"] is None and snap["lanes"][0]["mfu"] is None
    assert reg.get(metrics.SERVING_MFU) is None


@pytest.mark.parametrize("seed,max_intervals", [(0, 4096), (1, 8), (2, 2)])
def test_phase_accountant_reports_equal(seed, max_intervals):
    rng = np.random.default_rng(seed)
    ours = sat.PhaseAccountant(max_intervals=max_intervals)
    theirs = jsat.PhaseAccountant(max_intervals=max_intervals)
    for _ in range(300):
        phase = str(rng.choice(sat.FEED_PHASES))
        t0 = float(rng.uniform(0.0, 50.0))
        t1 = t0 + float(rng.uniform(-0.1, 0.8))  # reversed intervals too
        ours.record(phase, t0, t1)
        theirs.record(phase, t0, t1)
    assert ours.report() == theirs.report()
    for phase in sat.FEED_PHASES:
        assert ours.busy_seconds(phase) == theirs.busy_seconds(phase)
    assert sat.FEED_PHASES == jsat.FEED_PHASES
    assert sat.PhaseAccountant().report()["feed_stall_ratio"] is None


def test_union_seconds_equal():
    rng = np.random.default_rng(3)
    for _ in range(20):
        iv = [(float(a), float(a + d)) for a, d in zip(rng.uniform(0, 10, 12),
                                                        rng.uniform(-1, 3, 12))]
        assert sat._union_seconds(iv) == jsat._union_seconds(iv)


@pytest.mark.parametrize("window,sharpen", [(7, 9), (3, 5), (15, 3)])
def test_bucket_flops_is_the_documented_count(window, sharpen):
    cfg = PipelineConfig(canvas=128, median_window=window, sharpen_kernel=sharpen)
    counts = comparator_counts(window)
    median = counts["presort_minmax"] + counts["merge_minmax_pruned_shared"]
    per_pixel = (3 + 2 + median + 2 * (2 * sharpen - 1) + 3
                 + cfg.grow_block_iters * 9 / 32 + 2 + 1 + 4 + 1)
    for bucket in (1, 2, 16):
        assert sat.bucket_flops(cfg, bucket) == bucket * 128 * 128 * per_pixel
    assert sat.bucket_flops(cfg, 4, canvas=256) == 4 * sat.bucket_flops(cfg, 4)
