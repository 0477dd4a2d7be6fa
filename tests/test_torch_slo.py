"""The port's SLO plane held against the JAX package's, float for float.

The same request series (outcome counters and latency observations, made
from a numpy seed, on a fake clock) goes into both packages' registries;
each package's ``SLOMonitor`` publishes after every step, and the burn
rates, the budget and the gauges must be equal exactly: the same
arithmetic on the same numbers.
"""

import argparse
import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from nm03_capstone_project_tpu.obs import metrics as jmetrics  # noqa: E402
from nm03_capstone_project_tpu.obs import slo as jslo  # noqa: E402
from nm03_capstone_project_tpu.serving import metrics as jserving  # noqa: E402
from nm03_capstone_project_tpu_torch.obs import metrics, slo  # noqa: E402
from nm03_capstone_project_tpu_torch.serving import metrics as serving  # noqa: E402

STATUSES = ("ok", "ok", "ok", "ok", "ok", "ok", "error", "timeout", "shed", "invalid", "probe")


class FakeClock:
    def __init__(self):
        self.t = 5000.0

    def __call__(self):
        return self.t


def _run(module, reg_cls, serving_mod, objective_kw, seed):
    clock = FakeClock()
    reg = reg_cls()
    mon = module.SLOMonitor(
        reg, module.SLOObjective(**objective_kw),
        serving_mod.SERVING_REQUESTS_TOTAL, serving_mod.SERVING_REQUEST_SECONDS, clock=clock,
    )
    rng = np.random.default_rng(seed)
    blocks = []
    for _ in range(60):
        clock.t += float(rng.uniform(1.0, 120.0))
        for _ in range(int(rng.integers(0, 20))):
            status = STATUSES[int(rng.integers(len(STATUSES)))]
            reg.counter(serving_mod.SERVING_REQUESTS_TOTAL, status=status).inc()
            if status not in ("probe", "invalid"):
                reg.histogram(serving_mod.SERVING_REQUEST_SECONDS,
                              buckets=serving_mod.LATENCY_BUCKETS).observe(
                    float(rng.lognormal(-2.0, 1.5)))
        blocks.append(mon.publish())
    gauges = {m.name: m.value for m in reg.series()
              if m.name.startswith("slo_") and m.name != "slo_objective_info"}
    info = [dict(m.labels) for m in reg.series() if m.name == "slo_objective_info"]
    return blocks, gauges, info, mon.last_block()


@pytest.mark.parametrize("objective_kw", [
    {"availability_pct": 99.0},
    {"availability_pct": 99.5, "latency_target_s": 0.25},
    {"availability_pct": 90.0, "latency_target_s": 0.1, "latency_pct": 95.0,
     "window_fast_s": 60.0, "window_slow_s": 900.0},
    {"availability_pct": 99.9, "latency_target_s": 0.3},  # between bucket bounds
    {"availability_pct": 99.0, "latency_target_s": 500.0},  # past every bound
])
@pytest.mark.parametrize("seed", [0, 1])
def test_burn_rates_and_budget_equal_exactly(objective_kw, seed):
    got = _run(slo, metrics.MetricsRegistry, serving, objective_kw, seed)
    want = _run(jslo, jmetrics.MetricsRegistry, jserving, objective_kw, seed)
    assert got == want
    assert got[1]["slo_error_budget_remaining"] <= 1.0


def test_constants_and_objective_description_equal():
    assert (slo.DEFAULT_FAST_WINDOW_S, slo.DEFAULT_SLOW_WINDOW_S) == (
        jslo.DEFAULT_FAST_WINDOW_S, jslo.DEFAULT_SLOW_WINDOW_S)
    assert (slo.GOOD_STATUSES, slo.BAD_STATUSES) == (jslo.GOOD_STATUSES, jslo.BAD_STATUSES)
    kw = {"availability_pct": 99.5, "latency_target_s": 0.5}
    assert slo.SLOObjective(**kw).describe() == jslo.SLOObjective(**kw).describe()
    assert serving.LATENCY_BUCKETS == jserving.LATENCY_BUCKETS


@pytest.mark.parametrize("kw", [
    {"availability_pct": 100.0}, {"availability_pct": 0.0},
    {"latency_target_s": -1.0}, {"latency_pct": 100.0},
    {"window_fast_s": 0.0}, {"window_fast_s": 7200.0, "window_slow_s": 3600.0},
])
def test_invalid_objectives_refused_alike(kw):
    with pytest.raises(ValueError):
        jslo.SLOObjective(**kw)
    with pytest.raises(ValueError):
        slo.SLOObjective(**kw)


@pytest.mark.parametrize("argv", [
    [], ["--slo-availability", "99.5"], ["--slo-p99-ms", "250"],
    ["--slo-availability", "95", "--slo-p99-ms", "1000", "--slo-fast-window-s", "30",
     "--slo-slow-window-s", "600"],
])
def test_flags_and_objective_from_args_equal(argv):
    ours, theirs = argparse.ArgumentParser(), argparse.ArgumentParser()
    slo.add_slo_args(ours)
    jslo.add_slo_args(theirs)
    a, b = ours.parse_args(argv), theirs.parse_args(argv)
    assert vars(a) == vars(b)
    oa, ob = slo.objective_from_args(a), jslo.objective_from_args(b)
    assert (oa is None) == (ob is None) == (argv == [])
    if oa is not None:
        assert oa.describe() == ob.describe()
