"""The port's fault plans held against the JAX package's, call for call.

The same plan specs parse to the same rules (and the same refusals) in both
packages, apart from the one kind the port refuses on purpose
(``cache``/``io_error``: the JAX compile cache). Over a grid of sites x
selectors x ``after``/``count``/``rate`` the same seeded sequence of checks,
made from a numpy seed, fires the same rule on the same check in both;
``corrupt_bytes`` gives the same bytes; hangs honour their cancel event.
"""

import json
import pathlib
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from nm03_capstone_project_tpu.obs.run import RunContext as JaxRunContext  # noqa: E402
from nm03_capstone_project_tpu.resilience import faultinject as jfi  # noqa: E402
from nm03_capstone_project_tpu_torch.obs import RunContext  # noqa: E402
from nm03_capstone_project_tpu_torch.resilience import faultinject as fi  # noqa: E402

PORTED_KINDS = [(site, kind) for site, kinds in fi.KINDS_BY_SITE.items() for kind in kinds
                if (site, kind) not in fi.NOT_PORTED_KINDS]


def _both(spec):
    return jfi.FaultPlan.from_spec(spec), fi.FaultPlan.from_spec(spec)


def _rule_fields(rule) -> dict:
    return {k: getattr(rule, k) for k in ("site", "kind", "patient", "stem", "index", "lane",
                                          "after", "count", "rate", "hang_s")}


# -- parsing -------------------------------------------------------------------


def test_sites_and_kinds_are_the_jax_packages():
    assert fi.SITES == jfi.SITES
    assert fi.KINDS_BY_SITE == jfi.KINDS_BY_SITE
    assert fi.ENV_VAR == jfi.ENV_VAR == "NM03_FAULT_PLAN"
    assert fi.NOT_PORTED_KINDS == {}  # the compile cache's io_error is ported


@pytest.mark.parametrize("site,kind", PORTED_KINDS)
def test_every_ported_kind_parses_the_same(site, kind):
    spec = {"seed": 9, "faults": [{"site": site, "kind": kind, "stem": "1-02", "index": 3,
                                   "after": 2, "count": 1, "rate": 0.5, "hang_s": 1.5}]}
    jp, pp = _both(spec)
    assert pp.seed == jp.seed == 9
    assert [_rule_fields(r) for r in pp.rules] == [_rule_fields(r) for r in jp.rules]
    assert pp.has_site(site) and not pp.has_site("nowhere")


@pytest.mark.parametrize("form", ["dict", "json", "file"])
def test_spec_forms(form, tmp_path):
    spec = {"seed": 3, "faults": [{"site": "dispatch", "kind": "transient", "count": 2},
                                  {"site": "fleet", "kind": "proxy_io_error", "index": 1}]}
    if form == "json":
        spec = json.dumps(spec)
    elif form == "file":
        path = tmp_path / "plan.json"
        path.write_text(json.dumps(spec))
        spec = str(path)
    jp, pp = _both(spec)
    assert [_rule_fields(r) for r in pp.rules] == [_rule_fields(r) for r in jp.rules]
    assert fi.FaultPlan.from_spec(None) is None
    assert fi.FaultPlan.from_spec(pp) is pp


@pytest.mark.parametrize("spec", [
    {"faults": [{"site": "nowhere", "kind": "error"}]},
    {"faults": [{"site": "decode", "kind": "hang"}]},
    {"faults": [{"site": "decode", "kind": "error", "bogus": 1}]},
    {"faults": [{"site": "decode", "kind": "error", "rate": 1.5}]},
    {"faults": [{"site": "dispatch", "kind": "hang", "hang_s": -1}]},
    {"faults": ["decode"]},
    "{not json",
    [1, 2],
])
def test_refusals_match(spec):
    with pytest.raises(ValueError):
        jfi.FaultPlan.from_spec(spec)
    with pytest.raises(ValueError):
        fi.FaultPlan.from_spec(spec)


def test_the_compile_cache_kind_is_refused_with_its_reason():
    """Refused until the compile cache was ported (the name is kept): now
    both packages parse cache/io_error and fire it on the same checks, and
    its `kinds` filter keeps it apart from the result tier's kind."""
    spec = {"seed": 2, "faults": [{"site": "cache", "kind": "io_error", "stem": "e1",
                                   "count": 1}]}
    jp, pp = _both(spec)
    assert pp.has_site("cache") and jp.has_site("cache")
    for plan in (jp, pp):
        assert plan.fire("cache", stem="e1", kinds=("corrupt_entry",)) is None
        assert plan.fire("cache", stem="e0", kinds=("io_error",)) is None
        assert plan.fire("cache", stem="e1", kinds=("io_error",)) is not None
        assert plan.fire("cache", stem="e1", kinds=("io_error",)) is None  # count 1
    with pytest.raises(ValueError, match="invalid for site 'cache'"):
        fi.FaultPlan.from_spec({"faults": [{"site": "cache", "kind": "evict"}]})


def test_environment_activation(monkeypatch):
    spec = json.dumps({"seed": 5, "faults": [{"site": "export", "kind": "io_error"}]})
    monkeypatch.setenv("NM03_FAULT_PLAN", spec)
    jp, pp = jfi.FaultPlan.from_env(), fi.FaultPlan.from_env()
    assert pp.seed == jp.seed == 5 and pp.has_site("export")
    monkeypatch.setenv("NM03_FAULT_PLAN", "")
    assert fi.FaultPlan.from_env() is None and jfi.FaultPlan.from_env() is None


# -- the fire sequence -----------------------------------------------------------

SELECTOR_VALUES = {
    "patient": ["PGBM-0001", "PGBM-0002", None],
    "stem": ["1-01", "1-02", "1-03", None],
    "index": [0, 1, 2, 3, None],
    "lane": [0, 1, None],
}

# rules over every site, with each selector alone and together, and the
# after/count/rate budgets alone and combined
GRID = [
    [{"site": "decode", "kind": "error", "stem": "1-02"}],
    [{"site": "decode", "kind": "corrupt", "patient": "PGBM-0002", "after": 2}],
    [{"site": "decode", "kind": "error", "count": 3},
     {"site": "decode", "kind": "corrupt", "rate": 0.4}],
    [{"site": "dispatch", "kind": "transient", "count": 2},
     {"site": "dispatch", "kind": "hang", "index": 2, "hang_s": 0.0}],
    [{"site": "dispatch", "kind": "hang", "lane": 1, "after": 3, "count": 2}],
    [{"site": "dispatch", "kind": "transient", "rate": 0.3, "lane": 0}],
    [{"site": "export", "kind": "io_error", "stem": "1-03", "count": 4},
     {"site": "export", "kind": "sigterm", "after": 5}],
    [{"site": "export", "kind": "io_error", "patient": "PGBM-0001", "rate": 0.5,
      "after": 2, "count": 3}],
    [{"site": "ingest", "kind": "decode_error", "index": 1},
     {"site": "ingest", "kind": "stall", "after": 2, "hang_s": 0.5}],
    [{"site": "cache", "kind": "corrupt_entry", "stem": "1-01", "count": 1}],
    [{"site": "volume", "kind": "dispatch_error", "lane": 0},
     {"site": "volume", "kind": "dispatch_error", "index": 3}],
    [{"site": "fleet", "kind": "replica_unreachable", "stem": "1-02"},
     {"site": "fleet", "kind": "proxy_io_error", "index": 2, "rate": 0.7}],
]


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("case", range(len(GRID)))
def test_fire_sequence_equal_call_for_call(case, seed):
    rules = GRID[case]
    spec = {"seed": seed, "faults": rules}
    jp, pp = _both(spec)
    rng = np.random.default_rng(1000 * case + seed)
    site = rules[0]["site"]
    sites = [site, site, site, "decode", "export"]
    kinds = sorted({r["kind"] for r in rules})
    fired = 0
    for _ in range(120):
        kw = {k: v[int(rng.integers(len(v)))] for k, v in SELECTOR_VALUES.items()}
        check_site = sites[int(rng.integers(len(sites)))]
        mode = int(rng.integers(3))
        extra = {}
        if mode == 1:
            extra["lane_only"] = True
        elif mode == 2:
            extra["kinds"] = (kinds[int(rng.integers(len(kinds)))],)
        jr = jp.fire(check_site, **kw, **extra)
        pr = pp.fire(check_site, **kw, **extra)
        ji = None if jr is None else jp.rules.index(jr)
        pi = None if pr is None else pp.rules.index(pr)
        assert pi == ji, (kw, check_site, extra)
        fired += pi is not None
    assert pp.fired_total() == jp.fired_total() == fired
    assert fired > 0  # every case of the grid fires somewhere on its checks


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_draw_is_the_jax_packages(seed):
    rule_j = jfi.FaultRule(site="decode", kind="error", rate=0.5).validate()
    rule_p = fi.FaultRule(site="decode", kind="error", rate=0.5).validate()
    jp, pp = jfi.FaultPlan([rule_j], seed=seed), fi.FaultPlan([rule_p], seed=seed)
    draws = []
    for i in range(64):
        args = (0, None, f"1-{i:02d}", i, i % 3)
        assert pp._draw(0, rule_p, *args[1:]) == jp._draw(0, rule_j, *args[1:])
        draws.append(pp._draw(0, rule_p, *args[1:]))
    assert 0 < sum(draws) < 64


def test_routes_decode_probe_has_no_side_effect():
    spec = {"faults": [{"site": "decode", "kind": "error", "stem": "1-02", "count": 1},
                       {"site": "export", "kind": "io_error"}]}
    jp, pp = _both(spec)
    for stem in ("1-01", "1-02"):
        for _ in range(3):
            assert pp.routes_decode(stem=stem) == jp.routes_decode(stem=stem) == (stem == "1-02")
    assert pp.fire("decode", stem="1-02") is pp.rules[0]
    assert pp.fire("decode", stem="1-02") is None  # count 1: spent by the fire, not the probes


def test_a_fire_is_counted_and_logged():
    pp = fi.FaultPlan.from_spec({"faults": [{"site": "dispatch", "kind": "transient"}]})
    jp = jfi.FaultPlan.from_spec({"faults": [{"site": "dispatch", "kind": "transient"}]})
    obs, jobs = RunContext.create(driver="test"), JaxRunContext.create(driver="test")
    for _ in range(3):
        pp.fire("dispatch", obs=obs, index=1, lane=0)
        jp.fire("dispatch", obs=jobs, index=1, lane=0)
    got = obs.registry.get("resilience_faults_injected_total", site="dispatch",
                           kind="transient").value
    want = jobs.registry.get("resilience_faults_injected_total", site="dispatch",
                             kind="transient").value
    assert got == want == 3
    assert [e for e in obs.events.tail if e["event"] == "fault_injected"][-1]["index"] == 1


# -- the fault actions -----------------------------------------------------------


@pytest.mark.parametrize("n", [0, 10, 191, 192, 300, 4096])
@pytest.mark.parametrize("seed,key", [(0, ""), (7, "1-03"), (99, "PGBM-0002/1-17")])
def test_corrupt_bytes_byte_identical(n, seed, key):
    raw = np.random.default_rng(n + seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()
    got = fi.corrupt_bytes(raw, seed, key)
    assert got == jfi.corrupt_bytes(raw, seed, key)
    if n > 400:
        assert got != raw[: len(got)] and len(got) == max(192, n // 2)


def test_execute_hang_honours_cancel():
    rule = fi.FaultRule(site="dispatch", kind="hang", hang_s=30.0).validate()
    cancel = threading.Event()
    threading.Timer(0.1, cancel.set).start()
    with pytest.raises(fi.FaultAbandoned):
        fi.execute_hang(rule, cancel)
    fi.execute_hang(fi.FaultRule(site="dispatch", kind="hang", hang_s=0.0).validate())


def test_injected_errors_classify_like_the_jax_packages():
    from nm03_capstone_project_tpu_torch.resilience import is_retryable

    assert is_retryable(fi.InjectedTransientError("x"))
    assert not is_retryable(fi.InjectedDecodeError("x"))
    assert isinstance(fi.InjectedExportError("x"), OSError)
    for name in ("InjectedDecodeError", "InjectedExportError", "InjectedTransientError",
                 "FaultAbandoned"):
        assert [k.__name__ for k in getattr(fi, name).__mro__] == [
            k.__name__ for k in getattr(jfi, name).__mro__]
