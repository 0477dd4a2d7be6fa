"""The program's stage spans in a traced pass: the merge, the readers, and
on the card the clock they share with the device's records.

The card test is marked ``cuda`` and skips where no CUDA device is
visible; run it on the card with ``python3 -m pytest --noconftest
portbench/tests/test_program.py -m cuda -q``.
"""

from __future__ import annotations

import json
import types

import pytest

from portbench import catalog, harness, program, trace
from portbench.tests.test_harness import _Ev, _Prof
from portbench.tests.tiny import tiny_root  # noqa: F401 (a fixture)


def _pass():
    """A made-up pass of two studies (ns): a slice-like entry, then a
    volume-like one with two growth blocks and a sync between them. Its
    loop spans, the program's spans, and the device's records."""
    loop = [(0, 2000, trace.PASS), (0, 100, "portbench.stage"),
            (200, 300, "portbench.dispatch"), (300, 400, "portbench.fetch"),
            (1000, 1100, "portbench.stage"), (1200, 1600, "portbench.dispatch"),
            (1600, 1900, "portbench.wait")]
    prog = [(205, 295, "entry", -1), (206, 209, "inputs", 0), (210, 230, "seeds", 0),
            (240, 280, "grow", 0), (282, 292, "morph", 0),
            (1205, 1590, "entry", -1), (1210, 1300, "grow3d", 5), (1210, 1250, "grow3d.block", 6),
            (1250, 1290, "grow3d.sync", 6), (1290, 1300, "grow3d.block", 6),
            (1400, 1500, "morph", 5)]
    events = [_Ev("Memcpy HtoD (Pinned -> Device)", 100, 200),
              _Ev("Memcpy HtoD (Pinned -> Device)", 100, 150),
              _Ev("void seed_kernel(int)", 215, 220), _Ev("void grow_kernel(int)", 245, 250),
              _Ev("void morph_kernel(int)", 285, 310),
              _Ev("Memcpy DtoH (Device -> Pinned)", 310, 330),
              _Ev("Memcpy HtoD (Pinned -> Device)", 1000, 1100),
              _Ev("Memcpy HtoD (Pinned -> Device)", 1000, 1050),
              _Ev("void block_kernel(int)", 1220, 1255),
              _Ev("Memcpy DtoH (Device -> Pageable)", 1285, 1288),
              _Ev("void block_kernel(int)", 1295, 1320), _Ev("void morph_kernel(int)", 1450, 1460),
              _Ev("Memcpy DtoH (Device -> Pinned)", 1620, 1630)]
    return loop, prog, events


def _program(prog, counters=None, studies=2, launches=None):
    loop, _, events = _pass()
    device = program.device_records(_Prof(events), 0, 2000)
    return program.Program(prog, counters or {}, studies, launches or {},
                           program.idle_by_span(device, loop, prog, 0, 2000))


def _view(t, prog):
    return types.SimpleNamespace(trace=t, program=prog)


# the made-up pass's idle time (1,662 of 2,000 ns) by the innermost span
# over each instant
IDLE_NS = {"stage": 100, "dispatch": 20, "dispatch/entry": 189, "dispatch/inputs": 3,
           "dispatch/seeds": 15, "dispatch/grow": 35, "dispatch/morph": 93,
           "dispatch/grow3d.block": 15, "dispatch/grow3d.sync": 32, "fetch": 70,
           "loop": 800, "wait": 290}


def test_the_breakdown_splits_what_dispatch_read_and_keeps_the_rest():
    loop, prog, events = _pass()
    before = trace.summarize(_Prof(events), 2, frozenset(), loop)
    after = trace.summarize(_Prof(events), 2, frozenset(), program.merge(loop, prog))
    assert before.busy_s == after.busy_s and after.complete
    split = {k: v for k, v in after.idle_by_host.items() if k.startswith("dispatch")}
    assert sum(split.values()) == pytest.approx(before.idle_by_host["dispatch"])
    # each gap goes to the innermost span where it begins; the entry's own
    # time stays the harness's `dispatch`
    assert split == pytest.approx({"dispatch": 145e-9, "dispatch/seeds": 25e-9,
                                   "dispatch/grow": 35e-9, "dispatch/grow3d.sync": 37e-9,
                                   "dispatch/morph": 160e-9})
    rest = {k: v for k, v in after.idle_by_host.items() if not k.startswith("dispatch")}
    assert rest == pytest.approx({k: v for k, v in before.idle_by_host.items()
                                  if k != "dispatch"})


def test_the_idle_split_by_instant_conserves_the_card_s_idle_time():
    loop, prog, events = _pass()
    p = _program(prog)
    assert p.idle_s == pytest.approx({k: v * 1e-9 for k, v in IDLE_NS.items()})
    t = trace.summarize(_Prof(events), 2, frozenset(), program.merge(loop, prog))
    view = _view(t, p)
    launch = catalog.reader(catalog.ROOT, "launch_idle_pct")(view)
    sync = 100.0 * p.idle_s["dispatch/grow3d.sync"] / t.window_s
    own = 100.0 * sum(v for k, v in p.idle_s.items() if "/" not in k) / t.window_s
    # launching + waiting on a sync + the harness's own spans = the whole
    assert launch == pytest.approx(100.0 * 350 / 2000)
    whole = catalog.reader(catalog.ROOT, "device_idle_pct")(view)
    assert launch + sync + own == pytest.approx(whole)


def test_the_merge_keeps_the_loop_s_spans_and_leaves_the_entry_out():
    loop, prog, _ = _pass()
    merged = program.merge(loop, prog)
    assert merged[:len(loop)] == loop
    assert [n for _, _, n in merged[len(loop):]] == [
        "portbench.dispatch/" + n for _, _, n, _ in prog if n != "entry"]


def test_each_new_reader_on_a_made_up_run():
    loop, prog, events = _pass()
    t = trace.summarize(_Prof(events), 2, frozenset(), program.merge(loop, prog))
    view = _view(t, _program(prog, {"grow3d.steps": 32, "grow3d.syncs": 2}))
    read = lambda name, run=view: catalog.reader(catalog.ROOT, name)(run)  # noqa: E731
    # the entries' 90 + 385 ns, less the 40 ns sync under the second
    assert read("entry_launch_ms_per_study") == pytest.approx((90 + 385 - 40) * 1e-6 / 2)
    assert read("grow3d_sync_ms_per_study") == pytest.approx(40e-6 / 2)
    assert read("grow3d_steps_per_study") == 16
    assert read("launch_idle_pct") == pytest.approx(17.5)
    # a pass with no growth: the growth's readers read nothing
    flat = _view(t, _program(prog[:5], studies=1))
    assert read("grow3d_steps_per_study", flat) is None
    assert read("grow3d_sync_ms_per_study", flat) is None
    assert read("entry_launch_ms_per_study", flat) == pytest.approx(90e-6)
    # a run that carries no program spans (a program without the recorder,
    # or the harness's own view): every new reader reads nothing
    for run in (_view(t, None), types.SimpleNamespace(trace=t)):
        for name in ("entry_launch_ms_per_study", "launch_idle_pct",
                     "grow3d_steps_per_study", "grow3d_sync_ms_per_study"):
            assert read(name, run) is None


def test_the_block_counts_spans_counters_and_launches_a_study():
    _, prog, _ = _pass()
    b = _program(prog, {"grow3d.steps": 32}, launches={"fused": 2, "grow": 0}).block()
    assert b["studies"] == 2
    assert b["spans"]["entry"] == {"count": 2, "host_ms_per_study": pytest.approx(475e-6 / 2)}
    assert b["spans"]["grow3d.block"]["count"] == 2
    assert b["counters"] == {"grow3d.steps": 16}
    assert b["launches_per_study"] == {"fused": 1, "grow": 0}
    assert list(b["idle_s"])[0] == "loop"
    json.dumps(b)


@pytest.mark.parametrize("entry", ["process_batch", "process_volume"])
def test_a_cpu_pass_records_every_study_s_stages(tiny_root, entry):
    traffic = tiny_root / "portbench" / "traffic" / "tiny_mix.json"
    mix = json.loads(traffic.read_text())
    traffic.write_text(json.dumps(dict(mix, entry=entry)))
    h = harness.Harness(catalog.cell("tiny.cell", tiny_root), 5, "cpu")
    h.drive(studies=2, sample=False)
    summary, prog, device = program.traced_pass(h, 3)
    assert summary is None and device == []  # no device records on the CPU
    names = [n for _, _, n, _ in prog.spans]
    assert names.count("entry") == 3 and prog.studies == 3
    if entry == "process_volume":
        assert prog.counters["grow3d.syncs"] * 16 == prog.counters["grow3d.steps"] > 0
        assert names.count("grow3d.sync") == prog.counters["grow3d.syncs"]
    else:
        assert prog.counters == {} and names.count("seeds") == 3
    # the timed loop that follows records nothing
    h.drive(studies=2, sample=False)
    assert [n for _, _, n, _ in prog.spans].count("entry") == 3


@pytest.fixture()
def card():
    import torch

    from portbench.run import point_caches

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the shared clock is the card's trace")
    point_caches()
    return "cuda"


@pytest.mark.cuda
def test_every_sync_span_holds_the_end_of_the_read_it_waited_on(card):
    """On the wall clock of the profiler's records: each ``grow3d.sync``
    span holds the end of a device record (the popcount's copy to the host
    it waited on), and no device record runs at the span's end."""
    import bisect

    cell = catalog.cell("brats240.study_volume")
    h = harness.Harness(cell, 2**31 + 77, card)
    h.drive(studies=harness.WARM_STUDIES, sample=False)
    h.warm_profiler()
    summary, prog, device = program.traced_pass(h, 6)
    assert summary is not None and summary.complete
    syncs = [(s, e) for s, e, n, _ in prog.spans if n == program.SYNC]
    assert len(syncs) == prog.counters["grow3d.syncs"] > 0
    assert prog.counters["grow3d.syncs"] * cell["config"]["pipeline"]["grow_block_iters"] == \
        prog.counters["grow3d.steps"]
    ends = sorted(e for _, e, _ in device)
    for s, e in syncs:
        i = bisect.bisect_left(ends, s)
        assert i < len(ends) and ends[i] <= e, (s, e)
        assert not [r for r in device if r[0] < e < r[1]], (s, e)
