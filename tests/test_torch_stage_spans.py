"""The pipeline's stage spans and counters (``pipeline.stage_spans``).

One hook names each stage of ``process_batch`` and ``process_volume``:
under ``stage_spans(recorder)`` it records every stage as a nested span
and counts the 3D growth's steps and syncs; under ``stage_ranges()`` it
opens the device-time ledger's ranges as before; with neither open it
adds nothing to the call: no tensor op, no sync, no allocation.
"""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nm03_capstone_project_tpu_torch.config import PipelineConfig
from nm03_capstone_project_tpu_torch.data.synthetic import phantom_volume
from nm03_capstone_project_tpu_torch.obs import ledger
from nm03_capstone_project_tpu_torch.obs.spans import StageRecorder
from nm03_capstone_project_tpu_torch.pipeline import process_batch, process_volume, stage_spans
from nm03_capstone_project_tpu_torch.pipeline import slice_pipeline as sp
from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import _process, stage_ranges
from nm03_capstone_project_tpu_torch.pipeline.volume_pipeline import (
    grow_volume,
    volume_grow_inputs,
)

C = 64


def _volume():
    v = torch.zeros(8, C, C)
    v[:, :60, :56] = torch.as_tensor(phantom_volume(8, 60, 56, seed=3))
    return v, torch.tensor([60, 56], dtype=torch.int32)


def _run(entry, cfg):
    v, dm = _volume()
    if entry == "batch":
        return process_batch(v, dm.expand(v.shape[0], 2), cfg, device="cpu")
    return process_volume(v, dm, cfg, device="cpu")


def _recorded(entry, cfg):
    rec = StageRecorder()
    with stage_spans(rec):
        out = _run(entry, cfg)
    return rec, out


class _Ops(TorchDispatchMode):
    """Every ATen op dispatched, by name (``_local_scalar_dense`` is a
    read of a tensor's value on the host: a sync on the card)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


CASES = [("batch", {}), ("batch", {"fuse_preprocess": False}),
         ("volume", {}), ("volume", {"grow_algorithm": "jump"})]


@pytest.mark.parametrize("entry,kw", CASES)
def test_without_a_recorder_nothing_is_recorded_and_the_outputs_are_the_same(entry, kw):
    cfg = PipelineConfig(canvas=C, **kw)
    idle = StageRecorder()
    off = _run(entry, cfg)
    rec, on = _recorded(entry, cfg)
    assert idle.spans == [] and idle.counters == {}
    assert rec.spans and getattr(sp._hooks, "state", None) is None
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k


# (name, parent's name) of every span of one call, in the order they begin
BATCH_FUSED = [("entry", None), ("inputs", "entry"), ("normalize", "entry"),
               ("median7", "entry"), ("seeds", "entry"), ("grow", "entry"), ("morph", "entry")]
BATCH_SPLIT = [("entry", None), ("inputs", "entry"), ("normalize", "entry"),
               ("normalize", "entry"), ("median7", "entry"), ("sharpen", "entry"),
               ("seeds", "entry"), ("grow", "entry"), ("morph", "entry")]


def _volume_spans(syncs):
    growth = [("grow3d.block", "grow3d")]
    for _ in range(syncs - 1):
        growth += [("grow3d.sync", "grow3d"), ("grow3d.block", "grow3d")]
    growth += [("grow3d.sync", "grow3d")]
    return ([("entry", None), ("inputs", "entry"), ("normalize", "entry"),
             ("median7", "entry"), ("seeds", "entry"), ("grow3d", "entry")]
            + growth + [("morph", "entry")])


@pytest.mark.parametrize("entry,kw", CASES)
def test_the_spans_nest_as_the_stages_do(entry, kw):
    cfg = PipelineConfig(canvas=C, **kw)
    rec, _ = _recorded(entry, cfg)
    got = [(n, rec.spans[p][2] if p >= 0 else None) for _, _, n, p in rec.spans]
    if entry == "batch":
        assert got == (BATCH_FUSED if not kw else BATCH_SPLIT)
        assert rec.counters == {}
    else:
        assert got == _volume_spans(rec.counters["grow3d.syncs"])
    for i, (s, e, _, p) in enumerate(rec.spans):
        assert s <= e
        if p >= 0:
            ps, pe, _, _ = rec.spans[p]
            assert p < i and ps <= s and e <= pe
    # siblings one after another, and each call's spans under its entry
    assert rec.path(len(rec.spans) - 1) == "entry/morph"
    assert all(rec.path(i).startswith("entry") for i in range(len(rec.spans)))


@pytest.mark.parametrize("algorithm,steps_a_sync", [("dilate", 16), ("jump", 1)])
def test_the_counters_are_the_growth_s_own_steps_and_syncs(algorithm, steps_a_sync):
    cfg = PipelineConfig(canvas=C, grow_algorithm=algorithm)
    v, dm = _volume()
    pre, seeds, valid = volume_grow_inputs(v, dm, cfg)
    _, _, steps = grow_volume(pre, seeds, valid, cfg, return_steps=True)
    rec, _ = _recorded("volume", cfg)
    assert rec.counters["grow3d.steps"] == steps > 0
    assert rec.counters["grow3d.syncs"] * steps_a_sync == steps
    assert rec.counters["grow3d.syncs"] == sum(n == "grow3d.sync" for _, _, n, _ in rec.spans)
    # one host read of the card a sync, and no other in the growth
    with _Ops() as ops:
        grow_volume(pre, seeds, valid, cfg)
    assert ops.ops.count("aten._local_scalar_dense") == rec.counters["grow3d.syncs"]


@pytest.mark.parametrize("entry,kw", CASES)
def test_the_spans_add_no_tensor_op_and_no_sync(entry, kw):
    cfg = PipelineConfig(canvas=C, **kw)
    _run(entry, cfg)
    with _Ops() as off:
        _run(entry, cfg)
    rec = StageRecorder()
    with _Ops() as on, stage_spans(rec):
        _run(entry, cfg)
    assert rec.spans and off.ops == on.ops


# one growth's counts as the 3D grow kernel gives them, twice over
COUNTS = [("grow3d.launches", 1), ("grow3d.syncs", 0), ("grow3d.blocks", 3),
          ("grow3d.steps", 48), ("grow3d.launches", 1), ("grow3d.syncs", 0),
          ("grow3d.blocks", 2), ("grow3d.steps", 32)]


@pytest.mark.parametrize("tensors", [(), ("grow3d.steps",), ("grow3d.steps", "grow3d.blocks"),
                                     ("grow3d.launches", "grow3d.syncs", "grow3d.blocks",
                                      "grow3d.steps")])
def test_tensor_counts_sum_with_int_counts_to_the_same_totals(tensors):
    rec = StageRecorder()
    for name, value in COUNTS:
        rec.count(name, torch.tensor(value, dtype=torch.int32) if name in tensors else value)
    assert rec.counters == {"grow3d.launches": 2, "grow3d.syncs": 0, "grow3d.blocks": 5,
                            "grow3d.steps": 80}
    assert all(type(v) is int for v in rec.counters.values())


def test_a_tensor_count_stays_unread_until_the_counters_are_read():
    # the kernel's steps are a device value that becomes ready after the
    # call: counting one reads nothing, reading the counters reads it once
    steps = torch.tensor(0, dtype=torch.int32)
    rec = StageRecorder()
    with _Ops() as counting:
        rec.count("grow3d.launches")
        rec.count("grow3d.steps", steps)
        rec.count("grow3d.steps", 16)
    assert counting.ops == []
    steps.fill_(32)  # the value lands after it was counted
    with _Ops() as reading:
        assert rec.counters == {"grow3d.launches": 1, "grow3d.steps": 48}
    assert reading.ops.count("aten._local_scalar_dense") == 1
    with _Ops() as again:
        assert rec.counters == {"grow3d.launches": 1, "grow3d.steps": 48}
    assert again.ops == []
    rec.count("grow3d.steps", torch.tensor(16))
    assert rec.counters["grow3d.steps"] == 64


def test_a_closed_stage_makes_nothing():
    """With nothing open every stage hands back one shared null context and
    a count touches nothing: no object is made a stage."""
    from nm03_capstone_project_tpu_torch.ops.region_growing import no_stage

    names = ["entry", "inputs", "normalize", "median7", "sharpen", "seeds", "grow", "grow3d",
             "grow3d.block", "grow3d.sync", "morph"]
    assert {id(sp._stage(n)) for n in names} == {id(sp._OFF)}
    assert sp._count("grow3d.syncs") is None and getattr(sp._hooks, "state", None) is None
    assert no_stage("grow3d.block") is no_stage("grow3d.sync")


def _range_names(fn, tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = tmp_path / "trace.json"
    prof.export_chrome_trace(str(out))
    events = json.loads(out.read_text())["traceEvents"]
    return [e["name"] for e in events if e.get("cat") == ledger.ANNOTATION_CAT
            and e.get("ph") == "X"]


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("with_spans", [False, True])
def test_under_stage_ranges_the_ranges_are_the_ledger_s_names(fuse, with_spans, tmp_path):
    cfg = PipelineConfig(canvas=C, min_dim=32, fuse_preprocess=fuse)
    px = torch.zeros((2, C, C))
    dm = torch.full((2, 2), 32, dtype=torch.int32)
    rec = StageRecorder()

    def run():
        with stage_ranges(), (stage_spans(rec) if with_spans else sp._OFF):
            _process(px, dm, cfg)

    names = _range_names(run, tmp_path)
    want = {"normalize", "median7", "grow", "morph"} | (set() if fuse else {"sharpen"})
    assert set(names) == want and want <= set(ledger.STAGES)
    # the seed grid and valid mask are the grow stage's, as before
    assert names.count("grow") == 2
    assert bool(rec.spans) == with_spans
    assert _range_names(lambda: _process(px, dm, cfg), tmp_path) == []
