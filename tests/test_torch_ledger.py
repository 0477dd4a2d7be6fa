"""The port's device-time ledger held against the JAX package's.

* the same chunk stream (made from a numpy seed) charged into both ledgers
  gives equal accounts and per-request sums, and the accounts conserve the
  busy seconds charged;
* ``reduce_trace_events`` gives equal per-stage self time on the same
  synthetic Chrome-trace event lists (nested events, equal starts);
* the port's stage map — hand-written kernels by name, the ops around them
  by their position in a recorded kernel sequence — on synthetic card
  traces (a graph replay, a re-capture whose sequence differs) and on a CPU
  ``torch.profiler`` capture of the plain pipeline.
"""

import base64
import gzip
import io
import json
import math
import pathlib
import sys
import threading
import zipfile

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from nm03_capstone_project_tpu.obs import ledger as jledger  # noqa: E402
from nm03_capstone_project_tpu.obs import metrics as jmetrics  # noqa: E402
from nm03_capstone_project_tpu_torch.config import PipelineConfig  # noqa: E402
from nm03_capstone_project_tpu_torch.obs import ledger, metrics  # noqa: E402
from nm03_capstone_project_tpu_torch.pipeline.slice_pipeline import _process  # noqa: E402
from nm03_capstone_project_tpu_torch.serving.graphs import record_kernel_sequence  # noqa: E402
from nm03_capstone_project_tpu_torch.utils import profiling  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _chunks(seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(300):
        rows = int(rng.choice([1, 2, 4, 8, 16]))
        real = int(rng.integers(0, rows + 1))
        probe = int(rng.integers(0, rows - real + 1)) if rng.uniform() < 0.2 else 0
        out.append((float(rng.lognormal(-5.0, 1.0)), rows, real, probe))
    return out


def _charge(module, reg_cls, chunks):
    reg = reg_cls()
    led = module.DeviceTimeLedger(registry=reg)
    for busy, rows, real, probe in chunks:
        share = led.charge_chunk(busy, rows, real, probe_rows=probe)
        for _ in range(real):
            led.observe_request(share)
        led.observe_request(0.0)  # a deduplicated rider
    snap = led.publish()
    series = {(m.name, tuple(sorted(m.labels.items()))):
              (m.cumulative() if m.kind == "histogram" else m.value) for m in reg.series()}
    return snap, series


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accounts_equal_and_conserve(seed):
    chunks = _chunks(seed)
    (snap, series), (jsnap, jseries) = (_charge(ledger, metrics.MetricsRegistry, chunks),
                                        _charge(jledger, jmetrics.MetricsRegistry, chunks))
    assert snap["accounts"] == jsnap["accounts"]
    assert snap["requests"] == jsnap["requests"]
    assert snap["device_seconds_total"] == jsnap["device_seconds_total"]
    assert series == jseries
    busy = sum(c[0] for c in chunks)
    assert math.isclose(snap["device_seconds_total"], busy, rel_tol=1e-9, abs_tol=1e-9)
    # the port keeps the JAX key set, with one key of its own among the samples
    assert set(snap) == set(jsnap)
    assert set(snap["profile_samples"]) == set(jsnap["profile_samples"]) | {"unmatched_ops"}
    assert ledger.ACCOUNTS == jledger.ACCOUNTS and ledger.STAGES == jledger.STAGES
    assert ledger.DEVICE_SECONDS_BUCKETS == jledger.DEVICE_SECONDS_BUCKETS


def _nested_events(seed: int):
    """Synthetic device timelines: nested and sibling ops on two threads,
    equal start times, zero-duration and host (no hlo_op) events."""
    rng = np.random.default_rng(seed)
    evs = []
    for tid in (1, 2):
        t = 0.0
        for i in range(40):
            dur = float(rng.uniform(5, 50))
            op = f"op{tid}_{i}"
            evs.append({"ph": "X", "pid": 7, "tid": tid, "ts": t, "dur": dur,
                        "args": {"hlo_op": op}})
            if i % 3 == 0:  # a child at the parent's start, and one inside
                evs.append({"ph": "X", "pid": 7, "tid": tid, "ts": t, "dur": dur / 3,
                            "args": {"hlo_op": f"{op}c"}})
                evs.append({"ph": "X", "pid": 7, "tid": tid, "ts": t + dur / 2,
                            "dur": dur / 4, "args": {"hlo_op": f"%{op}d"}})
            t += dur + float(rng.uniform(0, 5))
        evs.append({"ph": "X", "pid": 7, "tid": tid, "ts": 1.0, "dur": 0.0,
                    "args": {"hlo_op": "zero"}})
        evs.append({"ph": "X", "pid": 7, "tid": tid, "ts": 2.0, "dur": 9.0, "args": {}})
        evs.append({"ph": "i", "pid": 7, "tid": tid, "ts": 3.0})
    stages = list(ledger.STAGES) + ["other"]
    stage_of = {e["args"]["hlo_op"].lstrip("%"): stages[int(rng.integers(len(stages)))]
                for e in evs if e.get("args", {}).get("hlo_op")}
    return evs, stage_of


@pytest.mark.parametrize("seed", [0, 5])
def test_reduce_trace_events_equal(seed):
    evs, stage_of = _nested_events(seed)
    got = ledger.reduce_trace_events(evs, stage_of)
    assert got == jledger.reduce_trace_events(evs, stage_of)
    assert got and all(v > 0 for v in got.values())


def _capture(events, gz: bool) -> dict:
    buf = io.BytesIO()
    doc = json.dumps({"traceEvents": events}).encode()
    with zipfile.ZipFile(buf, "w") as zf:
        if gz:
            zf.writestr("plugins/profile/x/host.trace.json.gz", gzip.compress(doc))
        else:
            zf.writestr("nm03.pt.trace.json", doc)
        zf.writestr("other.pb", b"ignored")
    return {"zip_b64": base64.b64encode(buf.getvalue()).decode()}


@pytest.mark.parametrize("gz", [False, True])
def test_trace_events_from_capture_equal(gz, tmp_path):
    evs, _ = _nested_events(1)
    cap = _capture(evs, gz)
    assert ledger.trace_events_from_capture(cap) == jledger.trace_events_from_capture(cap) == evs
    path = tmp_path / "kept.zip"
    path.write_bytes(base64.b64decode(cap["zip_b64"]))
    kept = {"zip_dropped": True, "zip_path": str(path)}
    assert ledger.trace_events_from_capture(kept) == evs
    assert ledger.trace_events_from_capture({}) == jledger.trace_events_from_capture({}) == []


def test_hbm_table_publishes_the_kinds_a_graph_has():
    reg = metrics.MetricsRegistry()
    led = ledger.DeviceTimeLedger(registry=reg)
    led.set_bucket_hbm(4, {"argument_bytes": 100, "output_bytes": 20, "temp_bytes": 30,
                           "peak_hbm_bytes": 150, "code_bytes": 9, "alias_bytes": 1})
    led.set_bucket_hbm(8, None)
    snap = led.publish()
    assert snap["hbm_bytes"] == {4: {"argument": 100, "output": 20, "temp": 30, "peak": 150}}
    kinds = {m.labels["kind"] for m in reg.series()
             if m.name == metrics.SERVING_EXECUTABLE_HBM_BYTES}
    assert kinds == {"argument", "output", "temp", "peak"}
    assert {k for _, k in ledger.HBM_KINDS} < {k for _, k in jledger.HBM_KINDS}


def test_sampler_skips_a_busy_lock_like_the_jax_one():
    from nm03_capstone_project_tpu.utils.profiling import ProfileBusy as JaxBusy

    evs, _ = _nested_events(2)
    results = {}
    for name, module, busy_cls in (("port", ledger, profiling.ProfileBusy),
                                   ("jax", jledger, JaxBusy)):
        calls = iter([busy_cls("held"), RuntimeError("no profiler"), _capture(evs, False)])

        def capture(ms, calls=calls):
            item = next(calls)
            if isinstance(item, Exception):
                raise item
            return item

        led = module.DeviceTimeLedger()
        sampler = module.ProfileSampler(led, interval_s=0.0, duration_ms=50, capture=capture)
        outcome = [sampler.sample_once() for _ in range(3)]
        snap = led.snapshot()
        results[name] = (outcome, snap["profile_samples"]["taken"],
                         snap["profile_samples"]["skipped"])
        sampler.start()  # interval 0: no thread
        assert sampler._thread is None
    assert results["port"] == results["jax"] == ([False, False, True], 1, 1)


def test_the_sampler_yields_to_a_held_profiler():
    led = ledger.DeviceTimeLedger()
    sampler = ledger.ProfileSampler(led, interval_s=0.0, duration_ms=20)
    with profiling.exclusive_profiler():
        assert sampler.sample_once() is False
        with pytest.raises(profiling.ProfileBusy):
            profiling.capture_profile(20)
    assert led.snapshot()["profile_samples"]["skipped"] == 1
    with pytest.raises(ValueError):
        profiling.capture_profile(5)
    with pytest.raises(ValueError):
        profiling.capture_profile(20_000)


# -- the port's stage map ----------------------------------------------------------


def _card_run(t0: float, corr0: int, names, stages=None, stream=7, graph=False):
    """Synthetic torch.profiler events of one run on a card: launch calls on
    host thread 1 (inside stage ranges when ``stages`` is given), kernels
    on a stream, linked by correlation ids (one id for a graph replay)."""
    evs = []
    t = t0
    for i, name in enumerate(names):
        corr = corr0 if graph else corr0 + i
        if not graph or i == 0:
            evs.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                        "pid": 1, "tid": 1, "ts": t, "dur": 2.0,
                        "args": {"correlation": corr}})
        if stages is not None:
            evs.append({"ph": "X", "cat": "user_annotation", "name": stages[i], "pid": 1,
                        "tid": 1, "ts": t - 0.5, "dur": 3.0})
        evs.append({"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": stream,
                    "ts": t + 10.0, "dur": 4.0 + i, "args": {"correlation": corr}})
        t += 20.0
    return evs


NAMES = ["void at::native::elementwise_kernel<128>", "fused_kernel<7, 16>",
         "void at::native::index_kernel", "grow_kernel", "void at::native::reduce_kernel",
         "void at::native::elementwise_kernel<128>"]
STAGES = ["normalize", "median7", "grow", "grow", "morph", "morph"]


def test_kernel_sequence_from_stage_ranges():
    seq = ledger.kernel_sequence(_card_run(0.0, 100, NAMES, STAGES))
    assert seq == list(zip(NAMES, STAGES))
    # without ranges, the hand-written kernels still map by name
    bare = ledger.kernel_sequence(_card_run(0.0, 100, NAMES))
    assert [st for _, st in bare] == ["other", "median7", "other", "grow", "other", "other"]
    assert ledger.stage_for_kernel("band_kernel<15>") == "median7"
    assert ledger.stage_for_kernel("void at::native::vectorized_elementwise_kernel") is None


@pytest.mark.parametrize("name, stage", [
    ("(anonymous namespace)::seed_valid_kernel(int const*, unsigned char*, int)", "grow"),
    ("(anonymous namespace)::finish_kernel(unsigned char const*, int const*, int)", "morph"),
    ("void (anonymous namespace)::fused_kernel<7, 16>(float const*)", "median7"),
])
def test_the_hand_written_kernels_map_to_their_stages_by_name(name, stage):
    assert ledger.stage_for_kernel(name) == stage


def test_graph_replays_label_by_position_and_a_recapture_goes_to_other():
    seq = list(zip(NAMES, STAGES))
    replays = (_card_run(1000.0, 500, NAMES, graph=True)
               + _card_run(2000.0, 600, NAMES, graph=True)
               + [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "pid": 0,
                   "tid": 7, "ts": 999.0, "dur": 3.0}])
    labeled, stage_of, unmatched = ledger.label_trace_events(replays, [seq])
    assert unmatched == 0
    got = ledger.reduce_trace_events(labeled, stage_of)
    want = {}
    for (_, st), dur in zip(seq, (4.0 + i for i in range(len(NAMES)))):
        want[st] = want.get(st, 0.0) + 2 * dur / 1e6
    want["other"] = 3.0 / 1e6  # the copy
    assert got.keys() == want.keys()
    assert all(math.isclose(got[k], want[k]) for k in want)
    # a re-captured graph with one op more: its hand-written kernels still
    # map by name, the rest goes to `other` and is counted
    recap = _card_run(3000.0, 700, NAMES[:2] + ["void extra_kernel"] + NAMES[2:], graph=True)
    _, stage_of, unmatched = ledger.label_trace_events(recap, [seq])
    assert unmatched == 5
    assert sorted(stage_of.values()) == sorted(["median7", "grow"] + ["other"] * 5)
    led = ledger.DeviceTimeLedger()
    led.ingest_kernel_sequence(1, seq)
    led.ingest_trace_events(replays + recap)
    snap = led.snapshot()
    assert snap["profile_samples"] == {"taken": 1, "skipped": 0, "unmatched_ops": 5}
    # shares are rounded to 4 places, and never sum past 1
    assert 1.0 - 5e-4 * len(snap["stage_shares"]) <= sum(snap["stage_shares"].values()) <= 1.0
    assert snap["stage_shares"]["median7"] > 0 and snap["stage_shares"]["grow"] > 0


def _cpu_capture(cfg, bucket):
    c = cfg.canvas
    px = torch.zeros((bucket, c, c))
    dm = torch.full((bucket, 2), cfg.min_dim, dtype=torch.int32)
    with profiling.exclusive_profiler() as prof:
        _process(px, dm, cfg)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "t.json"
        prof.export_chrome_trace(str(out))
        return json.loads(out.read_text())["traceEvents"]


@pytest.mark.parametrize("fuse", [True, False])
def test_cpu_capture_of_the_plain_pipeline_maps_every_stage(fuse):
    cfg = PipelineConfig(canvas=64, min_dim=32, fuse_preprocess=fuse)
    seq = record_kernel_sequence(cfg, 2, "cpu")
    stages = {st for _, st in seq}
    want = {"normalize", "median7", "grow", "morph"} | (set() if fuse else {"sharpen"})
    assert want <= stages
    events = _cpu_capture(cfg, 2)
    labeled, stage_of, unmatched = ledger.label_trace_events(events, [seq])
    assert unmatched == 0
    pie = ledger.reduce_trace_events(labeled, stage_of)
    assert want <= set(pie) and all(v >= 0 for v in pie.values())
    # a sequence recorded at another bucket still matches (the ops are the
    # same calls), one missing an op does not: its run goes to `other`
    _, _, unmatched = ledger.label_trace_events(events, [seq[:-1] + [("nope", "morph")]])
    assert unmatched > 0


def test_profiler_records_other_threads():
    cfg = PipelineConfig(canvas=64, min_dim=32)
    px = torch.zeros((1, 64, 64))
    dm = torch.full((1, 2), 32, dtype=torch.int32)
    go, stop = threading.Event(), threading.Event()

    def worker():
        go.set()
        while not stop.is_set():
            _process(px, dm, cfg)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    go.wait()
    try:
        cap = profiling.capture_profile(150)
    finally:
        stop.set()
        t.join()
    assert set(cap) >= {"duration_ms", "files", "zip_b64", "zip_bytes"}
    evs = ledger.trace_events_from_capture(cap)
    assert any(e.get("cat") == "cpu_op" for e in evs)
