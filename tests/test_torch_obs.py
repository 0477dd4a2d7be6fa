"""The port's copies of the observability modules, pinned to the JAX package's.

The same operations on the two packages' metrics registries give the same
snapshot (less its timestamp) and the same Prometheus text; the port's
event log and metrics snapshot pass ``scripts/check_telemetry.py``; its
flight recorder writes the JAX package's dump schema; its span recorder
feeds the same stage histogram; its trace contexts record the same span
layout; and its retry policy sleeps the same deterministic schedule.
"""

import json
import pathlib
import subprocess
import sys
import threading

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from nm03_capstone_project_tpu.obs import flightrec as jax_flightrec  # noqa: E402
from nm03_capstone_project_tpu.obs import metrics as jax_metrics  # noqa: E402
from nm03_capstone_project_tpu.obs import trace as jax_trace  # noqa: E402
from nm03_capstone_project_tpu.resilience import policy as jax_policy  # noqa: E402
from nm03_capstone_project_tpu_torch.obs import flightrec, metrics, trace  # noqa: E402
from nm03_capstone_project_tpu_torch.obs.run import RunContext  # noqa: E402
from nm03_capstone_project_tpu_torch.obs.spans import SpanRecorder  # noqa: E402
from nm03_capstone_project_tpu_torch.resilience import (  # noqa: E402
    DeadlineExceeded,
    DispatchSupervisor,
    ResilienceConfig,
    RetryPolicy,
    TransientDeviceError,
    policy,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
CHECKER = REPO / "scripts" / "check_telemetry.py"


def _drive(reg):
    reg.counter("serving_requests_total", help="h", status="ok").inc(3)
    reg.counter("serving_requests_total", help="h", status="shed").inc()
    reg.gauge("serving_lanes_ready", help="g").set(1)
    reg.gauge("serving_inflight", help="g").inc(2.5)
    h = reg.histogram("serving_request_seconds", help="lat", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    reg.gauge("serving_lane_state", lane="0").set(2)
    return reg


class TestMetricsRegistry:
    def test_snapshot_and_prometheus_equal_the_jax_registry(self):
        a = _drive(metrics.MetricsRegistry())
        b = _drive(jax_metrics.MetricsRegistry())
        sa, sb = a.snapshot(run_id="r", git_sha="g"), b.snapshot(run_id="r", git_sha="g")
        sa.pop("created_unix"), sb.pop("created_unix")
        assert sa == sb
        assert a.to_prometheus() == b.to_prometheus()
        assert a.counter_totals() == b.counter_totals()
        assert metrics.SCHEMA_METRICS == jax_metrics.SCHEMA_METRICS

    @pytest.mark.parametrize("bad", [
        lambda r: r.counter("bad name"),
        lambda r: r.counter("x", **{"bad-label": "v"}),
        lambda r: r.counter("x").inc(-1),
        lambda r: (r.counter("y"), r.gauge("y")),
        lambda r: r.histogram("z", buckets=(2.0, 1.0)),
        lambda r: r.histogram("w", buckets=(1.0, float("inf"))),
    ])
    def test_rejects_what_the_jax_registry_rejects(self, bad):
        for reg in (metrics.MetricsRegistry(), jax_metrics.MetricsRegistry()):
            with pytest.raises(ValueError):
                bad(reg)

    def test_concurrent_increments_are_not_lost(self):
        reg = metrics.MetricsRegistry()
        prev = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            def work():
                for _ in range(2000):
                    reg.counter("c", lane="0").inc()
                    reg.histogram("h", buckets=(1.0,)).observe(0.5)

            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(prev)
        assert reg.get("c", lane="0").value == 16000
        assert reg.get("h").count == 16000


class TestRunTelemetry:
    def test_events_and_metrics_pass_the_schema_check(self, tmp_path):
        events, snap = tmp_path / "e.jsonl", tmp_path / "m.json"
        ctx = RunContext.create("serve", metrics_out=snap, log_json=events, argv=["x"])
        ctx.retry(cause="serve_dispatch", attempt=1, error_class="TransientDeviceError")
        ctx.degraded(cause="deadline", site="serve_fleet")
        with ctx.spans.span("encode/a"):
            pass
        ctx.events.emit("serving_drain", level="WARNING", reason="test")
        ctx.close()
        res = subprocess.run(
            [sys.executable, str(CHECKER), "--events", str(events), "--metrics", str(snap),
             "--expect-counter", "resilience_retries_total=1",
             "--expect-counter", "pipeline_degraded_total=1",
             "--expect-histogram", "nm03_stage_latency_seconds=1"],
            capture_output=True, text=True, timeout=60,
        )
        assert res.returncode == 0, res.stdout + res.stderr
        records = [json.loads(line) for line in events.read_text().splitlines()]
        assert [r["event"] for r in records][0] == "run_started"
        assert [r["event"] for r in records][-1] == "run_finished"

    def test_span_recorder(self):
        reg = metrics.MetricsRegistry()
        s = SpanRecorder(registry=reg)
        with s.span("load/p1"):
            with s.section("load/p2"):
                assert s.current_path() == "load/p1/load/p2" and s.depth == 2
        assert set(s.report()) == {"load/p1", "load/p2"} and s.depth == 0
        assert reg.get(metrics.STAGE_LATENCY_METRIC, stage="load").count == 2


class TestTraceAndFlightRecorder:
    def test_span_records_have_the_jax_layout(self):
        ctx, jctx = trace.TraceContext("t1"), jax_trace.TraceContext("t1")
        for c in (ctx, jctx):
            with c.span("encode", lane=0):
                pass
        a, b = ctx.snapshot()[0], jctx.snapshot()[0]
        assert set(a) == set(b)
        assert (a["name"], a["lane"], a["riders"], a["trace_ids"]) == ("encode", 0, 1, ["t1"])
        chunk = trace.ChunkTrace([trace.TraceContext("a"), trace.TraceContext("b")], lane=0)
        with chunk.span("device_dispatch", attempt=1):
            pass
        rec = chunk.contexts[0].snapshot()[0]
        assert rec["riders"] == 2 and rec["trace_ids"] == ["a", "b"] and rec["attempt"] == 1
        assert chunk.contexts[1].snapshot()[0] is rec

    def test_flight_recorder_dump_schema(self, tmp_path):
        rec = flightrec.FlightRecorder(ring=4)
        for i in range(10):
            rec.note("mark", "m", i=i)
        rec.configure(str(tmp_path))
        path = rec.auto_dump("lane0_quarantine_deadline")
        dump = json.loads(pathlib.Path(path).read_text())
        assert dump["schema"] == jax_flightrec.SCHEMA_FLIGHT
        (records,) = dump["threads"].values()
        assert [r["i"] for r in records] == [6, 7, 8, 9]  # the ring keeps the last 4
        jax_dump = jax_flightrec.FlightRecorder().snapshot()
        assert set(dump) == set(jax_dump)


class TestResilience:
    def test_retry_schedule_equals_the_jax_policy(self):
        a = RetryPolicy(retry_max=3, seed=7)
        b = jax_policy.RetryPolicy(retry_max=3, seed=7)
        for cause in ("serve_dispatch", "serve_probe"):
            for attempt in (1, 2, 3, 4):
                assert a.delay_s(cause, attempt) == b.delay_s(cause, attempt)

    def test_retryable_classification(self):
        class AcceleratorError(RuntimeError):
            pass

        assert policy.is_retryable(TransientDeviceError("x"))
        assert policy.is_retryable(AcceleratorError("CUDA error"))
        assert not policy.is_retryable(ValueError("x"))
        assert not policy.is_retryable(RuntimeError("x"))

    def test_supervisor_retries_then_succeeds_inline_and_supervised(self):
        for timeout in (0.0, 5.0):
            calls = []

            def flaky():
                calls.append(1)
                if len(calls) < 2:
                    raise TransientDeviceError("once")
                return "ok"

            sup = DispatchSupervisor(ResilienceConfig(retry_max=2, retry_backoff_s=0.001,
                                                      dispatch_timeout_s=timeout))
            assert sup.run(flaky) == "ok" and len(calls) == 2

    def test_supervisor_deadline_and_deterministic_errors(self):
        import time

        sup = DispatchSupervisor(ResilienceConfig(dispatch_timeout_s=0.2))
        with pytest.raises(DeadlineExceeded):
            sup.run(lambda: time.sleep(2.0))
        with pytest.raises(KeyError):
            sup.run(lambda: {}["missing"])  # raised as it is, never retried
        exhausted = DispatchSupervisor(ResilienceConfig(retry_max=1, retry_backoff_s=0.001))
        with pytest.raises(TransientDeviceError):
            exhausted.run(lambda: (_ for _ in ()).throw(TransientDeviceError("always")))
