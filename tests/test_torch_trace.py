"""The port's ``nm03-trace`` exporter, held against the JAX package's.

The same recorded JSONL event streams go through both packages'
exporters, which must write equal trace JSON (every comparison is exact):

* one replica's stream: chunk spans shared by several riders, two
  requests under one client trace id, a retry attempt overlapping its
  abandoned predecessor on a lane, a torn last line;
* a fleet router's stream plus two replicas' streams, each process with
  its own clock offset: a proxied request that failed over, a canary
  probe, and a replica stream the router never routed to;
* streams that the port's own server and fleet wrote, over loopback on
  the CPU.

The exporter's CLI (``python -m nm03_capstone_project_tpu_torch.obs.trace``)
gives the JAX CLI's exit codes and files, and its output passes
``scripts/check_telemetry.py --expect-trace`` / ``--expect-fleet-trace``.
"""

import json
import pathlib
import subprocess
import sys
import urllib.request

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402,F401

from nm03_capstone_project_tpu.obs import trace as jax_trace  # noqa: E402
from nm03_capstone_project_tpu_torch.obs import trace  # noqa: E402

CHECKER = REPO / "scripts" / "check_telemetry.py"


def _record(run_id, seq, mono, offset, event, **fields):
    return {"schema": "nm03.events.v1", "run_id": run_id, "git_sha": "g", "seq": seq,
            "ts_unix": round(mono + offset, 6), "mono_s": mono, "level": "INFO",
            "event": event, **fields}


def _span(sid, name, t0, dur, trace_ids, lane=None, **fields):
    return {"id": sid, "name": name, "t0_s": t0, "dur_s": dur, "thread": "t",
            "lane": lane, "riders": len(trace_ids), "trace_ids": list(trace_ids), **fields}


def _write(path, records, torn_tail=False):
    lines = [json.dumps(r) for r in records]
    if torn_tail:
        lines.append('{"schema": "nm03.events.v1", "run_id": "x", "ev')
    path.write_text("\n".join(lines) + "\n")
    return path


def _replica_stream(path, run_id, offset, trace_ids, base=100.0, torn_tail=False):
    """serve_trace records as the server writes them: request spans on no
    lane, chunk spans on a lane shared by the riders of one batch."""
    recs = [_record(run_id, 0, base, offset, "run_started", driver="serve")]
    seq = 1
    chunk = _span(f"{run_id}.c1", "device_dispatch", base + 0.010, 0.0123456, trace_ids[:2],
                  lane=0, attempt=1)
    for i, tid in enumerate(trace_ids):
        t0 = base + 0.001 * i
        spans = [
            _span(f"{run_id}.q{i}", "queue_wait", t0, 0.002, [tid]),
            _span(f"{run_id}.k{i}", "coalesce", t0 + 0.002, 0.003, [tid]),
            chunk if i < 2 else _span(f"{run_id}.d{i}", "device_dispatch", base + 0.030,
                                      0.004, [tid], lane=1, attempt=1),
            _span(f"{run_id}.e{i}", "encode", base + 0.0231, 0.0011, [tid]),
        ]
        recs.append(_record(run_id, seq, base + 0.05 + i, offset, "serve_trace",
                            trace_id=tid, request_id=f"rq-{i}", status=200, spans=spans))
        seq += 1
    # a retry ladder: attempt 1 abandoned, attempt 2 overlapping it on lane 1
    tid = trace_ids[0]
    recs.append(_record(run_id, seq, base + 2.0, offset, "serve_trace", trace_id=tid,
                        request_id="rq-dup", status=200, spans=[
                            _span(f"{run_id}.w", "queue_wait", base + 0.9, 0.1, [tid]),
                            _span(f"{run_id}.a1", "device_dispatch", base + 1.0, 0.5, [tid],
                                  lane=1, attempt=1),
                            _span(f"{run_id}.a2", "device_dispatch", base + 1.2, 0.1, [tid],
                                  lane=1, attempt=2),
                        ]))
    recs.append(_record(run_id, seq + 1, base + 3.0, offset, "run_finished", status="ok"))
    return _write(path, recs, torn_tail=torn_tail)


def _router_stream(path, offset, routed):
    """fleet_trace records as the router writes them: route_pick, proxy_hop
    per attempt and failover on a dead hop, plus a canary probe."""
    recs = [_record("router", 0, 50.0, offset, "run_started", driver="fleet")]
    seq = 1
    for i, (tid, replica, dead) in enumerate(routed):
        t0 = 50.0 + 0.1 * i
        spans = [_span(f"r.p{i}", "route_pick", t0, 0.0001, [tid], attempt=1)]
        if dead:
            spans += [
                _span(f"r.h{i}a", "proxy_hop", t0 + 0.001, 0.02, [tid], replica=dead,
                      outcome="io_error", attempt=1),
                _span(f"r.f{i}", "failover", t0 + 0.021, 0.0001, [tid], replica=dead,
                      cause="io_error"),
                _span(f"r.p{i}b", "route_pick", t0 + 0.0212, 0.0001, [tid], attempt=2),
            ]
        spans.append(_span(f"r.h{i}", "proxy_hop", t0 + 0.03, 0.05, [tid], replica=replica,
                           outcome="ok", attempt=2 if dead else 1))
        recs.append(_record("router", seq, t0 + 0.1, offset, "fleet_trace", trace_id=tid,
                            request_id=f"fl-{i:06d}", replica=replica,
                            replica_hops=1 if dead else 0, status=200, spans=spans))
        seq += 1
    recs.append(_record("router", seq, 60.0, offset, "fleet_trace",
                        trace_id="fleet-probe-h:3-1", request_id="probe-000001",
                        replica="127.0.0.1:3", replica_hops=0, status=200, probe=True,
                        spans=[_span("r.cp", "canary_probe", 59.0, 0.2,
                                     ["fleet-probe-h:3-1"], replica="127.0.0.1:3",
                                     outcome="passed", probe=True)]))
    return _write(path, recs)


def _both(paths, tmp_path):
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    n_mine = trace.export_chrome_trace(paths, str(mine))
    n_theirs = jax_trace.export_chrome_trace(paths, str(theirs))
    return n_mine, n_theirs, json.loads(mine.read_text()), json.loads(theirs.read_text())


def _fleet_streams(tmp_path):
    a = _replica_stream(tmp_path / "a.jsonl", "rep-a", 1000.0, ["t0", "t1", "t2"],
                        base=200.0)
    b = _replica_stream(tmp_path / "b.jsonl", "rep-b", 1000.35, ["t3", "t4"], base=300.0,
                        torn_tail=True)
    lone = _replica_stream(tmp_path / "c.jsonl", "rep-c", 999.9, ["z9"], base=400.0)
    router = _router_stream(tmp_path / "router.jsonl", 1200.0, [
        ("t0", "127.0.0.1:1", None), ("t1", "127.0.0.1:1", "127.0.0.1:2"),
        ("t2", "127.0.0.1:1", None), ("t3", "127.0.0.1:2", None),
        ("t4", "127.0.0.1:2", "127.0.0.1:1"),
    ])
    return router, a, b, lone


class TestExporterParity:
    @pytest.mark.parametrize("torn_tail", [False, True])
    def test_one_replica_stream_equal(self, tmp_path, torn_tail):
        path = _replica_stream(tmp_path / "r.jsonl", "rep", 1000.0, ["t0", "t1", "t2"],
                               torn_tail=torn_tail)
        n_mine, n_theirs, mine, theirs = _both(str(path), tmp_path)
        assert n_mine == n_theirs == 4
        assert mine == theirs
        names = {e["args"]["name"] for e in mine["traceEvents"] if e["ph"] == "M"}
        # lane tracks, request tracks, the duplicated id split by request,
        # the overlapping retry attempt on a sibling track
        assert {"lane 0", "lane 1", "lane 1 (overlap)", "req t0 (rq-0)",
                "req t0 (rq-dup)"} <= names

    @pytest.mark.parametrize("with_lone", [False, True])
    def test_router_and_two_replicas_merge_equal(self, tmp_path, with_lone):
        router, a, b, lone = _fleet_streams(tmp_path)
        paths = [str(router), str(a), str(b)] + ([str(lone)] if with_lone else [])
        n_mine, n_theirs, mine, theirs = _both(paths, tmp_path)
        assert n_mine == n_theirs
        assert mine == theirs
        procs = sorted(e["args"]["name"] for e in mine["traceEvents"]
                       if e["ph"] == "M" and e["name"] == "process_name")
        want = ["nm03-fleet", "replica 127.0.0.1:1", "replica 127.0.0.1:2"]
        assert procs == sorted(want + (["replica rep-c"] if with_lone else []))
        hops = [e for e in mine["traceEvents"] if e["ph"] == "B" and e["name"] == "proxy_hop"]
        assert {e["args"]["outcome"] for e in hops} == {"ok", "io_error"}

    def test_clock_offsets_align_the_processes(self, tmp_path):
        """The router's hop for t3 starts before replica b's spans of t3:
        each stream's offset moves its monotonic times onto one timeline."""
        router, a, b, _ = _fleet_streams(tmp_path)
        streams = [trace.load_stream(str(p)) for p in (router, a, b)]
        assert [s["offset_s"] for s in streams] == [
            s["offset_s"] for s in (jax_trace.load_stream(str(p)) for p in (router, a, b))]
        assert [round(s["offset_s"], 6) for s in streams] == [1200.0, 1000.0, 1000.35]
        assert trace.merged_chrome_trace_events(streams) == \
            jax_trace.merged_chrome_trace_events(streams)

    def test_check_telemetry_accepts_the_port_exports(self, tmp_path):
        router, a, b, _ = _fleet_streams(tmp_path)
        single, merged = tmp_path / "single.json", tmp_path / "merged.json"
        trace.export_chrome_trace(str(a), str(single))
        trace.export_chrome_trace([str(router), str(a), str(b)], str(merged))
        for flag, path in (("--expect-trace", single), ("--expect-fleet-trace", merged)):
            res = subprocess.run([sys.executable, str(CHECKER), flag, str(path)],
                                 capture_output=True, text=True, timeout=60)
            assert res.returncode == 0, res.stderr


class TestExporterCli:
    @pytest.mark.parametrize("case", ["one", "merged", "empty", "missing"])
    def test_cli_exit_codes_and_files_equal(self, tmp_path, case):
        router, a, b, _ = _fleet_streams(tmp_path)
        empty = _write(tmp_path / "empty.jsonl",
                       [_record("e", 0, 1.0, 0.0, "run_started", driver="serve")])
        args = {"one": [str(a)], "merged": [str(router), str(a), str(b)],
                "empty": [str(empty)], "missing": [str(tmp_path / "nope.jsonl")]}[case]
        rc_mine = trace.main([*args, "-o", str(tmp_path / "port.json")])
        rc_theirs = jax_trace.main([*args, "-o", str(tmp_path / "jax.json")])
        assert rc_mine == rc_theirs == {"one": 0, "merged": 0, "empty": 1, "missing": 2}[case]
        if case != "missing":
            assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()

    def test_module_entry_point_writes_the_default_path(self, tmp_path):
        a = _replica_stream(tmp_path / "a.jsonl", "rep-a", 1000.0, ["t0"])
        res = subprocess.run(
            [sys.executable, "-m", "nm03_capstone_project_tpu_torch.obs.trace", str(a)],
            capture_output=True, text=True, timeout=120, cwd=REPO)
        assert res.returncode == 0, res.stderr
        assert "2 request trace(s)" in res.stdout
        assert json.loads((tmp_path / "a.jsonl.trace.json").read_text())["schema"] == \
            "nm03.trace.v1"


class TestRecordedPortStreams:
    def test_streams_the_port_wrote_export_equal(self, tmp_path):
        """A port server on the CPU and a port fleet in front of it, each
        with its own event log, serve a few requests; both exporters give
        the same merged timeline of the two logs."""
        from nm03_capstone_project_tpu_torch.config import PipelineConfig
        from nm03_capstone_project_tpu_torch.data.synthetic import phantom_slice
        from nm03_capstone_project_tpu_torch.fleet.router import FleetApp
        from nm03_capstone_project_tpu_torch.fleet.router import serve_in_thread as fleet_serve
        from nm03_capstone_project_tpu_torch.obs import RunContext
        from nm03_capstone_project_tpu_torch.serving.server import ServingApp, serve_in_thread

        replica_log, fleet_log = tmp_path / "replica.jsonl", tmp_path / "fleet.jsonl"
        app = ServingApp(cfg=PipelineConfig(canvas=64, min_dim=16), buckets=(1, 2),
                         device="cpu", obs=RunContext.create("serve", log_json=str(replica_log)))
        httpd, _, port = serve_in_thread(app)
        fleet = FleetApp([f"127.0.0.1:{port}"], health_interval_s=3600,
                         obs=RunContext.create("fleet", log_json=str(fleet_log)))
        fhttpd, _, fport = fleet_serve(fleet)
        try:
            body = phantom_slice(64, 60, seed=3).astype("<f4").tobytes()
            for i in range(3):
                req = urllib.request.Request(
                    f"http://127.0.0.1:{fport}/v1/segment?output=mask", data=body,
                    headers={"X-Nm03-Height": "64", "X-Nm03-Width": "60",
                             "X-Nm03-Request-Id": f"rec-{i}"}, method="POST")
                with urllib.request.urlopen(req, timeout=120) as r:
                    assert r.status == 200
        finally:
            fhttpd.shutdown()
            fhttpd.server_close()
            fleet.begin_drain()
            fleet.close()
            httpd.shutdown()
            httpd.server_close()
            app.begin_drain()
            app.close()
        n_mine, n_theirs, mine, theirs = _both([str(fleet_log), str(replica_log)], tmp_path)
        assert n_mine == n_theirs == 6
        assert mine == theirs
        procs = {e["args"]["name"] for e in mine["traceEvents"]
                 if e["ph"] == "M" and e["name"] == "process_name"}
        assert procs == {"nm03-fleet", f"replica 127.0.0.1:{port}"}
