"""``nm03-fleet``: the replica-fleet front end and its orchestration.

The port's copy of the JAX package's ``fleet/cli.py``; run it as
``python -m nm03_capstone_project_tpu_torch.fleet.cli``. Four subcommands:

* ``serve --replicas URL,URL,...`` — the routing front end: proxies
  ``POST /v1/segment`` (and ``/v1/segment-volume``) across the replicas
  with capacity-weighted routing, outlier ejection, failover and
  backpressure propagation, and serves its own ``/healthz`` / ``/readyz``
  / ``/metrics`` / ``/metrics.json`` (the ``fleet_*`` series; the
  ``--slo-*`` flags add the SLO plane's burn-rate gauges);
* ``restart --replicas URL,URL,...`` — the rolling restart: drain →
  relaunch → warm-wait, one replica at a time, so a redeploy never drops
  the fleet below (N−1)/N capacity;
* ``flightrec --replicas URL,URL,...`` — the remote debug pull: every
  replica's ``GET /debug/flightrec`` (its flight rings) into one dump per
  replica;
* ``profile --replicas URL,URL,... --ms N`` — fan an on-demand
  ``torch.profiler`` capture (``GET /debug/profile?ms=N``) across the
  replicas, writing each returned trace archive to disk.

The replicas are the port's servers, started by their operator (each on
the card unless its own command line asks for the CPU); the front end
starts none, runs no model, imports neither torch nor numpy and never
touches the card.
"""

from __future__ import annotations

import argparse
import json
import signal
import sys
import threading


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nm03-fleet", description=__doc__.strip().splitlines()[0]
    )
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser(
        "serve", help="run the fleet routing front-end",
        description="Proxy POST /v1/segment across N server replicas "
        "with capacity-weighted routing, ejection/probation, failover and "
        "Retry-After propagation.",
    )
    s.add_argument(
        "--replicas", required=True, metavar="URL[,URL...]",
        help="comma list of replica base URLs (host:port accepted)",
    )
    s.add_argument("--host", default="127.0.0.1", help="bind address")
    s.add_argument(
        "--port", type=int, default=8070, help="bind port (0 = ephemeral)"
    )
    s.add_argument(
        "--port-file", default=None, metavar="PATH",
        help="write the bound port here once listening (written atomically)",
    )
    s.add_argument(
        "--health-interval-s", type=float, default=1.0,
        help="replica /readyz poll cadence — the ejection detection latency",
    )
    s.add_argument(
        "--probe-interval-s", type=float, default=5.0,
        help="probation canary cadence for ejected replicas (an off-path "
        "POST /v1/segment on a synthetic slice; success reinstates)",
    )
    s.add_argument(
        "--health-timeout-s", type=float, default=2.0,
        help="per-poll HTTP timeout; a poll past this ejects (cause timeout)",
    )
    s.add_argument(
        "--proxy-timeout-s", type=float, default=90.0,
        help="per-hop proxied-request timeout; expiry ejects the replica "
        "and fails the request over",
    )
    s.add_argument(
        "--canary-hw", type=int, default=32, metavar="N",
        help="probation canary slice is NxN zeros, auto-clamped into the "
        "replica's published min-dim..canvas window (this flag is the "
        "floor when the replica publishes neither)",
    )
    s.add_argument(
        "--result-cache-bytes", default="0", metavar="BYTES",
        help="router-side content-addressed result tier budget (k/m/g "
        "suffixes; 0 disables) — a repeated study is answered at the "
        "front-end without spending a replica pick",
    )
    s.add_argument(
        "--fault-plan", default=None, metavar="SPEC",
        help="chaos plan (site 'fleet': replica_unreachable / "
        "proxy_io_error). Default: $NM03_FAULT_PLAN",
    )
    s.add_argument(
        "--metrics-out", default=None, metavar="PATH",
        help="write the fleet_* metrics snapshot here at drain",
    )
    s.add_argument(
        "--log-json", default=None, metavar="PATH",
        help="append fleet events (replica_ejected/reinstated, fleet_drain) "
        "as nm03.events.v1 JSONL here",
    )
    s.add_argument("--verbose", action="store_true", help="enable INFO logging")
    from nm03_capstone_project_tpu_torch.obs.slo import add_slo_args

    add_slo_args(s)  # the fleet-level SLO plane

    r = sub.add_parser(
        "restart", help="rolling-restart the replicas, one at a time",
        description="SIGTERM -> drain-wait -> relaunch (from each "
        "replica's own /readyz relaunch_argv) -> /readyz warm-wait, one "
        "replica at a time; same-host by construction.",
    )
    r.add_argument(
        "--replicas", required=True, metavar="URL[,URL...]",
        help="comma list of replica base URLs, restarted in order",
    )
    r.add_argument(
        "--fleet-url", default=None, metavar="URL",
        help="an nm03-fleet front-end to consult: wait until it reinstates "
        "each restarted replica before draining the next (guarantees at "
        "most one replica out of rotation)",
    )
    r.add_argument(
        "--drain-timeout-s", type=float, default=120.0,
        help="max wait for a SIGTERMed replica's listener to close",
    )
    r.add_argument(
        "--warm-timeout-s", type=float, default=600.0,
        help="max wait for a relaunched replica's /readyz 200",
    )
    r.add_argument(
        "--format", choices=["text", "json"], default="text",
        help="report format (json = the machine/CI interface)",
    )

    for name, desc in (
        ("flightrec",
         "pull every replica's flight-recorder rings (GET /debug/flightrec) "
         "— the wedged-fleet post-mortem without SIGUSR2 shell access"),
        ("profile",
         "fan an on-demand torch.profiler capture (GET /debug/profile?ms=N) "
         "across every replica and write each trace archive to disk"),
    ):
        d = sub.add_parser(name, help=desc.split(" — ")[0], description=desc)
        d.add_argument(
            "--replicas", required=True, metavar="URL[,URL...]",
            help="comma list of replica base URLs to pull from",
        )
        d.add_argument(
            "--out-dir", default=".", metavar="DIR",
            help="where the per-replica dumps land (created if missing)",
        )
        d.add_argument(
            "--timeout-s", type=float, default=30.0,
            help="per-replica HTTP timeout (profile pulls add the capture "
            "duration on top)",
        )
        if name == "profile":
            d.add_argument(
                "--ms", type=int, default=500, metavar="N",
                help="capture duration per replica in milliseconds "
                "(the server rejects values outside [10, 10000])",
            )
    return p


def _split_targets(spec: str):
    targets = [t.strip() for t in str(spec).split(",") if t.strip()]
    if not targets:
        raise SystemExit("nm03-fleet: --replicas needs at least one URL")
    return targets


def _serve(args) -> int:
    from nm03_capstone_project_tpu_torch.cache import parse_bytes
    from nm03_capstone_project_tpu_torch.fleet.router import (
        FleetApp,
        make_http_server,
    )
    from nm03_capstone_project_tpu_torch.obs import RunContext
    from nm03_capstone_project_tpu_torch.obs.slo import objective_from_args
    from nm03_capstone_project_tpu_torch.resilience import FaultPlan
    from nm03_capstone_project_tpu_torch.utils.reporter import configure_reporting

    configure_reporting(verbose=args.verbose)
    plan = (
        FaultPlan.from_spec(args.fault_plan)
        if args.fault_plan else FaultPlan.from_env()
    )
    obs = RunContext.create(
        "fleet", metrics_out=args.metrics_out, log_json=args.log_json,
        argv=sys.argv[1:],
    )
    app = FleetApp(
        _split_targets(args.replicas),
        obs=obs,
        health_interval_s=args.health_interval_s,
        probe_interval_s=args.probe_interval_s,
        health_timeout_s=args.health_timeout_s,
        proxy_timeout_s=args.proxy_timeout_s,
        canary_hw=args.canary_hw,
        fault_plan=plan,
        slo=objective_from_args(args),
        result_cache_bytes=parse_bytes(
            getattr(args, "result_cache_bytes", "0") or "0"
        ),
    )
    httpd = make_http_server(app, args.host, args.port)
    port = httpd.server_address[1]
    app.start()
    if args.port_file:
        from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_text

        atomic_write_text(args.port_file, f"{port}\n")
    print(
        f"nm03-fleet: listening on {args.host}:{port} "
        f"({app.replicas.healthy_count()}/{len(app.replicas)} replicas "
        "healthy)",
        flush=True,
    )

    def _drain_and_stop(signum, frame):
        def work():
            app.begin_drain(reason=signal.Signals(signum).name.lower())
            httpd.shutdown()

        threading.Thread(target=work, name="nm03-fleet-drain", daemon=True).start()

    signal.signal(signal.SIGTERM, _drain_and_stop)
    signal.signal(signal.SIGINT, _drain_and_stop)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        app.begin_drain(reason="exit")  # idempotent after a signal drain
        app.close(status="ok")
    print("nm03-fleet: drained and stopped", flush=True)
    return 0


def _restart(args) -> int:
    from nm03_capstone_project_tpu_torch.fleet.manager import (
        RestartError,
        rolling_restart,
    )

    def emit(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    try:
        report = rolling_restart(
            _split_targets(args.replicas),
            drain_timeout_s=args.drain_timeout_s,
            warm_timeout_s=args.warm_timeout_s,
            fleet_url=args.fleet_url,
            emit=emit,
        )
    except RestartError as e:
        report = getattr(e, "report", {"ok": False, "replicas": []})
        print(json.dumps(report, indent=2))
        print(f"nm03-fleet restart: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    if args.format == "json":
        print(json.dumps(report, indent=2))
    else:
        for r in report["replicas"]:
            print(
                f"{r['replica']:<22} pid {r['old_pid']} -> {r['new_pid']}  "
                f"drain {r['drain_s']}s  warm {r['warm_s']}s  "
                f"graph capture {r['capture_s']}s"
            )
        done = sum(1 for r in report["replicas"] if r.get("ok"))
        print(
            f"nm03-fleet restart: {done}/{len(report['replicas'])} replicas "
            "restarted",
            flush=True,
        )
    return 0


def _debug_pull(args, command: str) -> int:
    """Fan one ``/debug/*`` pull across every replica, concurrently.

    One thread per target (a profile pull BLOCKS for the capture
    duration server-side — serial pulls would stretch an N-replica
    post-mortem N×); every reachable replica's evidence is written even
    when others are wedged — exit 1 reports the partial pull, it never
    discards it.
    """
    import os
    import threading
    import urllib.request

    from nm03_capstone_project_tpu_torch.fleet.replicas import (
        normalize_target,
        target_label,
    )
    from nm03_capstone_project_tpu_torch.utils.atomicio import atomic_write_text

    targets = [normalize_target(t) for t in _split_targets(args.replicas)]
    os.makedirs(args.out_dir, exist_ok=True)
    if command == "profile":
        path, timeout = f"/debug/profile?ms={args.ms}", (
            args.timeout_s + args.ms / 1e3
        )
    else:
        path, timeout = "/debug/flightrec", args.timeout_s
    results = {}
    lock = threading.Lock()

    def pull(target: str) -> None:
        label = target_label(target)
        safe = label.replace(":", "_")
        try:
            with urllib.request.urlopen(
                f"{target}{path}", timeout=timeout
            ) as resp:
                payload = json.loads(resp.read())
        except Exception as e:  # noqa: BLE001 — a dead replica is a row
            with lock:
                results[label] = {"ok": False, "error": str(e)}
            return
        out = {"ok": True}
        if command == "profile":
            zip_b64 = payload.pop("zip_b64", None)
            json_path = os.path.join(args.out_dir, f"profile_{safe}.json")
            atomic_write_text(json_path, json.dumps(payload, indent=1) + "\n")
            out["json"] = json_path
            out["files"] = len(payload.get("files") or [])
            if zip_b64 is not None:
                import base64

                from nm03_capstone_project_tpu_torch.utils.atomicio import (
                    atomic_write_bytes,
                )

                zip_path = os.path.join(args.out_dir, f"profile_{safe}.zip")
                atomic_write_bytes(zip_path, base64.b64decode(zip_b64))
                out["zip"] = zip_path
            elif payload.get("zip_dropped"):
                # archive over the wire cap: it survives ON the replica —
                # the row names where to fetch it out of band
                out["zip"] = None
                out["remote_zip"] = payload.get("zip_path")
        else:
            dump_path = os.path.join(args.out_dir, f"flightrec_{safe}.json")
            atomic_write_text(dump_path, json.dumps(payload, indent=1) + "\n")
            out["json"] = dump_path
            out["threads"] = len(payload.get("threads") or {})
            out["records"] = payload.get("records_total")
        with lock:
            results[label] = out

    threads = [
        threading.Thread(target=pull, args=(t,), daemon=True) for t in targets
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout + 30)
    failed = 0
    for target in targets:
        label = target_label(target)
        r = results.get(label, {"ok": False, "error": "pull thread hung"})
        if r.get("ok"):
            detail = " ".join(
                f"{k}={v}" for k, v in sorted(r.items()) if k != "ok"
            )
            print(f"{label:<22} ok  {detail}")
        else:
            failed += 1
            print(f"{label:<22} FAILED  {r.get('error')}", file=sys.stderr)
    print(
        f"nm03-fleet {command}: {len(targets) - failed}/{len(targets)} "
        f"replica(s) pulled -> {args.out_dir}",
        flush=True,
    )
    return 1 if failed else 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "serve":
        from nm03_capstone_project_tpu_torch.obs.slo import objective_from_args

        try:
            objective_from_args(args)  # a bad --slo-* is a usage error,
        except ValueError as e:        # not a traceback mid-startup
            parser.error(str(e))
        return _serve(args)
    if args.command in ("flightrec", "profile"):
        return _debug_pull(args, args.command)
    return _restart(args)


if __name__ == "__main__":
    raise SystemExit(main())
