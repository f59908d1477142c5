"""Serving launcher: run an agent workload through the Continuum engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b \
        --policy continuum --workload swe-bench -n 60 --rate 0.05 \
        [--offload-gb 200] [--trace trace.json] [--engines 2]

Uses the virtual-clock simulation backend (cost-model timed; the scheduler
code is the production code). For real token generation on CPU see
examples/quickstart.py.

Observability front door::

    PYTHONPATH=src python -m repro_torch.launch.serve --http-port 8321 \
        --http-linger 60 --slo-ttft 2.0 ...

starts the telemetry plane plus :class:`repro_torch.obs.server.ObsServer`
before the run (``/metrics``, ``/healthz``, ``/traces``, ``/audit/<id>``,
SSE ``/events``) and keeps serving for ``--http-linger`` seconds after
the workload drains, so scrapers (and the CI ``http-smoke`` job) can
read the final state.

Cluster mode (``--cluster``) runs ``--engines`` replicas as one
:class:`~repro_torch.serving.cluster.Cluster` — shared virtual clock, KV-aware
routing and cross-replica migration — instead of independent engines
behind a session router.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.configs import get_config
from repro_torch.core.policies import POLICIES
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.offload import OffloadConfig
from repro_torch.serving.profiler import HardwareProfile
from repro_torch.serving.router import Router
from repro_torch.sim.runner import run_workload
from repro_torch.sim.workload import WORKLOADS, generate_programs, load_trace

CLUSTER_ROUTERS = ("round_robin", "sticky", "kv_aware", "kv_aware_migrate")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--policy", default="continuum", choices=list(POLICIES))
    ap.add_argument("--workload", default="swe-bench",
                    choices=list(WORKLOADS))
    ap.add_argument("--trace", help="replay a recorded JSON trace instead")
    ap.add_argument("-n", type=int, default=60)
    ap.add_argument("--rate", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--engines", type=int, default=1)
    ap.add_argument("--router", default=None,
                    help="placement policy: session | round_robin | "
                         "least_loaded (multi-engine), or one of "
                         f"{'/'.join(CLUSTER_ROUTERS)} with --cluster")
    ap.add_argument("--cluster", action="store_true",
                    help="run --engines replicas as one Cluster (shared "
                         "clock, KV-aware routing, cross-replica KV "
                         "migration) instead of independent engines")
    ap.add_argument("--offload-gb", type=float, default=0.0,
                    help="host-DRAM tier capacity (0 = offload disabled)")
    ap.add_argument("--ssd-gb", type=float, default=0.0,
                    help="SSD spillover tier below DRAM (needs --offload-gb)")
    ap.add_argument("--kv-budget-gb", type=float, default=40.0)
    ap.add_argument("--max-batch", type=int, default=48)
    ap.add_argument("--chunk-size", type=int, default=2048)
    ap.add_argument("--cost-source", default="analytic",
                    choices=("analytic", "roofline"),
                    help="roofline: calibrate the TTL cost model from the "
                         "compiled HLO of the real config (lower+compile "
                         "only — scanned layers keep it seconds on CPU)")
    ap.add_argument("--trace-out",
                    help="write a Perfetto-loadable trace of the run "
                         "(enables the telemetry plane); the raw event "
                         "stream lands next to it as <path>.jsonl and "
                         "the TTL audit as <path>.audit.json")
    ap.add_argument("--metrics-out",
                    help="write the Prometheus text exposition of the "
                         "run's metrics (enables the telemetry plane); "
                         "a JSON snapshot lands next to it as "
                         "<path>.json")
    ap.add_argument("--http-port", type=int, default=None,
                    help="serve the live telemetry plane over HTTP "
                         "(/metrics, /healthz, /traces, /audit, /events; "
                         "0 = ephemeral port, printed at startup); "
                         "enables the telemetry plane")
    ap.add_argument("--http-linger", type=float, default=0.0,
                    help="keep the HTTP server up this many wall seconds "
                         "after the run drains (CI scrape window)")
    ap.add_argument("--slo-ttft", type=float, default=None,
                    help="per-tenant TTFT SLO target seconds (enables "
                         "burn-rate monitoring)")
    ap.add_argument("--slo-jct", type=float, default=None,
                    help="per-tenant JCT SLO target seconds")
    ap.add_argument("--slo-objective", type=float, default=0.95,
                    help="compliance fraction for the SLO targets")
    args = ap.parse_args()

    if args.router is None:
        args.router = "kv_aware_migrate" if args.cluster else "session"
    cfg = get_config(args.arch)
    if args.trace:
        programs = load_trace(args.trace)
    else:
        programs = generate_programs(WORKLOADS[args.workload], n=args.n,
                                     rate_jps=args.rate, seed=args.seed)
    if args.cluster and args.router == "kv_aware_migrate" \
            and not args.offload_gb:
        # migration stages KV through the host tier on both ends
        print("note: --cluster with kv_aware_migrate needs an offload "
              "tier; defaulting --offload-gb 8", file=sys.stderr)
        args.offload_gb = 8.0
    off = OffloadConfig(dram_bytes=args.offload_gb * 1e9,
                        ssd_bytes=args.ssd_gb * 1e9) \
        if args.offload_gb else None
    # calibrate once and share: every replica serves the same model, so the
    # roofline compile (the expensive part) must not repeat per engine
    cost = None
    if args.cost_source == "roofline":
        from repro_torch.serving.profiler import CostModel
        cost = CostModel.from_roofline(cfg, chips=args.chips)
    id_prefix = "r" if args.cluster else "e"
    engines = [Engine(cfg, EngineConfig(
        policy=args.policy, chips=args.chips, offload=off,
        max_batch=args.max_batch, chunk_size=args.chunk_size,
        kv_budget_bytes=args.kv_budget_gb * 1e9), HardwareProfile(),
        cost=cost, engine_id=f"{id_prefix}{i}") for i in range(args.engines)]

    cluster = None
    if args.cluster:
        from repro_torch.serving.cluster import Cluster, ClusterConfig
        assert args.router in CLUSTER_ROUTERS, \
            f"--cluster router must be one of {CLUSTER_ROUTERS}"
        cluster = Cluster(engines, ClusterConfig(n_replicas=args.engines,
                                                 router=args.router))

    tel = None
    if args.trace_out or args.metrics_out or args.http_port is not None \
            or args.slo_ttft is not None or args.slo_jct is not None:
        from repro_torch.obs import Telemetry
        tel = Telemetry()
        if cluster is not None:
            cluster.attach_telemetry(tel)
        else:
            for e in engines:
                e.attach_telemetry(tel)
        if args.slo_ttft is not None or args.slo_jct is not None:
            from repro_torch.obs.slo import default_objectives
            tel.enable_slo(default_objectives(args.slo_ttft, args.slo_jct,
                                              args.slo_objective))

    server = None
    if args.http_port is not None:
        from repro_torch.obs.server import ObsServer
        clock_fn = (lambda: cluster.clock.now) if cluster is not None \
            else (lambda: max(e.clock for e in engines))
        server = ObsServer(tel, port=args.http_port, clock=clock_fn)
        server.start()
        print(json.dumps({"obs_http": server.url()}), flush=True)

    if cluster is not None:
        s = cluster.run(programs, max_seconds=1e7)
    else:
        router = Router(engines, policy=args.router)
        s = run_workload(programs, engines, router, max_seconds=1e7)
    if tel is not None:
        import pathlib
        if args.trace_out:
            from repro_torch.obs import export as obs_export
            p = pathlib.Path(args.trace_out)
            p.parent.mkdir(parents=True, exist_ok=True)
            obs_export.export_file(tel.trace, p)
            tel.trace.save_jsonl(p.with_suffix(p.suffix + ".jsonl"))
            p.with_suffix(p.suffix + ".audit.json").write_text(
                json.dumps(tel.audit.to_json(), indent=2, sort_keys=True)
                + "\n")
        if args.metrics_out:
            p = pathlib.Path(args.metrics_out)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(tel.metrics.exposition())
            p.with_suffix(p.suffix + ".json").write_text(
                json.dumps(tel.metrics.snapshot(), indent=2,
                           sort_keys=True) + "\n")
    st = engines[0].scheduler.stats
    out = {
        "policy": args.policy, "n_programs": s.n_programs,
        "avg_jct_s": round(s.avg_jct, 1), "p95_jct_s": round(s.p95_jct, 1),
        "throughput_jobs_per_min": round(s.throughput_jobs_per_s * 60, 2),
        "avg_queueing_s": round(s.avg_queueing, 1),
        "ttl": {"pins": st.pins, "hits": st.ttl_hits,
                "expiries": st.ttl_expiries,
                "deadlock_evictions": st.deadlock_evictions},
    }
    if cluster is not None:
        out["cluster"] = {
            "replicas": args.engines, "router": args.router,
            "migrations": cluster.stats.migrations,
            "migrated_tokens": cluster.stats.migrated_tokens,
            "cold_rehomes": cluster.stats.cold_rehomes,
        }
    if engines[0].kvstore is not None:
        ks = engines[0].kvstore
        out["kvstore"] = {
            "demotions": st.demotions,
            "reloads": st.offload_reloads,
            "reload_seconds": round(st.reload_seconds, 1),
            "recompute_seconds": round(st.recompute_seconds, 1),
            "tier_usage": {t: ks.usage()[t]["used_blocks"]
                           for t in ("dram", "ssd")},
            "bytes_moved": {c: round(v["bytes_moved"] / 1e9, 2)
                            for c, v in ks.transfer.usage().items()},
        }
    if tel is not None and tel.slo is not None:
        slo = tel.slo.status()
        out["slo"] = {"alerting": [t for t in slo["tenants"]
                                   if t["alerting"]],
                      "tenants": len(slo["tenants"])}
    print(json.dumps(out, indent=1), flush=True)
    if server is not None:
        if args.http_linger > 0:
            time.sleep(args.http_linger)
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
