"""Unified telemetry plane: trace spine + metrics registry + TTL audit.

One :class:`Telemetry` instance is shared by every replica of a run
(engine, scheduler, tiered store, transfer channels, paged runtime,
cluster router): each subsystem holds an ``obs`` attribute that is
``None`` by default — every emission site is behind an
``if self.obs is not None`` guard, so the disabled hot path pays one
attribute test and nothing else (``bench_overhead.py --telemetry``
gates the *enabled* overhead at 3%).

All timestamps come from the virtual clock, and every event is appended
in deterministic scheduler order, so a same-seed replay exports a
byte-identical trace (asserted by the CI ``telemetry`` job).

Wiring::

    tel = Telemetry()
    engine.attach_telemetry(tel)        # or cluster.attach_telemetry(tel)
    ... run ...
    export.export_file(tel.trace, "trace.json")   # Perfetto-loadable
    open("metrics.prom", "w").write(tel.metrics.exposition())
    json.dump(tel.audit.to_json(), open("audit.json", "w"))
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs.audit import AuditRecord, TTLAudit
from repro_torch.obs.registry import MetricsRegistry
from repro_torch.obs.trace import TraceRecorder

__all__ = ["Telemetry", "TraceRecorder", "MetricsRegistry", "TTLAudit",
           "AuditRecord"]

# decision kinds that also mark the program's own async track
_PROGRAM_MARKS = {"demote": "demoted", "evict": "evicted",
                  "reload": "reloaded", "preempt": "preempted",
                  "migrate_out": "migrated", "rehome_drop": "rehomed"}


class Telemetry:
    def __init__(self, trace_capacity: int = 200_000,
                 audit_capacity: int = 100_000,
                 audit_link_capacity: Optional[int] = None):
        self.trace = TraceRecorder(trace_capacity)
        self.metrics = MetricsRegistry()
        self.audit = TTLAudit(audit_capacity,
                              link_capacity=audit_link_capacity)
        self.audit.sink = self._on_solve
        # live-program oracle: audit compaction keeps complete raw chains
        # for programs that still have an open lifecycle span or pin
        self.audit.live_fn = self.live_programs
        self._phase: dict[str, str] = {}     # program -> open lifecycle span
        self._pinned: set[str] = set()       # programs with an open pin span
        self.replicas: list[str] = []        # engine ids wired into the plane
        # per-tenant burn-rate monitor (enable_slo); None = SLO off
        self.slo = None
        m = self.metrics
        self.decisions = m.counter(
            "continuum_sched_decisions_total",
            "Scheduler/runtime state mutations by kind (admit, pin, unpin, "
            "demote, evict, reload, preempt, migrate_out, rehome_drop)",
            ("replica", "kind"))
        self.ttl_solves = m.counter(
            "continuum_ttl_solves_total",
            "TTLModel.solve calls by CDF source", ("source",))
        self.router_decisions = m.counter(
            "continuum_router_decisions_total",
            "Cluster placement decisions by outcome", ("decision",))
        self.migrations = m.counter(
            "continuum_migrations_total",
            "Cross-replica KV migrations committed", ("src", "dst"))
        self.migrated_bytes = m.counter(
            "continuum_migrated_bytes_total",
            "Bytes shipped across PeerLinks", ("src", "dst"))
        self.transfer_bytes = m.counter(
            "continuum_transfer_bytes_total",
            "Bytes submitted per transfer channel", ("replica", "channel"))
        self.tokens = m.counter(
            "continuum_tokens_total",
            "Tokens processed per replica (kind: prefill | decode)",
            ("replica", "kind"))
        self.programs_finished = m.counter(
            "continuum_programs_finished_total",
            "Programs that completed their final turn", ("replica",))
        self.cow_splits = m.counter(
            "continuum_page_cow_splits_total",
            "Copy-on-write page splits in the paged KV runtime",
            ("replica",))
        self.step_seconds = m.histogram(
            "continuum_step_seconds", "Engine step duration (virtual s)",
            ("replica",))
        self.ttft_seconds = m.histogram(
            "continuum_ttft_seconds", "Per-turn time to first token",
            ("replica",))
        self.jct_seconds = m.histogram(
            "continuum_jct_seconds", "Program job completion time",
            ("replica",))
        self.reload_seconds = m.histogram(
            "continuum_reload_seconds",
            "Offload-tier reload latency paid at admission", ("replica",))
        self.queue_eta = m.gauge(
            "continuum_queue_eta_seconds",
            "Live queueing-delay ETA a new arrival would see", ("replica",))
        self.kv_blocks = m.gauge(
            "continuum_kv_blocks",
            "HBM KV pool occupancy (state: total | used | free | pinned | "
            "shared)", ("replica", "state"))
        self.store_blocks = m.gauge(
            "continuum_store_blocks",
            "Tiered-store occupancy (state: used | capacity)",
            ("replica", "tier", "state"))
        self.store_entries = m.gauge(
            "continuum_store_entries", "Resident tiered-store entries",
            ("replica",))
        self.transfer_backlog = m.gauge(
            "continuum_transfer_backlog_seconds",
            "Seconds until a channel's queue drains", ("replica", "channel"))
        self.transfer_inflight = m.gauge(
            "continuum_transfer_inflight_bytes",
            "Approximate bytes still in flight (backlog x nominal bw)",
            ("replica", "channel"))
        self.jct_components = m.gauge(
            "continuum_jct_component_seconds",
            "Fleet JCT decomposition by causal component (refreshed by "
            "each attribution analysis — see obs.attribution)",
            ("replica", "component"))
        # prediction-drift watchdog (enable_drift); None = drift off and
        # every paired emission site costs one extra attribute test
        self.drift = None
        self._engines: list = []       # attached engines (drift refits)

    # ------------------------------------------------------------ wiring
    def attach_engine(self, engine) -> None:
        """Wire one replica into the shared plane (the engine calls this
        from :meth:`Engine.attach_telemetry`)."""
        r = engine.engine_id
        if r not in self.replicas:
            self.replicas.append(r)
        engine.obs = self
        sch = engine.scheduler
        sch.obs = self
        sch.obs_replica = r
        sch.handler.obs = self
        sch.handler.obs_replica = r
        sch.handler.ttl_model.audit = self.audit
        store = engine.kvstore
        if store is not None:
            store.obs = self
            store.obs_replica = r
            store.obs_clock = lambda: engine.clock
            self._attach_channels(store.transfer, r)
        runtime = getattr(engine.backend, "runtime", None)
        if runtime is not None:
            runtime.obs = self
            runtime.obs_replica = r
            runtime.obs_clock = lambda: engine.clock
        self._engines.append(engine)
        if self.drift is not None:
            self._wire_drift_engine(engine)
        self.metrics.on_collect(lambda: self.collect_engine(engine))

    def _attach_channels(self, te, replica: str) -> None:
        for ch in (te.h2d, te.d2h, te.ssd_read, te.ssd_write,
                   te.peer_out, te.peer_in):
            if ch is not None:
                ch.obs = self
                ch.obs_track = f"{replica}/{ch.name}"

    def collect_engine(self, engine) -> None:
        """Gauge refresh (exposition/snapshot time only — never per step)."""
        r = engine.engine_id
        b = engine.blocks
        g = self.kv_blocks
        g.set(b.total, (r, "total"))
        g.set(b.used, (r, "used"))
        g.set(b.free, (r, "free"))
        g.set(b.pinned_total(), (r, "pinned"))
        g.set(b.shared, (r, "shared"))
        self.queue_eta.set(engine.queue_eta(engine.clock), (r,))
        store = engine.kvstore
        if store is None:
            return
        self.store_blocks.set(store.dram_used_blocks, (r, "dram", "used"))
        self.store_blocks.set(store.cfg.dram_blocks, (r, "dram", "capacity"))
        self.store_blocks.set(store.ssd_used_blocks, (r, "ssd", "used"))
        self.store_blocks.set(store.cfg.ssd_blocks, (r, "ssd", "capacity"))
        self.store_entries.set(len(store.entries), (r,))
        te = store.transfer
        now = engine.clock
        for ch in (te.h2d, te.d2h, te.ssd_read, te.ssd_write,
                   te.peer_out, te.peer_in):
            if ch is None:
                continue
            backlog = ch.backlog_seconds(now)
            self.transfer_backlog.set(backlog, (r, ch.name))
            self.transfer_inflight.set(backlog * ch.bw, (r, ch.name))

    # --------------------------------------------------------- decisions
    def decision(self, replica: str, kind: str, program_id: str,
                 info: tuple, now: float) -> None:
        """One scheduler/runtime state mutation: exactly one trace
        instant (cat=decision) + one audit link, plus derived metrics.
        This is the hottest emission path (every Schedule() admit runs
        it), so the ring push, counter bump and audit link are inlined
        — everything allocated is a tuple of scalars, which CPython's
        GC untracks after the first pass (``bench_overhead.py
        --telemetry`` gates the total at 3%)."""
        tr = self.trace
        if len(tr.events) == tr.capacity:
            tr.dropped += 1
        tr.seq += 1
        tr.events.append(("d", now, replica, kind, program_id, info))
        key = (replica, kind)
        dv = self.decisions.values
        dv[key] = dv.get(key, 0.0) + 1.0
        au = self.audit
        au.links.append((au._latest.get(program_id), program_id, kind,
                         now, info))
        if len(au.links) >= au._compact_at:
            au._compact()
        if program_id in self._pinned:
            # rare: only programs with an open pin span need bookkeeping
            if kind in ("unpin", "migrate_out", "rehome_drop") or \
                    (kind == "admit" and len(info) > 1
                     and info[1] == "pin"):
                # unpin/migrate closes the span; an admit with
                # source=pin is a TTL hit adopting it
                self._pinned.discard(program_id)
                tr.async_end(program_id, "pinned", now)
        elif kind == "pin":
            self._pinned.add(program_id)
            tr.async_begin(program_id, "pinned", now,
                           args={"ttl": info[1]} if len(info) > 1
                           else None)
        mark = _PROGRAM_MARKS.get(kind)
        if mark is not None:
            if kind == "reload" and info:
                self.reload_seconds.observe(float(info[0]), (replica,))
            tr.async_instant(program_id, mark, now)

    def _on_solve(self, rec: AuditRecord) -> None:
        self.ttl_solves.inc(1.0, (rec.source,))
        if rec.replica is not None:
            self.trace.instant(rec.replica, "ttl_solve", rec.ts, cat="ttl",
                               args={"program": rec.program_id,
                                     "ttl": rec.ttl, "gain": rec.gain,
                                     "source": rec.source,
                                     "record": rec.id})

    # ----------------------------------------------------- drift watchdog
    def enable_drift(self, cfg=None):
        """Attach the prediction-drift watchdog: every predicted-vs-
        realized pair (TTL-solve inputs, reload peeks, step estimates,
        placement scores, migration ETAs) feeds a rolling window with
        burn-style alerting (``drift_alert`` trace instants +
        ``continuum_drift_*`` metrics). Already-attached engines get
        their ``step_seconds`` recalibrator wired immediately."""
        from repro_torch.obs.drift import DriftConfig, DriftMonitor
        self.drift = DriftMonitor(self.metrics, self.trace,
                                  cfg or DriftConfig())
        for engine in self._engines:
            self._wire_drift_engine(engine)
        return self.drift

    def _wire_drift_engine(self, engine) -> None:
        """A drift alert on the step estimator re-fits the hardware
        calibration (profiler.calibrate_hardware) from the engine's live
        step samples; the fitted profile is reported, never applied —
        telemetry must not change scheduling decisions."""
        from repro_torch.serving.profiler import calibrate_hardware
        eng = engine

        def _refit() -> dict:
            samples = getattr(eng, "drift_samples", None)
            if not samples:
                return {"skipped": "no live step samples"}
            hw = calibrate_hardware(samples, eng.cost.prof, eng.cost.hw)
            return {"mfu": round(hw.mfu, 6),
                    "decode_eff": round(hw.decode_eff, 6),
                    "samples": len(samples)}

        self.drift.add_recalibrator(
            "step_seconds", f"calibrate_hardware/{eng.engine_id}", _refit)

    def attribution(self, eps: float = 1e-6) -> dict:
        """Run critical-path JCT attribution over the live trace and
        refresh ``continuum_jct_component_seconds``. Post-hoc analysis
        (O(events)) — the ``/attribution`` endpoint and the replay demo
        call it; nothing on the step path does."""
        from repro_torch.obs import attribution as _attr
        return _attr.attribute(self, eps=eps)

    # --------------------------------------------------------- SLO / latency
    def enable_slo(self, objectives):
        """Attach a per-tenant burn-rate monitor; its counters/gauges
        join this registry and alert instants land on the trace's
        ``slo`` lane."""
        from repro_torch.obs.slo import SLOMonitor
        self.slo = SLOMonitor(objectives, self.metrics, self.trace)
        return self.slo

    def note_ttft(self, replica: str, tenant: str, value: float,
                  now: float) -> None:
        self.ttft_seconds.observe(value, (replica,))
        if self.slo is not None:
            self.slo.observe(tenant, "ttft", value, now)

    def note_jct(self, replica: str, tenant: str, value: float,
                 now: float) -> None:
        self.jct_seconds.observe(value, (replica,))
        if self.slo is not None:
            self.slo.observe(tenant, "jct", value, now)

    def live_programs(self) -> set:
        """Programs with an open lifecycle span or pin — their raw audit
        chains survive retention compaction."""
        return set(self._phase) | self._pinned

    # --------------------------------------------------- program lifecycle
    def program_phase(self, program_id: str, phase: str, now: float,
                      args: Optional[dict] = None) -> None:
        """Advance a program's lifecycle track (queued → prefill → decode
        → tool_pause → ...); the open span, if any, ends here."""
        prev = self._phase.get(program_id)
        if prev is not None:
            self.trace.async_end(program_id, prev, now)
        self._phase[program_id] = phase
        self.trace.async_begin(program_id, phase, now, args)

    def program_end(self, program_id: str, now: float,
                    mark: str = "finished") -> None:
        prev = self._phase.pop(program_id, None)
        if prev is not None:
            self.trace.async_end(program_id, prev, now)
        self.trace.async_instant(program_id, mark, now)

    # ------------------------------------------------------------- lanes
    def channel_transfer(self, track: str, channel: str, nbytes: float,
                         start: float, end: float) -> None:
        self.trace.complete(track, "xfer", start, end - start,
                            cat="transfer", args={"bytes": nbytes})
        self.transfer_bytes.inc(nbytes, (track.partition("/")[0], channel))

    def tier_event(self, replica: str, name: str, program_id: str,
                   now: float, args: Optional[dict] = None) -> None:
        a = {"program": program_id}
        if args:
            a.update(args)
        self.trace.instant(replica, name, now, cat="tier", args=a)

    def router_event(self, decision: str, program_id: str, now: float,
                     args: Optional[dict] = None) -> None:
        a = {"program": program_id}
        if args:
            a.update(args)
        self.trace.instant("cluster", decision, now, cat="router", args=a)
        self.router_decisions.inc(1.0, (decision,))

    def cluster_migration(self, program_id: str, src: str, dst: str,
                          now: float, arrive: float, tokens: int,
                          nbytes: float, reason: str = "rehome") -> None:
        self.trace.instant("cluster", "migrate", now, cat="cluster",
                           args={"program": program_id, "src": src,
                                 "dst": dst, "tokens": tokens,
                                 "arrive": round(arrive, 9),
                                 "reason": reason})
        self.migrations.inc(1.0, (src, dst))
        self.migrated_bytes.inc(nbytes, (src, dst))
