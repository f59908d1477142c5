"""Multi-replica cluster serving: N full engines, one virtual clock,
KV-aware routing, cross-replica KV migration — and an **elastic** fleet:
replicas are added and removed at runtime (drain-then-retire), and a
prefill-only replica class disaggregates first-turn prefills from
steady-state decode (TokenCake/Mooncake-style).

Each replica is a complete :class:`~repro_torch.serving.engine.Engine` (own
``Scheduler``/``BlockManager``/``TieredKVStore``/backend) stepped on the
shared :class:`~repro_torch.serving.cluster.clock.ClusterClock`. The
:class:`~repro_torch.serving.cluster.router.ClusterRouter` places every
arriving turn; when the TTL cost model says shipping the KV beats both
re-queueing at home and recomputing cold, the cluster **migrates** it:

1. the source releases the KV without a home-tier demotion
   (``Scheduler.migrate_out`` for pins — the HBM->host staging is a real
   d2h transfer — or ``TieredKVStore.extract`` for tier entries, whose
   SSD suffix is first read up to DRAM);
2. the bytes cross the :class:`~repro_torch.serving.cluster.peer.PeerLink`
   (two serial NIC hops, queue-aware, BandwidthCurve-priced);
3. the target's store lands the entry (``admit_migrated``) stamped
   reloadable at the interconnect arrival time and *pinned* until then,
   so tier pressure cannot drop KV that is still on the wire;
4. the target's admission later reloads it through its own h2d channel —
   the arrival stamp makes the reload ETA include any remaining flight
   time, so the engine's reload-overlap machinery prices the migration
   end to end with zero new code paths.

Elasticity rides the same machinery:

- ``add_engine`` builds a fresh replica from the ``engine_factory``,
  wires its peer links/clock hooks, and makes it immediately routable;
- ``begin_drain`` marks a replica draining: the router stops placing
  on it, its in-flight programs finish (their next turns route
  elsewhere), and ``tick`` migrates its pinned/tiered KV to the best
  surviving decode replica over the PeerLinks; when nothing resides on
  it and no flight touches it, the replica **retires** (its links are
  torn down and its stats are preserved on ``retired_engines``);
- prefill-only replicas (``role == "prefill"``) take first-turn/cold
  prefills; the moment a turn finishes there the KV migrates to a
  decode replica (post-step handoff hook), so decode replicas keep
  smooth step times and the prefill pool never accumulates state.

Conservation invariant (``check``): at every step boundary, every
program's KV is resident on **exactly one replica** (HBM pin / running
request / tier entry — engine and store on the same replica count once)
**or in flight on exactly one PeerLink**; per-replica
``BlockManager.check`` / ``TieredKVStore.check`` / (physical backends)
``PagedKVRuntime.check`` all hold — across scale-up, drain and retire.

Program-level FCFS stays global: every replica's scheduler orders its
queue by the cluster-wide ``program_arrival_time``, so placement decides
*where* a program runs, never *when relative to other programs*.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.cluster.clock import ClusterClock
from repro_torch.serving.cluster.peer import PeerLink
from repro_torch.serving.cluster.router import ClusterRouter
from repro_torch.serving.cluster.scaling import ScalingConfig, ScalingPolicy
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.metrics import Summary
from repro_torch.serving.profiler import HardwareProfile
from repro_torch.sim.runner import Simulator


@dataclasses.dataclass
class ClusterConfig:
    n_replicas: int = 3
    router: str = "kv_aware_migrate"
    peer_bw: float = 25e9              # interconnect NIC, bytes/s per dir
    peer_latency_s: float = 0.0005
    peer_curve: Optional[tuple] = None  # (size, bw) BandwidthCurve points
    migrate_min_gain_s: float = 0.0    # hysteresis before leaving home
    affinity_balance: float = 1.5      # new-program placement load guard
    affinity_slack: int = 4
    check_each_step: bool = False      # conservation + pool checks per step
    scaling: Optional[ScalingConfig] = None   # None = static fleet
    prefill_replicas: int = 0          # disaggregated prefill pool size


@dataclasses.dataclass
class ClusterStats:
    migrations: int = 0
    migrated_tokens: int = 0
    migrated_bytes: float = 0.0
    migration_denied: int = 0          # target had no guaranteed room
    cold_rehomes: int = 0
    dropped_tokens: int = 0            # KV dropped by re-home decisions
    scale_ups: int = 0
    scale_downs: int = 0               # drains begun (retire follows)
    retired: int = 0
    drained_tokens: int = 0            # KV evacuated off draining replicas
    prefill_handoffs: int = 0          # prefill->decode KV shipments


class Cluster:
    def __init__(self, engines: list[Engine], ccfg: ClusterConfig,
                 clock: Optional[ClusterClock] = None,
                 engine_factory: Optional[Callable[[str], Engine]] = None):
        assert len(engines) >= 1
        self.engines = engines
        self.ccfg = ccfg
        self.clock = clock or ClusterClock()
        self.stats = ClusterStats()
        self.seen_programs: set[str] = set()
        # shared telemetry plane (attach_telemetry); None = disabled
        self.obs = None
        # the single chronological cluster event stream (replay traces):
        # migrate/scale/drain/retire records here, per-step decision
        # records appended by the replay harness's on_step
        self.trace: list[dict] = []

        # ------------------------------------------------------- elasticity
        self.engine_factory = engine_factory
        # optional role-specific factory: prefill replicas get their own
        # EngineConfig (build_cluster installs it); falls back to the
        # decode factory when absent
        self.prefill_factory: Optional[Callable[[str], Engine]] = None
        self.scaling = ScalingPolicy(ccfg.scaling) if ccfg.scaling else None
        self.draining: dict[str, float] = {}       # engine_id -> drain start
        self.retired_engines: list[Engine] = []
        self._active_since: dict[str, float] = {
            e.engine_id: 0.0 for e in engines}
        self._replica_seconds: float = 0.0         # accumulated at retire
        self._next_replica = len(engines)          # fresh ids, never reused

        from repro_torch.serving.kvstore.transfer import resolve_bandwidth
        self._peer_bw = resolve_bandwidth(ccfg.peer_curve, ccfg.peer_bw)
        self.links: dict[tuple[str, str], PeerLink] = {}
        if any(e.kvstore is None for e in engines) \
                and ccfg.router == "kv_aware_migrate":
            raise ValueError("kv_aware_migrate needs an offload tier on "
                             "every replica (EngineConfig.offload)")

        self.router = ClusterRouter(
            self, ccfg.router, migrate_min_gain_s=ccfg.migrate_min_gain_s,
            affinity_balance=ccfg.affinity_balance,
            affinity_slack=ccfg.affinity_slack)
        self.clock.on_advance(self._pump_links)
        for e in engines:
            self._wire(e)

    # ------------------------------------------------------------ plumbing
    def _wire(self, e: Engine) -> None:
        """Attach one replica to the fleet: peer channels + links to every
        existing replica, the shared-clock pre-step hook, the per-replica
        queue-ETA feed into the TTL solver, and (prefill replicas) the
        post-step KV handoff. Used both at construction and at runtime
        scale-up, so a late-added replica is indistinguishable from a
        seed one."""
        if e.kvstore is not None:
            e.kvstore.transfer.attach_peer_channels(
                self._peer_bw, self._peer_bw, self.ccfg.peer_latency_s)
            for other in self.engines:
                # only peers whose NIC channels are already attached —
                # during construction engines wire one by one, so each
                # pairing is created exactly once (by the later engine)
                if other is e or other.kvstore is None or \
                        other.kvstore.transfer.peer_out is None:
                    continue
                self.links[(e.engine_id, other.engine_id)] = \
                    PeerLink(e, other)
                self.links[(other.engine_id, e.engine_id)] = \
                    PeerLink(other, e)
        # per-replica queue ETA replaces the fleet-average T-bar in the
        # TTL solver (queue-ETA-aware reload pricing)
        e.scheduler.handler.queue_eta_fn = \
            (lambda eng=e: eng.queue_eta(eng.clock))
        # engines step on the shared clock; pre hooks keep it monotone
        # and pump in-flight migration arrivals before admission
        e.pre_step_hooks.append(lambda _e, t: self.clock.advance(t))
        if e.role == "prefill":
            e.post_step_hooks.append(
                lambda eng, ev, t: self._prefill_handoff(eng, ev, t))
        if self.ccfg.check_each_step:
            e.post_step_hooks.append(lambda _e, _ev, t: self.check(t))
        if self.obs is not None:
            e.attach_telemetry(self.obs)

    def attach_telemetry(self, tel) -> None:
        """Wire every replica (and the cluster/router lanes) into one
        shared :class:`~repro_torch.obs.Telemetry` plane. Call after
        construction — the peer channels already exist by then, so the
        NIC lanes (``r0/peer_out`` ...) are traced too. Replicas added
        later by the autoscaler attach themselves on scale-up."""
        self.obs = tel
        for e in self.engines:
            e.attach_telemetry(tel)

    def export_trace(self, now: Optional[float] = None) -> dict:
        """Perfetto document of the attached plane, clipped at ``now``
        (default: the shared cluster clock) so an export taken while a
        migration is still on a PeerLink renders its NIC spans truncated
        at the clock instead of running into the virtual future — the
        live ``/traces`` endpoint and mid-run snapshots both use this."""
        assert self.obs is not None, "attach_telemetry first"
        from repro_torch.obs import export as obs_export
        return obs_export.to_chrome(self.obs.trace,
                                    clip_at=self.clock.now
                                    if now is None else now)

    def _pump_links(self, now: float) -> None:
        """Arrival pump: migrations whose flight ended become plain target
        tier residents (the in-flight protection pin is released)."""
        for link, e in [(l, self.engine_by_id(l.dst_id))
                        for l in self.links.values()]:
            for m in link.pump(now):
                e.kvstore.unpin(m.program_id)

    # ----------------------------------------------------------- identity
    def engine_by_id(self, engine_id: str) -> Engine:
        return next(e for e in self.engines if e.engine_id == engine_id)

    def _resolve(self, ref) -> Engine:
        """Engine from an id string or a (legacy) list index."""
        return self.engines[ref] if isinstance(ref, int) \
            else self.engine_by_id(ref)

    def _index_of(self, engine_id: str) -> int:
        return next(i for i, e in enumerate(self.engines)
                    if e.engine_id == engine_id)

    def decode_pool(self) -> list[Engine]:
        """Active (non-draining) decode replicas — the placement pool."""
        return [e for e in self.engines
                if e.role == "decode" and e.engine_id not in self.draining]

    def prefill_pool(self) -> list[Engine]:
        return [e for e in self.engines
                if e.role == "prefill" and e.engine_id not in self.draining]

    def all_engines(self) -> list[Engine]:
        """Active + retired — the accounting universe for summaries."""
        return self.engines + self.retired_engines

    # ----------------------------------------------------------- elasticity
    def add_engine(self, now: float, role: str = "decode") -> Engine:
        """Runtime scale-up: build a fresh replica (never reusing an id),
        wire it, and make it routable immediately."""
        assert self.engine_factory is not None, \
            "runtime scaling needs an engine_factory (build_cluster " \
            "installs one)"
        prefix = "pf" if role == "prefill" else "r"
        eid = f"{prefix}{self._next_replica}"
        self._next_replica += 1
        factory = self.prefill_factory \
            if role == "prefill" and self.prefill_factory is not None \
            else self.engine_factory
        e = factory(eid)
        e.role = role
        self.engines.append(e)      # in-place: the simulator shares the list
        self._active_since[eid] = now
        self._wire(e)
        self.stats.scale_ups += 1
        self.trace.append({"ev": "scale_up", "replica": eid,
                           "t": round(now, 9), "role": role})
        if self.obs is not None:
            self.obs.router_event("scale_up", eid, now,
                                  args={"replica": eid, "role": role})
        return e

    def begin_drain(self, engine_id: str, now: float) -> None:
        """Runtime scale-down, phase 1: the replica stops taking
        placements; ``tick`` evacuates its KV and retires it once empty."""
        if engine_id in self.draining:
            return
        self.engine_by_id(engine_id)              # must exist
        self.draining[engine_id] = now
        self.stats.scale_downs += 1
        self.trace.append({"ev": "drain", "replica": engine_id,
                           "t": round(now, 9)})
        if self.obs is not None:
            self.obs.router_event("drain", engine_id, now,
                                  args={"replica": engine_id})

    def _drain_pump(self, now: float) -> None:
        """Evacuate a draining replica: every pinned/tiered KV entry not
        still needed by a queued request migrates to the cheapest
        surviving decode replica (or is dropped when nowhere can land —
        recompute-elsewhere beats blocking retirement forever)."""
        for eid in list(self.draining):
            src = self.engine_by_id(eid)
            busy = {r.program_id for r in src.running} | \
                {r.program_id for r in src.scheduler.waiting}
            # pins first (complete copies), then tier entries
            pids = [p for p in list(src.scheduler.pinned) if p not in busy]
            if src.kvstore is not None:
                pids += [p for p, en in list(src.kvstore.entries.items())
                         if p not in busy and p not in pids
                         and not en.pinned]   # inbound flights land first
            for pid in pids:
                dst = self._drain_target(pid, src, now)
                before = self.stats.migrated_tokens
                if dst is not None and \
                        self.migrate(pid, eid, dst.engine_id, now,
                                     reason="drain"):
                    self.stats.drained_tokens += \
                        self.stats.migrated_tokens - before
                    self.router.session_map[pid] = dst.engine_id
                else:
                    self.drop_replica_kv(pid, eid, now)
                    self.router.session_map.pop(pid, None)

    def _drain_target(self, pid: str, src: Engine,
                      now: float) -> Optional[Engine]:
        pool = [e for e in self.decode_pool() if e is not src]
        if not pool:
            return None
        pin = src.scheduler.pinned.get(pid)
        if pin is not None:
            nbytes = pin.tokens * src.scheduler._kv_bytes_per_token
        else:
            entry = src.kvstore.entries.get(pid)
            nbytes = entry.nbytes if entry is not None else 0.0
        pool = [e for e in pool if self.can_land(e.engine_id, nbytes)]
        if not pool:
            return None
        return min(pool, key=lambda e: (e.queue_eta(now), e.engine_id))

    def _maybe_retire(self, now: float) -> None:
        for eid in list(self.draining):
            e = self.engine_by_id(eid)
            if e.running or e.scheduler.waiting or e.scheduler.pinned:
                continue
            if e.kvstore is not None and e.kvstore.entries:
                continue
            # no flight (or arrived-but-unpumped record) may touch a
            # retiring replica's links — the arrival pump must run first
            if any(l.ledger
                   for (s, d), l in self.links.items()
                   if s == eid or d == eid):
                continue
            self._replica_seconds += now - self._active_since.pop(eid, now)
            self.engines.remove(e)     # in-place: router/simulator see it
            self.retired_engines.append(e)
            for key in [k for k in self.links if eid in k]:
                del self.links[key]
            self.router.remove_engine(eid)
            del self.draining[eid]
            self.stats.retired += 1
            self.trace.append({"ev": "retire", "replica": eid,
                               "t": round(now, 9)})
            if self.obs is not None:
                self.obs.router_event("retire", eid, now,
                                      args={"replica": eid})

    def tick(self, now: float) -> None:
        """The elastic heartbeat, called by the simulator on every clock
        advance: scaling decisions, drain evacuation, retirement. A no-op
        for static fleets (no policy, nothing draining)."""
        self.clock.advance(now)
        if self.scaling is not None:
            self.scaling.step(self, now)
        if self.draining:
            self._drain_pump(now)
            self._maybe_retire(now)

    def replica_seconds(self, now: float) -> float:
        """Total replica-time provisioned so far — the fleet-cost metric
        the autoscaling bench reports (replica-hours = this / 3600)."""
        return self._replica_seconds + sum(
            now - t0 for t0 in self._active_since.values())

    # -------------------------------------------- prefill -> decode handoff
    def _prefill_handoff(self, e: Engine, ev, now: float) -> None:
        """Disaggregation contract: KV finished on a prefill replica
        ALWAYS moves to a decode replica — at the step end, over the
        PeerLink (``admit_migrated`` lands it there), with the program
        re-homed so its next turn never returns to the prefill pool."""
        end = now + ev.duration
        for r, _tool in ev.tool_started:
            pid = r.program_id
            dst = self._drain_target(pid, e, end)
            if dst is not None and \
                    self.migrate(pid, e.engine_id, dst.engine_id, end,
                                 reason="handoff"):
                self.stats.prefill_handoffs += 1
                self.router.session_map[pid] = dst.engine_id
            else:
                # nowhere can land: drop (the next turn recomputes on a
                # decode replica) rather than let state pool here
                self.drop_replica_kv(pid, e.engine_id, end)
                self.router.session_map.pop(pid, None)

    # ----------------------------------------------------------- migration
    def can_land(self, dst, nbytes: float) -> bool:
        """Conservative capacity pre-check: the target tier store must
        have guaranteed room (free DRAM *or* free SSD for the whole run)
        so an in-flight migration can never be dropped at landing."""
        kv = self._resolve(dst).kvstore
        if kv is None or nbytes <= 0:
            return False
        st = kv
        blocks = st._blocks_for(nbytes)
        return st.dram_free_blocks() >= blocks or \
            (st.cfg.ssd_blocks > 0 and st.ssd_free_blocks() >= blocks)

    def migration_eta(self, pid: str, src_ref, dst_ref,
                      now: float) -> float:
        """Peek: seconds until `pid`'s KV (as the source holds it now)
        would land in the target's DRAM tier — staging readiness + both
        NIC hops, nothing committed."""
        src = self._resolve(src_ref)
        dst = self._resolve(dst_ref)
        link = self.links.get((src.engine_id, dst.engine_id))
        if link is None or src.kvstore is None:
            return math.inf
        te = src.kvstore.transfer
        pin = src.scheduler.pinned.get(pid)
        if pin is not None:
            nbytes = pin.tokens * src.scheduler._kv_bytes_per_token
            _, staged = te.d2h.eta(nbytes, now)
        else:
            entry = src.kvstore.entries.get(pid)
            if entry is None:
                return math.inf
            nbytes = entry.nbytes
            staged = entry.dram_ready
            if entry.ssd_blocks:
                _, up = te.ssd_read.eta(entry.ssd_bytes, now,
                                        earliest=entry.ssd_ready)
                staged = max(staged, up)
        return link.eta(nbytes, now, staged_ready=staged) - now

    def _cancel_inflight(self, pid: str) -> None:
        """Forget any undelivered ledger record for `pid` (its landed
        entry is being consumed by a drop/re-migration before the flight
        clock ran out — without this the ledger would report the entry
        'lost in flight')."""
        for link in self.links.values():
            kept = []
            for m in link.ledger:
                if m.program_id == pid and not m.delivered:
                    m.delivered = True
                    link.n_delivered += 1
                else:
                    kept.append(m)
            link.ledger = kept

    def migrate(self, pid: str, src_ref, dst_ref, now: float,
                reason: str = "rehome") -> bool:
        """Commit a cross-replica KV migration. Returns False (and leaves
        the source untouched) when the target cannot guarantee room.
        ``reason`` classifies the flight for attribution: ``rehome``
        (router placement win), ``drain`` (scale-down evacuation) or
        ``handoff`` (prefill->decode disaggregation shipment)."""
        src = self._resolve(src_ref)
        dst = self._resolve(dst_ref)
        link = self.links.get((src.engine_id, dst.engine_id))
        if link is None or src.kvstore is None or dst.kvstore is None:
            return False
        drift = self.obs.drift if self.obs is not None else None
        # drift control pair: peek the ETA while the source still holds
        # the entry (migrate_out/extract mutate that state below)
        peek = self.migration_eta(pid, src.engine_id, dst.engine_id, now) \
            if drift is not None else math.inf
        te = src.kvstore.transfer
        pin = src.scheduler.pinned.get(pid)
        if pin is not None:
            tokens = pin.tokens
            nbytes = tokens * src.scheduler._kv_bytes_per_token
            if not self.can_land(dst.engine_id, nbytes):
                self.stats.migration_denied += 1
                return False
            # HBM -> host staging is a real d2h transfer on the source;
            # migrate_out frees the pin without a home-tier demotion (the
            # backend keeps a host copy that travels with the entry)
            src.scheduler.migrate_out(pid, now, keep_copy=True)
            staged = te.write_dram(nbytes, now).end
            # a stale tier entry can coexist with the pin (a radix-tie
            # admission leaves the offload entry unconsumed): the pin is
            # the complete copy, so the stale entry must not stay behind
            if src.kvstore.entries.get(pid) is not None:
                self._cancel_inflight(pid)
                src.kvstore.extract(pid)
        else:
            entry = src.kvstore.entries.get(pid)
            if entry is None or entry.tokens <= 0:
                return False
            tokens, nbytes = entry.tokens, entry.nbytes
            if not self.can_land(dst.engine_id, nbytes):
                self.stats.migration_denied += 1
                return False
            self._cancel_inflight(pid)   # re-migrating a mid-flight entry
            src.kvstore.extract(pid)
            staged = entry.dram_ready
            if entry.ssd_blocks:
                # the SSD suffix must be read up before the NIC can send
                up = te.read_ssd(entry.ssd_bytes, now,
                                 earliest=entry.ssd_ready)
                staged = max(staged, up.end)
            src.scheduler._log("migrate_out", pid, tokens)
        m = link.send(pid, tokens, nbytes, now, staged_ready=staged)
        landed = dst.kvstore.admit_migrated(pid, tokens, nbytes,
                                                  now, ready_at=m.arrive)
        assert landed is not None, \
            f"migration of {pid} dropped at landing despite can_land"
        dst.kvstore.pin(pid)      # in-flight protection until arrive
        src_hc = getattr(src.backend, "host_caches", None)
        dst_hc = getattr(dst.backend, "host_caches", None)
        if src_hc is not None and dst_hc is not None and pid in src_hc:
            dst_hc[pid] = src_hc.pop(pid)   # staged copy travels with it
        self.stats.migrations += 1
        self.stats.migrated_tokens += tokens
        self.stats.migrated_bytes += nbytes
        self.trace.append({"ev": "migrate", "pid": pid,
                           "src": src.engine_id, "dst": dst.engine_id,
                           "t": round(now, 9), "arrive": round(m.arrive, 9),
                           "tokens": tokens, "reason": reason})
        if self.obs is not None:
            self.obs.cluster_migration(pid, src.engine_id, dst.engine_id,
                                       now, m.arrive, tokens, nbytes,
                                       reason=reason)
            if drift is not None and math.isfinite(peek):
                drift.observe("migration_eta", now, peek, m.arrive - now)
        return True

    def drop_replica_kv(self, pid: str, ref, now: float) -> int:
        """Cold re-home / scatter policies: whatever KV the replica still
        holds for `pid` is genuinely dropped (recompute-elsewhere was the
        cheaper decision) — never left behind to go double-resident."""
        e = self._resolve(ref)
        tokens = e.scheduler.migrate_out(pid, now, keep_copy=False)
        if e.kvstore is not None:
            entry = e.kvstore.entries.get(pid)
            if entry is not None:
                tokens += entry.tokens
                # the entry may still be inbound (scatter policies can
                # re-home faster than the wire): close its ledger record
                # so it reads as dropped, not lost in flight
                self._cancel_inflight(pid)
                e.kvstore.drop(pid)
        self.stats.dropped_tokens += tokens
        if tokens > 0:
            # between-step decision: recorded in the cluster's own trace
            # stream (the per-step decision sinks are already captured)
            self.trace.append({"ev": "rehome_drop", "pid": pid,
                               "replica": e.engine_id,
                               "t": round(now, 9), "tokens": tokens})
            if self.obs is not None:
                self.obs.router_event("rehome_drop", pid, now,
                                      args={"replica": e.engine_id,
                                            "tokens": tokens})
        return tokens

    # -------------------------------------------------------- conservation
    def residency(self, pid: str, now: float) -> list[str]:
        """Where `pid`'s KV currently lives: replica ids (engine-held or
        tier-resident — one location per replica) and/or PeerLink names
        for undelivered migrations."""
        inflight: dict[str, str] = {}   # dst engine_id -> link label
        for link in self.links.values():
            for m in link.in_flight(now):
                if m.program_id == pid:
                    inflight[link.dst_id] = f"link:{m.src}->{m.dst}"
        locs: list[str] = []
        for e in self.engines:
            held = pid in e.scheduler.pinned or \
                any(r.program_id == pid for r in e.running)
            entry = e.kvstore.entries.get(pid) \
                if e.kvstore is not None else None
            if entry is not None and e.engine_id in inflight:
                locs.append(inflight[e.engine_id])   # still on the wire
            elif held or entry is not None:
                locs.append(e.engine_id)
        return locs

    def violations(self, now: float) -> list[str]:
        """Conservation audit: programs whose KV is double-resident, and
        in-flight migrations whose landed entry vanished mid-flight."""
        out = []
        for pid in sorted(self.seen_programs):
            locs = self.residency(pid, now)
            if len(locs) > 1:
                out.append(f"{pid} double-resident: {locs}")
        for link in self.links.values():
            dst = self.engine_by_id(link.dst_id)
            for m in link.in_flight(now):
                held = m.program_id in dst.scheduler.pinned or \
                    any(r.program_id == m.program_id for r in dst.running)
                entry = dst.kvstore.entries.get(m.program_id)
                if entry is None and not held:
                    out.append(f"{m.program_id} lost in flight on "
                               f"link:{m.src}->{m.dst}")
        return out

    def check(self, now: float) -> None:
        """Assert conservation plus every replica's pool invariants."""
        bad = self.violations(now)
        assert not bad, bad
        for e in self.engines:
            e.blocks.check()
            if e.kvstore is not None:
                e.kvstore.check()
            runtime = getattr(e.backend, "runtime", None)
            if runtime is not None:
                runtime.check(getattr(e.backend, "prefix_index", None))

    # --------------------------------------------------------------- run
    def run(self, programs, max_seconds: float = 36000.0,
            on_step=None) -> Summary:
        self.router.register_programs(programs)
        sim = ClusterSimulator(self, max_seconds, on_step=on_step)
        sim.add_programs(programs)
        return sim.run()


class ClusterSimulator(Simulator):
    """The event runner on the cluster's shared clock: arrivals are
    routed at cluster time (so migration pricing sees current queues and
    in-flight state), each engine step advances the clock through its
    pre-step hook, and the elastic heartbeat (scaling, drain, retire)
    runs before every arrival delivery. The engine-ready map follows the
    fleet as replicas come and go; retired replicas keep contributing
    their program stats to the summary."""

    def __init__(self, cluster: Cluster, max_seconds: float = 36000.0,
                 on_step=None):
        super().__init__(cluster.engines, cluster.router, max_seconds,
                         on_step=on_step)
        self.cluster = cluster

    def _deliver_arrivals(self) -> None:
        self.cluster.tick(self.now)
        # reconcile the ready-map with the (possibly resized) fleet
        live = {e.engine_id for e in self.cluster.engines}
        for eid in list(self._engine_ready):
            if eid not in live:
                del self._engine_ready[eid]
        for eid in live:
            self._engine_ready.setdefault(eid, self.now)
        super()._deliver_arrivals()

    def _summary_engines(self):
        return self.cluster.all_engines()


def prefill_engine_config(ecfg: EngineConfig,
                          chunk_scale: int = 4) -> EngineConfig:
    """The prefill-pool variant of a decode EngineConfig: a much larger
    per-step chunk budget (the pool exists to swallow long first-turn
    prefills) and TTL pinning off — a prefill replica hands every
    finished KV to a decode replica immediately, so retaining it across
    a tool call would only fight the handoff for HBM. ``fcfs_program``
    keeps the program-level FCFS ordering without retention."""
    return dataclasses.replace(
        ecfg, policy="fcfs_program",
        chunk_size=max(1, ecfg.chunk_size * chunk_scale))


def build_cluster(arch: ModelConfig, ecfg: EngineConfig,
                  ccfg: ClusterConfig = ClusterConfig(),
                  hw: HardwareProfile = HardwareProfile(),
                  prefill_ecfg: Optional[EngineConfig] = None) -> Cluster:
    """``n_replicas`` decode replicas (+ ``prefill_replicas`` prefill-only
    ones) sharing one calibrated cost model (profiles are per-(model,
    hardware), not per-replica), with an ``engine_factory`` installed so
    the scaling policy can grow the fleet at runtime. Prefill replicas
    use ``prefill_ecfg`` (default :func:`prefill_engine_config`:
    larger chunk budget, no TTL pins) — both the seed pool and any
    replica the autoscaler adds later with ``role="prefill"``."""
    pcfg = prefill_ecfg if prefill_ecfg is not None \
        else prefill_engine_config(ecfg)
    engines: list[Engine] = []
    cost = None
    for i in range(ccfg.n_replicas):
        eng = Engine(arch, ecfg, hw, cost=cost, engine_id=f"r{i}")
        cost = cost if cost is not None else eng.cost
        engines.append(eng)
    for i in range(ccfg.prefill_replicas):
        eng = Engine(arch, pcfg, hw, cost=cost, engine_id=f"pf{i}")
        eng.role = "prefill"
        cost = cost if cost is not None else eng.cost
        engines.append(eng)
    shared = cost

    def factory(eid: str, _arch=arch, _ecfg=ecfg, _hw=hw) -> Engine:
        return Engine(_arch, _ecfg, _hw, cost=shared, engine_id=eid)

    def pf_factory(eid: str, _arch=arch, _ecfg=pcfg, _hw=hw) -> Engine:
        return Engine(_arch, _ecfg, _hw, cost=shared, engine_id=eid)

    cluster = Cluster(engines, ccfg, engine_factory=factory)
    cluster.prefill_factory = pf_factory
    return cluster
