"""KV-aware cluster routing: Continuum's TTL economics *between* engines.

The single-engine scheduler already prices retention as
``reload/recompute cost vs queueing delay`` (Eq. 2). The moment there
are replicas, the same trade-off becomes a *placement* problem: a
program returning from a tool call may find its home replica congested
while a peer is idle but cold. For every returning request the router
scores each replica with the TTL model's ingredients:

    home  (KV pinned)        cost = queue_eta(home)
    home  (KV in tiers)      cost = queue_eta(home) + reload_eta(home)
                                    + reload collateral
    peer  (recompute cold)   cost = queue_eta(peer) + recompute_seconds
    peer  (migrate the KV)   cost = max(queue_eta(peer), flight_eta)
                                    + h2d_seconds(peer)
                                    + reload collateral

``queue_eta`` is :meth:`Engine.queue_eta` (the same per-replica estimate
the TTL solver now takes); ``reload_eta`` is the tier store's queue-aware
chain; ``flight_eta`` is the PeerLink's three-hop peek; migration
overlaps the target queue (the KV flies while the request waits), while
a recompute cannot (it needs the accelerator). **Reload collateral** is
the fleet price of the engine's stall semantics: a step's duration is
``max(compute, reload)``, so every co-scheduled request on the admitting
replica pays the part of the reload that exceeds the step it was going
to run anyway — ``max(0, reload - est_step) * len(running)`` is added to
any option that triggers a reload there. The cheapest option wins;
``migrate_min_gain_s`` adds hysteresis so marginal wins don't thrash.

Elastic fleets change *who is placeable*, not the scoring: draining
replicas take no placements (their homes are forcibly re-scored against
the surviving pool, migrating KV out when it wins), retired replicas
drop out of ``session_map`` via :meth:`remove_engine`, and when the
cluster has prefill-only replicas every first-turn/cold prefill routes
to the least-loaded one (its finished KV always migrates to a decode
replica, so a prefill home never persists).

Placement never reorders programs relative to their cluster-wide arrival
order: every scheduler sorts its queue by the *global*
``program_arrival_time`` (program-level FCFS is preserved fleet-wide, a
replica simply serves the FCFS-minimal subset routed to it).

Policies (the bench_cluster grid):

- ``round_robin``      — scatter turns; any KV left behind is dropped.
- ``sticky``           — session affinity, never migrates (the old
                         ``Router(policy="session")`` behavior).
- ``kv_aware``         — cost-scored placement, but a re-home always
                         recomputes cold (the KV never moves).
- ``kv_aware_migrate`` — full model: re-homes ship the KV over the
                         PeerLink when that beats recomputing.

New programs (turn 0) place by shared-prefix affinity with the load
guard of the legacy :class:`~repro_torch.serving.router.Router` (cache heat
never herds the fleet onto one replica); ``round_robin`` scatters,
``sticky`` takes the least-loaded replica.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.types import Program, Request

POLICIES = ("round_robin", "sticky", "kv_aware", "kv_aware_migrate")


class ClusterRouter:
    def __init__(self, cluster, policy: str = "kv_aware_migrate",
                 migrate_min_gain_s: float = 0.0,
                 affinity_balance: float = 1.5, affinity_slack: int = 4):
        assert policy in POLICIES, policy
        self.cluster = cluster
        self.engines = cluster.engines      # the live fleet (shared list)
        self.policy = policy
        self.migrate_min_gain_s = migrate_min_gain_s
        self.affinity_balance = affinity_balance
        self.affinity_slack = affinity_slack
        self.session_map: dict[str, str] = {}    # program -> home engine_id
        self._programs: dict[str, Program] = {}
        self._rr = 0

    # ------------------------------------------------------ compat surface
    def register_programs(self, programs: list[Program]) -> None:
        for p in programs:
            self._programs[p.program_id] = p

    def program_of(self, program_id: str) -> Optional[Program]:
        return self._programs.get(program_id)

    def remove_engine(self, engine_id: str) -> None:
        """A replica retired: forget every session homed there. The drain
        pump re-homed all KV-bearing programs already, so anything still
        pointing here is stateless and simply places fresh next turn."""
        for pid in [p for p, eid in self.session_map.items()
                    if eid == engine_id]:
            del self.session_map[pid]

    # ----------------------------------------------------------- utilities
    def _pool(self) -> list:
        """Placement candidates: active decode replicas."""
        return self.cluster.decode_pool()

    def _engine(self, engine_id: str):
        for e in self.engines:
            if e.engine_id == engine_id:
                return e
        return None

    def _order(self, e) -> int:
        return self.engines.index(e)

    # -------------------------------------------------------------- route
    def route(self, req: Request):
        now = self.cluster.clock.now
        pid = req.program_id
        obs = self.cluster.obs
        self.cluster.seen_programs.add(pid)
        home_id = self.session_map.get(pid)
        home = self._engine(home_id) if home_id is not None else None
        if home is None and home_id is not None:
            # the home retired after this program's KV was drained off it
            self.session_map.pop(pid, None)
            home_id = None
        if self.policy == "round_robin":
            pool = self._pool() or self.engines
            e = pool[self._rr % len(pool)]
            self._rr += 1
            if home is not None and home is not e:
                # the turn runs elsewhere: whatever KV the old home still
                # holds is garbage (conservation: drop, don't leak)
                self.cluster.drop_replica_kv(pid, home.engine_id, now)
            self.session_map[pid] = e.engine_id
            if obs is not None:
                obs.router_event("scatter", pid, now,
                                 args={"replica": e.engine_id,
                                       "turn": req.turn_idx})
            return e
        if home is None:
            e = self._place_new(req)
            self.session_map[pid] = e.engine_id
            if obs is not None:
                obs.router_event(
                    "place_prefill" if e.role == "prefill"
                    else "place_new", pid, now,
                    args={"replica": e.engine_id})
            return e
        if self.policy == "sticky":
            if home.engine_id in self.cluster.draining:
                # sticky never migrates, but a draining home must empty:
                # re-home cold to the least-loaded survivor
                pool = self._pool() or [home]
                e = min(pool, key=lambda x: (x.load(), self._order(x)))
                if e is not home:
                    self.cluster.drop_replica_kv(pid, home.engine_id, now)
                    self.cluster.stats.cold_rehomes += 1
                    self.session_map[pid] = e.engine_id
                    if obs is not None:
                        obs.router_event("rehome_cold", pid, now,
                                         args={"src": home.engine_id,
                                               "dst": e.engine_id,
                                               "turn": req.turn_idx})
                    return e
            if obs is not None:
                obs.router_event("stay_home", pid, now,
                                 args={"replica": home.engine_id,
                                       "turn": req.turn_idx})
            return home
        e, migrate, score = self._best_replica(req, home, now)
        if obs is not None and obs.drift is not None and score is not None:
            # the winner's cost is a time-to-first-compute estimate; the
            # scheduler realizes it as queueing_delay + committed reload
            # at this request's first admission on the chosen replica
            obs.drift.predict("placement_cost", pid, now, score)
        if e is not home:
            shipped = migrate and self.cluster.migrate(
                pid, home.engine_id, e.engine_id, now)
            if not shipped:
                # recompute-cold re-home (or a denied migration): the old
                # home's copy is dropped so the KV is never double-resident
                self.cluster.drop_replica_kv(pid, home.engine_id, now)
                self.cluster.stats.cold_rehomes += 1
            self.session_map[pid] = e.engine_id
            if obs is not None:
                obs.router_event(
                    "rehome_migrate" if shipped else "rehome_cold", pid,
                    now, args={"src": home.engine_id,
                               "dst": e.engine_id,
                               "turn": req.turn_idx})
        elif obs is not None:
            obs.router_event("stay_home", pid, now,
                             args={"replica": home.engine_id,
                                   "turn": req.turn_idx})
        return e

    # ----------------------------------------------------------- placement
    def _place_new(self, req: Request):
        """First turn (or a re-placed stateless program): the prefill
        pool when the fleet is disaggregated (kv-aware policies), else
        prefix-affinity with the herding guard; plain least-loaded for
        ``sticky``."""
        if self.policy != "sticky":
            pf = self.cluster.prefill_pool()
            if pf:
                return min(pf, key=lambda e: (e.load(), self._order(e)))
        pool = self._pool() or self.engines
        loads = {e.engine_id: e.load() for e in pool}
        if self.policy == "sticky":
            return min(pool, key=lambda e: (loads[e.engine_id],
                                            self._order(e)))
        cap = min(loads.values()) * self.affinity_balance \
            + self.affinity_slack
        best, best_key = None, None
        for e in pool:
            match = e.prefix_match_tokens(req) \
                if hasattr(e, "prefix_match_tokens") else 0
            if loads[e.engine_id] > cap:
                match = 0
            key = (-match, loads[e.engine_id], self._order(e))
            if best_key is None or key < best_key:
                best, best_key = e, key
        return best

    def _recompute_seconds(self, engine, req: Request) -> float:
        """Cold-start cost on `engine`: prefill the prompt minus whatever
        its shared-prefix index already covers."""
        cover = engine.prefix_match_tokens(req) \
            if engine.prefix_index is not None else 0
        fn = engine.scheduler.recompute_estimate_fn
        tokens = max(req.prompt_len - cover, 0)
        return fn(tokens) if fn is not None else 0.0

    @staticmethod
    def _reload_collateral(engine, reload_s: float) -> float:
        """Fleet price of admitting a reload on `engine`: the step charges
        ``max(compute, reload)``, so every co-scheduled request pays the
        excess of the reload over the step it was going to run anyway."""
        if reload_s <= 0 or not engine.running:
            return 0.0
        excess = reload_s - engine.est_step_seconds()
        return max(0.0, excess) * len(engine.running)

    def _best_replica(self, req: Request, home, now: float):
        """Score every placeable replica for this returning request;
        returns (winner engine, ship-the-KV?, winner cost or None when
        the decision was forced rather than scored)."""
        pid = req.program_id
        pin = home.scheduler.pinned.get(pid)
        entry = home.kvstore.entries.get(pid) \
            if home.kvstore is not None else None
        if pin is None and entry is not None and entry.pinned:
            # the entry is an inbound migration still on the wire: moving
            # it again before it lands is pure thrash — stay home (the
            # drain pump will move it after landing if home is draining)
            return home, False, None
        kv_tokens = pin.tokens if pin is not None else \
            (entry.tokens if entry is not None else 0)
        nbytes = kv_tokens * home.scheduler._kv_bytes_per_token
        can_migrate = (self.policy == "kv_aware_migrate" and kv_tokens > 0)

        home_draining = home.engine_id in self.cluster.draining
        if kv_tokens == 0:
            pf = self.cluster.prefill_pool()
            if pf:
                # fully cold returner: its prefill belongs on the
                # disaggregated pool (the handoff re-homes it after)
                return min(pf, key=lambda e: (e.load(),
                                              self._order(e))), False, None
        candidates = self._pool()
        if not home_draining and home.role == "decode" \
                and home not in candidates:
            candidates = candidates + [home]
        if not candidates:
            return home, False, None

        home_cost = None
        scored = []
        for e in candidates:
            eta = e.queue_eta(now)
            if e is home:
                if pin is not None:
                    cost = eta                       # hot in HBM
                elif entry is not None:
                    reload = e.kvstore.transfer.reload_eta(
                        entry.dram_bytes, entry.ssd_bytes, now,
                        dram_ready=entry.dram_ready,
                        ssd_ready=entry.ssd_ready)
                    cost = eta + reload \
                        + self._reload_collateral(e, reload)
                else:
                    cost = eta + self._recompute_seconds(e, req)
                home_cost = cost
                scored.append((cost, e, False))
                continue
            cost = eta + self._recompute_seconds(e, req)
            migrate = False
            if can_migrate and self.cluster.can_land(e.engine_id, nbytes):
                flight = self.cluster.migration_eta(
                    pid, home.engine_id, e.engine_id, now)
                h2d = e.kvstore.transfer.h2d.seconds(nbytes)
                mcost = max(eta, flight) + h2d \
                    + self._reload_collateral(e, h2d)
                if mcost < cost:
                    cost, migrate = mcost, True
            scored.append((cost, e, migrate))
        # cheapest replica; ties prefer home, then fleet order
        cost, e, migrate = min(
            scored, key=lambda s: (s[0], 0 if s[1] is home else 1,
                                   self._order(s[1])))
        if e is not home and home_cost is not None \
                and home_cost - cost <= self.migrate_min_gain_s:
            return home, False, home_cost            # hysteresis: stay put
        return e, migrate, cost
