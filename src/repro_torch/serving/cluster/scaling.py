"""Runtime autoscaling for the replica fleet.

The policy watches the same two signals the TTL model already trades
against each other — the per-replica queueing delay
(:meth:`Engine.queue_eta`, the paper's out-of-order delay) and KV pool
pressure (block-pool occupancy) — and turns them into add/remove-replica
decisions on the shared virtual clock:

- **scale up** when the mean decode-pool ``queue_eta`` stays above
  ``scale_up_eta_s`` (or any replica's block pool stays above
  ``pool_pressure``) for ``up_hold_s`` seconds;
- **scale down** when the mean ``queue_eta`` stays below
  ``scale_down_eta_s`` *and* every pool's **live** occupancy — blocks
  backing currently-running requests — is below half the pressure
  threshold for ``down_hold_s`` seconds — the victim (the least-loaded
  decode replica) then *drains*: it stops taking placements, in-flight
  programs finish, and its pinned/tiered KV migrates to survivors over
  the PeerLink machinery before the replica retires.

The up- and down-guards deliberately read *different* pool signals.
Total occupancy (``used/total``) is the up-signal because a full pool
forces evictions and preemptions regardless of queue depth.  But total
occupancy includes TTL pins and shared prefix blocks — cache, which in
steady state keeps the pool nearly full by design and which a drain
migrates or rebuilds elsewhere.  Gating scale-down on it would freeze
the fleet at its high-water mark; only request-held blocks measure the
demand that survivors must actually absorb.

Hysteresis is explicit: separate up/down thresholds, hold timers that
reset whenever the signal leaves the band, and a ``cooldown_s`` window
after every action so a bursty arrival wave cannot thrash the fleet
(the drain itself also takes wall-clock, which naturally rate-limits
down-scaling). All state is driven by the deterministic virtual clock,
so autoscaled traces replay byte-identically.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class ScalingConfig:
    min_replicas: int = 1
    max_replicas: int = 6
    scale_up_eta_s: float = 1.0       # aggregate ETA above -> pressure up
    scale_down_eta_s: float = 0.2     # aggregate ETA below -> pressure down
    # how the per-replica queue ETAs collapse into the scaling signal:
    # "mean" (historic default) washes out a single hot replica among
    # idle peers; "p90" (nearest-rank) and "max" keep tail congestion
    # visible so one overloaded replica can still trigger scale-up.
    eta_aggregate: str = "mean"       # "mean" | "p90" | "max"
    pool_pressure: float = 0.9        # any block pool above -> pressure up
    up_hold_s: float = 0.5            # signal persistence before acting
    down_hold_s: float = 4.0
    cooldown_s: float = 4.0           # dead time after any action
    # the policy may also keep up to this many prefill-only replicas: the
    # first scale-up adds one (new-session prefill is the bulk of a wave
    # front), and once the decode pool is back at min_replicas the next
    # scale-down drains it — so a trough runs min_replicas total, not
    # min_replicas + an idle prefill replica.
    prefill_max: int = 0


class ScalingPolicy:
    """Hysteretic queue-ETA + pool-pressure autoscaler.

    ``step(cluster, now)`` is called by :meth:`Cluster.tick` on every
    clock advance; at most one scaling action fires per call.
    """

    def __init__(self, cfg: Optional[ScalingConfig] = None):
        self.cfg = cfg or ScalingConfig()
        self._over_since: Optional[float] = None
        self._under_since: Optional[float] = None
        self._last_action: float = -1e30
        self.actions: list[dict] = []      # decision log (trace-adjacent)

    # ------------------------------------------------------------- signals
    def signals(self, cluster, now: float) -> tuple[float, float, int]:
        """(aggregate decode-pool queue ETA, max pool occupancy, pool
        size) — the ETA aggregate follows ``cfg.eta_aggregate``."""
        pool = cluster.decode_pool()
        if not pool:
            return 0.0, 0.0, 0
        etas = sorted(e.queue_eta(now) for e in pool)
        agg = self.cfg.eta_aggregate
        if agg == "max":
            eta = etas[-1]
        elif agg == "p90":
            eta = etas[min(len(etas) - 1,
                           max(0, -(-9 * len(etas) // 10) - 1))]
        else:
            assert agg == "mean", f"unknown eta_aggregate {agg!r}"
            eta = sum(etas) / len(etas)
        press = max((e.blocks.used / e.blocks.total) if e.blocks.total
                    else 0.0 for e in pool)
        return eta, press, len(pool)

    @staticmethod
    def live_pressure(cluster) -> float:
        """Max fraction of any decode pool held by *running* requests.

        Excludes TTL pins and shared prefix blocks: those are cache, kept
        hot by design, and a drain migrates them to survivors — they say
        nothing about whether the fleet can shrink."""
        pool = cluster.decode_pool()
        return max(((sum(e.blocks.alloc.values()) / e.blocks.total)
                    if e.blocks.total else 0.0 for e in pool), default=0.0)

    # ---------------------------------------------------------------- step
    def step(self, cluster, now: float) -> Optional[str]:
        cfg = self.cfg
        eta, press, n = self.signals(cluster, now)
        if n == 0:
            return None
        over = eta >= cfg.scale_up_eta_s or press >= cfg.pool_pressure
        under = (eta <= cfg.scale_down_eta_s
                 and self.live_pressure(cluster) <= cfg.pool_pressure / 2)
        # hold timers reset whenever the signal leaves its band
        if over:
            if self._over_since is None:
                self._over_since = now
        else:
            self._over_since = None
        if under:
            if self._under_since is None:
                self._under_since = now
        else:
            self._under_since = None
        if now - self._last_action < cfg.cooldown_s:
            return None
        if (over and self._over_since is not None
                and now - self._over_since >= cfg.up_hold_s):
            role = None
            if cfg.prefill_max and len(cluster.prefill_pool()) < cfg.prefill_max:
                role = "prefill"
            elif n < cfg.max_replicas:
                role = "decode"
            if role is not None:
                e = cluster.add_engine(now, role=role)
                self._last_action = now
                self._over_since = None
                self.actions.append({"act": "up", "t": round(now, 9),
                                     "replica": e.engine_id,
                                     "eta": round(eta, 6),
                                     "pressure": round(press, 6)})
                return "up"
        if (under and self._under_since is not None
                and now - self._under_since >= cfg.down_hold_s):
            victim = None
            if n > cfg.min_replicas:
                victim = min(cluster.decode_pool(),
                             key=lambda e: (e.load(), e.engine_id))
            elif cfg.prefill_max and cluster.prefill_pool():
                victim = min(cluster.prefill_pool(),
                             key=lambda e: (e.load(), e.engine_id))
            if victim is not None:
                cluster.begin_drain(victim.engine_id, now)
                self._last_action = now
                self._under_since = None
                self.actions.append({"act": "down", "t": round(now, 9),
                                     "replica": victim.engine_id,
                                     "eta": round(eta, 6),
                                     "pressure": round(press, 6)})
                return "down"
        return None
