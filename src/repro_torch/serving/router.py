"""Multi-engine routing (paper §6.2 'Real SWE-Agent in Distributed
Setting'): session-aware routing pins a program to the engine that holds
its KV state; baselines: round-robin and least-loaded. Includes straggler
mitigation: a session whose engine is overloaded beyond
``migrate_threshold``x the fleet median is migrated (losing its cache) —
bounding the damage of a slow/hot replica.

``prefix_affinity`` extends session routing for shared-prefix fleets
(:mod:`repro_torch.serving.prefix`): a *new* program is placed on the engine
whose radix index already covers the most of its prompt (so 1000 sessions
of one agent template land where the shared preamble's KV lives), with
load as the tie-breaker; thereafter it is sticky like ``session``. A
cache-hot engine is only preferred while its load stays within
``affinity_balance`` x the least-loaded engine (plus a small absolute
slack) — otherwise affinity degenerates into herding the whole fleet onto
one replica, and re-prefilling a preamble elsewhere is far cheaper than
queueing behind it (SGLang's cache-aware router applies the same guard).
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import numpy as np

from repro_torch.core.types import Program, Request


class Router:
    def __init__(self, engines, policy: Literal["session", "round_robin",
                                                "least_loaded",
                                                "prefix_affinity"] = "session",
                 migrate_threshold: float = 0.0,
                 affinity_balance: float = 1.5, affinity_slack: int = 4):
        self.engines = list(engines)
        self.policy = policy
        self.migrate_threshold = migrate_threshold
        self.affinity_balance = affinity_balance
        self.affinity_slack = affinity_slack
        self.session_map: dict[str, int] = {}
        self._rr = 0
        self._programs: dict[str, Program] = {}
        self.migrations = 0

    def register_programs(self, programs: list[Program]) -> None:
        for p in programs:
            self._programs[p.program_id] = p

    # ---------------------------------------------------- elastic scaling
    def add_engine(self, engine) -> None:
        """Scale up: new replica joins the fleet; new sessions prefer it
        (least-loaded placement does the rebalancing organically)."""
        self.engines.append(engine)

    def remove_engine(self, engine_id: str) -> list[str]:
        """Scale down / node failure: drop the replica and remap its
        sessions (their KV state is lost — next turns re-prefill or reload,
        exactly the failure semantics of a real node loss). Returns the
        remapped program ids."""
        idx = next(i for i, e in enumerate(self.engines)
                   if e.engine_id == engine_id)
        self.engines.pop(idx)
        remapped = []
        for pid, i in list(self.session_map.items()):
            if i == idx:
                del self.session_map[pid]      # re-placed on next request
                remapped.append(pid)
            elif i > idx:
                self.session_map[pid] = i - 1
        return remapped

    def program_of(self, program_id: str) -> Optional[Program]:
        return self._programs.get(program_id)

    def route(self, req: Request):
        if self.policy == "round_robin":
            e = self.engines[self._rr % len(self.engines)]
            self._rr += 1
            return e
        if self.policy == "least_loaded":
            return min(self.engines, key=lambda e: e.load())
        # session-aware: sticky to the engine holding this program's state
        idx = self.session_map.get(req.program_id)
        if idx is None:
            if self.policy == "prefix_affinity":
                idx = self._best_prefix_engine(req)
            else:
                idx = int(np.argmin([e.load() for e in self.engines]))
            self.session_map[req.program_id] = idx
        elif self.migrate_threshold > 0 and len(self.engines) > 1:
            loads = [e.load() for e in self.engines]
            others = [l for i, l in enumerate(loads) if i != idx]
            med = max(float(np.median(others)), 1.0)
            if loads[idx] > self.migrate_threshold * med:
                new_idx = int(np.argmin(loads))
                if new_idx != idx:
                    self.session_map[req.program_id] = new_idx
                    self.migrations += 1
                    idx = new_idx
        return self.engines[idx]

    def _best_prefix_engine(self, req: Request) -> int:
        """Engine whose radix index covers the most of `req`'s prompt;
        least-loaded breaks ties (and the no-match cold start). Engines
        loaded beyond ``affinity_balance`` x the fleet minimum (+ slack)
        forfeit their affinity bonus so cache heat never causes herding."""
        loads = [e.load() for e in self.engines]
        lo = min(loads)
        cap = lo * self.affinity_balance + self.affinity_slack
        best, best_key = 0, None
        for i, e in enumerate(self.engines):
            match = e.prefix_match_tokens(req) \
                if hasattr(e, "prefix_match_tokens") else 0
            if loads[i] > cap:
                match = 0
            key = (-match, loads[i])
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best
