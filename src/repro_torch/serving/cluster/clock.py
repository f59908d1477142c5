"""Shared virtual clock for a replica fleet.

Every engine replica already runs on an externally-driven clock
(``Engine.step(now)``); the cluster layer needs one *shared* notion of
"now" that (a) is monotone across interleaved replica steps and (b) is
readable outside a step — the router prices placement decisions at
arrival-delivery time, between steps. (Global program-level FCFS does
not live here: every replica's scheduler orders its queue by the global
``program_arrival_time``, with the process-wide ``request_id`` counter
as the deterministic tie-break — see ``repro_torch.core.policies``.)

The clock also owns the deferred-delivery timers of the
:class:`~repro_torch.serving.cluster.peer.PeerLink` ledgers: ``advance``
moves virtual time forward and pumps every registered callback, which
is how in-flight migrations become target-tier residency exactly at
their interconnect arrival time.
"""
from __future__ import annotations

from typing import Callable


class ClusterClock:
    """Monotone shared virtual time + migration-arrival pump."""

    def __init__(self):
        self.now = 0.0
        # pumped (in registration order, deterministic) on every advance:
        # fn(now) — peer-link ledgers deliver arrived migrations here
        self._on_advance: list[Callable[[float], None]] = []

    def on_advance(self, fn: Callable[[float], None]) -> None:
        self._on_advance.append(fn)

    def advance(self, t: float) -> float:
        """Move virtual time forward to ``t`` (never backward) and pump
        the deferred-delivery callbacks. Returns the new now."""
        if t > self.now:
            self.now = t
        for fn in self._on_advance:
            fn(self.now)
        return self.now
