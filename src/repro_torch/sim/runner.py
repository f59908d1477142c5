"""Event-driven runner: drives one or more engines against an agent
workload on a virtual clock. Tool executions become future arrival events
for the program's next turn (the ReAct loop of paper §2.1).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

from repro_torch.core.types import Program, Request
from repro_torch.serving.engine import Engine, StepEvents
from repro_torch.serving.metrics import Summary, summarize
from repro_torch.serving.router import Router
from repro_torch.sim.workload import request_for_turn


@dataclasses.dataclass(order=True)
class _Event:
    time: float
    seq: int
    kind: str = dataclasses.field(compare=False)          # "arrive"
    program: Program = dataclasses.field(compare=False)
    turn_idx: int = dataclasses.field(compare=False)


class Simulator:
    """Multi-engine simulator with a shared virtual clock.

    Engines step independently; the global clock advances to the earliest
    engine completion or pending arrival (discrete-event at engine-step
    granularity)."""

    def __init__(self, engines: list[Engine], router: Optional[Router] = None,
                 max_seconds: float = 36000.0, on_step=None):
        self.engines = engines
        self.router = router or Router(engines)
        self.max_seconds = max_seconds
        self.events: list[_Event] = []
        self._seq = 0
        self.now = 0.0
        self._engine_ready = {e.engine_id: 0.0 for e in engines}
        # called as on_step(engine, StepEvents, now) after every non-idle
        # engine step — replay/decision-log capture and per-step invariant
        # checking (the differential harness and the fuzz suites)
        self.on_step = on_step

    def add_programs(self, programs: list[Program]) -> None:
        for p in programs:
            self._push(p.arrival_time, p, 0)

    def _push(self, t: float, program: Program, turn_idx: int) -> None:
        self._seq += 1
        heapq.heappush(self.events, _Event(t, self._seq, "arrive", program,
                                           turn_idx))

    # ------------------------------------------------------------------ run
    def run(self) -> Summary:
        stall = 0
        while self.now < self.max_seconds:
            prev_now = self.now
            self._deliver_arrivals()
            busy = [e for e in self.engines
                    if e.has_work and self._engine_ready[e.engine_id] <= self.now]
            if not busy:
                next_times = [self._engine_ready[e.engine_id]
                              for e in self.engines if e.has_work]
                if self.events:
                    next_times.append(self.events[0].time)
                if not next_times:
                    break                       # all drained
                self.now = max(self.now, min(next_times))
                continue
            for e in busy:
                ev = e.step(self.now)
                if ev.idle:
                    self._engine_ready[e.engine_id] = self.now
                    continue
                end = self.now + ev.duration
                self._engine_ready[e.engine_id] = end
                self._handle_events(e, ev, end)
                if self.on_step is not None:
                    self.on_step(e, ev, self.now)
            # advance to the earliest ready engine or next arrival
            cands = [t for t in self._engine_ready.values() if t > self.now]
            if self.events:
                cands.append(self.events[0].time)
            if cands:
                self.now = max(self.now, min(cands))
            # no-progress guard (e.g. waiting work that can never admit)
            stall = stall + 1 if self.now == prev_now else 0
            if stall > 10000:
                break
        return self.summary()

    def _deliver_arrivals(self) -> None:
        while self.events and self.events[0].time <= self.now:
            ev = heapq.heappop(self.events)
            req = request_for_turn(ev.program, ev.turn_idx, max(ev.time, self.now))
            engine = self.router.route(req)
            engine.submit(req, self.now)

    def _handle_events(self, engine: Engine, ev: StepEvents, end: float) -> None:
        for req, tool in ev.tool_started:
            prog = self.router.program_of(req.program_id)
            if prog is not None and req.turn_idx + 1 < prog.num_turns:
                self._push(end + req.tool_duration, prog, req.turn_idx + 1)

    # -------------------------------------------------------------- results
    def _summary_engines(self) -> list[Engine]:
        """Engines whose stats enter the summary — elastic clusters
        override to include replicas that retired mid-run."""
        return self.engines

    def summary(self) -> Summary:
        programs = []
        total_tokens = 0
        prefill_tokens = 0
        prefix_hit_tokens = 0
        reload_tokens = 0
        recompute_tokens = 0
        for e in self._summary_engines():
            programs.extend(e.programs.values())
            total_tokens += e.tokens_prefilled + e.tokens_decoded
            prefill_tokens += e.tokens_prefilled
            prefix_hit_tokens += e.scheduler.stats.prefix_hit_tokens
            reload_tokens += e.scheduler.stats.reload_tokens
            recompute_tokens += e.scheduler.stats.recompute_tokens
        return summarize(programs, total_tokens,
                         prefill_tokens=prefill_tokens,
                         prefix_hit_tokens=prefix_hit_tokens,
                         reload_tokens=reload_tokens,
                         recompute_tokens=recompute_tokens)


def run_workload(programs: list[Program], engines: list[Engine],
                 router: Optional[Router] = None,
                 max_seconds: float = 36000.0) -> Summary:
    router = router or Router(engines)
    router.register_programs(programs)
    sim = Simulator(engines, router, max_seconds)
    sim.add_programs(programs)
    return sim.run()
