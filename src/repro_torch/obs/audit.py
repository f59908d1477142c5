"""TTL decision audit: why was this program pinned (and for how long)?

Every :meth:`~repro_torch.core.ttl.TTLModel.solve` / ``solve_parallel`` call
records its inputs — PrefillReload, the queue ETA (or fleet T̄) it
priced out-of-order cost with, η, and the record counts that picked the
CDF source — plus the output TTL and expected gain. Every subsequent
scheduler/runtime decision (pin, unpin, demote, evict, reload, preempt,
migrate, admit) *links back* to the program's most recent solve record,
so the full causal chain

    solve inputs → τ* → pin → ttl_hit | expiry → demotion → reload

is reconstructable per program from one artifact.

The solve call itself has no program/time context (the TTL model is
deliberately scheduler-agnostic), so the scheduler stages it with
:meth:`begin_solve` just before invoking the retention policy; the model
consumes the staged context when it records. Links are appended for
*every* decision, including ones with no justifying solve (e.g. a
first-turn admit) — the completeness fuzz test counts exactly one link
per decision.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.ttl import TTLDecision


@dataclasses.dataclass
class AuditRecord:
    id: int
    ts: float
    program_id: Optional[str]
    replica: Optional[str]
    turn_idx: Optional[int]
    tool: Optional[str]
    inputs: dict                   # prefill_reload, queue_eta, t_bar, eta, ...
    ttl: float
    gain: float
    source: str                    # per_tool | global | cold_start | parallel
    actions: list = dataclasses.field(default_factory=list)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class TTLAudit:
    def __init__(self, capacity: int = 100_000,
                 link_capacity: Optional[int] = None):
        self.capacity = capacity
        # link retention ring: raw links beyond this are compacted away
        # (after folding into record actions, and skipping live programs
        # so their chains stay complete); default scales with records —
        # long-running replays hold memory flat either way
        self.link_capacity = link_capacity if link_capacity is not None \
            else 4 * capacity
        # compaction trigger sits above the capacity so the O(n) sweep
        # amortizes to O(1) per link
        self._compact_at = self.link_capacity + \
            max(self.link_capacity // 4, 1)
        self.records: list[AuditRecord] = []
        # every decision, in order: (record_id|None, program_id, action,
        # ts, detail) — record_id points at the justifying solve
        self.links: list[tuple] = []
        # program arrivals (program_id, ts): the observed gap between a
        # solve (tool start) and the next arrival is the program's actual
        # tool duration — the ground truth the regret analyzer replays
        # counterfactual TTLs against
        self.arrivals: list[tuple] = []
        self._latest: dict[str, int] = {}     # program_id -> record id
        self._by_id: dict[int, AuditRecord] = {}
        self._pending: Optional[tuple] = None  # staged solve context
        self._next_id = 0
        self._materialized = 0     # links folded into record actions
        self.dropped = 0
        self.dropped_links = 0
        self.dropped_arrivals = 0
        # Telemetry hook: called with each new AuditRecord (metric bump +
        # trace instant); None when the audit runs standalone
        self.sink: Optional[Callable[[AuditRecord], None]] = None
        # live-program oracle for retention (set by Telemetry): programs
        # it returns keep their full raw chain across compactions
        self.live_fn: Optional[Callable[[], set]] = None

    # ------------------------------------------------------------- record
    def begin_solve(self, program_id: str, tool: Optional[str],
                    turn_idx: int, ts: float,
                    replica: Optional[str] = None) -> None:
        """Stage the scheduler-side context for the solve call about to
        happen (the TTL model itself knows neither program nor clock)."""
        self._pending = (program_id, tool, turn_idx, ts, replica)

    def record_solve(self, tool: Optional[str], prefill_reload: float,
                     queue_eta: Optional[float], decision: TTLDecision,
                     n_tool: int = 0, n_global: int = 0) -> int:
        pid, ptool, turn, ts, replica = self._pending or \
            (None, tool, None, 0.0, None)
        self._pending = None
        rec = AuditRecord(
            id=self._next_id, ts=ts, program_id=pid, replica=replica,
            turn_idx=turn, tool=ptool if ptool is not None else tool,
            inputs={"prefill_reload": round(prefill_reload, 9),
                    "queue_eta": None if queue_eta is None
                    else round(queue_eta, 9),
                    "t_bar": round(decision.t_bar, 9),
                    "eta": round(decision.eta, 9),
                    "n_tool_records": n_tool,
                    "n_global_records": n_global},
            ttl=round(decision.ttl, 9), gain=round(decision.gain, 9),
            source=decision.source)
        self._next_id += 1
        if len(self.records) >= self.capacity:
            live = self.live_fn() if self.live_fn is not None else ()
            drop = next((i for i, r in enumerate(self.records)
                         if r.program_id not in live), 0)
            old = self.records.pop(drop)
            self._by_id.pop(old.id, None)
            self.dropped += 1
        self.records.append(rec)
        self._by_id[rec.id] = rec
        if pid is not None:
            self._latest[pid] = rec.id
        if self.sink is not None:
            self.sink(rec)
        return rec.id

    def link(self, program_id: str, action: str, ts: float,
             detail: tuple = ()) -> None:
        """Attach a scheduler/runtime decision to the program's most
        recent solve record (None = no solve justified it). Hot path:
        one tuple append — per-record ``actions`` are materialized
        lazily from the link stream at query time."""
        self.links.append((self._latest.get(program_id), program_id,
                           action, ts, detail))
        if len(self.links) >= self._compact_at:
            self._compact()

    def note_arrival(self, program_id: str, ts: float) -> None:
        """A turn of ``program_id`` entered the queue at ``ts`` (the tool
        finished). Gives every solve record a ground-truth return gap."""
        self.arrivals.append((program_id, ts))
        if len(self.arrivals) >= self._compact_at:
            self._compact()

    def _compact(self) -> None:
        """Retention sweep: fold every link into its record's actions
        (nothing causal is lost), then drop the oldest raw links and
        arrivals down to ``link_capacity`` — except those of live
        programs, whose complete chains must survive for ``/audit/<id>``
        and post-hoc regret analysis."""
        self._materialize()
        live = self.live_fn() if self.live_fn is not None else set()

        def _trim(seq: list, pid_of, capacity: int) -> tuple[list, int]:
            excess = len(seq) - capacity
            if excess <= 0:
                return seq, 0
            kept, dropped = [], 0
            for item in seq:
                if dropped < excess and pid_of(item) not in live:
                    dropped += 1
                else:
                    kept.append(item)
            return kept, dropped

        self.links, d = _trim(self.links, lambda l: l[1],
                              self.link_capacity)
        self.dropped_links += d
        self._materialized = len(self.links)
        self.arrivals, d = _trim(self.arrivals, lambda a: a[0],
                                 self.link_capacity)
        self.dropped_arrivals += d

    def _materialize(self) -> None:
        """Fold links recorded since the last query into their records'
        ``actions`` lists (incremental: only the new suffix is walked)."""
        by_id = self._by_id
        for rid, _pid, action, ts, detail in \
                self.links[self._materialized:]:
            if rid is not None:
                rec = by_id.get(rid)
                if rec is not None:
                    rec.actions.append((action, ts, detail))
        self._materialized = len(self.links)

    # -------------------------------------------------------------- query
    def chain(self, program_id: str) -> dict:
        """Per-program causal chain: all solve records plus every linked
        decision, in event order."""
        self._materialize()
        recs = [r for r in self.records if r.program_id == program_id]
        links = [l for l in self.links if l[1] == program_id]
        return {"program_id": program_id,
                "records": [r.to_json() for r in recs],
                "links": links,
                "arrivals": [ts for pid, ts in self.arrivals
                             if pid == program_id]}

    def complete_programs(self) -> list[str]:
        """Programs whose audit chain is complete in the acceptance
        sense: a solve record that led to a pin, followed by a terminal
        action (unpin / demotion / eviction / migration) on the same
        record."""
        TERMINAL = {"unpin", "demote", "evict", "migrate_out",
                    "rehome_drop"}
        self._materialize()
        out = []
        for r in self.records:
            acts = {a[0] for a in r.actions}
            if r.program_id and "pin" in acts and acts & TERMINAL:
                out.append(r.program_id)
        return sorted(set(out))

    def to_json(self) -> dict:
        self._materialize()
        return {"records": [r.to_json() for r in self.records],
                "links": self.links,
                "arrivals": self.arrivals,
                "dropped": self.dropped,
                "dropped_links": self.dropped_links,
                "dropped_arrivals": self.dropped_arrivals,
                "complete_programs": self.complete_programs()}
