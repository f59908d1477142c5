"""Trace spine: typed spans + instants on the virtual clock.

Every instrumented subsystem appends into one bounded ring buffer, in
deterministic (virtual-clock-driven) order, so a same-seed replay
produces a byte-identical exported trace. Four event shapes:

- ``instant(track, name, ts)``   — a point event on a replica/cluster lane
  (scheduler decisions, tier moves, router placements)
- ``complete(track, name, ts, dur)`` — a duration span on a lane (engine
  steps, individual channel transfers)
- ``async_begin/async_end(pid, name, ts)`` — program-lifecycle phases
  (queued → prefill → decode → tool-pause; the pinned interval); matched
  by (program, name) into one async track per program in the exporter
- ``async_instant(pid, name, ts)`` — point events on a program's track
  (demoted, reloaded, migrated, finished)

Track naming: ``"r0"`` = replica r0's scheduler/step lane; ``"r0/h2d"``
= replica r0's h2d transfer channel lane; ``"cluster"`` = the router
lane. The exporter (:mod:`repro_torch.obs.export`) maps tracks to
Chrome/Perfetto processes and threads.

Events are plain tuples (first element = Chrome phase letter) so the
enabled-path cost is one bounds check plus one deque append.
"""
from __future__ import annotations

import json
from collections import deque
from typing import Optional


class TraceRecorder:
    def __init__(self, capacity: int = 200_000):
        self.capacity = capacity
        self.events: deque = deque(maxlen=capacity)
        self.dropped = 0                  # ring overwrites (oldest lost)
        # monotone push counter: event i in the ring has sequence number
        # seq - len(events) + i + 1, so live consumers (the SSE /events
        # stream) can cursor through the ring without re-reading it
        self.seq = 0

    def __len__(self) -> int:
        return len(self.events)

    def _push(self, ev: tuple) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.seq += 1
        self.events.append(ev)

    def tail(self, since: int) -> tuple[list[tuple], int]:
        """Events pushed after sequence number ``since`` (clamped to the
        ring: anything older than ``seq - len(events)`` was overwritten).
        Returns ``(events, new_cursor)``; pass ``new_cursor`` back on the
        next call. Event ``i`` of the returned list has sequence number
        ``new_cursor - len(events) + i + 1``."""
        seq = self.seq
        oldest = seq - len(self.events)
        if since < oldest:
            since = oldest
        if since >= seq:
            return [], seq
        evs = list(self.events)
        return evs[len(evs) - (seq - since):], seq

    # ------------------------------------------------------------- lanes
    def instant(self, track: str, name: str, ts: float, cat: str = "event",
                args: Optional[dict] = None) -> None:
        self._push(("i", ts, track, name, cat, args))

    def complete(self, track: str, name: str, ts: float, dur: float,
                 cat: str = "span", args: Optional[dict] = None) -> None:
        self._push(("X", ts, dur, track, name, cat, args))

    def decision(self, track: str, kind: str, ts: float, program_id: str,
                 info: tuple) -> None:
        """Packed scheduler-decision instant: the hottest emission path
        allocates one tuple of scalars (CPython untracks it after the
        first GC pass — no dict, no ring-buffer GC pressure). The
        exporter unpacks it into a cat="decision" instant."""
        self._push(("d", ts, track, kind, program_id, info))

    # -------------------------------------------------- program lifecycle
    def async_begin(self, program_id: str, name: str, ts: float,
                    args: Optional[dict] = None) -> None:
        self._push(("b", ts, program_id, name, args))

    def async_end(self, program_id: str, name: str, ts: float,
                  args: Optional[dict] = None) -> None:
        self._push(("e", ts, program_id, name, args))

    def async_instant(self, program_id: str, name: str, ts: float,
                      args: Optional[dict] = None) -> None:
        self._push(("n", ts, program_id, name, args))

    # ----------------------------------------------------------------- io
    def save_jsonl(self, path: str) -> None:
        """Raw event stream, one JSON array per line (the exporter's
        input format; also the stable on-disk form for later export)."""
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev, sort_keys=True,
                                   separators=(",", ":")) + "\n")

    @staticmethod
    def load_jsonl(path: str) -> list[tuple]:
        with open(path) as f:
            return [tuple(json.loads(line)) for line in f if line.strip()]
