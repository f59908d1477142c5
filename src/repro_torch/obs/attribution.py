"""Critical-path JCT attribution: explain every second of every program.

The trace spine already records a program's full lifecycle as contiguous
async spans (queued → prefill → decode → tool_pause → ... → finished),
scheduler decisions (admit/reload per replica), engine step spans (with
the reload stall that stretched them) and cluster migration instants
(with flight windows and reasons). This module derives, purely from
those events, a per-program causal decomposition of job completion time:

- ``queueing``       arrival + between-turn admission waits
- ``preempt_requeue``re-queued time after a preemption
- ``prefill``        prefill compute (net of reload stalls)
- ``decode``         decode compute (net of reload stalls)
- ``reload_stall``   step time the program's OWN tier reload added
- ``reload_collateral`` step time someone ELSE's reload added while this
                     program was co-scheduled (the router prices exactly
                     this; here it is measured)
- ``migration_wire`` queued time spent waiting on a cross-replica KV
                     flight (rehome migrations)
- ``drain_wire``     ditto, for drain-evacuation flights
- ``handoff_wire``   ditto, for prefill→decode disaggregation handoffs
- ``tool_pause``     waiting on the external tool

The base spans tile ``[arrival, end]`` exactly (``Telemetry.
program_phase`` closes the previous span at the next span's begin), and
every refinement *moves* seconds between components rather than adding
any, so the decomposition sums to the measured JCT to float precision —
asserted per program (``eps``) and CI-gated by ``replay --attribution``.

The per-program *critical path* is the refined edge chain itself
(a program's lifecycle is sequential; concurrent work — pinned KV,
migrations overlapped by tool pauses — only enters when it extends the
chain, which is exactly when the carve rules charge it). ``worst_edge``
names the single longest edge: the first thing an operator looks at when
asking "why was program X slow".

Fleet rollups aggregate component-seconds across programs and replicas
into a ranked bottleneck table ("34% of fleet-seconds were reload
collateral on r2"). Reports are canonical JSON (sorted keys, rounded
floats) so same-seed runs are byte-identical.
"""
from __future__ import annotations

import json

COMPONENTS = ("queueing", "preempt_requeue", "prefill", "decode",
              "reload_stall", "reload_collateral", "migration_wire",
              "drain_wire", "handoff_wire", "tool_pause")

#: migration ``reason`` -> wire component charged for queued flight waits
_WIRE = {"rehome": "migration_wire", "drain": "drain_wire",
         "handoff": "handoff_wire"}

_BASE = {"prefill": "prefill", "decode": "decode",
         "tool_pause": "tool_pause"}


def _r9(x: float) -> float:
    return round(float(x), 9)


class _Segment:
    __slots__ = ("kind", "t0", "t1", "replica", "carves")

    def __init__(self, kind, t0, replica):
        self.kind = kind
        self.t0 = t0
        self.t1 = None
        self.replica = replica
        self.carves = []          # (component, seconds, detail)


def _scan(events):
    """One pass over the raw event stream -> per-program segment lists
    plus the step/migration facts the refinement needs."""
    segs: dict[str, list] = {}          # pid -> [_Segment...]
    open_seg: dict[str, _Segment] = {}
    ends: dict[str, tuple] = {}         # pid -> (ts, mark)
    replica_of: dict[str, str] = {}     # last decision-tagged replica
    reloads: dict[tuple, set] = {}      # (replica, ts) -> reloader pids
    steps: list = []                    # (replica, t0, dur, stall)
    flights: dict[str, list] = {}       # pid -> [(t0, t1, reason, src, dst)]
    pinned_open: dict[str, float] = {}
    pinned_s: dict[str, float] = {}
    for ev in events:
        tag = ev[0]
        if tag == "b":
            _, ts, pid, name, args = ev
            if name == "pinned":
                pinned_open[pid] = ts
                continue
            kind = _BASE.get(name)
            if kind is None and name == "queued":
                kind = "preempt_requeue" if args and \
                    args.get("preempted") else "queueing"
                if args and "replica" in args:
                    replica_of[pid] = args["replica"]
            if kind is None:
                continue
            seg = _Segment(kind, ts, replica_of.get(pid))
            open_seg[pid] = seg
            segs.setdefault(pid, []).append(seg)
        elif tag == "e":
            _, ts, pid, name, _args = ev
            if name == "pinned":
                t0 = pinned_open.pop(pid, None)
                if t0 is not None:
                    pinned_s[pid] = pinned_s.get(pid, 0.0) + (ts - t0)
                continue
            seg = open_seg.get(pid)
            if seg is not None and seg.t1 is None:
                seg.t1 = ts
        elif tag == "n":
            _, ts, pid, name, _args = ev
            if name in ("finished", "rejected"):
                ends[pid] = (ts, name)
        elif tag == "d":
            _, ts, replica, kind, pid, _info = ev
            replica_of[pid] = replica
            if kind == "reload":
                reloads.setdefault((replica, ts), set()).add(pid)
        elif tag == "X":
            _, ts, dur, track, name, cat, args = ev
            if cat == "step" and args:
                stall = args.get("stall", 0.0)
                if stall > 0.0:
                    steps.append((track, ts, dur, stall))
        elif tag == "i":
            _, ts, track, name, cat, args = ev
            if cat == "cluster" and name == "migrate" and args:
                flights.setdefault(args["program"], []).append(
                    (ts, args.get("arrive", ts),
                     args.get("reason", "rehome"),
                     args.get("src"), args.get("dst")))
    return segs, ends, reloads, steps, flights, pinned_s


def _overlap(a0, a1, b0, b1) -> float:
    return max(0.0, min(a1, b1) - max(a0, b0))


def analyze(events, eps: float = 1e-6) -> dict:
    """Attribute JCT for every completed program in ``events`` (raw
    trace tuples — ``Telemetry.trace.events`` or a loaded jsonl).
    Returns the canonical report dict (see module docstring)."""
    segs, ends, reloads, steps, flights, pinned_s = _scan(events)

    # refinement pass 1: reload stalls. Every step stretched by a reload
    # charges its stall to each participant segment — the reloader(s) as
    # reload_stall, the incumbents as reload_collateral.
    for replica, t0, dur, stall in steps:
        t1 = t0 + dur
        reloaders = reloads.get((replica, t0), ())
        for pid, plist in segs.items():
            for seg in plist:
                if seg.kind not in ("prefill", "decode") \
                        or seg.replica != replica or seg.t1 is None:
                    continue
                ov = _overlap(seg.t0, seg.t1, t0, t1)
                if ov <= 0.0:
                    continue
                c = min(stall, ov)
                comp = "reload_stall" if pid in reloaders \
                    else "reload_collateral"
                seg.carves.append((comp, c, {"step_t": _r9(t0),
                                             "replica": replica}))
                break        # one segment per program spans a given step

    # refinement pass 2: migration wire time that actually cost JCT —
    # the part of a flight window a program spent *queued* waiting on it
    # (flights hidden behind tool pauses are free and stay unattributed).
    for pid, fl in flights.items():
        for f0, f1, reason, src, dst in fl:
            comp = _WIRE.get(reason, "migration_wire")
            for seg in segs.get(pid, ()):
                if seg.kind not in ("queueing", "preempt_requeue") \
                        or seg.t1 is None:
                    continue
                ov = _overlap(seg.t0, seg.t1, f0, f1)
                if ov > 0.0:
                    seg.carves.append((comp, ov, {"src": src, "dst": dst}))

    programs = {}
    fleet_edge = {}                     # (component, replica) -> seconds
    total = 0.0
    incomplete = []
    for pid in sorted(segs):
        plist = segs[pid]
        end = ends.get(pid)
        if end is None or end[1] != "finished" or not plist \
                or any(s.t1 is None for s in plist):
            incomplete.append(pid)
            continue
        arrival = plist[0].t0
        jct = end[0] - arrival
        comps = dict.fromkeys(COMPONENTS, 0.0)
        edges = []
        for seg in plist:
            base = seg.t1 - seg.t0
            carved = 0.0
            for comp, c, detail in seg.carves:
                c = min(c, base - carved)    # never carve past the span
                if c <= 0.0:
                    continue
                carved += c
                comps[comp] += c
                edges.append({"t0": _r9(seg.t0), "t1": _r9(seg.t1),
                              "component": comp, "seconds": _r9(c),
                              "replica": seg.replica, **detail})
            rest = base - carved
            comps[seg.kind] += rest
            edges.append({"t0": _r9(seg.t0), "t1": _r9(seg.t1),
                          "component": seg.kind, "seconds": _r9(rest),
                          "replica": seg.replica})
        ssum = sum(comps.values())
        residual = jct - ssum
        worst = max(edges, key=lambda e: (e["seconds"], e["t0"]))
        programs[pid] = {
            "arrival": _r9(arrival), "end": _r9(end[0]), "jct": _r9(jct),
            "components": {k: _r9(v) for k, v in comps.items() if v > 0.0},
            "residual": _r9(residual),
            "sums_to_jct": abs(residual) <= eps,
            "pinned_seconds": _r9(pinned_s.get(pid, 0.0)),
            "critical_path": edges,
            "worst_edge": worst,
        }
        total += jct
        for e in edges:
            key = (e["component"], e["replica"] or "")
            fleet_edge[key] = fleet_edge.get(key, 0.0) + e["seconds"]

    by_component: dict[str, float] = {}
    for (comp, _r), s in fleet_edge.items():
        by_component[comp] = by_component.get(comp, 0.0) + s
    bottlenecks = sorted(
        ({"component": comp, "replica": rep, "seconds": _r9(s),
          "fraction": _r9(s / total) if total > 0 else 0.0}
         for (comp, rep), s in fleet_edge.items()),
        key=lambda b: (-b["seconds"], b["component"], b["replica"]))
    return {
        "programs": programs,
        "fleet": {
            "total_jct_seconds": _r9(total),
            "n_programs": len(programs),
            "by_component": {
                c: {"seconds": _r9(s),
                    "fraction": _r9(s / total) if total > 0 else 0.0}
                for c, s in sorted(by_component.items())},
            "bottlenecks": bottlenecks[:10],
        },
        "incomplete_programs": incomplete,
        "epsilon": eps,
        "ok": bool(programs) and all(p["sums_to_jct"]
                                     for p in programs.values()),
    }


def dumps(report: dict) -> str:
    """Canonical byte-stable serialization (same-seed runs diff clean)."""
    return json.dumps(report, sort_keys=True, indent=2,
                      allow_nan=False) + "\n"


def refresh_metrics(tel, report: dict) -> None:
    """(Re)populate ``continuum_jct_component_seconds`` from a report —
    gauge semantics so repeated analyses stay idempotent."""
    g = tel.jct_components
    g.values.clear()
    acc: dict[tuple, float] = {}
    for p in report["programs"].values():
        for e in p["critical_path"]:
            key = (e["replica"] or "", e["component"])
            acc[key] = acc.get(key, 0.0) + e["seconds"]
    for key, s in acc.items():
        g.set(_r9(s), key)


def attribute(tel, eps: float = 1e-6) -> dict:
    """Analyze a live :class:`~repro_torch.obs.Telemetry` plane and refresh its
    attribution metrics. The ``/attribution`` endpoint and the replay
    demo both run through here."""
    report = analyze(tel.trace.events, eps=eps)
    refresh_metrics(tel, report)
    return report
