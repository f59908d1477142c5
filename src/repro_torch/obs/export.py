"""Chrome/Perfetto trace-event exporter + schema validation.

Maps the trace spine's lanes onto the Chrome trace-event JSON format
(loadable at https://ui.perfetto.dev): one *process* per replica with a
scheduler thread plus one thread per transfer channel, one process for
the cluster router, and one ``programs`` process whose async events
(``ph`` b/e/n, keyed by ``id`` = program id) render as one track per
program. Timestamps are virtual-clock seconds scaled to microseconds.

Export is deterministic — sorted pid/tid assignment, recorded event
order, ``json.dumps(sort_keys=True)`` — so same seed ⇒ byte-identical
file (the CI telemetry job asserts this).

CLI::

    python -m repro_torch.obs.export trace.jsonl -o trace.json   # raw -> Chrome
    python -m repro_torch.obs.export --validate trace.json       # schema check
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from repro_torch.obs.trace import TraceRecorder

_PROGRAMS = "programs"


def _us(ts: float) -> float:
    return round(ts * 1e6, 3)


def _tracks(events) -> tuple[dict, dict]:
    """Deterministic (track -> (pid, tid)) plus pid -> process name."""
    lane_tracks = set()
    has_programs = False
    for ev in events:
        if ev[0] in ("i", "d"):
            lane_tracks.add(ev[2])
        elif ev[0] == "X":
            lane_tracks.add(ev[3])
        else:
            has_programs = True
    procs: dict[str, list] = {}
    for track in sorted(lane_tracks):
        proc, _, thread = track.partition("/")
        procs.setdefault(proc, []).append(thread or "sched")
    pid_of: dict[str, int] = {}
    names: dict[int, str] = {}
    track_ids: dict[str, tuple] = {}
    pid = 0
    for proc in sorted(procs):
        pid += 1
        pid_of[proc] = pid
        names[pid] = proc
        # the bare lane ("sched") renders first, channels after, sorted
        threads = sorted(set(procs[proc]), key=lambda t: (t != "sched", t))
        for tid, thread in enumerate(threads):
            track = proc if thread == "sched" else f"{proc}/{thread}"
            track_ids[track] = (pid, tid, thread)
    if has_programs:
        pid += 1
        pid_of[_PROGRAMS] = pid
        names[pid] = _PROGRAMS
    return track_ids, names


def to_chrome(recorder_or_events, clip_at: Optional[float] = None) -> dict:
    """Convert recorded events (a TraceRecorder or its raw tuples) to a
    Chrome trace-event document.

    ``clip_at`` (virtual seconds) makes a *mid-run* export well-formed:
    transfer-channel spans are committed at submit time with their end in
    the virtual future (e.g. a migration still on a PeerLink NIC), so a
    live export would otherwise contain spans that outrun the clock.
    Spans straddling the clip are shortened to end exactly at ``clip_at``
    and marked ``args.truncated = true``; events that have not started
    yet are dropped. ``None`` (the default) exports verbatim."""
    events = getattr(recorder_or_events, "events", recorder_or_events)
    events = list(events)
    if clip_at is not None:
        events = [ev for ev in events if ev[1] <= clip_at]
    track_ids, proc_names = _tracks(events)
    prog_pid = max(proc_names, default=0) if _PROGRAMS in proc_names.values() \
        else None
    out = []
    for pid, name in sorted(proc_names.items()):
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": name}})
        if name == _PROGRAMS:
            prog_pid = pid
    for track in sorted(track_ids):
        pid, tid, thread = track_ids[track]
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": thread}})
    for ev in events:
        ph = ev[0]
        if ph == "i":
            _, ts, track, name, cat, args = ev
            pid, tid, _ = track_ids[track]
            rec = {"ph": "i", "ts": _us(ts), "pid": pid, "tid": tid,
                   "name": name, "cat": cat, "s": "t"}
        elif ph == "d":
            # packed scheduler decision (hot-path shape): unpack into a
            # cat="decision" instant
            _, ts, track, name, program_id, info = ev
            pid, tid, _ = track_ids[track]
            rec = {"ph": "i", "ts": _us(ts), "pid": pid, "tid": tid,
                   "name": name, "cat": "decision", "s": "t"}
            args = {"program": program_id, "info": list(info)}
        elif ph == "X":
            _, ts, dur, track, name, cat, args = ev
            if clip_at is not None and ts + dur > clip_at:
                dur = clip_at - ts
                args = dict(args) if args else {}
                args["truncated"] = True
            pid, tid, _ = track_ids[track]
            rec = {"ph": "X", "ts": _us(ts), "dur": _us(dur), "pid": pid,
                   "tid": tid, "name": name, "cat": cat}
        else:                       # b / e / n on the programs process
            _, ts, program_id, name, args = ev
            rec = {"ph": ph, "ts": _us(ts), "pid": prog_pid, "tid": 0,
                   "name": name, "cat": "program", "id": str(program_id)}
        if args:
            rec["args"] = args
        out.append(rec)
    other = {"generator": "repro_torch.obs",
             "dropped_events": getattr(recorder_or_events, "dropped", 0)}
    if clip_at is not None:
        other["clipped_at"] = round(clip_at, 9)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": other}


def dumps(doc: dict) -> str:
    """Canonical byte-stable serialization."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":")) + "\n"


def export_file(recorder_or_events, path: str) -> str:
    data = dumps(to_chrome(recorder_or_events))
    with open(path, "w") as f:
        f.write(data)
    return data


# ------------------------------------------------------------------ schema
_SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "trace_schema.json")


def load_schema() -> dict:
    with open(_SCHEMA_PATH) as f:
        return json.load(f)


def _check(obj, schema: dict, path: str, errors: list[str]) -> None:
    """Minimal JSON-Schema-subset validator (type / required /
    properties / items / enum / minimum) — no external dependency, so
    the CI job validates identically everywhere."""
    t = schema.get("type")
    types = {"object": dict, "array": list, "string": str,
             "number": (int, float), "integer": int, "boolean": bool}
    if t is not None:
        py = types[t]
        ok = isinstance(obj, py) and not (t in ("number", "integer")
                                          and isinstance(obj, bool))
        if t == "number":
            ok = isinstance(obj, (int, float)) and not isinstance(obj, bool)
        if not ok:
            errors.append(f"{path}: expected {t}, got {type(obj).__name__}")
            return
    if "enum" in schema and obj not in schema["enum"]:
        errors.append(f"{path}: {obj!r} not in {schema['enum']}")
    if "minimum" in schema and isinstance(obj, (int, float)) \
            and not isinstance(obj, bool) and obj < schema["minimum"]:
        errors.append(f"{path}: {obj} < minimum {schema['minimum']}")
    if isinstance(obj, dict):
        for req in schema.get("required", ()):
            if req not in obj:
                errors.append(f"{path}: missing required key {req!r}")
        for key, sub in schema.get("properties", {}).items():
            if key in obj:
                _check(obj[key], sub, f"{path}.{key}", errors)
    if isinstance(obj, list) and "items" in schema:
        for i, item in enumerate(obj):
            _check(item, schema["items"], f"{path}[{i}]", errors)
            if errors and len(errors) > 20:
                return


def validate(doc: dict, schema: Optional[dict] = None) -> list[str]:
    """Validate a Chrome trace document; returns error strings ([] = ok).
    Also enforces two semantic properties the schema can't express:
    async (b/e/n) events carry an id, and b/e events balance per
    (id, name)."""
    errors: list[str] = []
    _check(doc, schema or load_schema(), "$", errors)
    open_spans: dict[tuple, int] = {}
    for i, ev in enumerate(doc.get("traceEvents", ())):
        if not isinstance(ev, dict):
            continue
        ph = ev.get("ph")
        if ph in ("b", "e", "n") and "id" not in ev:
            errors.append(f"$.traceEvents[{i}]: async event missing id")
        if ph == "b":
            open_spans[(ev.get("id"), ev.get("name"))] = \
                open_spans.get((ev.get("id"), ev.get("name")), 0) + 1
        elif ph == "e":
            key = (ev.get("id"), ev.get("name"))
            if open_spans.get(key, 0) <= 0:
                errors.append(f"$.traceEvents[{i}]: async end without begin "
                              f"for {key}")
            else:
                open_spans[key] -= 1
    return errors


# --------------------------------------------------------------------- CLI
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Export a raw trace (.jsonl) to Chrome/Perfetto JSON, "
                    "or validate an exported trace against the schema.")
    ap.add_argument("input", help="raw .jsonl (export) or .json (--validate)")
    ap.add_argument("-o", "--out", help="output path (default: stdout)")
    ap.add_argument("--validate", action="store_true",
                    help="treat input as an exported Chrome trace and "
                         "schema-check it")
    args = ap.parse_args(argv)
    if args.validate:
        with open(args.input) as f:
            doc = json.load(f)
        errors = validate(doc)
        if errors:
            for e in errors:
                print(f"INVALID {e}", file=sys.stderr)
            return 1
        n = len(doc.get("traceEvents", ()))
        print(f"OK {args.input}: {n} events, schema-valid")
        return 0
    events = TraceRecorder.load_jsonl(args.input)
    data = dumps(to_chrome(events))
    if args.out:
        with open(args.out, "w") as f:
            f.write(data)
        print(f"wrote {args.out}: {len(events)} events")
    else:
        sys.stdout.write(data)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
