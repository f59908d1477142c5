"""Counterfactual TTL regret: replay an audit log under alternative policies.

The paper's robustness claim is that the solved TTL τ* stays close to
the clairvoyant policy under unpredictable tool durations. The
:class:`~repro_torch.obs.audit.TTLAudit` artifact contains everything needed
to test that claim quantitatively, after the fact, with no re-simulation:

- each solve record carries the decision inputs (PrefillReload, the
  queue ETA it priced out-of-order cost with, η) and the solved τ*;
- the arrival stream gives the *actual* gap ``d`` between the solve (the
  tool starting) and the program's next return to the queue — i.e. the
  realized tool duration the solver could only model as a distribution;
- the link stream gives what the run actually paid (reload seconds,
  cold recomputes, queueing between arrival and admission).

Holding KV for τ reserves memory for ``min(τ, d)`` seconds and pays the
retention gain ``G = queue_eta·η + PrefillReload`` iff the program is
back before expiry, so per decision (in normalized seconds):

    B(τ; d)   = G·1[d ≤ τ] − min(τ, d)
    B_oracle  = max(G − d, 0)              (hold exactly when it pays)
    regret(τ) = B_oracle − B(τ; d)  ≥ 0

Policies evaluated per recorded decision: the run's own ``continuum``
τ*, ``oracle``, ``evict_always`` (τ = 0), ``pin_forever`` (τ = ∞,
charged to the run horizon if the program never returns) and a fixed-TTL
sweep. Every policy sees the same recorded G and the same realized d, so
totals are directly comparable; the CI gate asserts continuum's total
regret beats every fixed TTL and evict-always on the seeded skewed
cluster trace.

CLI::

    python -m repro_torch.obs.regret audit.json -o regret.json
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

DEFAULT_FIXED_TTLS = (0.1, 0.3, 1.0, 3.0, 10.0)

_INF = float("inf")


def _fmt_ttl(t: float) -> str:
    return f"{t:g}"


def gain_of(inputs: dict) -> float:
    """Retention gain G the solver priced: out-of-order delay (the
    per-replica queue ETA when recorded, else the fleet T̄) scaled by the
    memoryfulness η, plus the prefill/reload cost avoided on a hit."""
    wait = inputs.get("queue_eta")
    if wait is None:
        wait = inputs.get("t_bar", 0.0)
    return wait * inputs.get("eta", 0.0) + inputs.get("prefill_reload", 0.0)


def benefit(gain: float, ttl: float, gap: Optional[float],
            hold_cap: float) -> float:
    """Realized net benefit of holding for ``ttl`` given actual gap
    ``gap`` (None = the program never returned; an unbounded hold is
    charged up to ``hold_cap``, the remaining run horizon)."""
    if gap is None:
        return -min(ttl, hold_cap)
    if gap <= ttl:
        return gain - gap
    return -ttl


def _per_decision(rec: dict, arrivals: list, horizon: float) -> dict:
    """Everything the policy sweep needs for one solve record, plus the
    realized (as-run) attribution from the link stream."""
    t0 = rec["ts"]
    gain = gain_of(rec["inputs"])
    # actual gap: first arrival of this program strictly after the solve
    gap = next((ts - t0 for ts in arrivals if ts > t0), None)
    hold_cap = max(horizon - t0, 0.0)
    # realized attribution: the actions linked to this record, in order
    realized = {"hit": None, "reload_s": 0.0, "recompute_s": 0.0,
                "queue_s": 0.0}
    for action, ts, detail in rec.get("actions", ()):
        if action == "admit" and realized["hit"] is None:
            source = detail[1] if len(detail) > 1 else None
            realized["hit"] = source == "pin"
            if source == "none":
                # returning turn admitted with nothing resident: the
                # whole avoided-prefill charge comes back as recompute
                realized["recompute_s"] = rec["inputs"].get(
                    "prefill_reload", 0.0)
            if gap is not None:
                realized["queue_s"] = max(ts - (t0 + gap), 0.0)
        elif action == "reload" and detail:
            realized["reload_s"] += float(detail[0])
    return {"record_id": rec["id"], "program_id": rec["program_id"],
            "replica": rec.get("replica"), "ts": t0,
            "tool": rec.get("tool"), "ttl": rec["ttl"], "gain": gain,
            "source": rec["source"], "gap": gap, "hold_cap": hold_cap,
            "realized": realized}


def analyze(audit, fixed_ttls=DEFAULT_FIXED_TTLS,
            top_n: int = 10) -> dict:
    """Build the per-policy / per-program regret report from a
    :class:`~repro_torch.obs.audit.TTLAudit` (or its ``to_json()`` dict)."""
    data = audit.to_json() if hasattr(audit, "to_json") else audit
    records = data.get("records", [])
    links = data.get("links", [])
    arrivals_by: dict[str, list] = {}
    for pid, ts in data.get("arrivals", []):
        arrivals_by.setdefault(pid, []).append(ts)
    for v in arrivals_by.values():
        v.sort()
    # run horizon: the last timestamp the audit saw anywhere
    horizon = 0.0
    for r in records:
        horizon = max(horizon, r["ts"])
        for _a, ts, _d in r.get("actions", ()):
            horizon = max(horizon, ts)
    for l in links:
        horizon = max(horizon, l[3])
    for v in arrivals_by.values():
        if v:
            horizon = max(horizon, v[-1])

    decisions = [_per_decision(r, arrivals_by.get(r["program_id"], ()),
                               horizon)
                 for r in records if r.get("program_id") is not None]

    policies = {"continuum": None, "oracle": "oracle", "evict_always": 0.0,
                "pin_forever": _INF}
    for t in fixed_ttls:
        policies[f"fixed_{_fmt_ttl(t)}"] = float(t)

    totals = {name: {"benefit_s": 0.0, "regret_s": 0.0, "hits": 0,
                     "misses": 0, "held_s": 0.0}
              for name in policies}
    per_program: dict[str, dict] = {}
    worst: list[tuple] = []

    for d in decisions:
        gain, gap, cap = d["gain"], d["gap"], d["hold_cap"]
        oracle = max(gain - gap, 0.0) if gap is not None else 0.0
        d["oracle"] = oracle
        d["regret"] = {}
        for name, tau in policies.items():
            if tau == "oracle":
                b = oracle
                held = gap if (gap is not None and gain > gap) else 0.0
                hit = gap is not None and gain > gap
            else:
                t = d["ttl"] if tau is None else tau
                b = benefit(gain, t, gap, cap)
                held = min(t, gap) if gap is not None else min(t, cap)
                hit = gap is not None and gap <= t
            tot = totals[name]
            tot["benefit_s"] += b
            tot["regret_s"] += oracle - b
            tot["held_s"] += held
            tot["hits" if hit else "misses"] += 1
            d["regret"][name] = oracle - b
        pp = per_program.setdefault(d["program_id"], {
            "decisions": 0,
            "regret_s": {name: 0.0 for name in policies},
            "reload_s": 0.0, "recompute_s": 0.0, "queue_s": 0.0})
        pp["decisions"] += 1
        for name in policies:
            pp["regret_s"][name] += d["regret"][name]
        pp["reload_s"] += d["realized"]["reload_s"]
        pp["recompute_s"] += d["realized"]["recompute_s"]
        pp["queue_s"] += d["realized"]["queue_s"]
        worst.append((d["regret"]["continuum"], d))

    worst.sort(key=lambda x: (-x[0], x[1]["record_id"]))
    n = len(decisions)
    for tot in totals.values():
        tot["mean_regret_s"] = tot["regret_s"] / n if n else 0.0
    ranking = sorted(totals, key=lambda p: (totals[p]["regret_s"], p))
    rivals = [p for p in totals
              if p.startswith("fixed_") or p == "evict_always"]
    beats_all = all(totals["continuum"]["regret_s"]
                    < totals[p]["regret_s"] for p in rivals)

    def _r(x, nd=6):
        return round(x, nd)

    report = {
        "n_decisions": n,
        "n_returned": sum(1 for d in decisions if d["gap"] is not None),
        "horizon_s": _r(horizon),
        "fixed_ttls": [float(t) for t in fixed_ttls],
        "policies": {name: {
            "total_benefit_s": _r(t["benefit_s"]),
            "total_regret_s": _r(t["regret_s"]),
            "mean_regret_s": _r(t["mean_regret_s"]),
            "held_s": _r(t["held_s"]),
            "hits": t["hits"], "misses": t["misses"]}
            for name, t in totals.items()},
        "ranking": ranking,
        "continuum_beats_all_fixed": beats_all,
        "realized": {
            "hits": sum(1 for d in decisions if d["realized"]["hit"]),
            "misses": sum(1 for d in decisions
                          if d["realized"]["hit"] is False),
            "reload_s": _r(sum(d["realized"]["reload_s"]
                               for d in decisions)),
            "recompute_s": _r(sum(d["realized"]["recompute_s"]
                                  for d in decisions)),
            "queue_s": _r(sum(d["realized"]["queue_s"]
                              for d in decisions))},
        "per_program": {pid: {
            "decisions": pp["decisions"],
            "regret_s": {k: _r(v) for k, v in
                         sorted(pp["regret_s"].items())},
            "reload_s": _r(pp["reload_s"]),
            "recompute_s": _r(pp["recompute_s"]),
            "queue_s": _r(pp["queue_s"])}
            for pid, pp in sorted(per_program.items())},
        "worst_decisions": [{
            "record_id": d["record_id"], "program_id": d["program_id"],
            "replica": d["replica"], "ts": _r(d["ts"]),
            "tool": d["tool"], "ttl": _r(d["ttl"]),
            "gain_s": _r(d["gain"]),
            "gap_s": None if d["gap"] is None else _r(d["gap"]),
            "oracle_s": _r(d["oracle"]),
            "regret_s": _r(r)} for r, d in worst[:top_n] if r > 0],
    }
    return report


def dumps(report: dict) -> str:
    """Canonical byte-stable serialization (same-seed determinism is a
    CI gate)."""
    return json.dumps(report, sort_keys=True, indent=2,
                      allow_nan=False) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Counterfactual TTL regret report from an audit log")
    ap.add_argument("audit", help="audit.json written by the telemetry "
                                  "plane (TTLAudit.to_json)")
    ap.add_argument("-o", "--out", help="output path (default: stdout)")
    ap.add_argument("--fixed-ttls", type=float, nargs="+",
                    default=list(DEFAULT_FIXED_TTLS))
    args = ap.parse_args(argv)
    with open(args.audit) as f:
        data = json.load(f)
    report = analyze(data, fixed_ttls=tuple(args.fixed_ttls))
    text = dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        best = report["ranking"][0] if report["ranking"] else "-"
        print(f"wrote {args.out}: {report['n_decisions']} decisions, "
              f"best policy {best}, continuum_beats_all_fixed="
              f"{report['continuum_beats_all_fixed']}")
    else:
        print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
