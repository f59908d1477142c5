"""Per-tenant SLO objectives with multi-window burn-rate alerting.

An :class:`SLOObjective` is a latency target plus a compliance fraction
("95% of TTFTs under 2s"). The monitor keeps, per (tenant, objective),
two rolling windows on the *virtual* clock — a short window that reacts
fast and a long window that filters blips — and computes the classic
SRE burn rate in each:

    error budget = 1 - objective          (e.g. 5%)
    burn rate    = violation fraction in window / error budget

Burn 1.0 means the tenant is consuming budget exactly at the sustainable
rate; an alert fires only when *both* windows burn above the threshold
(the multi-window pattern: the short window confirms the problem is
current, the long window that it is material). Alert and resolve
transitions land as instants on the trace's ``slo`` lane and as counters
in the registry, so they are visible in Perfetto, ``/metrics`` and the
SSE ``/events`` stream alike.

Everything is driven by observations stamped with virtual time (the
engine feeds TTFT at first token and JCT at final-turn completion via
:meth:`repro_torch.obs.Telemetry.note_ttft` / ``note_jct``), so same-seed runs
produce byte-identical alert streams.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable, Optional


@dataclasses.dataclass(frozen=True)
class SLOObjective:
    metric: str                    # "ttft" | "jct"
    target_s: float                # latency target per request/program
    objective: float = 0.95        # fraction that must meet the target
    short_window_s: float = 30.0   # reacts to what is happening now
    long_window_s: float = 120.0   # confirms it is material
    burn_threshold: float = 2.0    # alert when BOTH windows burn above

    @property
    def name(self) -> str:
        return f"{self.metric}_p{round(self.objective * 100)}"


def default_objectives(ttft_target_s: Optional[float] = None,
                       jct_target_s: Optional[float] = None,
                       objective: float = 0.95) -> list[SLOObjective]:
    out = []
    if ttft_target_s is not None:
        out.append(SLOObjective("ttft", ttft_target_s, objective))
    if jct_target_s is not None:
        out.append(SLOObjective("jct", jct_target_s, objective))
    return out


class _Window:
    __slots__ = ("span", "events", "bad")

    def __init__(self, span: float):
        self.span = span
        self.events: deque = deque()    # (ts, violated 0/1)
        self.bad = 0

    def add(self, ts: float, violated: int) -> None:
        self.events.append((ts, violated))
        self.bad += violated
        cut = ts - self.span
        ev = self.events
        while ev and ev[0][0] < cut:
            _, v = ev.popleft()
            self.bad -= v

    def burn(self, budget: float) -> float:
        n = len(self.events)
        if n == 0:
            return 0.0
        return (self.bad / n) / budget


class SLOMonitor:
    """Rolling burn-rate evaluation of a set of objectives, per tenant.

    Wire through :meth:`repro_torch.obs.Telemetry.enable_slo`; the tenant key
    is the program's ``shared_prefix_id`` (the skewed cluster workload
    encodes tenants there), falling back to ``"default"``.
    """

    def __init__(self, objectives: Iterable[SLOObjective], registry,
                 trace=None):
        self.objectives = tuple(objectives)
        self.trace = trace
        self._windows: dict[tuple, tuple] = {}   # (tenant, obj) -> (s, l)
        self._alerting: dict[tuple, bool] = {}   # (tenant, name) -> bool
        self.requests = registry.counter(
            "continuum_slo_requests_total",
            "SLO-evaluated observations (status: ok | breach)",
            ("tenant", "slo", "status"))
        self.alerts = registry.counter(
            "continuum_slo_alerts_total",
            "Multi-window burn-rate alerts fired", ("tenant", "slo"))
        self.burn_rate = registry.gauge(
            "continuum_slo_burn_rate",
            "Error-budget burn rate per rolling window (1.0 = budget "
            "consumed exactly at the sustainable rate)",
            ("tenant", "slo", "window"))

    def observe(self, tenant: str, metric: str, value: float,
                now: float) -> None:
        for obj in self.objectives:
            if obj.metric != metric:
                continue
            violated = 1 if value > obj.target_s else 0
            key = (tenant, obj)
            w = self._windows.get(key)
            if w is None:
                w = self._windows[key] = (_Window(obj.short_window_s),
                                          _Window(obj.long_window_s))
            short, long_ = w
            short.add(now, violated)
            long_.add(now, violated)
            self.requests.inc(
                1.0, (tenant, obj.name, "breach" if violated else "ok"))
            budget = max(1.0 - obj.objective, 1e-9)
            bs, bl = short.burn(budget), long_.burn(budget)
            self.burn_rate.set(round(bs, 9), (tenant, obj.name, "short"))
            self.burn_rate.set(round(bl, 9), (tenant, obj.name, "long"))
            akey = (tenant, obj.name)
            alerting = self._alerting.get(akey, False)
            thr = obj.burn_threshold
            if not alerting and bs > thr and bl > thr:
                self._alerting[akey] = True
                self.alerts.inc(1.0, (tenant, obj.name))
                if self.trace is not None:
                    self.trace.instant(
                        "slo", "slo_alert", now, cat="slo",
                        args={"tenant": tenant, "slo": obj.name,
                              "target_s": obj.target_s,
                              "burn_short": round(bs, 6),
                              "burn_long": round(bl, 6)})
            elif alerting and bs <= thr and bl <= thr:
                self._alerting[akey] = False
                if self.trace is not None:
                    self.trace.instant(
                        "slo", "slo_resolve", now, cat="slo",
                        args={"tenant": tenant, "slo": obj.name,
                              "burn_short": round(bs, 6),
                              "burn_long": round(bl, 6)})

    # --------------------------------------------------------------- query
    def status(self) -> dict:
        """Live JSON view (the ``/slo`` endpoint)."""
        tenants = []
        for (tenant, obj), (short, long_) in sorted(
                self._windows.items(), key=lambda kv: (kv[0][0],
                                                       kv[0][1].name)):
            budget = max(1.0 - obj.objective, 1e-9)
            tenants.append({
                "tenant": tenant, "slo": obj.name,
                "target_s": obj.target_s, "objective": obj.objective,
                "burn_short": round(short.burn(budget), 6),
                "burn_long": round(long_.burn(budget), 6),
                "samples_short": len(short.events),
                "samples_long": len(long_.events),
                "alerting": self._alerting.get((tenant, obj.name), False)})
        return {"objectives": [dataclasses.asdict(o)
                               for o in self.objectives],
                "tenants": tenants}
