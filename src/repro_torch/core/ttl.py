"""Continuum's TTL utility model (paper §4.1–4.2).

For a finished request r that will call tool f:

    Cost(τ, r)    = MemUsage(r)/M̄ · τ
    Benefit(r)    = CacheMissCost(r) + OutOfOrderCost(r)
    CacheMissCost = MemUsage(r)/M̄ · PrefillReload(r)
    OutOfOrderCost= T̄/M̄ · MemUsage(r) · η

After cancelling MemUsage(r)/M̄ (Eq. 2):

    τ* = argmax_τ  P(τ, f) · (T̄·η + PrefillReload(r)) − τ

solved by enumerating the empirical tool-duration records S[f] (plus τ=0).

Cold start (paper §4.2): with |S| ≤ K use a fixed TTL derived from the same
model under ToolDuration ~ Exp(mean u), η = 1:
    maximize (1 − e^{−τ/u})·G − τ  ⇒  τ* = u · ln(G/u)  (if G > u, else 0).
With K < |S| and |S[f]| ≤ K, fall back to the global duration records.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict, deque
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TTLConfig:
    cold_start_k: int = 100         # K in the paper
    max_ttl: float = 600.0          # hard bound (robustness backstop)
    exp_unit_mean: float = 1.0      # u for the cold-start Exp model (seconds)
    window: int = 512               # sliding windows for T̄ and M̄
    eta_default: float = 1.0        # memoryfulness before enough samples
    eta_min_programs: int = 8
    per_tool_cap: int = 2048        # bound S[f] memory


class ToolDurationRecords:
    """S in Algorithm 1: per-tool and global empirical duration records."""

    def __init__(self, cap: int = 2048):
        self.cap = cap
        self.per_tool: dict[str, deque] = defaultdict(lambda: deque(maxlen=cap))
        self.global_: deque = deque(maxlen=cap * 4)

    def record(self, tool: str, duration: float) -> None:
        d = max(0.0, float(duration))
        self.per_tool[tool].append(d)
        self.global_.append(d)

    def count(self, tool: Optional[str] = None) -> int:
        if tool is None:
            return len(self.global_)
        return len(self.per_tool.get(tool, ()))

    def durations(self, tool: Optional[str] = None) -> np.ndarray:
        src = self.global_ if tool is None else self.per_tool.get(tool, ())
        return np.asarray(src, dtype=np.float64)

    def cdf(self, tool: Optional[str], tau: float) -> float:
        """P(τ, f): empirical P[duration <= tau]."""
        d = self.durations(tool)
        if d.size == 0:
            return 0.0
        return float(np.mean(d <= tau))


class MemoryfulnessEstimator:
    """η = −Corr(k, N−k) over (served, remaining) samples of finished
    programs (paper §4.1). Streaming Pearson correlation."""

    def __init__(self, default: float = 1.0, min_programs: int = 8):
        self.default = default
        self.min_programs = min_programs
        self.n_programs = 0
        self._sx = self._sy = self._sxx = self._syy = self._sxy = 0.0
        self._n = 0

    def observe_program(self, num_turns: int) -> None:
        """Add samples (k, N−k) for k = 0..N−1 from a finished program."""
        N = int(num_turns)
        if N <= 0:
            return
        self.n_programs += 1
        for k in range(N):
            x, y = float(k), float(N - k)
            self._n += 1
            self._sx += x
            self._sy += y
            self._sxx += x * x
            self._syy += y * y
            self._sxy += x * y

    @property
    def eta(self) -> float:
        if self.n_programs < self.min_programs or self._n < 4:
            return self.default
        n = self._n
        cov = self._sxy / n - (self._sx / n) * (self._sy / n)
        vx = self._sxx / n - (self._sx / n) ** 2
        vy = self._syy / n - (self._sy / n) ** 2
        if vx <= 1e-12 or vy <= 1e-12:
            # all programs identical length -> fully memoryful
            return 1.0
        corr = cov / math.sqrt(vx * vy)
        return float(np.clip(-corr, -1.0, 1.0))


class SlidingMean:
    def __init__(self, window: int, init: float = 0.0):
        self.buf: deque = deque(maxlen=window)
        self.init = init

    def add(self, x: float) -> None:
        self.buf.append(float(x))

    @property
    def mean(self) -> float:
        if not self.buf:
            return self.init
        return float(np.mean(self.buf))


@dataclasses.dataclass
class TTLDecision:
    ttl: float
    gain: float                    # expected net benefit at τ*
    source: str                    # "per_tool" | "global" | "cold_start"
    prefill_reload: float
    eta: float
    t_bar: float


class TTLModel:
    """Computes τ* (Eq. 2) from live statistics.

    The engine feeds it: tool durations (via records), queueing delays of
    evicted-then-returning requests (T̄), request memory usage (M̄), and
    finished program turn counts (η).
    """

    def __init__(self, cfg: TTLConfig = TTLConfig()):
        self.cfg = cfg
        self.records = ToolDurationRecords(cfg.per_tool_cap)
        self.eta_est = MemoryfulnessEstimator(cfg.eta_default, cfg.eta_min_programs)
        self.t_bar = SlidingMean(cfg.window, init=0.0)    # avg queueing delay
        self.m_bar = SlidingMean(cfg.window, init=1.0)    # avg mem per request
        # telemetry: a repro_torch.obs.audit.TTLAudit records every solve's
        # inputs and output; None (the default) costs one attribute test
        self.audit = None

    # ---- feeds ----------------------------------------------------------
    def observe_tool(self, tool: str, duration: float) -> None:
        self.records.record(tool, duration)

    def observe_queueing_delay(self, delay: float) -> None:
        self.t_bar.add(max(0.0, delay))

    def observe_mem_usage(self, mem: float) -> None:
        if mem > 0:
            self.m_bar.add(mem)

    def observe_program_finish(self, num_turns: int) -> None:
        self.eta_est.observe_program(num_turns)

    def predict_tool_duration(self, tool: Optional[str]) -> float:
        """Point prediction of the coming tool call's duration — the
        expectation of the same empirical records the solver's CDF draws
        from (per-tool mean when the tool has records, else the global
        mean, else the cold-start Exp mean). The drift watchdog pairs
        this with the realized gap to audit the tool-CDF estimator."""
        d = self.records.durations(tool) if tool else \
            self.records.durations(None)
        if d.size == 0:
            d = self.records.durations(None)
        if d.size == 0:
            return self.cfg.exp_unit_mean
        return float(d.mean())

    # ---- the solver ------------------------------------------------------
    def _gain_term(self, prefill_reload: float,
                   queue_eta: Optional[float] = None) -> float:
        """G = T̄·η + PrefillReload(r) (seconds).

        ``queue_eta`` — a live per-replica queueing-delay estimate (the
        engine's outstanding-work ETA) — replaces the fleet-average T̄ when
        provided: in a multi-replica cluster the out-of-order cost a TTL
        miss pays is the *local* queue the returning program would rejoin,
        not the historical average across the fleet.

        The estimate prices each queued request's residual prefill
        separately (lumping them into one quadratic-attention call
        overestimates replicas holding many small residuals, biasing this
        solver toward over-pinning) and includes the waiting queue's
        decode backlog. The same signal drives the cluster's
        ``ScalingPolicy``, so TTL solving and fleet sizing read one
        consistent notion of queueing pressure."""
        delay = self.t_bar.mean if queue_eta is None else max(0.0, queue_eta)
        return delay * self.eta_est.eta + max(0.0, prefill_reload)

    def solve(self, tool: Optional[str], prefill_reload: float,
              queue_eta: Optional[float] = None) -> TTLDecision:
        dec = self._solve(tool, prefill_reload, queue_eta)
        if self.audit is not None:
            self.audit.record_solve(
                tool, prefill_reload, queue_eta, dec,
                n_tool=self.records.count(tool) if tool else 0,
                n_global=self.records.count(None))
        return dec

    def _solve(self, tool: Optional[str], prefill_reload: float,
               queue_eta: Optional[float] = None) -> TTLDecision:
        cfg = self.cfg
        G = self._gain_term(prefill_reload, queue_eta)
        eta = self.eta_est.eta
        tb = self.t_bar.mean if queue_eta is None else max(0.0, queue_eta)

        n_global = self.records.count(None)
        n_tool = self.records.count(tool) if tool else 0

        if n_global <= cfg.cold_start_k:
            ttl = self._cold_start_ttl(G)
            return TTLDecision(min(ttl, cfg.max_ttl), 0.0, "cold_start",
                               prefill_reload, eta, tb)

        source = "per_tool" if (tool and n_tool > cfg.cold_start_k) else "global"
        d = self.records.durations(tool if source == "per_tool" else None)
        tau, gain = self._argmax_over_durations(d, G)
        if gain <= 0.0:
            return TTLDecision(0.0, gain, source, prefill_reload, eta, tb)
        return TTLDecision(min(tau, cfg.max_ttl), gain, source,
                           prefill_reload, eta, tb)

    @staticmethod
    def _argmax_over_durations(d: np.ndarray, G: float) -> tuple[float, float]:
        """Enumerate candidate τ ∈ sorted unique durations ∪ {0} (Eq. 2)."""
        if d.size == 0:
            return 0.0, 0.0
        taus = np.unique(d)                      # sorted unique
        n = d.size
        # P(τ_i) = rank of τ_i / n  (counts duplicates correctly)
        cdf = np.searchsorted(np.sort(d), taus, side="right") / n
        gains = cdf * G - taus
        i = int(np.argmax(gains))
        best_gain = float(gains[i])
        zero_gain = 0.0                          # τ=0 ⇒ gain 0
        if best_gain <= zero_gain:
            return 0.0, best_gain
        return float(taus[i]), best_gain

    def _cold_start_ttl(self, G: float) -> float:
        """T_default: Exp(u) durations, η=1 ⇒ τ* = u·ln(G/u) if G > u."""
        u = self.cfg.exp_unit_mean
        if G <= u:
            return 0.0
        return u * math.log(G / u)

    # ---- parallel tool calls (paper Appendix C.1) -------------------------
    def solve_parallel(self, tools: list[str], prefill_reload: float,
                       queue_eta: Optional[float] = None) -> TTLDecision:
        """TTL for a turn that fans out several tools and resumes when ALL
        return: the finish-within-τ probability is the product of the
        per-tool empirical CDFs (independent tools; the gap is the max of
        the durations). Candidates: union of all tools' recorded durations.
        """
        if len(tools) <= 1:
            return self.solve(tools[0] if tools else None, prefill_reload,
                              queue_eta)
        dec = self._solve_parallel(tools, prefill_reload, queue_eta)
        if self.audit is not None:
            self.audit.record_solve(
                "par:" + "+".join(sorted(tools)), prefill_reload, queue_eta,
                dec, n_tool=min(self.records.count(f) for f in tools),
                n_global=self.records.count(None))
        return dec

    def _solve_parallel(self, tools: list[str], prefill_reload: float,
                        queue_eta: Optional[float] = None) -> TTLDecision:
        cfg = self.cfg
        G = self._gain_term(prefill_reload, queue_eta)
        if self.records.count(None) <= cfg.cold_start_k:
            ttl = self._cold_start_ttl(G)
            return TTLDecision(min(ttl, cfg.max_ttl), 0.0, "cold_start",
                               prefill_reload, self.eta_est.eta, self.t_bar.mean)
        cands = [0.0]
        per_tool = []
        for f in tools:
            src = f if self.records.count(f) > cfg.cold_start_k else None
            d = self.records.durations(src)
            per_tool.append(np.sort(d))
            cands.extend(np.unique(d).tolist())
        taus = np.unique(np.asarray(cands))
        joint = np.ones_like(taus)
        for d in per_tool:
            if d.size == 0:
                joint *= 0.0
            else:
                joint *= np.searchsorted(d, taus, side="right") / d.size
        gains = joint * G - taus
        i = int(np.argmax(gains))
        if gains[i] <= 0:
            return TTLDecision(0.0, float(gains[i]), "parallel",
                               prefill_reload, self.eta_est.eta, self.t_bar.mean)
        return TTLDecision(min(float(taus[i]), cfg.max_ttl), float(gains[i]),
                           "parallel", prefill_reload, self.eta_est.eta,
                           self.t_bar.mean)
