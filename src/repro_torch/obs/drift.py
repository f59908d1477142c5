"""Prediction-drift watchdog: audit every estimate the scheduler trusts.

Continuum's decisions are priced off *predictions* — the TTL solver's
queue ETA and tool-duration CDF, the offload plane's reload ETA peek,
the engine's analytic step-time estimate, the router's placement score,
the cluster's migration ETA. The paper's robustness claim is that the
system degrades gracefully when those predictions are wrong; this module
makes the error itself a first-class observable so an operator (or the
recalibration hook) learns *which* estimator went stale before JCTs do.

Every site that both predicts and later observes a quantity feeds a
(predicted, observed) pair into a per-estimator rolling window, either

- :meth:`DriftMonitor.observe` for same-instant pairs (peek vs commit,
  estimated vs realized step), or
- :meth:`DriftMonitor.predict` / :meth:`DriftMonitor.realize` for
  deferred pairs keyed by program id (TTL-solve inputs realized at the
  next admission; :meth:`DriftMonitor.drop` cancels a pending pair whose
  ground truth never materializes, e.g. a reload estimate voided by a
  TTL pin hit).

Each window keeps bias (mean observed−predicted) and the p50/p90 of the
symmetric relative error ``|obs−pred| / max(|obs|,|pred|,floor)``.
Alerting mirrors :mod:`repro_torch.obs.slo`: when an estimator's p90 relative
error crosses its fire threshold a ``drift_alert`` instant lands on the
trace's ``drift`` lane and ``continuum_drift_alerts_total`` increments;
hysteresis resolves it (``drift_resolve``) once p90 falls back under the
resolve threshold. Firing also runs any registered *recalibrators* —
e.g. re-fitting ``HardwareProfile`` via
:func:`repro_torch.serving.profiler.calibrate_hardware` from live step samples
— whose fitted result is recorded (trace + :attr:`recalibrations`) but
never applied to the live cost model, so telemetry cannot change
scheduling decisions.

Everything is driven by virtual-clock timestamps and count-based check
cadence, so same-seed runs produce byte-identical alert streams
(CI-gated by ``replay --attribution``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

#: canonical estimator names (the wiring sites use these exact keys)
ESTIMATORS = ("queue_eta", "tool_duration", "prefill_reload",
              "step_seconds", "placement_cost", "migration_eta")


@dataclasses.dataclass
class DriftConfig:
    window: int = 256            # rolling (predicted, observed) pairs kept
    min_samples: int = 24        # no verdict before this many pairs
    fire_p90: float = 0.9        # p90 symmetric relative error to fire
    resolve_p90: float = 0.55    # hysteresis: resolve below this
    check_every: int = 8         # evaluate every N samples (deterministic)
    err_floor: float = 0.05      # seconds floor in the error denominator
    pending_cap: int = 4096      # bound on outstanding deferred pairs
    # per-estimator (fire, resolve) overrides, e.g. a sloppy estimator
    # the operator has accepted: {"placement_cost": (2.0, 1.2)}
    overrides: dict = dataclasses.field(default_factory=dict)

    def thresholds(self, estimator: str) -> tuple[float, float]:
        return self.overrides.get(estimator,
                                  (self.fire_p90, self.resolve_p90))


class _EstimatorWindow:
    __slots__ = ("pairs", "total", "since_check")

    def __init__(self, window: int):
        self.pairs: deque = deque(maxlen=window)   # (predicted, observed)
        self.total = 0                             # lifetime sample count
        self.since_check = 0


def _rel_error(pred: float, obs: float, floor: float) -> float:
    return abs(obs - pred) / max(abs(obs), abs(pred), floor)


def _quantile(sorted_vals: list, q: float) -> float:
    """Nearest-rank quantile on an already-sorted list (deterministic,
    no interpolation ambiguity across platforms)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


class DriftMonitor:
    """Rolling predicted-vs-realized windows + burn-style alerting.

    Wired by :meth:`repro_torch.obs.Telemetry.attach_engine`; every emission
    site guards with ``obs is not None and obs.drift is not None`` so
    the disabled path costs two attribute tests.
    """

    def __init__(self, registry=None, trace=None,
                 cfg: DriftConfig = DriftConfig()):
        self.cfg = cfg
        self.trace = trace
        self._win: dict[str, _EstimatorWindow] = {}
        self._pending: dict[tuple, tuple] = {}   # (est, key) -> (ts, pred)
        self._alerting: dict[str, bool] = {}
        self.alerts_fired = 0
        # estimator -> [(name, callable)], run (in registration order)
        # when that estimator's alert fires; results are *reported*, never
        # applied — see module docstring
        self.recalibrators: dict[str, list] = {}
        self.recalibrations: list[dict] = []
        if registry is not None:
            self.samples = registry.counter(
                "continuum_drift_samples_total",
                "Predicted-vs-realized pairs recorded per estimator",
                ("estimator",))
            self.alerts = registry.counter(
                "continuum_drift_alerts_total",
                "Drift alerts fired (estimator p90 relative error crossed "
                "its threshold)", ("estimator",))
            # quantile gauges: meaningless to sum across any label, so
            # they are excluded from label-dropping fleet aggregation
            self.p90_error = registry.gauge(
                "continuum_drift_p90_rel_error",
                "p90 symmetric relative error over the rolling window",
                ("estimator",), summable=False)
            self.p50_error = registry.gauge(
                "continuum_drift_p50_rel_error",
                "p50 symmetric relative error over the rolling window",
                ("estimator",), summable=False)
            self.bias = registry.gauge(
                "continuum_drift_bias_seconds",
                "Mean (observed - predicted) over the rolling window",
                ("estimator",), summable=False)
        else:
            self.samples = self.alerts = None
            self.p90_error = self.p50_error = self.bias = None

    # ------------------------------------------------------------ feeding
    def observe(self, estimator: str, ts: float, predicted: float,
                observed: float) -> None:
        """Record one same-instant (predicted, observed) pair."""
        w = self._win.get(estimator)
        if w is None:
            w = self._win[estimator] = _EstimatorWindow(self.cfg.window)
        w.pairs.append((float(predicted), float(observed)))
        w.total += 1
        w.since_check += 1
        if self.samples is not None:
            self.samples.inc(1.0, (estimator,))
        if w.since_check >= self.cfg.check_every:
            w.since_check = 0
            self._check(estimator, w, ts)

    def predict(self, estimator: str, key: str, ts: float,
                predicted: float) -> None:
        """Stage a deferred pair: ground truth arrives later under the
        same (estimator, key) via :meth:`realize`. Re-predicting the same
        key overwrites (only the latest estimate is ever realized)."""
        if len(self._pending) >= self.cfg.pending_cap:
            # deterministic bound: evict the oldest staged prediction
            self._pending.pop(next(iter(self._pending)))
        self._pending[(estimator, key)] = (ts, float(predicted))

    def realize(self, estimator: str, key: str, ts: float,
                observed: float) -> None:
        """Close a deferred pair. No-op when nothing is pending (the
        predicted path never ran for this program)."""
        staged = self._pending.pop((estimator, key), None)
        if staged is not None:
            self.observe(estimator, ts, staged[1], observed)

    def drop(self, estimator: str, key: str) -> None:
        """Cancel a staged prediction whose ground truth will never
        materialize (e.g. a reload estimate voided by a pin hit)."""
        self._pending.pop((estimator, key), None)

    # ----------------------------------------------------------- alerting
    def _stats(self, w: _EstimatorWindow) -> tuple[float, float, float]:
        floor = self.cfg.err_floor
        errs = sorted(_rel_error(p, o, floor) for p, o in w.pairs)
        n = len(w.pairs)
        bias = sum(o - p for p, o in w.pairs) / n if n else 0.0
        return bias, _quantile(errs, 0.5), _quantile(errs, 0.9)

    def _check(self, estimator: str, w: _EstimatorWindow,
               ts: float) -> None:
        bias, p50, p90 = self._stats(w)
        if self.p90_error is not None:
            key = (estimator,)
            self.p90_error.set(round(p90, 9), key)
            self.p50_error.set(round(p50, 9), key)
            self.bias.set(round(bias, 9), key)
        if len(w.pairs) < self.cfg.min_samples:
            return
        fire, resolve = self.cfg.thresholds(estimator)
        alerting = self._alerting.get(estimator, False)
        if not alerting and p90 > fire:
            self._alerting[estimator] = True
            self.alerts_fired += 1
            if self.alerts is not None:
                self.alerts.inc(1.0, (estimator,))
            if self.trace is not None:
                self.trace.instant(
                    "drift", "drift_alert", ts, cat="drift",
                    args={"estimator": estimator,
                          "p90_rel_error": round(p90, 6),
                          "p50_rel_error": round(p50, 6),
                          "bias_s": round(bias, 6),
                          "samples": len(w.pairs)})
            self._recalibrate(estimator, ts)
        elif alerting and p90 <= resolve:
            self._alerting[estimator] = False
            if self.trace is not None:
                self.trace.instant(
                    "drift", "drift_resolve", ts, cat="drift",
                    args={"estimator": estimator,
                          "p90_rel_error": round(p90, 6),
                          "samples": len(w.pairs)})

    def _recalibrate(self, estimator: str, ts: float) -> None:
        for name, fn in self.recalibrators.get(estimator, ()):
            try:
                result = fn()
            except Exception as exc:     # a refit must never kill serving
                result = {"error": repr(exc)}
            rec = {"estimator": estimator, "recalibrator": name,
                   "ts": round(ts, 9), "result": result}
            self.recalibrations.append(rec)
            if self.trace is not None:
                self.trace.instant("drift", "drift_recalibrate", ts,
                                   cat="drift", args=rec)

    def add_recalibrator(self, estimator: str, name: str,
                         fn: Callable[[], dict]) -> None:
        """Register a refit callback run when ``estimator``'s alert
        fires. ``fn`` returns a JSON-able summary of the fitted values
        (e.g. ``{"mfu": 0.41, "decode_eff": 0.22}``)."""
        self.recalibrators.setdefault(estimator, []).append((name, fn))

    # -------------------------------------------------------------- query
    def status(self) -> dict:
        """Live JSON view (the ``/drift`` endpoint). Read-only: stats are
        recomputed from the windows, alert state is whatever the last
        count-based check decided."""
        estimators = []
        for name in sorted(self._win):
            w = self._win[name]
            bias, p50, p90 = self._stats(w)
            fire, resolve = self.cfg.thresholds(name)
            estimators.append({
                "estimator": name,
                "samples": len(w.pairs), "total_samples": w.total,
                "bias_s": round(bias, 9),
                "p50_rel_error": round(p50, 9),
                "p90_rel_error": round(p90, 9),
                "fire_p90": fire, "resolve_p90": resolve,
                "alerting": self._alerting.get(name, False)})
        return {"config": {"window": self.cfg.window,
                           "min_samples": self.cfg.min_samples,
                           "fire_p90": self.cfg.fire_p90,
                           "resolve_p90": self.cfg.resolve_p90,
                           "err_floor": self.cfg.err_floor},
                "estimators": estimators,
                "alerts_fired": self.alerts_fired,
                "pending_pairs": len(self._pending),
                "recalibrations": self.recalibrations}
