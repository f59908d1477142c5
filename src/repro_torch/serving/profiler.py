"""Offline profiling + analytic step-cost model (paper §5.2, TPU-adapted).

The paper profiles (1) GPU↔CPU offload bandwidth and (2) a prefill-vs-
context quadratic, per (hardware, model) pair, in <10 min. This container
has no accelerator, so the *measurements* come from a roofline model of the
target chip (v5e: 197 TFLOP/s bf16, 819 GB/s HBM); the *method* — sampling
chunk sizes {1k, 2k, 4k, ...} and fitting a quadratic — is reproduced
faithfully, and on real hardware `measure_fn` is swapped for timed runs.

The same cost model drives the virtual-clock execution backend.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str = "tpu-v5e"
    flops: float = 197e12            # bf16 peak per chip
    hbm_bw: float = 819e9            # bytes/s
    hbm_bytes: float = 16e9
    ici_bw: float = 50e9             # per link, bytes/s
    h2d_bw: float = 25e9             # host<->device
    ssd_bw: float = 3e9
    mfu: float = 0.5                 # achievable fraction for prefill
    decode_eff: float = 0.7          # achievable fraction of HBM bw


@dataclasses.dataclass
class ModelServingProfile:
    """Static per-(model, chips) numbers used by the cost model."""
    param_bytes: float
    active_param_bytes: float        # MoE: activated path only
    kv_bytes_per_token: float
    state_bytes: float               # SSM fixed state per sequence
    flops_per_token: float           # 2*N_active per token (fwd)
    chips: int = 1


def build_profile(cfg: ModelConfig, chips: int = 1,
                  dtype_bytes: int = 2) -> ModelServingProfile:
    n = cfg.param_count()
    na = cfg.active_param_count()
    return ModelServingProfile(
        param_bytes=n * dtype_bytes,
        active_param_bytes=na * dtype_bytes,
        kv_bytes_per_token=cfg.kv_bytes_per_token(dtype_bytes),
        state_bytes=cfg.state_bytes(),
        flops_per_token=2.0 * na,
        chips=chips,
    )


class CostModel:
    """Analytic execution times for engine steps on the target hardware."""

    def __init__(self, prof: ModelServingProfile, hw: HardwareProfile = HardwareProfile()):
        self.prof = prof
        self.hw = hw

    # ---- roofline-calibrated construction ---------------------------------
    @classmethod
    def from_roofline(cls, cfg: ModelConfig, mesh=None,
                      hw: HardwareProfile = HardwareProfile(),
                      chips: int = 1, prefill_tokens: int = 64,
                      decode_batch: int = 4, decode_context: int = 128
                      ) -> "CostModel":
        """Build a cost model whose per-token FLOPs and per-step bytes are
        *counted from the port's steps* (via
        :mod:`repro_torch.dist.roofline`) instead of derived from the
        config's analytic param counts.

        A small prefill step and a small decode step are built for ``cfg``
        on the ``meta`` device (shapes only: nothing is drawn or
        allocated, and the count is the same on any machine) and run once
        under the counter, which takes the analyzer's byte model (operand
        + output bytes of the matmul family, elementwise chains fused at 0
        bytes); the serving profile is calibrated from the two counts:

        - ``flops_per_token``   <- prefill FLOPs / prefill tokens
        - ``active_param_bytes``<- decode bytes minus the KV-cache read
        - ``kv_bytes_per_token``/``state_bytes`` stay exact-from-config
          (they are structural, not measured).

        ``mesh``: None (one device) or a ``DeviceMesh``: the two steps
        are built on it (weights and caches as DTensors, still on the
        meta device) and the counts are per device, as the reference's
        are on its mesh."""
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.dist.roofline import count_step
        from repro_torch.models.steps import (build_decode_step,
                                              build_prefill_step)

        p_cost = count_step(build_prefill_step(
            cfg, mesh, ShapeSpec("cal_p", "prefill", prefill_tokens, 1),
            device="meta"))
        d_cost = count_step(build_decode_step(
            cfg, mesh, ShapeSpec("cal_d", "decode", decode_context,
                                 decode_batch), device="meta"))

        kvpt = cfg.kv_bytes_per_token(2)
        state = cfg.state_bytes()
        kv_read = decode_batch * (decode_context * kvpt + state)
        prof = ModelServingProfile(
            param_bytes=2.0 * cfg.param_count(),
            active_param_bytes=max(d_cost.bytes - kv_read, 1.0),
            kv_bytes_per_token=kvpt,
            state_bytes=state,
            flops_per_token=p_cost.flops / prefill_tokens,
            chips=chips,
        )
        return cls(prof, hw)

    # ---- primitive costs -------------------------------------------------
    def prefill_seconds(self, tokens: int, context: int = 0) -> float:
        """Prefill `tokens` new tokens on top of `context` cached tokens."""
        if tokens <= 0:
            return 0.0
        p, hw = self.prof, self.hw
        flops = p.flops_per_token * tokens
        # attention: quadratic term (2*2*d_kv-ish folded into kv bytes scale)
        attn_flops = 2.0 * tokens * (context + tokens / 2) * \
            (p.kv_bytes_per_token / 2)  # 2 bytes/elem -> elems
        total = (flops + attn_flops) / (hw.flops * p.chips * hw.mfu)
        return total

    def decode_step_seconds(self, batch: int, avg_context: int) -> float:
        """One decode iteration for `batch` sequences.

        The model amortizes the parameter read over the WHOLE batch — the
        shape the physical path now matches: ``PagedKVRuntime.decode_batch``
        serves all ``batch`` sequences through one fused kernel step per
        layer, so one parameter sweep feeds every sequence (a per-program
        decode loop would pay ``param_read`` ``batch`` times)."""
        if batch <= 0:
            return 0.0
        p, hw = self.prof, self.hw
        param_read = p.active_param_bytes / (hw.hbm_bw * p.chips * hw.decode_eff)
        kv_read = batch * (avg_context * p.kv_bytes_per_token + p.state_bytes) \
            / (hw.hbm_bw * p.chips * hw.decode_eff)
        flops = batch * p.flops_per_token / (hw.flops * p.chips * hw.mfu)
        return max(param_read + kv_read, flops)

    def decode_tokens_per_s(self, batch: int, avg_context: int) -> float:
        """Analytic decode throughput (tokens/s) at a given batch shape —
        the reference curve ``benchmarks/bench_decode.py`` plots the
        measured per-program vs batched sweep against."""
        if batch <= 0:
            return 0.0
        return batch / self.decode_step_seconds(batch, avg_context)

    def step_seconds(self, prefill_tokens: int, prefill_context: int,
                     decode_batch: int, decode_avg_context: int) -> float:
        """A mixed continuous-batching step (chunked prefill + decode)."""
        return (self.prefill_seconds(prefill_tokens, prefill_context) +
                self.decode_step_seconds(decode_batch, decode_avg_context))

    def kv_bytes(self, tokens: int) -> float:
        return tokens * self.prof.kv_bytes_per_token + self.prof.state_bytes

    # ---- the paper's offline profile --------------------------------------
    def fit_prefill_quadratic(self, max_context: int = 131072,
                              measure_fn: Callable[[int], float] | None = None
                              ) -> np.ndarray:
        """Sample prefill times at {1k, 2k, 4k, ... max} and fit a*L^2+b*L+c
        (paper §5.2). measure_fn defaults to the analytic model; on real
        hardware pass a timed runner."""
        measure = measure_fn or (lambda L: self.prefill_seconds(L, 0))
        sizes, times = [], []
        L = min(1000, max(max_context // 8, 8))       # small-model friendly
        while L <= max_context or len(sizes) < 3:
            sizes.append(L)
            times.append(measure(L))
            L *= 2
        coef = np.polyfit(np.asarray(sizes, float), np.asarray(times, float), 2)
        return coef                                    # [a, b, c]

    @staticmethod
    def quadratic_prefill_seconds(coef: np.ndarray, tokens: int) -> float:
        return float(np.polyval(coef, max(tokens, 0)))


@dataclasses.dataclass
class StepSample:
    """One engine step observed by a measuring backend (e.g. the replay
    harness's ShadowClockBackend): the measured wall-clock duration plus
    the step's composition, enough to re-price it under any
    HardwareProfile."""
    measured_s: float
    prefill_tokens: int
    prefill_context: int
    decode_batch: int
    decode_avg_context: int


def step_gap(samples: list[StepSample], prof: ModelServingProfile,
             hw: HardwareProfile) -> float:
    """Total |measured − analytic| seconds over `samples` under `hw`."""
    cost = CostModel(prof, hw)
    return float(sum(abs(s.measured_s - cost.step_seconds(
        s.prefill_tokens, s.prefill_context, s.decode_batch,
        s.decode_avg_context)) for s in samples))


def calibration_report(samples: list[StepSample],
                       prof: ModelServingProfile,
                       hw_in: HardwareProfile,
                       hw_out: HardwareProfile) -> dict:
    """JSON-able fit report: input vs fitted efficiencies, the total
    measured-vs-analytic gap under each, and per-sample residuals under
    the fitted profile (the telemetry plane's calibration artifact —
    checked in under ``experiments/calibration/``)."""
    cost = CostModel(prof, hw_out)
    residuals = []
    for s in samples:
        analytic = cost.step_seconds(s.prefill_tokens, s.prefill_context,
                                     s.decode_batch, s.decode_avg_context)
        residuals.append({
            "measured_s": round(s.measured_s, 9),
            "analytic_s": round(analytic, 9),
            "residual_s": round(s.measured_s - analytic, 9),
            "prefill_tokens": s.prefill_tokens,
            "prefill_context": s.prefill_context,
            "decode_batch": s.decode_batch,
            "decode_avg_context": s.decode_avg_context})
    gap_in = step_gap(samples, prof, hw_in)
    gap_out = step_gap(samples, prof, hw_out)
    abs_res = sorted(abs(r["residual_s"]) for r in residuals)
    return {
        "hardware": hw_in.name,
        "samples": len(samples),
        "input": {"mfu": hw_in.mfu, "decode_eff": hw_in.decode_eff,
                  "flops": hw_in.flops, "hbm_bw": hw_in.hbm_bw},
        "fitted": {"mfu": round(hw_out.mfu, 9),
                   "decode_eff": round(hw_out.decode_eff, 9)},
        "gap_s": {"input": round(gap_in, 9),
                  "fitted": round(gap_out, 9),
                  "reduction": round(1.0 - gap_out / gap_in, 9)
                  if gap_in > 0 else 0.0},
        "abs_residual_s": {
            "p50": round(abs_res[len(abs_res) // 2], 9) if abs_res else 0.0,
            "max": round(abs_res[-1], 9) if abs_res else 0.0},
        "residuals": residuals}


def calibrate_hardware(samples: list[StepSample],
                       prof: ModelServingProfile, hw: HardwareProfile,
                       iters: int = 3,
                       outlier_factor: float = 10.0,
                       report_path: str | None = None) -> HardwareProfile:
    """Auto-calibrate ``mfu``/``decode_eff`` from measured step durations.

    The analytic model is linear in (1/mfu, 1/decode_eff) once each
    step's decode phase is classified memory- vs flops-bound:

        measured ≈ P·(1/mfu) + D·(1/decode_eff)

    where P is the step's mfu-independent prefill numerator (plus the
    decode flops numerator when flops-bound) and D its decode memory
    numerator. We alternate a least-squares solve with re-classification
    (the ``max()`` in ``decode_step_seconds`` is the only nonlinearity)
    for ``iters`` rounds and return the candidate profile with the
    smallest total gap — never worse than the input ``hw``.

    Samples whose measured duration exceeds ``outlier_factor`` × the
    median are dropped from the *fit* (JIT-compile warmup steps), though
    every candidate is still scored on the full set. A calibrated
    efficiency above 1.0 is allowed: it means the profile's peak
    flops/bandwidth are mis-specified for this host, and wall-clock
    accuracy (what the TTL model needs) beats physical plausibility.

    With ``report_path`` set, a :func:`calibration_report` (fitted
    values + residuals) is written there as JSON."""
    if not samples:
        return hw
    meas = np.asarray([s.measured_s for s in samples])
    med = float(np.median(meas))
    fit = [s for s in samples
           if med <= 0 or s.measured_s <= outlier_factor * med] or samples

    def numerators(s: StepSample, h: HardwareProfile):
        cost = CostModel(prof, h)
        pre = cost.prefill_seconds(s.prefill_tokens, s.prefill_context)
        p_num = pre * h.mfu
        d_mem = 0.0
        d_flops = 0.0
        if s.decode_batch > 0:
            mem = (prof.active_param_bytes + s.decode_batch *
                   (s.decode_avg_context * prof.kv_bytes_per_token +
                    prof.state_bytes)) / (h.hbm_bw * prof.chips)
            fl = s.decode_batch * prof.flops_per_token / \
                (h.flops * prof.chips)
            if fl / h.mfu > mem / h.decode_eff:     # flops-bound decode
                d_flops = fl
            else:
                d_mem = mem
        return p_num, d_mem, d_flops

    cands = [hw]
    cur = hw
    for _ in range(max(iters, 1)):
        rows, y = [], []
        for s in fit:
            p_num, d_mem, d_flops = numerators(s, cur)
            rows.append([p_num + d_flops, d_mem])
            y.append(s.measured_s)
        A = np.asarray(rows)
        use = [i for i in range(2) if float(np.abs(A[:, i]).sum()) > 0]
        if not use:
            break
        x, *_ = np.linalg.lstsq(A[:, use], np.asarray(y), rcond=None)
        inv = {0: 1.0 / cur.mfu, 1: 1.0 / cur.decode_eff}
        for i, xi in zip(use, x):
            inv[i] = max(float(xi), 1e-9)
        cur = dataclasses.replace(hw, mfu=1.0 / inv[0],
                                  decode_eff=1.0 / inv[1])
        cands.append(cur)
    best = min(cands, key=lambda h: step_gap(samples, prof, h))
    if report_path is not None:
        import json
        with open(report_path, "w") as f:
            json.dump(calibration_report(samples, prof, hw, best), f,
                      indent=2, sort_keys=True)
            f.write("\n")
    return best


def make_prefill_reload_fn(cost: CostModel, coef: np.ndarray,
                           store=None, clock: Callable[[], float] | None = None):
    """PrefillReload(r) for the TTL model: time to reconstruct r's context,
    min(recompute via the fitted quadratic, reload over the host link).

    With a :class:`~repro_torch.serving.kvstore.TieredKVStore` attached, the
    reload term is priced by its :class:`TransferEngine` against the
    channels' *current in-flight state* (queue backlog, per-transfer
    latency) at the engine's virtual clock — a busy H2D link makes
    retention look better, which is exactly the paper's reload-vs-
    recompute tradeoff responding to load. Without a store the TTL model
    can only ever recompute."""

    def fn(req) -> float:
        tokens = req.prompt_len + req.generated
        recompute = CostModel.quadratic_prefill_seconds(coef, tokens)
        if store is None or not store.cfg.enabled:
            return recompute
        now = clock() if clock is not None else 0.0
        # hypothetical future reload of a DRAM-resident entry, queue-aware
        reload = store.transfer.reload_eta(cost.kv_bytes(tokens), 0.0, now)
        return min(recompute, reload)

    return fn
