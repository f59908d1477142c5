"""Agentic workload generation + trace record/replay.

Synthetic traces statistically matched to the paper's collected datasets
(Table 2; Fig. 3 turn structure; Fig. 5 long-tailed tool durations):

  SWE-Bench: turns ~ N(10.9, 2.1); tool ms ~ lognormal(mean 925, sd 3550);
             tokens/program ~ N(70126, 19732)
  BFCL v4:   turns ~ N(6.3, 2.3);  tool ms ~ lognormal(mean 1923, sd 2133);
             tokens/program ~ N(93256, 68687)
  OpenHands: higher turn count (20 ± 6), SWE-like tools.

Tool names are drawn from a per-dataset palette with per-tool duration
scales, including heavy-tail tools (fetch_url, cd) matching Fig. 5.
Programs arrive in a Poisson process. Traces serialize to JSON for replay
(the paper open-sources its traces in the same spirit).

Shared prefixes: real agent fleets run many concurrent sessions of the
same agent template, so every program opens with an identical system
prompt + tool-schema preamble (KVFlow/CacheWise). ``generate_programs``
models this with ``share_ratio``: each program's first turn is prepended
with ``share_ratio * tokens_mean`` preamble tokens drawn from a shared
content stream (``prefix_groups`` splits the fleet across that many
distinct templates). The serving layer's radix index
(:mod:`repro_torch.serving.prefix`) can then deduplicate the preamble's KV
across programs.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Optional

import numpy as np

from repro_torch.core.types import Program, Request, Turn


@dataclasses.dataclass
class WorkloadSpec:
    name: str
    mean_turns: float
    std_turns: float
    tool_mean_s: float
    tool_std_s: float
    tokens_mean: float
    tokens_std: float
    output_frac: float = 0.15         # share of per-turn tokens generated
    max_context: int = 131072
    tools: tuple = ()                 # (name, weight, scale, sigma)
    # floors (defaults match the paper-scale traces; smoke workloads for
    # real-model replay shrink them so CPU runs stay fast)
    min_turn_tokens: int = 64
    min_output_tokens: int = 16
    min_new_tokens: int = 16


SWE_BENCH = WorkloadSpec(
    name="swe-bench",
    mean_turns=10.9, std_turns=2.1,
    tool_mean_s=0.925, tool_std_s=3.550,
    tokens_mean=70126, tokens_std=19732,
    tools=(("ls", 0.15, 0.15, 0.6), ("cat", 0.15, 0.2, 0.6),
           ("grep", 0.1, 0.4, 0.8), ("sed", 0.1, 0.3, 0.7),
           ("python", 0.2, 1.8, 1.0), ("pytest", 0.15, 4.0, 1.1),
           ("git", 0.1, 0.5, 0.8), ("cd", 0.05, 0.08, 2.4)),  # cd: Fig.5 tail
)

BFCL = WorkloadSpec(
    name="bfcl",
    mean_turns=6.3, std_turns=2.3,
    tool_mean_s=1.923, tool_std_s=2.133,
    tokens_mean=93256 * 0.4, tokens_std=68687 * 0.4,  # paper scales BFCL by 0.4
    tools=(("web_search", 0.45, 2.2, 0.9), ("fetch_url", 0.35, 1.2, 1.8),
           ("calculator", 0.1, 0.05, 0.4), ("finish", 0.1, 0.3, 0.6)),
)

OPENHANDS = WorkloadSpec(
    name="openhands",
    mean_turns=20.0, std_turns=6.0,
    tool_mean_s=1.2, tool_std_s=2.8,
    tokens_mean=80000, tokens_std=25000,
    tools=(("edit", 0.25, 0.3, 0.6), ("bash", 0.35, 1.5, 1.2),
           ("browse", 0.15, 2.5, 1.3), ("pytest", 0.25, 5.0, 1.0)),
)

WORKLOADS = {"swe-bench": SWE_BENCH, "bfcl": BFCL, "openhands": OPENHANDS}


def _lognormal_params(mean: float, sigma_ln: float) -> tuple[float, float]:
    """mu for a lognormal with the given *linear* mean and log-space sigma."""
    mu = math.log(max(mean, 1e-6)) - 0.5 * sigma_ln ** 2
    return mu, sigma_ln


def generate_programs(spec: WorkloadSpec, n: int, rate_jps: float,
                      seed: int = 0, turn_scale: float = 1.0,
                      share_ratio: float = 0.0,
                      prefix_groups: int = 1,
                      partial_prefix_drop: float = 0.0,
                      burst_scale: float = 4.0) -> list[Program]:
    """Poisson arrivals at `rate_jps`; `turn_scale` replays the paper's
    Fig. 14 experiment (more turns, inversely scaled token lengths).

    `share_ratio` > 0 prepends a shared agent preamble (system prompt +
    tool schemas) of ``share_ratio * spec.tokens_mean`` tokens to every
    program's first turn; programs are assigned round-robin to
    `prefix_groups` distinct preamble contents (1 = one fleet-wide agent
    template).

    `partial_prefix_drop` > 0 gives that fraction of programs one
    mid-program *context burst* turn (``burst_scale`` × its normal
    new-token count — an agent pasting a huge tool output). Their
    offload-tier entries are then oversized relative to the fleet, so
    under DRAM/SSD pressure the tiered store sheds their *suffix* blocks
    (:meth:`TieredKVStore._demote_lru`) — the workload knob that actually
    exercises partial-prefix adoption (the next turn adopts the shrunk
    usable prefix and recomputes only the uncovered suffix)."""
    rng = np.random.default_rng(seed)
    shared_tokens = int(max(0.0, share_ratio) * spec.tokens_mean)
    t = 0.0
    out = []
    for i in range(n):
        t += rng.exponential(1.0 / rate_jps)
        n_turns = max(2, int(round(rng.normal(spec.mean_turns, spec.std_turns)
                                   * turn_scale)))
        total_tokens = max(2000, rng.normal(spec.tokens_mean, spec.tokens_std))
        total_tokens = min(total_tokens, spec.max_context * 0.9)
        per_turn = total_tokens / n_turns
        names = [w[0] for w in spec.tools]
        weights = np.array([w[1] for w in spec.tools])
        weights = weights / weights.sum()
        turns = []
        for k in range(n_turns):
            # later turns tend to be shorter (Fig. 3: approaching completion)
            frac = 1.25 - 0.5 * (k / max(n_turns - 1, 1))
            tok = max(spec.min_turn_tokens, int(per_turn * frac))
            out_tok = max(spec.min_output_tokens, int(tok * spec.output_frac))
            new_tok = max(spec.min_new_tokens, tok - out_tok)
            if k == n_turns - 1:
                tool, dur = None, 0.0
            else:
                ti = int(rng.choice(len(names), p=weights))
                name, _, scale, sigma = spec.tools[ti]
                mu, s = _lognormal_params(scale, sigma)
                dur = float(rng.lognormal(mu, s))
                tool = name
            text = f"```bash\n{tool} arg{k}\n```" if tool else "Final answer."
            turns.append(Turn(new_tokens=new_tok, output_tokens=out_tok,
                              tool=tool, tool_duration=dur, output_text=text))
        if partial_prefix_drop > 0 and n_turns >= 3 \
                and rng.random() < partial_prefix_drop:
            # context burst on one mid-program turn (never the first or
            # last): the program's offloaded KV becomes oversized and
            # sheds suffix blocks under tier pressure
            k = int(rng.integers(1, n_turns - 1))
            turns[k].new_tokens = min(int(turns[k].new_tokens * burst_scale),
                                      int(spec.max_context * 0.8))
        prefix_id = None
        if shared_tokens:
            # the preamble is extra context on top of the program's own work
            turns[0].new_tokens += shared_tokens
            prefix_id = f"{spec.name}/preamble-{i % max(prefix_groups, 1)}"
        out.append(Program(program_id=f"{spec.name}-{i}", arrival_time=t,
                           turns=turns, shared_prefix_tokens=shared_tokens,
                           shared_prefix_id=prefix_id))
    return out


def generate_skewed_programs(spec: WorkloadSpec, n: int, rate_jps: float,
                             seed: int = 0, *, tenants: int = 4,
                             tenant_skew: float = 1.2,
                             share_ratio: float = 0.2,
                             storm_frac: float = 0.0,
                             storm_gap_s: float = 20.0,
                             churn_frac: float = 0.0,
                             churn_scale: float = 8.0,
                             turn_scale: float = 1.0) -> list[Program]:
    """Skewed multi-tenant arrival pattern — the cluster-routing stressor.

    Multi-replica serving is easy when load is uniform; the regimes where
    KV-aware placement and migration actually matter are:

    - **hot-tenant skew**: programs belong to ``tenants`` agent templates
      drawn from a Zipf(``tenant_skew``) distribution, each with its own
      shared preamble. Most sessions run the hottest template, so its
      preamble KV (and therefore prefix affinity) concentrates on a few
      replicas — exactly the herding-vs-cache-heat tension.
    - **tool-storm bursts**: ``storm_frac`` of the programs run *batch*
      tools (CI pipelines, cron-fed crawlers) whose duration is a fixed
      multiple of ``storm_gap_s`` per turn index, identical across the
      cohort — programs that arrived together keep returning together,
      turn after turn, and slam their home replicas simultaneously (the
      thundering-herd case where migrating some returners to idle peers
      beats queueing them all).
    - **replica-affinity churn**: ``churn_frac`` of the programs alternate
      short and very long (``churn_scale``×) tool calls. Long absences
      expire TTL pins and demote KV to the tiers, so these programs keep
      returning to a *cold* home — the population for which the
      migrate-vs-reload-vs-recompute decision is genuinely three-way.

    Deterministic for a given seed (the base fleet reuses
    :func:`generate_programs` with a derived seed, so traces stay
    byte-stable)."""
    progs = generate_programs(spec, n=n, rate_jps=rate_jps, seed=seed,
                              turn_scale=turn_scale, share_ratio=share_ratio,
                              prefix_groups=1)
    rng = np.random.default_rng(seed + 0x5EED)
    tenants = max(tenants, 1)
    ranks = np.arange(1, tenants + 1, dtype=np.float64)
    weights = ranks ** -max(tenant_skew, 0.0)
    weights /= weights.sum()
    for p in progs:
        tid = int(rng.choice(tenants, p=weights))
        if p.shared_prefix_tokens:
            p.shared_prefix_id = f"{spec.name}/tenant-{tid}"
        stormy = rng.random() < storm_frac
        churny = rng.random() < churn_frac
        for k, t in enumerate(p.turns):
            if t.tool is None:
                continue
            if churny and k % 2 == 1:
                t.tool_duration *= churn_scale
            if stormy:
                # batch tools: duration is a fixed multiple of the storm
                # gap, identical across the cohort for the same turn
                # index -> programs that arrived together return together
                t.tool_duration = storm_gap_s * (1 + k % 3)
    return progs


def generate_diurnal_programs(spec: WorkloadSpec, n: int, rate_jps: float,
                              seed: int = 0, *, period_s: float = 600.0,
                              peak_mult: float = 4.0,
                              burst_frac: float = 0.0,
                              burst_size: int = 4,
                              burst_span_s: float = 1.0,
                              **skew_kw) -> list[Program]:
    """Diurnal + bursty arrival shape — the autoscaling stressor.

    A static fleet sized for the peak over-provisions the trough and a
    fleet sized for the trough melts at the peak; this generator builds
    the workload where an elastic cluster earns its replica-hours:

    - **diurnal wave**: arrivals follow a non-homogeneous Poisson process
      with rate ``rate_jps * (1 + (peak_mult-1) * (1+sin)/2)`` over a
      ``period_s`` cycle (trough at t=0, peak half a period later),
      generated by thinning — candidates are drawn at the peak rate and
      accepted with probability ``rate(t)/rate_max``, so the trace is
      deterministic for a seed and the *shape* is exact, not binned;
    - **arrival bursts**: ``burst_frac`` of the accepted arrivals become
      cohort heads — ``burst_size-1`` extra programs land within
      ``burst_span_s`` of them (a team kicking off CI, a cron fan-out).
      Bursts ride on top of the wave, so peak-hour bursts are the
      thundering-herd worst case the scaling hysteresis must absorb
      without thrashing.

    Program *content* (turns, tenants, tool storms, churn) comes from
    :func:`generate_skewed_programs` with the same ``n`` and any
    ``skew_kw`` passed through; only the arrival times are rewritten,
    so diurnal traces stay comparable with the skewed smoke traces.
    Deterministic for a given seed."""
    progs = generate_skewed_programs(spec, n=n, rate_jps=rate_jps,
                                     seed=seed, **skew_kw)
    rng = np.random.default_rng(seed + 0xD1E5)
    peak_mult = max(peak_mult, 1.0)
    rate_max = rate_jps * peak_mult

    def rate_at(t: float) -> float:
        wave = 0.5 * (1.0 + math.sin(2.0 * math.pi * t / period_s
                                     - math.pi / 2.0))
        return rate_jps * (1.0 + (peak_mult - 1.0) * wave)

    arrivals: list[float] = []
    t = 0.0
    while len(arrivals) < len(progs):
        t += rng.exponential(1.0 / rate_max)        # thinning candidates
        accept = rng.random() < rate_at(t) / rate_max
        if not accept:
            continue
        arrivals.append(t)
        if burst_frac > 0 and rng.random() < burst_frac:
            extra = min(burst_size - 1, len(progs) - len(arrivals))
            for _ in range(max(extra, 0)):
                arrivals.append(t + rng.random() * burst_span_s)
    arrivals.sort()
    for p, at in zip(progs, arrivals):
        p.arrival_time = at
    progs.sort(key=lambda p: (p.arrival_time, p.program_id))
    return progs


def request_for_turn(p: Program, turn_idx: int, arrival: float) -> Request:
    t = p.turns[turn_idx]
    dur = t.tool_duration
    if t.parallel_tools:
        dur = max(d for _, d in t.parallel_tools)       # barrier on all tools
    dur *= max(0.0, 1.0 - t.async_overlap)              # futures hide a share
    prompt_len = p.context_len_at(turn_idx)
    return Request(
        program_id=p.program_id,
        turn_idx=turn_idx,
        prompt_len=prompt_len,
        output_len=t.output_tokens,
        arrival_time=arrival,
        program_arrival_time=p.arrival_time,
        tool=t.tool,
        tool_duration=dur,
        parallel_tools=t.parallel_tools,
        output_text=t.output_text,
        is_last_turn=turn_idx == p.num_turns - 1,
        shared_prefix_len=min(p.shared_prefix_tokens, prompt_len),
        shared_prefix_id=p.shared_prefix_id,
    )


# ---------------------------------------------------------------- traces io
def save_trace(programs: list[Program], path: str | pathlib.Path) -> None:
    data = [{
        "program_id": p.program_id,
        "arrival_time": p.arrival_time,
        "turns": [dataclasses.asdict(t) for t in p.turns],
        "shared_prefix_tokens": p.shared_prefix_tokens,
        "shared_prefix_id": p.shared_prefix_id,
    } for p in programs]
    pathlib.Path(path).write_text(json.dumps(data))


def load_trace(path: str | pathlib.Path) -> list[Program]:
    data = json.loads(pathlib.Path(path).read_text())
    return [Program(d["program_id"], d["arrival_time"],
                    [Turn(**t) for t in d["turns"]],
                    shared_prefix_tokens=d.get("shared_prefix_tokens", 0),
                    shared_prefix_id=d.get("shared_prefix_id"))
            for d in data]
