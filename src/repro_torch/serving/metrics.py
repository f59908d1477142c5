"""JCT / throughput / bubble-time metrics (paper Figs. 4, 8–11)."""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable

import numpy as np

from repro_torch.core.types import ProgramStats


@dataclasses.dataclass
class Summary:
    n_programs: int
    avg_jct: float
    p50_jct: float
    p90_jct: float
    p95_jct: float
    p99_jct: float
    throughput_jobs_per_s: float
    throughput_tokens_per_s: float
    avg_queueing: float          # per-program accumulated bubble time
    avg_ttl_hit_rate: float
    makespan: float
    avg_ttft: float = 0.0        # mean per-turn time-to-first-token
    prefill_tokens: float = 0.0  # tokens actually prefilled fleet-wide
    prefix_hit_tokens: float = 0.0  # prompt tokens served from shared-prefix KV
    p50_queueing: float = 0.0    # per-program bubble-time percentiles
    p99_queueing: float = 0.0
    total_tool_pause_s: float = 0.0  # wall seconds programs spent in tools
    reload_tokens: float = 0.0       # prompt tokens served by tier reloads
    recompute_tokens: float = 0.0    # returning-turn tokens prefilled cold

    def row(self) -> dict:
        return dataclasses.asdict(self)


def summarize(programs: Iterable[ProgramStats], total_tokens: int = 0,
              prefill_tokens: float = 0.0,
              prefix_hit_tokens: float = 0.0,
              reload_tokens: float = 0.0,
              recompute_tokens: float = 0.0) -> Summary:
    done = [p for p in programs if p.finish_time >= 0]
    if not done:
        return Summary(0, *([0.0] * 9), 0.0)
    jcts = np.array([p.jct for p in done])
    t0 = min(p.arrival_time for p in done)
    t1 = max(p.finish_time for p in done)
    makespan = max(t1 - t0, 1e-9)
    hits = sum(p.ttl_hits for p in done)
    misses = sum(p.ttl_misses for p in done)
    turns = sum(p.num_turns for p in done)
    return Summary(
        n_programs=len(done),
        avg_jct=float(jcts.mean()),
        p50_jct=float(np.percentile(jcts, 50)),
        p90_jct=float(np.percentile(jcts, 90)),
        p95_jct=float(np.percentile(jcts, 95)),
        p99_jct=float(np.percentile(jcts, 99)),
        throughput_jobs_per_s=len(done) / makespan,
        throughput_tokens_per_s=total_tokens / makespan,
        avg_queueing=float(np.mean([p.total_queueing for p in done])),
        avg_ttl_hit_rate=hits / max(hits + misses, 1),
        makespan=float(makespan),
        avg_ttft=float(sum(p.total_ttft for p in done) / max(turns, 1)),
        prefill_tokens=float(prefill_tokens),
        prefix_hit_tokens=float(prefix_hit_tokens),
        p50_queueing=float(np.percentile(
            [p.total_queueing for p in done], 50)),
        p99_queueing=float(np.percentile(
            [p.total_queueing for p in done], 99)),
        total_tool_pause_s=float(sum(p.total_tool_time for p in done)),
        reload_tokens=float(reload_tokens),
        recompute_tokens=float(recompute_tokens),
    )
