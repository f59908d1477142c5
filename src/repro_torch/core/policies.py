"""Retention + priority policies: Continuum and the paper's baselines.

A policy decides (a) waiting-queue priority and (b) KV retention when a
request finishes with a pending tool call:

- ``vllm``        — end-of-turn eviction, request-level FCFS (vanilla vLLM).
- ``autellix``    — PLAS: least cumulative program service first; end-of-turn
                    eviction (Autellix).
- ``infercept``   — preserve iff E[tool duration] (GPU-occupancy cost) is
                    below the reload/recompute cost; unbounded pin, no
                    queueing-delay term (InferCept, LMCache-async variant).
- ``static_ttl``  — program-level FCFS + fixed cold-start TTL (ablation).
- ``fcfs_program``— program-level FCFS only, end-of-turn eviction (ablation).
- ``continuum``   — program-level FCFS + TTL-aware priority + full utility
                    model (Eq. 2).

Priority keys sort ascending (smaller = scheduled first).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Protocol

from repro_torch.core.tool_handler import ToolCallHandler
from repro_torch.core.types import Request, RequestState


@dataclasses.dataclass
class PinDecision:
    ttl: float                     # 0 = evict now; math.inf = until return
    meta: Optional[object] = None


class Policy(Protocol):
    name: str

    def priority_key(self, req: Request, now: float,
                     pinned_programs: set[str],
                     attained_service: dict[str, float]) -> tuple: ...

    def retention(self, req: Request, tool: Optional[str],
                  handler: ToolCallHandler) -> PinDecision: ...


class _Base:
    retains = False

    def priority_key(self, req, now, pinned_programs, attained_service):
        # vLLM default: preempted first, then request arrival order
        return (0 if req.state == RequestState.PREEMPTED else 1,
                req.arrival_time, req.request_id)

    def retention(self, req, tool, handler) -> PinDecision:
        return PinDecision(0.0)


class VLLMPolicy(_Base):
    """End-of-turn eviction, request-level FCFS."""
    name = "vllm"


class AutellixPolicy(_Base):
    """PLAS: programs with less cumulative service time first (Autellix).

    Discretized into quanta to avoid starvation-free strict ordering churn,
    as in the paper's MLFQ-flavored description."""
    name = "autellix"

    def __init__(self, quantum: float = 2.0):
        self.quantum = quantum

    def priority_key(self, req, now, pinned_programs, attained_service):
        served = attained_service.get(req.program_id, 0.0)
        level = int(served / self.quantum)
        return (0 if req.state == RequestState.PREEMPTED else 1,
                level, req.program_arrival_time, req.request_id)


class InferCeptPolicy(_Base):
    """Preserve iff expected GPU-occupancy cost of pinning through the tool
    call is below the reload/recompute cost of the next turn. No TTL bound,
    no per-turn queueing term (the gap Continuum fixes)."""
    name = "infercept"
    retains = True

    def retention(self, req, tool, handler) -> PinDecision:
        model = handler.ttl_model
        d = model.records.durations(tool)
        if d.size == 0:
            d = model.records.durations(None)
        if d.size == 0:
            return PinDecision(0.0)
        expected = float(d.mean())
        reload_cost = handler.prefill_reload_fn(req)
        # normalized by MemUsage/M̄ on both sides (cancels)
        if expected < reload_cost:
            return PinDecision(math.inf)   # pin until the program returns
        return PinDecision(0.0)


class ProgramFCFSPolicy(_Base):
    """Ablation: program-level FCFS ordering only (no retention)."""
    name = "fcfs_program"

    def priority_key(self, req, now, pinned_programs, attained_service):
        return (0 if req.state == RequestState.PREEMPTED else 1,
                req.program_arrival_time, req.turn_idx, req.request_id)


class StaticTTLPolicy(ProgramFCFSPolicy):
    """Ablation: program-FCFS + fixed TTL from the cold-start formula."""
    name = "static_ttl"
    retains = True

    def __init__(self, ttl: float | None = None):
        self._ttl = ttl

    def retention(self, req, tool, handler) -> PinDecision:
        if self._ttl is not None:
            return PinDecision(self._ttl)
        model = handler.ttl_model
        g = model._gain_term(handler.prefill_reload_fn(req))
        return PinDecision(model._cold_start_ttl(g))


class ContinuumPolicy(_Base):
    """Full Continuum: TTL-aware priority + program-level FCFS + Eq. 2."""
    name = "continuum"
    retains = True

    def priority_key(self, req, now, pinned_programs, attained_service):
        # paper §4.3: preempted ≻ pinned-within-TTL ≻ rest; then program FCFS
        return (0 if req.state == RequestState.PREEMPTED else 1,
                0 if req.program_id in pinned_programs else 1,
                req.program_arrival_time, req.turn_idx, req.request_id)

    def retention(self, req, tool, handler) -> PinDecision:
        dec = handler.set_up_ttl(req, tool)
        return PinDecision(dec.ttl, dec)


POLICIES = {
    "vllm": VLLMPolicy,
    "autellix": AutellixPolicy,
    "infercept": InferCeptPolicy,
    "fcfs_program": ProgramFCFSPolicy,
    "static_ttl": StaticTTLPolicy,
    "continuum": ContinuumPolicy,
}


def make_policy(name: str, **kw) -> Policy:
    return POLICIES[name](**kw)
