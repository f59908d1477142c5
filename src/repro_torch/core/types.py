"""Core datatypes for multi-turn agent serving.

A *program* is one agent job (e.g. a SWE-Bench task): a sequence of *turns*,
each an LLM request; between turns the agent runs a tool. A *request* is one
turn instance submitted to the engine. Context accumulates across turns
(prompt_i = full history + new tool output).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools
from typing import Optional

_req_counter = itertools.count()


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclasses.dataclass
class Turn:
    """One LLM call + (optionally) the tool(s) invoked after it."""
    new_tokens: int                 # tokens appended this turn (prompt / tool output)
    output_tokens: int              # tokens the LLM generates this turn
    tool: Optional[str] = None      # tool called after this turn (None = final)
    tool_duration: float = 0.0      # ground-truth duration (revealed at runtime)
    output_text: str = ""           # raw text (exercise the tool-call parsers)
    # Appendix C.1 extensions:
    parallel_tools: Optional[list] = None   # [(name, duration), ...] barrier
    async_overlap: float = 0.0      # fraction of tool time hidden by the
                                    # model continuing to generate (futures)


@dataclasses.dataclass
class Program:
    program_id: str
    arrival_time: float
    turns: list[Turn] = dataclasses.field(default_factory=list)
    # cross-program shared preamble (system prompt / tool schemas): the
    # first `shared_prefix_tokens` of the context come from the named
    # shared stream, identical across every program with the same id
    shared_prefix_tokens: int = 0
    shared_prefix_id: Optional[str] = None

    @property
    def num_turns(self) -> int:
        return len(self.turns)

    def context_len_at(self, turn_idx: int) -> int:
        """Prompt length (full accumulated context) of turn `turn_idx`."""
        n = 0
        for i in range(turn_idx):
            n += self.turns[i].new_tokens + self.turns[i].output_tokens
        return n + self.turns[turn_idx].new_tokens

    def total_tokens(self) -> int:
        return sum(t.new_tokens + t.output_tokens for t in self.turns)


@dataclasses.dataclass
class Request:
    """One turn submitted to the serving engine."""
    program_id: str
    turn_idx: int
    prompt_len: int                 # full context length (tokens) incl. history
    output_len: int                 # tokens to generate
    arrival_time: float
    program_arrival_time: float
    tool: Optional[str] = None      # tool this turn will call when it finishes
    tool_duration: float = 0.0
    parallel_tools: Optional[list] = None   # [(name, duration), ...]
    output_text: str = ""
    is_last_turn: bool = False
    shared_prefix_len: int = 0      # leading tokens from a shared stream
    shared_prefix_id: Optional[str] = None
    request_id: int = dataclasses.field(default_factory=lambda: next(_req_counter))

    # --- engine-managed state ---
    state: RequestState = RequestState.WAITING
    prefill_pos: int = 0            # prompt tokens already prefilled
    generated: int = 0              # output tokens generated so far
    cached_prefix: int = 0          # prompt tokens already in HBM at admission
    first_schedule_time: float = -1.0
    first_token_time: float = -1.0  # TTFT anchor: first output token emitted
    finish_time: float = -1.0
    queueing_delay: float = 0.0     # time waited before first schedule
    preemptions: int = 0
    served_from_pin: bool = False   # admitted with its KV pinned (TTL hit)
    served_from_shared: bool = False  # admitted via radix shared-prefix hit
    reload_seconds: float = 0.0     # time spent reloading/recomputing prefix
    prefix_node: Optional[object] = None  # deepest locked radix node
    block_hashes: Optional[tuple] = None  # cached prompt block hash chain

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.output_len

    def done_prefill(self) -> bool:
        return self.prefill_pos >= self.prompt_len

    def done(self) -> bool:
        return self.generated >= self.output_len


@dataclasses.dataclass
class ProgramStats:
    """Per-program accounting for JCT / bubble-time metrics (Fig. 4/8)."""
    program_id: str
    arrival_time: float
    finish_time: float = -1.0
    num_turns: int = 0
    total_queueing: float = 0.0     # sum of per-turn queueing delays ("bubble")
    total_reload: float = 0.0       # prefill-recompute / reload seconds
    total_tool_time: float = 0.0
    total_ttft: float = 0.0         # sum of per-turn time-to-first-token
    ttl_hits: int = 0
    ttl_misses: int = 0
    prefix_hits: int = 0            # turns admitted via shared-prefix match
    prefix_hit_tokens: int = 0      # prompt tokens served from shared KV

    @property
    def jct(self) -> float:
        return self.finish_time - self.arrival_time
