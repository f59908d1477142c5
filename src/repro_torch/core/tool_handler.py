"""Tool-Call Handler (paper §5.1, §5.3, Appendix A/B).

A thin class invoked by the scheduler on request arrival and completion. It
(1) parses tool calls out of LLM output (OpenAI function-call schema, bash
code blocks, terminal-bench command lists), (2) tracks per-tool latency from
observed inter-request intervals within the same program_id, and (3) returns
TTL values via the utility model.

Scheduler-facing API (paper §5.3):
- ``func_call_finish(tool, timestamp, program_id)``: request finished with a
  parsed tool call — record the tool start time.
- ``update_tool_call_time(program_id, timestamp)``: the next request of the
  program arrived — close the interval, record the duration.
- ``set_up_ttl(request, tool)``: best TTL for this finished request.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Callable, Optional

from repro_torch.core.ttl import TTLDecision, TTLModel
from repro_torch.core.types import Request


class ToolCallParser:
    """Extract the tool/function name from LLM output text.

    Mirrors the paper's Appendix A (mini-swe-agent bash blocks) and Appendix
    B (OpenAI schema / terminal-bench). Returns None when no tool call is
    present (final turn)."""

    BASH_RE = re.compile(r"```bash\s*\n(.*?)\n```", re.DOTALL)

    def parse(self, text: str) -> Optional[str]:
        if not text:
            return None
        name = self._parse_openai_json(text)
        if name:
            return name
        name = self._parse_bash_block(text)
        if name:
            return name
        return self._parse_terminal_bench(text)

    def _parse_openai_json(self, text: str) -> Optional[str]:
        # OpenAI-style: {"type": "function_call", "name": "get_weather", ...}
        try:
            obj = json.loads(text)
        except (json.JSONDecodeError, ValueError):
            return None
        if isinstance(obj, dict):
            if obj.get("type") == "function_call" and "name" in obj:
                return str(obj["name"])
            # terminal-bench: {"commands": [{"keystrokes": "pytest -q\n", ...}]}
            cmds = obj.get("commands")
            if isinstance(cmds, list) and cmds:
                keys = cmds[0].get("keystrokes", "")
                words = keys.split()
                return words[0] if words else None
        return None

    def _parse_bash_block(self, text: str) -> Optional[str]:
        # mini-swe-agent: exactly one ```bash ...``` block; first word =
        # command; handle && / || splitting (Appendix B)
        actions = self.BASH_RE.findall(text)
        if len(actions) != 1:
            return None
        first_cmd = re.split(r"&&|\|\|", actions[0].strip())[0].strip()
        words = first_cmd.split()
        return words[0] if words else None

    def _parse_terminal_bench(self, text: str) -> Optional[str]:
        return None  # folded into _parse_openai_json


@dataclasses.dataclass
class _PendingTool:
    tool: str
    finish_ts: float


class ToolCallHandler:
    """Decoupled from the scheduler loop; owns the TTL model."""

    def __init__(self, ttl_model: TTLModel | None = None,
                 prefill_reload_fn: Callable[[Request], float] | None = None,
                 parser: ToolCallParser | None = None):
        self.ttl_model = ttl_model or TTLModel()
        self.parser = parser or ToolCallParser()
        # PrefillReload(r): seconds to reconstruct r's KV (profiler-backed)
        self.prefill_reload_fn = prefill_reload_fn or (lambda r: 0.0)
        # live per-replica queueing-delay ETA (cluster serving wires this to
        # Engine.queue_eta); None = the TTL model's fleet-average T̄
        self.queue_eta_fn: Optional[Callable[[], float]] = None
        self._pending: dict[str, _PendingTool] = {}     # program_id -> tool
        self.seen_programs: set[str] = set()
        # telemetry plane: observed tool durations (the S[f] feed) land
        # on the replica's trace lane; None = no-op
        self.obs = None
        self.obs_replica = "engine0"

    # ------------------------------------------------------------- parsing
    @staticmethod
    def joint_key(names) -> str:
        """Barrier key for a parallel fan-out (Appendix C.1)."""
        return "par:" + "+".join(sorted(names))

    def identify_tool(self, req: Request) -> Optional[str]:
        """Tool invoked by this finished request (None = program done).

        Prefers the structured field (engine-level function-call interface);
        falls back to parsing raw output text (chat-interface agents).
        Parallel fan-outs map to a joint barrier key whose empirical CDF is
        the max-of-durations distribution."""
        if req.is_last_turn:
            return None
        if req.parallel_tools:
            return self.joint_key([n for n, _ in req.parallel_tools])
        if req.tool:
            return req.tool
        return self.parser.parse(req.output_text)

    # ---------------------------------------------------- scheduler-facing
    def func_call_finish(self, tool: str, timestamp: float,
                         program_id: str) -> None:
        self._pending[program_id] = _PendingTool(tool, timestamp)

    def update_tool_call_time(self, program_id: str, timestamp: float) -> None:
        pend = self._pending.pop(program_id, None)
        if pend is not None:
            self.ttl_model.observe_tool(pend.tool, timestamp - pend.finish_ts)
            if self.obs is not None:
                self.obs.trace.instant(
                    self.obs_replica, "tool_duration", timestamp, cat="ttl",
                    args={"program": program_id, "tool": pend.tool,
                          "duration": round(timestamp - pend.finish_ts, 9)})
                if self.obs.drift is not None:
                    # ground truth for the tool-CDF estimator staged at
                    # set_up_ttl time (no-op if no solve ran)
                    self.obs.drift.realize(
                        "tool_duration", program_id, timestamp,
                        timestamp - pend.finish_ts)
        self.seen_programs.add(program_id)

    def set_up_ttl(self, req: Request, tool: str) -> TTLDecision:
        reload = self.prefill_reload_fn(req)
        queue_eta = self.queue_eta_fn() if self.queue_eta_fn else None
        if self.obs is not None and self.obs.drift is not None:
            # stage every solver input the drift watchdog can later test:
            # the queueing delay the model priced (realized at the next
            # non-pin admission), the reload-ETA peek (realized when the
            # reload commits) and the tool-duration expectation (realized
            # when the program returns)
            drift = self.obs.drift
            pid = req.program_id
            ts = req.finish_time if req.finish_time >= 0 else 0.0
            drift.predict("queue_eta", pid, ts,
                          queue_eta if queue_eta is not None
                          else self.ttl_model.t_bar.mean)
            drift.predict("prefill_reload", pid, ts, reload)
            drift.predict("tool_duration", pid, ts,
                          self.ttl_model.predict_tool_duration(tool))
        if req.parallel_tools and \
                self.ttl_model.records.count(tool) <= self.ttl_model.cfg.cold_start_k:
            # joint barrier CDF not yet warm: independence product of the
            # individual tools' CDFs (paper Appendix C.1)
            names = [n for n, _ in req.parallel_tools]
            return self.ttl_model.solve_parallel(names, reload, queue_eta)
        return self.ttl_model.solve(tool, reload, queue_eta)

    # ----------------------------------------------------------- lifecycle
    def on_program_finish(self, program_id: str, num_turns: int) -> None:
        self._pending.pop(program_id, None)
        self.ttl_model.observe_program_finish(num_turns)
