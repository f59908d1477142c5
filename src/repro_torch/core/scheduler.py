"""Continuum's scheduler (paper Algorithm 1), policy-parameterized.

Owns the waiting queue Q, the TTL map P (pinned programs), and the
historical tool-call records S (inside the tool handler). The engine calls:

    on_request_arrive(r)      — line 1–5
    on_request_finish(r)      — line 6–12
    schedule(now, admit_fn)   — line 13–26 (admission via engine callback)

Memory lives in a :class:`~repro_torch.serving.blocks.BlockManager`; offload
tiers in an optional :class:`~repro_torch.serving.offload.OffloadManager`; the
optional cross-program shared-prefix cache in a
:class:`~repro_torch.serving.prefix.RadixPrefixIndex` (admission then charges
only the suffix a radix match doesn't cover, and TTL pins inherit the
matched path's refcount so pinned prefixes are eviction-proof).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

from repro_torch.core.policies import Policy
from repro_torch.core.tool_handler import ToolCallHandler
from repro_torch.core.types import Request, RequestState
from repro_torch.serving.blocks import BlockManager
from repro_torch.serving.offload import OffloadManager
from repro_torch.serving.prefix import RadixPrefixIndex, request_block_hashes


def materialized_tokens(req: Request) -> int:
    """KV tokens a request's cache PHYSICALLY holds: the final sampled
    token's KV is never appended (it is the next turn's first input), so
    a request that generated g tokens materialized prompt + g - 1
    positions; one still mid-prefill holds exactly its prefilled prefix.
    Pins and tier entries credit exactly this — crediting prompt + g
    would make every clean reload/adoption look one token short in the
    physical path."""
    if req.generated > 0:               # prefill done: prompt is resident
        return req.prompt_len + req.generated - 1
    return req.prefill_pos


@dataclasses.dataclass
class PinEntry:
    program_id: str
    request_id: int
    expiry: float                  # absolute time; math.inf = until return
    tokens: int                    # cached context tokens
    pinned_at: float
    prefix_node: Optional[object] = None   # radix lock inherited from the
    # finished request: keeps the program's shared-prefix path pin-protected


@dataclasses.dataclass
class SchedulerStats:
    pins: int = 0
    ttl_hits: int = 0
    ttl_expiries: int = 0
    deadlock_evictions: int = 0
    preemptions: int = 0
    offload_reloads: int = 0
    full_recomputes: int = 0
    prefix_hits: int = 0           # admissions served from the radix index
    prefix_hit_tokens: int = 0     # prompt tokens covered by those matches
    reload_seconds: float = 0.0    # link time paid by offload-tier reloads
    recompute_seconds: float = 0.0  # est. prefill time paid by full recomputes
    demotions: int = 0             # TTL expiries demoted to a lower tier
                                   # (instead of dropped)
    reload_tokens: int = 0         # prompt tokens served by tier reloads
    recompute_tokens: int = 0      # prompt tokens re-prefilled because the
                                   # KV was gone (turn > 0, no cache source)


class Scheduler:
    def __init__(self, policy: Policy, handler: ToolCallHandler,
                 blocks: BlockManager,
                 offload: Optional[OffloadManager] = None,
                 prefix_index: Optional[RadixPrefixIndex] = None):
        self.policy = policy
        self.handler = handler
        self.blocks = blocks
        self.offload = offload
        self.prefix_index = prefix_index
        self.waiting: list[Request] = []
        self.pinned: dict[str, PinEntry] = {}          # TTL map P
        self.attained_service: dict[str, float] = {}   # Autellix PLAS state
        self.program_turns: dict[str, int] = {}
        self.stats = SchedulerStats()
        self.on_evict: Optional[Callable[[str], None]] = None  # backend hook
        # tiered-store backend hooks: a demotion keeps the KV (host copy)
        # while an eviction genuinely loses it; a reload restores it
        # (on_reload receives the usable cached-token count — a partial
        # prefix truncates the physical restore)
        self.on_demote: Optional[Callable[[str], None]] = None
        self.on_reload: Optional[Callable[[str, int], None]] = None
        # engine-wired estimator: prefill seconds for a token count (prices
        # the recompute a TTL/offload miss causes — bench/metrics signal)
        self.recompute_estimate_fn: Optional[Callable[[int], float]] = None
        # decision log: when the engine points this at a list, every
        # scheduling decision (admit source, pin, unpin, demote/evict,
        # reload, preempt) is appended as a tuple — the differential
        # replay harness compares these streams across backends
        self.decision_sink: Optional[list] = None
        # telemetry plane (repro_torch.obs.Telemetry) — None keeps _log at a
        # single attribute test; `now` shadows the last clock value any
        # public entry point saw, so _log can timestamp decisions made
        # deep inside call chains that don't thread `now`
        self.obs = None
        self.obs_replica = "engine0"
        self.now = 0.0

    def _log(self, kind: str, program_id: str, *info) -> None:
        if self.decision_sink is not None:
            self.decision_sink.append((kind, program_id) + info)
        if self.obs is not None:
            self.obs.decision(self.obs_replica, kind, program_id, info,
                              self.now)

    # ----------------------------------------------------------- Algorithm 1
    def on_request_arrive(self, req: Request, now: float) -> None:
        self.now = now
        req.state = RequestState.WAITING
        self.waiting.append(req)
        if self.obs is not None:
            # ground-truth return gap for the regret analyzer: the delta
            # from the previous turn's solve (tool start) to this arrival
            # is the tool duration the solver could only model
            self.obs.audit.note_arrival(req.program_id, now)
        # seen program: close the tool-call interval (S[f] <- duration)
        self.handler.update_tool_call_time(req.program_id, now)
        self.program_turns[req.program_id] = req.turn_idx + 1

    def on_request_finish(self, req: Request, now: float) -> dict:
        """Returns {"pinned": bool, "ttl": float}. Engine already marked the
        request finished and owns its block allocation."""
        self.now = now
        req.state = RequestState.FINISHED
        req.finish_time = now
        tool = self.handler.identify_tool(req)
        if tool is None:
            # last request of its program: free KV + any leftover pin. The
            # program will never return, so nothing is offloaded (and any
            # stale offload entry is dropped to reclaim tier capacity).
            self._free_finished(req, now, final=True)
            self._unpin(req.program_id, reason="program_done", now=now)
            self.handler.on_program_finish(req.program_id,
                                           self.program_turns.get(req.program_id,
                                                                  req.turn_idx + 1))
            return {"pinned": False, "ttl": 0.0}

        self.handler.func_call_finish(tool, now, req.program_id)
        if self.obs is not None:
            # stage the solve context: the TTL model itself knows neither
            # the program nor the clock (see repro_torch.obs.audit)
            self.obs.audit.begin_solve(req.program_id, tool, req.turn_idx,
                                       now, replica=self.obs_replica)
        decision = self.policy.retention(req, tool, self.handler)
        if decision.ttl > 0:
            n = self.blocks.pin(req.request_id, req.program_id)
            self.pinned[req.program_id] = PinEntry(
                req.program_id, req.request_id, now + decision.ttl,
                materialized_tokens(req), now,
                prefix_node=req.prefix_node)   # pin inherits the radix lock
            req.prefix_node = None
            self.stats.pins += 1
            self._log("pin", req.program_id, req.turn_idx,
                      round(decision.ttl, 9))
            return {"pinned": True, "ttl": decision.ttl, "blocks": n}
        self._free_finished(req, now)
        return {"pinned": False, "ttl": 0.0}

    def _free_finished(self, req: Request, now: float,
                       final: bool = False) -> None:
        self.blocks.free_request(req.request_id)
        self._release_prefix(req)
        if final and self.offload is not None:
            # program finished: no future turn will ever reload this KV
            self.offload.drop(req.program_id)
        self.release_program(req.program_id,
                             0 if final else materialized_tokens(req),
                             now, reason="finish_final" if final
                             else "finish")

    def release_program(self, program_id: str, tokens: int, now: float,
                        reason: str) -> bool:
        """THE release protocol (single copy — finish, TTL expiry,
        deadlock victims and engine preemption all come through here):
        offload-demote ``tokens`` of the program's HBM KV if a tier will
        take them (``tokens=0`` = nothing reloadable, e.g. a final turn),
        then notify the backend demote-vs-evict. Returns demoted."""
        self.now = now
        demoted = False
        if self.offload is not None and tokens > 0:
            demoted = self.offload.offload(
                program_id, tokens, tokens * self._kv_bytes_per_token,
                now=now) is not None
        self._notify_release(program_id, demoted, reason=reason)
        return demoted

    def _notify_release(self, program_id: str, demoted: bool,
                        reason: str = "") -> None:
        """Tell the execution backend what happened to the program's HBM
        KV: demoted (a lower tier holds it — keep a host copy) vs evicted
        (genuinely gone)."""
        if demoted:
            self.stats.demotions += 1
            self._log("demote", program_id, reason)
            if self.on_demote is not None:
                self.on_demote(program_id)
                return
        else:
            self._log("evict", program_id, reason)
        if self.on_evict is not None:
            self.on_evict(program_id)

    def _release_prefix(self, req: Request) -> None:
        if self.prefix_index is not None and req.prefix_node is not None:
            self.prefix_index.release(req.prefix_node)
        req.prefix_node = None

    # -------------------------------------------------- cross-replica moves
    def migrate_out(self, program_id: str, now: float,
                    keep_copy: bool = True) -> int:
        """Release ``program_id``'s pinned HBM KV because it is leaving
        this replica (cluster migration / cold re-home) — the blocks are
        freed WITHOUT a home-tier demotion: the KV departs on a peer link
        (``keep_copy=True``; the backend stages a host copy for the
        flight) or is genuinely dropped (``keep_copy=False``, the
        recompute-elsewhere decision). Returns the pinned token count
        (0 = no pin held here)."""
        self.now = now
        e = self.pinned.pop(program_id, None)
        if e is None:
            return 0
        self.blocks.unpin_free(program_id)
        if self.prefix_index is not None and e.prefix_node is not None:
            self.prefix_index.release(e.prefix_node)
            e.prefix_node = None
        self._log("migrate_out" if keep_copy else "rehome_drop", program_id,
                  e.tokens)
        if keep_copy and self.on_demote is not None:
            self.on_demote(program_id)
        elif self.on_evict is not None:
            self.on_evict(program_id)
        return e.tokens

    # engine wires this (depends on model config)
    _kv_bytes_per_token: float = 0.0

    def unpin_expired(self, now: float) -> None:
        """Line 15–18: evict pins past TTL unless the program is back in Q."""
        in_queue = {r.program_id for r in self.waiting}
        for pid in list(self.pinned):
            e = self.pinned[pid]
            if now > e.expiry and pid not in in_queue:
                self._unpin(pid, reason="ttl_expired", now=now)
                self.stats.ttl_expiries += 1

    def _unpin(self, program_id: str, reason: str, now: float = 0.0) -> int:
        e = self.pinned.pop(program_id, None)
        if e is None:
            return 0
        n = self.blocks.unpin_free(program_id)
        if self.prefix_index is not None and e.prefix_node is not None:
            # the shared path stays cached but is no longer pin-protected
            self.prefix_index.release(e.prefix_node)
            e.prefix_node = None
        self._log("unpin", program_id, reason)
        # TTL expiry demotes HBM→DRAM (async write on the transfer
        # timeline) instead of dropping the context; a finished program
        # (or an empty pin) has nothing reloadable
        self.release_program(
            program_id,
            e.tokens if n and reason != "program_done" else 0,
            now, reason=reason)
        return n

    # ------------------------------------------------------------ selection
    def pick_next(self, now: float) -> Optional[Request]:
        if not self.waiting:
            return None
        pinned_pids = set(self.pinned)
        key = lambda r: self.policy.priority_key(r, now, pinned_pids,
                                                 self.attained_service)
        return min(self.waiting, key=key)

    def queue_backlog(self) -> list[tuple[Request, int]]:
        """``(request, uncovered prefill tokens)`` for every waiting
        request — the pin-aware residual that ``Engine.queue_eta`` prices
        per request (on top of the covered context)."""
        return [(r, max(r.prompt_len - self._pin_tokens(r), 0))
                for r in self.waiting]

    # ------------------------------------------------- cached-prefix sources
    def _pin_tokens(self, req: Request) -> int:
        e = self.pinned.get(req.program_id)
        return min(e.tokens, req.prompt_len) if e is not None else 0

    def _radix_tokens(self, req: Request) -> int:
        """Shared-prefix coverage from the radix index (read-only probe).
        Capped at prompt_len - 1: the final prompt token is always computed
        so the first output token has fresh logits (vLLM semantics)."""
        if self.prefix_index is None:
            return 0
        hashes = request_block_hashes(req, self.blocks.cfg.block_size)
        blocks = self.prefix_index.match_blocks(hashes)
        return min(blocks * self.blocks.cfg.block_size,
                   max(req.prompt_len - 1, 0))

    def _offload_tokens(self, req: Request, now: float = 0.0) -> int:
        """Tier-resident prefix tokens: only blocks still resident count
        (suffix blocks demoted-then-dropped shrink the usable prefix and
        the uncovered remainder is recomputed). Capped at prompt_len - 1
        like the pin/radix sources, so a reloaded request always has ≥1
        prefill token — the step that runs it is the step that pays its
        ``reload_seconds``."""
        entry = self.offload.lookup(req.program_id, now) \
            if self.offload else None
        return min(entry.tokens, max(req.prompt_len - 1, 0)) \
            if entry is not None else 0

    def _footprint_tokens(self, req: Request) -> int:
        """Token positions the admitted request's KV will occupy before
        decode growth takes over: the prompt, plus — for a request
        resuming after a mid-decode preemption — the tokens it already
        generated (decode growth only extends at *future* block
        boundaries, so under-charging here would let the pool overcommit
        by ``generated/block_size`` blocks per resumed request; the
        deficit used to surface as publication transferring more blocks
        into the shared pool than the request owned)."""
        return req.prompt_len + req.generated

    def _admit_need(self, req: Request, now: float = 0.0) -> int:
        """Blocks `admit` would reserve for `req` (for deadlock sizing).
        Mirrors admit()'s source selection exactly: an offload win charges
        the full prompt (the reloaded KV needs its blocks)."""
        pin_t = self._pin_tokens(req)
        radix_t = self._radix_tokens(req)
        off_t = self._offload_tokens(req, now)
        footprint = self._footprint_tokens(req)
        if pin_t >= max(radix_t, off_t) and pin_t > 0:
            need = self.blocks.blocks_for_tokens(footprint - pin_t)
            return max(0, need - self.blocks.cfg.state_blocks)
        if radix_t >= off_t and radix_t > 0:
            return self.blocks.blocks_for_tokens(footprint - radix_t)
        return self.blocks.blocks_for_tokens(footprint)

    def admit(self, req: Request, now: float) -> bool:
        """Try to place `req`'s KV footprint; True if admitted. Cached
        context can come from three sources, best coverage wins:

        - the program's own TTL pin (adopted; state blocks resident),
        - a cross-program radix match (shared blocks ref-acquired; only the
          uncovered suffix is charged),
        - an offload-tier entry (full blocks reserved, KV reloaded over the
          link — skips compute, pays ``reload_seconds``).
        """
        pin_t = self._pin_tokens(req)
        radix_t = self._radix_tokens(req)
        off_t = self._offload_tokens(req, now)
        if pin_t >= max(radix_t, off_t) and pin_t > 0:
            source, cached = "pin", pin_t
        elif radix_t >= off_t and radix_t > 0:
            source, cached = "radix", radix_t
        elif off_t > 0:
            source, cached = "offload", off_t
        else:
            source, cached = "none", 0
        node = None
        if source == "radix":
            # lock the matched path *before* sizing: the in-admit eviction
            # below must not shrink the coverage `need` is computed from
            hashes = request_block_hashes(req, self.blocks.cfg.block_size)
            blocks, node = self.prefix_index.acquire(hashes, now)
            cached = min(blocks * self.blocks.cfg.block_size,
                         max(req.prompt_len - 1, 0))
        # vLLM semantics: reserve prompt blocks at admission; decode growth
        # goes through extend() with preemption on pressure. An offloaded
        # prefix still needs its blocks — the KV is reloaded into them.
        # The footprint includes tokens a resumed request already
        # generated (see _footprint_tokens).
        charge = 0 if source == "offload" else cached
        need = self.blocks.blocks_for_tokens(
            self._footprint_tokens(req) - charge)
        if source == "pin":
            need = max(0, need - self.blocks.cfg.state_blocks)  # state resident
        if not self.blocks.can_allocate(need):
            # reclaim unreferenced shared-prefix cache before giving up
            deficit = need - (self.blocks.free - self.blocks.watermark_blocks)
            if self.prefix_index is None \
                    or self.prefix_index.evict(deficit) <= 0 \
                    or not self.blocks.can_allocate(need):
                if node is not None:
                    self.prefix_index.release(node)
                return False
        # commit
        if source == "pin":
            self.blocks.adopt_pin(req.program_id, req.request_id)
            entry = self.pinned.pop(req.program_id)
            req.prefix_node = entry.prefix_node    # adopt the radix lock too
            self.stats.ttl_hits += 1
            req.served_from_pin = True
            req.cached_prefix = cached
            req.reload_seconds = 0.0
        elif source == "radix":
            req.prefix_node = node
            req.served_from_shared = True
            req.cached_prefix = cached
            req.reload_seconds = 0.0
            self.stats.prefix_hits += 1
            self.stats.prefix_hit_tokens += req.cached_prefix
        elif source == "offload":
            # reloaded prefix skips prefill compute but pays link time:
            # begin_reload commits the H2D (and SSD→DRAM) transfers on the
            # timeline and consumes the tier entry
            req.reload_seconds = self.offload.begin_reload(
                req.program_id, now) or 0.0
            req.cached_prefix = cached
            self.stats.offload_reloads += 1
            self.stats.reload_seconds += req.reload_seconds
            self.stats.reload_tokens += cached
            self._log("reload", req.program_id,
                      round(req.reload_seconds, 9), cached)
            if self.on_reload is not None:
                # the usable prefix (`cached`) truncates the physical
                # restore — suffix blocks the store dropped are recomputed
                self.on_reload(req.program_id, cached)
        else:
            # full recompute: clear any reload debt left from an earlier
            # offload admission of this (since preempted) request
            req.reload_seconds = 0.0
            if req.turn_idx > 0:
                self.stats.full_recomputes += 1
                self.stats.recompute_tokens += req.prompt_len
                if self.recompute_estimate_fn is not None:
                    self.stats.recompute_seconds += \
                        self.recompute_estimate_fn(req.prompt_len)
        if need:
            self.blocks.allocate(req.request_id, need)
        self._log("admit", req.program_id, req.turn_idx, source, cached)
        self.waiting.remove(req)
        req.state = RequestState.RUNNING
        drift = self.obs.drift if self.obs is not None else None
        if drift is not None and not drift._pending:
            # nothing staged -> every realize/drop below is a no-op; skip
            # them so policies that never solve (and the overhead gate's
            # solve-free workload) pay one dict truthiness test, not
            # three tuple-hash pops per admission
            drift = None
        if drift is not None:
            # reload-ETA peek vs commit: the solve priced prefill_reload
            # from a TransferEngine peek; an offload admission just
            # committed the real thing. Any other source means the
            # predicted reload never ran — no ground truth, drop it.
            if source == "offload":
                drift.realize("prefill_reload", req.program_id, now,
                              req.reload_seconds)
            else:
                drift.drop("prefill_reload", req.program_id)
        if req.first_schedule_time < 0:
            req.first_schedule_time = now
            req.queueing_delay = now - req.arrival_time
            # feed T̄: queueing delay of requests whose KV was NOT retained
            if not req.served_from_pin and req.turn_idx > 0:
                self.handler.ttl_model.observe_queueing_delay(req.queueing_delay)
            if drift is not None:
                if req.served_from_pin or req.turn_idx == 0:
                    # a pin hit skipped the queue the estimate priced
                    drift.drop("queue_eta", req.program_id)
                else:
                    drift.realize("queue_eta", req.program_id, now,
                                  req.queueing_delay)
                drift.realize("placement_cost", req.program_id, now,
                              req.queueing_delay + req.reload_seconds)
        return True

    # --------------------------------------------------- shared-prefix hooks
    def insert_prefix(self, req: Request, now: float) -> None:
        """Called by the engine when `req`'s prefill completes: publish the
        prompt into the radix index. Newly inserted blocks move from the
        request's allocation into the shared pool; blocks another request
        published first are freed as duplicates."""
        idx = self.prefix_index
        if idx is None:
            return
        hashes = request_block_hashes(req, self.blocks.cfg.block_size)
        if not hashes:
            return
        held_blocks = 0
        if req.prefix_node is not None:
            held_blocks = req.prefix_node.depth_blocks()
        new, dup, node = idx.insert(hashes, req.prefix_node, held_blocks, now)
        req.prefix_node = node
        if new:
            self.blocks.to_shared(req.request_id, new)
        if dup:
            self.blocks.free_duplicates(req.request_id, dup)

    def prefix_reclaim(self, need_blocks: int) -> int:
        """Evict unreferenced shared-prefix blocks (engine decode-OOM path:
        cheaper than preempting a running request)."""
        if self.prefix_index is None:
            return 0
        return self.prefix_index.evict(need_blocks)

    def free_victims(self, need_blocks: int, now: float) -> int:
        """Deadlock prevention (paper §5.2): unpin victims with the latest
        program arrival time until `need_blocks` fit."""
        freed = 0
        # latest program arrival first — approximated by latest pinned_at
        victims = sorted(self.pinned.values(), key=lambda e: -e.pinned_at)
        for v in victims:
            if self.blocks.can_allocate(need_blocks):
                break
            freed += self._unpin(v.program_id, reason="deadlock_victim",
                                 now=now)
            self.stats.deadlock_evictions += 1
        return freed

    # ------------------------------------------------------------- schedule
    def schedule(self, now: float, max_admits: int = 64,
                 admit_hook: Callable[[Request], None] | None = None) -> list[Request]:
        """Algorithm 1 Schedule(): admit from Q by priority until memory or
        queue is exhausted. Returns the admitted requests."""
        self.now = now
        self.unpin_expired(now)
        admitted: list[Request] = []
        while self.waiting and len(admitted) < max_admits:
            req = self.pick_next(now)
            if req is None:
                break
            if not self.admit(req, now):
                # deadlock prevention: free pinned victims, retry once
                need = self._admit_need(req, now)
                if self.pinned:
                    self.free_victims(need, now)
                    if self.admit(req, now):
                        admitted.append(req)
                        if admit_hook:
                            admit_hook(req)
                        continue
                break
            admitted.append(req)
            if admit_hook:
                admit_hook(req)
            # feed M̄ with this request's eventual footprint
            self.handler.ttl_model.observe_mem_usage(
                self.blocks.blocks_for_tokens(req.total_len))
        return admitted

    def note_service(self, program_id: str, seconds: float) -> None:
        """Autellix PLAS bookkeeping: attained service per program."""
        self.attained_service[program_id] = \
            self.attained_service.get(program_id, 0.0) + seconds
