"""Continuous-batching serving engine with chunked prefill and TTL pinning.

One engine == one model replica (one pod/slice). Each ``step(now)`` is one
engine iteration (Sarathi/vLLM-style): a token budget of chunked prefill
plus one decode token for every running sequence. The scheduler (Algorithm
1) decides admission order and KV retention; the execution backend supplies
the step duration (virtual-clock cost model here, real JAX/TPU execution in
``backend.JaxModelBackend``).

With ``EngineConfig.prefix`` set, the engine carries a per-replica
shared-prefix radix index (:mod:`repro_torch.serving.prefix`): finished prefills
are published into it, admissions match against it, and decode-time memory
pressure reclaims unreferenced cache before preempting anyone.

Backends carrying a :class:`~repro_torch.serving.paged_runtime.PagedKVRuntime`
are driven physically: the engine sizes the page pool against its block
pool, demote/reload hooks stage pages out/in through the ``page_copy``
staging buffers (one bulk transfer per tier move), preemption takes the
same demotion path, and radix-served admissions adopt shared physical
pages (copy-on-write). Every scheduling decision is appended to
``StepEvents.decisions`` — the differential replay harness
(:mod:`repro_torch.sim.replay`) compares these streams between the logical and
physical stacks.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Protocol

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policies import make_policy
from repro_torch.core.scheduler import Scheduler, materialized_tokens
from repro_torch.core.tool_handler import ToolCallHandler
from repro_torch.core.ttl import TTLConfig, TTLModel
from repro_torch.core.types import ProgramStats, Request, RequestState
from repro_torch.serving.blocks import BlockConfig, BlockManager
from repro_torch.serving.offload import OffloadConfig, OffloadManager
from repro_torch.serving.prefix import (PrefixConfig, RadixPrefixIndex,
                                  request_block_hashes)
from repro_torch.serving.profiler import (CostModel, HardwareProfile,
                                    ModelServingProfile, build_profile,
                                    make_prefill_reload_fn)


@dataclasses.dataclass
class PrefillWork:
    req: Request
    chunk: int
    context: int            # tokens already in place before this chunk


class ExecutionBackend(Protocol):
    def execute(self, prefill: list[PrefillWork], decode: list[Request]) -> float:
        """Run one engine step; returns its duration in seconds."""


class SimBackend:
    """Virtual-clock backend: step durations from the analytic cost model."""

    def __init__(self, cost: CostModel):
        self.cost = cost

    def execute(self, prefill: list[PrefillWork], decode: list[Request]) -> float:
        p_tokens = sum(w.chunk for w in prefill)
        p_ctx = max((w.context for w in prefill), default=0)
        d_ctx = (sum(r.prompt_len + r.generated for r in decode) // len(decode)
                 if decode else 0)
        return self.cost.step_seconds(p_tokens, p_ctx, len(decode), d_ctx)


@dataclasses.dataclass
class EngineConfig:
    policy: str = "continuum"
    max_batch: int = 256                 # max concurrently running sequences
    chunk_size: int = 2048               # prefill token budget per step
    block_size: int = 16
    kv_budget_bytes: float = 0.0         # 0 = derive from HBM minus params
    chips: int = 1
    offload: Optional[OffloadConfig] = None
    prefix: Optional[PrefixConfig] = None  # cross-program shared-prefix KV
    ttl: TTLConfig = dataclasses.field(default_factory=TTLConfig)
    scheduler_overhead_s: float = 0.0    # per-step overhead (Table 4)
    # "analytic": config-derived param counts (paper baseline).
    # "roofline": calibrate the cost model from compiled HLO
    #             (CostModel.from_roofline) — TTL's PrefillReload then uses
    #             measured prefill-recompute seconds.
    cost_source: str = "analytic"


@dataclasses.dataclass
class StepEvents:
    duration: float = 0.0
    finished: list = dataclasses.field(default_factory=list)
    tool_started: list = dataclasses.field(default_factory=list)  # (req, tool)
    admitted: list = dataclasses.field(default_factory=list)
    idle: bool = False
    # scheduling decisions made during this step, in order (admit source,
    # pin/unpin, demote/evict, reload, preempt) — the differential replay
    # harness compares these streams between logical and physical runs
    decisions: list = dataclasses.field(default_factory=list)


class Engine:
    def __init__(self, arch: ModelConfig, ecfg: EngineConfig,
                 hw: HardwareProfile = HardwareProfile(),
                 backend: ExecutionBackend | None = None,
                 cost: CostModel | None = None,
                 engine_id: str = "engine0"):
        self.arch = arch
        self.ecfg = ecfg
        self.hw = hw
        self.engine_id = engine_id
        # fleet role: "decode" serves full programs; "prefill" replicas
        # (disaggregated fleet) only run first-turn/cold prefills and hand
        # the finished KV to a decode replica before the tool returns
        self.role = "decode"
        if cost is not None:            # pre-calibrated, shared across replicas
            self.cost = cost
            self.profile = cost.prof
        elif ecfg.cost_source == "roofline":
            self.cost = CostModel.from_roofline(arch, hw=hw, chips=ecfg.chips)
            self.profile = self.cost.prof
        else:
            self.profile = build_profile(arch, ecfg.chips)
            self.cost = CostModel(self.profile, hw)
        self.backend = backend or SimBackend(self.cost)

        # --- KV block pool sizing ---
        kv_budget = ecfg.kv_budget_bytes or max(
            hw.hbm_bytes * ecfg.chips * 0.9 - self.profile.param_bytes, 1e9)
        kvpt = self.profile.kv_bytes_per_token
        if kvpt > 0:
            block_bytes = ecfg.block_size * kvpt
            state_blocks = math.ceil(self.profile.state_bytes / block_bytes) \
                if self.profile.state_bytes else 0
        else:  # pure SSM: fixed state per sequence is the unit
            block_bytes = max(self.profile.state_bytes, 1.0)
            state_blocks = 1
        total_blocks = max(int(kv_budget / block_bytes), 64)
        self.blocks = BlockManager(BlockConfig(total_blocks, ecfg.block_size,
                                               state_blocks=state_blocks))
        self.block_bytes = block_bytes

        # --- offload tiers (tiered kvstore behind the legacy facade) ---
        self.offload = None
        self.kvstore = None
        if ecfg.offload:
            # store accounting blocks match the engine's KV blocks
            ocfg = dataclasses.replace(ecfg.offload,
                                       block_bytes=self.block_bytes)
            self.offload = OffloadManager(ocfg)
            self.kvstore = self.offload.store

        # --- cross-program shared-prefix index (radix over block hashes) ---
        self.prefix_index: Optional[RadixPrefixIndex] = None
        if ecfg.prefix is not None and ecfg.prefix.enabled \
                and self.profile.kv_bytes_per_token > 0:   # SSM state: no
            pcfg = dataclasses.replace(ecfg.prefix,        # prefix sharing
                                       block_size=ecfg.block_size)
            self.prefix_index = RadixPrefixIndex(pcfg, self.blocks)

        # --- TTL model + tool handler (profiler-backed PrefillReload) ---
        # reload seconds come from live TransferEngine state (queues +
        # in-flight writes), not a static nbytes/bw formula
        self.clock = 0.0
        coef = self.cost.fit_prefill_quadratic(arch.max_seq_len)
        reload_fn = make_prefill_reload_fn(
            self.cost, coef, store=self.kvstore, clock=lambda: self.clock)
        handler = ToolCallHandler(TTLModel(ecfg.ttl), prefill_reload_fn=reload_fn)
        self.prefill_coef = coef

        policy = make_policy(ecfg.policy)
        self.scheduler = Scheduler(policy, handler, self.blocks, self.offload,
                                   prefix_index=self.prefix_index)
        self.scheduler._kv_bytes_per_token = kvpt if kvpt > 0 else block_bytes
        self.scheduler.recompute_estimate_fn = \
            lambda tokens: CostModel.quadratic_prefill_seconds(coef, tokens)
        if hasattr(self.backend, "drop_program"):
            self.scheduler.on_evict = self.backend.drop_program
        if self.kvstore is not None:
            # real backends keep a host copy on demotion and restore it on
            # reload; eviction remains a genuine loss
            if hasattr(self.backend, "offload_program"):
                self.scheduler.on_demote = self.backend.offload_program
            if hasattr(self.backend, "restore_program"):
                self.scheduler.on_reload = self.backend.restore_program
            if hasattr(self.backend, "drop_host_copy"):
                # pressure victims the store evicts (LRU drop with no SSD
                # room) must release the backend's host copy too — the
                # scheduler only sees the program it is currently freeing
                self.kvstore.on_drop = self.backend.drop_host_copy

        # --- physical page runtime (paged backends) ---
        # a backend carrying a PagedKVRuntime gets it sized 1:1 with the
        # accounting block pool (admission control then bounds physical
        # pages too) and, with prefix sharing on, a page-stamped radix
        # mirror so scheduler radix admissions become shared physical
        # pages (COW) instead of recomputed ones
        runtime = getattr(self.backend, "runtime", None)
        if runtime is not None:
            if runtime.page_size != ecfg.block_size:
                raise ValueError(
                    f"backend page_size {runtime.page_size} != engine "
                    f"block_size {ecfg.block_size}: physical pages and "
                    f"accounting blocks must be the same granularity")
            # headroom beyond the accounting pool: a batched decode step
            # may COW-split one shared append page per batch member
            # before any accounting-side eviction can run
            runtime.grow(self.blocks.total + max(16, ecfg.max_batch))
            if self.prefix_index is not None \
                    and hasattr(self.backend, "enable_prefix_sharing"):
                self.backend.enable_prefix_sharing()

        # accounting-index radix evictions propagate to the backend's
        # page-stamped mirror (same hash chain, same keep depth), so the
        # two trees cannot drift: without this the mirror frees pages only
        # under physical page pressure, and its LRU may pick *different*
        # victims than accounting did — paths the scheduler still serves
        # then materialize as shortfall_tokens defensive recomputes
        if self.prefix_index is not None \
                and hasattr(self.backend, "drop_prefix_chain"):
            backend = self.backend
            self.prefix_index.on_evict_node = (
                lambda node: backend.drop_prefix_chain(
                    node.path_hashes(),
                    node.depth_blocks() - node.n_blocks))

        # cluster serving hooks: pre hooks run before admission (peer-link
        # pump), post hooks after every step() call including idle ones
        # (conservation checks) — both on the externally-driven clock
        self.pre_step_hooks: list[Callable] = []    # fn(engine, now)
        self.post_step_hooks: list[Callable] = []   # fn(engine, events, now)

        self.running: list[Request] = []
        self.programs: dict[str, ProgramStats] = {}
        self.steps = 0
        self.busy_seconds = 0.0
        self.tokens_prefilled = 0
        self.tokens_decoded = 0
        self.rejected = 0
        # telemetry plane (attach_telemetry); None = every emission site
        # short-circuits on one attribute test
        self.obs = None
        # live StepSamples kept only while the drift watchdog is on —
        # its step_seconds recalibrator re-fits HardwareProfile from them
        self.drift_samples: list = []

    def attach_telemetry(self, tel) -> None:
        """Wire this replica into a shared :class:`repro_torch.obs.Telemetry`:
        scheduler decisions, TTL solves, tiered-store moves, transfer
        channels, the paged runtime, and this engine's gauges all report
        into it. Call after construction (and, in a cluster, after peer
        channels are attached so the NIC lanes are wired too)."""
        tel.attach_engine(self)

    # ------------------------------------------------------------------ API
    def submit(self, req: Request, now: float) -> None:
        ps = self.programs.get(req.program_id)
        if ps is None:
            ps = ProgramStats(req.program_id, req.program_arrival_time)
            self.programs[req.program_id] = ps
        ps.num_turns = max(ps.num_turns, req.turn_idx + 1)
        # fail fast on requests that can never fit (real engines 4xx these)
        need = self.blocks.blocks_for_tokens(req.total_len)
        if need > self.blocks.total * (1 - self.blocks.cfg.watermark):
            req.state = RequestState.FINISHED
            req.finish_time = now
            ps.finish_time = now
            self.rejected += 1
            if self.obs is not None:
                self.obs.program_end(req.program_id, now, mark="rejected")
            return
        if self.obs is not None:
            # opening the queued span also closes a prior tool_pause span
            self.obs.program_phase(req.program_id, "queued", now,
                                   args={"turn": req.turn_idx,
                                         "replica": self.engine_id})
        self.scheduler.on_request_arrive(req, now)

    @property
    def has_work(self) -> bool:
        return bool(self.running or self.scheduler.waiting)

    def load(self) -> float:
        """Routing signal: running + waiting footprint."""
        return len(self.running) + len(self.scheduler.waiting)

    def queue_eta(self, now: float) -> float:
        """Routing/TTL signal: rough seconds until a *new* arrival would
        reach the head of this replica's queue — the outstanding prefill
        of running + waiting requests plus the decode backlog of BOTH,
        priced by the analytic cost model. Each residual prefill is priced
        per request at its own cached context: chunked prefill resumes
        every residual from where it stopped, and the quadratic attention
        term telescopes so per-chunk costs sum to one call at that
        context. Lumping all residuals into a single ``prefill_seconds``
        call (the old formula) charges the quadratic term on the fleet's
        *total*, overestimating replicas that hold many small residuals —
        which biased the TTL solver toward over-pinning and steered the
        router away from mildly busy replicas. Deterministic,
        side-effect free; the cluster router folds it into placement and
        the TTL model uses it as the per-replica out-of-order delay
        (``TTLModel.solve(queue_eta=...)``)."""
        pre_s = 0.0
        dec = 0
        ctxs = []
        for r in self.running:
            if not r.done_prefill():
                pre_s += self.cost.prefill_seconds(
                    r.prompt_len - r.prefill_pos, r.prefill_pos)
            dec += max(r.output_len - r.generated, 0)
            ctxs.append(r.prompt_len + r.generated)
        # waiting requests admit against their TTL pins: price only the
        # uncovered suffix on top of the covered context (a queue of
        # pinned returners is nearly free, and overestimating it would
        # trigger pointless migrations) — but their decode backlog queues
        # behind the running batch all the same
        for r, resid in self.scheduler.queue_backlog():
            if resid > 0:
                pre_s += self.cost.prefill_seconds(
                    resid, r.prompt_len - resid)
            dec += max(r.output_len - r.generated, 0)
            ctxs.append(r.prompt_len + r.generated)
        if pre_s <= 0 and dec <= 0:
            return 0.0
        batch = min(max(len(ctxs), 1), self.ecfg.max_batch)
        avg_ctx = int(sum(ctxs) / len(ctxs)) if ctxs else 0
        steps = dec / batch
        return pre_s + steps * self.cost.decode_step_seconds(batch, avg_ctx)

    def est_step_seconds(self) -> float:
        """Analytic duration of the replica's NEXT step (chunk-budget
        capped prefill + current decode batch). The router uses this to
        price reload-stall collateral: a reload stalls co-scheduled
        requests only for the part that exceeds the step they were going
        to run anyway."""
        budget = self.ecfg.chunk_size
        p_tok = 0
        p_ctx = 0
        n_dec = 0
        d_ctx = 0
        for r in self.running:
            if not r.done_prefill():
                if budget > 0:
                    chunk = min(budget, r.prompt_len - r.prefill_pos)
                    budget -= chunk
                    p_tok += chunk
                    p_ctx = max(p_ctx, r.prefill_pos)
            elif not r.done():
                n_dec += 1
                d_ctx += r.prompt_len + r.generated
        if p_tok == 0 and n_dec == 0:
            return 0.0
        d_avg = int(d_ctx / n_dec) if n_dec else 0
        return self.cost.step_seconds(p_tok, p_ctx, n_dec, d_avg)

    # ----------------------------------------------------------------- step
    def step(self, now: float) -> StepEvents:
        ev = StepEvents()
        self.clock = now            # anchors TransferEngine-based pricing
        self.scheduler.decision_sink = ev.decisions
        self.scheduler.now = now    # timestamps decisions made mid-step
        for hook in self.pre_step_hooks:
            hook(self, now)
        # drift watchdog: the router prices collateral off
        # est_step_seconds(), an estimate of the CURRENT batch's next
        # step — snapshot it before admission changes the batch so the
        # realized pair below compares like with like
        drift = self.obs.drift if self.obs is not None else None
        est_step = self.est_step_seconds() if drift is not None else 0.0
        # 1. admission (Algorithm 1 Schedule())
        cap = self.ecfg.max_batch - len(self.running)
        if cap > 0:
            admitted = self.scheduler.schedule(now, max_admits=cap)
            for r in admitted:
                r.prefill_pos = r.cached_prefix
                self.running.append(r)
                if self.obs is not None:
                    # fully-cached prompts (pin adoption) skip prefill
                    self.obs.program_phase(
                        r.program_id,
                        "decode" if r.done_prefill() else "prefill", now,
                        args={"turn": r.turn_idx,
                              "cached": r.cached_prefix})
            ev.admitted = admitted

        if not self.running:
            ev.idle = True
            return self._finish_step(ev, now)

        # 2. compose the batch: chunked prefill + decode
        budget = self.ecfg.chunk_size
        prefill_work: list[PrefillWork] = []
        for r in self.running:
            if budget <= 0:
                break
            if not r.done_prefill():
                chunk = min(budget, r.prompt_len - r.prefill_pos)
                prefill_work.append(PrefillWork(r, chunk, r.prefill_pos))
                budget -= chunk

        decode_reqs = [r for r in self.running
                       if r.done_prefill() and not r.done()]

        # 3. decode block growth (+ preemption on OOM; unreferenced shared
        #    prefix cache is reclaimed first — cheaper than preempting)
        for r in list(decode_reqs):
            if r not in decode_reqs:    # preempted as an earlier r's victim
                continue
            pos = r.prompt_len + r.generated
            if pos % self.ecfg.block_size == 0 and self.profile.kv_bytes_per_token > 0:
                while not self.blocks.extend(r.request_id, 1):
                    if self.scheduler.prefix_reclaim(1) > 0:
                        continue
                    victim = self._pick_preemption_victim(exclude=r)
                    if victim is None:
                        break
                    self._preempt(victim, now)
                    if victim in decode_reqs:
                        decode_reqs.remove(victim)
                    # a mid-prefill victim must leave the batch too: its
                    # blocks are freed and its pages staged out/evicted —
                    # executing its stale chunk would advance a PREEMPTED
                    # request and re-create the entry the backend dropped
                    prefill_work = [w for w in prefill_work
                                    if w.req is not victim]

        # Reload stalls gate the whole step — every co-scheduled request
        # pays the slowest participant's reload (the router prices this
        # collateral). Charged on the FIRST step the request participates
        # in, prefill chunk or decode alike: a fully-cached admission (pin
        # adoption after a DRAM restore) goes straight to decode and must
        # still pay its stall. Cleared unconditionally so a stale value
        # never survives to be re-charged on a later turn.
        reload_penalty = 0.0
        for r in [w.req for w in prefill_work] + decode_reqs:
            if r.reload_seconds > 0:
                reload_penalty = max(reload_penalty, r.reload_seconds)
                r.reload_seconds = 0.0

        # 4. execute. Tier reloads are DMA transfers on their own channels,
        # so they overlap the step's compute; only the slower of the two
        # paces the step (LMCache-style async offload, paper §5.2).
        exec_s = self.backend.execute(prefill_work, decode_reqs)
        stall = max(0.0, reload_penalty - exec_s)
        dur = exec_s + stall + self.ecfg.scheduler_overhead_s
        ev.duration = dur
        self.busy_seconds += dur
        self.steps += 1
        if self.obs is not None:
            rid = self.engine_id
            p_tok = sum(w.chunk for w in prefill_work)
            args = {"prefill_tokens": p_tok, "decode": len(decode_reqs),
                    "running": len(self.running)}
            if stall > 0.0:
                # the reload-stall seconds this step added on top of its
                # compute — the attribution analyzer charges them to the
                # reloader (reload_stall) and incumbents (collateral)
                args["stall"] = round(stall, 9)
            self.obs.trace.complete(rid, "step", now, dur, cat="step",
                                    args=args)
            self.obs.step_seconds.observe(dur, (rid,))
            if drift is not None:
                if not ev.admitted:
                    # admission changed nothing: est_step priced exactly
                    # this batch — an honest predicted/realized pair
                    drift.observe("step_seconds", now, est_step, exec_s)
                if len(self.drift_samples) < 2048:
                    from repro_torch.serving.profiler import StepSample
                    d_ctx = (sum(r.prompt_len + r.generated
                                 for r in decode_reqs)
                             // len(decode_reqs)) if decode_reqs else 0
                    self.drift_samples.append(StepSample(
                        measured_s=exec_s, prefill_tokens=p_tok,
                        prefill_context=max(
                            (w.context for w in prefill_work), default=0),
                        decode_batch=len(decode_reqs),
                        decode_avg_context=d_ctx))
            if p_tok:
                self.obs.tokens.inc(p_tok, (rid, "prefill"))
            if decode_reqs:
                self.obs.tokens.inc(len(decode_reqs), (rid, "decode"))

        # 5. advance state
        total_tok = sum(w.chunk for w in prefill_work) + len(decode_reqs) or 1
        end = now + dur
        for w in prefill_work:
            w.req.prefill_pos += w.chunk
            self.tokens_prefilled += w.chunk
            if w.req.done_prefill():
                w.req.generated = max(w.req.generated, 1)  # prefill emits tok 1
                self.tokens_decoded += 1
                self._note_first_token(w.req, end)
                # publish the finished prompt into the shared-prefix index
                self.scheduler.insert_prefix(w.req, end)
                if self.obs is not None:
                    self.obs.program_phase(w.req.program_id, "decode", end)
            self.scheduler.note_service(
                w.req.program_id, dur * w.chunk / total_tok)
        for r in decode_reqs:
            r.generated += 1
            self.tokens_decoded += 1
            self._note_first_token(r, end)   # fully-cached prompts skip prefill
            self.scheduler.note_service(r.program_id, dur * 1 / total_tok)

        # 6. completions
        for r in list(self.running):
            if r.done_prefill() and r.done():
                self.running.remove(r)
                info = self.scheduler.on_request_finish(r, end)
                ev.finished.append(r)
                ps = self.programs[r.program_id]
                ps.total_queueing += r.queueing_delay
                if r.served_from_shared:
                    ps.prefix_hits += 1
                    ps.prefix_hit_tokens += r.cached_prefix
                if r.served_from_pin:
                    ps.ttl_hits += 1
                elif r.turn_idx > 0:
                    ps.ttl_misses += 1
                if r.is_last_turn or r.tool is None:
                    ps.finish_time = end
                    if self.obs is not None:
                        self.obs.program_end(r.program_id, end)
                        self.obs.programs_finished.inc(1.0, (self.engine_id,))
                        # tenant identity rides on the shared-prefix id
                        # (the skewed workload encodes tenants there);
                        # feeds the JCT histogram + per-tenant SLO burn
                        self.obs.note_jct(self.engine_id,
                                          r.shared_prefix_id or "default",
                                          ps.jct, end)
                else:
                    ev.tool_started.append((r, r.tool))
                    ps.total_tool_time += r.tool_duration
                    if self.obs is not None:
                        self.obs.program_phase(r.program_id, "tool_pause",
                                               end, args={"tool": r.tool})
        return self._finish_step(ev, now)

    def _finish_step(self, ev: StepEvents, now: float) -> StepEvents:
        """Run post-step hooks and detach the decision sink: once the
        step's events are handed out (and possibly serialized by a trace
        capture), between-step actors — the cluster router migrating or
        dropping KV at arrival time — must not mutate them. Cluster-level
        decisions are recorded in the cluster's own trace stream."""
        for hook in self.post_step_hooks:
            hook(self, ev, now)
        self.scheduler.decision_sink = None
        return ev

    def _note_first_token(self, r: Request, at: float) -> None:
        if r.first_token_time < 0:
            r.first_token_time = at
            ps = self.programs.get(r.program_id)
            if ps is not None:
                ps.total_ttft += at - r.arrival_time
            if self.obs is not None:
                self.obs.note_ttft(self.engine_id,
                                   r.shared_prefix_id or "default",
                                   at - r.arrival_time, at)

    # ------------------------------------------------------- routing signals
    def prefix_match_tokens(self, req: Request) -> int:
        """Prompt tokens of `req` this engine could serve from its shared-
        prefix index (the router's prefix-affinity score)."""
        if self.prefix_index is None:
            return 0
        hashes = request_block_hashes(req, self.ecfg.block_size)
        return self.prefix_index.match_blocks(hashes) * self.ecfg.block_size

    # ------------------------------------------------------------ preemption
    def _pick_preemption_victim(self, exclude: Request) -> Optional[Request]:
        cands = [r for r in self.running if r is not exclude]
        if not cands:
            return None
        pinned = set(self.scheduler.pinned)
        key = lambda r: self.scheduler.policy.priority_key(
            r, 0.0, pinned, self.scheduler.attained_service)
        return max(cands, key=key)   # lowest priority = largest key

    def _preempt(self, r: Request, now: float) -> None:
        self.blocks.free_request(r.request_id)
        self.scheduler._release_prefix(r)   # shared path stays cached; a
        # re-admission will radix-match the already-published prompt
        # same release protocol as finish/TTL expiry: a successful offload
        # demotes (the backend stages the pages out through page_copy and
        # keeps a host copy), otherwise the physical KV is genuinely
        # evicted. Credit only the MATERIALIZED tokens (the last sampled
        # token's KV was never appended).
        self.scheduler._log("preempt", r.program_id, r.turn_idx)
        self.scheduler.release_program(
            r.program_id, materialized_tokens(r), now, reason="preempt")
        r.state = RequestState.PREEMPTED
        r.prefill_pos = 0
        r.cached_prefix = 0
        r.served_from_pin = False    # the adopted/shared cache is gone; a
        r.served_from_shared = False  # re-admission earns its own hit flags
        r.preemptions += 1
        self.running.remove(r)
        self.scheduler.waiting.append(r)
        self.scheduler.stats.preemptions += 1
        if self.obs is not None:
            # back to the queue: its prefill/decode span ends here
            self.obs.program_phase(r.program_id, "queued", now,
                                   args={"turn": r.turn_idx,
                                         "preempted": True})
