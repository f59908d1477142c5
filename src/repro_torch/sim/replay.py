"""The torch leg of the differential logical-vs-physical replay.

The same seeded trace runs through the unchanged engine twice: once on
the accounting-only ``SimBackend`` (logical) and once on the port's
physical stack, a :class:`~repro_torch.serving.backend.TorchModelBackend`
over a :class:`~repro_torch.serving.paged_runtime.PagedKVRuntime`, wrapped
in a :class:`ShadowClockBackend` that executes the real model but reports
the analytic cost model's duration — so both legs share one virtual clock
and must make identical scheduling decisions. During the physical leg
every restore is round-tripped through the gather kernel and every COW
split is compared with its source page (``verify_staging`` /
``verify_copies``).

The workload specs, :class:`ReplayConfig`, :func:`seeded_programs`,
:class:`ShadowClockBackend` and :func:`_first_divergence` are copies of
the JAX package's ``repro.sim.replay``, so a logical leg run there and a
physical leg run here (in one interpreter: block hashing uses Python's
``hash``) replay the same trace under the same configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.core.ttl import TTLConfig
from repro_torch.core.types import Program, Turn
from repro_torch.serving.engine import Engine, EngineConfig, SimBackend
from repro_torch.serving.offload import OffloadConfig
from repro_torch.serving.prefix import PrefixConfig
from repro_torch.serving.profiler import (CostModel, HardwareProfile,
                                          build_profile)
from repro_torch.serving.router import Router
from repro_torch.sim.runner import Simulator
from repro_torch.sim.workload import WorkloadSpec, generate_programs

#: CPU-fast workload statistically shaped like SWE-Bench but sized for the
#: smoke models (short contexts, tiny outputs): real-model replay stays in
#: seconds, while still producing TTL pins/expiries, demotions, reloads,
#: preemptions and shared-prefix (COW) admissions.
SMOKE_SPEC = WorkloadSpec(
    name="replay-smoke",
    mean_turns=3.0, std_turns=0.8,
    tool_mean_s=0.6, tool_std_s=0.8,
    tokens_mean=300, tokens_std=60,
    output_frac=0.05, max_context=448,
    tools=(("ls", 0.4, 0.15, 0.5), ("pytest", 0.3, 1.2, 0.8),
           ("web", 0.3, 0.4, 1.0)),
    min_turn_tokens=48, min_output_tokens=3, min_new_tokens=24,
)

#: Decode-heavy variant: most of each turn's tokens are *generated*, so
#: engine steps carry large decode batches and small prefill chunks —
#: the trace that exercises the fused ``decode_batch`` path (ragged
#: tables, COW splits mid-batch) through the differential gate.
SMOKE_DECODE_SPEC = WorkloadSpec(
    name="replay-decode-heavy",
    mean_turns=2.0, std_turns=0.6,
    tool_mean_s=0.6, tool_std_s=0.8,
    tokens_mean=220, tokens_std=50,
    output_frac=0.55, max_context=448,
    tools=(("ls", 0.4, 0.15, 0.5), ("pytest", 0.3, 1.2, 0.8),
           ("web", 0.3, 0.4, 1.0)),
    min_turn_tokens=48, min_output_tokens=24, min_new_tokens=24,
)

#: ``--workload`` registry of the differential gate.
WORKLOAD_SPECS = {"smoke": SMOKE_SPEC, "decode-heavy": SMOKE_DECODE_SPEC}


@dataclasses.dataclass
class ReplayConfig:
    """One differential scenario: engine + tier sizing (identical for the
    logical and physical runs) and the smoke model to execute."""
    arch: str = "qwen2-1.5b"
    policy: str = "continuum"
    block_size: int = 16
    chunk_size: int = 128
    max_batch: int = 8
    total_blocks: int = 112           # engine HBM pool (floors at 64)
    dram_blocks: int = 40             # offload DRAM tier, in engine blocks
    ssd_blocks: int = 16              # small on purpose: forces suffix drops
    h2d_bw_blocks: float = 400.0      # tier bandwidths in blocks/s
    ssd_bw_blocks: float = 80.0
    share_ratio: float = 0.25         # cross-program preamble (COW path)
    max_ttl: float = 1.5              # short TTLs: expiry/demote happen
    max_seconds: float = 3600.0
    max_len: int = 512                # backend stream/page horizon
    # deliberately slow virtual chip: smoke-model steps then take real
    # virtual time, queueing delays become positive, and the TTL solver
    # actually chooses to pin (T-bar > 0) — without this every retention
    # decision degenerates to "don't" and the pin/expiry/deadlock paths
    # go unexercised
    hw_flops: float = 1e8
    hw_hbm_bw: float = 2e7

    def hardware(self) -> HardwareProfile:
        return HardwareProfile(flops=self.hw_flops, hbm_bw=self.hw_hbm_bw)

    def engine_config(self, block_bytes: float) -> EngineConfig:
        return EngineConfig(
            policy=self.policy, max_batch=self.max_batch,
            chunk_size=self.chunk_size, block_size=self.block_size,
            kv_budget_bytes=self.total_blocks * block_bytes,
            offload=OffloadConfig(
                dram_bytes=self.dram_blocks * block_bytes,
                ssd_bytes=self.ssd_blocks * block_bytes,
                h2d_bw=self.h2d_bw_blocks * block_bytes,
                ssd_bw=self.ssd_bw_blocks * block_bytes),
            prefix=PrefixConfig(),
            ttl=TTLConfig(cold_start_k=4, max_ttl=self.max_ttl,
                          exp_unit_mean=0.3))


def seeded_programs(seed: int, n: int = 6, rate_jps: float = 3.0,
                    spec: WorkloadSpec = SMOKE_SPEC,
                    share_ratio: float = 0.25,
                    twins: bool = True) -> list[Program]:
    """Seeded smoke workload. With ``twins``, a deterministic pair of
    programs running the *same agent template* is appended: their whole
    first-turn prompt (160 tokens, a multiple of the block size) comes
    from one shared stream, so the second twin's admission radix-matches
    the full prompt, is capped at ``prompt_len - 1``, and adopts
    mid-page — the guaranteed copy-on-write split the differential
    harness must see verified."""
    progs = generate_programs(spec, n=n, rate_jps=rate_jps, seed=seed,
                              share_ratio=share_ratio, prefix_groups=1)
    if twins:
        tmpl = f"{spec.name}/twin-{seed}"
        # twin1 arrives well after twin0's first prefill completed and
        # published, so its admission full-prompt radix-matches
        for j, t0 in ((0, 0.25), (1, 2.6)):
            progs.append(Program(
                program_id=f"{spec.name}-twin{j}-{seed}",
                arrival_time=t0,
                turns=[Turn(new_tokens=160, output_tokens=3, tool="ls",
                            tool_duration=0.3,
                            output_text="```bash\nls twin\n```"),
                       Turn(new_tokens=48, output_tokens=3, tool=None,
                            tool_duration=0.0, output_text="Final answer.")],
                shared_prefix_tokens=160, shared_prefix_id=tmpl))
    return progs


class ShadowClockBackend:
    """Physical execution on the logical clock: runs the real backend for
    its side effects (pages, staging, COW), reports the analytic cost
    model's step duration — so the logical and physical engines see
    identical virtual time and must make identical decisions. Every
    step's measured wall duration is kept next to its composition
    (:class:`~repro_torch.serving.profiler.StepSample`)."""

    def __init__(self, inner, cost: CostModel):
        self.inner = inner
        self.cost = cost
        self._cost_backend = SimBackend(cost)
        self.samples: list = []          # StepSample per executed step

    def execute(self, prefill, decode) -> float:
        from repro_torch.serving.profiler import StepSample
        measured = self.inner.execute(prefill, decode)
        analytic = self._cost_backend.execute(prefill, decode)
        d_ctx = (sum(r.prompt_len + r.generated for r in decode)
                 // len(decode)) if decode else 0
        self.samples.append(StepSample(
            measured_s=measured,
            prefill_tokens=sum(w.chunk for w in prefill),
            prefill_context=max((w.context for w in prefill), default=0),
            decode_batch=len(decode), decode_avg_context=d_ctx))
        return analytic

    def calibrate(self, **kw):
        """HardwareProfile with mfu/decode_eff fitted to the recorded
        measured-vs-analytic step gap."""
        from repro_torch.serving.profiler import calibrate_hardware
        return calibrate_hardware(self.samples, self.cost.prof,
                                  self.cost.hw, **kw)

    def __getattr__(self, name):    # hooks + runtime resolve on the inner
        return getattr(self.inner, name)


def _clone_programs(programs: list[Program]) -> list[Program]:
    """Fresh Program/Turn objects per run."""
    return [Program(p.program_id, p.arrival_time,
                    [dataclasses.replace(t) for t in p.turns],
                    shared_prefix_tokens=p.shared_prefix_tokens,
                    shared_prefix_id=p.shared_prefix_id)
            for p in programs]


def run_engine(programs: list[Program], rc: ReplayConfig, device="cuda",
               *, physical: bool = True, cfg=None,
               hw: HardwareProfile | None = None, model=None,
               on_step=None) -> tuple[list, Engine]:
    """One replay leg. The physical leg runs ``programs`` through an
    ``Engine`` whose backend is a shadow-clocked ``TorchModelBackend`` on
    ``device`` with ``verify_copies`` and ``verify_staging`` on;
    ``physical=False`` is the logical leg on ``SimBackend``. ``cfg``
    defaults to the smoke config of ``rc.arch``, ``hw`` to
    ``rc.hardware()``; ``model`` reuses already-built weights;
    ``on_step(engine, events, now)`` runs after every engine step (the
    fuzz suites check invariants there). Returns (decision log, engine);
    the log holds ``{"now": t, "events": [decision tuples]}`` for every
    engine step that made a decision."""
    cfg = cfg if cfg is not None else get_config(rc.arch, smoke=True)
    prof = build_profile(cfg, 1)
    hw = hw if hw is not None else rc.hardware()
    cost = CostModel(prof, hw)
    block_bytes = rc.block_size * prof.kv_bytes_per_token
    backend = None
    if physical:
        from repro_torch.serving.backend import TorchModelBackend
        inner = TorchModelBackend(cfg, model=model, seed=0,
                                  max_len=rc.max_len,
                                  page_size=rc.block_size, device=device)
        inner.runtime.verify_copies = True
        inner.verify_staging = True
        backend = ShadowClockBackend(inner, cost)
    eng = Engine(cfg, rc.engine_config(block_bytes), hw, backend=backend,
                 cost=cost)
    log: list = []

    def _capture(e, ev, now):
        if ev.decisions:
            log.append({"now": round(now, 9),
                        "events": [tuple(d) for d in ev.decisions]})
        if on_step is not None:
            on_step(e, ev, now)

    programs = _clone_programs(programs)
    router = Router([eng])
    router.register_programs(programs)
    sim = Simulator([eng], router, max_seconds=rc.max_seconds,
                    on_step=_capture)
    sim.add_programs(programs)
    sim.run()
    return log, eng


def _first_divergence(log_a: list, log_b: list) -> Optional[dict]:
    for i, (ra, rb) in enumerate(zip(log_a, log_b)):
        if ra != rb:
            return {"step": i, "now": ra["now"], "logical": ra["events"],
                    "physical": rb["events"]}
    if len(log_a) != len(log_b):
        i = min(len(log_a), len(log_b))
        longer = log_a[i] if len(log_a) > len(log_b) else log_b[i]
        return {"step": i, "now": longer["now"],
                "logical": log_a[i]["events"] if i < len(log_a) else None,
                "physical": log_b[i]["events"] if i < len(log_b) else None}
    return None
