"""Differential logical-vs-physical replay harness of the PyTorch port.

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

1. **Traces** — a seeded smoke workload is serialized to JSONL as
   submit / tool_pause / finish events (``record_trace`` /
   ``load_trace``, byte-identical for the same seed).
2. **Differential run** — :func:`run_differential`: the two legs' per-step
   decision logs must be identical, every restore and COW split
   bit-exact.
3. **Cluster mode** — :func:`run_cluster_trace` / :func:`run_cluster_replay`:
   the same trace through an N-replica cluster (optionally elastic, with
   disaggregated prefill replicas). With ``physical=True`` every replica
   is a shadow-clocked ``TorchModelBackend``; all of them share one
   ``Model`` and one token-stream seed, so a staged host copy that
   migrates to another replica is valid KV there and is restored through
   the scatter kernel. The physical cluster trace must be byte-identical
   to the logical one, with the conservation audit, ``Cluster.check``
   and the bit-exact staging checks holding after every step.
4. **Telemetry, regret and attribution demos** — the JAX package's
   logical legs, run on the port's copies of ``repro.obs``.

The workload specs, configurations and demos are those of the JAX
package's ``repro.sim.replay``, so a leg run there and one run here (in
one interpreter: block hashing uses Python's ``hash``) replay the same
trace under the same configuration. Physical legs run on ``device``,
``"cuda"`` by default; ``"cpu"`` runs the kernels' plain versions.

    PYTHONPATH=src python -m repro_torch.sim.replay --seeds 0 1 2
    PYTHONPATH=src python -m repro_torch.sim.replay --cluster --physical
    PYTHONPATH=src python -m repro_torch.sim.replay --device cpu --cluster \
        --autoscale --physical --seeds 0

Artifacts go to ``experiments/replay_torch/`` unless ``--out`` says
otherwise.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
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

#: CLI ``--workload`` registry for the differential gate.
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


# ---------------------------------------------------------------- trace io
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


def _turn_payload(t: Turn) -> dict:
    return {"new_tokens": t.new_tokens, "output_tokens": t.output_tokens,
            "tool": t.tool, "tool_duration": t.tool_duration,
            "output_text": t.output_text}


def record_trace(programs: list[Program], path) -> None:
    """Serialize a workload as replayable JSONL events: ``submit`` (turn 0
    at the program's arrival time), ``tool_pause`` (turn k arrives
    ``duration`` after turn k-1 finishes) and ``finish`` (the final turn).
    Keys are sorted and floats unrounded: the same programs always produce
    byte-identical files."""
    lines = []
    for p in programs:
        lines.append({"ev": "submit", "pid": p.program_id,
                      "t": p.arrival_time, "turn": 0,
                      "shared_prefix_tokens": p.shared_prefix_tokens,
                      "shared_prefix_id": p.shared_prefix_id,
                      **_turn_payload(p.turns[0])})
        for k in range(1, p.num_turns):
            prev = p.turns[k - 1]
            lines.append({"ev": "tool_pause", "pid": p.program_id,
                          "turn": k, "after_tool": prev.tool,
                          "duration": prev.tool_duration,
                          **_turn_payload(p.turns[k])})
        lines.append({"ev": "finish", "pid": p.program_id,
                      "turn": p.num_turns - 1})
    pathlib.Path(path).write_text(
        "\n".join(json.dumps(l, sort_keys=True) for l in lines) + "\n")


def load_trace(path) -> list[Program]:
    """Rebuild the Program list from a trace file."""
    progs: dict[str, Program] = {}
    for line in pathlib.Path(path).read_text().splitlines():
        d = json.loads(line)
        if d["ev"] == "finish":
            continue
        turn = Turn(new_tokens=d["new_tokens"],
                    output_tokens=d["output_tokens"], tool=d["tool"],
                    tool_duration=d["tool_duration"],
                    output_text=d["output_text"])
        if d["ev"] == "submit":
            progs[d["pid"]] = Program(
                program_id=d["pid"], arrival_time=d["t"], turns=[turn],
                shared_prefix_tokens=d.get("shared_prefix_tokens", 0),
                shared_prefix_id=d.get("shared_prefix_id"))
        else:                                   # tool_pause
            progs[d["pid"]].turns.append(turn)
    return list(progs.values())


# ----------------------------------------------------------- backends
class ShadowClockBackend:
    """Physical execution on the logical clock: runs the real backend for
    its side effects (pages, staging, COW), reports the analytic cost
    model's step duration — so the logical and physical engines see
    identical virtual time and must make identical decisions.

    Every step's *measured* wall duration is recorded next to its
    composition (:class:`~repro_torch.serving.profiler.StepSample`), so the
    measured-vs-analytic gap the shadow clock deliberately discards is
    not lost: :meth:`calibrate` fits ``HardwareProfile.mfu`` /
    ``decode_eff`` to it (``profiler.calibrate_hardware``), turning a
    replay run into the paper's <10-min offline profile for this host."""

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
        measured-vs-analytic step gap (see ROADMAP follow-up (d))."""
        from repro_torch.serving.profiler import calibrate_hardware
        return calibrate_hardware(self.samples, self.cost.prof,
                                  self.cost.hw, **kw)

    def __getattr__(self, name):    # hooks + runtime resolve on the inner
        return getattr(self.inner, name)


# ------------------------------------------------------------ differential
@dataclasses.dataclass
class DifferentialReport:
    matched: bool
    steps_logical: int
    steps_physical: int
    first_divergence: Optional[dict]
    staging_checks: int = 0
    staging_failures: int = 0
    cow_checks: int = 0
    cow_failures: int = 0
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.matched and self.staging_failures == 0 \
            and self.cow_failures == 0

    def describe(self) -> str:
        if self.ok:
            return (f"MATCH: {self.steps_physical} decision steps identical; "
                    f"{self.staging_checks} restores and {self.cow_checks} "
                    f"COW splits bit-exact "
                    f"(demotions={self.stats.get('demotions')}, "
                    f"reloads={self.stats.get('offload_reloads')}, "
                    f"preemptions={self.stats.get('preemptions')}, "
                    f"prefix_hits={self.stats.get('prefix_hits')})")
        out = ["DIVERGENCE:"]
        if not self.matched and self.first_divergence is not None:
            d = self.first_divergence
            out.append(f"  first differing step #{d['step']} "
                       f"(virtual t={d.get('now')}):")
            out.append(f"    logical : {d.get('logical')}")
            out.append(f"    physical: {d.get('physical')}")
        if self.staging_failures:
            out.append(f"  {self.staging_failures}/{self.staging_checks} "
                       f"restore round-trips NOT bit-exact")
        if self.cow_failures:
            out.append(f"  {self.cow_failures}/{self.cow_checks} "
                       f"COW splits NOT bit-exact")
        return "\n".join(out)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def _clone_programs(programs: list[Program]) -> list[Program]:
    """Fresh Program/Turn objects per run (requests mutate nothing on the
    Program, but isolation keeps the two runs honest)."""
    return [Program(p.program_id, p.arrival_time,
                    [dataclasses.replace(t) for t in p.turns],
                    shared_prefix_tokens=p.shared_prefix_tokens,
                    shared_prefix_id=p.shared_prefix_id)
            for p in programs]


def _physical_backend(cfg, rc: ReplayConfig, cost: CostModel, model,
                      device) -> ShadowClockBackend:
    """A shadow-clocked ``TorchModelBackend`` on ``device`` with every COW
    split and every restore verified bit-exact. ``model`` (None: seeded
    weights of its own) and the token-stream seed 0 are what make two
    backends' KV interchangeable: a host copy staged out on one is valid
    KV on another only when both hold the same weights and draw the same
    prompt ids."""
    from repro_torch.serving.backend import TorchModelBackend
    inner = TorchModelBackend(cfg, model=model, seed=0, max_len=rc.max_len,
                              page_size=rc.block_size, device=device)
    inner.runtime.verify_copies = True
    inner.verify_staging = True
    return ShadowClockBackend(inner, cost)


def run_engine(programs: list[Program], rc: ReplayConfig, device="cuda",
               *, physical: bool = True, cfg=None,
               hw: HardwareProfile | None = None, model=None,
               on_step=None, telemetry=None) -> tuple[list, Engine]:
    """One replay leg. The physical leg runs ``programs`` through an
    ``Engine`` whose backend is a shadow-clocked ``TorchModelBackend`` on
    ``device`` with ``verify_copies`` and ``verify_staging`` on;
    ``physical=False`` is the logical leg on ``SimBackend``. ``cfg``
    defaults to the smoke config of ``rc.arch``, ``hw`` to
    ``rc.hardware()``; ``model`` reuses already-built weights;
    ``on_step(engine, events, now)`` runs after every engine step (the
    fuzz suites check invariants there); ``telemetry`` (a
    :class:`~repro_torch.obs.Telemetry`) is attached to the engine, and
    through it to the paged runtime. Returns (decision log, engine); the
    log holds ``{"now": t, "events": [decision tuples]}`` for every
    engine step that made a decision."""
    cfg = cfg if cfg is not None else get_config(rc.arch, smoke=True)
    prof = build_profile(cfg, 1)
    hw = hw if hw is not None else rc.hardware()
    cost = CostModel(prof, hw)
    block_bytes = rc.block_size * prof.kv_bytes_per_token
    backend = _physical_backend(cfg, rc, cost, model, device) \
        if physical else None
    eng = Engine(cfg, rc.engine_config(block_bytes), hw,
                 backend=backend, cost=cost)
    if telemetry is not None:
        eng.attach_telemetry(telemetry)
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


def run_differential(programs: list[Program],
                     rc: ReplayConfig = ReplayConfig(), device="cuda", *,
                     cfg=None, hw: HardwareProfile | None = None,
                     model=None) -> DifferentialReport:
    """Execute `programs` through the logical and the physical stack (on
    ``device``) and compare decision streams + physical bit-exactness."""
    log_l, _ = run_engine(programs, rc, physical=False, cfg=cfg, hw=hw)
    log_p, eng_p = run_engine(programs, rc, device, cfg=cfg, hw=hw,
                              model=model)
    div = _first_divergence(log_l, log_p)
    backend = eng_p.backend.inner
    st = eng_p.scheduler.stats
    return DifferentialReport(
        matched=div is None,
        steps_logical=len(log_l), steps_physical=len(log_p),
        first_divergence=div,
        staging_checks=len(backend.staging_checks),
        staging_failures=sum(1 for _, ok in backend.staging_checks
                             if not ok),
        cow_checks=len(backend.runtime.copy_checks),
        cow_failures=sum(1 for ok in backend.runtime.copy_checks if not ok),
        stats={"demotions": st.demotions,
               "offload_reloads": st.offload_reloads,
               "preemptions": st.preemptions,
               "prefix_hits": st.prefix_hits,
               "ttl_hits": st.ttl_hits,
               "ttl_expiries": st.ttl_expiries,
               "cow_splits": backend.runtime.cow_splits,
               "restores": backend.restores,
               "demotions_physical": backend.demotions,
               "shortfall_tokens": backend.shortfall_tokens})


# ----------------------------------------------------------- cluster mode
@dataclasses.dataclass
class ClusterReplayReport:
    """Verdict of a cluster replay: the same seeded trace through an
    N-replica cluster must be (a) deterministic — two runs produce
    byte-identical cluster traces (per-step decision streams tagged with
    replica ids, interleaved with migration events) — and (b)
    conservative — at every step boundary no program's KV is
    double-resident across replicas/links or lost across a migration.
    A physical replay compares the logical run (A) with the physical run
    (B) instead, and its ``stats`` add the fleet's staging and COW checks,
    which must all hold."""
    deterministic: bool
    conservation_violations: int
    steps: int
    migrations: int
    first_divergence: Optional[dict]
    violation_examples: list = dataclasses.field(default_factory=list)
    stats: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return self.deterministic and self.conservation_violations == 0 \
            and self.stats.get("staging_failures", 0) == 0 \
            and self.stats.get("cow_failures", 0) == 0

    def describe(self) -> str:
        if self.ok:
            physical = "" if "staging_checks" not in self.stats else (
                f"; physical: {self.stats['staging_checks']} restores and "
                f"{self.stats['cow_checks']} COW splits bit-exact, "
                f"shortfall={self.stats['shortfall_tokens']}")
            return (f"MATCH: {self.steps} cluster steps byte-identical "
                    f"across runs; 0 conservation violations "
                    f"(migrations={self.migrations}, "
                    f"cold_rehomes={self.stats.get('cold_rehomes')}, "
                    f"reloads={self.stats.get('offload_reloads')})"
                    + physical)
        out = ["DIVERGENCE:"]
        if not self.deterministic and self.first_divergence is not None:
            d = self.first_divergence
            out.append(f"  first differing trace line #{d['line']}:")
            out.append(f"    run A: {d.get('a')}")
            out.append(f"    run B: {d.get('b')}")
        if self.conservation_violations:
            out.append(f"  {self.conservation_violations} conservation "
                       f"violations, e.g. {self.violation_examples[:3]}")
        for what in ("staging", "cow"):
            if self.stats.get(f"{what}_failures", 0):
                out.append(f"  {self.stats[f'{what}_failures']}/"
                           f"{self.stats[f'{what}_checks']} {what} checks "
                           f"NOT bit-exact")
        return "\n".join(out)

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


def cluster_programs(seed: int, n: int = 10,
                     rate_jps: float = 2.0) -> list[Program]:
    """Seeded skewed smoke workload for cluster replays: hot-tenant skew
    concentrates prefix affinity, tool storms synchronize returns, churn
    keeps re-homing live — all three migration triggers on a CPU-fast
    fleet."""
    from repro_torch.sim.workload import generate_skewed_programs
    return generate_skewed_programs(
        SMOKE_SPEC, n=n, rate_jps=rate_jps, seed=seed, tenants=3,
        tenant_skew=1.4, share_ratio=0.3, storm_frac=0.4,
        storm_gap_s=2.0, churn_frac=0.3, churn_scale=6.0)


def elastic_programs(seed: int, n: int = 16,
                     rate_jps: float = 2.0) -> list[Program]:
    """Seeded diurnal + bursty smoke workload for elastic replays: the
    arrival wave forces the scaling policy through at least one
    trough-peak-trough cycle, bursts test the hysteresis, and the
    skewed content (tenants/storms/churn) keeps migration live during
    drains."""
    from repro_torch.sim.workload import generate_diurnal_programs
    return generate_diurnal_programs(
        SMOKE_SPEC, n=n, rate_jps=rate_jps, seed=seed,
        period_s=40.0, peak_mult=5.0, burst_frac=0.25, burst_size=3,
        burst_span_s=0.5, tenants=3, tenant_skew=1.4, share_ratio=0.3,
        storm_frac=0.3, storm_gap_s=2.0, churn_frac=0.2, churn_scale=4.0)


def elastic_scaling_config():
    """The seeded elastic-replay policy: thresholds sized to the smoke
    hardware (CPU-slow chip, seconds-long steps), one-replica floor,
    short holds so the diurnal cycle triggers both directions."""
    from repro_torch.serving.cluster import ScalingConfig
    return ScalingConfig(min_replicas=1, max_replicas=5,
                         scale_up_eta_s=2.0, scale_down_eta_s=0.3,
                         pool_pressure=0.9, up_hold_s=0.5,
                         down_hold_s=3.0, cooldown_s=3.0)


def run_cluster_trace(programs: list[Program], rc: ReplayConfig,
                      replicas: int = 3,
                      router: str = "kv_aware_migrate",
                      telemetry: bool = False,
                      scaling=None, prefill_replicas: int = 0,
                      drift: bool = False, *, physical: bool = False,
                      device="cuda", cfg=None,
                      hw: HardwareProfile | None = None, model=None
                      ) -> tuple[list[str], list[str], object]:
    """One cluster replay leg. Returns (trace lines, conservation
    violations observed at step boundaries, cluster). With
    ``telemetry``, a shared :class:`~repro_torch.obs.Telemetry` plane is
    attached to every replica and left on ``cluster.obs`` (``drift``
    additionally enables the prediction-drift watchdog before the run).
    With ``scaling`` (a :class:`ScalingConfig`), the fleet is elastic:
    ``replicas`` is the *starting* decode-pool size, an engine factory is
    installed so the policy can grow it, and scale/drain/retire events
    enter the byte-compared trace stream. ``prefill_replicas`` adds
    disaggregated prefill-only replicas (``pf*``).

    ``physical=False`` is the logical stack. ``physical=True`` gives every
    replica — seed, prefill and the ones the autoscaler adds — a
    shadow-clocked ``TorchModelBackend`` on ``device`` (verified COW
    splits and restores), all over ONE ``model`` (built once from seed 0
    when None) and token-stream seed 0; after every step ``Cluster.check``
    must pass and no replica may hold a host copy its tier store has no
    entry for. ``cfg`` defaults to the smoke config of ``rc.arch``, ``hw``
    to ``rc.hardware()``."""
    from repro_torch.serving.cluster import Cluster, ClusterConfig
    cfg = cfg if cfg is not None else get_config(rc.arch, smoke=True)
    prof = build_profile(cfg, 1)
    hw = hw if hw is not None else rc.hardware()
    cost = CostModel(prof, hw)
    block_bytes = rc.block_size * prof.kv_bytes_per_token
    if physical and model is None:
        from repro_torch.models import Model
        model = Model(cfg, device=device, seed=0)

    def make(eid: str) -> Engine:
        backend = _physical_backend(cfg, rc, cost, model, device) \
            if physical else None
        return Engine(cfg, rc.engine_config(block_bytes), hw,
                      backend=backend, cost=cost, engine_id=eid)

    engines = [make(f"r{i}") for i in range(replicas)]
    for i in range(prefill_replicas):
        e = make(f"pf{i}")
        e.role = "prefill"
        engines.append(e)
    ccfg = ClusterConfig(
        n_replicas=replicas, router=router,
        peer_bw=2 * rc.h2d_bw_blocks * block_bytes,
        peer_latency_s=0.001,
        scaling=scaling, prefill_replicas=prefill_replicas)
    cluster = Cluster(engines, ccfg,
                      engine_factory=make if scaling else None)
    if telemetry:
        from repro_torch.obs import Telemetry
        cluster.attach_telemetry(Telemetry())
        if drift:
            cluster.obs.enable_drift()
    violations: list[str] = []

    def _capture(e, ev, now):
        if ev.decisions:
            cluster.trace.append({
                "ev": "step", "replica": e.engine_id, "now": round(now, 9),
                "events": [list(d) for d in ev.decisions]})
        violations.extend(cluster.violations(now))
        if physical:
            cluster.check(now)
            for r in cluster.engines:
                stray = set(r.backend.host_caches) - set(r.kvstore.entries)
                assert not stray, (r.engine_id, sorted(stray))

    cluster.run(_clone_programs(programs), max_seconds=rc.max_seconds,
                on_step=_capture)
    lines = [json.dumps(d, sort_keys=True) for d in cluster.trace]
    return lines, violations, cluster


#: runtime tier events (``PagedKVRuntime``): what a physical leg's trace
#: holds beyond the logical leg's
RUNTIME_EVENTS = ("stage_out", "restore", "cow_split")


def runtime_events(tel, replica: Optional[str] = None) -> list[tuple]:
    """The raw trace events of the paged runtimes (stage-out, restore, COW
    split), in emission order; ``replica`` keeps one replica's."""
    return [ev for ev in tel.trace.events
            if ev[0] == "i" and ev[4] == "tier" and ev[3] in RUNTIME_EVENTS
            and (replica is None or ev[2] == replica)]


def cross_replica_restores(tel) -> list[tuple[str, str, str]]:
    """(program, replica that staged it out, replica that restored it)
    for every restore of a host copy staged out on another replica — KV
    that crossed the peer link."""
    staged: dict[str, str] = {}
    out = []
    for _, _, replica, name, _, args in runtime_events(tel):
        pid = args["program"]
        if name == "stage_out":
            staged[pid] = replica
        elif name == "restore" and staged.get(pid, replica) != replica:
            out.append((pid, staged[pid], replica))
    return out


def physical_stats(cluster) -> dict:
    """Per-replica counters of a physical cluster leg (retired replicas
    included), each backend's beside the runtime events the telemetry
    plane recorded for it when one is attached."""
    out = {}
    for e in cluster.all_engines():
        b = e.backend.inner
        rt = b.runtime
        rec = dict(
            demotions=b.demotions, restores=b.restores,
            cow_splits=rt.cow_splits,
            staging_checks=len(b.staging_checks),
            staging_failures=sum(not ok for _, ok in b.staging_checks),
            cow_checks=len(rt.copy_checks),
            cow_failures=sum(not ok for ok in rt.copy_checks),
            shortfall_tokens=b.shortfall_tokens,
            prefill_tokens=b.prefill_tokens_computed,
            decode_tokens=b.decode_tokens_computed)
        if cluster.obs is not None:
            evs = runtime_events(cluster.obs, e.engine_id)
            for name in RUNTIME_EVENTS:
                rec[f"{name}_events"] = sum(ev[3] == name for ev in evs)
        out[e.engine_id] = rec
    return out


def run_cluster_replay(programs: list[Program],
                       rc: ReplayConfig = ReplayConfig(),
                       replicas: int = 3,
                       router: str = "kv_aware_migrate",
                       first: Optional[tuple] = None,
                       scaling=None,
                       prefill_replicas: int = 0, *,
                       physical: bool = False, device="cuda", cfg=None,
                       hw: HardwareProfile | None = None,
                       model=None) -> ClusterReplayReport:
    """Run the trace twice; verdict = byte-identical traces + zero
    conservation violations. ``first`` reuses an existing *logical*
    ``run_cluster_trace`` result as run A (the CLI records the trace
    artifact with it — no third simulation). ``scaling`` /
    ``prefill_replicas`` make both legs elastic (the scale/drain/retire
    events are part of the byte-compared stream, so autoscaling itself
    is gated deterministic). ``physical=True`` makes run B the physical
    leg on ``device`` (run A stays logical): its trace must equal the
    logical one, its violations are the ones reported, and its staging
    and COW checks join ``stats``."""
    kw = dict(scaling=scaling, prefill_replicas=prefill_replicas, cfg=cfg,
              hw=hw)
    lines_a, viol_a, cluster = first if first is not None else \
        run_cluster_trace(programs, rc, replicas, router, **kw)
    lines_b, viol_b, cluster_b = run_cluster_trace(
        programs, rc, replicas, router, physical=physical, device=device,
        model=model, **kw)
    if physical:
        viol_a, cluster = viol_b, cluster_b
    div = None
    for i, (a, b) in enumerate(zip(lines_a, lines_b)):
        if a != b:
            div = {"line": i, "a": a, "b": b}
            break
    if div is None and len(lines_a) != len(lines_b):
        i = min(len(lines_a), len(lines_b))
        div = {"line": i,
               "a": lines_a[i] if i < len(lines_a) else None,
               "b": lines_b[i] if i < len(lines_b) else None}
    fleet = cluster.all_engines()        # retired replicas still count
    st = fleet[0].scheduler.stats
    stats = {"cold_rehomes": cluster.stats.cold_rehomes,
             "offload_reloads": sum(e.scheduler.stats.offload_reloads
                                    for e in fleet),
             "demotions": sum(e.scheduler.stats.demotions for e in fleet),
             "preemptions": sum(e.scheduler.stats.preemptions
                                for e in fleet),
             "migrated_tokens": cluster.stats.migrated_tokens,
             "migration_denied": cluster.stats.migration_denied,
             "scale_ups": cluster.stats.scale_ups,
             "scale_downs": cluster.stats.scale_downs,
             "retired": cluster.stats.retired,
             "drained_tokens": cluster.stats.drained_tokens,
             "prefill_handoffs": cluster.stats.prefill_handoffs,
             "engine0_pins": st.pins}
    if physical:
        per = physical_stats(cluster)
        for key in ("staging_checks", "staging_failures", "cow_checks",
                    "cow_failures", "shortfall_tokens", "restores",
                    "demotions"):
            stats[key if key != "demotions" else "demotions_physical"] = \
                sum(r[key] for r in per.values())
        stats["cow_splits"] = sum(r["cow_splits"] for r in per.values())
        stats["replicas"] = per
    return ClusterReplayReport(
        deterministic=div is None,
        conservation_violations=len(viol_a),
        steps=len(lines_a),
        migrations=cluster.stats.migrations,
        first_divergence=div,
        violation_examples=viol_a[:5],
        stats=stats)


# ------------------------------------------------------------- telemetry
def write_telemetry_artifacts(tel, out_dir) -> dict:
    """Export one run's full telemetry plane: Perfetto-loadable
    ``trace.json``, the raw event stream ``trace.jsonl``, the Prometheus
    text exposition ``metrics.prom``, its JSON mirror ``metrics.json``
    and the TTL decision audit ``audit.json``. Returns
    {artifact name -> path}."""
    from repro_torch.obs import export as obs_export
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = {"trace": out / "trace.json",
             "trace_raw": out / "trace.jsonl",
             "metrics_prom": out / "metrics.prom",
             "metrics_json": out / "metrics.json",
             "audit": out / "audit.json"}
    doc = obs_export.to_chrome(tel.trace)
    paths["trace"].write_text(obs_export.dumps(doc))
    tel.trace.save_jsonl(paths["trace_raw"])
    paths["metrics_prom"].write_text(tel.metrics.exposition())
    paths["metrics_json"].write_text(
        json.dumps(tel.metrics.snapshot(), indent=2, sort_keys=True)
        + "\n")
    paths["audit"].write_text(
        json.dumps(tel.audit.to_json(), indent=2, sort_keys=True) + "\n")
    return {k: str(v) for k, v in paths.items()}


def run_telemetry_demo(seed: int, out_dir,
                       rc: ReplayConfig = ReplayConfig(),
                       replicas: int = 3,
                       router: str = "kv_aware_migrate") -> dict:
    """The ISSUE's seeded observability scenario: a 3-replica cluster run
    with the full telemetry plane on, exported to ``out_dir``. The same
    seed is then run a second time and the Perfetto export must be
    byte-identical; the exported trace must validate against the schema;
    and the TTL audit must contain at least one complete
    solve → pin → expiry/demotion chain. Returns a verdict dict."""
    from repro_torch.obs import export as obs_export
    # denser than the conservation gate's workload: per-replica queueing
    # must be positive so the TTL solver actually pins (the acceptance
    # chain is solve -> pin -> expiry/demotion, not just demotes)
    progs = cluster_programs(seed, n=16, rate_jps=3.0)
    _, _, cluster = run_cluster_trace(progs, rc, replicas, router,
                                      telemetry=True)
    tel = cluster.obs
    paths = write_telemetry_artifacts(tel, out_dir)
    doc = obs_export.to_chrome(tel.trace)
    schema_errors = obs_export.validate(doc)
    _, _, cluster_b = run_cluster_trace(progs, rc, replicas, router,
                                        telemetry=True)
    bytes_a = obs_export.dumps(doc)
    bytes_b = obs_export.dumps(obs_export.to_chrome(cluster_b.obs.trace))
    complete = tel.audit.complete_programs()
    verdict = {
        "seed": seed, "replicas": replicas, "router": router,
        "events": len(tel.trace.events),
        "dropped_events": tel.trace.dropped,
        "schema_errors": schema_errors,
        "deterministic": bytes_a == bytes_b,
        "ttl_solves": len(tel.audit.records),
        "audit_links": len(tel.audit.links),
        "complete_audit_chains": sorted(complete),
        "migrations": cluster.stats.migrations,
        "artifacts": paths,
        "ok": (not schema_errors and bytes_a == bytes_b
               and len(complete) >= 1),
    }
    (pathlib.Path(out_dir) / "verdict.json").write_text(
        json.dumps(verdict, indent=2, sort_keys=True) + "\n")
    return verdict


def run_regret_demo(seed: int, out_dir,
                    rc: Optional[ReplayConfig] = None,
                    replicas: int = 3,
                    router: str = "kv_aware_migrate",
                    n: int = 24, rate_jps: float = 6.0) -> dict:
    """The ISSUE's counterfactual-regret scenario: a *dense* skewed
    cluster trace (heavier than the telemetry demo: per-replica queueing
    is sustained, so retention genuinely pays and the TTL solver's
    per-tool adaptivity matters) replayed through
    :func:`repro_torch.obs.regret.analyze`. Gates on three things:

    - Continuum's solved TTL beats every fixed-TTL counterfactual *and*
      evict-always on total regret (``continuum_beats_all_fixed``);
    - a second same-seed run produces a byte-identical regret report;
    - the ``/metrics`` scrape fetched over a live :class:`ObsServer` is
      byte-identical across the two runs.

    Writes ``regret.json``, ``metrics.prom`` and ``verdict.json`` to
    ``out_dir``; returns the verdict dict."""
    import urllib.request

    from repro_torch.obs import regret as obs_regret
    from repro_torch.obs.server import ObsServer
    if rc is None:
        # long max_ttl: the fixed-TTL sweep and the solver both get room
        # to hold KV across multi-second tool storms
        rc = dataclasses.replace(ReplayConfig(), max_ttl=8.0)
    progs = cluster_programs(seed, n=n, rate_jps=rate_jps)

    def one_run():
        _, _, cluster = run_cluster_trace(progs, rc, replicas, router,
                                          telemetry=True)
        report = obs_regret.analyze(cluster.obs.audit.to_json())
        srv = ObsServer(cluster.obs,
                        clock=lambda: cluster.clock.now).start()
        try:
            with urllib.request.urlopen(srv.url("/metrics")) as resp:
                prom = resp.read().decode()
        finally:
            srv.stop()
        return report, obs_regret.dumps(report), prom

    report, bytes_a, prom_a = one_run()
    _, bytes_b, prom_b = one_run()
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "regret.json").write_text(bytes_a)
    (out / "metrics.prom").write_text(prom_a)
    verdict = {
        "seed": seed, "replicas": replicas, "router": router,
        "n_programs": n, "rate_jps": rate_jps, "max_ttl": rc.max_ttl,
        "n_decisions": report["n_decisions"],
        "ranking": report["ranking"],
        "total_regret_s": {p: report["policies"][p]["total_regret_s"]
                           for p in report["policies"]},
        "continuum_beats_all_fixed": report["continuum_beats_all_fixed"],
        "report_deterministic": bytes_a == bytes_b,
        "metrics_deterministic": prom_a == prom_b,
        "artifacts": {"regret": str(out / "regret.json"),
                      "metrics_prom": str(out / "metrics.prom")},
        "ok": (report["continuum_beats_all_fixed"]
               and bytes_a == bytes_b and prom_a == prom_b),
    }
    (out / "verdict.json").write_text(
        json.dumps(verdict, indent=2, sort_keys=True) + "\n")
    return verdict


def drift_scenario_programs() -> list[Program]:
    """Scripted mispredicted-tool workload for the drift watchdog demo:
    one long program whose ``survey`` tool durations first alternate
    hard between ~60ms and 2s (the mean-based tool-CDF predictor is then
    wrong by >90% on every short call — p90 relative error crosses the
    fire threshold), then settle at a steady 2s (the predictor converges
    and the alert must *resolve*). Fully deterministic — the alternation
    is scripted in the turns, not sampled. Turns are kept small (16
    prompt tokens each) so all 55 of them fit the smoke block pool —
    the demo must reach phase 2 or the resolve can never fire."""
    turns = []
    for k in range(24):                      # phase 1: fire
        turns.append(Turn(new_tokens=16, output_tokens=3, tool="survey",
                          tool_duration=0.06 if k % 2 == 0 else 2.0,
                          output_text=""))
    for _ in range(30):                      # phase 2: resolve
        turns.append(Turn(new_tokens=16, output_tokens=3, tool="survey",
                          tool_duration=2.0, output_text=""))
    turns.append(Turn(new_tokens=16, output_tokens=3, tool=None,
                      tool_duration=0.0, output_text="Final answer."))
    return [Program(program_id="drift-oracle", arrival_time=0.0,
                    turns=turns)]


def run_attribution_demo(seed: int, out_dir,
                         rc: Optional[ReplayConfig] = None,
                         replicas: int = 3,
                         router: str = "kv_aware_migrate") -> dict:
    """The ISSUE's attribution + drift scenario, in two parts:

    1. a seeded cluster run with telemetry *and* the drift watchdog on,
       analyzed by :mod:`repro_torch.obs.attribution` — every completed
       program's JCT decomposition must sum to its JCT within ε, and a
       second same-seed run must produce a byte-identical report (and
       byte-identical drift status);
    2. the scripted :func:`drift_scenario_programs` workload on a single
       engine — the watchdog must fire a drift alert for *exactly* the
       ``tool_duration`` estimator (every other estimator quiet) and
       later resolve it once the predictor converges.

    Writes ``attribution.json``, ``drift.json`` and ``verdict.json`` to
    ``out_dir``; returns the verdict dict."""
    from repro_torch.obs import Telemetry
    from repro_torch.obs import attribution as obs_attr
    from repro_torch.obs.drift import DriftConfig
    if rc is None:
        rc = ReplayConfig()
    progs = cluster_programs(seed, n=16, rate_jps=3.0)

    def one_run():
        _, _, cluster = run_cluster_trace(progs, rc, replicas, router,
                                          telemetry=True, drift=True)
        report = cluster.obs.attribution()
        status = json.dumps(cluster.obs.drift.status(), indent=2,
                            sort_keys=True) + "\n"
        return report, obs_attr.dumps(report), status

    report, bytes_a, status_a = one_run()
    _, bytes_b, status_b = one_run()
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "attribution.json").write_text(bytes_a)

    # part 2: the mispredicted-tool scenario (tight window/min_samples so
    # the scripted 54-pair workload crosses both thresholds)
    tel = Telemetry()
    tel.enable_drift(DriftConfig(window=24, min_samples=24))
    run_engine(drift_scenario_programs(), rc, physical=False,
               telemetry=tel)
    drift_marks = [e for e in tel.trace.events
                   if e[0] == "i" and e[4] == "drift"]
    fired = sorted({e[5]["estimator"] for e in drift_marks
                    if e[3] == "drift_alert"})
    resolved = sorted({e[5]["estimator"] for e in drift_marks
                       if e[3] == "drift_resolve"})
    scenario_report = tel.attribution()
    (out / "drift.json").write_text(
        json.dumps(tel.drift.status(), indent=2, sort_keys=True) + "\n")

    fleet = report["fleet"]
    verdict = {
        "seed": seed, "replicas": replicas, "router": router,
        "n_programs": fleet["n_programs"],
        "sums_to_jct": report["ok"],
        "report_deterministic": bytes_a == bytes_b,
        "drift_deterministic": status_a == status_b,
        "by_component": {c: v["seconds"]
                         for c, v in fleet["by_component"].items()},
        "top_bottleneck": fleet["bottlenecks"][0]
        if fleet["bottlenecks"] else None,
        "scenario": {
            "alerts_fired": fired,
            "alerts_resolved": resolved,
            "sums_to_jct": scenario_report["ok"],
        },
        "artifacts": {"attribution": str(out / "attribution.json"),
                      "drift": str(out / "drift.json")},
        "ok": (report["ok"] and fleet["n_programs"] >= 4
               and bytes_a == bytes_b and status_a == status_b
               and scenario_report["ok"]
               and fired == ["tool_duration"]
               and "tool_duration" in resolved),
    }
    (out / "verdict.json").write_text(
        json.dumps(verdict, indent=2, sort_keys=True) + "\n")
    return verdict


# ----------------------------------------------------------------- CLI
def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="differential logical-vs-physical replay gate")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--programs", type=int, default=6)
    ap.add_argument("--out", type=str, default="experiments/replay_torch")
    ap.add_argument("--device", type=str, default="cuda",
                    help="device of the physical legs (cuda, or cpu for "
                         "the kernels' plain versions)")
    ap.add_argument("--workload", type=str, default="smoke",
                    choices=sorted(WORKLOAD_SPECS),
                    help="trace shape for the differential gate: 'smoke' "
                         "(prefill-heavy) or 'decode-heavy' (most tokens "
                         "generated -> large fused decode batches)")
    ap.add_argument("--cluster", action="store_true",
                    help="cluster mode: N-replica determinism + KV "
                         "conservation gate (logical stack; with "
                         "--physical, the physical leg against it)")
    ap.add_argument("--physical", action="store_true",
                    help="with --cluster: run B on shadow-clocked torch "
                         "backends on --device (KV migrates between "
                         "replicas for real); gates its trace against "
                         "the logical one, conservation after every "
                         "step and bit-exact staging and COW checks")
    ap.add_argument("--autoscale", action="store_true",
                    help="with --cluster: elastic mode — seeded diurnal+"
                         "bursty trace, runtime scale-up/down with "
                         "drain-based retirement and a prefill-only "
                         "replica; gates byte-identical traces, zero "
                         "conservation violations AND non-vacuous "
                         "scaling (at least one scale-up and one "
                         "retirement per seed)")
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--router", type=str, default="kv_aware_migrate")
    ap.add_argument("--calibrate", action="store_true",
                    help="calibration mode: run one physical leg per "
                         "seed and write the fitted mfu/decode_eff + "
                         "residuals report (profiler.calibration_report)")
    ap.add_argument("--telemetry", action="store_true",
                    help="telemetry mode: seeded cluster run with the "
                         "full observability plane; writes Perfetto "
                         "trace + metrics + TTL audit and gates on "
                         "schema validity, byte-identical same-seed "
                         "export and a complete audit chain")
    ap.add_argument("--attribution", action="store_true",
                    help="attribution mode: seeded cluster run with "
                         "telemetry + drift watchdog; gates on every "
                         "program's JCT decomposition summing to its "
                         "JCT, byte-identical same-seed reports, and "
                         "the scripted mispredicted-tool scenario "
                         "firing (and resolving) a drift alert for "
                         "exactly the tool-duration estimator")
    ap.add_argument("--regret", action="store_true",
                    help="regret mode: dense seeded cluster run replayed "
                         "under counterfactual TTL policies (oracle, "
                         "evict-always, pin-forever, fixed sweep); gates "
                         "on Continuum beating every fixed TTL and "
                         "evict-always, plus byte-identical same-seed "
                         "regret report and /metrics scrape")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    failed = False
    for seed in args.seeds:
        if args.attribution:
            verdict = run_attribution_demo(seed, out / f"seed{seed}",
                                           replicas=args.replicas,
                                           router=args.router)
            print(f"attribution seed {seed}: "
                  f"{'OK' if verdict['ok'] else 'FAIL'} "
                  f"(programs={verdict['n_programs']}, "
                  f"sums_to_jct={verdict['sums_to_jct']}, "
                  f"deterministic={verdict['report_deterministic'] and verdict['drift_deterministic']}, "
                  f"fired={verdict['scenario']['alerts_fired']}, "
                  f"resolved={verdict['scenario']['alerts_resolved']})")
            failed |= not verdict["ok"]
            continue
        if args.regret:
            verdict = run_regret_demo(seed, out / f"seed{seed}",
                                      replicas=args.replicas,
                                      router=args.router)
            print(f"regret seed {seed}: "
                  f"{'OK' if verdict['ok'] else 'FAIL'} "
                  f"(decisions={verdict['n_decisions']}, "
                  f"beats_all_fixed="
                  f"{verdict['continuum_beats_all_fixed']}, "
                  f"ranking={verdict['ranking'][:3]}, "
                  f"deterministic={verdict['report_deterministic'] and verdict['metrics_deterministic']})")
            failed |= not verdict["ok"]
            continue
        if args.telemetry:
            verdict = run_telemetry_demo(
                seed, out / f"seed{seed}", ReplayConfig(),
                args.replicas, args.router)
            print(f"telemetry seed {seed}: "
                  f"{'OK' if verdict['ok'] else 'FAIL'} "
                  f"(events={verdict['events']}, "
                  f"solves={verdict['ttl_solves']}, "
                  f"deterministic={verdict['deterministic']}, "
                  f"complete_chains={len(verdict['complete_audit_chains'])})")
            failed |= not verdict["ok"]
            continue
        if args.calibrate:
            progs = seeded_programs(seed, n=args.programs)
            _, eng = run_engine(progs, ReplayConfig(), args.device)
            path = out / f"calibration_seed{seed}.json"
            cal = eng.backend.calibrate(report_path=str(path))
            hw = eng.backend.cost.hw
            print(f"calibrate seed {seed}: mfu {hw.mfu:.3f}->"
                  f"{cal.mfu:.3f} decode_eff {hw.decode_eff:.3f}->"
                  f"{cal.decode_eff:.3f} -> {path}")
            continue
        if args.cluster and args.autoscale:
            progs = elastic_programs(seed, n=max(args.programs, 16))
            scaling = elastic_scaling_config()
            first = run_cluster_trace(
                progs, ReplayConfig(), replicas=2, router=args.router,
                scaling=scaling, prefill_replicas=1)
            (out / f"elastic_trace_seed{seed}.jsonl").write_text(
                "\n".join(first[0]) + "\n")
            report = run_cluster_replay(progs, ReplayConfig(),
                                        replicas=2, router=args.router,
                                        first=first, scaling=scaling,
                                        prefill_replicas=1,
                                        physical=args.physical,
                                        device=args.device)
            (out / f"elastic_verdict_seed{seed}.json").write_text(
                json.dumps(report.to_json(), indent=2, default=str))
            scaled = (report.stats["scale_ups"] >= 1
                      and report.stats["retired"] >= 1)
            print(f"elastic seed {seed}: {report.describe()} "
                  f"(scale_ups={report.stats['scale_ups']}, "
                  f"retired={report.stats['retired']}, "
                  f"handoffs={report.stats['prefill_handoffs']})")
            if not scaled:
                print(f"elastic seed {seed}: FAIL — scaling never fired "
                      f"(vacuous elastic gate)")
            failed |= not (report.ok and scaled)
            continue
        if args.cluster:
            progs = cluster_programs(seed, n=max(args.programs, 10))
            first = run_cluster_trace(
                progs, ReplayConfig(), args.replicas, args.router)
            (out / f"cluster_trace_seed{seed}.jsonl").write_text(
                "\n".join(first[0]) + "\n")
            report = run_cluster_replay(progs, ReplayConfig(),
                                        args.replicas, args.router,
                                        first=first,
                                        physical=args.physical,
                                        device=args.device)
            (out / f"cluster_verdict_seed{seed}.json").write_text(
                json.dumps(report.to_json(), indent=2, default=str))
            print(f"cluster seed {seed}: {report.describe()}")
            failed |= not report.ok
            continue
        spec = WORKLOAD_SPECS[args.workload]
        tag = "" if args.workload == "smoke" else f"_{args.workload}"
        trace = out / f"trace_seed{seed}{tag}.jsonl"
        record_trace(seeded_programs(seed, n=args.programs, spec=spec),
                     trace)
        report = run_differential(load_trace(trace), device=args.device)
        (out / f"verdict_seed{seed}{tag}.json").write_text(
            json.dumps(report.to_json(), indent=2, default=str))
        print(f"seed {seed} [{args.workload}]: {report.describe()}")
        failed |= not report.ok
    return 1 if failed else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
