#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with one card::

    python3 chip_smoke.py

Phase 0  the device: name and power limit (nvidia-smi), TF32 off.
Phase 1  build every CUDA kernel from ``src/repro_torch/csrc`` (nvcc,
         sm_90a), all sources in parallel.
Phase 2  every kernel against its plain PyTorch version on the card, at
         the serving path's shapes for full-width qwen2-1.5b (L=28, KV=2,
         Dh=128, H=12, page=16, bf16 pools, B=8, ragged lengths up to 4096
         with a zero-length row and garbage in dead table slots) and at the
         smoke models' shapes (Dh=8, G=3, page=8; Dh=16, G=2, page=16), in
         bf16 and fp32; times the kernel, its plain version and, where one
         exists, the one PyTorch call computing the same function, beside
         the least time the card could take.
Phase 3  the main path: full-width qwen2-1.5b (28 layers, seeded random
         weights cast once to bf16) serving agent programs through the
         unchanged ``Engine`` with a ``TorchModelBackend``: (a) the
         differential replay, the physical leg on a shadow clock priced by
         the card's datasheet profile, which must make the logical leg's
         decisions with every restore and COW split bit-exact and with
         pins, TTL hits, demotions, restores and COW splits all exercised;
         (b) the same programs on the measured clock, for JCT and
         throughput. Kernel launch counts are zeroed before phase 3 and
         read after it: every kernel must have run there.

Prints a ``{"kernels": [...]}`` line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``. Any failed check raises: the script
then exits non-zero and prints no result line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Datasheet peaks (NVIDIA H100/H200 data sheets; dense rates, full power
# limit): HBM bytes/s, bf16 tensor-core FLOP/s, fp32 FLOP/s, HBM bytes,
# host link (PCIe Gen5 x16) bytes/s. Matched against the nvidia-smi name,
# most specific first.
CARDS = (
    ("H100 PCIe", dict(hbm_bw=2.0e12, bf16=756e12, fp32=51e12,
                       hbm_bytes=80e9, h2d=64e9)),
    ("H100 NVL", dict(hbm_bw=3.9e12, bf16=835e12, fp32=60e12,
                      hbm_bytes=94e9, h2d=64e9)),
    ("H200", dict(hbm_bw=4.8e12, bf16=989e12, fp32=67e12,
                  hbm_bytes=141e9, h2d=64e9)),
    ("H100", dict(hbm_bw=3.35e12, bf16=989e12, fp32=67e12,
                  hbm_bytes=80e9, h2d=64e9)),
)

# Phase-2 shapes: qwen2-1.5b at full width, and the qwen2 and glm4 smoke
# models' (Dh 8 and 16, G 3 and 2, pages of 8 and 16).
FULL = dict(L=28, KV=2, G=6, Dh=128, page=16, B=8,
            lens=(4096, 0, 1, 17, 1000, 2048, 3333, 4095), stage_pages=128)
SMOKE = dict(L=2, KV=2, G=3, Dh=8, page=8, B=4, lens=(0, 5, 17, 40),
             stage_pages=5)
GLM4_SMOKE = dict(L=2, KV=2, G=2, Dh=16, page=16, B=3, lens=(7, 0, 33),
                  stage_pages=3)


def log(*args) -> None:
    print(*args, flush=True)


def card_datasheet(name: str) -> dict:
    for key, sheet in CARDS:
        if key in name:
            return sheet
    raise RuntimeError(f"no datasheet for card {name!r}")


def hardware_profile(name: str):
    """The engine's HardwareProfile for this card, from its datasheet
    (mfu / decode_eff keep the profile's defaults)."""
    from repro_torch.serving.profiler import HardwareProfile
    s = card_datasheet(name)
    return HardwareProfile(name=name, flops=s["bf16"], hbm_bw=s["hbm_bw"],
                           hbm_bytes=s["hbm_bytes"], ici_bw=450e9,
                           h2d_bw=s["h2d"])


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters``
    calls after ``warmup`` untimed ones."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: float, sheet: dict, op_rate: str):
    """The least time for the work: the larger of bytes / HBM bandwidth
    and operations / the peak rate of their type. Returns (ms, bound_by)."""
    t_bytes = nbytes / sheet["hbm_bw"] * 1e3
    t_ops = ops / sheet[op_rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 2
def make_case(shape: dict, dtype, gen, device):
    """Pools, queries, ragged block tables (garbage in every dead slot) and
    token rows at ``shape``."""
    import numpy as np
    import torch
    L, KV, G, Dh, page, B = (shape[k] for k in ("L", "KV", "G", "Dh",
                                                 "page", "B"))
    lens = np.asarray(shape["lens"], np.int32)
    n_live = [math.ceil(n / page) for n in lens]
    n_tab = max(1, max(n_live))
    P = max(sum(n_live), shape["stage_pages"], B) + 16
    rng = np.random.default_rng(0)
    tables = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(B, n_tab),
                          dtype=np.int64).astype(np.int32)
    perm = rng.permutation(P)
    used = 0
    for b, n in enumerate(n_live):
        tables[b, :n] = perm[used:used + n]
        used += n
    pool = (L, P, page, KV, Dh)
    return dict(
        lens=lens, tables=tables, P=P,
        q=torch.randn((B, KV * G, Dh), generator=gen, device=device).to(dtype),
        k=torch.randn(pool, generator=gen, device=device).to(dtype),
        v=torch.randn(pool, generator=gen, device=device).to(dtype),
        k_tok=torch.randn((L, B, KV, Dh), generator=gen,
                          device=device).to(dtype),
        v_tok=torch.randn((L, B, KV, Dh), generator=gen,
                          device=device).to(dtype),
        stage_ids=rng.permutation(P)[:shape["stage_pages"]],
        app_pages=rng.permutation(P)[:B],
        app_offs=rng.integers(0, page, size=B))


def check_decode(case: dict, layer: int, timed: bool, sheet: dict):
    import torch
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_kernel, paged_decode_attention_ref)
    dev = case["q"].device
    tables = torch.from_numpy(case["tables"]).to(dev)
    lens = torch.from_numpy(case["lens"]).to(dev)
    args = (case["q"], case["k"], case["v"], tables, lens)
    acc, m, l = paged_decode_attention_kernel(*args, layer=layer,
                                              return_residuals=True)
    out = paged_decode_attention_kernel(*args, layer=layer)
    torch.cuda.synchronize()
    acc_r, m_r, l_r = paged_decode_attention_ref(*args, layer=layer,
                                                 return_residuals=True)
    out_r = paged_decode_attention_ref(*args, layer=layer)
    # fp32 residuals from identical inputs differ only in summation order
    # over at most 4096 terms: 2e-3 covers it with a wide margin
    for got, ref in ((acc, acc_r), (m, m_r), (l, l_r)):
        torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)
    # the normalized output is rounded to q's dtype on both sides: one
    # bf16 ulp (2^-8 relative) apart at most
    torch.testing.assert_close(out.float(), out_r.float(), atol=1e-2,
                               rtol=1e-2)
    empty = [b for b, n in enumerate(case["lens"]) if n == 0]
    for b in empty:                 # exact empty-row contract
        assert (m[b] == -2.0e38).all() and (l[b] == 0).all() \
            and (acc[b] == 0).all(), "empty row residuals"
    err = max((acc - acc_r).abs().max().item(),
              (out.float() - out_r.float()).abs().max().item())
    if not timed:
        return err, None
    B, H, Dh = case["q"].shape
    KV = case["k"].shape[3]
    live = int(case["lens"].sum())
    esz = case["q"].element_size()
    n_live = sum(math.ceil(n / case["k"].shape[2]) for n in case["lens"])
    nbytes = (B * H * Dh * esz + 2 * live * KV * Dh * esz + 4 * n_live
              + 4 * B + B * H * Dh * 4 + 2 * B * H * 4)
    ops = 4.0 * live * H * Dh             # q.k and p.v, fp32 on CUDA cores
    bms, by = bound_ms(nbytes, ops, sheet, "fp32")
    rec = dict(
        ms=time_ms(lambda: paged_decode_attention_kernel(
            *args, layer=layer, return_residuals=True)),
        plain_ms=time_ms(lambda: paged_decode_attention_ref(
            *args, layer=layer, return_residuals=True), iters=3, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None)
    return err, rec


def check_page_copy(case: dict, timed: bool, sheet: dict) -> dict:
    """Gather, scatter, copy (gather + scatter) and append: bit-exact
    against the plain versions. Returns {kernel: (err, timing or None)}."""
    import torch
    from repro_torch.kernels.page_copy import (
        append_tokens_ref, copy_pages, copy_pages_ref, page_gather_kernel,
        page_gather_ref, page_scatter_kernel, page_scatter_ref,
        token_append_kernel)
    k = case["k"]
    dev = k.device
    ids = case["stage_ids"]
    ids_dev = torch.from_numpy(ids).to(dev)
    res = {}

    staging = page_gather_kernel(k, ids)
    torch.cuda.synchronize()
    assert torch.equal(staging, page_gather_ref(k, ids)), "gather"
    res["page_gather"] = 0.0

    pool, pool_r = k.clone(), k.clone()
    fresh = torch.randn(staging.shape, device=dev).to(k.dtype)
    page_scatter_kernel(pool, fresh, ids)
    page_scatter_ref(pool_r, fresh, ids)
    torch.cuda.synchronize()
    assert torch.equal(pool, pool_r), "scatter"
    res["page_scatter"] = 0.0

    src, dst = ids[: len(ids) // 2], ids[len(ids) // 2:][: len(ids) // 2]
    copy_pages(pool, src, dst)
    copy_pages_ref(pool_r, src, dst)
    torch.cuda.synchronize()
    assert torch.equal(pool, pool_r), "copy"

    kp, vp = k.clone(), case["v"].clone()
    kr, vr = k.clone(), case["v"].clone()
    token_append_kernel(kp, vp, case["k_tok"], case["v_tok"],
                        case["app_pages"], case["app_offs"])
    append_tokens_ref(kr, vr, case["k_tok"], case["v_tok"],
                      case["app_pages"], case["app_offs"])
    torch.cuda.synchronize()
    assert torch.equal(kp, kr) and torch.equal(vp, vr), "append"
    res["token_append"] = 0.0
    if not timed:
        return {name: (err, None) for name, err in res.items()}

    L, P = k.shape[:2]
    row = k[0, 0].numel() * k.element_size()
    moved = len(ids) * L * row
    out = {}
    for name, kern, plain, lib in (
            ("page_gather", lambda: page_gather_kernel(k, ids),
             lambda: page_gather_ref(k, ids),
             lambda: torch.index_select(k, 1, ids_dev)),
            ("page_scatter", lambda: page_scatter_kernel(pool, staging, ids),
             lambda: page_scatter_ref(pool_r, staging, ids),
             lambda: pool_r.index_copy_(1, ids_dev, staging))):
        bms, by = bound_ms(2 * moved + 4 * len(ids), 0, sheet, "bf16")
        out[name] = (res[name], dict(ms=time_ms(kern), plain_ms=time_ms(plain),
                                     bound_ms=bms, bound_by=by,
                                     library_ms=time_ms(lib)))
    pid_dev = torch.from_numpy(case["app_pages"]).to(dev)
    off_dev = torch.from_numpy(case["app_offs"]).to(dev)

    def library_append():
        kr[:, pid_dev, off_dev] = case["k_tok"]
        vr[:, pid_dev, off_dev] = case["v_tok"]

    tok_bytes = case["k_tok"].numel() * case["k_tok"].element_size()
    bms, by = bound_ms(4 * tok_bytes + 8 * len(case["app_pages"]), 0, sheet,
                       "bf16")
    out["token_append"] = (res["token_append"], dict(
        ms=time_ms(lambda: token_append_kernel(
            kp, vp, case["k_tok"], case["v_tok"], case["app_pages"],
            case["app_offs"])),
        plain_ms=time_ms(lambda: append_tokens_ref(
            kr, vr, case["k_tok"], case["v_tok"], case["app_pages"],
            case["app_offs"])),
        bound_ms=bms, bound_by=by, library_ms=time_ms(library_append)))
    return out


def phase2(sheet: dict) -> dict:
    """Returns {kernel name: record} at the full-width shapes."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}
    full = make_case(FULL, torch.bfloat16, gen, "cuda")
    err, rec = check_decode(full, layer=FULL["L"] - 1, timed=True,
                            sheet=sheet)
    records["paged_decode_attention"] = dict(max_abs_err=err, **rec)
    for name, (err, rec) in check_page_copy(full, True, sheet).items():
        records[name] = dict(max_abs_err=err, **rec)
    del full
    for shape in (SMOKE, GLM4_SMOKE):
        for dtype in (torch.bfloat16, torch.float32):
            smoke = make_case(shape, dtype, gen, "cuda")
            err, _ = check_decode(smoke, layer=1, timed=False, sheet=sheet)
            records["paged_decode_attention"]["max_abs_err"] = max(
                records["paged_decode_attention"]["max_abs_err"], err)
            check_page_copy(smoke, False, sheet)
    for name, rec in records.items():
        log(f"phase2 {name}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), library "
            f"{'n/a' if rec['library_ms'] is None else '%.4f ms' % rec['library_ms']}"
            f", max_abs_err {rec['max_abs_err']:.3g}")
    return records


# ---------------------------------------------------------------- phase 3
def agent_programs(seed: int = 0):
    """Eight agent programs of 2-3 turns with contexts up to ~2.2k
    tokens, a fleet-wide shared preamble, and a twin pair whose second
    member adopts the first one's prompt pages mid-page (the COW split).
    Tool pauses are short local tools (milliseconds: ls / cat) and slow
    ones (seconds: pytest), on the millisecond scale of a step on the
    card, so that TTL pins are both kept and left to expire."""
    from repro_torch.core.types import Program, Turn
    from repro_torch.sim.workload import WorkloadSpec, generate_programs
    spec = WorkloadSpec(
        name="chip-smoke", mean_turns=2.6, std_turns=0.5,
        tool_mean_s=0.5, tool_std_s=1.0, tokens_mean=1500, tokens_std=300,
        output_frac=0.02, max_context=2048,
        tools=(("ls", 0.35, 0.002, 0.3), ("cat", 0.3, 0.004, 0.3),
               ("pytest", 0.35, 2.0, 0.3)),
        min_turn_tokens=64, min_output_tokens=6, min_new_tokens=32)
    # a burst (8 sessions within ~40 ms): returning turns queue behind
    # the others' prefills, which is when the TTL solver pins
    progs = generate_programs(spec, n=6, rate_jps=200.0, seed=seed,
                              share_ratio=0.25, prefix_groups=1)
    tmpl = "chip-smoke/twin"
    for j, t0 in ((0, 0.0), (1, 0.03)):
        progs.append(Program(
            program_id=f"chip-smoke-twin{j}", arrival_time=t0,
            turns=[Turn(new_tokens=512, output_tokens=6, tool="ls",
                        tool_duration=0.002,
                        output_text="```bash\nls twin\n```"),
                   Turn(new_tokens=96, output_tokens=6, tool=None,
                        tool_duration=0.0, output_text="Final answer.")],
            shared_prefix_tokens=512, shared_prefix_id=tmpl))
    return progs


def replay_config():
    """Engine and tier sizing of the serve phase: the replay harness's
    ReplayConfig scaled to 2k contexts on the card. A KV pool of 512
    blocks (8k tokens) for 8 programs of ~2k, at most 4 running, a DRAM
    tier that takes every demotion, tier links at PCIe Gen5 and NVMe
    rates, and TTLs capped at 0.5 s with a 2 ms cold-start unit, the
    scale of a step on the card."""
    from repro_torch.core.ttl import TTLConfig
    from repro_torch.sim.replay import ReplayConfig

    @dataclasses.dataclass
    class ServeConfig(ReplayConfig):
        exp_unit_mean: float = 0.002

        def engine_config(self, block_bytes):
            return dataclasses.replace(
                super().engine_config(block_bytes),
                ttl=TTLConfig(cold_start_k=4, max_ttl=self.max_ttl,
                              exp_unit_mean=self.exp_unit_mean))

    block = 16 * 28672                # bytes of one 16-token qwen2-1.5b block
    return ServeConfig(arch="qwen2-1.5b", chunk_size=512, max_batch=4,
                       total_blocks=512, dram_blocks=2048, ssd_blocks=256,
                       h2d_bw_blocks=64e9 / block, ssd_bw_blocks=3e9 / block,
                       max_ttl=0.5, max_len=4096)


def serve_differential(cfg, hw, model, device):
    """Phase 3a: logical leg vs physical leg on the analytic clock."""
    from repro_torch.sim import replay
    rc = replay_config()
    progs = agent_programs()
    log_l, _ = replay.run_engine(progs, rc, physical=False, cfg=cfg, hw=hw)
    log_p, eng = replay.run_engine(progs, rc, device=device, cfg=cfg, hw=hw,
                                   model=model)
    div = replay._first_divergence(log_l, log_p)
    assert div is None, f"decision streams diverge: {div}"
    return eng, len(log_p)


def serve_measured(cfg, hw, model, device):
    """Phase 3b: the same programs on the measured clock."""
    from repro_torch.serving.backend import TorchModelBackend
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.profiler import CostModel, build_profile
    from repro_torch.serving.router import Router
    from repro_torch.sim.runner import Simulator
    rc = replay_config()
    prof = build_profile(cfg, 1)
    cost = CostModel(prof, hw)
    ecfg = rc.engine_config(rc.block_size * prof.kv_bytes_per_token)
    backend = TorchModelBackend(cfg, model=model, max_len=rc.max_len,
                                page_size=rc.block_size, device=device)
    backend.verify_staging = True
    backend.runtime.verify_copies = True
    eng = Engine(cfg, ecfg, hw, backend=backend, cost=cost)
    progs = agent_programs()
    router = Router([eng])
    router.register_programs(progs)
    sim = Simulator([eng], router, max_seconds=rc.max_seconds)
    sim.add_programs(progs)
    summary = sim.run()
    return eng, summary, len(progs)


def mechanism_stats(eng) -> dict:
    b = eng.backend.inner if hasattr(eng.backend, "inner") else eng.backend
    st = eng.scheduler.stats
    return dict(pins=st.pins, ttl_hits=st.ttl_hits,
                ttl_expiries=st.ttl_expiries, demotions=b.demotions,
                restores=b.restores, cow_splits=b.runtime.cow_splits,
                preemptions=st.preemptions, prefix_hits=st.prefix_hits,
                shortfall_tokens=b.shortfall_tokens,
                staging_checks=len(b.staging_checks),
                staging_ok=all(ok for _, ok in b.staging_checks),
                copy_checks=len(b.runtime.copy_checks),
                copy_ok=all(b.runtime.copy_checks),
                prefill_tokens=b.prefill_tokens_computed,
                decode_tokens=b.decode_tokens_computed)


def phase3(hw):
    """The main path at full qwen2-1.5b width on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    cfg = get_config("qwen2-1.5b")
    device = "cuda"
    t0 = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    log(f"phase3 model {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params "
        f"in {next(model.parameters()).dtype}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"phase3 hardware profile: {hw}")

    reset_launch_counts()
    t0 = time.perf_counter()
    eng_a, steps = serve_differential(cfg, hw, model, device)
    wall_a = time.perf_counter() - t0
    counts_a = launch_counts()
    st_a = mechanism_stats(eng_a)
    samples = eng_a.backend.samples
    log(f"phase3a differential: {steps} decision steps identical to the "
        f"logical leg, {wall_a:.1f} s wall, {st_a}, launches {counts_a}")
    assert all(p.finish_time >= 0 for p in eng_a.programs.values())
    for key in ("pins", "ttl_hits", "demotions", "restores", "cow_splits"):
        assert st_a[key] > 0, f"phase 3a exercised no {key}"
    assert st_a["staging_ok"] and st_a["copy_ok"], "staging / COW mismatch"
    assert st_a["staging_checks"] and st_a["copy_checks"]
    assert st_a["shortfall_tokens"] == 0, st_a["shortfall_tokens"]
    b = eng_a.backend.inner
    b.runtime.check(b.prefix_index)

    reset_after_a = dict(counts_a)
    t0 = time.perf_counter()
    eng_b, summary, n_progs = serve_measured(cfg, hw, model, device)
    wall_b = time.perf_counter() - t0
    counts = launch_counts()
    st_b = mechanism_stats(eng_b)
    assert summary.n_programs == n_progs == len(eng_b.programs)
    assert st_b["staging_ok"] and st_b["copy_ok"]
    eng_b.backend.runtime.check(eng_b.backend.prefix_index)
    busy = eng_b.busy_seconds
    log(f"phase3b measured clock: {summary.n_programs} programs, avg JCT "
        f"{summary.avg_jct:.4f} s (p90 {summary.p90_jct:.4f} s), avg TTFT "
        f"{summary.avg_ttft:.4f} s, {eng_b.steps} steps, engine busy "
        f"{busy:.3f} s, {wall_b:.1f} s wall, {st_b}")
    pre_s = sum(s.measured_s for s in samples if s.decode_batch == 0)
    pre_t = sum(s.prefill_tokens for s in samples if s.decode_batch == 0)
    dec_s = sum(s.measured_s for s in samples if s.prefill_tokens == 0)
    dec_t = sum(s.decode_batch for s in samples if s.prefill_tokens == 0)
    rates = dict(
        prefill_tokens_per_s=pre_t / pre_s if pre_s else None,
        decode_tokens_per_s=dec_t / dec_s if dec_s else None,
        avg_decode_batch=(dec_t / sum(1 for s in samples
                                      if s.prefill_tokens == 0 and
                                      s.decode_batch))
        if dec_t else None,
        measured_avg_jct_s=summary.avg_jct,
        measured_tokens_per_s=(st_b["prefill_tokens"] + st_b["decode_tokens"])
        / busy)
    log(f"phase3 throughput (measured step times, 3a prefill-only / "
        f"decode-only steps): {json.dumps(rates)}")
    for name, n in counts.items():
        assert n > 0, f"kernel {name} never launched on the main path"
    log(f"phase3 launches: 3a {reset_after_a}, 3a+3b {counts}")
    return counts


# ------------------------------------------------------------------ main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    sheet = card_datasheet(kind)
    log(f"phase0 device {kind} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}; allow_tf32 "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; datasheet {sheet}")

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"phase1 built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(paths):
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"phase1 {name}: {line.strip()}")

    records = phase2(sheet)
    counts = phase3(hardware_profile(kind))

    sources = {
        "paged_decode_attention": (
            "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:116"),
        "page_gather": ("src/repro_torch/csrc/page_copy.cu",
                        "src/repro/kernels/page_copy/kernel.py:45"),
        "page_scatter": ("src/repro_torch/csrc/page_copy.cu",
                         "src/repro/kernels/page_copy/kernel.py:70"),
        "token_append": ("src/repro_torch/csrc/page_copy.cu",
                         "src/repro/kernels/page_copy/kernel.py:114"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[name], **records[name])
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
