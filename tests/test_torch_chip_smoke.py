"""``chip_smoke.py`` off the card: it refuses to run without CUDA, its
datasheet table and workload are what its docstrings say, and its two
serve legs run end to end on the CPU at smoke width (the card runs them
at full qwen2-1.5b width)."""
import math
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import Model  # noqa: E402

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)


def test_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("name,hbm_bw", [
    ("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12),
    ("NVIDIA H100 NVL", 3.9e12), ("NVIDIA H200", 4.8e12)])
def test_datasheet_matches_card_name(name, hbm_bw):
    assert chip_smoke.card_datasheet(name)["hbm_bw"] == hbm_bw
    hw = chip_smoke.hardware_profile(name)
    assert hw.name == name and hw.hbm_bw == hbm_bw


def test_unknown_card_has_no_bound():
    with pytest.raises(RuntimeError):
        chip_smoke.card_datasheet("Some Other GPU")


def test_bound_takes_the_larger_time():
    sheet = chip_smoke.card_datasheet("NVIDIA H100 80GB HBM3")
    ms, by = chip_smoke.bound_ms(3.35e9, 0, sheet, "bf16")
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = chip_smoke.bound_ms(0, 67e9, sheet, "fp32")
    assert by == "operations" and ms == pytest.approx(1.0)


def test_agent_programs():
    progs = chip_smoke.agent_programs()
    assert len(progs) == 8
    assert all(2 <= p.num_turns <= 3 for p in progs)
    assert max(p.total_tokens() for p in progs) <= 2300
    assert sum(p.shared_prefix_id is not None for p in progs) == 8
    tools = {t.tool for p in progs for t in p.turns if t.tool}
    assert {"ls", "pytest"} <= tools


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("qwen2-1.5b", smoke=True)
    hw = chip_smoke.hardware_profile("NVIDIA H100 80GB HBM3")
    return cfg, hw, Model(cfg, device="cpu")


def test_serve_differential_on_cpu(smoke):
    eng, steps, wall = chip_smoke.serve_differential(*smoke, "cpu")
    st = chip_smoke.mechanism_stats(eng)
    assert steps > 0 and wall > 0
    assert all(p.finish_time >= 0 for p in eng.programs.values())
    assert st["staging_ok"] and st["copy_ok"] and st["cow_splits"] > 0
    assert st["shortfall_tokens"] == 0


def test_serve_measured_on_cpu(smoke):
    eng, summary, n = chip_smoke.serve_measured(*smoke, "cpu")
    st = chip_smoke.mechanism_stats(eng)
    assert summary.n_programs == n == 8
    assert st["staging_ok"] and st["copy_ok"]
    eng.backend.runtime.check(eng.backend.prefix_index)


def test_flash_and_scan_work_at_the_main_shapes():
    """The bounds' arithmetic at path A's and path B's shapes: ~12.9 GFLOP
    and ~15 MB for qwen2-1.5b's 2048-token prefill attention; ~106 MB and
    ~2 GFLOP a layer for rwkv6-3b's 2048-token scan."""
    nbytes, ops = chip_smoke.flash_work(chip_smoke.FLASH_MAIN, 2)
    assert ops == pytest.approx(12.89e9, rel=1e-3)
    assert nbytes == 2 * 2048 * (2 * 12 + 2 * 2) * 128
    sheet = chip_smoke.card_datasheet("NVIDIA H100 80GB HBM3")
    assert chip_smoke.bound_ms(nbytes, ops, sheet, "bf16")[1] == \
        "operations"
    nbytes, ops = chip_smoke.scan_work(chip_smoke.SCAN_MAIN)
    assert nbytes == pytest.approx(106.2e6, rel=1e-3)
    assert ops == pytest.approx(2.01e9, rel=1e-2)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_prefill_vs_extend_on_cpu(dtype):
    """Phase 3's logit check at smoke width (the CPU takes the blocked
    plain attention where the card runs the flash kernel)."""
    import dataclasses
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              compute_dtype=dtype)
    check = chip_smoke.prefill_vs_extend(Model(cfg, device="cpu"), n=96,
                                         split=40)
    chip_smoke.assert_prefill_vs_extend(check, dtype)


def test_rwkv_phase_on_cpu():
    """Phase 4's driver at rwkv6-3b smoke width on the CPU: a timed
    prefill and decode in bf16, and the fp32 checks of one prefill
    against the recurrence and against two carried-state calls."""
    import dataclasses
    cfg = get_config("rwkv6-3b", smoke=True)
    m32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                device="cpu", seed=0)
    m16 = Model(cfg, dict(m32.params), device="cpu")
    assert m16.params["blocks.tmix.wr"].dtype == torch.bfloat16
    assert m16.params["blocks.tmix.u"].dtype == torch.float32
    toks = torch.randint(0, cfg.vocab_size, (2, 128),
                         generator=torch.Generator().manual_seed(2))
    rates = chip_smoke.forward_throughput(m16, toks, n_dec=4)
    assert rates["batch"] == 2 and rates["prompt"] == 128
    checks = chip_smoke.rwkv_equivalence(m32, toks)
    assert set(checks) == {"recurrence", "two_calls"}
    chip_smoke.assert_rwkv_equivalence(checks)
    chip_smoke.rwkv_equivalence_checks(dict(m32.params), cfg, toks, "cpu")


def test_prefill_logit_checks_on_cpu(capsys):
    """Phase 3's asserted check and logged depth sweep at smoke width; the
    sweep's plain-version swap is undone afterwards."""
    from repro_torch.models import attention
    before = attention.attend_causal
    chip_smoke.prefill_logit_checks(get_config("qwen2-1.5b", smoke=True),
                                    "cpu")
    assert attention.attend_causal is before
    out = capsys.readouterr().out
    assert "depth sweep" in out and '"2": {"kernel"' in out


def test_flash_work_at_the_serving_bucket_and_with_a_window():
    """The serving path's 512-token chunk (B=1, H=12, KV=2, D=128): 512 x
    513 / 2 live pairs a head, ~0.81 GFLOP, 3.5 MB; with a window, query
    i sees min(i + 1, window) keys."""
    nbytes, ops = chip_smoke.flash_work(chip_smoke.FLASH_BUCKET, 2)
    assert ops == 4.0 * 128 * (512 * 513 // 2) * 12
    assert nbytes == 2 * 512 * (2 * 12 + 2 * 2) * 128
    shape = dict(chip_smoke.FLASH_BUCKET, S=10, window=4)
    assert chip_smoke.flash_work(shape, 2)[1] == \
        4.0 * 128 * 12 * (1 + 2 + 3 + 4 * 7)
    gemma = chip_smoke.FLASH_OTHER[1]
    pairs = 4096 * 4097 // 2 + 4096 * 4096
    assert chip_smoke.flash_work(gemma, 2)[1] == 4.0 * 256 * pairs * 16


SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_118flash_wgmma_kernelILi128ELi2EEEv
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS"
        /*0a70*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;  /* 0x00e00004181879f0 */
        /*0a80*/                   HGMMA.64x128x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;  /* 0x00e00008181879f0 */
        /*0a90*/              @P0  HGMMA.64x128x16.F32.BF16 R24, R152, gdesc[UR8], R24 ;
        /*0aa0*/                   WARPGROUP.ARRIVE ;
        /*0ab0*/                   MOV R2, 0x0 ;  /* HGMMA in a comment */
		Function : _ZN12_GLOBAL__N_117flash_fp32_kernelILi8EEEv
        /*0010*/                   FFMA R1, R2, R3, R4 ;
"""


def test_count_sass_counts_hgmma_per_function():
    counts = chip_smoke.count_sass(SASS)
    assert counts == {
        "_ZN12_GLOBAL__N_118flash_wgmma_kernelILi128ELi2EEEv": 3,
        "_ZN12_GLOBAL__N_117flash_fp32_kernelILi8EEEv": 0}
    assert chip_smoke.count_sass(SASS, "FFMA")[
        "_ZN12_GLOBAL__N_117flash_fp32_kernelILi8EEEv"] == 1


def test_flash_tiles_follow_the_planner():
    from repro_torch.kernels.flash_attention.kernel import plan_bf16
    for D in (8, 80, 128, 192, 256):
        for q_tile in chip_smoke.FLASH_TILES:
            assert plan_bf16(1, 4, 256, D, q_tile).q_tile == q_tile


def test_decode_bound_at_the_phase2_shape():
    """Decode attention's bound at the phase-2 shape: the live K/V rows
    (14,590 tokens x 2 KV heads x 128 x 2 bytes, twice) dominate, ~4.48 us
    at 3.35 TB/s; the same bytes on the CPU case as on the card's."""
    case = chip_smoke.make_case(chip_smoke.FULL, torch.bfloat16,
                                torch.Generator().manual_seed(0), "cpu")
    sheet = chip_smoke.card_datasheet("NVIDIA H100 80GB HBM3")
    ms, by = chip_smoke.decode_bound(case, sheet)
    assert by == "bytes" and ms == pytest.approx(0.0044831, rel=1e-4)


@pytest.mark.parametrize("rec,ok", [
    (dict(ms=0.05, device_ms=0.02, bound_ms=0.0175), True),
    (dict(ms=0.05, device_ms=0.0175, bound_ms=0.0175), True),
    (dict(ms=0.05, device_ms=0.015, bound_ms=0.0175), False),
    (dict(ms=0.01, device_ms=0.02, bound_ms=0.0175), False)])
def test_a_bound_share_over_100_percent_fails_the_run(rec, ok):
    if ok:
        chip_smoke.check_bound_shares({"k": rec})
    else:
        with pytest.raises(AssertionError, match="below its bound"):
            chip_smoke.check_bound_shares({"k": rec})


def test_decode_widths_cover_every_tensor_core_head_dim():
    from repro_torch.kernels.decode_attention.kernel import TC_HEAD_DIMS
    dims = {s["Dh"] for s in chip_smoke.DECODE_WIDTHS + (
        chip_smoke.FULL, chip_smoke.SMOKE, chip_smoke.GLM4_SMOKE)}
    assert set(TC_HEAD_DIMS) <= dims
    assert {s["G"] for s in chip_smoke.DECODE_WIDTHS} >= {1, 2, 6, 16}


def test_cluster_workloads():
    """Phase 5's programs: phase 3's turns (contexts up to ~2.2k tokens)
    in the cluster harness's skewed shape (three tenant preambles, storm
    and churn tools) and, for 5b, its diurnal wave."""
    for progs, n in ((chip_smoke.cluster_agent_programs(),
                      chip_smoke.CLUSTER_RUN["n"]),
                     (chip_smoke.elastic_agent_programs(),
                      chip_smoke.ELASTIC_RUN["n"])):
        assert len(progs) == n
        assert max(p.total_tokens() for p in progs) <= 2300
        assert len({p.shared_prefix_id for p in progs
                    if p.shared_prefix_id}) >= 2
        assert {t.tool for p in progs for t in p.turns if t.tool} >= \
            {"ls", "pytest"}
    cfg = chip_smoke.card_scaling_config()
    assert cfg.scale_up_eta_s < 0.1 and cfg.down_hold_s < 0.1


@pytest.mark.parametrize("elastic", [False, True])
def test_phase5_sizing_at_full_width(elastic):
    """Phase 5's legs on the logical stack at full qwen2-1.5b width under
    the H100 profile (what the card's physical legs must reproduce): a
    migration, and a migrated program reloaded on its destination; for
    the elastic fleet a scale-up and a prefill handoff."""
    import json
    from repro_torch.sim import replay
    cfg = get_config("qwen2-1.5b")
    hw = chip_smoke.hardware_profile("NVIDIA H100 80GB HBM3")
    if elastic:
        progs = chip_smoke.elastic_agent_programs()
        kw = dict(replicas=2, scaling=chip_smoke.card_scaling_config(),
                  prefill_replicas=1)
    else:
        progs = chip_smoke.cluster_agent_programs()
        kw = dict(replicas=3)
    lines, violations, cluster = replay.run_cluster_trace(
        progs, chip_smoke.replay_config(), cfg=cfg, hw=hw, **kw)
    assert violations == []
    st = cluster.stats
    assert st.migrations >= 1
    arrived, reloaded = {}, []
    for rec in map(json.loads, lines):
        if rec["ev"] == "migrate":
            arrived[rec["pid"]] = rec["dst"]
        elif rec["ev"] == "step":
            reloaded += [d[1] for d in rec["events"] if d[0] == "reload"
                         and arrived.get(d[1]) == rec["replica"]]
    assert reloaded
    if elastic:
        assert st.scale_ups >= 1 and st.prefill_handoffs >= 1
    # ~50 ms a host-bound step on the card: keep phase 5 near 30 s
    assert sum(e.steps for e in cluster.all_engines()) <= 400


@pytest.mark.parametrize("elastic", [False, True])
def test_cluster_legs_on_cpu(smoke, elastic):
    """Phase 5's driver at smoke width on the CPU: the physical leg equals
    the logical one, with every check the card's run makes except the
    non-vacuity ones, which hold at full width (the test above)."""
    cfg, hw, model = smoke
    st = chip_smoke.cluster_legs(cfg, hw, model, "cpu", elastic)
    assert st["steps"] > 0 and st["trace_lines"] > 0
    assert "pinned_num_host_alloc" not in st
    assert sum(r["stage_out_events"] for r in st["replicas"].values()) > 0
    if elastic:     # at smoke width the fixed fleet re-homes cold instead
        assert st["scale_ups"] >= 1 and st["prefill_handoffs"] >= 1
        assert st["cross_replica_restores"] >= 1
        assert sum(r["staging_checks"]
                   for r in st["replicas"].values()) > 0


def test_phase6_serve_sizing_at_full_width():
    """Phase 6a's programs on the logical stack at full qwen3-moe width,
    cut to ``MOE_DEPTH`` layers, under the H100 profile (what the card's
    physical leg must reproduce): pins, TTL hits, demotions, reloads and
    prefix hits, in few enough steps to keep phase 6 near a minute."""
    import dataclasses
    from repro_torch.sim import replay
    cfg = dataclasses.replace(get_config(chip_smoke.MOE_ARCH),
                              num_layers=chip_smoke.MOE_DEPTH)
    hw = chip_smoke.hardware_profile("NVIDIA H100 80GB HBM3")
    rc = chip_smoke.replay_config(cfg)
    assert rc.h2d_bw_blocks == pytest.approx(64e9 / (16 * 12288))
    _, eng = replay.run_engine(chip_smoke.agent_programs(), rc,
                               physical=False, cfg=cfg, hw=hw)
    st = eng.scheduler.stats
    assert st.pins > 0 and st.ttl_hits > 0 and st.prefix_hits > 0
    assert st.demotions > 0 and st.offload_reloads > 0
    assert eng.steps <= 200


def test_serve_moe_on_cpu():
    """Phase 6a's leg at qwen3-moe smoke width on the CPU: the
    physical leg equals the logical one with every check bit-exact, the
    padded prefill chunks drop copies and decode steps drop none."""
    cfg = get_config(chip_smoke.MOE_ARCH, smoke=True)
    hw = chip_smoke.hardware_profile("NVIDIA H100 80GB HBM3")
    st, counts = chip_smoke.serve_moe(cfg, hw, "cpu")
    assert st["decision_steps"] > 0 and st["engine_steps"] > 0
    assert st["staging_checks"] > 0 and st["copy_checks"] > 0
    assert st["dropped_copies_prefill"] > 0
    assert st["dropped_copies_decode"] == 0
    assert st["moe_dispatches"]["decode"] > 0
    assert set(counts) >= set(chip_smoke.PATH_A)


@pytest.mark.parametrize("arch", list(chip_smoke.FAMILY_DEPTHS))
def test_family_checks_on_cpu(arch):
    """Phase 6b's checks at smoke width on the CPU, with their bounds."""
    checks = chip_smoke.family_checks(get_config(arch, smoke=True), "cpu")
    chip_smoke.assert_family_checks(checks)
    assert ("paged_vs_forward" in checks) == \
        (arch in chip_smoke.FAMILY_PAGED)
    assert ("embeds_vs_tokens" in checks) == (arch == "pixtral-12b")


# ------------------------------------------------ phase 7 (path E) on CPU
#: smoke-width stand-ins for phase 7's legs: gemma2's prompt past its
#: 32-token window (the split path's prefill wraps the ring, its decode
#: steps cross it), zamba2's not a whole number of 16-token SSD chunks
PATH_E_SMOKE = {"gemma2-9b": dict(prompt=48, depths=(2, 4)),
                "zamba2-2.7b": dict(prompt=40, depths=(2, 4))}


@pytest.mark.parametrize("arch", list(PATH_E_SMOKE))
def test_cut_model_takes_whole_pairs_and_groups(arch):
    """``cut_model`` slices gemma2's pair stack and zamba2's group stack
    by blocks of layers (zamba2 keeps its shared blocks), and refuses a
    depth that splits a block."""
    cfg = get_config(arch, smoke=True)
    params = dict(Model(cfg, device="cpu", seed=0).params)
    per = chip_smoke.layers_per_block(cfg)
    assert per == 2
    cut = chip_smoke.cut_model(params, cfg, per, "float32", "cpu")
    assert cut.cfg.num_layers == per and len(cut.layers) == per
    for name, t in cut.params.items():
        want = params[name][:1] if name.startswith("blocks.") \
            else params[name]
        assert torch.equal(t, want.float()), name
    with pytest.raises(ValueError, match="whole number"):
        chip_smoke.cut_model(params, cfg, per + 1, "float32", "cpu")


def test_plain_prefill_attention_swaps_both_paths():
    """Within the block, causal and windowed prefill attention are the
    flash plain version (with the window); after it, the model's own."""
    from repro_torch.models import attention
    before = attention.attend_causal, attention.attend_windowed
    q = torch.randn(1, 40, 4, 16, generator=torch.Generator().manual_seed(0))
    k, v = q[:, :, :2], q[:, :, 2:]
    want = attention.attend_windowed(q, k, v, scale=0.25, window=8, cap=5.0)
    with chip_smoke.plain_prefill_attention():
        assert attention.attend_windowed is not before[1]
        assert attention.attend_causal is attention.attend_windowed
        got = attention.attend_windowed(q, k, v, scale=0.25, window=8,
                                        cap=5.0)
    assert (attention.attend_causal, attention.attend_windowed) == before
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", list(PATH_E_SMOKE))
def test_path_e_checks_on_cpu(arch):
    """Phase 7b / 7d's checks at smoke width on the CPU, with their
    bounds, and 7a / 7c's timed prefill and decode."""
    import dataclasses
    cfg = get_config(arch, smoke=True)
    run = PATH_E_SMOKE[arch]
    params = dict(Model(dataclasses.replace(cfg, compute_dtype="float32"),
                        device="cpu", seed=0).params)
    for depth in run["depths"]:
        checks = chip_smoke.path_e_checks(params, cfg, depth, run["prompt"],
                                          chip_smoke.PATH_E_TAIL // 8, "cpu")
        assert set(checks) == {"prefill_vs_decode", "kernel_vs_plain"}
        chip_smoke.assert_path_e_checks(checks)
    model = Model(cfg, device="cpu", seed=0)
    toks = torch.randint(0, cfg.vocab_size, (2, run["prompt"]),
                         generator=torch.Generator().manual_seed(2))
    rates = chip_smoke.forward_throughput(model, toks, n_dec=3,
                                          max_len=run["prompt"] + 3)
    assert rates["batch"] == 2 and rates["decode_step_ms"] > 0


def test_path_e_legs_at_full_width():
    """Phase 7's legs at the published configs: the flash launches a
    prefill it asserts, the cut depths whole blocks, gemma2's prompt past
    its window and into a cache whose local layers are rings."""
    from repro_torch.configs import get_config as cfg_of
    for leg, run in chip_smoke.PATH_E.items():
        cfg = cfg_of(run["arch"])
        per = chip_smoke.layers_per_block(cfg)
        assert run["flash"] == (cfg.num_layers if per == 2
                                else cfg.num_layers // per)
        assert all(d % per == 0 for d in run["depths"])
        assert run["prompt"] % 64 and run["max_len"] >= \
            run["prompt"] + chip_smoke.PATH_E_DECODE
    gemma = cfg_of("gemma2-9b")
    assert chip_smoke.PATH_E["7a"]["prompt"] - chip_smoke.PATH_E_TAIL > \
        gemma.sliding_window


# ------------------------------------------------ phase 8 (path F) on CPU
def test_path_f_sizing_at_full_width():
    """8a's shape is train_4k's row with its global batch cut (and one row
    a microbatch at qwen2-1.5b's train_microbatches); 8b's cut keeps
    whole layers."""
    from repro_torch.configs.base import SHAPES
    cfg = get_config(chip_smoke.TRAIN_F["arch"])
    full = SHAPES["train_4k"]
    assert chip_smoke.TRAIN_F["seq"] == full.seq_len
    assert chip_smoke.TRAIN_F["full_batch"] == full.global_batch
    assert chip_smoke.TRAIN_F["batch"] == cfg.train_microbatches == 2
    assert cfg.remat == "full" and cfg.compute_dtype == "bfloat16"
    assert chip_smoke.TRAIN_CHECK["layers"] < cfg.num_layers


def test_train_steps_on_cpu(tmp_path):
    """Phase 8a's loop at smoke width: a warm-up step and timed ones, each
    record with its rates, no kernel launched; a flat history fails the
    check (the smoke model's losses fall over tens of steps, the
    full-width model's on the card within its ten)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import launch_counts
    cfg = get_config("qwen2-1.5b", smoke=True)
    recs = chip_smoke.train_steps(cfg, ShapeSpec("t", "train", 64, 2), 3,
                                  "cpu", tmp_path, peak_flops=989e12)
    assert [r["step"] for r in recs] == [1, 2, 3, 4]
    for r in recs:
        assert r["step_ms"] > 0 and r["wall_ms"] >= r["step_ms"]
        assert r["tokens_per_s"] > 0 and 0 < r["flops_share"] < 1
    assert all(math.isfinite(r["loss"]) for r in recs)
    assert not any(launch_counts().values())
    chip_smoke.assert_training([dict(r, loss=5.0 - i)
                                for i, r in enumerate(recs)])
    with pytest.raises(AssertionError):
        chip_smoke.assert_training([dict(r, loss=1.0) for r in recs])


def test_card_vs_cpu_on_cpu(tmp_path):
    """Phase 8b's legs at smoke width with the CPU on both sides: equal
    histories, and the resumed step 2 equal to the uninterrupted one."""
    gaps = chip_smoke.card_vs_cpu(get_config("qwen2-1.5b", smoke=True),
                                  "cpu", tmp_path,
                                  **chip_smoke.TRAIN_CHECK)
    assert len(gaps["losses"]) == chip_smoke.TRAIN_CHECK["steps"]
    assert max(gaps["loss_gaps"] + gaps["grad_norm_gaps"]) == 0
    chip_smoke.assert_card_vs_cpu(gaps)


def test_roofline_checks_at_full_width():
    """Phase 8c off the card: full qwen2-1.5b counted on the meta device
    within 2x of the analytic profile, 3a-like steps priced by both, and
    the roofline-priced engine pinning under the H100's profile."""
    from repro_torch.serving.profiler import StepSample
    hw = chip_smoke.hardware_profile("NVIDIA H100 80GB HBM3")
    samples = [StepSample(0.06, 512, 0, 0, 0),
               StepSample(0.045, 0, 0, 4, 2048),
               StepSample(0.07, 512, 1024, 2, 900)]
    checks = chip_smoke.roofline_checks(get_config("qwen2-1.5b"), hw,
                                        samples)
    chip_smoke.assert_roofline(checks)
    assert checks["prefill"]["steps"] == checks["decode"]["steps"] == 1
    assert checks["prefill"]["measured_over_roofline"] > 0


PHASE9_CPU = """
import json, sys, tempfile, warnings
warnings.filterwarnings("ignore")
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
import chip_smoke
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh
chip_smoke.init_group("gloo", "cpu")
mesh = make_host_mesh()
assert tuple(mesh.shape) == (1, 1)
cfg = get_config("qwen2-1.5b", smoke=True)
out = {"serve": chip_smoke.sharded_serving(cfg, mesh, "cpu", 2, 16, 4)}
with tempfile.TemporaryDirectory() as tmp:
    out["train"] = chip_smoke.sharded_training(
        cfg, make_host_mesh, "cpu", tmp, layers=2, seq=32, batch=2,
        steps=chip_smoke.PATH_G_TRAIN["steps"])
out["moe"] = chip_smoke.a2a_vs_grouped(
    get_config("qwen3-moe-235b-a22b", smoke=True), mesh, "cpu", 2, 16)
with tempfile.TemporaryDirectory() as tmp:
    out["dryrun"] = chip_smoke.dryrun_cells(
        (("qwen2-1.5b", "decode_32k", False),), tmp, smoke=True)
torch.distributed.destroy_process_group()
print(json.dumps(out))
"""


def test_phase9_on_cpu_gloo():
    """Phase 9 (path G) off the card: its functions on a one-rank gloo
    group with the CPU as the device, at smoke width (the card runs 9a-c
    at full width on NCCL, 9d at full width): the sharded serving legs
    bit-equal to the meshless ones, the sharded trainer's step 1 equal and
    its remesh going on, the all-to-all layer against the grouped one and
    a smoke dry-run cell, each through the phase's own checks (the flash
    kernel does not run on the CPU, so 9a's launches are 0 here)."""
    import json
    import os
    import subprocess
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", PHASE9_CPU, str(ROOT)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    serve = out["serve"]
    assert serve["tokens_equal"] and serve["logits_bit_equal"], serve
    assert not any(serve["launches"].values()), serve
    chip_smoke.assert_sharded_training(out["train"])
    assert out["train"]["loss_gap"] == 0, out["train"]
    chip_smoke.assert_a2a(out["moe"])
    assert out["moe"]["bit_equal"], out["moe"]
    chip_smoke.assert_dryrun(out["dryrun"])
    assert chip_smoke.PATH_G_DRYRUN[-1] == ("qwen3-moe-235b-a22b",
                                            "train_4k", True)
