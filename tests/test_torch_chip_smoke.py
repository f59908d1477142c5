"""``chip_smoke.py`` off the card: it refuses to run without CUDA, its
datasheet table and workload are what its docstrings say, and its two
serve legs run end to end on the CPU at smoke width (the card runs them
at full qwen2-1.5b width)."""
import dataclasses
import json
import math
import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import kernel_wrappers  # noqa: E402
from repro_torch.kernels.fusions import gated_act_ref  # noqa: E402
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


@pytest.mark.parametrize("graphs", [False, True])
def test_serve_pair_leg_on_cpu(smoke, graphs):
    """Phase 3's paired 3b leg, eager or on the bucket buffers: every
    program finishes, nothing is captured on the CPU, and no kernel
    launches."""
    leg = chip_smoke.serve_pair_leg(*smoke, "cpu", graphs)
    assert leg["cuda_graphs"] is graphs and leg["steps"] > 0
    assert 0 < leg["avg_jct_s"] <= leg["p90_jct_s"] and leg["busy_s"] > 0
    assert leg["captures"] == leg["replays"] == 0 == leg["capture_s"]
    assert leg["prefill_captures"] == leg["prefill_replays"] == 0
    assert leg["prefill_buckets"] > 0 and leg["graph_pool_bytes"] is None
    assert set(leg["launches"]) == set(kernel_wrappers())
    assert sum(leg["launches"].values()) == 0


@pytest.mark.parametrize("ops", ["PREFILL_OPS", "MOE_PREFILL_OPS"])
def test_prefill_schedules_cover_the_cases(ops):
    """Phase 3d's and 6a's chunk schedules, walked on the host: a fresh
    chunked prompt, every extend bucket used at least three times (eager,
    captured, replayed), S = 1 and S = Sp, mid-page and page-aligned
    starts, a twin whose shared last page the next extend COW-splits."""
    from repro_torch.serving.prefill_graph import capacity
    lengths, uses, twins = {}, {}, 0
    for op in getattr(chip_smoke, ops):
        if op[0] == "twin":
            lengths[op[1]] = lengths[op[2]]
            twins += 1
            continue
        pid, n, pad = op
        start = lengths.get(pid, 0)
        assert n <= pad
        key = ("extend" if start else "prefill", pad, capacity(start, pad))
        uses[key] = uses.get(key, 0) + 1
        lengths[pid] = start + n
    assert twins == 1 and uses[max(uses)] >= 3
    assert sum(n >= 3 for n in uses.values()) >= 4
    assert {k[1] for k in uses if k[0] == "extend"} >= {16, 32} or \
        {k[1] for k in uses if k[0] == "extend"} >= {16, 64, 256}


def test_prefill_graph_vs_eager_on_cpu(smoke):
    """Phase 3d at smoke width on the CPU (6a's schedule, whose prompts
    fit a smoke model's context): both legs on the bucket buffers, equal
    bit for bit, a COW split in each, nothing captured or launched."""
    check = chip_smoke.prefill_graph_vs_eager(smoke[2], "cpu",
                                              chip_smoke.MOE_PREFILL_OPS)
    chip_smoke.assert_prefill_graph_vs_eager(check, cuda=False)
    assert check["chunks"] == 15 and check["to_capture"] == 4
    assert "capture_cost" not in check


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
    pair = chip_smoke.decode_pair(m16, toks, 4)
    chip_smoke.assert_decode_pair(pair, cuda=False)
    assert pair["steps"] == chip_smoke.DECODE_WARM + 4
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
    pair = chip_smoke.decode_pair(model, toks, 3)
    chip_smoke.assert_decode_pair(pair, cuda=False)
    assert pair["max_len"] == run["prompt"] + chip_smoke.decode_positions(3)
    legs = pair["legs"]
    assert legs["graph"]["cuda_graphs"] and not legs["eager"]["cuda_graphs"]
    assert "device_ms" not in legs["graph"]      # traced on the card only


@pytest.mark.parametrize("broken", ["logits_bit_equal", "caches_bit_equal",
                                    "captures", "replays",
                                    "host_launch_calls"])
def test_decode_pair_check_fails_on_a_fault(broken):
    """The phase 4 / 7 pair check: bit equality of the logits and caches,
    one capture, a replay on every later step, at most 10 host launch
    calls a replay; each fault fails it."""
    def leg(graphs):
        return dict(cuda_graphs=graphs, captures=int(graphs),
                    replays=36 if graphs else 0, host_launch_calls=5
                    if graphs else 5016)

    check = dict(logits_bit_equal=True, tokens_equal=True,
                 caches_bit_equal=True, finite=True, steps=37,
                 legs={"graph": leg(True), "eager": leg(False)})
    chip_smoke.assert_decode_pair(check, cuda=True)
    if broken in check:
        check[broken] = False
    else:
        check["legs"]["graph"][broken] = {"captures": 2, "replays": 35,
                                          "host_launch_calls": 11}[broken]
    with pytest.raises(AssertionError):
        chip_smoke.assert_decode_pair(check, cuda=True)


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
            run["prompt"] + chip_smoke.decode_positions(
                chip_smoke.PATH_E_DECODE)
    gemma = cfg_of("gemma2-9b")
    assert chip_smoke.PATH_E["7a"]["prompt"] - chip_smoke.PATH_E_TAIL > \
        gemma.sliding_window


# ------------------------------------------------ phase 8 (path F) on CPU
def test_path_f_sizing_at_full_width():
    """8a's shape is train_4k's row with its global batch cut (and one row
    a microbatch at qwen2-1.5b's train_microbatches); 8b's cuts keep
    whole layers, the equality legs 8a's shape and a replay after the
    graph's warm-up and capture."""
    from repro_torch.configs.base import SHAPES
    cfg = get_config(chip_smoke.TRAIN_F["arch"])
    full = SHAPES["train_4k"]
    assert chip_smoke.TRAIN_F["seq"] == full.seq_len
    assert chip_smoke.TRAIN_F["full_batch"] == full.global_batch
    assert chip_smoke.TRAIN_F["batch"] == cfg.train_microbatches == 2
    assert cfg.remat == "full" and cfg.compute_dtype == "bfloat16"
    assert chip_smoke.TRAIN_CHECK["layers"] < cfg.num_layers
    eq = chip_smoke.TRAIN_EQUAL
    assert eq["layers"] == chip_smoke.TRAIN_CHECK["layers"]
    assert (eq["seq"], eq["batch"]) == (chip_smoke.TRAIN_F["seq"],
                                        chip_smoke.TRAIN_F["batch"])
    assert eq["steps"] == chip_smoke.warm_steps(True) + 1


def test_train_steps_on_cpu(tmp_path):
    """Phase 8a's graph leg at smoke width: its warm-up, the step that
    captures on the card and timed steps, each record with its rates, no
    kernel launched, nothing captured on the CPU; a flat history fails
    the check (the smoke model's losses fall over tens of steps, the
    full-width model's on the card within its ten)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import launch_counts
    cfg = get_config("qwen2-1.5b", smoke=True)
    leg = chip_smoke.train_leg(cfg, ShapeSpec("t", "train", 64, 2), 3,
                               "cpu", tmp_path, peak_flops=989e12)
    recs = leg["records"]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    assert [r["kind"] for r in recs] == ["warm-up", "capture"] + \
        ["timed"] * 3
    for r in recs:
        assert r["step_ms"] > 0 and r["wall_ms"] >= r["step_ms"]
        assert 0 < r["enqueue_ms"] <= r["step_ms"]
        assert r["tokens_per_s"] > 0 and 0 < r["flops_share"] < 1
    assert all(math.isfinite(r["loss"]) for r in recs)
    assert leg["captures"] == leg["replays"] == 0 == leg["capture_s"]
    assert leg["graph_pool_bytes"] is None and leg["trace"] is None
    assert not any(launch_counts().values())
    chip_smoke.assert_training([dict(r, loss=5.0 - i)
                                for i, r in enumerate(recs)])
    with pytest.raises(AssertionError):
        chip_smoke.assert_training([dict(r, loss=1.0) for r in recs])


def test_train_legs_pair_on_cpu(tmp_path):
    """Phase 8a's two legs from one init on one schedule: the eager leg's
    losses are the graph leg's first ones, bit for bit; each leg's
    summary has its medians over the timed steps."""
    from repro_torch.configs.base import ShapeSpec
    cfg = get_config("qwen2-1.5b", smoke=True)
    shape = ShapeSpec("t", "train", 64, 2)
    legs = {g: chip_smoke.train_leg(cfg, shape, n, "cpu", tmp_path / str(g),
                                    cuda_graphs=g, total=6)
            for g, n in ((True, 3), (False, 2))}
    losses = {g: [r["loss"] for r in leg["records"]]
              for g, leg in legs.items()}
    assert len(losses[False]) == 3 and losses[True][:3] == losses[False]
    assert [r["kind"] for r in legs[False]["records"]] == \
        ["warm-up", "timed", "timed"]
    for g, leg in legs.items():
        summary = chip_smoke.leg_summary(leg)
        assert summary["cuda_graphs"] is g and summary["timed_steps"] == \
            (3 if g else 2)
        assert summary["min_step_ms"] <= summary["median_step_ms"] <= \
            summary["max_step_ms"]
        assert summary["last_loss"] == losses[g][-1]


def test_graph_vs_eager_training_on_cpu(tmp_path):
    """Phase 8b's equality legs at smoke width (two microbatches, remat)
    on the CPU: the eager legs and the graph path's equal bit for bit."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              train_microbatches=2)
    assert cfg.remat == "full"
    check = chip_smoke.graph_vs_eager_training(cfg, "cpu", tmp_path,
                                               layers=2, seq=64, batch=2,
                                               steps=3)
    chip_smoke.assert_graph_vs_eager_training(check)
    assert len(check["losses"]) == 3
    assert check["graph"]["n_differing"] == 0 == check["graph"]["max_abs"]
    bad = dict(check, graph=dict(check["graph"], bit_equal=False))
    with pytest.raises(AssertionError):
        chip_smoke.assert_graph_vs_eager_training(bad)


def fake_leg(kernels: float, calls: float, graphs: bool) -> dict:
    """An 8a leg as ``assert_train_pair`` reads it: falling losses, its
    trace's device ops and host launch calls."""
    recs = [dict(loss=5.0 - i) for i in range(5)]
    return dict(records=recs, captures=int(graphs), replays=3 * graphs,
                trace=dict(device_kernels_per_step=kernels,
                           host_launch_calls_per_step=calls,
                           kernel_counts={"k": kernels}))


@pytest.mark.parametrize("graph,eager,ok", [
    ((90604.0, 8.0), (90604.0, 90604.0), True),
    ((90604.0, 8.0), (90586.0, 90604.0), True),      # ops lost by traces
    ((90704.0, 8.0), (90604.0, 90604.0), False),     # 100 nodes too many
    ((90504.0, 8.0), (90604.0, 90604.0), False),     # 100 too few
    ((90604.0, 10.0), (90604.0, 90604.0), False)])   # host launches
def test_train_pair_check(graph, eager, ok):
    """8a's pair check: the replay runs the eager step's device ops (each
    leg's own ops at the step's ends set apart, and the few a one-step
    trace loses) with under 10 host launch calls."""
    g, e = fake_leg(*graph, True), fake_leg(*eager, False)
    if ok:
        chip_smoke.assert_train_pair(g, e)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.assert_train_pair(g, e)


@pytest.mark.parametrize("phase", ["8a", "8b equal", "8b card vs cpu"])
def test_a_capture_failure_is_not_caught(tmp_path, monkeypatch, phase):
    """Phase 8's legs let a failing graph step (a capture that raises)
    through: nothing falls back to the eager step."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train.train_graph import TrainGraph

    def fails(self, *args):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(TrainGraph, "step", fails)
    cfg = get_config("qwen2-1.5b", smoke=True)
    run = {"8a": lambda: chip_smoke.train_leg(
               cfg, ShapeSpec("t", "train", 64, 2), 1, "cpu", tmp_path),
           "8b equal": lambda: chip_smoke.graph_vs_eager_training(
               cfg, "cpu", tmp_path, layers=2, seq=64, batch=2, steps=2),
           "8b card vs cpu": lambda: chip_smoke.card_vs_cpu(
               cfg, "cpu", tmp_path, **chip_smoke.TRAIN_CHECK)}[phase]
    with pytest.raises(RuntimeError, match="capture failed"):
        run()


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
from repro_torch.launch.mesh import make_host_mesh, one_rank_group
one_rank_group("cpu")
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
# 9e: the trainer's graph path against the eager sharded step (two
# microbatches in (i), as the config's at full width)
import dataclasses
with tempfile.TemporaryDirectory() as tmp:
    out["train_legs"] = chip_smoke.sharded_train_legs(
        dataclasses.replace(cfg, train_microbatches=2), mesh, "cpu", tmp,
        seq=32, batch=2, steps=chip_smoke.PATH_G_TRAIN_GRAPH["steps"],
        eager_steps=chip_smoke.PATH_G_TRAIN_GRAPH["eager_steps"])
with tempfile.TemporaryDirectory() as tmp:
    out["train_pair"] = chip_smoke.sharded_train_pair(
        cfg, mesh, "cpu", tmp, layers=2, seq=32, batch=1,
        steps=chip_smoke.PATH_G_TRAIN_EQUAL["steps"])
with tempfile.TemporaryDirectory() as tmp:
    out["dryrun"] = chip_smoke.dryrun_cells(
        (("qwen2-1.5b", "decode_32k", False),), tmp, smoke=True)
torch.distributed.destroy_process_group()
# profile_step --mesh opens its own one-rank group
import contextlib, io
from repro_torch.launch import profile_step
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    profile_step.main(["--mesh", "--device", "cpu", "--smoke", "--batch",
                       "1", "--context", "16", "--steps", "2"])
out["profile"] = json.loads(buf.getvalue())
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    profile_step.main(["--train", "--mesh", "--device", "cpu", "--smoke",
                       "--batch", "2", "--context", "16", "--steps", "2"])
out["train_profile"] = json.loads(buf.getvalue())
print(json.dumps(out))
"""


def test_phase9_on_cpu_gloo():
    """Phase 9 (path G) off the card: its functions on a one-rank gloo
    group with the CPU as the device, at smoke width (the card runs 9a-c
    at full width on NCCL, 9d at full width): the sharded serving legs
    bit-equal to the meshless ones, the sharded trainer's step 1 equal and
    its remesh going on, the all-to-all layer against the grouped one and
    a smoke dry-run cell, 9e's graph-path trainer against the eager
    sharded one (two microbatches; then the 2-layer pair, bit for bit,
    and its step 1 equal to the meshless trainer's), each through the
    phase's own checks; then
    ``profile_step --mesh`` and ``--train --mesh`` at smoke width, each
    on its own one-rank group: their keys (the sharded trainer's DTensor
    dispatches counted, the meshless one's none), and no host number
    under a device metric's name (the flash
    kernel does not run on the CPU, so 9a's launches are 0 here, and the
    sharded graph leg runs its bucket eagerly: nothing captured)."""
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
    chip_smoke.assert_sharded_serving(serve, cuda=False)
    assert serve["graph_replays"] == 0, serve
    chip_smoke.assert_sharded_training(out["train"])
    assert out["train"]["loss_gap"] == 0, out["train"]
    legs = out["train_legs"]
    chip_smoke.assert_sharded_train_legs(legs, cuda=False)
    assert [r["kind"] for r in legs["graph"]["records"]] == \
        ["warm-up", "capture", "timed", "timed"], legs["graph"]
    assert [r["kind"] for r in legs["eager"]["records"]] == \
        ["warm-up", "timed", "timed"], legs["eager"]
    assert legs["graph"]["captures"] == 0 == legs["eager"]["captures"]
    pair = out["train_pair"]
    chip_smoke.assert_sharded_train_pair(pair)
    assert pair["loss_gap"] == 0 == pair["grad_norm_gap"], pair
    assert pair["graph"]["n_differing"] == 0, pair
    chip_smoke.assert_a2a(out["moe"])
    assert out["moe"]["bit_equal"], out["moe"]
    chip_smoke.assert_dryrun(out["dryrun"])
    assert chip_smoke.PATH_G_DRYRUN[-1] == ("qwen3-moe-235b-a22b",
                                            "train_4k", True)
    prof = out["profile"]
    assert prof["mesh"] == [1, 1] and prof["backend"] == "gloo", prof
    assert prof["decode_step"] == "cuda_graph", prof
    for leg in ("decode", "decode_meshless", "prefill"):
        rec = prof[leg]
        assert rec["wall_ms_median"] > 0 and rec["enqueue_ms_median"] > 0
        # no card: the device metrics are null, never host numbers
        assert all(rec[k] is None for k in (
            "device_busy_ms_per_step", "device_busy_share",
            "device_kernels_per_step", "host_launch_calls_per_step")), rec
    split = prof["decode"]["host_split"]
    assert set(split) == {f"{k}_ms_per_step" for k in (
        "offsets", "write_piece", "kv_for", "step")}, split
    # no offset read on the host is left; a bucket's step writes and
    # finds its heads inside the step it times
    assert split["offsets_ms_per_step"] == 0, split
    assert 0 < split["write_piece_ms_per_step"] < \
        split["step_ms_per_step"], split
    graph = prof["sharded_graph"]
    assert graph["captures"] == 0 and graph["replays"] == 0, graph
    # profile_step --train --mesh: the sharded trainer (its graph path,
    # DTensor dispatches counted) beside the meshless one
    train = out["train_profile"]
    assert train["mesh"] == [1, 1] and train["backend"] == "gloo", train
    assert train["device"] == "cpu" and train["train_step"] == "cuda_graph"
    sharded, meshless = train["train"], train["train_meshless"]["train"]
    assert train["train_meshless"]["train_step"] == "cuda_graph"
    assert sharded["python_subclass_dispatches_per_step"] > 0, sharded
    assert meshless["python_subclass_dispatches_per_step"] == 0, meshless
    for rec in (sharded, meshless):
        assert rec["wall_ms_median"] > 0 and rec["enqueue_ms_median"] > 0
        assert all(rec[k] is None for k in (
            "device_busy_ms_per_step", "device_busy_share",
            "device_kernels_per_step", "host_launch_calls_per_step")), rec
    # nothing captured on the CPU, and no device memory reported
    assert train["capture_s"] == 0 and train["graph_pool_bytes"] is None
    assert "max_memory_allocated" not in train, train


#: path F's graph pool, full-depth qwen2-1.5b at B 2 x 4096 (twice 9e(i)'s
#: tokens) on the H100 (PERF.md section 5)
PATH_F_POOL_BYTES = 30.5e9


def test_path_g_train_sizing_at_full_width():
    """9e(i)'s shape is 8a's 4096-token row halved, one row a microbatch
    at qwen2-1.5b's two; each leg runs steps 1-4 (the graph's warm-up,
    capture and replays before its traced step; the eager leg's warm-up
    and timed steps, its traced step the fourth). The fp32 masters, two
    moments, a microbatch's grads and their accumulator, with a graph
    pool no larger than path F's at twice the tokens, fit the card's 80
    GB. 9e(ii) is 9b's cut, run for four steps."""
    cfg = get_config(chip_smoke.PATH_G["arch"])
    g = chip_smoke.PATH_G_TRAIN_GRAPH
    assert g["batch"] == cfg.train_microbatches == \
        chip_smoke.TRAIN_F["batch"]
    assert 2 * g["seq"] == chip_smoke.TRAIN_F["seq"]
    assert cfg.remat == "full" and cfg.compute_dtype == "bfloat16"
    assert chip_smoke.warm_steps(True) + g["steps"] == 4 == \
        chip_smoke.warm_steps(False) + g["eager_steps"] + 1
    assert cfg.opt_state_dtype == "float32"
    state_bytes = 5 * 4 * cfg.param_count()
    assert state_bytes + PATH_F_POOL_BYTES < 80e9, state_bytes
    eq = chip_smoke.PATH_G_TRAIN_EQUAL
    assert {k: v for k, v in eq.items() if k != "steps"} == \
        {k: v for k, v in chip_smoke.PATH_G_TRAIN.items() if k != "steps"}
    assert eq["steps"] == chip_smoke.warm_steps(True) + 2


@pytest.fixture
def gloo_mesh():
    """A (1, 1) mesh over a one-rank gloo group in this process."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh, one_rank_group
    one_rank_group("cpu")
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("part", ["9e(i)", "9e(ii)"])
def test_a_mesh_capture_failure_is_not_caught(tmp_path, monkeypatch,
                                              gloo_mesh, part):
    """Phase 9e's legs let a failing graph step on the mesh (a capture
    that raises) through: nothing falls back to the eager sharded
    step."""
    from repro_torch.train.train_graph import TrainGraph

    def fails(self, *args):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(TrainGraph, "step", fails)
    cfg = get_config("qwen2-1.5b", smoke=True)
    run = {"9e(i)": lambda: chip_smoke.sharded_train_legs(
               cfg, gloo_mesh, "cpu", tmp_path, seq=32, batch=2, steps=1,
               eager_steps=1),
           "9e(ii)": lambda: chip_smoke.sharded_train_pair(
               cfg, gloo_mesh, "cpu", tmp_path, layers=2, seq=32, batch=1,
               steps=2)}[part]
    with pytest.raises(RuntimeError, match="capture failed"):
        run()


# ------------------------------------------- phase 2's fusions, phase 3's
def plain_fusions(broken: str | None = None) -> dict:
    """The four fusions' plain versions standing in for their kernels,
    ``broken``'s output moved off its plain version's."""
    kernels = {name: (ref, ref)
               for name, (_, ref) in chip_smoke.fusion_kernels().items()}
    gate_up = kernels["gate_up_act"][1]

    def rowwise(x, w1, w3, activation):
        # the CPU's bf16 product depends on the row count (P3); the kernel
        # it stands in for does not: a row at a time
        return torch.cat([gate_up(x[i:i + 1], w1, w3, activation)
                          for i in range(x.shape[0])])

    kernels["gate_up_act"] = (rowwise, rowwise)
    qkv = kernels["qkv_proj"][1]

    def qkv_rowwise(x, wq, wk, wv, *, k_out, v_out, rope=None, **chain):
        # a row at a time for the same reason
        q = [qkv(x[i:i + 1], wq, wk, wv, k_out=k_out[i:i + 1],
                 v_out=v_out[i:i + 1], **chain,
                 rope=None if rope is None else
                 tuple(t[i:i + 1] for t in rope))
             for i in range(x.shape[0])]
        return torch.cat(q)

    kernels["qkv_proj"] = (qkv_rowwise, qkv_rowwise)
    if broken is not None:
        ref = kernels[broken][1]

        def off(*args, **kw):
            out = ref(*args, **kw)
            last = out[-1] if isinstance(out, tuple) else out
            flat = last.view(-1)
            flat[0] = flat[0] * 1.5 + 1.0      # many ulps away
            return out

        kernels[broken] = (off, ref)
    return kernels


@pytest.fixture
def small_fusion_checks(monkeypatch):
    """Phase 2's fusion checks cut for the CPU: two published widths
    (qwen2's bias, qwen3-moe's qk norm), rows 1 and 4, smoke pools."""
    monkeypatch.setattr(chip_smoke, "FUSION_ARCHS",
                        ("qwen2-1.5b", "qwen3-moe-235b-a22b"))
    monkeypatch.setattr(chip_smoke, "FUSION_ROWS", (1, 4))
    monkeypatch.setattr(chip_smoke, "GATE_UP_ROWS", (1, 4, 16))
    monkeypatch.setattr(chip_smoke, "QKV_ROWS", (1, 4, 16))
    monkeypatch.setattr(chip_smoke, "FUSION_MERGE_CASES",
                        (("SMOKE", "bfloat16", 1),
                         ("GLM4_SMOKE", "float32", 1)))


def test_fusion_checks_on_cpu(small_fusion_checks, capsys):
    """Phase 2's checks of the fusions and of the new token's merge run
    end to end (the plain versions standing in for the kernels): each a
    record, the activation over every finite bf16 gate, the gate/up
    product within its bound at each width."""
    recs = chip_smoke.check_fusions(torch.Generator().manual_seed(0), None,
                                    "cpu", plain_fusions())
    assert set(chip_smoke.FUSIONS) == {
        "rms_norm", "qkv_rope", "gated_act", "gate_up_act", "qkv_proj"}
    assert set(recs) == set(chip_smoke.FUSIONS) | {"decode_merge"}
    assert all(r["max_abs_err"] == 0 for r in recs.values())
    out = capsys.readouterr().out
    assert "'finite_bf16_gates': 65280" in out
    for name in (*chip_smoke.FUSIONS, "decode_merge"):
        assert f"phase2 {name}" in out


def _fp32_norm_moved_by(ulps: int):
    """The plain norm with every fp32 output moved ``ulps`` ulps away
    from the float64 norm of its input (on the far side of it)."""
    ref = chip_smoke.fusion_kernels()["rms_norm"][1]

    def moved(x, scale, eps, delta=None, fp32_sum=False):
        out = ref(x, scale, eps, delta, fp32_sum)
        inp, h = (out if delta is not None else (x, out))
        if h.dtype != torch.float32:
            return out
        exact = chip_smoke.norm_exact(inp, scale, eps)
        bits = exact.view(torch.int32)
        step = torch.where(exact >= 0, ulps, -ulps).to(torch.int32)
        far = (bits + step).view(torch.float32)
        return (out[0], far) if delta is not None else far

    return moved


@pytest.mark.parametrize("shift,passes", [(0, True), (None, True),
                                          (1, False)])
def test_fp32_norm_bound_is_the_kernel_order(shift, passes):
    """P15: phase 2 holds the fp32 norm within ``norm_fp32_ulps`` of the
    float64 norm on each seed: an output at the bound passes (0: the
    float64 norm itself; None: exactly the bound away), one ulp past it
    fails; the bound grows with the kernel's summation chain."""
    cfg = get_config("qwen2-1.5b")
    bound = chip_smoke.norm_fp32_ulps(cfg.d_model)
    ulps = {0: 0, None: bound, 1: bound + 1}[shift]
    kern = _fp32_norm_moved_by(ulps)
    ref = chip_smoke.fusion_kernels()["rms_norm"][1]
    run = lambda: chip_smoke.check_fusion_norms(       # noqa: E731
        cfg, 4, torch.float32, "cpu", {"rms_norm": (kern, ref)})
    if passes:
        gap = run()
        assert gap["float64"]["max_ulps"] == ulps
        assert gap["float64"]["bound_ulps"] == bound
    else:
        with pytest.raises(AssertionError):
            run()
    # a row of 64 chunks is one warp's (chain 4 x 2 + 5), 384 chunks one
    # thread a chunk over 12 warps (chain 4 + 5 + 11)
    assert chip_smoke.norm_fp32_ulps(256) == math.ceil((1 + 7 + 5 + 3)
                                                       / 2) + 8
    assert chip_smoke.norm_fp32_ulps(1536) == math.ceil((1 + 3 + 5 + 11
                                                         + 3) / 2) + 8


@pytest.fixture
def fake_card(monkeypatch):
    """``chip_smoke.main`` on the CPU: a card that reports itself, no
    build; each phase is the test's to replace."""
    import subprocess
    from repro_torch.kernels import _build
    name = "NVIDIA H100 80GB HBM3"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: name)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: type(
        "Done", (), {"stdout": f"{name}, 700.00 W\n"})())
    monkeypatch.setattr(_build, "build_all", lambda: {
        "flash_attention": pathlib.Path("lib")})
    monkeypatch.setattr(_build, "build_log", lambda lib: "")
    monkeypatch.setattr(chip_smoke, "check_hgmma", lambda lib: None)
    counts = {k: 1 for k in kernel_wrappers()}
    for phase, value in (("phase3", (counts, None, [])),
                         ("phase4", {"rwkv6_scan": 1}),
                         ("phase5", {"5a": counts, "5b": counts}),
                         ("phase6", counts),
                         ("phase7", {"7a": counts, "7c": counts}),
                         ("phase8", counts), ("phase9", counts)):
        monkeypatch.setattr(chip_smoke, phase,
                            lambda *a, v=value, **k: v)
    return name


def test_kernels_line_names_the_fusions(fake_card, monkeypatch, capsys):
    """The kernels line holds the four fusions beside the six ported
    kernels, and the two Mamba2 kernels, each with every key of the
    contract; the last line is the device's."""
    rec = dict(ms=0.02, plain_ms=0.1, bound_ms=0.001, bound_by="bytes",
               library_ms=None, device_ms=0.01, max_abs_err=0.0)
    monkeypatch.setattr(chip_smoke, "phase2", lambda *a: {
        k: dict(rec) for k in kernel_wrappers()})
    assert chip_smoke.main() == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == {"ok": True, "device": {
        "platform": "gpu", "kind": fake_card, "count": 1}}
    rows = {r["name"]: r for r in json.loads(lines[-3])["kernels"]}
    keys = {"name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms"}
    for name, (source, replaces) in chip_smoke.FUSIONS.items():
        assert keys <= set(rows[name])
        assert rows[name]["route"] == "cuda"
        assert (rows[name]["source"], rows[name]["replaces"]) == \
            (source, replaces)
        assert (ROOT / source).exists()
        path, line = replaces.split(":")
        assert (ROOT / path).exists() and int(line) > 0
    assert rows["qkv_rope_chunk"]["route"] == "cuda"
    assert (rows["qkv_rope_chunk"]["source"],
            rows["qkv_rope_chunk"]["replaces"]) == chip_smoke.CHUNK_QKV
    assert (rows["dense_decode_attention"]["source"],
            rows["dense_decode_attention"]["replaces"]) == (
        "src/repro_torch/csrc/dense_decode.cu",
        "src/repro/models/attention.py:272")
    for name, (source, replaces) in chip_smoke.MAMBA2.items():
        assert keys <= set(rows[name]) and rows[name]["route"] == "cuda"
        assert (rows[name]["source"], rows[name]["replaces"]) == \
            (source, replaces)
        path, line = replaces.split(":")
        assert (ROOT / source).exists() and (ROOT / path).exists()
    assert len(rows) == 10 + len(chip_smoke.FUSIONS) + len(chip_smoke.MAMBA2)


@pytest.mark.parametrize("broken", ["rms_norm", "qkv_rope", "decode_merge",
                                    "gated_act", "gate_up_act", "qkv_proj"])
def test_a_failing_fusion_check_fails_the_run(fake_card, monkeypatch,
                                              capsys, small_fusion_checks,
                                              broken):
    """A fusion whose output leaves its plain version's stops the run
    with an error (a non-zero exit) before any result is printed."""
    def phase2(sheet, hw):
        return chip_smoke.check_fusions(torch.Generator().manual_seed(0),
                                        sheet, "cpu", plain_fusions(broken))

    monkeypatch.setattr(chip_smoke, "phase2", phase2)
    with pytest.raises(AssertionError):
        chip_smoke.main()
    out = capsys.readouterr().out
    assert '"ok"' not in out and '"kernels"' not in out


def test_fused_vs_plain_on_cpu(smoke):
    """Phase 3's fused step against ``fused=False`` at smoke width on the
    CPU: both legs the plain versions, equal, no kernel launched."""
    check = chip_smoke.fused_vs_plain(smoke[2], "cpu", prompts=(40, 17),
                                      steps=3)
    chip_smoke.assert_fused_vs_plain(check, "bfloat16", cuda=False)
    assert check["max_abs_diff"] == 0 and check["argmax_equal"]
    assert check["fusions"] == ["rms_norm", "qkv_rope", "gate_up_act"]


def _card_check() -> dict:
    """A fused-vs-plain record as the card's 2-layer bf16 check gives it:
    each layer and step one decode-attention launch in both legs (the
    fused one with the token merged), and the fused leg's gate/up
    product in place of its gated activation."""
    zero = {k: 0 for k in kernel_wrappers()}
    check = dict(argmax_equal=True, max_abs_diff=0.0, max_abs_logit=150.0,
                 rms_logit=39.0, layers=2, steps=6,
                 fusions=["rms_norm", "qkv_rope", "gate_up_act"],
                 launches_fused=dict(zero, paged_decode_attention=12,
                                     rms_norm=15, qkv_rope=12,
                                     gate_up_act=12),
                 launches_plain=dict(zero, paged_decode_attention=12))
    return check


@pytest.mark.parametrize("edit,ok", [
    (lambda c: None, True),
    (lambda c: c.update(max_abs_diff=2.0), True),   # 2 ulps at 128-256
    (lambda c: c.update(max_abs_diff=2.5), False),
    (lambda c: c.update(argmax_equal=False), False),
    (lambda c: c["launches_plain"].update(paged_decode_attention=24),
     False),                          # the plain leg's launch counted twice
    (lambda c: c["launches_fused"].update(paged_decode_attention=24),
     False),                          # a merged launch counted twice
])
def test_fused_vs_plain_bounds_and_counts(edit, ok):
    """The fused step's gate on the card: bf16 within FUSED_BF16_ULPS ulps
    of the largest logit, and decode attention counted once a layer and
    step in each leg."""
    check = _card_check()
    edit(check)
    assert chip_smoke.fused_bound(check, "bfloat16") == 2.0
    assert chip_smoke.fused_bound(check, "float32") == pytest.approx(0.039)
    if ok:
        chip_smoke.assert_fused_vs_plain(check, "bfloat16", cuda=True)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.assert_fused_vs_plain(check, "bfloat16", cuda=True)


@pytest.mark.parametrize("layers,top,share,bound", [
    (2, 3.5, 0.0, 2 * 2.0 ** -7 * 3.5 + 2 * 2.0 ** -6),
    (28, 3.5, 0.25, 28 * 2.0 ** -7 * 1.5 * 3.5 + 2 * 2.0 ** -6),
    (28, 150.0, 0.0, 28 * 2.0 ** -7 * 150.0 + 2 * 2.0 ** 0),
    (28, 3.5, (0.0, 0.04), 28 * 2.0 ** -7 * 1.6 * 3.5 + 2 * 2.0 ** -6),
    (2, 3.5, (0.25, 0.01), 2 * 2.0 ** -7 * 1.8 * 3.5 + 2 * 2.0 ** -6)])
def test_step_bound_counts_each_layer(layers, top, share, bound):
    """P14's bound: 2^-7 (1 + sqrt(s) + 3 sqrt(t)) of the largest logit a
    layer (the norms' one-ulp gaps, the gate/up product's share s of
    outputs one ulp off and the qkv launch's share t of q, k and v), plus
    two ulps of it."""
    share, qkv = share if isinstance(share, tuple) else (share, None)
    check = dict(layers=layers, max_abs_logit=top, gate_up_share=share)
    if qkv is not None:
        check["qkv_share"] = qkv
    assert chip_smoke.step_bound(check) == pytest.approx(bound)


def test_published_decode_checks_on_cpu(capsys):
    """The published-init decode checks end to end at smoke width on the
    CPU (both legs the plain versions, so equal): the 2-layer check and a
    deeper one held to ``step_bound``."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              num_layers=4)
    chip_smoke.published_decode_checks(cfg, "cpu")
    out = capsys.readouterr().out
    assert "at the published init, 2 full-width layers" in out
    assert "at the published init, 4 full-width layers" in out
    assert '"argmax_gap": 0.0' in out


@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_gate_up_bound_covers_a_product_one_ulp_off(activation):
    """``gate_up_bound``: the plain spelling's output with gate or up one
    bf16 ulp away stays within it, and it is no wider than a few ulps of
    the largest output."""
    g = torch.linspace(-6, 6, 4001).to(torch.bfloat16)
    u = torch.linspace(3, -2, 4001).to(torch.bfloat16)
    bound = chip_smoke.gate_up_bound(g, u, activation)
    base = gated_act_ref(g, u, activation).float()
    for t, other, first in ((g, u, True), (u, g, False)):
        up = (t.view(torch.int16) + 1).view(torch.bfloat16)   # |t| + 1 ulp
        moved = gated_act_ref(up, other, activation) if first else \
            gated_act_ref(other, up, activation)
        assert (moved.float() - base).abs().max().item() <= bound
    assert 0 < bound <= 8 * 2.0 ** (math.floor(math.log2(
        base.abs().max().item())) - 7)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-235b-a22b"])
def test_qkv_bound_covers_projections_one_ulp_off(arch):
    """``qkv_proj_bound``: the plain chain on projections each one bf16 ulp
    away (away from zero, toward it, and alternating by channel), and on
    projections summed in another order, stays within it element by
    element (qwen2: bias and RoPE; qwen3-moe: the
    qk norm and RoPE), and it is no wider than a few ulps of the largest
    output."""
    from repro_torch.kernels.fusions.ref import (qkv_products,
                                                 qkv_proj_bound,
                                                 qkv_rope_ref)
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(3)
    t = chip_smoke.qkv_inputs(cfg, 4, gen, "cpu")
    x, ws, chain = t["x"], t["ws"][0], t["chain"]
    bounds = qkv_proj_bound(x, *ws, **chain)
    base = qkv_products(x, *ws)

    def chain_of(p):
        ko, vo = torch.empty_like(p[1]), torch.empty_like(p[2])
        return qkv_rope_ref(*p, k_out=ko, v_out=vo, **chain), ko, vo

    want = chain_of(base)
    # the projections summed in another order (float64, then rounded),
    # as the kernel's K split sums them, stay within it too
    exact = [(x.double() @ w.reshape(w.shape[0], -1).double()).to(
        torch.bfloat16).reshape(p.shape) for p, w in zip(base, ws)]
    for a, b, bd in zip(chain_of(exact), want, bounds):
        assert ((a.double() - b.double()).abs() <= bd).all()
    for step in ((1, 1), (-1, -1), (1, -1)):
        moved = []
        for p in base:
            bits = p.view(torch.int16)
            sign = torch.ones(p.shape[-1], dtype=torch.int16)
            sign[1::2] = step[1]
            moved.append((bits + step[0] * sign * (bits != 0)).view(
                torch.bfloat16))
        for a, b, bd in zip(chain_of(moved), want, bounds):
            assert ((a.double() - b.double()).abs() <= bd).all(), step
    for b, bd in zip(want, bounds):
        top = b.double().abs().max().item()
        assert 0 < bd.max().item() <= 16 * 2.0 ** (math.floor(math.log2(
            top)) - 7)


@pytest.mark.parametrize("family,dtype,names", [
    ("qwen2-1.5b", "bfloat16", ["rms_norm", "qkv_proj", "gate_up_act"]),
    ("qwen2-1.5b", "float32", ["rms_norm", "qkv_rope", "gated_act"]),
    ("qwen3-moe-235b-a22b", "bfloat16", ["rms_norm", "qkv_proj"]),
    ("stablelm-3b", "bfloat16", ["rms_norm", "qkv_rope", "gate_up_act"])])
def test_fused_names_follow_the_ffn_route(family, dtype, names):
    """A dense bf16 decode step takes the gate/up product, an fp32 one the
    products and the gated activation's kernel; a MoE FFN neither. A bf16
    step takes the qkv launch where its plan takes the heads (stablelm's
    Dh 80 keeps the products and the row pass), an fp32 one never."""
    cfg = dataclasses.replace(get_config(family), compute_dtype=dtype)
    assert chip_smoke.fused_names(cfg) == names


@pytest.mark.parametrize("traces,calls", [
    ([{"a": 3}], 1),                  # a trace with events: taken
    ([{}, {"a": 3}], 2),              # an empty one: traced once more
    ([{}, {}], 2),                    # and that one counts, empty or not
])
def test_an_empty_step_trace_is_taken_once_more(monkeypatch, traces, calls):
    from repro_torch.launch import profile_step
    seen = []

    def traced(fn, **kw):
        seen.append(kw)
        return {"kernel_counts": traces[len(seen) - 1]}

    monkeypatch.setattr(profile_step, "traced", traced)
    resets = []
    assert chip_smoke.step_kernel_counts(
        lambda: None, lambda: resets.append(1)) == traces[calls - 1]
    assert len(seen) == calls and len(resets) == calls - 1


def test_most_kernel_counts_takes_each_names_largest(monkeypatch):
    """Two traced steps, a kernel dropped from each: every name's count
    is its largest, so neither drop shows."""
    from repro_torch.launch import profile_step
    traces = [{"gemm": 16, "rsqrt": 5}, {"gemm": 17, "rsqrt": 4, "x": 1}]

    def traced(fn, **kw):
        return {"kernel_counts": traces.pop(0)}

    monkeypatch.setattr(profile_step, "traced", traced)
    assert chip_smoke.most_kernel_counts(lambda: None) == \
        {"gemm": 17, "rsqrt": 5, "x": 1}
    assert not traces


def _dense_standin(q, k, v, offsets, **kw):
    """The dense launch's arithmetic on the CPU: the plain version in fp32
    (the scores unrounded, as the launch keeps them) over the caches with
    their dead slots zeroed (the launch never reads them; the plain
    version reads every slot), rounded to q's dtype."""
    from repro_torch.kernels.decode_attention import dense_decode_ref
    return dense_decode_ref(q.float(), torch.nan_to_num(k).float(),
                            torch.nan_to_num(v).float(), offsets,
                            **kw).to(q.dtype)


@pytest.mark.parametrize("shape", chip_smoke.DENSE_DECODE
                         + chip_smoke.DENSE_EDGES,
                         ids=lambda s: s["name"])
def test_dense_checks_on_cpu(shape):
    """Phase 2's dense-launch check with the launch's arithmetic standing
    in: the cases' NaN dead slots, each element within the tolerance
    derived from the launch's roundings of the plain version in float64,
    both dtypes."""
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        got = chip_smoke.check_dense(shape, dtype, gen, launch=_dense_standin,
                                     device="cpu", rows=False)
        assert 0 < got["max_abs_err"] <= got["tolerance"]
        assert got["gap_over_tolerance"] <= 1.0


def _dense_schedule(q, k, v, offsets, **kw):
    """The dense kernel's schedule on the CPU (``dense_split_ref``: its
    ranks' splits, each warp's stages, fp32 scores, P V as bf16 hi + lo,
    the merges in warp and rank order); it reads live slots alone."""
    from repro_torch.kernels.decode_attention.ref import dense_split_ref
    return dense_split_ref(q, k, v, offsets, **kw)


@pytest.mark.parametrize("shape", chip_smoke.DENSE_DECODE
                         + chip_smoke.DENSE_EDGES[:1]
                         + chip_smoke.DENSE_HEAD_EDGES,
                         ids=lambda s: s["name"])
def test_dense_checks_pass_the_kernels_schedule(shape):
    """Phase 2's dense check with the dense kernel's own schedule standing
    in, at path E's shapes, a ring not yet full (empty ranks) and the
    other head geometries (G 16, two and four KV heads a CTA): each
    element within ``dense_tolerance`` in both dtypes."""
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        got = chip_smoke.check_dense(shape, dtype, gen,
                                     launch=_dense_schedule, device="cpu",
                                     rows=False)
        assert 0 < got["max_abs_err"] <= got["tolerance"]
        assert got["gap_over_tolerance"] <= 1.0


def _dense_zeros(q, k, v, offsets, **kw):
    return torch.zeros_like(q)


def _dense_rank_dropped(q, k, v, offsets, *, scale, softcap, window):
    """The dense kernel's schedule with its rank 1 left out of every
    row's merge (a cluster rank whose split never arrives)."""
    from repro_torch.kernels.decode_attention.ref import (
        combine_splits, dense_split_partials)
    out = []
    for acc_s, m_s, l_s in dense_split_partials(q, k, v, offsets,
                                                scale=scale,
                                                softcap=softcap):
        keep = [r for r in range(len(m_s)) if r != 1]
        acc, _, l = combine_splits(acc_s[keep], m_s[keep], l_s[keep],
                                   torch.zeros(len(keep), dtype=torch.bool))
        out.append(acc / l.clamp_min(1e-30)[..., None])
    return torch.stack(out).reshape(q.shape).to(q.dtype)


def _dense_uncapped(q, k, v, offsets, **kw):
    return _dense_standin(q, k, v, offsets, **dict(kw, softcap=0.0))


def _dense_rounded_scores(q, k, v, offsets, **kw):
    """The plain version in q's dtype: bf16 scores rounded to bf16."""
    from repro_torch.kernels.decode_attention import dense_decode_ref
    return dense_decode_ref(q, torch.nan_to_num(k), torch.nan_to_num(v),
                            offsets, **kw)


def _dense_last_split_dropped(q, k, v, offsets, *, window, **kw):
    """Each row over its live slots short of its last 128-token split."""
    out = []
    for b in range(q.shape[0]):
        live = min(int(offsets[b]) + 1, k.shape[1])
        cut = (live - 1) // 128 * 128
        out.append(_dense_standin(
            q[b:b + 1], k[b:b + 1, :cut], v[b:b + 1, :cut],
            torch.tensor([cut - 1], dtype=torch.int32), window=0, **kw)[0]
            if cut else torch.zeros_like(q[b]))
    return torch.stack(out)


_CAPPED = chip_smoke.DENSE_EDGES[-1]


@pytest.mark.parametrize("fault,shape", [
    *((_dense_zeros, s) for s in chip_smoke.DENSE_DECODE + (_CAPPED,)),
    *((_dense_last_split_dropped, s) for s in chip_smoke.DENSE_DECODE),
    *((_dense_rank_dropped, s) for s in chip_smoke.DENSE_DECODE),
    (_dense_uncapped, _CAPPED), (_dense_rounded_scores, _CAPPED)],
    ids=lambda x: x["name"] if isinstance(x, dict) else x.__name__[7:])
def test_dense_check_catches_each_fault(fault, shape):
    """Phase 2's bf16 dense check fails a launch that writes zeros, drops
    a row's last split or a cluster rank's split (rank 1 of the dense
    kernel's schedule), skips the softcap (q x 20: the scores at the cap)
    or rounds its scores to bf16 as the plain spelling does."""
    assert _CAPPED["qscale"] > 1 and _CAPPED["softcap"]
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(AssertionError):
        chip_smoke.check_dense(shape, torch.bfloat16, gen, launch=fault,
                               device="cpu", rows=False)


def test_dense_bound_at_gemma2s_global_layer():
    """The dense launch's bound at gemma2-9b's global layer: 4632 live
    tokens x 8 KV heads x 256 x 2 bytes, K and V, ~37.9 MB at 3.35 TB/s."""
    sheet = chip_smoke.card_datasheet("NVIDIA H100 80GB HBM3")
    ms, by = chip_smoke.dense_bound(chip_smoke.DENSE_DECODE[0], 2, sheet)
    assert by == "bytes" and ms == pytest.approx(0.0113319, rel=1e-4)


@pytest.mark.parametrize("arch,fusions", [
    ("gemma2-9b", {"rms_norm": None, "qkv_proj": 42, "gate_up_act": 42,
                   "gated_act": 0, "qkv_rope_chunk": 0}),
    ("zamba2-2.7b", {"rms_norm": None, "qkv_rope": 9, "gate_up_act": 9,
                     "gated_act": 0, "qkv_rope_chunk": 0, "mamba2_step": 54,
                     "ssd_chunk": 0})])
def test_path_e_fusions_follow_the_shapes(arch, fusions):
    """The kernels a fused path E step runs: gemma2-9b's qkv launch (its
    plan takes Dh 256 at one row), zamba2-2.7b's row pass (its Dh 80 is
    refused by the plan), each sublayer's gate/up launch; zamba2-2.7b's
    decode step's Mamba2 launch once a layer, its prompt's SSD in the
    prefill alone."""
    cfg = get_config(arch)
    assert chip_smoke.path_e_fusions(cfg) == fusions
    assert chip_smoke.attention_calls(cfg) == (42 if arch == "gemma2-9b"
                                               else 9)


def _path_e_check(**kw) -> dict:
    base = dict(max_abs_diff=0.05, argmax_gap=0.0, max_abs_logit=20.0,
                layers=42, norms=4, scale=1 / 16, softcap=50.0,
                score_max=3.0, gate_up_share=0.0, qkv_share=0.0)
    return dict(base, **kw)


def test_path_e_bound_counts_each_term():
    """``path_e_bound``: sqrt(L) r max|logit| + 2 ulps, r from the norms
    (2^-8 each), the P and output roundings (2^-7), the scores' rounding
    (d = 2^-9 min(scale S, 0.45 softcap)) and the launches' shares."""
    c = _path_e_check()
    ulps = 2 * 2.0 ** (math.floor(math.log2(20.0)) - 7)
    r = math.expm1(2 * 2.0 ** -9 * 3.0 / 16) + 2.0 ** -7 + 4 * 2.0 ** -8
    L = math.sqrt(42)
    assert chip_smoke.path_e_bound(c) == pytest.approx(L * r * 20 + ulps)
    # the softcap bounds a score's move however large the raw score
    big = chip_smoke.path_e_bound(_path_e_check(score_max=1e6))
    r_cap = math.expm1(2 * 2.0 ** -9 * 0.45 * 50) + 2.0 ** -7 + 4 * 2.0 ** -8
    assert big == pytest.approx(L * r_cap * 20 + ulps)
    assert chip_smoke.path_e_bound(_path_e_check(score_max=1e6,
                                                 softcap=0.0)) > 1e3
    shares = chip_smoke.path_e_bound(_path_e_check(gate_up_share=0.01,
                                                   qkv_share=0.01))
    assert shares == pytest.approx(chip_smoke.path_e_bound(c) + L * 20 *
                                   2.0 ** -7 * 4 * 0.1)


@pytest.mark.parametrize("layers", [2, 4, 42])
def test_path_e_gate_fails_a_zero_output_at_each_depth(layers):
    """At each depth the gate holds, the bound stays below max|logit|: a
    fused leg of zeros (a gap of max|logit|) fails it, and so does an
    argmax flip between logits max|logit| apart."""
    c = _card_path_e(layers)
    assert chip_smoke.path_e_bound(c) < 0.2 * c["max_abs_logit"]
    chip_smoke.assert_path_e_fused_vs_plain(c, cuda=True)
    for gap in ("max_abs_diff", "argmax_gap"):
        with pytest.raises(AssertionError):
            chip_smoke.assert_path_e_fused_vs_plain(
                dict(c, **{gap: c["max_abs_logit"]}), cuda=True)


def _card_path_e(layers: int = 2, **kw) -> dict:
    """A fused-vs-plain record as the card's gemma2-9b check gives it at
    ``layers`` layers: the dense launch, the qkv launch and the gate/up
    launch once a layer and step in the fused leg, none in the plain
    one."""
    n = 6 * layers
    lf = dict(dense_decode_attention=n, qkv_proj=n, gate_up_act=n,
              rms_norm=63, gated_act=layers, qkv_rope_chunk=1,
              flash_attention=layers)
    c = _path_e_check(layers=layers, steps=6, decode_stats_fused=0,
                      fusions={"rms_norm": None, "qkv_proj": layers,
                               "gate_up_act": layers, "gated_act": 0,
                               "qkv_rope_chunk": 0},
                      launches_fused=lf,
                      launches_plain=dict(flash_attention=layers))
    c.update(kw)
    return c


@pytest.mark.parametrize("edit,ok", [
    (lambda c: None, True),
    (lambda c: c.update(max_abs_diff=1e3), False),
    (lambda c: c.update(argmax_gap=1e3), False),
    (lambda c: c.update(decode_stats_fused=1), False),
    (lambda c: c["launches_fused"].update(dense_decode_attention=11), False),
    (lambda c: c["launches_plain"].update(dense_decode_attention=12), False),
    (lambda c: c["launches_plain"].update(gate_up_act=12), False),
    (lambda c: c["launches_fused"].pop("qkv_rope_chunk"), False),
    (lambda c: c["launches_fused"].update(flash_attention=3), False)])
def test_path_e_gate_catches_each_fault(edit, ok):
    """``assert_path_e_fused_vs_plain`` on the card: the gap within its
    bound, one dense launch a sublayer and step in the fused leg alone,
    no plain dense arithmetic there, every fusion in the fused leg alone,
    the same flash prefill."""
    check = _card_path_e()
    edit(check)
    if ok:
        chip_smoke.assert_path_e_fused_vs_plain(check, cuda=True)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.assert_path_e_fused_vs_plain(check, cuda=True)


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-2.7b"])
def test_path_e_fused_vs_plain_on_cpu(arch):
    """Phase 7's fused-vs-plain check at smoke width on the CPU: both legs
    the plain versions (the dense launch's among them on the fused leg),
    equal bit for bit, nothing launched, no plain dense arithmetic in the
    fused leg; and the published-init checks at two cut depths."""
    cfg = get_config(arch, smoke=True)
    run = PATH_E_SMOKE[arch]
    model = Model(cfg, device="cpu", seed=0)
    toks = torch.randint(0, cfg.vocab_size, (2, run["prompt"]),
                         generator=torch.Generator().manual_seed(2))
    check = chip_smoke.forward_fused_vs_plain(model, toks, 3,
                                              run["prompt"] + 3)
    check.update(gate_up_share=0.0, qkv_share=0.0)
    chip_smoke.assert_path_e_fused_vs_plain(check, cuda=False)
    assert check["argmax_equal"] and check["score_max"] > 0
    chip_smoke.published_path_e_checks(
        cfg, dict(B=2, prompt=run["prompt"], max_len=run["prompt"] + 8,
                  check="7x", published=run["depths"]), "cpu")
    pair = chip_smoke.decode_pair(model, toks, 2, fused=True)
    plain = chip_smoke.decode_pair(model, toks, 2, fused=False)
    side = chip_smoke.path_e_legs(pair, plain)
    assert set(side) == {"fused", "plain"}
    assert set(side["fused"]) == {"prefill_s", "graph", "eager"}


# ------------------------------------- phase 2: the Mamba2 kernels (CPU)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_mamba2_checks_pass_the_plain_versions(dtype):
    """Phase 2's Mamba2 checks at the smoke edge with the plain versions
    standing in for the kernels: the new states bit-equal, every element
    within ``mamba2_tolerance``, rows alone equal to rows in a batch."""
    from repro_torch.kernels.mamba2 import mamba2_step_ref, ssd_chunk_ref
    gen = torch.Generator().manual_seed(0)
    for edge in chip_smoke.MAMBA2_EDGES:
        w = dict(edge, eps=1e-5)
        got = chip_smoke.check_mamba2_step(w, edge["B"], dtype, gen, "cpu",
                                           mamba2_step_ref)
        assert got["gap_over_tolerance"] == 0.0 and got["tolerance"] > 0
        got = chip_smoke.check_ssd_chunk(w, edge["B"], edge["S"], dtype, gen,
                                         "cpu", ssd_chunk_ref)
        assert got["gap_over_tolerance"] == 0.0
        assert got["state_gap_over_tolerance"] == 0.0


def test_mamba2_planted_faults_fail_the_checks():
    """Each planted fault (no D skip or no decay in the decode step, no
    carried state or no D skip in the SSD) fails its check in bf16 and
    fp32; the SSD on TF32-rounded operands fails the fp32 check."""
    caught = chip_smoke.planted_mamba2_faults(torch.Generator().manual_seed(1),
                                              "cpu")
    assert caught == ["step_no_skip", "step_no_decay", "chunk_no_carry",
                      "chunk_no_skip", "chunk_tf32"]


def test_mamba2_tolerance_counts_each_term():
    """``mamba2_tolerance``: zero where every term is zero and the output
    exact; a bf16 output takes its ulps beside fp32's few; a deeper sum
    takes more."""
    z = torch.full((1, 2, 4), 2.0)
    y = torch.tensor([[[1.0, -2.0, 0.5, 3.0], [0.25, 1.0, -1.0, 2.0]]])
    D, norm = torch.zeros(2), torch.zeros(2, 4)
    xs = torch.zeros(1, 2, 4)
    args = (y, y.abs(), 20, xs)
    fp32 = chip_smoke.mamba2_tolerance(*args, z, D, norm, 1e-5)
    bf16 = chip_smoke.mamba2_tolerance(*args, z.bfloat16(), D, norm, 1e-5)
    deep = chip_smoke.mamba2_tolerance(y, y.abs(), 2000, xs, z, D, norm,
                                       1e-5)
    assert (bf16 > fp32).all() and (deep > fp32).all()
    # fp32: a few of its ulps at outputs of ~1; bf16: its own ulps there
    assert (fp32 < 1e-4).all() and (bf16 > 2.0 ** -9).all()
    zero = chip_smoke.mamba2_tolerance(torch.zeros_like(y), torch.zeros_like(
        y), 20, xs, z, D, norm, 1e-5)
    assert (zero == 0).all()


def test_path_e_bound_adds_the_mamba2_layers_in_quadrature():
    """``path_e_bound`` with M Mamba2 layers: sqrt(L r^2 + M r_m^2),
    r_m = 2^-8 + 2^-7 sqrt(m); no Mamba2 layer leaves it as it was."""
    c = _path_e_check(layers=9, norms=2, softcap=0.0, scale=1 / 80 ** 0.5)
    base = chip_smoke.path_e_bound(c)
    assert chip_smoke.path_e_bound(dict(c, mamba_layers=0,
                                        mamba2_share=0.5)) == base
    top, ulps = 20.0, 2 * 2.0 ** (math.floor(math.log2(20.0)) - 7)
    r = (base - ulps) / (3 * top)
    rm = 2.0 ** -8 + 2.0 ** -7 * math.sqrt(0.01)
    got = chip_smoke.path_e_bound(dict(c, mamba_layers=54,
                                       mamba2_share=0.01))
    assert got == pytest.approx(math.sqrt(9 * r * r + 54 * rm * rm) * top
                                + ulps)
    assert chip_smoke.mamba_layers(get_config("zamba2-2.7b")) == 54
    assert chip_smoke.mamba_layers(get_config("gemma2-9b")) == 0
    assert chip_smoke.mamba2_share(get_config("zamba2-2.7b"), "cpu") == 0.0
