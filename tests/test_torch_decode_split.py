"""The split-KV decode attention's arithmetic and host side, on the CPU.

The CUDA kernel cuts each row's live tokens into splits of whole pages
(``split_plan``), computes one fp32 online-softmax partial a split and
merges a row's splits in split order (``combine_splits``). Its plain
twin, ``paged_decode_split_ref``, is held here against the JAX package's
Pallas kernel in interpret mode on the same numpy inputs; ``plan_decode``
(grid, stage tile, shared memory, workspace) against the source's
constants. The kernel itself is held against the plain version on the
card by ``chip_smoke.py`` phase 2.

Tolerances: the split partials differ from the Pallas kernel's page-by-
page online softmax only in fp32 summation order: 2e-5 on fp32 inputs
(residuals and output), and on bf16 inputs 2e-2 for the output, one
bf16 rounding (the bound of ``tests/test_torch_kernels.py``).
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import paged_decode_attention as jax_decode
from repro_torch.kernels.decode_attention import (paged_decode_attention,
                                                  paged_decode_attention_kernel)
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention.kernel import (HEAD_GROUPS,
                                                         SMEM_PER_BLOCK,
                                                         TC_HEAD_DIMS,
                                                         plan_decode)
from repro_torch.kernels.decode_attention.ref import (NEG_INF, SPLIT_TOKENS,
                                                      combine_splits,
                                                      paged_decode_split_ref,
                                                      split_pages, split_plan)

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "src" /
          "repro_torch" / "csrc" / "decode_attention.cu").read_text()
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def source_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


def both(x: np.ndarray, dtype: str = "float32"):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(np.array(x)).to(td)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def case(B, H, KV, D, page, lens, seed=0, extra_pages=8):
    """Pools, queries and ragged tables whose dead slots hold garbage."""
    rng = np.random.default_rng(seed)
    n_live = [-(-n // page) for n in lens]
    n_tab = max(1, max(n_live))
    P = sum(n_live) + extra_pages
    perm = rng.permutation(P)
    tabs = rng.integers(-2 ** 20, 2 ** 20, size=(len(lens), n_tab))
    used = 0
    for b, n in enumerate(n_live):
        tabs[b, :n] = perm[used:used + n]
        used += n
    return dict(q=rng.normal(size=(B, H, D)),
                k=rng.normal(size=(P, page, KV, D)),
                v=rng.normal(size=(P, page, KV, D)),
                tabs=tabs.astype(np.int32), lens=np.asarray(lens, np.int32))


# ---------------------------------------------------------------- the plan
@pytest.mark.parametrize("page", [8, 16, 32, 64])
@pytest.mark.parametrize("length", [0, 1, 7, 255, 256, 257, 511, 4096, 16385])
def test_split_plan_covers_the_row_in_whole_pages(page, length):
    splits = split_plan(length, page)
    step = split_pages(page) * page
    assert step == SPLIT_TOKENS      # every page size of the repo divides it
    assert [s for s, _ in splits] == list(range(0, length, step))
    assert all(e - s == step for s, e in splits[:-1])
    assert all(s % page == 0 and s < e for s, e in splits)
    covered = [t for s, e in splits for t in range(s, e)]
    assert covered == list(range(length))


def test_split_plan_depends_on_the_length_and_page_alone():
    step = SPLIT_TOKENS
    assert split_plan(2 * step + 60, 16) == [(0, step), (step, 2 * step),
                                             (2 * step, 2 * step + 60)]
    assert split_pages(2 * SPLIT_TOKENS) == 1 and split_pages(512) == 1
    assert split_plan(300, 512) == [(0, 300)]


@pytest.mark.parametrize("name,value", [
    ("kSplitTokens", SPLIT_TOKENS), ("kThreads", decode_kernel.THREADS),
    ("kStages", decode_kernel.STAGES),
    ("kStageBytes", decode_kernel.STAGE_BYTES),
    ("kMaxTile", decode_kernel.MAX_TILE),
    ("kTcThreads", decode_kernel.TC_THREADS),
    ("kTcTile", decode_kernel.TC_TILE),
    ("kMaxGD", decode_kernel.MAX_GD)])
def test_constants_match_the_kernel_source(name, value):
    assert source_constant(name) == value


def test_the_merge_scratch_matches_the_source():
    """The row's merge keeps three rows of 16 heads, the weights of
    kCombineChunk splits, the row's sums, q's rows and the new token's k
    and v in the block's dynamic shared memory, the records (16-byte
    padded) after them: the plan counts the same bytes, every block has
    room for one record at least, and every G * D the plan takes fits the
    row's kMaxGD sums."""
    chunk = source_constant("kCombineChunk")
    assert "4 * (3 * 16 + kCombineChunk * 16 + kMaxGD + kMaxGD + 2 * 256) + 16" \
        in SOURCE
    assert "return (G * D + 2 * G + 1 + 3) & ~3;" in SOURCE
    assert decode_kernel.MERGE_SMEM == 4 * (3 * 16 + chunk * 16 +
                                            2 * decode_kernel.MAX_GD + 512) \
        + 16                                # the bulk copy's mbarrier
    for G, D, esz in ((16, 128, 2), (8, 256, 2), (1, 8, 2), (1, 4, 4),
                      (16, 128, 4), (3, 16, 2), (8, 256, 4)):
        plan = plan_decode(4, 2, G, D, esz, 16, 64)
        record = decode_kernel.record_floats(G, D)
        assert record % 4 == 0 and 0 <= record - (G * D + 2 * G + 1) < 4
        # the scratch, then at least one staged record
        assert plan.smem_bytes >= decode_kernel.MERGE_SMEM + 4 * record
        assert G * D <= decode_kernel.MAX_GD and D <= 256


@pytest.mark.parametrize("B,KV,n_tab", [(1, 1, 1), (4, 2, 128), (8, 2, 256),
                                        (64, 16, 3), (300, 32, 2)])
def test_plan_counts_one_ticket_counter_a_row_and_kv_head(B, KV, n_tab):
    """One int32 ticket counter a (row, KV head): the source indexes them
    ``blockIdx.z * gridDim.y + blockIdx.y`` over the grid (splits, KV,
    B), whatever the table width."""
    plan = plan_decode(B, KV, 2, 64, 2, 16, n_tab)
    assert plan.counters == B * KV == plan.grid[1] * plan.grid[2]
    assert "blockIdx.z * gridDim.y + blockIdx.y" in SOURCE
    assert "mg.counters[b * KV + kvh] = 0" in SOURCE


def test_ticket_counters_are_zeroed_slices_of_one_arena(monkeypatch):
    """A stream's counters: a zeroed slice of at least MIN_COUNTERS (a
    power of two) of its device's arena, kept while it suffices; each
    stream its own slice, a larger need a new one; a used-up arena is
    followed by a new one, the old kept (graphs keep its addresses)."""
    monkeypatch.setattr(decode_kernel, "_COUNTERS", {})
    monkeypatch.setattr(decode_kernel, "_ARENAS", {})
    monkeypatch.setattr(decode_kernel, "_KEPT", [])
    monkeypatch.setattr(decode_kernel, "ARENA_COUNTERS", 16384)
    dev = torch.device("cpu")
    a = decode_kernel.ticket_counters(dev, 7, 10)
    assert a.dtype == torch.int32 and not a.any()
    assert a.numel() == decode_kernel.MIN_COUNTERS
    assert decode_kernel.ticket_counters(dev, 7, 4096) is a
    other = decode_kernel.ticket_counters(dev, 8, 1)
    arena = decode_kernel._KEPT[0]
    assert other.data_ptr() == a.data_ptr() + 4 * 4096
    big = decode_kernel.ticket_counters(dev, 7, 5000)
    assert big.numel() == 8192 and not big.any()
    assert big.data_ptr() == arena.data_ptr() + 4 * 8192
    assert decode_kernel.ticket_counters(dev, 7, 20) is big
    fresh = decode_kernel.ticket_counters(dev, 9, 1)   # the arena is full
    assert len(decode_kernel._KEPT) == 2
    assert fresh.data_ptr() == decode_kernel._KEPT[1].data_ptr()


def test_one_launch_a_call_in_the_source():
    """The split kernels merge their rows in the same launch: no combine
    kernel is left, a block's ticket is one acquire-release atomic, the
    last ticket's block merges (staging the records with one bulk copy
    through L2 after a proxy fence), and the entry point launches
    once."""
    assert "combine_kernel" not in SOURCE
    assert "last_ticket(mg.counters, max_splits)" in SOURCE
    assert "atom.acq_rel.gpu.global.add.s32" in SOURCE
    assert "bulk_load(stage, rec, 4u * min(chunk, n) * R, bar)" in SOURCE
    assert "fence.proxy.async.global" in SOURCE
    assert "parts" not in SOURCE.split("int paged_decode_launch(")[1]


def test_instantiations_match_the_source_dispatch():
    groups = sorted({int(g) for g in re.findall(r"REPRO_SPLIT\((\d+)\);",
                                                SOURCE)})
    assert tuple(groups) == HEAD_GROUPS
    dims = [int(d) for d in re.findall(r"REPRO_TC\((\d+)\)", SOURCE)]
    assert tuple(dims) == TC_HEAD_DIMS


@pytest.mark.parametrize("D,esz,tensor_cores", [
    (128, 2, True), (64, 2, True), (80, 2, True), (16, 2, True),
    (256, 2, True), (8, 2, False), (24, 2, False), (128, 4, False)])
def test_bf16_at_the_repo_head_dims_takes_the_tensor_cores(D, esz,
                                                           tensor_cores):
    plan = plan_decode(2, 2, 6, D, esz, 16, 40)
    assert plan.tensor_cores is tensor_cores
    if tensor_cores:   # padded rows: D + 8 elements; then the row's merge
        assert plan.smem_bytes == max(3 * 2 * 64 * (D + 8) * 2,
                                      4 * 4 * 16 * (D + 2),
                                      decode_kernel.MERGE_SMEM +
                                      4 * decode_kernel.record_floats(6, D))


@pytest.mark.parametrize("esz", [2, 4])
@pytest.mark.parametrize("G", [1, 2, 3, 6, 8, 16])
def test_every_supported_shape_fits_shared_memory(esz, G):
    for D in range(16 // esz, 257, 16 // esz):
        if D > 128 and G > 8:
            continue
        plan = plan_decode(4, 2, G, D, esz, 16, 300)
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        assert plan.tile in (32, 64) and plan.tile % 8 == 0
        assert plan.tensor_cores or \
            plan.tile * D * esz <= decode_kernel.STAGE_BYTES


@pytest.mark.parametrize("B,n_tab,page", [
    (8, 256, 16), (1, 256, 16), (8, 257, 16), (4, 128, 16), (2, 1, 64),
    (2, 3, 64), (2, 5, 64), (1, 1024, 16), (3, 40, 8)])
def test_grid_depends_on_the_table_width_alone(B, n_tab, page):
    plan = plan_decode(B, 2, 6, 128, 2, page, n_tab)
    splits = -(-n_tab * page // SPLIT_TOKENS)   # whole pages divide it
    assert plan.grid == (splits, 2, B)
    # a record: acc, m, l and a flag, padded to 16 bytes (784 of 781)
    assert plan.workspace_floats == B * 2 * splits * 784
    assert decode_kernel.record_floats(6, 128) == 784


@pytest.mark.parametrize("G,D,esz", [(17, 128, 2), (16, 256, 2), (2, 264, 4),
                                     (2, 12, 2), (2, 6, 4)])
def test_plan_refuses_what_the_kernel_does_not_take(G, D, esz):
    with pytest.raises(ValueError):
        plan_decode(2, 2, G, D, esz, 16, 8)


# ------------------------------------------------- against the JAX kernel
SHAPES = [  # B, H, KV, D, page, lens: test_sweep's shapes, G=16 and G=1
    (2, 8, 2, 64, 16, (256, 100)), (3, 4, 4, 128, 32, (128, 33, 1)),
    (1, 16, 1, 64, 64, (128,)), (4, 6, 2, 8, 8, (24, 1, 9, 0)),
    (2, 12, 2, 128, 16, (257, 64)),
    (2, 32, 2, 128, 16, (300, 255)),        # glm4-9b: G 16, Dh 128
    (2, 16, 16, 128, 16, (513, 17)),        # moonshot: G 1
    (1, 12, 2, 16, 16, (2100,)),            # one row of 9 splits
]


@pytest.mark.parametrize("B,H,KV,D,page,lens", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_then_combine_matches_jax(B, H, KV, D, page, lens, dtype):
    c = case(B, H, KV, D, page, lens, seed=B * 100 + D)
    jx = [both(c[k], dtype)[0] for k in ("q", "k", "v")]
    tx = [both(c[k], dtype)[1] for k in ("q", "k", "v")]
    tabs, lens_ = c["tabs"], c["lens"]
    acc_j, m_j, l_j = jax_decode(*jx, jnp.asarray(tabs), jnp.asarray(lens_),
                                 return_residuals=True)
    acc, m, l = paged_decode_split_ref(*tx, torch.from_numpy(tabs),
                                       torch.from_numpy(lens_),
                                       return_residuals=True)
    out_j = jax_decode(*jx, jnp.asarray(tabs), jnp.asarray(lens_))
    out = paged_decode_split_ref(*tx, torch.from_numpy(tabs),
                                 torch.from_numpy(lens_))
    assert out.dtype == tx[0].dtype and out.shape == tx[0].shape
    if dtype == "float32":
        for got, want in ((acc, acc_j), (m, m_j), (l, l_j), (out, out_j)):
            np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-5,
                                       atol=2e-5)
    else:
        np.testing.assert_allclose(as_np(out), as_np(out_j), rtol=2e-2,
                                   atol=2e-2)


def test_layer_stacked_pool_takes_the_layer():
    c = case(2, 4, 2, 16, 8, (300, 40), seed=5)
    k5 = np.stack([c["k"], c["k"] * 0.5 + 1])
    v5 = np.stack([c["v"], c["v"] - 1])
    tabs, lens = torch.from_numpy(c["tabs"]), torch.from_numpy(c["lens"])
    q = torch.from_numpy(c["q"]).float()
    for li in range(2):
        out = paged_decode_split_ref(q, torch.from_numpy(k5).float(),
                                     torch.from_numpy(v5).float(), tabs,
                                     lens, layer=li)
        out_j = jax_decode(jnp.asarray(c["q"], jnp.float32),
                           jnp.asarray(k5, jnp.float32),
                           jnp.asarray(v5, jnp.float32),
                           jnp.asarray(c["tabs"]), jnp.asarray(c["lens"]),
                           layer=jnp.asarray(li, jnp.int32))
        np.testing.assert_allclose(out.numpy(), as_np(out_j), rtol=2e-5,
                                   atol=2e-5)


# ------------------------------------------------------------- contracts
def test_combine_over_no_split_is_exactly_empty():
    acc, m, l = combine_splits(torch.zeros((0, 2, 3, 8)),
                               torch.zeros((0, 2, 3)), torch.zeros((0, 2, 3)),
                               torch.zeros(0, dtype=torch.bool))
    assert (m == NEG_INF).all() and (l == 0).all() and (acc == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_empty_row_residuals_are_exact(dtype):
    c = case(3, 6, 2, 16, 16, (0, 300, 0), seed=2)
    tx = [both(c[k], dtype)[1] for k in ("q", "k", "v")]
    acc, m, l = paged_decode_split_ref(*tx, torch.from_numpy(c["tabs"]),
                                       torch.from_numpy(c["lens"]),
                                       return_residuals=True)
    for b in (0, 2):
        assert (m[b] == -2.0e38).all() and (l[b] == 0).all() \
            and (acc[b] == 0).all()
    assert (l[1] > 0).all()


@pytest.mark.parametrize("fn", [paged_decode_split_ref,
                                paged_decode_attention])
def test_batched_equals_one_row_bitwise_in_bf16(fn):
    c = case(4, 12, 2, 16, 16, (600, 0, 1, 257), seed=3)
    q, k, v = (both(c[x], "bfloat16")[1] for x in ("q", "k", "v"))
    tabs, lens = torch.from_numpy(c["tabs"]), torch.from_numpy(c["lens"])
    batched = fn(q, k, v, tabs, lens, return_residuals=True)
    for b in range(4):
        row = fn(q[b:b + 1], k, v, tabs[b:b + 1], lens[b:b + 1],
                 return_residuals=True)
        for got, want in zip(row, batched):
            assert torch.equal(got[0], want[b])


def test_padding_width_changes_nothing():
    """Wider tables, dead slots full of garbage: more empty split blocks
    on the card, the same bits here."""
    c = case(3, 8, 2, 16, 8, (70, 0, 300), seed=4)
    args = [torch.from_numpy(c[x]).float() for x in ("q", "k", "v")]
    tabs = c["tabs"]
    wide = np.concatenate([tabs, np.full((3, 70), 2 ** 29, np.int32)], 1)
    lens = torch.from_numpy(c["lens"])
    narrow = paged_decode_split_ref(*args, torch.from_numpy(tabs), lens,
                                    return_residuals=True)
    widened = paged_decode_split_ref(*args, torch.from_numpy(wide), lens,
                                     return_residuals=True)
    assert all(torch.equal(a, b) for a, b in zip(narrow, widened))
    assert plan_decode(3, 2, 4, 16, 4, 8, wide.shape[1]).max_splits > \
        plan_decode(3, 2, 4, 16, 4, 8, tabs.shape[1]).max_splits


def test_a_poisoned_split_stays_nan_through_the_combine():
    rng = np.random.default_rng(6)
    acc_s = torch.from_numpy(rng.normal(size=(3, 2, 2, 8))).float()
    m_s = torch.from_numpy(rng.normal(size=(3, 2, 2))).float()
    l_s = torch.rand((3, 2, 2)) + 1
    for bad in range(3):
        flags = torch.zeros(3, dtype=torch.bool)
        flags[bad] = True
        for x in combine_splits(acc_s, m_s, l_s, flags):
            assert torch.isnan(x).all()
    clean = combine_splits(acc_s, m_s, l_s, torch.zeros(3, dtype=torch.bool))
    assert all(torch.isfinite(x).all() for x in clean)


def test_a_live_id_outside_the_pool_poisons_its_row_only():
    c = case(3, 4, 2, 16, 16, (600, 300, 40), seed=7)
    args = [torch.from_numpy(c[x]).float() for x in ("q", "k", "v")]
    lens = torch.from_numpy(c["lens"])
    good = paged_decode_split_ref(*args, torch.from_numpy(c["tabs"]), lens,
                                  return_residuals=True)
    tabs = c["tabs"].copy()
    tabs[1, 17] = c["k"].shape[0]          # a live slot of row 1's 2nd split
    bad = paged_decode_split_ref(*args, torch.from_numpy(tabs), lens,
                                 return_residuals=True)
    for g, x in zip(good, bad):
        assert torch.isnan(x[1]).all()
        assert torch.equal(x[0], g[0]) and torch.equal(x[2], g[2])
    out = paged_decode_split_ref(*args, torch.from_numpy(tabs), lens)
    assert torch.isnan(out[1]).all() and torch.isfinite(out[[0, 2]]).all()


def test_the_kernel_refuses_cpu_tensors_and_launches_nothing():
    c = case(1, 4, 2, 16, 16, (20,))
    args = [torch.from_numpy(c[x]).float() for x in ("q", "k", "v")]
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention_kernel(*args, torch.from_numpy(c["tabs"]),
                                      torch.from_numpy(c["lens"]))
    assert paged_decode_attention_kernel.launches == 0
