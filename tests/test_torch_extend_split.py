"""The bf16 extend launch's split over keys and the RMS norm's launch
geometry, off the card.

The extend launch puts two heads of a GQA group on a CTA's 64 query rows
(one head's 128 rows where G is odd) and splits each query tile's live key
tiles over a cluster of ``slices`` CTAs, which merge their partial
softmax states in slice order. Here: its plan is a function of the shapes
and the SM count alone (the launch's arguments do not move with the
offsets' values); at path A's chunk it puts at least a wave of
two-warpgroup CTAs on 132 SMs; the tile ranges each CTA works out on the
device (the Python model of the kernel's formula) cover every live key
tile of its query tile exactly once at every offset of ``chip_smoke``'s
extend shapes, empty slices allowed; and the plain-torch model of the
slices and the merge (``flash_extend_split_ref``) equals the launch's
plain version and the reference's ``attend_decode`` run through JAX, in
fp32 within 1e-5 (the same fp32 softmax summed in other orders:
measured gaps stay under 2e-6), with empty slices and NaN in dead cache
slots.

The norm: its geometry (threads a row, chunks a thread, rows a block) is
a function of the row length alone, so a row's sum runs in one order
whatever the batch; a row of at most 64 chunks takes one warp, the order
of the qkv kernel's qk norm; and every refusal comes before anything is
built or launched. The kernels themselves run on the card only
(``chip_smoke.py`` phase 2).
"""
import dataclasses
import inspect
import math
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.kernels import _build, kernel_wrappers, launch_counts
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ref import flash_extend_split_ref
from repro_torch.kernels.fusions import kernel as fusion_kernel

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

EXTEND_SHAPES = (chip_smoke.FLASH_EXTEND,) + chip_smoke.FLASH_EXTEND_EDGES
FP32 = dict(rtol=1e-5, atol=1e-5)


def _shape_id(shape: dict) -> str:
    return "B{B}-H{H}-KV{KV}-C{C}-T{T}-D{D}-W{window}".format(**shape)


def _plan(shape: dict, **kw) -> flash_kernel.ExtendPlan:
    return flash_kernel.plan_extend(*(shape[x] for x in (
        "B", "H", "KV", "C", "T", "D")), shape["window"], **kw)


# ------------------------------------------------------------- the plan
def test_plan_takes_shapes_and_sms_alone():
    """``plan_extend``'s parameters are the shapes, the window, the SM
    count and the measurement hook: no offset reaches it."""
    params = list(inspect.signature(flash_kernel.plan_extend).parameters)
    assert params == ["B", "H", "KV", "C", "T", "D", "window", "num_sms",
                      "slices"]


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card."""

    @property
    def is_cuda(self):
        return True


def _on_card(t):
    return torch.Tensor._make_subclass(_OnCard, t)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_arguments_do_not_move_with_the_offsets(monkeypatch, dtype):
    """The launch's arguments at two offset tensors of other values are
    the same but for the offsets' address: grid, split and tile shapes
    are fixed on the host from the shapes alone, so one captured graph
    replays every start."""
    calls = []

    def lookup(lib, name, argtypes):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "function", lookup)
    monkeypatch.setattr(flash_kernel, "_num_sms", lambda index: 132)
    monkeypatch.setattr(flash_kernel, "device_guard",
                        lambda device: _NullContext())
    monkeypatch.setattr(flash_kernel, "stream_handle", lambda device: 7)
    shape = chip_smoke.FLASH_EXTEND
    q = torch.zeros(1, shape["C"], 12, 128, dtype=dtype).transpose(1, 2)
    k = torch.zeros(1, shape["T"], 2, 128, dtype=dtype).transpose(1, 2)
    for off in (2048, 0, 1037):
        flash_kernel.flash_extend_kernel(
            *map(_on_card, (q, k, k, torch.tensor([off], dtype=torch.int32))))
    names = {name for name, _ in calls}
    assert names == {"flash_extend_bf16_launch" if dtype == torch.bfloat16
                     else "flash_attention_fp32_launch"}
    offset_at = 14 if dtype == torch.bfloat16 else 15
    first = calls[0][1]
    for _, args in calls[1:]:
        assert len(args) == len(first)
        for i, (a, b) in enumerate(zip(args, first)):
            if i in (0, 1, 2, 3, 4, offset_at):   # addresses
                continue
            assert a == b, (i, a, b)
    if dtype == torch.bfloat16:
        plan = _plan(shape)
        assert first[15:18] == (int(plan.pair), plan.slices, plan.stages)
    flash_kernel.flash_extend_kernel.launches = 0


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_path_a_chunk_plan_is_one_full_wave():
    """Path A's chunk (512 queries of 12 heads, G 6, on a 2560-slot
    scratch): two heads a CTA over 64 rows, two warpgroups (256
    threads), each query tile's keys split over a cluster of 2: 96 CTAs,
    one wave on 132 SMs (a CTA holds an SM). The 144 or more CTAs of 3
    or 4 slices run in two waves, the second as long as the first (the
    launch's slice sweep on the H100, PERF.md)."""
    plan = _plan(chip_smoke.FLASH_EXTEND)
    assert plan.pair and plan.q_tile == 64 and plan.threads == 256
    assert plan.slices == 2 and plan.cluster == (2, 1, 1)
    assert plan.grid == (16, 6, 1) and plan.ctas == 96
    assert plan.block_k == 128 and plan.key_tiles == 20
    assert plan.smem_bytes <= flash_kernel.SMEM_PER_BLOCK
    assert plan.partial_bytes <= plan.smem_bytes - flash_kernel.ALIGN_SLACK


@pytest.mark.parametrize("shape", EXTEND_SHAPES, ids=_shape_id)
def test_plan_at_every_extend_shape(shape):
    """Every extend shape gets a plan: two warpgroups a CTA, heads paired
    where G is even, a split of at most 4 and at most the tiles a CTA
    can see, a merge that fits the shared memory, and no second wave of
    CTAs that the unsplit grid would not have."""
    plan = _plan(shape)
    G = shape["H"] // shape["KV"]
    assert plan.pair == (G % 2 == 0)
    assert plan.q_tile == (64 if plan.pair else 128)
    assert 1 <= plan.slices <= min(flash_kernel.MAX_SLICES, plan.key_tiles)
    assert plan.partial_bytes <= plan.smem_bytes - flash_kernel.ALIGN_SLACK
    assert plan.smem_bytes <= flash_kernel.SMEM_PER_BLOCK
    base = plan.ctas // plan.slices
    assert plan.ctas <= max(132, base)
    if base >= 132:
        assert plan.slices == 1


@pytest.mark.parametrize("base,tiles,sms,want", [
    (48, 20, 132, 2),     # path A's chunk: one wave of 96, not two of 144+
    (96, 20, 132, 1),     # B 2: a wave unsplit beats two waves of splits
    (200, 20, 132, 1),    # fills the card alone
    (16, 6, 132, 3),      # 3 and 4 tie: the smaller
    (48, 1, 132, 1),
    (10, 100, 132, 4),    # the cap
])
def test_pick_slices(base, tiles, sms, want):
    assert flash_kernel.pick_slices(base, tiles, sms) == want


def test_plan_refusals():
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_kernel.plan_extend(1, 12, 2, 16, 64, 100)
    with pytest.raises(ValueError, match="groups"):
        flash_kernel.plan_extend(1, 12, 5, 16, 64, 128)
    with pytest.raises(ValueError, match="slices 5"):
        flash_kernel.plan_extend(1, 12, 2, 16, 64, 128, slices=5)


# ----------------------------------------------------- the tile ranges
def _live_tiles(C, T, off, q0, rows, window, bk):
    """The key tiles a query tile's rows see, from each row's own live
    keys: row i at off + i sees [off + i - window + 1 (or 0), off + i],
    cut at T."""
    i = np.arange(q0, min(C, q0 + rows))
    lo = np.maximum(0, off + i - window + 1) if window > 0 else \
        np.zeros_like(i)
    hi = np.minimum(T, off + i + 1)
    assert (lo[1:] <= hi[:-1]).all()           # the rows' keys run on
    return set(range(lo.min() // bk, -(-hi.max() // bk)))


@pytest.mark.parametrize("shape", EXTEND_SHAPES, ids=_shape_id)
def test_slices_cover_each_live_tile_once(shape):
    """At every offset 0 .. T - C, each query tile's slices are in
    order, disjoint and together exactly its live key tiles; a slice may
    be empty."""
    C, T, W = shape["C"], shape["T"], shape["window"]
    plan = _plan(shape)
    offsets = range(T - C + 1)
    empty = 0
    for off in offsets:
        (per_tile,) = flash_kernel.extend_tile_ranges(plan, C, T, [off], W)
        for qt, slices in enumerate(per_tile):
            assert len(slices) == plan.slices
            want = _live_tiles(C, T, off, qt * plan.q_tile, plan.q_tile, W,
                               plan.block_k)
            got = []
            for (a, b), nxt in zip(slices, slices[1:] + [(None, None)]):
                assert a <= b and (nxt[0] is None or b == nxt[0])
                got += range(a, b)
                empty += a == b
            assert got == sorted(want), (off, qt)
            assert len(got) <= plan.key_tiles
    if plan.slices > 1 and shape is chip_smoke.FLASH_EXTEND:
        assert empty > 0        # offset 0: 1-4 tiles over 5 slices


def test_tile_ranges_take_each_batch_rows_offset():
    plan = _plan(chip_smoke.FLASH_EXTEND_EDGES[2])
    a, b = flash_kernel.extend_tile_ranges(plan, 300, 2560, [1000, 37])
    assert a != b
    assert flash_kernel.extend_tile_ranges(plan, 300, 2560, [37])[0] == b
    # a negative offset is read as 0, as the kernel's max(off, 0)
    assert flash_kernel.extend_tile_ranges(plan, 300, 2560, [-5]) == \
        flash_kernel.extend_tile_ranges(plan, 300, 2560, [0])


# ------------------------------------- the slices and the merge, in fp32
#: (B, H, KV, C, T, D, offsets, window, softcap, slices, block_k, some
#: slice empty): tiny key tiles so that the split has work; G 6 with
#: offsets off any tile, G 3 (one head a CTA) split past its tiles, G 2
#: at D 256 with a window and a softcap, and a split past the tiles a CTA
#: sees at offset 0
SPLIT_CASES = [
    (2, 12, 2, 13, 64, 64, (37, 3), 0, 0.0, 4, 8, True),
    (1, 6, 2, 20, 90, 64, (50,), 0, 0.0, 4, 32, True),
    (1, 4, 2, 11, 96, 256, (70,), 24, 50.0, 3, 8, False),
    (2, 4, 2, 9, 48, 128, (0, 39), 0, 0.0, 4, 16, True),
]


@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: f"G{c[1] // c[2]}-D{c[5]}-S{c[9]}")
def test_split_merge_matches_the_reference(case):
    """Slice partials merged in slice order, every cache slot past a
    row's offset + C NaN: finite, and within fp32 1e-5 of the launch's
    plain version and of the reference's ``attend_decode`` (JAX, fp32)
    on the same numpy inputs."""
    B, H, KV, C, T, D, offs, window, cap, slices, bk, empty = case
    rng = np.random.default_rng(D + slices)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, C, H, D), (B, T, KV, D), (B, T, KV, D))]
    off = np.asarray(offs, np.int32)
    scale = 1.0 / math.sqrt(D)
    want = np.asarray(jax_attn.attend_decode(
        *(jnp.asarray(a) for a in arrs), jnp.asarray(off), scale=scale,
        cap=cap, window=window))
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in arrs)
    plain = flash_attention_ref(q, k, v, q_offset=torch.from_numpy(off),
                                scale=scale, window=window, softcap=cap)
    dead_k, dead_v = k.clone(), v.clone()
    for b, o in enumerate(offs):
        dead_k[b, :, o + C:] = float("nan")
        dead_v[b, :, o + C:] = float("nan")
    plan = dataclasses.replace(
        flash_kernel.plan_extend(B, H, KV, C, T, D, window, slices=slices),
        block_k=bk)
    ranges = flash_kernel.extend_tile_ranges(plan, C, T, offs, window)
    assert empty == any(a == b for per_b in ranges for tile in per_b
                        for a, b in tile)
    got = flash_extend_split_ref(q, dead_k, dead_v, torch.from_numpy(off),
                                 plan=plan, scale=scale, window=window,
                                 softcap=cap)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, plain, **FP32)
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), want, **FP32)


def test_one_slice_is_the_plain_softmax():
    """With one slice the merge is the identity: the model is the plain
    version's fp32 softmax over the CTA's keys."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 6, 7, 32), (1, 2, 40, 32), (1, 2, 40, 32)))
    off = torch.tensor([30], dtype=torch.int32)
    plan = flash_kernel.plan_extend(1, 6, 2, 7, 40, 32, slices=1)
    torch.testing.assert_close(
        flash_extend_split_ref(q, k, v, off, plan=plan),
        flash_attention_ref(q, k, v, q_offset=off), **FP32)


def test_extend_entry_point_takes_the_bound_arguments():
    """``flash_extend_bf16_launch``'s parameter list matches the ctypes
    declaration the wrapper binds: the offsets after the softcap, then
    pair, slices and stages."""
    src = (ROOT / "src" / "repro_torch" / "csrc" /
           "flash_attention.cu").read_text()
    sig = re.search(r"int flash_extend_bf16_launch\(([^)]*)\)",
                    src).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == len(flash_kernel._EXTEND_ARGS)
    assert params[14:18] == ["const void* q_off", "int pair", "int slices",
                             "int stages"]
    assert f"kMaxSlices = {flash_kernel.MAX_SLICES};" in src


# --------------------------------------------------- the norm's geometry
#: every row length a config gives the norm: d_model, and the head dim
#: of a qk-normed family (published and smoke widths)
def _norm_widths() -> set[int]:
    from repro_torch.configs import ARCH_IDS, get_config
    widths = set()
    for arch in ARCH_IDS:
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            widths.add(cfg.d_model)
            if cfg.qk_norm:
                widths.add(cfg.head_dim)
    return widths


@pytest.mark.parametrize("esz", [2, 4])
def test_norm_geometry_is_a_function_of_the_row(esz):
    """One geometry a row length: whole warps a row, at most 512 threads,
    every chunk owned by one thread (t, t + R, ...), a block of at most
    512 threads; rows of up to 64 chunks on one warp."""
    for D in sorted(_norm_widths() | {8, 64, 256, 520, 4096, 8192, 16384,
                                      32768, 65536}):
        if (D * esz) % 16:
            continue
        geo = fusion_kernel.norm_geometry(D, esz)
        assert geo == fusion_kernel.norm_geometry(D, esz)
        chunks = D * esz // 16
        rt, cpt = geo.row_threads, geo.chunks_per_thread
        assert rt % 32 == 0 and 32 <= rt <= 512
        assert geo.threads == rt * geo.rows_per_block <= 512
        assert cpt in (0, 1, 2, 4)
        if cpt:
            assert cpt * rt >= chunks        # every chunk in registers
        else:
            assert rt == 512 and chunks > 4 * 512
        if chunks <= 64:
            assert rt == 32       # the qkv kernel's qk norm order
        elif chunks <= 512:
            assert cpt == 1 and rt == 32 * -(-chunks // 32)


def test_norm_geometry_at_path_a():
    """qwen2-1.5b's 1536-wide rows: one thread a 16-byte chunk, 192 a
    row, a row a block; its 128-wide qk rows one warp."""
    assert fusion_kernel.norm_geometry(1536, 2) == fusion_kernel.NormGeometry(
        row_threads=192, chunks_per_thread=1, rows_per_block=1, threads=192)
    assert fusion_kernel.norm_geometry(128, 2).row_threads == 32
    assert fusion_kernel.norm_geometry(5120, 4).chunks_per_thread == 4


@pytest.mark.parametrize("x,scale", [
    (torch.zeros(4, 12, dtype=torch.bfloat16),
     torch.zeros(12, dtype=torch.bfloat16)),
    (torch.zeros(4, 6), torch.zeros(6)),
])
def test_norm_refuses_partial_chunks_before_any_launch(x, scale):
    with pytest.raises(ValueError, match="16 bytes"):
        fusion_kernel.rms_norm_kernel(x, scale, 1e-6)
    with pytest.raises(ValueError, match="16-byte chunks"):
        fusion_kernel.norm_geometry(x.shape[-1], x.element_size())
    assert launch_counts() == {name: 0 for name in kernel_wrappers()}
    assert not _build._libs


def test_norm_entry_point_takes_the_geometry():
    """``rms_norm_launch`` takes the geometry the wrapper plans, and the
    source's constants are the planner's."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "fusions.cu").read_text()
    sig = re.search(r"int rms_norm_launch\(([^)]*)\)", src).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == len(fusion_kernel._NORM_ARGS)
    assert params[9:12] == ["int rt", "int cpt", "int rows_per_block"]
    assert f"kNormMaxThreads = {fusion_kernel.NORM_MAX_THREADS};" in src
    assert " empty_launch(" in src
