"""Decode attention's bf16 dense kernel (``csrc/dense_decode.cu``) off the
card: its plan, its refusals and the plain version of its schedule.

The kernel is path E's one-token attention over ``Model.forward``'s cache:
the reference's ``attend_decode`` at C == 1
(``src/repro/models/attention.py:272``). A row's live slots are cut into
``cluster`` splits, one CTA each, the CTAs of a (row, KV head group) one
thread-block cluster that merges them in rank order; a CTA's consumer
warps of a head take its 16-token stages in turn and merge in warp order.
Here:

- the plan (``plan_dense_split``) against the source's bounds, and as a
  function of (T, KV, G, D) alone: the same at every batch size, its
  splits whole stages that cover T; the launch passes it to the source,
  which keeps no plan of its own, in the order the source's entry point
  takes;
- what the kernel does not take is refused on the host, before any
  launch, at every family's (KV, G, Dh);
- the plain version of the schedule (``dense_split_ref``: the ranks'
  splits, each warp's stages, the merges in warp and rank order) against
  ``dense_decode_ref`` and the JAX package's ``attend_decode`` at C == 1
  on the same numpy inputs: gemma2 smoke's heads with the softcap over a
  plain cache and a wrapped ring (also at gemma2-9b's Dh 256), zamba2
  smoke's (and zamba2-2.7b's Dh 80), at forced cluster sizes 1, 2 and 4.

Tolerances: fp32 1e-5 (the same softmax summed in other orders). bf16
inputs: the references evaluated in fp32 on the same bf16 values (the
kernel's arithmetic keeps the scores and P in fp32, P V as bf16 hi + lo),
within one bf16 ulp of the largest output (the output's rounding).
"""
import contextlib
import inspect
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention.ref import (NEG_INF,
                                                      dense_decode_ref,
                                                      dense_split_partials,
                                                      dense_split_ref)

torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "src" /
          "repro_torch" / "csrc" / "dense_decode.cu").read_text()


def source_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+)(?: \* (\d+))?;", SOURCE)
    assert m, name
    return int(m.group(1)) * int(m.group(2) or 1)


@pytest.mark.parametrize("name,value", [
    ("kConsumers", dk.DENSE_CONSUMERS),
    ("kStageTokens", dk.DENSE_STAGE_TOKENS),
    ("kMaxStages", dk.DENSE_MAX_STAGES),
    ("kMaxCluster", dk.DENSE_MAX_CLUSTER),
    ("kBarBytes", dk.DENSE_BAR_BYTES),
    ("kSmemLimit", dk.SMEM_PER_BLOCK)])
def test_constants_match_the_kernel_source(name, value):
    assert source_constant(name) == value
    for d in dk.DENSE_HEAD_DIMS:      # the source's instantiations
        assert f"DENSE_LAUNCH({d})" in SOURCE


#: (T, KV, G, D): path E's shapes (gemma2-9b global and ring, zamba2-2.7b)
#: and other families' heads at other lengths
PLAN_SHAPES = [(4672, 8, 2, 256), (4096, 8, 2, 256), (2048, 32, 1, 80),
               (2560, 2, 6, 128), (32768, 4, 16, 64), (100, 2, 2, 16),
               (5, 8, 1, 128)]


@pytest.mark.parametrize("T,KV,G,D", PLAN_SHAPES)
def test_plan_depends_on_the_cache_alone(T, KV, G, D):
    """The split length and cluster size come from (T, KV, G, D) alone:
    ``plan_dense_split`` takes nothing else, and ``plan_dense_decode``
    gives the same plan at every batch size (the grid's last dimension
    is B). The ranks' splits are whole 16-token stages, rank order,
    covering every slot of a full cache once, none empty at T; a shorter
    row's ranges stop at its length (a row's splits never read past
    it)."""
    assert list(inspect.signature(dk.plan_dense_split).parameters) == \
        ["T", "KV", "G", "D", "cluster"]
    plan = dk.plan_dense_split(T, KV, G, D)
    for B in (1, 2, 3, 8):
        dense = dk.plan_dense_decode(B, T, KV, G, D, 2)
        assert dense.route == "cluster" and dense.split == plan
        assert dense.grid == (plan.cluster, KV // plan.heads, B)
    assert plan.cluster & (plan.cluster - 1) == 0 or \
        plan.cluster == dk.DENSE_PLAN_CLUSTER
    assert 1 <= plan.cluster <= dk.DENSE_PLAN_CLUSTER
    assert plan.split % dk.DENSE_STAGE_TOKENS == 0
    assert 1 <= plan.stages <= dk.DENSE_MAX_STAGES
    assert plan.chunk * plan.cluster >= plan.heads * G * D
    assert plan.chunk & (plan.chunk - 1) == 0
    assert KV % plan.heads == 0 and plan.heads * D * 2 <= 640 or \
        plan.heads == 1
    assert plan.smem_bytes <= dk.SMEM_PER_BLOCK
    ranges = dk.dense_split_ranges(T, plan, T)
    assert ranges[0][0] == 0 and ranges[-1][1] == T
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(t1 > t0 for t0, t1 in ranges)
    for length in (0, 1, T // 3):
        assert max(t1 for _, t1 in
                   dk.dense_split_ranges(T, plan, length)) == length


@pytest.mark.parametrize("D", dk.DENSE_HEAD_DIMS)
def test_boxes_cover_a_head_conflict_free(D):
    """A head's row arrives as TMA boxes at most 256 elements wide that
    cover it, each row of a box an odd number of 16-byte units long (8
    rows read by ldmatrix fall on distinct banks), the boxes' shared
    memory offsets whole 128-byte lines."""
    n, w = dk.dense_boxes(D)
    assert n * w >= D and w <= 256 and (w // 8) % 2 == 1 and w % 8 == 0
    assert (w * 2 * dk.DENSE_STAGE_TOKENS) % 128 == 0


def test_plan_at_path_e_fills_one_wave():
    """Path E's shapes: gemma2-9b a KV head a CTA, 14 splits (8 x 14 =
    112 CTAs at B 1, one an SM), zamba2-2.7b four KV heads a CTA (640
    bytes a token's K), 8 splits (2 x 8 x 8 = 128 at B 2); rings of 5 and
    4 stages, within two CTAs an SM's shared memory."""
    g = dk.plan_dense_split(4672, 8, 2, 256)
    r = dk.plan_dense_split(4096, 8, 2, 256)
    z = dk.plan_dense_split(2048, 32, 1, 80)
    assert (g.heads, g.cluster, g.split, g.stages) == (1, 14, 336, 5)
    assert (r.heads, r.cluster, r.split, r.stages) == (1, 14, 304, 5)
    assert (z.heads, z.cluster, z.split, z.stages) == (4, 8, 256, 4)
    for p in (g, r, z):
        assert 2 * (p.smem_bytes + 1024) <= 233472


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: it walks the wrapper's
    host checks up to the launch, which no test here may reach."""

    @property
    def is_cuda(self):
        return True


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_OnCard, t)


@pytest.fixture
def no_launch(monkeypatch):
    def launched(*_args, **_kw):
        raise AssertionError("a kernel was looked up for a launch")
    monkeypatch.setattr(_build, "function", launched)


def _wrapper_call(KV, G, D, T=64, dtype=torch.bfloat16, **kw):
    q = _on_card(torch.zeros(2, KV * G, D, dtype=dtype))
    cache = _on_card(torch.zeros(2, T, KV, D, dtype=dtype))
    offs = _on_card(torch.full((2,), T - 1, dtype=torch.int32))
    return dk.dense_decode_attention_kernel(q, cache, cache, offs, **kw)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_each_family_taken_or_refused_before_launch(no_launch, arch):
    """Every family with attention, published and smoke widths, bf16: its
    (KV, G, Dh) reaches the launch's lookup through the route its plan
    names (the dense kernel at DENSE_HEAD_DIMS, else the paged split
    kernels); one more query head than the kernels take and a forced
    cluster past 16 are refused with ``ValueError`` before any lookup."""
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        if cfg.family == "ssm":
            continue
        KV, D = cfg.num_kv_heads, cfg.head_dim
        G = cfg.num_heads // KV
        plan = dk.plan_dense_decode(2, 64, KV, G, D, 2)
        assert plan.route == ("cluster" if D in dk.DENSE_HEAD_DIMS
                              else "split")
        with pytest.raises(AssertionError, match="looked up"):
            _wrapper_call(KV, G, D)
        with pytest.raises(ValueError):
            _wrapper_call(KV, 17, D)
        if plan.route == "cluster":
            with pytest.raises(ValueError):
                _wrapper_call(KV, G, D, _cluster=17)
        else:
            with pytest.raises(ValueError):
                _wrapper_call(KV, G, D, _cluster=2)


def _source_params(fn: str) -> list[str]:
    """The parameter names of the source's C entry point ``fn``."""
    m = re.search(rf"\nint {fn}\(([^)]*)\)", SOURCE)
    assert m, fn
    return [p.split()[-1].lstrip("*") for p in m.group(1).split(",")]


#: (T, KV, G, D): path E's shapes and chip_smoke's edges at other heads
#: (G 16 at Dh 128 over two n tiles, two and one KV heads a CTA; Dh 64
#: two heads a CTA; Dh 16 four)
LAUNCH_SHAPES = [(4672, 8, 2, 256), (4096, 8, 2, 256), (2048, 32, 1, 80),
                 (1536, 4, 16, 128), (4000, 1, 16, 128), (3000, 2, 6, 64),
                 (5000, 4, 3, 16)]


@pytest.mark.parametrize("T,KV,G,D", LAUNCH_SHAPES)
def test_launch_passes_the_hosts_plan(monkeypatch, T, KV, G, D):
    """The source keeps no plan: the wrapper passes ``plan_dense_split``'s
    heads, cluster, split, stages and chunk to ``dense_cluster_launch``,
    in the order of the source's parameters and as many arguments as its
    ctypes signature declares, and counts the one launch (the count put
    back after the test, so no other test sees it)."""
    names = _source_params("dense_cluster_launch")
    assert len(names) == len(dk._CLUSTER_ARGTYPES)
    calls = []

    def function(lib, name, argtypes):
        assert lib == "dense_decode"
        return lambda *args: calls.append((name, args)) or 0

    monkeypatch.setattr(_build, "function", function)
    monkeypatch.setattr(dk, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(dk, "device_guard",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(dk, "_DENSE_MAPS", {})
    q = _on_card(torch.zeros(1, KV * G, D, dtype=torch.bfloat16))
    cache = _on_card(torch.zeros(1, T, KV, D, dtype=torch.bfloat16))
    offs = _on_card(torch.full((1,), T - 1, dtype=torch.int32))
    # the count starts at 0 here and is put back after the test
    monkeypatch.setattr(dk.dense_decode_attention_kernel, "launches", 0)
    dk.dense_decode_attention_kernel(q, cache, cache, offs)
    assert dk.dense_decode_attention_kernel.launches == 1
    assert [c[0] for c in calls] == ["dense_cluster_maps",
                                     "dense_cluster_launch"]
    args = dict(zip(names, calls[1][1]))
    plan = dk.plan_dense_split(T, KV, G, D)
    assert {k: args[k] for k in ("B", "T", "KV", "G", "D")} == \
        dict(B=1, T=T, KV=KV, G=G, D=D)
    assert {k: args[k] for k in ("heads", "cluster", "split", "stages",
                                 "chunk")} == {
        k: getattr(plan, k) for k in ("heads", "cluster", "split",
                                      "stages", "chunk")}


@pytest.mark.parametrize("KV,G,D", [(8, 16, 256), (2, 2, 264), (2, 2, 10)])
def test_shapes_no_route_takes_are_refused(no_launch, KV, G, D):
    """G 16 above head_dim 128, a head dim past 256 and one of no whole
    16-byte chunks: refused by the planner, in both dtypes, before any
    lookup."""
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError):
            _wrapper_call(KV, G, D, dtype=dtype)


#: (B, T, KV, G, D, window, softcap, offsets, clusters): gemma2 smoke's
#: heads (KV 2, G 2, Dh 32) with the softcap over a plain cache and over
#: its 32-slot ring wrapped past its slots, gemma2-9b's Dh 256 on a ring,
#: zamba2 smoke's heads (KV 4, G 1, Dh 16) and zamba2-2.7b's Dh 80
SCHEDULES = {
    "gemma2 smoke plain": (2, 48, 2, 2, 32, 0, 50.0, (47, 5), (1, 2)),
    "gemma2 smoke ring wrapped": (3, 32, 2, 2, 32, 32, 50.0, (40, 77, 31),
                                  (1, 2)),
    "gemma2 Dh 256 ring": (2, 64, 2, 2, 256, 64, 50.0, (100, 7), (2, 4)),
    "zamba2 smoke": (2, 40, 4, 1, 16, 0, 0.0, (39, 12), (1, 2)),
    "zamba2 Dh 80": (2, 48, 4, 1, 80, 0, 0.0, (47, 20), (2, 4)),
}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_the_references(name, dtype):
    """``dense_split_ref`` at each forced cluster size against
    ``dense_decode_ref`` and the JAX ``attend_decode`` at C == 1 on the
    same numpy inputs (bf16: the same bf16 values, both references in
    fp32): fp32 within 1e-5; bf16 within one bf16 ulp of the largest
    output."""
    B, T, KV, G, D, window, cap, offs, clusters = SCHEDULES[name]
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in (
        (B, KV * G, D), (B, T, KV, D), (B, T, KV, D)))
    tdt = DTYPES[dtype][1]
    qt, kt, vt = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    qf, kf, vf = (t.float() for t in (qt, kt, vt))   # the same values
    off = torch.tensor(offs, dtype=torch.int32)
    scale = 1.0 / np.sqrt(D)
    jax_out = np.asarray(jax_attn.attend_decode(
        *(jnp.asarray(t.numpy()) for t in (qf[:, None], kf, vf)),
        jnp.asarray(np.asarray(offs, np.int32)), scale=scale, cap=cap,
        window=window)[:, 0])
    want = dense_decode_ref(qf, kf, vf, off, scale=scale, softcap=cap,
                            window=window).numpy()
    for c in clusters:
        plan = dk.dense_geometry(T, KV, G, D, cluster=c)
        got = dense_split_ref(qt, kt, vt, off, scale=scale, softcap=cap,
                              window=window, plan=plan)
        assert got.dtype == tdt
        got = got.float().numpy()
        assert np.isfinite(got).all()
        for ref in (want, jax_out):
            if dtype == "float32":
                np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
            else:
                ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
                assert np.abs(got - ref).max() <= ulp, (name, c, ulp)


def test_partials_follow_the_ranks():
    """A row's partials come rank by rank: ranks past the row's length
    are empty (m -2e38, l 0, acc 0, weighed by exactly 0 in the merge);
    each live rank's l is at least 1 (its max scores e^0); the rows do
    not depend on each other (a row alone gives its partials' bits)."""
    rng = np.random.default_rng(8)
    B, T, KV, G, D = 3, 64, 2, 2, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, KV * G, D), (B, T, KV, D), (B, T, KV, D)))
    offs = torch.tensor([63, 20, 0], dtype=torch.int32)
    plan = dk.dense_geometry(T, KV, G, D, cluster=4)
    rows = dense_split_partials(q, k, v, offs, scale=0.25, plan=plan)
    for b, (acc_s, m_s, l_s) in enumerate(rows):
        live = -(-(int(offs[b]) + 1) // plan.split)
        assert len(m_s) == plan.cluster
        assert (l_s[:live] >= 1).all() and (m_s[:live] > NEG_INF).all()
        assert (m_s[live:] == NEG_INF).all() and (l_s[live:] == 0).all()
        assert (acc_s[live:] == 0).all()
        alone = dense_split_partials(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                     offs[b:b + 1], scale=0.25, plan=plan)
        assert all(torch.equal(x, y) for x, y in zip(alone[0],
                                                      rows[b]))
