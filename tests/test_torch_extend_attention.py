"""The flash kernels' extend launch off the card: a chunk's queries at
per-row offsets against a longer cache, the reference's ``attend_decode``
over a plain cache (which XLA fuses under ``jit``; no Pallas kernel
computes it).

On the CPU the launch's plain version (``flash_attention_ref`` with
``q_offset``) and the port's ``attend_decode`` are held against the JAX
package's ``attend_decode`` on the same numpy inputs, over per-row
offsets that differ, offsets off any tile, a cache longer than the
chunk's end, G 1/6/8, D 64/80/128/256, a window on a plain cache and a
softcap. The host side of the launch (its plan and refusals) runs here as
pure functions; the model's dispatch is checked with a stand-in for the
launch; and the paged runtime's chunked prefill and extends, fused and
plain, against the JAX runtime. The kernel itself runs on the card only
(``chip_smoke.py`` phase 2 holds it against the plain version here).

Tolerances: fp32 2e-5 (one fp32 softmax over the same scores on both
sides, summed in other orders). bf16: the port's ``attend_decode`` spells
the reference's arithmetic, op for op (scores rounded to bf16, P rounded
to bf16 before P V), within two bf16 ulps of the larger value; the plain
version of the launch keeps fp32 scores and P (as the kernel does, but
for its P in bf16) against the reference's bf16 roundings, within 3e-2
(the bf16 rounding of scores of |s| ~ 3 moves a weight by up to 2^-6
relative, on outputs of |o| <= ~2).
"""
import dataclasses
import pathlib
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.models import attention as jax_attn
from repro.serving.paged_runtime import PagedKVRuntime as JaxRuntime
from repro_torch.configs import get_config
from repro_torch.kernels import _build, kernel_wrappers, launch_counts
from repro_torch.kernels.flash_attention import (flash_attention_ref,
                                                 flash_extend_kernel)
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models import Model
from repro_torch.models import attention
from repro_torch.models.common import params_from_numpy
from repro_torch.serving.paged_runtime import PagedKVRuntime

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FP32 = dict(rtol=2e-5, atol=2e-5)
BF16_LAUNCH = dict(rtol=3e-2, atol=3e-2)

#: (B, H, KV, C, T, D, offsets, window, softcap): G 6 with offsets off any
#: tile and a cache past the chunk's end; G 1 at D 80; G 8 at D 128 with
#: offset 0 and a chunk that ends the cache; D 256 with a window on a
#: plain cache (T > window) and a softcap
CASES = [
    (2, 12, 2, 13, 64, 64, (37, 3), 0, 0.0),
    (1, 4, 4, 16, 80, 80, (50,), 0, 0.0),
    (2, 16, 2, 9, 48, 128, (0, 39), 0, 0.0),
    (1, 4, 2, 11, 96, 256, (70,), 24, 50.0),
]


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def chunk_inputs(B, H, KV, C, T, D, offs, dtype, seed=0):
    """q (B, C, H, D) and the cache (B, T, KV, D) in the model's layout,
    as JAX arrays and CPU tensors of the same values; the offsets."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, C, H, D), (B, T, KV, D), (B, T, KV, D))]
    jax_in = [jnp.asarray(a).astype(jd) for a in arrs]
    torch_in = [torch.from_numpy(a).to(td) for a in arrs]
    return jax_in, torch_in, np.asarray(offs, np.int32)


def heads_first(*xs):
    return [x.transpose(1, 2) for x in xs]


@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"G{c[1] // c[2]}-D{c[5]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_extend_matches_jax_attend_decode(case, dtype):
    """The launch's plain version and the model's ``attend_decode`` (CPU:
    the reference's arithmetic) against the JAX ``attend_decode``."""
    B, H, KV, C, T, D, offs, window, cap = case
    (qj, kj, vj), (qt, kt, vt), off = chunk_inputs(B, H, KV, C, T, D, offs,
                                                   dtype, seed=D)
    scale = 1.0 / np.sqrt(D)
    want = as_np(jax_attn.attend_decode(qj, kj, vj, jnp.asarray(off),
                                        scale=scale, cap=cap,
                                        window=window))
    model = attention.attend_decode(qt, kt, vt, torch.from_numpy(off),
                                    scale=scale, cap=cap, window=window)
    plain = flash_attention_ref(*heads_first(qt, kt, vt), scale=scale,
                                window=window, softcap=cap,
                                q_offset=torch.from_numpy(off))
    assert model.dtype == plain.dtype == DTYPES[dtype][1]
    got_model, got_plain = as_np(model), as_np(plain.transpose(1, 2))
    if dtype == "float32":
        np.testing.assert_allclose(got_model, want, **FP32)
        np.testing.assert_allclose(got_plain, want, **FP32)
        return
    gap = np.abs(got_model - want)
    assert (gap <= 2 * bf16_ulp(np.maximum(np.abs(got_model),
                                           np.abs(want)))).all()
    np.testing.assert_allclose(got_plain, want, **BF16_LAUNCH)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dead_slots_never_reach_the_result(dtype):
    """Slots past each row's offset + C may hold anything (a cache's
    unwritten slots): NaN there gives the bits zeros give."""
    B, H, KV, C, T, D, offs, window, cap = CASES[0]
    _, (q, k, v), off = chunk_inputs(B, H, KV, C, T, D, offs, dtype)
    nan_k, nan_v, zero_k, zero_v = k.clone(), v.clone(), k.clone(), v.clone()
    for b, o in enumerate(offs):
        nan_k[b, o + C:] = nan_v[b, o + C:] = float("nan")
        zero_k[b, o + C:] = zero_v[b, o + C:] = 0
    a = flash_attention_ref(*heads_first(q, nan_k, nan_v),
                            q_offset=torch.from_numpy(off))
    b = flash_attention_ref(*heads_first(q, zero_k, zero_v),
                            q_offset=torch.from_numpy(off))
    assert torch.isfinite(a).all() and torch.equal(a, b)


@pytest.mark.parametrize("fn", ["plain", "model"])
def test_padded_rows_leave_real_rows_alone(fn):
    """A chunk padded past its real rows (the serving path pads to a
    bucket): causality keeps the padding out of every real row."""
    B, H, KV, C, T, D, offs, window, cap = CASES[2]
    _, (q, k, v), off = chunk_inputs(B, H, KV, C, T, D, offs, "bfloat16")
    S = C - 4
    off_t = torch.from_numpy(off)

    def run(qq):
        if fn == "plain":
            return flash_attention_ref(*heads_first(qq, k, v),
                                       q_offset=off_t).transpose(1, 2)
        return attention.attend_decode(qq, k, v, off_t, scale=D ** -0.5)

    assert torch.equal(run(q)[:, :S], run(q[:, :S].contiguous()))


def test_prefill_reference_unchanged_by_the_offsets():
    """Offsets of 0 over keys of the queries' own length are the prefill
    launch's plain version, bit for bit."""
    _, (q, k, v), _ = chunk_inputs(2, 6, 2, 40, 40, 32, (0, 0), "float32")
    q, k, v = heads_first(q, k, v)
    zero = torch.zeros(2, dtype=torch.int32)
    for window, cap in ((0, 0.0), (9, 30.0)):
        assert torch.equal(
            flash_attention_ref(q, k, v, window=window, softcap=cap),
            flash_attention_ref(q, k, v, window=window, softcap=cap,
                                q_offset=zero))


class TestExtendPlan:
    """The host side of the extend launch as pure functions: its tile
    plan, its operand checks and the C entry points' argument lists."""

    def test_path_a_chunk_plan(self):
        """512 queries of 12 heads (G 6) against a 2560-slot scratch: the
        extend plan pairs two heads on a CTA's 64 rows and splits the 20
        K/V tiles of 128 over clusters of 2: 96 CTAs of two warpgroups,
        one wave (the prefill plan of the same queries: 96 one-group
        CTAs); D 256 takes 64-key tiles."""
        plan = flash_kernel.plan_extend(1, 12, 2, 512, 2560, 128)
        assert plan.pair and plan.q_tile == 64 and plan.threads == 256
        assert plan.ctas == 96 and plan.grid == (16, 6, 1)
        assert plan.block_k == 128 and plan.key_tiles == 20
        prefill = flash_kernel.plan_bf16(1, 12, 512, 128)
        assert prefill.grid == (8, 12, 1) and prefill.q_tile == 64
        wide = flash_kernel.plan_extend(1, 16, 8, 200, 4672, 256, 4096)
        assert wide.block_k == 64 and wide.key_tiles == 66

    def test_prefill_plan_unchanged(self):
        for B, H, S, D in ((1, 12, 512, 128), (1, 16, 8192, 256),
                           (2, 8, 1000, 80)):
            plan = flash_kernel.plan_bf16(B, H, S, D)
            assert plan == flash_kernel.plan_bf16(B, H, S, D, plan.q_tile)
            assert plan.key_tiles == -(-S // plan.block_k)

    @pytest.mark.parametrize("edit,error,match", [
        (lambda a: a.update(k=a["k"].float()), TypeError, "share"),
        (lambda a: a.update(q=a["q"][0]), ValueError, "bad shapes"),
        (lambda a: a.update(v=a["v"][:, :, :-1]), ValueError, "bad shapes"),
        (lambda a: a.update(k=a["k"][:1], v=a["v"][:1]), ValueError,
         "do not fit"),
        (lambda a: a.update(k=a["k"][:, :, :0], v=a["v"][:, :, :0]),
         ValueError, "do not fit"),
        (lambda a: a.update(q=a["q"][:, :5]), ValueError, "do not fit"),
        (lambda a: a.update(q=a["q"][..., ::2], k=a["k"][..., ::2],
                            v=a["v"][..., ::2]), ValueError, "unit stride"),
        (lambda a: a.update(off=a["off"].long()), ValueError, "q_offset"),
        (lambda a: a.update(off=a["off"][:1]), ValueError, "q_offset"),
        (lambda a: a.update(off=a["off"][None]), ValueError, "q_offset"),
        (lambda a: a.update(off=torch.stack([a["off"]] * 2, 1)[:, 0]),
         ValueError, "q_offset"),
        (lambda a: a.update(off=(37, 3)), ValueError, "q_offset"),
    ])
    def test_refusals_before_any_launch(self, edit, error, match):
        """Each refusal reached on CPU tensors, before the device check:
        no kernel launched, nothing built."""
        _, (q, k, v), off = chunk_inputs(2, 12, 2, 13, 64, 64, (37, 3),
                                         "bfloat16")
        args = dict(zip(("q", "k", "v"), heads_first(q, k, v)),
                    off=torch.from_numpy(off))
        edit(args)
        with pytest.raises(error, match=match):
            flash_extend_kernel(args["q"], args["k"], args["v"], args["off"])
        assert launch_counts()["flash_extend"] == 0 and not _build._libs

    def test_head_dim_and_grid_limits(self):
        q = torch.zeros((1, 4, 8, 264), dtype=torch.bfloat16)
        k = torch.zeros((1, 2, 16, 264), dtype=torch.bfloat16)
        off = torch.zeros(1, dtype=torch.int32)
        with pytest.raises(ValueError, match="head_dim 264"):
            flash_extend_kernel(q, k, k, off)

    def test_cpu_tensors_are_refused_by_the_launch(self):
        """Well-formed CPU operands reach the device check and stop
        there; the dispatch sends them to the plain version."""
        _, (q, k, v), off = chunk_inputs(2, 12, 2, 13, 64, 64, (37, 3),
                                         "float32")
        q, k, v = heads_first(q, k, v)
        off = torch.from_numpy(off)
        with pytest.raises(ValueError, match="same CUDA device"):
            flash_extend_kernel(q, k, v, off)
        assert launch_counts() == {name: 0 for name in kernel_wrappers()}
        assert not _build._libs

    @pytest.mark.parametrize("entry,args", [
        ("flash_attention_fp32_launch", flash_kernel._FP32_ARGS),
        ("flash_attention_bf16_launch", flash_kernel._BF16_ARGS)])
    def test_entry_points_take_the_bound_arguments(self, entry, args):
        """The C entry points' parameter lists match the ctypes
        declarations the wrappers bind (the offsets after the softcap)."""
        src = (ROOT / "src" / "repro_torch" / "csrc" /
               "flash_attention.cu").read_text()
        sig = re.search(rf"int {entry}\(([^)]*)\)", src).group(1)
        params = [p.strip() for p in sig.split(",")]
        assert len(params) == len(args)
        assert params[8:10] == ["int Sq", "int Sk"]
        assert params[15] == "const void* q_off"


class FakeCuda(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` yes: the model's dispatch
    point takes its CUDA branch, into a stand-in for the launch."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def recorded_launch(monkeypatch):
    """``attention.flash_extend_kernel`` replaced by the launch's plain
    version, recording each call's offsets."""
    calls = []

    def launch(q, k, v, q_offset, *, scale, window, softcap):
        calls.append(q_offset.clone())
        assert q_offset.dtype == torch.int32 and q_offset.is_contiguous()
        return flash_attention_ref(*(torch.Tensor(x) for x in (q, k, v)),
                                   scale=scale, window=window,
                                   softcap=softcap, q_offset=q_offset)

    monkeypatch.setattr(attention, "flash_extend_kernel", launch)
    return calls


@pytest.mark.parametrize("kv_len", [np.array([37, 3]), 21])
def test_attend_decode_routes_chunks_to_the_extend_launch(recorded_launch,
                                                          kv_len):
    """On CUDA tensors a chunk over a plain cache runs the launch, its
    offsets int32 (B,) of kv_len, one for all of a forward's layers; it
    computes what the CPU's plain version does (fp32, 2e-5). One token, a
    ring (T == window), ``plain`` and CPU tensors do not."""
    _, (q, k, v), _ = chunk_inputs(2, 12, 2, 13, 64, 64, (37, 3), "float32")
    kl = torch.from_numpy(kv_len) if isinstance(kv_len, np.ndarray) \
        else kv_len
    fake = q.as_subclass(FakeCuda)
    with attention.forward_scope():
        out = attention.attend_decode(fake, k, v, kl, scale=0.125)
        attention.attend_decode(fake, k, v, kl, scale=0.125)
    assert len(recorded_launch) == 2
    assert recorded_launch[0].tolist() == \
        (np.broadcast_to(kv_len, (2,))).tolist()
    want = attention.attend_decode(q, k, v, kl, scale=0.125)
    np.testing.assert_allclose(as_np(torch.Tensor(out)), as_np(want), **FP32)
    for args, kw in (((fake[:, :1], k, v, kl), {}),
                     ((fake, k[:, :16], v[:, :16], 0), dict(window=16)),
                     ((fake, k, v, kl), dict(plain=True)),
                     ((q, k, v, kl), {})):
        attention.attend_decode(*args, scale=0.125, **kw)
    assert len(recorded_launch) == 2


# ---------------------------------------------------------------- runtime
FP32_LOGITS = dict(rtol=2e-5, atol=5e-4)
#: (program, tokens, pad_to): a 40-token prompt in 16-token chunks (the
#: last 8 padded), a second program's 20 tokens, then extends of 5 and 16
#: tokens (the first padded to 8) on each
RUNTIME_OPS = (("A", 16, 16), ("A", 16, 16), ("A", 8, 16), ("B", 20, 32),
               ("A", 5, 8), ("B", 16, 16), ("B", 5, 8), ("A", 16, 16))


@pytest.fixture(scope="module")
def glm4_pair():
    jcfg = dataclasses.replace(jax_config("glm4-9b", smoke=True),
                               compute_dtype="float32")
    jm = JaxModel(jcfg)
    import jax
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("glm4-9b", smoke=True),
                               compute_dtype="float32")
    tm = Model(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp)),
               device="cpu")
    return jcfg, jp, tcfg, tm


def run_ops(rt, model, ops, make):
    rng = np.random.default_rng(3)
    return [rt.prefill(model, pid, make(rng.integers(0, 100, n)), pad_to=pad)
            for pid, n, pad in ops]


def test_chunked_prefill_and_extends_match_jax_runtime(glm4_pair):
    """Chunked prefill, padded chunks and extends through
    ``PagedKVRuntime(fused=True)`` on the CPU against the JAX runtime
    (fp32, the runtime tests' bound), then a decode step; the same
    runtime with ``fused=False`` gives the same bits."""
    jcfg, jp, tcfg, tm = glm4_pair
    rj = JaxRuntime(jcfg, n_pages=32, page_size=8)
    legs = {f: PagedKVRuntime(tcfg, n_pages=32, page_size=8, device="cpu",
                              fused=f) for f in (True, False)}
    want = run_ops(rj, jp, RUNTIME_OPS, jnp.asarray)
    got = {f: run_ops(rt, tm, RUNTIME_OPS, torch.from_numpy)
           for f, rt in legs.items()}
    for a, b in zip(want, got[True]):
        np.testing.assert_allclose(as_np(b), as_np(a), **FP32_LOGITS)
    assert all(torch.equal(a, b) for a, b in zip(got[True], got[False]))
    for a, b in zip(rj.decode_batch(jp, ["A", "B"]),
                    legs[True].decode_batch(tm, ["A", "B"])):
        np.testing.assert_allclose(as_np(b), as_np(a), **FP32_LOGITS)
    assert launch_counts() == {name: 0 for name in kernel_wrappers()}


@pytest.mark.parametrize("mode", ["prefill", "extend"])
def test_forward_spellings_are_one_on_cpu(mode):
    """``Model.forward(fused=False | True)`` in bf16 on the CPU: the
    fusions' plain versions and the plain attention are the model's own
    ops, bit for bit."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    model = Model(cfg, device="cpu", seed=1)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 24)))
    outs = []
    for fused in (False, True):
        cache = model.init_cache(2, 40)
        if mode == "extend":
            model.forward(toks[:, :10], cache=cache)
            logits, _ = model.forward(toks[:, 10:], cache=cache,
                                      cache_len=10, mode="extend",
                                      fused=fused)
        else:
            logits, _ = model.forward(toks, cache=cache, fused=fused)
        outs.append((logits, cache["k"].clone()))
    for logits, k in outs[1:]:
        assert torch.equal(logits, outs[0][0]) and torch.equal(k, outs[0][1])


# ------------------------------------------------------------- chip_smoke
SMALL_EXTENDS = (("p0", 16, 16), ("p0", 9, 16), ("p1", 12, 16),
                 ("p1", 1, 8))


def test_chunk_fused_vs_plain_on_cpu(monkeypatch):
    """Phase 3's chunk check at smoke width on the CPU: the three legs
    (fused, fusions alone, plain) are one on the CPU, no kernel is
    launched, and the fusions leg's attention is plain whatever the
    model passes."""
    model = Model(get_config("qwen2-1.5b", smoke=True), device="cpu")
    seen = []
    real = attention.attend_decode

    def spy(*args, **kw):
        seen.append(kw.get("plain"))
        return real(*args, **kw)

    monkeypatch.setattr(attention, "attend_decode", spy)
    check = chip_smoke.chunk_fused_vs_plain(
        model, "cpu", prompts=(("p0", 40), ("p1", 600)),
        extends=SMALL_EXTENDS, trace=False)
    chip_smoke.assert_chunk_fused_vs_plain(check, "bfloat16", cuda=False)
    assert check["max_abs_diff"] == 0 == check["fusions"]["max_abs_diff"]
    assert check["chunks"] == len(SMALL_EXTENDS)
    layers = model.cfg.num_layers
    n = len(SMALL_EXTENDS) * layers       # a leg's attend_decode calls
    assert seen[-3 * n:] == [False] * n + [True] * n + [True] * n


def _card_chunk_check() -> dict:
    """A chunk record as the card's 2-layer check gives it."""
    zero = {k: 0 for k in kernel_wrappers()}
    gap = dict(argmax_equal=True, argmax_gap=0.0, max_abs_diff=0.0,
               rms_logit=39.0, max_abs_logit=150.0)
    common = dict(zero, rms_norm=12, gated_act=8)
    return dict(gap, max_abs_diff=0.02, chunks=4, fusions=dict(gap),
                score_max=40.0, scale=128 ** -0.5, layers=2, init="seeded",
                launches_fused=dict(common, flash_extend=8),
                launches_fusions=dict(common), launches_plain=dict(zero))


#: the published init's logits (P13): the bf16 bound at 3.5, 2 layers and
#: a largest raw score of 40 (scale 128^-0.5)
PUBLISHED = dict(init="published", max_abs_logit=3.5, rms_logit=0.8)
SCORE_R = np.expm1(2 * 2.0 ** -9 * 40 / np.sqrt(128)) + 2.0 ** -7
PUBLISHED_BOUND = 2 * SCORE_R * 3.5 + 2 * 2.0 ** -6


@pytest.mark.parametrize("dtype,edit,ok", [
    ("float32", lambda c: None, True),
    ("float32", lambda c: c.update(max_abs_diff=0.039), True),  # 1e-3 rms
    ("float32", lambda c: c.update(max_abs_diff=0.04), False),
    ("float32", lambda c: c.update(argmax_equal=False), False),
    ("float32", lambda c: c["fusions"].update(max_abs_diff=0.04), False),
    ("bfloat16", lambda c: c.update(max_abs_diff=123.75,
                                    argmax_equal=False), True),  # logged
    ("bfloat16", lambda c: c.update(PUBLISHED, max_abs_diff=0.18), True),
    ("bfloat16", lambda c: c.update(PUBLISHED, max_abs_diff=0.19), False),
    ("bfloat16", lambda c: c.update(PUBLISHED, argmax_equal=False,
                                    argmax_gap=0.36), True),  # a near tie
    ("bfloat16", lambda c: c.update(PUBLISHED, argmax_equal=False,
                                    argmax_gap=0.37), False),
    ("bfloat16", lambda c: c["fusions"].update(max_abs_diff=2.0), True),
    ("bfloat16", lambda c: c["fusions"].update(max_abs_diff=2.5), False),
    ("bfloat16", lambda c: c["fusions"].update(argmax_equal=False), False),
    ("float32", lambda c: c["launches_plain"].update(flash_extend=8), False),
    ("float32", lambda c: c["launches_fusions"].update(flash_extend=8),
     False),
    ("float32", lambda c: c["launches_fused"].update(flash_extend=0), False),
    ("float32", lambda c: c["launches_plain"].update(rms_norm=12), False),
    ("float32", lambda c: c["launches_fusions"].update(gated_act=0), False),
])
def test_chunk_bounds_and_counts_on_the_card(dtype, edit, ok):
    """The chunk's gate: fp32 within 1e-3 of the rms with argmax equal;
    bf16 at the published init within P13's bound from the largest raw
    score (its argmax where the bound decides it), at the seeded init
    logged (the plain attention's bf16-rounded scores, P5); the fusions
    alone within two ulps of the largest logit; the extend launch in the
    fused leg alone, the fusions in both fused legs."""
    check = _card_chunk_check()
    assert chip_smoke.chunk_bound(check, "bfloat16") == pytest.approx(
        2 * SCORE_R * 150 + 2 * 2.0 ** 0)
    edit(check)
    assert chip_smoke.chunk_bound(check, "float32") == pytest.approx(
        1e-3 * check["rms_logit"])
    if check["init"] == "published":
        assert chip_smoke.chunk_bound(check, "bfloat16") == pytest.approx(
            PUBLISHED_BOUND)
    if ok:
        chip_smoke.assert_chunk_fused_vs_plain(check, dtype, cuda=True)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.assert_chunk_fused_vs_plain(check, dtype, cuda=True)


@pytest.mark.parametrize("edit,ok", [
    (lambda c: None, True),
    (lambda c: c.update(traced_extend_launches_fused=27), False),
    (lambda c: c.update(traced_attention_ops_fused=["exp_kernel_cuda"]),
     False),
    (lambda c: c.update(traced_wheres_fused=30), False),
    (lambda c: c.update(traced_attention_ops_plain=[]), False),
])
def test_chunk_trace_gate(edit, ok):
    """The traced extend chunk: 28 launches, no score kernels fused."""
    check = dict(traced_extend_launches_fused=28,
                 traced_extend_launches_plain=0,
                 traced_attention_ops_fused=[], traced_wheres_fused=2,
                 traced_attention_ops_plain=list(
                     chip_smoke.PLAIN_ATTENTION_OPS),
                 traced_wheres_plain=30, traced_kernels_fused=900,
                 traced_kernels_plain=2981)
    edit(check)
    if ok:
        chip_smoke.assert_chunk_trace(check, 28)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.assert_chunk_trace(check, 28)


def test_extend_work_at_path_a():
    """Path A's chunk (512 queries on 2048 cached tokens, 12 heads of
    128): 7.25 GFLOP, bound by operations at ~7.3 us on the H100; the
    shapes of phase 2 keep every chunk inside its cache."""
    nbytes, flops = chip_smoke.extend_work(chip_smoke.FLASH_EXTEND, 2)
    pairs = sum(2048 + i + 1 for i in range(512))
    assert flops == 4.0 * 128 * 12 * pairs
    assert nbytes == 2 * 2 * 12 * 512 * 128 + 4 + 2 * 2 * 2560 * 128 * 2
    sheet = chip_smoke.card_datasheet("NVIDIA H100 80GB HBM3")
    ms, by = chip_smoke.bound_ms(nbytes, flops, sheet, "bf16")
    assert by == "operations" and ms == pytest.approx(0.00733, rel=1e-2)
    for shape in (chip_smoke.FLASH_EXTEND,) + chip_smoke.FLASH_EXTEND_EDGES:
        assert len(shape["offs"]) == shape["B"]
        assert max(shape["offs"]) + shape["C"] <= shape["T"]


def test_extend_mask_is_the_reference_mask():
    """chip_smoke's SDPA mask is the plain version's: attention with it
    gives the plain version's output (fp32, 2e-5)."""
    shape = dict(B=2, H=4, KV=2, C=6, T=30, D=16, offs=(20, 3), window=5,
                 softcap=0.0)
    _, (q, k, v), off = chunk_inputs(2, 4, 2, 6, 30, 16, (20, 3), "float32")
    q, k, v = heads_first(q, k, v)
    mask = chip_smoke.extend_mask(shape, "cpu")
    s = torch.einsum("bhcd,bhtd->bhct", q, k.repeat_interleave(2, 1)) / 4.0
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    o = torch.einsum("bhct,bhtd->bhcd", p, v.repeat_interleave(2, 1))
    want = flash_attention_ref(q, k, v, window=5,
                               q_offset=torch.from_numpy(off))
    np.testing.assert_allclose(o.numpy(), want.numpy(), **FP32)
