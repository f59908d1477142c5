"""The paged decode step's fusions (``repro_torch.kernels.fusions``) off the
card: each plain version against its counterpart in the JAX package, the
runtime's decode step through the fused ops against the composition it
replaced, and the CUDA wrappers' refusals before any build or launch.

The plain versions are the port's eager spelling op for op, so in bf16
they match the JAX package's jitted functions bit for bit at smoke width
(P2's spellings: the norm reading the fp32 residual sum where XLA's
fusion does, the rounded sum at the scan carry); in fp32 within 1e-6.
The CUDA kernels run on the card only (``chip_smoke.py`` phase 2 holds
them against these plain versions).
"""
import dataclasses
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.decode_attention import \
    paged_decode_attention as jax_decode
from repro.models import attention as jax_attn
from repro.models.common import rms_norm as jax_rms_norm
from repro.models.mlp import mlp_apply as jax_mlp_apply
from repro_torch.configs import get_config
from repro_torch.dist.sharding import matmul, matmul_in
from repro_torch.kernels import _build, kernel_wrappers, launch_counts
from repro_torch.kernels import fusions
from repro_torch.kernels.decode_attention import (
    merge_new_token_ref, paged_decode_attention, paged_decode_attention_kernel)
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.decode_attention.kernel import plan_decode
from repro_torch.kernels.page_copy import append_tokens_indexed
from repro_torch.models import Model
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (add_rms_norm, rms_norm, rope_tables,
                                       sinusoidal_emb)
from repro_torch.models.transformer import ffn_apply
from repro_torch.serving.paged_runtime import PAGED_FAMILIES, PagedKVRuntime

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float32": (torch.float32, jnp.float32)}
FP32_TOL = 1e-6
#: the smoke configs of every family the paged runtime serves: dense
#: qwen2 (qkv bias), stablelm (partial rotary), glm4 (G 16 at full
#: width), qwen3-moe (qk norm), pixtral (VLM), musicgen (GELU, sinusoidal
#: positions)
PAGED_ARCHS = ("qwen2-1.5b", "stablelm-3b", "glm4-9b",
               "qwen3-moe-235b-a22b", "pixtral-12b", "musicgen-large")


def rand(rng, shape, dtype: str, std: float = 1.0):
    """The same values as a torch tensor and a JAX array of ``dtype``."""
    a = (rng.standard_normal(shape) * std).astype(np.float32)
    t = torch.from_numpy(a).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.float().numpy()).astype(DTYPES[dtype][1])


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_match(port, ref, dtype: str) -> None:
    """bf16 bit for bit, fp32 within FP32_TOL."""
    if dtype == "bfloat16":
        assert np.array_equal(as_np(port), as_np(ref))
    else:
        np.testing.assert_allclose(as_np(port), as_np(ref), rtol=FP32_TOL,
                                   atol=FP32_TOL)


# --------------------------------------------------- plain vs the JAX package
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["plain", "fp32_sum", "rounded"])
def test_norm_matches_jax(mode, dtype):
    """The norm's three modes against the reference's: ``rms_norm`` alone;
    the residual add and ln2 in one jitted function (XLA's fusion reads
    the fp32 sum); the scan carry (the add rounded, then the norm)."""
    rng = np.random.default_rng(0)
    eps = 1e-6
    (x, xj), (d, dj) = (rand(rng, (4, 1, 64), dtype) for _ in range(2))
    s, sj = rand(rng, (64,), dtype, std=0.1)
    norm = jax.jit(lambda a, b: jax_rms_norm(a, b, eps))
    if mode == "plain":
        assert_match(fusions.rms_norm(x, s, eps), norm(xj, sj), dtype)
        return
    got = fusions.rms_norm(x, s, eps, d, fp32_sum=mode == "fp32_sum")
    if mode == "fp32_sum":
        want = jax.jit(lambda a, b, c: (a + b, jax_rms_norm(a + b, c, eps)))(
            xj, dj, sj)
    else:
        carry = jax.jit(lambda a, b: a + b)(xj, dj)
        want = (carry, norm(carry, sj))
    for a, b in zip(got, want):
        assert_match(a, b, dtype)


def attn_params(rng, cfg, dtype: str) -> tuple[dict, dict]:
    """One layer's attention weights at ``cfg``'s width, torch and JAX."""
    H, KV, Dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.d_model
    shapes = {"wq": (D, H, Dh), "wk": (D, KV, Dh), "wv": (D, KV, Dh)}
    if cfg.qkv_bias:
        shapes.update(bq=(H, Dh), bk=(KV, Dh), bv=(KV, Dh))
    if cfg.qk_norm:
        shapes.update(q_norm=(Dh,), k_norm=(Dh,))
    pt, pj = {}, {}
    for name, shape in shapes.items():
        std = 0.1 if name.endswith("norm") else D ** -0.5 \
            if name.startswith("w") else 0.5
        pt[name], pj[name] = rand(rng, shape, dtype, std)
    return pt, pj


def port_qkv(cfg, p, h, positions):
    """The decode step's projections and the row pass's plain version
    (``fusions.qkv_rope_ref``) for one token a row: (q, k, v) as (B, 1,
    heads, Dh)."""
    q, k, v = (matmul_in(h, p[w])[:, 0] for w in ("wq", "wk", "wv"))
    B, KV, Dh = k.shape
    k_out, v_out = k.new_empty((B, KV, Dh)), v.new_empty((B, KV, Dh))
    rope = rope_tables(positions, Dh, cfg.rope_theta, cfg.rope_fraction) \
        if cfg.pos_emb == "rope" else None
    qd = fusions.qkv_rope_ref(
        q, k, v, k_out=k_out, v_out=v_out,
        bias=(p["bq"], p["bk"], p["bv"]) if cfg.qkv_bias else None,
        norm=(p["q_norm"], p["k_norm"]) if cfg.qk_norm else None,
        eps=cfg.norm_eps, rope=rope)
    return qd[:, None], k_out[:, None], v_out[:, None]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "stablelm-3b",
                                  "qwen3-moe-235b-a22b", "musicgen-large"])
def test_qkv_rope_matches_jax(arch, dtype):
    """Projections, then bias (qwen2), qk norm (qwen3-moe) and RoPE
    (partial in stablelm, none in musicgen) against the reference's
    ``qkv_project``, at decode positions past 1000: jitted in bf16; op by
    op in fp32, where XLA's fusion of the qk norm into the rotation moves
    qwen3-moe's q by up to 1.4e-5 from the op-by-op values (the port's are
    within 5e-7 of those)."""
    cfg = get_config(arch, smoke=True)
    jcfg = jax_config(arch, smoke=True)
    rng = np.random.default_rng(1)
    pt, pj = attn_params(rng, cfg, dtype)
    h, hj = rand(rng, (3, 1, cfg.d_model), dtype)
    pos = np.array([[1000], [1], [1517]], np.int32)

    def project(p, x, s):
        return jax_attn.qkv_project(p, x, jcfg, s)

    want = (jax.jit(project) if dtype == "bfloat16" else project)(
        pj, hj, jnp.asarray(pos))
    got = port_qkv(cfg, pt, h, torch.from_numpy(pos).long())
    for a, b in zip(got, want):
        assert_match(a, b, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "stablelm-3b",
                                  "qwen3-moe-235b-a22b", "musicgen-large"])
def test_qkv_proj_ref_matches_jax(arch, dtype):
    """The decode step's qkv pass as one call (``fusions.qkv_proj``, its
    plain version on the CPU: the three products, then the chain) against
    the reference's ``qkv_project`` at decode positions past 1000: bias
    (qwen2), qk norm (qwen3-moe), partial rotary (stablelm), no RoPE
    (musicgen); bf16 jitted, bit for bit; fp32 op by op within FP32_TOL
    (XLA's fusion of the qk norm into the rotation moves qwen3-moe's q
    by up to 1.4e-5 from the op-by-op values)."""
    cfg = get_config(arch, smoke=True)
    jcfg = jax_config(arch, smoke=True)
    rng = np.random.default_rng(11)
    pt, pj = attn_params(rng, cfg, dtype)
    h, hj = rand(rng, (3, 1, cfg.d_model), dtype)
    pos = np.array([[1000], [7], [2049]], np.int32)

    def project(p, x, s):
        return jax_attn.qkv_project(p, x, jcfg, s)

    want = (jax.jit(project) if dtype == "bfloat16" else project)(
        pj, hj, jnp.asarray(pos))
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    k_out, v_out = (torch.empty(3, KV, Dh, dtype=DTYPES[dtype][0])
                    for _ in range(2))
    rope = rope_tables(torch.from_numpy(pos).long(), Dh, cfg.rope_theta,
                       cfg.rope_fraction) if cfg.pos_emb == "rope" else None
    q = fusions.qkv_proj(
        h, pt["wq"], pt["wk"], pt["wv"], k_out=k_out, v_out=v_out,
        bias=(pt["bq"], pt["bk"], pt["bv"]) if cfg.qkv_bias else None,
        norm=(pt["q_norm"], pt["k_norm"]) if cfg.qk_norm else None,
        eps=cfg.norm_eps, rope=rope)
    for a, b in zip((q[:, None], k_out[:, None], v_out[:, None]), want):
        assert_match(a, b, dtype)


def test_qkv_project_hands_its_pass_to_project():
    """``qkv_project(project=)``: the hook gets the normed rows, the three
    stored weights and the chain ``finish`` would get; the decode step's
    hook (``fusions.qkv_proj``) gives ``qkv_project``'s own q, k and v."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    rng = np.random.default_rng(12)
    pt, _ = attn_params(rng, cfg, "bfloat16")
    h, _ = rand(rng, (2, 1, cfg.d_model), "bfloat16")
    pos = torch.tensor([[3], [900]])
    seen = {}

    def spy(x, wq, wk, wv, **chain):
        seen.update(x=x, w=(wq, wk, wv), **chain)
        return "q"

    assert attn_mod.qkv_project(pt, h, cfg, pos, project=spy) == "q"
    assert seen["x"] is h and all(
        a is pt[n] for a, n in zip(seen["w"], ("wq", "wk", "wv")))
    assert seen["bias"][0] is pt["bq"] and seen["norm"] is None
    assert seen["eps"] == cfg.norm_eps
    want = attn_mod.qkv_project(pt, h, cfg, pos)
    for got, ref in zip(seen["rope"], rope_tables(pos, cfg.head_dim,
                                                  cfg.rope_theta,
                                                  cfg.rope_fraction)):
        assert torch.equal(got, ref)
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    k_out, v_out = (torch.empty(2, KV, Dh, dtype=torch.bfloat16)
                    for _ in range(2))
    q = attn_mod.qkv_project(pt, h, cfg, pos, project=functools.partial(
        fusions.qkv_proj, k_out=k_out, v_out=v_out))
    for a, b in zip((q, k_out, v_out), want):
        assert torch.equal(a, b[:, 0])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_gated_mlp_matches_jax(activation, dtype):
    """``w2(act(w1 x) * w3 x)`` with ``fusions.gated_act`` between the
    products against the reference's ``mlp_apply``."""
    rng = np.random.default_rng(2)
    D, F = 64, 160
    (w1, w1j), (w3, w3j) = (rand(rng, (D, F), dtype, D ** -0.5)
                            for _ in range(2))
    w2, w2j = rand(rng, (F, D), dtype, F ** -0.5)
    x, xj = rand(rng, (4, 1, D), dtype, 2.0)
    got = matmul(fusions.gated_act(matmul(x, w1), matmul(x, w3),
                                   activation), w2)
    want = jax.jit(lambda p, a: jax_mlp_apply(p, a, activation))(
        {"w1": w1j, "w2": w2j, "w3": w3j}, xj)
    assert_match(got, want, dtype)


@pytest.mark.parametrize("arch", PAGED_ARCHS)
@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_gate_up_act_ref_matches_jax(arch, activation):
    """``gate_up_act_ref`` (the two products and the gated activation)
    against the JAX package's gated product at the family's smoke width,
    bf16, bit for bit: the reference's ``mlp_apply`` jitted as the model
    runs it, its w2 the identity, so that its output is the gated product
    itself (one nonzero term a sum)."""
    cfg = get_config(arch, smoke=True)
    D, F = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(3)
    (w1, w1j), (w3, w3j) = (rand(rng, (D, F), "bfloat16", D ** -0.5)
                            for _ in range(2))
    x, xj = rand(rng, (4, 1, D), "bfloat16", 2.0)
    got = fusions.gate_up_act_ref(x, w1, w3, activation)
    want = jax.jit(lambda p, a: jax_mlp_apply(p, a, activation))(
        {"w1": w1j, "w2": jnp.eye(F, dtype=jnp.bfloat16), "w3": w3j}, xj)
    assert got.shape == (4, 1, F)
    assert_match(got, want, "bfloat16")


@pytest.mark.parametrize("rows,dtype,takes", [
    (1, torch.bfloat16, True), (4, torch.bfloat16, True),
    (16, torch.bfloat16, True), (17, torch.bfloat16, False),
    (512, torch.bfloat16, False), (4, torch.float32, False)])
def test_the_decode_ffn_route_is_picked_from_shapes(rows, dtype, takes):
    """The fused step's FFN takes the one-launch product for bf16 rows of
    at most 16 tokens on the card; fp32 and a chunk's rows keep the
    products and the activation's kernel. A CPU tensor never does."""
    from repro_torch.kernels.fusions.kernel import takes_gate_up

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    x = torch.zeros(rows, 1, 64, dtype=dtype)
    assert takes_gate_up(x.as_subclass(OnCard)) is takes
    assert not takes_gate_up(x)


@pytest.mark.parametrize("rows,dtype,Dh,rot,takes", [
    (1, torch.bfloat16, 128, 64, True), (4, torch.bfloat16, 128, 64, True),
    (16, torch.bfloat16, 128, 64, True), (4, torch.bfloat16, 64, 0, True),
    (4, torch.bfloat16, 256, 128, True),
    (17, torch.bfloat16, 128, 64, False),       # more rows: the row pass
    (512, torch.bfloat16, 128, 64, False),      # a chunk's rows
    (4, torch.float32, 128, 64, False),         # fp32
    (4, torch.bfloat16, 80, 10, False),         # stablelm: Dh of no boxes
    (4, torch.bfloat16, 128, 12, False)])       # a partner not a chunk
def test_the_decode_qkv_route_is_picked_from_shapes(rows, dtype, Dh, rot,
                                                    takes):
    """The fused step's qkv pass takes the one launch for bf16 rows of at
    most 16 tokens on the card with a head dim of whole 64-column boxes
    and a rotation of whole 8-channel chunks; everything else keeps the
    three products and the row pass's kernel. A CPU tensor never does."""
    from repro_torch.kernels.fusions.kernel import takes_qkv_proj

    class OnCard(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    x = torch.zeros(rows, 1, 64, dtype=dtype)
    wq = torch.zeros(64, 4, Dh, dtype=dtype)
    wk = torch.zeros(64, 2, Dh, dtype=dtype)
    rope = (torch.zeros(rows, 1, rot),) * 2 if rot else None
    assert takes_qkv_proj(x.as_subclass(OnCard), wq, wk, rope) is takes
    assert not takes_qkv_proj(x, wq, wk, rope)


def jax_merge(qd, k_new, v_new, acc, m, l, scale: float):
    """The reference's merge of the new token (``src/repro/serving/
    paged_runtime.py:411-421``), as it reads there."""
    B, H, Dh = qd.shape
    KV = k_new.shape[1]
    qg = qd.reshape(B, KV, H // KV, Dh).astype(jnp.float32)
    kf = k_new.astype(jnp.float32)
    vf = v_new.astype(jnp.float32)
    s_self = jnp.einsum("bkgd,bkd->bkg", qg, kf) * scale
    m2 = jnp.maximum(m, s_self)
    alpha = jnp.exp(m - m2)
    p_self = jnp.exp(s_self - m2)
    acc2 = acc * alpha[..., None] + p_self[..., None] * vf[:, :, None, :]
    l2 = l * alpha + p_self
    o = (acc2 / jnp.maximum(l2, 1e-30)[..., None]).reshape(B, H, Dh)
    return o.astype(qd.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_merge_matches_jax(dtype):
    """The new token's merge fed the JAX decode kernel's residuals (in
    interpret mode): the port's plain merge against the reference's
    expression on the same residuals, an empty row included; and the
    port's whole plain path (its attention's residuals, then the merge)
    against the reference's within the kernels' fp32 summation order."""
    rng = np.random.default_rng(3)
    L, P, page, KV, G, Dh, B = 2, 12, 8, 2, 3, 16, 3
    (kp, kpj), (vp, vpj) = (rand(rng, (L, P, page, KV, Dh), dtype)
                            for _ in range(2))
    q, qj = rand(rng, (B, KV * G, Dh), dtype)
    (kn, knj), (vn, vnj) = (rand(rng, (B, KV, Dh), dtype) for _ in range(2))
    tables = np.array([[3, 7, 1, 0], [5, 0, 0, 0], [2, 9, 11, 4]], np.int32)
    lens = np.array([19, 0, 30], np.int32)
    scale = Dh ** -0.5
    acc, m, l = jax_decode(qj, kpj, vpj, jnp.asarray(tables),
                           jnp.asarray(lens), layer=1, scale=scale,
                           interpret=True, return_residuals=True)
    want = jax_merge(qj, knj, vnj, acc, m, l, scale)
    res = [torch.from_numpy(np.array(r)) for r in (acc, m, l)]
    got = merge_new_token_ref(q, kn, vn, *res, scale)
    assert_match(got, want, dtype)
    assert np.array_equal(as_np(got[1]), as_np(vn[1]).repeat(G, 0))
    whole = fusions.attend_merged(q, kp, vp, torch.from_numpy(tables),
                                  torch.from_numpy(lens), kn, vn, layer=1,
                                  scale=scale)
    np.testing.assert_allclose(as_np(whole), as_np(want), rtol=0,
                               atol=1e-5 if dtype == "float32" else 2 ** -6)


# --------------------------------- the decode step against its old spelling
def composed_step(rt, model, toks, tables, lens, app_pages, app_offs):
    """The paged decode step as it read before the fusions: every chain
    spelled in torch ops inline (the composition ``fusions``' plain
    versions must reproduce bit for bit)."""
    cfg = rt.cfg
    B = toks.shape[0]
    KV, Dh, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    G = H // KV
    scale = 1.0 / np.sqrt(Dh)
    positions = lens.long()[:, None]
    x = model.params["embed"][toks][:, None]
    if cfg.pos_emb == "sinusoidal":
        x = x + sinusoidal_emb(positions, cfg.d_model).to(x.dtype)
    if cfg.scale_embeddings:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    ks, vs = [], []
    for li, p in enumerate(model.layers):
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn_mod.qkv_project(p["attn"], h, cfg, positions)
        qd = q[:, 0].contiguous()
        k_new, v_new = k[:, 0], v[:, 0]
        acc, m, l = paged_decode_attention(
            qd, rt.k_pages, rt.v_pages, tables, lens, layer=li, scale=scale,
            return_residuals=True)
        qg = qd.reshape(B, KV, G, Dh).float()
        kf, vf = k_new.float(), v_new.float()
        s_self = (qg * kf[:, :, None, :]).sum(-1) * scale
        m2 = torch.maximum(m, s_self)
        alpha = torch.exp(m - m2)
        p_self = torch.exp(s_self - m2)
        acc2 = acc * alpha[..., None] + p_self[..., None] * vf[:, :, None]
        l2 = l * alpha + p_self
        o = (acc2 / l2.clamp_min(1e-30)[..., None]).reshape(B, H, Dh)
        a = attn_mod.out_project(p["attn"], o.to(x.dtype)[:, None])
        x, h2 = add_rms_norm(x, a, p["ln2"], cfg.norm_eps)
        x = x + ffn_apply(p["mlp"], h2, cfg)
        ks.append(k_new)
        vs.append(v_new)
    append_tokens_indexed(rt.k_pages, rt.v_pages, torch.stack(ks),
                          torch.stack(vs), app_pages, app_offs)
    x = rms_norm(x, model.params["final_norm"], cfg.norm_eps)
    logits = (x @ model.head())[:, 0]
    return logits, logits.argmax(-1)


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_step_equals_its_old_composition(arch):
    """For every family the runtime pages, the decode step on the CPU
    (the fused ops' CPU dispatch, and ``fused=False``) gives the old
    composition's logits, next tokens and pools bit for bit, in bf16 over
    a ragged batch with an empty row."""
    cfg = get_config(arch, smoke=True)
    assert cfg.family in PAGED_FAMILIES
    model = Model(cfg, device="cpu", seed=0)
    rt = PagedKVRuntime(cfg, n_pages=16, page_size=8, device="cpu")
    rng = np.random.default_rng(4)
    for pid, n in (("a", 13), ("b", 22)):
        rt.prefill(model, pid, torch.from_numpy(
            rng.integers(0, cfg.vocab_size, n)))
    toks = torch.tensor([5, 9, 2])
    tables = torch.tensor([rt.pages_of("a") + [0], rt.pages_of("b"),
                           [0, 0, 0]], dtype=torch.int32)
    lens = torch.tensor([13, 22, 0], dtype=torch.int32)
    free = rt.free[-3:]
    app_pages = torch.tensor([rt.pages_of("a")[1], rt.pages_of("b")[2],
                              free[0]], dtype=torch.int32)
    app_offs = torch.tensor([5, 6, 0], dtype=torch.int32)
    args = (toks, tables, lens, app_pages, app_offs)
    pools = rt.k_pages.clone(), rt.v_pages.clone()
    legs = []
    for leg in ("fused", "plain", "composed"):
        rt.k_pages.copy_(pools[0])
        rt.v_pages.copy_(pools[1])
        rt.fused = leg == "fused"
        step = composed_step if leg == "composed" else \
            type(rt)._decode_step
        logits, nxt = step(rt, model, *args)
        legs.append((logits, nxt, rt.k_pages.clone(), rt.v_pages.clone()))
    for leg in legs[:2]:
        for a, b in zip(leg, legs[2]):
            assert torch.equal(a, b), arch
    assert launch_counts() == {name: 0 for name in kernel_wrappers()}


# ------------------------------------------------------- the CUDA wrappers
def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _qkv_proj(rows: int = 4, dtype=torch.bfloat16, Dh: int = 64,
              rot: int = 16, **edit):
    """The qkv launch on CPU tensors of 64-wide rows, 4 query and 2 KV
    heads, edited."""
    a = dict(x=torch.zeros(rows, 1, 64, dtype=dtype),
             wq=torch.zeros(64, 4, Dh, dtype=dtype),
             wk=torch.zeros(64, 2, Dh, dtype=dtype),
             wv=torch.zeros(64, 2, Dh, dtype=dtype),
             k_out=torch.zeros(rows, 2, Dh, dtype=dtype),
             v_out=torch.zeros(rows, 2, Dh, dtype=dtype),
             rope=(torch.zeros(rows, 1, rot), torch.zeros(rows, 1, rot)))
    a.update(edit)
    return fusions.qkv_proj_kernel(a.pop("x"), a.pop("wq"), a.pop("wk"),
                                   a.pop("wv"), **a)


def _merged(G: int, Dh: int = 16):
    """Decode attention with the new token merged, on CPU pools."""
    pool = torch.zeros(2, 4, 8, 2, Dh)
    return paged_decode_attention_kernel(
        torch.zeros(3, 2 * G, Dh), pool, pool,
        torch.zeros(3, 2, dtype=torch.int32), torch.ones(3, dtype=torch.int32),
        layer=1, scale=0.25,
        new_kv=(torch.zeros(3, 2, Dh), torch.zeros(3, 2, Dh)))


@pytest.mark.parametrize("call,match", [
    # CPU tensors, every shape right
    (lambda: fusions.rms_norm_kernel(_bf16(4, 1, 64), _bf16(64), 1e-6),
     "CUDA"),
    (lambda: fusions.rms_norm_kernel(_bf16(4, 64), _bf16(64), 1e-6,
                                     _bf16(4, 64), True), "CUDA"),
    (lambda: fusions.qkv_rope_kernel(
        _bf16(3, 6, 16), _bf16(3, 2, 16), _bf16(3, 2, 16),
        k_out=_bf16(3, 2, 16), v_out=_bf16(3, 2, 16)), "CUDA"),
    (lambda: _merged(3), "CUDA"),
    (lambda: fusions.gated_act_kernel(_bf16(4, 1, 64), _bf16(4, 1, 64),
                                      "silu"), "CUDA"),
    # rows the 16-byte loads cannot take: 12 and 4 bf16 elements, an
    # address 2 bytes off, a qk-normed head of 12
    (lambda: fusions.rms_norm_kernel(_bf16(4, 12), _bf16(12), 1e-6),
     "16 bytes"),
    (lambda: fusions.rms_norm_kernel(_bf16(65)[1:], _bf16(64), 1e-6),
     "16 bytes"),
    (lambda: fusions.gated_act_kernel(_bf16(4, 4), _bf16(4, 4), "gelu"),
     "16 bytes"),
    (lambda: fusions.qkv_rope_kernel(
        _bf16(3, 6, 12), _bf16(3, 2, 12), _bf16(3, 2, 12),
        k_out=_bf16(3, 2, 12), v_out=_bf16(3, 2, 12),
        norm=(_bf16(12), _bf16(12))), "16 bytes"),
    # G > 16 and other shapes the kernels do not take
    (lambda: plan_decode(3, 2, 17, 16, 2, 8, 2), "at most 16"),
    (lambda: fusions.qkv_rope_kernel(
        _bf16(3, 2, 512), _bf16(3, 2, 512), _bf16(3, 2, 512),
        k_out=_bf16(3, 2, 512), v_out=_bf16(3, 2, 512)), "at most 256"),
    (lambda: fusions.gated_act_kernel(_bf16(4, 64), _bf16(4, 64), "relu"),
     "activation"),
    # the gate/up product: CPU tensors, 17 tokens, fp32, widths not whole
    # 16-byte rows, an address 2 bytes off, a mismatched w3, a bad
    # activation, weights that are not matrices
    (lambda: fusions.gate_up_act_kernel(_bf16(4, 1, 64), _bf16(64, 128),
                                        _bf16(64, 128), "silu"), "CUDA"),
    (lambda: fusions.gate_up_act_kernel(_bf16(17, 64), _bf16(64, 128),
                                        _bf16(64, 128), "silu"), "1 to 16"),
    (lambda: fusions.gate_up_act_kernel(_bf16(4, 64).float(),
                                        _bf16(64, 128), _bf16(64, 128),
                                        "silu"), "bfloat16"),
    (lambda: fusions.gate_up_act_kernel(_bf16(4, 60), _bf16(60, 128),
                                        _bf16(60, 128), "gelu"), "16 bytes"),
    (lambda: fusions.gate_up_act_kernel(_bf16(4, 64), _bf16(64, 132),
                                        _bf16(64, 132), "gelu"), "16 bytes"),
    (lambda: fusions.gate_up_act_kernel(_bf16(4 * 64 + 1)[1:].view(4, 64),
                                        _bf16(64, 128), _bf16(64, 128),
                                        "silu"), "16 bytes"),
    (lambda: fusions.gate_up_act_kernel(_bf16(4, 64), _bf16(64, 128),
                                        _bf16(64, 136), "silu"), "d_model"),
    (lambda: fusions.gate_up_act_kernel(_bf16(4, 64), _bf16(64, 128),
                                        _bf16(64, 128), "relu"),
     "activation"),
    (lambda: fusions.gate_up_act_kernel(_bf16(4, 64), _bf16(64 * 128),
                                        _bf16(64 * 128), "silu"), "d_model"),
    (lambda: fusions.rms_norm_kernel(_bf16(4, 64), _bf16(64).float(),
                                     1e-6), "every tensor"),
    # the qkv launch: CPU tensors, 17 tokens, fp32, a head dim of no whole
    # boxes, a partner that is not a whole chunk, weights that disagree,
    # outputs of the wrong shape, an address 2 bytes off
    (lambda: _qkv_proj(), "CUDA"),
    (lambda: _qkv_proj(rows=17), "1 to 16"),
    (lambda: _qkv_proj(dtype=torch.float32), "bfloat16"),
    (lambda: _qkv_proj(Dh=80), "boxes"),
    (lambda: _qkv_proj(rot=12), "chunks"),
    (lambda: _qkv_proj(wk=_bf16(64, 2, 128)), "d_model"),
    (lambda: _qkv_proj(k_out=_bf16(4, 3, 64)), "outputs"),
    (lambda: _qkv_proj(x=_bf16(4 * 64 + 1)[1:].view(4, 1, 64)), "16 bytes"),
])
def test_wrappers_refuse_before_any_launch(call, match):
    """The CUDA wrappers check shapes, dtypes, rows and the device before
    they build or launch anything: a CPU tensor, a row the 16-byte loads
    cannot take and G > 16 raise ``ValueError``."""
    with pytest.raises(ValueError, match=match):
        call()
    assert launch_counts() == {name: 0 for name in kernel_wrappers()}
    assert not _build._libs


def test_fusions_source_builds_for_hopper():
    """``fusions.cu`` is one of the sources ``_build`` compiles for
    ``sm_90a`` from the checkout, and names nothing of the JAX package."""
    assert "fusions" in _build.SOURCES
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    src = (_build.CSRC / "fusions.cu").read_text()
    assert _build.CSRC == ROOT / "src" / "repro_torch" / "csrc"
    assert "import jax" not in src and "repro." not in src
    for entry in ("rms_norm_launch", "qkv_rope_launch", "gated_act_launch",
                  "gate_up_maps", "gate_up_launch", "qkv_proj_maps",
                  "qkv_proj_launch", "repro_error_string"):
        assert f" {entry}(" in src
    assert _build.library_path("fusions").parent == _build.BUILD_DIR


@pytest.mark.parametrize("entry,args", [
    ("qkv_rope_launch", "_ROPE_ARGS"), ("qkv_rope_cache_launch",
                                        "_CACHE_ARGS"),
    ("qkv_proj_launch", "_QP_ARGS")])
def test_qkv_entry_points_take_the_bound_arguments(entry, args):
    """Each qkv entry point's C parameter list matches the ctypes
    declaration its wrapper binds, type by type: the row pass's layout
    (``rt``, then ``shared``), the qkv launch's cluster split before
    ``eps``."""
    from repro_torch.kernels.fusions import kernel as fk
    src = (_build.CSRC / "fusions.cu").read_text()
    sig = re.search(rf"int {entry}\(([^)]*)\)", src).group(1)
    params = [" ".join(p.split()[:-1]) for p in sig.split(",")]
    ctypes_of = {"const void*": fk._P, "void*": fk._P, "int": fk._I,
                 "float": fk._F, "long long": fk._L}
    assert [ctypes_of[p] for p in params] == getattr(fk, args)
    names = [p.split()[-1] for p in sig.split(",")]
    if entry == "qkv_proj_launch":
        assert names[-3:] == ["split", "eps", "stream"]
    else:
        assert names.index("shared") == names.index("rt") + 1


def test_every_fusion_counts_its_launches():
    """The fusions' wrappers have launch counts beside the six ported
    kernels'; the new token's merge has none of its own: it rides in
    decode attention's one launch, counted there."""
    wrappers = kernel_wrappers()
    for name, fn in (("rms_norm", fusions.rms_norm_kernel),
                     ("qkv_rope", fusions.qkv_rope_kernel),
                     ("gated_act", fusions.gated_act_kernel),
                     ("gate_up_act", fusions.gate_up_act_kernel),
                     ("qkv_proj", fusions.qkv_proj_kernel),
                     ("paged_decode_attention",
                      decode_kernel.paged_decode_attention_kernel)):
        assert wrappers[name] is fn and fn.launches == 0
    assert "decode_merge" not in wrappers


def test_fused_flag_drops_the_graphs():
    """Turning ``fused`` off (or on) drops the captured decode buckets: a
    graph holds the kernels of the step it captured. The prefill chunk's
    buckets hold its spelling too (its norms, activation and extend
    attention): kept when the flag is back before the next chunk, dropped
    when a chunk runs under the other spelling."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              num_layers=1)
    model = Model(cfg, device="cpu", seed=0)
    rt = PagedKVRuntime(cfg, n_pages=8, page_size=8, device="cpu")
    rt.prefill(model, "a", torch.arange(5))
    rt.decode(model, "a")
    assert rt.graphs.buckets()
    prefill = dict(rt.prefill_graphs.buckets())
    assert prefill
    rt.fused = False
    logits = rt.decode(model, "a")
    (bucket,) = rt.graphs.buckets().values()
    assert torch.isfinite(logits).all()
    rt.fused = True
    rt.decode(model, "a")
    rt.prefill(model, "b", torch.arange(5))
    assert all(b is not bucket for b in rt.graphs.buckets().values())
    assert all(rt.prefill_graphs.buckets()[k] is b
               for k, b in prefill.items())
    rt.fused = False
    rt.prefill(model, "c", torch.arange(5))
    assert all(b is not old for old in prefill.values()
               for b in rt.prefill_graphs.buckets().values())
