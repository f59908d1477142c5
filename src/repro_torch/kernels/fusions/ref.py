"""Plain PyTorch versions of the paged decode step's fused passes: the
port's eager spelling of each chain, op for op. A CPU tensor takes them,
the runtime runs them on the card with ``fused=False``, and
``chip_smoke.py`` holds the CUDA kernels against them."""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import matmul, matmul_in
from repro_torch.kernels.decode_attention import (merge_new_token_ref,
                                                  paged_decode_attention)
from repro_torch.models.attention import qkv_finish, write_cache
from repro_torch.models.common import activation_fn, add_rms_norm, rms_norm


def rms_norm_ref(x, scale, eps: float, delta=None, fp32_sum: bool = False):
    """``rms_norm(x)``; with ``delta`` the residual add first, returning
    ``(x + delta, norm)``: the norm reads the fp32 sum (``fp32_sum``,
    ``add_rms_norm``) or the sum rounded to x's dtype."""
    if delta is None:
        return rms_norm(x, scale, eps)
    if fp32_sum:
        return add_rms_norm(x, delta, scale, eps)
    x = x + delta
    return x, rms_norm(x, scale, eps)


def qkv_rope_ref(q, k, v, *, k_out, v_out, bias=None, norm=None,
                 eps: float = 0.0, rope=None):
    """One token's projections q (B, H, Dh), k and v (B, KV, Dh): the
    biases ``(bq, bk, bv)`` added, q and k normed with ``(q_norm,
    k_norm)``, then rotated by ``rope = (cos, sin)`` (B, 1, rot/2) fp32,
    as ``attention.qkv_finish`` orders them. k and v are written into
    ``k_out`` and ``v_out`` (B, KV, Dh); returns q (B, H, Dh),
    contiguous."""
    q, k, v = qkv_finish(q[:, None], k[:, None], v[:, None], bias=bias,
                         norm=norm, eps=eps, rope=rope)
    k_out.copy_(k[:, 0])
    v_out.copy_(v[:, 0])
    return q[:, 0].contiguous()


def qkv_products(x, wq, wk, wv):
    """One token a row's three projections: x (B, 1, d_model) or (B,
    d_model) against wq (d_model, H, Dh), wk and wv (d_model, KV, Dh),
    ``attention.qkv_project``'s products, as (B, heads, Dh)."""
    return tuple(matmul_in(x, w).reshape(-1, *w.shape[1:])
                 for w in (wq, wk, wv))


def qkv_proj_ref(x, wq, wk, wv, *, k_out, v_out, bias=None, norm=None,
                 eps: float = 0.0, rope=None):
    """The decode step's qkv pass: the three products
    (:func:`qkv_products`), then :func:`qkv_rope_ref` (``attention.
    qkv_project``'s chain). k and v are written into ``k_out`` and
    ``v_out`` (B, KV, Dh); returns q (B, H, Dh)."""
    q, k, v = qkv_products(x, wq, wk, wv)
    return qkv_rope_ref(q, k, v, k_out=k_out, v_out=v_out, bias=bias,
                        norm=norm, eps=eps, rope=rope)


def bf16_ulp(t):
    """The bf16 ulp at each element's magnitude, float64."""
    return torch.exp2(torch.floor(torch.log2(
        t.double().abs().clamp_min(2.0 ** -126))) - 7)


def qkv_proj_bound(x, wq, wk, wv, *, bias=None, norm=None, eps: float = 0.0,
                   rope=None) -> tuple:
    """How far ``qkv_proj_kernel``'s q, k and v may lie from
    :func:`qkv_proj_ref`'s, element by element, in float64. Each
    projection is an fp32 sum of d_model products x_i w_i, rounded once
    to bf16; the kernel sums in another order than cuBLAS (its K split
    over a cluster), and two orders' fp32 sums lie within 2 d_model u
    sum_i |x_i w_i| (u = 2^-24) of each other, so the rounded
    projections within that and one bf16 ulp more (where the two sums
    round apart). That gap is carried through the plain spelling's chain:
    the bias add (the gap, and one ulp more where the two sums round
    apart); the qk norm (the row's mean square moved by the gaps moves
    rsqrt by at most rho of itself, (1 - x)^-1/2 <= 1 + x / (2 (1 - x)),
    and 2^-20 more for the fp32 sums' orders; then the gap times the
    scale, and one ulp of the rounding); RoPE (each rounded product
    carries its input's gap times |cos| or |sin| and one ulp, the sum or
    difference one more). Returns (q, k, v) bounds of the outputs'
    shapes."""
    outs = []
    xd = x.reshape(-1, x.shape[-1]).double()
    for i, (p, w) in enumerate(zip(qkv_products(x, wq, wk, wv),
                                   (wq, wk, wv))):
        K = w.shape[0]
        mass = (xd.abs() @ w.reshape(K, -1).double().abs()).reshape(p.shape)
        y = p.double()
        gap = 2 * K * 2.0 ** -24 * mass
        gap = gap + bf16_ulp(y.abs() + gap)
        if bias is not None:
            y = (p + bias[i]).double()
            gap = gap + bf16_ulp(y.abs() + gap)
        if norm is not None and i < 2:
            mean = y.square().mean(-1, keepdim=True)
            dmean = (2 * y.abs() * gap + gap.square()).mean(-1, keepdim=True)
            rho = dmean / (2 * (mean + eps - dmean).clamp_min(1e-300)) \
                + 2.0 ** -20
            scale = (mean + eps).rsqrt() * (1.0 + norm[i].double())
            gap = scale.abs() * (y.abs() * rho + gap * (1 + rho))
            y = y * scale
            gap = gap + bf16_ulp(y.abs() + gap)
        if rope is not None and i < 2:
            cos, sin = (t.to(torch.bfloat16).double().reshape(
                y.shape[0], 1, -1) for t in rope)
            h = cos.shape[-1]
            a, b = y[..., :h], y[..., h:2 * h]
            ga, gb = gap[..., :h], gap[..., h:2 * h]

            def term(v, gv, t):
                return t.abs() * gv + bf16_ulp((v * t).abs() + t.abs() * gv)

            first = term(a, ga, cos) + term(b, gb, sin)
            second = term(b, gb, cos) + term(a, ga, sin)
            gap = torch.cat([
                first + bf16_ulp((a * cos - b * sin).abs() + first),
                second + bf16_ulp((b * cos + a * sin).abs() + second),
                gap[..., 2 * h:]], -1)
        outs.append(gap)
    return tuple(outs)


def qkv_rope_chunk_ref(q, k, v, *, cache_k, cache_v, offsets, k_rows=None,
                       v_rows=None, bias=None, norm=None, eps: float = 0.0,
                       rope=None):
    """A chunk's projections q (N, H, Dh), k and v (N, KV, Dh), N = nb *
    C rows of ``cache_k``'s nb sequences: ``attention.qkv_finish`` over
    their (nb, C, heads, Dh) views, ``rope = (cos, sin)`` tables of N or C
    rows (..., rot/2), then ``attention.write_cache`` into ``cache_k`` /
    ``cache_v`` (nb, T, KV, Dh) at ``offsets`` ((nb,), a tensor: slots
    worked out on its device), and k / v into ``k_rows`` / ``v_rows`` (N,
    KV, Dh) where given. Returns q (N, H, Dh), contiguous."""
    N, H, Dh = q.shape
    nb = cache_k.shape[0]
    C = N // nb
    if rope is not None:
        lead = (nb, C) if rope[0].numel() == N * rope[0].shape[-1] else (C,)
        rope = tuple(t.reshape(*lead, t.shape[-1]) for t in rope)
    q, k, v = qkv_finish(q.view(nb, C, H, Dh), k.view(nb, C, -1, Dh),
                         v.view(nb, C, -1, Dh), bias=bias, norm=norm,
                         eps=eps, rope=rope)
    write_cache(cache_k, cache_v, k, v, offsets)
    if k_rows is not None:
        k_rows.copy_(k.reshape(k_rows.shape))
        v_rows.copy_(v.reshape(v_rows.shape))
    return q.reshape(N, H, Dh).contiguous()


def attend_merged_ref(q, k_pages, v_pages, tables, lens, k_new, v_new, *,
                      layer: int, scale: float):
    """Paged decode attention's residuals over the pages, then the new
    token's exact merge (:func:`merge_new_token_ref`): (B, H, Dh) in q's
    dtype."""
    acc, m, l = paged_decode_attention(q, k_pages, v_pages, tables, lens,
                                       layer=layer, scale=scale,
                                       return_residuals=True)
    return merge_new_token_ref(q, k_new, v_new, acc, m, l, scale)


def gated_act_ref(gate, up, activation: str):
    """``act(gate) * up``, SiLU or the tanh GELU spelled as the JAX
    package computes them (``common._silu``, ``common._gelu_tanh``)."""
    return activation_fn(activation)(gate) * up


def gate_up_act_ref(x, w1, w3, activation: str):
    """``act(x @ w1) * (x @ w3)``: the two products, then
    :func:`gated_act_ref` (``models/mlp.mlp_apply``'s three ops)."""
    return gated_act_ref(matmul(x, w1), matmul(x, w3), activation)
