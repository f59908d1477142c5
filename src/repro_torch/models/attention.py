"""Attention: GQA with RoPE / QKV bias / QK-norm / softcap.

Plain tensor code, as in the JAX package (where this lives outside any
Pallas kernel): ``attend_causal`` is the q-chunked online-softmax prefill,
``attend_decode`` is dense attention of new tokens against a contiguous
cache with length masking. The paged decode path goes through the CUDA
kernel instead (:mod:`repro_torch.kernels.decode_attention`).

Layouts: q (B, S, H, Dh); k/v (B, S, KV, Dh); caches (B, S_max, KV, Dh).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (ParamSpec, apply_rope, rms_norm,
                                       rope_tables, softcap)

NEG_INF = -2.0e38  # fp32 mask value (safe under bf16->fp32 upcast)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def attention_specs(cfg: ModelConfig, dtype: str) -> dict[str, ParamSpec]:
    D, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((D, H, Dh), dtype=dtype),
        "wk": ParamSpec((D, KV, Dh), dtype=dtype),
        "wv": ParamSpec((D, KV, Dh), dtype=dtype),
        "wo": ParamSpec((H, Dh, D), dtype=dtype),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((H, Dh), init="zeros", dtype=dtype)
        specs["bk"] = ParamSpec((KV, Dh), init="zeros", dtype=dtype)
        specs["bv"] = ParamSpec((KV, Dh), init="zeros", dtype=dtype)
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((Dh,), init="zeros", dtype=dtype)
        specs["k_norm"] = ParamSpec((Dh,), init="zeros", dtype=dtype)
    return specs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) @ w (D, N, Dh) -> (B, S, N, Dh)."""
    D, N, Dh = w.shape
    return (x @ w.reshape(D, N * Dh)).unflatten(-1, (N, Dh))


def qkv_project(p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,H,Dh), k/v (B,S,KV,Dh) with RoPE applied."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.pos_emb == "rope":
        cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                               cfg.rope_fraction)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def out_project(p: dict, o: torch.Tensor) -> torch.Tensor:
    """o (B, S, H, Dh) @ wo (H, Dh, D) -> (B, S, D)."""
    H, Dh, D = p["wo"].shape
    return o.flatten(-2) @ p["wo"].reshape(H * Dh, D)


# ---------------------------------------------------------------------------
# core block attention (one q block vs one kv block), GQA via reshape
# ---------------------------------------------------------------------------
def _block_attn(q, k, v, mask, scale: float, cap: float):
    """q (B,Q,H,Dh), k/v (B,T,KV,Dh), mask broadcastable to (B,KV,G,Q,T).

    Returns (out (B,Q,H,Dh), m (B,KV,G,Q), l (B,KV,G,Q)) fp32 stats."""
    B, Q, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    if k.dtype != q.dtype:
        k, v = k.to(q.dtype), v.to(q.dtype)
    qg = q.reshape(B, Q, KV, G, Dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k).float() * scale
    if cap > 0:
        s = softcap(s, cap)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)                               # (B,KV,G,Q)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v)
    return o.reshape(B, Q, H, Dh), m, l


def _per_query(stat: torch.Tensor) -> torch.Tensor:
    """(B,KV,G,Q) -> (B,Q,KV*G,1) to scale per-head outputs."""
    B, KV, G, Q = stat.shape
    return stat.permute(0, 3, 1, 2).reshape(B, Q, KV * G)[..., None]


def _combine(acc_o, acc_m, acc_l, o, m, l):
    """Online-softmax merge of two partial blocks."""
    new_m = torch.maximum(acc_m, m)
    c1 = torch.exp(acc_m - new_m)
    c2 = torch.exp(m - new_m)
    new_l = acc_l * c1 + l * c2
    new_o = acc_o * _per_query(c1).to(acc_o.dtype) \
        + o * _per_query(c2).to(acc_o.dtype)
    return new_o, new_m, new_l


def _finalize(o, m, l):
    return o / _per_query(l).clamp_min(1e-30).to(o.dtype)


# ---------------------------------------------------------------------------
# full causal attention (prefill), q-chunked with skipped blocks
# ---------------------------------------------------------------------------
def attend_causal(q, k, v, *, scale: float, cap: float = 0.0,
                  q_chunk: int = 1024, kv_chunk: int = 1024) -> torch.Tensor:
    """Causal attention over the full sequence, in q x kv blocks with an
    online-softmax merge; blocks entirely above the diagonal are skipped."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    G = H // KV
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, S)
    nq, nk = math.ceil(S / q_chunk), math.ceil(S / kv_chunk)
    Sq, Sk = nq * q_chunk, nk * kv_chunk
    if Sq != S:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Sq - S))
    if Sk != S:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, Sk - S))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, Sk - S))
    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        acc_o = torch.zeros_like(q_blk)
        acc_m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                           device=q.device)
        acc_l = torch.zeros_like(acc_m)
        for kj in range(nk):
            k_start = kj * kv_chunk
            if k_start > qi * q_chunk + q_chunk - 1:
                continue                          # above the causal diagonal
            k_pos = k_start + torch.arange(kv_chunk, device=q.device)
            mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] < S)
            o, m, l = _block_attn(q_blk, k[:, k_start:k_start + kv_chunk],
                                  v[:, k_start:k_start + kv_chunk], mask,
                                  scale, cap)
            acc_o, acc_m, acc_l = _combine(acc_o, acc_m, acc_l, o, m, l)
        outs.append(_finalize(acc_o, acc_m, acc_l))
    return torch.cat(outs, dim=1)[:, :S]


# ---------------------------------------------------------------------------
# decode / extend: new tokens vs a contiguous cache
# ---------------------------------------------------------------------------
def write_cache(cache_k, cache_v, k_new, v_new, cache_len) -> None:
    """Write k/v (B,C,KV,Dh) into the caches (B,W,KV,Dh) in place at
    per-sequence offsets ``cache_len`` ((B,) or a scalar), clamped to
    ``W - C`` like ``dynamic_update_slice``."""
    W, C = cache_k.shape[1], k_new.shape[1]
    starts = torch.as_tensor(cache_len).reshape(-1).tolist()
    if len(starts) == 1:
        starts = starts * cache_k.shape[0]
    for b, s in enumerate(starts):
        s = max(0, min(int(s), W - C))
        cache_k[b, s:s + C] = k_new[b].to(cache_k.dtype)
        cache_v[b, s:s + C] = v_new[b].to(cache_v.dtype)


def attend_decode(q, cache_k, cache_v, kv_len, *, scale: float,
                  cap: float = 0.0) -> torch.Tensor:
    """q (B,C,H,Dh) new queries at absolute positions kv_len..kv_len+C-1
    (per batch); the cache (B,T,KV,Dh) already holds the new keys. Dense
    over the cache with validity masking."""
    B, C, H, Dh = q.shape
    T = cache_k.shape[1]
    if isinstance(kv_len, int):          # no host-to-device copy
        kv_len = torch.full((B,), kv_len, dtype=torch.int32, device=q.device)
    else:
        kv_len = torch.as_tensor(kv_len, dtype=torch.int32,
                                 device=q.device).reshape(-1).expand(B)
    slot = torch.arange(T, device=q.device)[None, :]           # (1,T)
    total = kv_len + C                                         # (B,)
    q_pos = kv_len[:, None, None] + torch.arange(C, device=q.device)[
        None, :, None]                                         # (B,C,1)
    mask = (slot[:, None, :] <= q_pos) & \
        (slot[:, None, :] < total[:, None, None])              # (B,C,T)
    o, m, l = _block_attn(q, cache_k, cache_v, mask[:, None, None], scale,
                          cap)
    return _finalize(o, m, l)
