"""Attention: GQA with RoPE / QKV bias / QK-norm / softcap.

Plain tensor code, as in the JAX package, with one dispatch point:
``attend_causal`` and ``attend_windowed`` (fresh prefill; the second with
gemma2's sliding window) run the hand-written flash-attention kernel on
CUDA tensors (:mod:`repro_torch.kernels.flash_attention`) and the
reference's q-chunked online-softmax blocks (:func:`causal_blocks`,
:func:`windowed_blocks`) on CPU tensors. A training forward calls the
blocks on any device, each block recomputed in backward where its layer
is not (the reference's ``_block_attn_remat``): the kernel has no
backward, and the reference's train step runs its jnp blocks too.
``attend_decode`` is dense attention of new tokens against a contiguous
or ring cache with length and window masking (extend and decode mode, as
in the reference). The paged decode path goes through its own CUDA kernel
(:mod:`repro_torch.kernels.decode_attention`). On a mesh,
:func:`attend_sharded` runs the same functions on each rank's local
pieces (the flash kernel on CUDA tensors, never on a DTensor).

Layouts: q (B, S, H, Dh); k/v (B, S, KV, Dh); caches (B, S_max, KV, Dh).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import matmul_in, matmul_out
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.models.common import (ParamSpec, apply_rope, rms_norm,
                                       rope_tables, softcap)

NEG_INF = -2.0e38  # fp32 mask value (safe under bf16->fp32 upcast)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def attention_specs(cfg: ModelConfig, dtype: str) -> dict[str, ParamSpec]:
    D, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((D, H, Dh), ("embed", "q_heads", "head_dim"),
                        dtype=dtype),
        "wk": ParamSpec((D, KV, Dh), ("embed", "kv_heads", "head_dim"),
                        dtype=dtype),
        "wv": ParamSpec((D, KV, Dh), ("embed", "kv_heads", "head_dim"),
                        dtype=dtype),
        "wo": ParamSpec((H, Dh, D), ("q_heads", "head_dim", "embed"),
                        dtype=dtype),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((H, Dh), ("q_heads", "head_dim"),
                                init="zeros", dtype=dtype)
        specs["bk"] = ParamSpec((KV, Dh), ("kv_heads", "head_dim"),
                                init="zeros", dtype=dtype)
        specs["bv"] = ParamSpec((KV, Dh), ("kv_heads", "head_dim"),
                                init="zeros", dtype=dtype)
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((Dh,), ("head_dim",), init="zeros",
                                    dtype=dtype)
        specs["k_norm"] = ParamSpec((Dh,), ("head_dim",), init="zeros",
                                    dtype=dtype)
    return specs


def qkv_project(p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor):
    """x (B,S,D) -> q (B,S,H,Dh), k/v (B,S,KV,Dh) with RoPE applied."""
    q, k, v = (matmul_in(x, p[w]) for w in ("wq", "wk", "wv"))
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
    return matmul_out(o, p["wo"])


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
    """Causal attention over the full sequence. q (B,S,H,Dh), k/v
    (B,S,KV,Dh) -> (B,S,H,Dh). On CUDA tensors: the flash-attention kernel,
    fed (B,H,S,Dh) views of the same memory (no copy). On CPU tensors:
    :func:`causal_blocks`."""
    if q.is_cuda:
        return flash_attention_kernel(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale, causal=True, window=0,
            softcap=cap).transpose(1, 2)
    return causal_blocks(q, k, v, scale=scale, cap=cap, q_chunk=q_chunk,
                         kv_chunk=kv_chunk)


def _blocks(remat: bool):
    """The block function: recomputed in backward under ``remat``."""
    if not remat:
        return _block_attn
    return lambda *args: checkpoint(_block_attn, *args, use_reentrant=False)


def causal_blocks(q, k, v, *, scale: float, cap: float = 0.0,
                  q_chunk: int = 1024, kv_chunk: int = 1024,
                  remat: bool = False) -> torch.Tensor:
    """Causal attention as q x kv blocks with an online-softmax merge,
    blocks entirely above the diagonal skipped (the JAX package's bf16
    arithmetic, op for op), on any device. ``remat``: each block is
    recomputed in backward instead of keeping its scores."""
    block_attn = _blocks(remat)
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
            o, m, l = block_attn(q_blk, k[:, k_start:k_start + kv_chunk],
                                 v[:, k_start:k_start + kv_chunk], mask,
                                 scale, cap)
            acc_o, acc_m, acc_l = _combine(acc_o, acc_m, acc_l, o, m, l)
        outs.append(_finalize(acc_o, acc_m, acc_l))
    return torch.cat(outs, dim=1)[:, :S]


# ---------------------------------------------------------------------------
# sliding-window causal attention (gemma2's local layers)
# ---------------------------------------------------------------------------
def attend_windowed(q, k, v, *, scale: float, window: int, cap: float = 0.0,
                    q_chunk: int = 1024) -> torch.Tensor:
    """Causal attention where query i sees keys i - window < j <= i. q
    (B,S,H,Dh), k/v (B,S,KV,Dh) -> (B,S,H,Dh). On CUDA tensors: the
    flash-attention kernel with its window. On CPU tensors:
    :func:`windowed_blocks`."""
    if q.is_cuda:
        return flash_attention_kernel(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale, causal=True, window=window,
            softcap=cap).transpose(1, 2)
    return windowed_blocks(q, k, v, scale=scale, window=window, cap=cap,
                           q_chunk=q_chunk)


def windowed_blocks(q, k, v, *, scale: float, window: int, cap: float = 0.0,
                    q_chunk: int = 1024, remat: bool = False) -> torch.Tensor:
    """Sliding-window causal attention, the reference's arithmetic on any
    device: :func:`causal_blocks` while S <= window, else one block a q
    chunk against the static span of ``window + q_chunk`` keys ending at
    the chunk's last row. ``remat`` as in :func:`causal_blocks`."""
    B, S, H, Dh = q.shape
    if S <= window:
        return causal_blocks(q, k, v, scale=scale, cap=cap, q_chunk=q_chunk,
                             kv_chunk=q_chunk, remat=remat)
    q_chunk = min(q_chunk, S)
    nq = math.ceil(S / q_chunk)
    Sq = nq * q_chunk
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, Sq - S))
    span = window + q_chunk
    # left-pad K/V by a span so that every chunk's span is in range
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, span, Sq - S))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, span, Sq - S))
    outs = []
    for qi in range(nq):
        first = qi * q_chunk + q_chunk - span       # position of the span
        q_pos = qi * q_chunk + torch.arange(q_chunk, device=q.device)
        k_pos = first + torch.arange(span, device=q.device)
        mask = (k_pos[None, :] <= q_pos[:, None]) & \
            (k_pos[None, :] > q_pos[:, None] - window) & (k_pos[None, :] >= 0)
        o, m, l = _blocks(remat)(q[:, qi * q_chunk:(qi + 1) * q_chunk],
                                 kp[:, first + span:first + 2 * span],
                                 vp[:, first + span:first + 2 * span], mask,
                                 scale, cap)
        outs.append(_finalize(o, m, l))
    return torch.cat(outs, dim=1)[:, :S]


# ---------------------------------------------------------------------------
# decode / extend: new tokens vs a contiguous or ring cache
# ---------------------------------------------------------------------------
def is_ring(cache_k: torch.Tensor, window: int) -> bool:
    """A sliding-window layer's cache of exactly ``window`` slots is a
    ring (the reference's condition): a shorter one holds every position
    from 0 and is written and masked like a global layer's."""
    return window > 0 and cache_k.shape[1] == window


def _offsets(cache_len, B: int) -> list[int]:
    starts = torch.as_tensor(cache_len).reshape(-1).tolist()
    return starts * B if len(starts) == 1 else starts


def refuse_ring_extend(cache_len, C: int, slots: int) -> None:
    """Raise ``ValueError`` for a chunk of C > 1 tokens after a prefill
    (mode extend, or decode given more than one token) that runs past a
    ring's ``slots`` (cache_len + C > slots). The reference writes
    the chunk into the ring before its queries read it, so the chunk's
    later keys overwrite keys its earlier queries still need, and its
    logits are wrong (ROADMAP R7); the port refuses that case instead of
    copying the wrong answer. A one-token step, and a chunk that stays
    inside the ring, are exact."""
    if C > 1 and max(_offsets(cache_len, 1)) + C > slots:
        raise ValueError(
            f"a chunk of {C} tokens at cache_len {cache_len} runs "
            f"past the {slots}-slot ring of a sliding-window layer: the "
            f"reference overwrites keys the chunk's earlier queries need "
            f"(ROADMAP R7), so the port refuses it; extend at most "
            f"{slots} - cache_len tokens at a time, or decode one by one")


def write_cache(cache_k, cache_v, k_new, v_new, cache_len, *,
                ring: bool = False, slot0: int = 0,
                slots: int | None = None) -> None:
    """Write k/v (B,C,KV,Dh) into the caches (B,W,KV,Dh) in place at
    per-sequence offsets ``cache_len`` ((B,) or a scalar). A plain cache
    is written at slots s..s+C-1, s clamped to ``W - C`` like
    ``dynamic_update_slice``. A ring (a sliding-window layer's W =
    window slots) holds position p in slot p mod W: of a chunk longer
    than W only its last W tokens are written, which is what the
    reference's scatter with repeated slots leaves ("later writes win").
    ``slots``: the caches are the W slots from ``slot0`` of a cache of
    ``slots`` (one rank's piece of a cache sharded on its sequence), and
    only the tokens that land in them are written."""
    W, C = cache_k.shape[1], k_new.shape[1]
    k_new, v_new = k_new.to(cache_k.dtype), v_new.to(cache_v.dtype)
    if slots is not None:
        _write_piece(cache_k, cache_v, k_new, v_new, cache_len, ring, slot0,
                     slots)
        return
    for b, s in enumerate(_offsets(cache_len, cache_k.shape[0])):
        s = int(s)
        if ring:
            n = min(C, W)
            slots = (s + C - n + torch.arange(n, device=cache_k.device)) % W
            cache_k[b, slots] = k_new[b, C - n:]
            cache_v[b, slots] = v_new[b, C - n:]
        else:
            s = max(0, min(s, W - C))
            cache_k[b, s:s + C] = k_new[b]
            cache_v[b, s:s + C] = v_new[b]


def _write_piece(cache_k, cache_v, k_new, v_new, cache_len, ring: bool,
                 slot0: int, slots: int) -> None:
    """:func:`write_cache` into the W slots from ``slot0`` of a cache of
    ``slots``: each token's slot in the whole cache worked out on the
    host, those in the piece written."""
    W, C = cache_k.shape[1], k_new.shape[1]
    for b, s in enumerate(_offsets(cache_len, cache_k.shape[0])):
        s = int(s)
        if ring:
            n = min(C, slots)
            pairs = [((s + i) % slots - slot0, i) for i in range(C - n, C)]
        else:
            s = max(0, min(s, slots - C))
            pairs = [(s + i - slot0, i) for i in range(C)]
        pairs = [(d, i) for d, i in pairs if 0 <= d < W]
        if not pairs:
            continue
        dst, src = (torch.tensor(t, device=cache_k.device)
                    for t in zip(*pairs))
        cache_k[b, dst] = k_new[b, src]
        cache_v[b, dst] = v_new[b, src]


def attend_decode(q, cache_k, cache_v, kv_len, *, scale: float,
                  cap: float = 0.0, window: int = 0) -> torch.Tensor:
    """q (B,C,H,Dh) new queries at absolute positions kv_len..kv_len+C-1
    (per batch); the cache (B,T,KV,Dh) already holds the new keys. Dense
    over the cache with validity masking, and with ``window`` the sliding
    window: in a ring (T == window) slot s holds the latest position p =
    s (mod T) below kv_len + C, in a plain cache slot s holds position
    s. The reference's two masks."""
    return _finalize(*decode_stats(q, cache_k, cache_v, kv_len, scale=scale,
                                   cap=cap, window=window))


def decode_stats(q, cache_k, cache_v, kv_len, *, scale: float,
                 cap: float = 0.0, window: int = 0, slot0: int = 0,
                 slots: int | None = None):
    """:func:`attend_decode` before its normalisation: (o, m, l) as
    :func:`_block_attn` gives them. ``slots``: the cache is the slots from
    ``slot0`` of a cache of ``slots`` (a piece of a cache sharded on its
    sequence); the pieces' stats merge as :func:`_combine` merges
    blocks."""
    B, C, H, Dh = q.shape
    T = cache_k.shape[1] if slots is None else slots
    if isinstance(kv_len, int):          # no host-to-device copy
        kv_len = torch.full((B,), kv_len, dtype=torch.int32, device=q.device)
    else:
        kv_len = torch.as_tensor(kv_len, dtype=torch.int32,
                                 device=q.device).reshape(-1).expand(B)
    slot = slot0 + torch.arange(cache_k.shape[1],
                                device=q.device)[None, :]      # (1,T)
    total = kv_len + C                                         # (B,)
    q_pos = kv_len[:, None, None] + torch.arange(C, device=q.device)[
        None, :, None]                                         # (B,C,1)
    if window > 0 and T == window:
        n_wrap = torch.div(total[:, None] - 1 - slot, T,
                           rounding_mode="floor")
        pos = slot + n_wrap.clamp_min(0) * T                   # (B,T)
        valid = (pos < total[:, None]) & \
            (pos >= (total - window).clamp_min(0)[:, None])
        mask = valid[:, None, :] & (pos[:, None, :] <= q_pos) & \
            (pos[:, None, :] > q_pos - window)
    else:
        mask = (slot[:, None, :] <= q_pos) & \
            (slot[:, None, :] < total[:, None, None])          # (B,C,T)
        if window > 0:
            mask = mask & (slot[:, None, :] > q_pos - window)
    return _block_attn(q, cache_k, cache_v, mask[:, None, None], scale, cap)


# ---------------------------------------------------------------------------
# attention under a mesh: the local pieces of q, k, v and the cache
# ---------------------------------------------------------------------------
def padded_group(G: int, KV: int, width: int) -> int:
    """G' >= G, the query heads a KV group gets when a model axis of
    ``width`` shards the heads and does not divide H = KV * G: the least
    G' with ``width`` dividing KV * G' and the local head count KV * G' /
    width dividing G' or a multiple of it, so each shard reads whole GQA
    groups (ROADMAP R8: padding H as a whole, as the reference does,
    moves real heads to another KV head)."""
    fits = [Gp for Gp in range(G, G * width + 1) if KV * Gp % width == 0]
    for Gp in fits:
        local = KV * Gp // width
        if Gp % local == 0 or local % Gp == 0:
            return Gp
    return fits[0]


def _pad_heads(q, KV: int, Gp: int):
    """q (B,S,KV*G,Dh) -> (B,S,KV*Gp,Dh): zero heads at the end of each KV
    group (heads replicated, so the padding is local)."""
    from repro_torch.dist.sharding import from_local, place
    q = place(q, "act_batch", None, None, None)
    ql = q.to_local().unflatten(2, (KV, -1))
    ql = torch.nn.functional.pad(ql, (0, 0, 0, Gp - ql.shape[3]))
    return from_local(ql.flatten(2, 3), q)


def _unpad_heads(o, KV: int, G: int):
    """The inverse of :func:`_pad_heads` (heads gathered first)."""
    from repro_torch.dist.sharding import from_local, place
    o = place(o, "act_batch", None, None, None)
    ol = o.to_local().unflatten(2, (KV, -1))[:, :, :, :G].flatten(2, 3)
    return from_local(ol, o)


def _kv_for(q, k, Gp: int):
    """The KV heads this rank's query heads read, and their group size:
    a slice of the local KV heads when the local query heads are whole
    groups or within one group, else one KV head gathered per query
    head."""
    from repro_torch.dist.sharding import local_offset
    Hl = q.to_local().shape[2]
    h0, c0 = local_offset(q)[2], local_offset(k)[2]
    idx = [(h0 + i) // Gp - c0 for i in range(Hl)]
    n = idx[-1] - idx[0] + 1
    per = Hl // n
    if Hl % n == 0 and idx == [idx[0] + i // per for i in range(Hl)]:
        return slice(idx[0], idx[0] + n), per
    return torch.tensor(idx, device=q.to_local().device), 1


def _take(t: torch.Tensor, heads):
    return t[:, :, heads] if isinstance(heads, slice) else \
        t.index_select(2, heads)


def attend_sharded(q, k, v, kv, cache_len, *, mode: str, scale: float,
                   cap: float = 0.0, window: int = 0,
                   remat: bool = False):
    """The attention core on DTensors: q (B,S,H,Dh), k/v (B,S,KV,Dh), kv
    the layer's (cache_k, cache_v) DTensors (B,T,KV,Dh) or None. Returns
    o (B,S,H,Dh).

    q is placed on ("act_batch", None, "act_heads", None), k and v on
    ("act_batch", None, "act_kv_heads", None): the reference's constrain
    sites. Each rank then attends on its local pieces, through the same
    functions as one device (on CUDA tensors the flash kernel, which
    never sees a DTensor): its batch rows, its query heads and the KV
    heads they read. A cache sharded on its sequence is written where
    each token's slot lies, and the pieces' softmax stats are merged
    across the ranks that hold it. When the model axis does not divide
    H, each KV group is padded with zero query heads (:func:`padded_group`)
    and the padding is dropped before the out-projection."""
    from torch.distributed._functional_collectives import all_reduce
    from torch.distributed.tensor import Replicate
    from repro_torch.dist.sharding import (current_rules, from_local,
                                           local_offset, place, to_local)
    rules = current_rules()
    KV, H = k.shape[2], q.shape[2]
    G = H // KV
    width = rules.get("__attn_head_pad__", 0)
    Gp = padded_group(G, KV, width) if width else G
    if Gp != G:
        q = _pad_heads(q, KV, Gp)
    q = place(q, "act_batch", None, "act_heads", None)
    k = place(k, "act_batch", None, "act_kv_heads", None)
    v = place(v, "act_batch", None, "act_kv_heads", None)
    heads, _ = _kv_for(q, k, Gp)
    ql = q.to_local()
    b0 = local_offset(q)[0]
    if kv is None:
        kl = _take(to_local(k, q.placements), heads)
        vl = _take(to_local(v, q.placements), heads)
        if mode == "train":
            fn = windowed_blocks if window else causal_blocks
            kw = {"window": window} if window else {}
            ol = fn(ql, kl, vl, scale=scale, cap=cap, remat=remat, **kw)
        elif window:
            ol = attend_windowed(ql, kl, vl, scale=scale, window=window,
                                 cap=cap)
        else:
            ol = attend_causal(ql, kl, vl, scale=scale, cap=cap)
    else:
        ck, cv = kv
        T = ck.shape[1]
        ckl, cvl = ck.to_local(), cv.to_local()
        t0 = local_offset(ck)[1]
        offs = _offsets(cache_len, q.shape[0])[b0:b0 + ql.shape[0]]
        write_cache(ckl, cvl, k.to_local(), v.to_local(), offs,
                    ring=is_ring(ck, window), slot0=t0, slots=T)
        if mode == "prefill":
            kl, vl = _take(k.to_local(), heads), _take(v.to_local(), heads)
            ol = (attend_windowed(ql, kl, vl, scale=scale, window=window,
                                  cap=cap) if window else
                  attend_causal(ql, kl, vl, scale=scale, cap=cap))
        else:
            # the ranks that split the cache's sequence each attend every
            # query head they serve to their piece, and merge the stats
            seq = [i for i, pl in enumerate(ck.placements) if pl.is_shard(1)]
            if any(q.placements[i].is_shard(2) for i in seq):
                q = q.redistribute(q.device_mesh, [
                    Replicate() if i in seq else pl
                    for i, pl in enumerate(q.placements)])
                heads, _ = _kv_for(q, k, Gp)
                ql = q.to_local()
            o, m, l = decode_stats(
                ql, _take(ckl, heads), _take(cvl, heads),
                torch.tensor(offs, dtype=torch.int32, device=ql.device),
                scale=scale, cap=cap, window=window, slot0=t0, slots=T)
            names = ck.device_mesh.mesh_dim_names
            for i in seq:
                group = ck.device_mesh.get_group(names[i])
                m_all = all_reduce(m, "max", group)
                c = torch.exp(m - m_all)
                l = all_reduce(l * c, "sum", group)
                o = all_reduce(o * _per_query(c).to(o.dtype), "sum", group)
                m = m_all
            ol = _finalize(o, m, l)
    o = from_local(ol.contiguous(), q)
    o = place(o, "act_batch", None, "act_heads", None)
    return _unpad_heads(o, KV, G) if Gp != G else o
