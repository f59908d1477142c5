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
``attend_decode`` is attention of new tokens against a contiguous or ring
cache with length and window masking (extend and decode mode, as in the
reference): on CUDA tensors a chunk of several tokens against a plain
cache runs the flash kernels' extend launch, and one token (a plain cache
or a ring) decode attention's dense launch
(:mod:`repro_torch.kernels.decode_attention`; its plain version on CPU
tensors), their offsets read on the device; ``plain``, a chunk on a ring
and CPU chunks take the reference's dense arithmetic
(:func:`decode_stats`). The paged decode path goes through the same
decode kernel over its pages. On a mesh,
:func:`attend_sharded` runs the same functions on each rank's local
pieces (the flash kernel on CUDA tensors, never on a DTensor).

Layouts: q (B, S, H, Dh); k/v (B, S, KV, Dh); caches (B, S_max, KV, Dh).
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import matmul_in, matmul_out
from repro_torch.kernels.decode_attention import dense_decode_attention
from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                 flash_extend_kernel)
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


def qkv_finish(q, k, v, *, bias=None, norm=None, eps: float = 0.0,
               rope=None):
    """The chain after the projections, q (B,S,H,Dh), k/v (B,S,KV,Dh):
    the biases ``(bq, bk, bv)`` added, q and k normed with ``(q_norm,
    k_norm)``, then rotated by ``rope = (cos, sin)``; each optional."""
    if bias is not None:
        q, k, v = q + bias[0], k + bias[1], v + bias[2]
    if norm is not None:
        q = rms_norm(q, norm[0], eps)
        k = rms_norm(k, norm[1], eps)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    return q, k, v


def qkv_project(p: dict, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor | None = None, *, rope=None,
                finish=None, project=None):
    """x (B,S,D) -> q (B,S,H,Dh), k/v (B,S,KV,Dh) with RoPE applied from
    the tables ``rope = (cos, sin)`` (the model builds them once a
    forward), or from tables made of ``positions`` when none are given.
    ``finish`` takes :func:`qkv_finish`'s place (the prefill chunk's fused
    pass) and its result is returned; ``project`` takes the products' and
    the finish's (the paged decode step's qkv pass), called as
    ``project(x, wq, wk, wv, bias=, norm=, eps=, rope=)``."""
    if cfg.pos_emb != "rope":
        rope = None
    elif rope is None:
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_fraction)
    chain = dict(
        bias=(p["bq"], p["bk"], p["bv"]) if cfg.qkv_bias else None,
        norm=(p["q_norm"], p["k_norm"]) if cfg.qk_norm else None,
        eps=cfg.norm_eps, rope=rope)
    if project is not None:
        return project(x, p["wq"], p["wk"], p["wv"], **chain)
    q, k, v = (matmul_in(x, p[w]) for w in ("wq", "wk", "wv"))
    return (finish or qkv_finish)(q, k, v, **chain)


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
    return lambda *args: checkpoint(_block_attn, *args, use_reentrant=False,
                                    preserve_rng_state=False)


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
    only the tokens that land in them are written (:func:`_write_piece`,
    on the device whatever ``cache_len`` is). A tensor ``cache_len`` is
    never read on the host: the slots are worked out on its device
    (:func:`_write_indexed`)."""
    W, C = cache_k.shape[1], k_new.shape[1]
    k_new, v_new = k_new.to(cache_k.dtype), v_new.to(cache_v.dtype)
    if slots is not None:
        _write_piece(cache_k, cache_v, k_new, v_new, cache_len, ring, slot0,
                     slots)
        return
    if isinstance(cache_len, torch.Tensor):
        _write_indexed(cache_k, cache_v, k_new, v_new, cache_len, ring)
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


def _write_indexed(cache_k, cache_v, k_new, v_new, cache_len,
                   ring: bool) -> None:
    """:func:`write_cache` at offsets held in a tensor: each row's slots
    computed on the device (a plain cache's start clamped to ``W - C``,
    a ring's slots taken mod W; once a forward for the layers that share
    a cache shape), written with one indexed copy a cache. No value is
    read back, so a captured step can write at offsets that change
    between replays."""
    B, W = cache_k.shape[:2]
    C = k_new.shape[1]
    dev = cache_k.device
    n = min(C, W) if ring else C

    def make():
        s = cache_len.to(dev).reshape(-1).long().expand(B)
        if ring:
            slots = (s[:, None] + (C - n) + torch.arange(n, device=dev)) % W
        else:
            slots = s.clamp(max=W - C).clamp(min=0)[:, None] + \
                torch.arange(C, device=dev)
        return torch.arange(B, device=dev)[:, None], slots

    rows, slots = _per_forward(cache_len, ("write_slots", B, W, C, ring,
                                           dev), make)
    if ring:
        k_new, v_new = k_new[:, C - n:], v_new[:, C - n:]
    cache_k[rows, slots] = k_new
    cache_v[rows, slots] = v_new


def _write_piece(cache_k, cache_v, k_new, v_new, cache_len, ring: bool,
                 slot0: int, slots: int) -> None:
    """:func:`write_cache` into the W slots from ``slot0`` of a cache of
    ``slots``, at offsets held in a tensor, reading nothing on the host:
    each slot of :func:`_piece_plan`'s window takes the token that lands
    on it, if one does, else its own value. The window's slots are
    distinct, so no write's order matters (an indexed copy with repeated
    slots leaves any one of them)."""
    B, W = cache_k.shape[:2]
    C = k_new.shape[1]
    rows, win, src, keep = _per_forward(
        cache_len, ("piece", B, C, W, ring, slot0, slots),
        lambda: _piece_plan(cache_len, B, C, W, ring, slot0, slots,
                            cache_k.device))
    for cache, new in ((cache_k, k_new), (cache_v, v_new)):
        cache[rows, win] = torch.where(keep, new[rows, src],
                                       cache[rows, win])


def _piece_plan(cache_len, B: int, C: int, W: int, ring: bool, slot0: int,
                slots: int, dev) -> tuple:
    """Where :func:`_write_piece` writes, worked out on the device: the
    rows, the window of piece slots (B, w), the token each window slot
    takes, and whether one lands there ((B, w, 1, 1)).

    A row's tokens land on a run of n slots of the whole cache (a plain
    cache: n = C from the clamped start; a ring: the last n = min(C,
    slots) tokens, from slot (s + C - n) mod slots on), which meets the
    piece in one run of at most w = min(n, W) of its slots, or in all of
    them: a piece of a cache split in two or more holds at most half of
    it, and a ring that wraps within a whole piece wraps with it. The w
    slots taken mod W from where the run enters the piece so cover every
    token that lands there."""
    s = torch.as_tensor(cache_len, device=dev).reshape(-1).long().expand(B)
    n = min(C, slots) if ring else C
    # the run's first slot, and where the run enters the piece
    first = (s + C - n) % slots if ring else \
        s.clamp(max=slots - C).clamp(min=0)
    d0 = first - slot0
    w0 = torch.where((d0 >= 0) & (d0 < W), d0, torch.zeros_like(d0))
    win = (w0[:, None] + torch.arange(min(n, W), device=dev)) % W
    t = slot0 + win - first[:, None]                  # token of each slot
    if ring:
        t = t % slots
    keep = ((t >= 0) & (t < n))[..., None, None]
    src = (C - n + t).clamp(0, C - 1)
    return torch.arange(B, device=dev)[:, None], win, src, keep


_scope = threading.local()


@contextlib.contextmanager
def forward_scope():
    """One forward: what :func:`_per_forward` makes inside it is made once
    and kept until it ends."""
    prev = getattr(_scope, "memo", None)
    _scope.memo = {}
    try:
        yield
    finally:
        _scope.memo = prev


def _per_forward(anchor, key: tuple, make):
    """``make()`` once per (``anchor``, ``key``) within one
    :func:`forward_scope` (anew on every call outside one). The layers
    of a forward write and read at the same offsets, so the index
    tensors worked out from them on the device are made once a forward,
    not once a layer. ``anchor`` (the offsets) is held with the value,
    so its id names it while the scope lives."""
    memo = getattr(_scope, "memo", None)
    if memo is None:
        return make()
    k = (id(anchor),) + key
    if k not in memo:
        memo[k] = (anchor, make())
    return memo[k][1]


def attend_decode(q, cache_k, cache_v, kv_len, *, scale: float,
                  cap: float = 0.0, window: int = 0, plain: bool = False,
                  mode: str = "decode") -> torch.Tensor:
    """q (B,C,H,Dh) new queries at absolute positions kv_len..kv_len+C-1
    (per batch); the cache (B,T,KV,Dh) already holds the new keys, and
    kv_len + C <= T. With ``window`` the sliding window: in a ring (T ==
    window) slot s holds the latest position p = s (mod T) below kv_len +
    C, in a plain cache slot s holds position s. The reference's two
    masks.

    On CUDA tensors a chunk (C > 1) over a plain cache runs the flash
    kernels' extend launch on (B,H,C,Dh) / (B,KV,T,Dh) views of the same
    memory, kv_len its device offsets (:func:`_extend_offsets`: nothing
    read on the host). A decode step's one token (``mode`` "decode",
    :func:`takes_decode_launch`) runs decode attention's dense launch over
    the cache as it lies, plain or ring, at the same offsets (on CPU
    tensors its plain version, these ops' bits); a one-row extend chunk
    does not.
    A chunk on a ring or on CPU tensors, and ``plain`` (what
    ``Model.forward`` passes unless ``fused``) take the reference's dense
    arithmetic, :func:`decode_stats`."""
    B, C = q.shape[:2]
    if takes_decode_launch(C, plain, cache_k.shape[1], window, mode):
        if cache_k.dtype != q.dtype:
            cache_k, cache_v = cache_k.to(q.dtype), cache_v.to(q.dtype)
        return dense_decode_attention(
            q[:, 0].contiguous(), cache_k, cache_v,
            _extend_offsets(kv_len, B, q.device), scale=scale, softcap=cap,
            window=window)[:, None]
    if takes_extend_launch(q.is_cuda, C, plain, is_ring(cache_k, window)):
        if cache_k.dtype != q.dtype:
            cache_k, cache_v = cache_k.to(q.dtype), cache_v.to(q.dtype)
        return flash_extend_kernel(
            q.transpose(1, 2), cache_k.transpose(1, 2),
            cache_v.transpose(1, 2), _extend_offsets(kv_len, q.shape[0],
                                                     q.device),
            scale=scale, window=window, softcap=cap).transpose(1, 2)
    return _finalize(*decode_stats(q, cache_k, cache_v, kv_len, scale=scale,
                                   cap=cap, window=window))


def takes_decode_launch(C: int, plain: bool, T: int, window: int,
                        mode: str = "decode") -> bool:
    """Whether :func:`attend_decode` runs one query a row through decode
    attention's dense launch (its plain version on the CPU): unless
    ``plain``, in a decode step (``mode``; the paged runtime's extend
    chunks keep their route, whatever their rows) at C == 1 over a cache
    of ``T`` slots that needs no window mask at one query (no window, or
    T <= window: a ring, or a plain cache shorter than it;
    ``dense_decode_ref`` says why). A shape rule, decided on the host
    before any launch."""
    return mode == "decode" and C == 1 and not plain and \
        (window == 0 or T <= window)


def takes_extend_launch(cuda: bool, C: int, plain: bool,
                        ring: bool) -> bool:
    """Whether :func:`attend_decode` runs a chunk of ``C`` queries
    through the flash extend launch, which never reads a cache slot past
    a row's last query (the paged runtime then leaves its scratch rows
    past ``start`` as the gather wrote them)."""
    return cuda and C > 1 and not plain and not ring


def _extend_offsets(kv_len, B: int, device) -> torch.Tensor:
    """The offsets of the extend launch and of the chunk's qkv launch: a
    contiguous int32 (B,) tensor on ``device``, one for all the layers of
    a forward; a (1,) or (B,)
    int32 tensor there is used as it is (a view, no launch), a host int
    filled there (no upload)."""
    def make():
        if isinstance(kv_len, int):
            return torch.full((B,), kv_len, dtype=torch.int32,
                              device=device)
        off = torch.as_tensor(kv_len).to(device, torch.int32).reshape(-1)
        return off.expand(B).contiguous()
    return _per_forward(kv_len, ("extend_offsets", B), make)


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
    idx = tuple((h0 + i) // Gp - c0 for i in range(Hl))
    n = idx[-1] - idx[0] + 1
    per = Hl // n
    if Hl % n == 0 and idx == tuple(idx[0] + i // per for i in range(Hl)):
        return slice(idx[0], idx[0] + n), per
    return _head_index(idx, q.to_local().device), 1


@functools.lru_cache(maxsize=64)
def _head_index(idx: tuple, device: torch.device) -> torch.Tensor:
    """The gathered heads' index on ``device``, uploaded once a placement
    and kept: a captured step reads the same tensor every replay."""
    return torch.tensor(idx, device=device)


def _local_offsets(cache_len, B: int, b0: int, Bl: int, device):
    """This rank's rows ``[b0, b0 + Bl)`` of the offsets, an int32 tensor
    on ``device``, one for all the layers of a forward: a slice of a (B,)
    or scalar tensor (a view, nothing read back), or a host int filled
    there (no upload)."""
    def make():
        if isinstance(cache_len, int):
            return torch.full((Bl,), cache_len, dtype=torch.int32,
                              device=device)
        cl = torch.as_tensor(cache_len).to(device, torch.int32)
        return cl.reshape(-1).expand(B)[b0:b0 + Bl]
    return _per_forward(cache_len, ("offsets", B, b0, Bl), make)


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
        offs = _local_offsets(cache_len, q.shape[0], b0, ql.shape[0],
                              ql.device)
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
                ql, _take(ckl, heads), _take(cvl, heads), offs,
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
