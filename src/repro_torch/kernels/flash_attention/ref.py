"""Plain PyTorch causal GQA attention (+ sliding window, + tanh softcap):
the version a CPU tensor takes and the one ``chip_smoke.py`` holds the
CUDA kernels against. A port of the JAX package's ``flash_attention_ref``
(one full fp32 softmax per row, softcap before the mask), widened to the
extend launch's shapes: queries at per-row offsets against a longer run
of keys. Also the bf16 extend launch's split over keys as plain torch
(:func:`flash_extend_split_ref`), for the CPU tests of its slices and
merge."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, *, scale: float | None = None,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        q_offset=None) -> torch.Tensor:
    """q (B, H, Sq, D); k/v (B, KV, Sk, D) -> (B, H, Sq, D) in q's dtype.
    Query row i sits at position i (``q_offset`` None, the prefill: Sk ==
    Sq) or at ``q_offset[b] + i`` (a (B,) integer tensor: the extend
    launch's plain version), the keys at positions 0 .. Sk - 1. Keys no
    query of a batch row sees are zeroed before the products, as the
    kernels never let them reach a result (a cache's unwritten slots may
    hold NaN)."""
    B, H, S, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, S, D).float()
    pos = torch.arange(S, device=q.device)[None, :]               # (1, S)
    if q_offset is not None:
        pos = pos + q_offset.to(q.device).long().reshape(-1, 1)   # (B, S)
    key = torch.arange(Sk, device=q.device)
    mask = torch.ones((pos.shape[0], S, Sk), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= key <= pos[..., None]
    if window > 0:
        mask &= key > pos[..., None] - window
    seen = mask.any(1)[:, None, :, None]                     # (B|1, 1, Sk, 1)
    kf = torch.where(seen, k.float(), 0.0)
    vf = torch.where(seen, v.float(), 0.0)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, kf) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, vf)
    return o.reshape(B, H, S, D).to(q.dtype)


def flash_extend_split_ref(q, k, v, q_offset, *, plan, scale=None,
                           window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """The extend launch as its bf16 kernel splits it, in fp32: for each
    batch row, head and query tile of ``plan`` (a
    ``kernel.ExtendPlan``), each slice's key tiles
    (``kernel.extend_tile_ranges``) give a partial (acc, m, l): scores
    masked past the CTA's live keys, causally and by the window, V rows
    past the live keys zeroed, m = -inf and l = 0 where a slice sees no
    key; the partials merge in slice order, f_s = exp(m_s - max m), out =
    sum f_s acc_s / max(sum f_s l_s, 1e-30). q (B, H, C, D), k/v (B, KV,
    T, D), ``q_offset`` (B,) -> (B, H, C, D) in fp32."""
    from repro_torch.kernels.flash_attention.kernel import extend_tile_ranges
    B, H, C, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    offs = [int(o) for o in q_offset]
    ranges = extend_tile_ranges(plan, C, T, offs, window)
    bk, rows = plan.block_k, plan.q_tile
    out = torch.zeros((B, H, C, D), dtype=torch.float32)
    for b, off in enumerate(offs):
        off = max(off, 0)
        for qt, slices in enumerate(ranges[b]):
            q0 = qt * rows
            i = torch.arange(q0, min(C, q0 + rows))
            pos = off + i                                          # (r,)
            kv_end = min(T, off + min(C, q0 + rows))
            qb = q[b, :, q0:q0 + len(i)].float().reshape(KV, G, len(i), D)
            parts = []
            for first, end in slices:
                key = torch.arange(min(first * bk, T), min(end * bk, T))
                live = (key[None] < kv_end) & (key[None] <= pos[:, None])
                if window > 0:
                    live &= key[None] > pos[:, None] - window
                kk = k[b, :, key].float()
                vv = torch.where((key < kv_end)[None, :, None],
                                 v[b, :, key].float(), 0.0)
                sc = torch.einsum("kgrd,ktd->kgrt", qb, kk) * scale
                if softcap > 0:
                    sc = torch.tanh(sc / softcap) * softcap
                sc = torch.where(live, sc, -math.inf)
                m = sc.amax(-1) if len(key) else \
                    torch.full(sc.shape[:-1], -math.inf)
                m_use = torch.where(m == -math.inf, 0.0, m)
                p = torch.exp(sc - m_use[..., None])
                parts.append((torch.einsum("kgrt,ktd->kgrd", p, vv), m,
                              p.sum(-1)))
            mx = torch.stack([m for _, m, _ in parts]).amax(0)
            m_use = torch.where(mx == -math.inf, 0.0, mx)
            acc = torch.zeros_like(qb)
            lsum = torch.zeros_like(mx)
            for a, m, l in parts:
                f = torch.exp(m - m_use)
                acc = acc + f[..., None] * a
                lsum = lsum + f * l
            o = acc / lsum.clamp_min(1e-30)[..., None]
            out[b, :, q0:q0 + len(i)] = o.reshape(H, len(i), D)
    return out
