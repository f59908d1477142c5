"""Plain PyTorch causal GQA attention (+ sliding window, + tanh softcap):
the version a CPU tensor takes and the one ``chip_smoke.py`` holds the
CUDA kernels against. A port of the JAX package's ``flash_attention_ref``
(one full fp32 softmax per row, softcap before the mask), widened to the
extend launch's shapes: queries at per-row offsets against a longer run
of keys."""
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
