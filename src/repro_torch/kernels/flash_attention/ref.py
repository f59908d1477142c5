"""Plain PyTorch causal GQA attention (+ sliding window, + tanh softcap):
the version a CPU tensor takes and the one ``chip_smoke.py`` holds the
CUDA kernel against. A port of the JAX package's ``flash_attention_ref``:
one full fp32 softmax per row, softcap before the mask."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, *, scale: float | None = None,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q (B, H, S, D); k/v (B, KV, S, D) -> (B, H, S, D) in q's dtype."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, S, D).float()
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)
