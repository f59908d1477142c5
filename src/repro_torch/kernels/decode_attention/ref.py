"""Plain PyTorch paged decode attention: the version a CPU tensor takes and
the one ``chip_smoke.py`` holds the CUDA kernel against."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def sanitize_block_tables(block_tables: torch.Tensor, seq_lens,
                          page: int) -> torch.Tensor:
    """Rewrite dead (b, ip) table slots (``ip * page >= seq_lens[b]``) to
    the valid sentinel page 0; live slots pass through untouched and must
    already be valid physical page ids (the caller contract). The CUDA
    kernel never reads a dead slot; this is the same contract made
    explicit for gathers that index every slot."""
    lens = torch.as_tensor(seq_lens, dtype=torch.int32,
                           device=block_tables.device)
    ip = torch.arange(block_tables.shape[1], dtype=torch.int32,
                      device=block_tables.device)
    live = ip[None, :] * page < lens[:, None]
    return torch.where(live, block_tables,
                       torch.zeros_like(block_tables)).to(torch.int32)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, seq_lens,
                               *, layer: int | None = None,
                               scale: float | None = None,
                               return_residuals: bool = False):
    """Same shapes and contract as the CUDA kernel: q (B, H, D); pools
    (P, page, KV, D) or (L, P, page, KV, D) with ``layer``; block_tables
    (B, n_tab); seq_lens (B,). Each row attends over exactly its own live
    tokens (dead slots are never gathered), so a row's result does not
    depend on the batch or the table width."""
    if k_pages.dim() == 5:
        li = 0 if layer is None else int(layer)
        k_pages, v_pages = k_pages[li], v_pages[li]
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    n_tab = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    tables = sanitize_block_tables(block_tables, seq_lens, page).long()
    lens = torch.as_tensor(seq_lens).tolist()
    acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=q.device)
    for b, n in enumerate(lens):
        n = min(int(n), n_tab * page)
        if n <= 0:
            continue
        ids = tables[b, :math.ceil(n / page)]
        k = k_pages[ids].reshape(-1, KV, D)[:n].float()       # (T, KV, D)
        v = v_pages[ids].reshape(-1, KV, D)[:n].float()
        qg = q[b].reshape(KV, G, D).float()
        s = torch.einsum("kgd,tkd->kgt", qg, k) * scale
        m[b] = s.amax(-1)
        p = torch.exp(s - m[b][..., None])
        l[b] = p.sum(-1)
        acc[b] = torch.einsum("kgt,tkd->kgd", p, v)
    if return_residuals:
        return acc, m, l
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)
