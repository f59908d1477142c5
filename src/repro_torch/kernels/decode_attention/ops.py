"""Paged decode attention, dispatched by device: a CUDA tensor launches the
hand-written kernel (:mod:`.kernel`), a CPU tensor takes the plain version
(:mod:`.ref`)."""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.kernel import (
    dense_decode_attention_kernel, paged_decode_attention_kernel)
from repro_torch.kernels.decode_attention.ref import (
    dense_decode_ref, paged_decode_attention_ref)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                           layer=None, scale=None, return_residuals=False):
    """q (B, H, D); k/v_pages (P, page, KV, D) or (L, P, page, KV, D) with
    ``layer``; block_tables (B, n_tab); seq_lens (B,). Returns (B, H, D)
    or, with ``return_residuals``, the fp32 ``(acc, m, l)``."""
    if q.device.type == "cuda":
        return paged_decode_attention_kernel(
            q, k_pages, v_pages,
            torch.as_tensor(block_tables, dtype=torch.int32, device=q.device),
            torch.as_tensor(seq_lens, dtype=torch.int32, device=q.device),
            layer=0 if layer is None else int(layer), scale=scale,
            return_residuals=return_residuals)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                          seq_lens, layer=layer, scale=scale,
                                          return_residuals=return_residuals)
    raise ValueError(f"paged_decode_attention: unsupported device {q.device}")


def dense_decode_attention(q, cache_k, cache_v, offsets, *, scale: float,
                           softcap: float = 0.0, window: int = 0):
    """One token a row, q (B, H, D), against a dense cache (B, T, KV, D)
    at the positions ``offsets``: on a CUDA tensor the dense launch
    (``offsets`` a (B,) int32 device tensor), on a CPU tensor its plain
    version."""
    if q.device.type == "cuda":
        return dense_decode_attention_kernel(q, cache_k, cache_v, offsets,
                                             scale=scale, softcap=softcap,
                                             window=window)
    if q.device.type == "cpu":
        return dense_decode_ref(q, cache_k, cache_v, offsets, scale=scale,
                                softcap=softcap, window=window)
    raise ValueError(f"dense_decode_attention: unsupported device "
                     f"{q.device}")
