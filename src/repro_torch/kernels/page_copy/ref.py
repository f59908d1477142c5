"""Plain PyTorch page gather / scatter / append: the versions a CPU tensor
takes and the ones ``chip_smoke.py`` holds the CUDA kernels against.
Like the kernels, scatter, copy and append update the pools in place."""
from __future__ import annotations

import torch


def _idx(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.long, device=device)


def page_gather_ref(pages, page_ids) -> torch.Tensor:
    """pages (L, P, page, KV, Dh); page_ids (n,) -> (L, n, page, KV, Dh)."""
    return pages[:, _idx(page_ids, pages.device)]


def page_scatter_ref(pages, staging, page_ids) -> torch.Tensor:
    """pages[:, page_ids[i]] = staging[:, i], in place; returns pages."""
    pages[:, _idx(page_ids, pages.device)] = staging
    return pages


def copy_pages_ref(pages, src_ids, dst_ids) -> torch.Tensor:
    """pages[:, dst_ids[i]] = pages[:, src_ids[i]] (COW split), in place."""
    pages[:, _idx(dst_ids, pages.device)] = \
        pages[:, _idx(src_ids, pages.device)]
    return pages


def append_tokens_ref(k_pages, v_pages, k_tok, v_tok, page_ids, offsets):
    """pages[:, page_ids[b], offsets[b]] = tok[:, b] for both pools, in
    place; k/v_tok (L, B, KV, Dh). Returns (k_pages, v_pages)."""
    ids = _idx(page_ids, k_pages.device)
    offs = _idx(offsets, k_pages.device)
    k_pages[:, ids, offs] = k_tok.to(k_pages.dtype)
    v_pages[:, ids, offs] = v_tok.to(v_pages.dtype)
    return k_pages, v_pages
