"""Page gather / scatter / copy / append, dispatched by the pool's device:
a CUDA pool launches the hand-written kernels (:mod:`.kernel`), a CPU pool
takes the plain versions (:mod:`.ref`). Page ids and offsets are host
integer sequences (lists, arrays or CPU tensors). Scatter, copy and append
update the pools in place, where the JAX package rebinds new arrays."""
from __future__ import annotations

import torch

from repro_torch.kernels import host_index
from repro_torch.kernels.page_copy.kernel import (page_gather_kernel,
                                                  page_scatter_kernel,
                                                  token_append_kernel)
from repro_torch.kernels.page_copy.ref import (append_tokens_ref,
                                               page_gather_ref,
                                               page_scatter_ref)


def _on_cuda(pages: torch.Tensor, what: str) -> bool:
    if pages.device.type in ("cuda", "cpu"):
        return pages.is_cuda
    raise ValueError(f"{what}: unsupported device {pages.device}")


def gather_pages(pages, page_ids) -> torch.Tensor:
    """Batch-gather scattered physical pages into one contiguous staging
    buffer (the D2H tier-move unit): (L, n, page, KV, Dh)."""
    ids = host_index(page_ids)
    if _on_cuda(pages, "gather_pages"):
        return page_gather_kernel(pages, ids)
    return page_gather_ref(pages, ids)


def scatter_pages(pages, staging, page_ids) -> torch.Tensor:
    """Scatter a contiguous staging buffer back into physical pages (the
    H2D reload unit), in place; returns ``pages``."""
    ids = host_index(page_ids)
    if _on_cuda(pages, "scatter_pages"):
        return page_scatter_kernel(pages, staging, ids)
    return page_scatter_ref(pages, staging, ids)


def copy_pages(pages, src_ids, dst_ids) -> torch.Tensor:
    """Copy pages src_ids -> dst_ids inside one pool (the COW-split
    primitive): gather the shared pages, scatter them into the fresh ones,
    in place; returns ``pages``."""
    staging = gather_pages(pages, src_ids)
    return scatter_pages(pages, staging, dst_ids)


def append_tokens(k_pages, v_pages, k_tok, v_tok, page_ids, offsets):
    """Append one new token's K/V per sequence into its (exclusively owned,
    pairwise-distinct) append page, all B sequences and all L layers in one
    call, in place: k/v_tok (L, B, KV, Dh); page_ids, offsets (B,).
    Returns ``(k_pages, v_pages)``."""
    ids, offs = host_index(page_ids), host_index(offsets)
    if _on_cuda(k_pages, "append_tokens"):
        return token_append_kernel(
            k_pages, v_pages, k_tok.to(k_pages.dtype).contiguous(),
            v_tok.to(v_pages.dtype).contiguous(), ids, offs)
    return append_tokens_ref(k_pages, v_pages, k_tok, v_tok, ids, offs)
