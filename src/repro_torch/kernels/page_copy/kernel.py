"""CUDA page gather / scatter / token append: the checked launchers of
``csrc/page_copy.cu``, the port of the Pallas ``page_gather_kernel``,
``page_scatter_kernel`` and ``token_append_kernel``
(``src/repro/kernels/page_copy/kernel.py``).

Index arguments arrive as host arrays (:func:`repro_torch.kernels.
host_index`): they are range- and distinctness-checked here, on the host,
before any pointer reaches a kernel, then uploaded without waiting for the
stream. Scatter and append update the pool tensors in place (the JAX
kernels alias them with ``input_output_aliases`` and return new arrays).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build, to_device

_LIB = "page_copy"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_COPY_ARGS = [_P, _P, _P, _I, _I, _I, _L, _P]
_APPEND_ARGS = [_P] * 6 + [_I] * 4 + [_L, _P]


def _check_pool(pages: torch.Tensor, what: str) -> None:
    if not pages.is_cuda:
        raise ValueError(f"{what}: the pool must be a CUDA tensor")
    if pages.dim() != 5 or not pages.is_contiguous():
        raise ValueError(f"{what}: the pool must be a contiguous "
                         f"(L, P, page, KV, Dh) tensor, got "
                         f"{tuple(pages.shape)}")


def _check_ids(ids: np.ndarray, P: int, what: str,
               distinct: bool = False) -> None:
    if ids.size and (ids.min() < 0 or ids.max() >= P):
        raise ValueError(f"{what}: page ids outside [0, {P})")
    if distinct and np.unique(ids).size != ids.size:
        raise ValueError(f"{what}: page ids must be pairwise distinct")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def page_gather_kernel(pages: torch.Tensor,
                       page_ids: np.ndarray) -> torch.Tensor:
    """pages (L, P, page, KV, Dh) on the GPU; page_ids (n,) host ints ->
    staging (L, n, page, KV, Dh) with staging[:, i] = pages[:, ids[i]]."""
    _check_pool(pages, "page_gather_kernel")
    L, P = pages.shape[:2]
    _check_ids(page_ids, P, "page_gather_kernel")
    n = int(page_ids.size)
    staging = torch.empty((L, n) + tuple(pages.shape[2:]), dtype=pages.dtype,
                          device=pages.device)
    if n == 0 or L == 0:
        return staging
    ids = to_device(page_ids, pages.device)
    fn = _build.function(_LIB, "page_gather_launch", _COPY_ARGS)
    with torch.cuda.device(pages.device):
        err = fn(pages.data_ptr(), ids.data_ptr(), staging.data_ptr(), n, L,
                 P, pages[0, 0].numel() * pages.element_size(),
                 _stream(pages))
    _build.check(_LIB, err, "page_gather_kernel")
    page_gather_kernel.launches += 1
    return staging


def page_scatter_kernel(pages: torch.Tensor, staging: torch.Tensor,
                        page_ids: np.ndarray) -> torch.Tensor:
    """pages[:, ids[i]] = staging[:, i] in place (other pages untouched);
    staging (L, n, page, KV, Dh) on the pool's GPU; ids pairwise distinct.
    Returns ``pages``."""
    _check_pool(pages, "page_scatter_kernel")
    L, P = pages.shape[:2]
    _check_ids(page_ids, P, "page_scatter_kernel", distinct=True)
    n = int(page_ids.size)
    if staging.device != pages.device or staging.dtype != pages.dtype \
            or tuple(staging.shape) != (L, n) + tuple(pages.shape[2:]) \
            or not staging.is_contiguous():
        raise ValueError(f"page_scatter_kernel: staging "
                         f"{tuple(staging.shape)} {staging.dtype} "
                         f"{staging.device} does not fit pool "
                         f"{tuple(pages.shape)} {pages.dtype}")
    if n == 0 or L == 0:
        return pages
    ids = to_device(page_ids, pages.device)
    fn = _build.function(_LIB, "page_scatter_launch", _COPY_ARGS)
    with torch.cuda.device(pages.device):
        err = fn(pages.data_ptr(), ids.data_ptr(), staging.data_ptr(), n, L,
                 P, pages[0, 0].numel() * pages.element_size(),
                 _stream(pages))
    _build.check(_LIB, err, "page_scatter_kernel")
    page_scatter_kernel.launches += 1
    return pages


def token_append_kernel(k_pages: torch.Tensor, v_pages: torch.Tensor,
                        k_tok: torch.Tensor, v_tok: torch.Tensor,
                        page_ids: np.ndarray, offsets: np.ndarray):
    """Write each of B new tokens' K/V rows for all L layers into slot
    ``offsets[b]`` of page ``page_ids[b]``, in place, in one launch:
    k/v_pages (L, P, page, KV, Dh); k/v_tok (L, B, KV, Dh) in the pools'
    dtype; page_ids pairwise distinct. Returns ``(k_pages, v_pages)``."""
    _check_pool(k_pages, "token_append_kernel")
    _check_pool(v_pages, "token_append_kernel")
    L, P, page, KV, Dh = k_pages.shape
    B = int(page_ids.size)
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype \
            or v_pages.device != k_pages.device:
        raise ValueError("token_append_kernel: k and v pools differ")
    for tok in (k_tok, v_tok):
        if tuple(tok.shape) != (L, B, KV, Dh) or tok.dtype != k_pages.dtype \
                or tok.device != k_pages.device or not tok.is_contiguous():
            raise ValueError(f"token_append_kernel: token rows "
                             f"{tuple(tok.shape)} {tok.dtype} do not fit "
                             f"pools {tuple(k_pages.shape)} {k_pages.dtype}")
    _check_ids(page_ids, P, "token_append_kernel", distinct=True)
    if offsets.shape != (B,) or (B and (offsets.min() < 0
                                        or offsets.max() >= page)):
        raise ValueError(f"token_append_kernel: offsets outside [0, {page})")
    if B == 0 or L == 0:
        return k_pages, v_pages
    ids = to_device(page_ids, k_pages.device)
    offs = to_device(offsets, k_pages.device)
    fn = _build.function(_LIB, "token_append_launch", _APPEND_ARGS)
    with torch.cuda.device(k_pages.device):
        err = fn(k_pages.data_ptr(), v_pages.data_ptr(), k_tok.data_ptr(),
                 v_tok.data_ptr(), ids.data_ptr(), offs.data_ptr(), B, L, P,
                 page, KV * Dh * k_pages.element_size(), _stream(k_pages))
    _build.check(_LIB, err, "token_append_kernel")
    token_append_kernel.launches += 1
    return k_pages, v_pages


page_gather_kernel.launches = 0
page_scatter_kernel.launches = 0
token_append_kernel.launches = 0
