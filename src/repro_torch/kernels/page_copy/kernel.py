"""CUDA page gather / scatter / token append: the checked launchers of
``csrc/page_copy.cu``, the port of the Pallas ``page_gather_kernel``,
``page_scatter_kernel`` and ``token_append_kernel``
(``src/repro/kernels/page_copy/kernel.py``).

Index arguments arrive as host arrays (:func:`repro_torch.kernels.
host_index`): they are range-checked here, on the host, before any pointer
reaches a kernel, and for scatter and token append, whose writes would
race, checked pairwise distinct (a gather may read a page twice). All
three pass their ids (and append's offsets) by value in the launch, cut
into slices of the parameter struct's capacity (:func:`pack_ids`): no
index tensor, no host-to-device copy. Scatter and append update the pool
tensors in place (the JAX kernels alias them with
``input_output_aliases`` and return new arrays).

:func:`token_append_indexed_kernel` is the one exception: its slots are
int32 tensors on the device that the kernel reads, as the Pallas kernel
takes them through scalar prefetch, so a captured CUDA graph replays it
with each step's slots. Their values are the caller's to check.
"""
from __future__ import annotations

import array
import ctypes
import dataclasses
import math

import torch

from repro_torch.kernels import _build, device_guard, stream_handle

_LIB = "page_copy"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_MOVE_ARGS = [_P] * 3 + [_I] * 5 + [_L, _P]   # gather and scatter
_APPEND_ARGS = [_P] * 6 + [_I] * 6 + [_L, _P]
K_MAX_APPEND = 256    # kMaxAppend in csrc/page_copy.cu
K_MAX_SCATTER = 512   # kMaxScatter in csrc/page_copy.cu
K_MAX_GATHER = 512    # kMaxGather in csrc/page_copy.cu


def _check_pool(pages: torch.Tensor, what: str) -> None:
    if not pages.is_cuda:
        raise ValueError(f"{what}: the pool must be a CUDA tensor")
    if pages.dim() != 5 or not pages.is_contiguous():
        raise ValueError(f"{what}: the pool must be a contiguous "
                         f"(L, P, page, KV, Dh) tensor, got "
                         f"{tuple(pages.shape)}")


def _row_bytes(pages: torch.Tensor) -> int:
    return math.prod(pages.shape[2:]) * pages.element_size()


def page_gather_kernel(pages: torch.Tensor, page_ids) -> torch.Tensor:
    """pages (L, P, page, KV, Dh) on the GPU; page_ids (n,) host ints in
    [0, P), repeats allowed -> staging (L, n, page, KV, Dh) with
    staging[:, i] = pages[:, ids[i]]; the ids passed by value, one launch
    per ``K_MAX_GATHER`` pages."""
    _check_pool(pages, "page_gather_kernel")
    L, P = pages.shape[:2]
    slices = pack_ids(page_ids, P, what="page_gather_kernel",
                      capacity=K_MAX_GATHER, distinct=False)
    n = sum(len(sl.page_ids) for sl in slices)
    staging = torch.empty((L, n) + tuple(pages.shape[2:]), dtype=pages.dtype,
                          device=pages.device)
    if n == 0 or L == 0:
        return staging
    launch = _build.function(_LIB, "page_gather_launch", _MOVE_ARGS)
    row_bytes = _row_bytes(pages)
    with device_guard(pages.device):
        stream = stream_handle(pages.device)
        for sl in slices:
            err = launch(pages.data_ptr(), staging.data_ptr(),
                         sl.page_ids.buffer_info()[0], sl.start,
                         len(sl.page_ids), n, L, P, row_bytes, stream)
            _build.check(_LIB, err, "page_gather_kernel")
            page_gather_kernel.launches += 1
    return staging


def page_scatter_kernel(pages: torch.Tensor, staging: torch.Tensor,
                        page_ids) -> torch.Tensor:
    """pages[:, ids[i]] = staging[:, i] in place (other pages untouched);
    staging (L, n, page, KV, Dh) on the pool's GPU; ids pairwise distinct,
    passed by value, one launch per ``K_MAX_SCATTER`` pages. Returns
    ``pages``."""
    _check_pool(pages, "page_scatter_kernel")
    L, P = pages.shape[:2]
    slices = pack_ids(page_ids, P, what="page_scatter_kernel",
                      capacity=K_MAX_SCATTER)
    n = sum(len(sl.page_ids) for sl in slices)
    if staging.device != pages.device or staging.dtype != pages.dtype \
            or tuple(staging.shape) != (L, n) + tuple(pages.shape[2:]) \
            or not staging.is_contiguous():
        raise ValueError(f"page_scatter_kernel: staging "
                         f"{tuple(staging.shape)} {staging.dtype} "
                         f"{staging.device} does not fit pool "
                         f"{tuple(pages.shape)} {pages.dtype}")
    if n == 0 or L == 0:
        return pages
    launch = _build.function(_LIB, "page_scatter_launch", _MOVE_ARGS)
    row_bytes = _row_bytes(pages)
    with device_guard(pages.device):
        stream = stream_handle(pages.device)
        for sl in slices:
            err = launch(pages.data_ptr(), staging.data_ptr(),
                         sl.page_ids.buffer_info()[0], sl.start,
                         len(sl.page_ids), n, L, P, row_bytes, stream)
            _build.check(_LIB, err, "page_scatter_kernel")
            page_scatter_kernel.launches += 1
    return pages


@dataclasses.dataclass(frozen=True)
class IdSlice:
    """Entries ``start .. start + len(page_ids)`` of a by-value launch,
    with their page ids (and, for token append, slot offsets) as the int32
    host arrays one launch copies into its parameters."""
    start: int
    page_ids: array.array
    offsets: array.array | None = None


def _ints(x) -> list[int]:
    return x.tolist() if hasattr(x, "tolist") else [int(i) for i in x]


def pack_ids(page_ids, P: int, *, what: str, capacity: int, offsets=None,
             page: int = 0, distinct: bool = True) -> list[IdSlice]:
    """Validate the page ids of a by-value launch on the host (in [0, P);
    pairwise distinct unless ``distinct`` is False, as for a gather, whose
    reads of a page do not race; with ``offsets``, one offset in [0, page)
    an id) and cut them into launches of at most ``capacity`` entries."""
    ids = _ints(page_ids)
    offs = None if offsets is None else _ints(offsets)
    if offs is not None and len(offs) != len(ids):
        raise ValueError(f"{what}: {len(ids)} page ids but {len(offs)} "
                         f"offsets")
    if ids and (min(ids) < 0 or max(ids) >= P):
        raise ValueError(f"{what}: page ids outside [0, {P})")
    if offs and (min(offs) < 0 or max(offs) >= page):
        raise ValueError(f"{what}: offsets outside [0, {page})")
    if distinct and len(set(ids)) != len(ids):
        raise ValueError(f"{what}: page ids must be pairwise distinct")
    return [IdSlice(start, array.array("i", ids[start:start + capacity]),
                    None if offs is None else
                    array.array("i", offs[start:start + capacity]))
            for start in range(0, len(ids), capacity)]


def pack_append_args(page_ids, offsets, P: int, page: int) -> list[IdSlice]:
    """The ids and offsets of a token append, validated and cut into
    launches of at most ``K_MAX_APPEND`` rows (:func:`pack_ids`)."""
    return pack_ids(page_ids, P, what="token_append_kernel",
                    capacity=K_MAX_APPEND, offsets=offsets, page=page)


def token_append_kernel(k_pages: torch.Tensor, v_pages: torch.Tensor,
                        k_tok: torch.Tensor, v_tok: torch.Tensor,
                        page_ids, offsets):
    """Write each of B new tokens' K/V rows for all L layers into slot
    ``offsets[b]`` of page ``page_ids[b]``, in place, one launch per
    ``K_MAX_APPEND`` rows: k/v_pages (L, P, page, KV, Dh); k/v_tok (L, B,
    KV, Dh) in the pools' dtype; page_ids pairwise distinct. Returns
    ``(k_pages, v_pages)``."""
    _check_pool(k_pages, "token_append_kernel")
    _check_pool(v_pages, "token_append_kernel")
    L, P, page, KV, Dh = k_pages.shape
    B = len(page_ids)
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype \
            or v_pages.device != k_pages.device:
        raise ValueError("token_append_kernel: k and v pools differ")
    _check_tokens(k_pages, k_tok, v_tok, B, "token_append_kernel")
    slices = pack_append_args(page_ids, offsets, P, page)
    if B == 0 or L == 0:
        return k_pages, v_pages
    launch = _build.function(_LIB, "token_append_launch", _APPEND_ARGS)
    args = (k_pages.data_ptr(), v_pages.data_ptr(), k_tok.data_ptr(),
            v_tok.data_ptr())
    tok_bytes = KV * Dh * k_pages.element_size()
    with device_guard(k_pages.device):
        stream = stream_handle(k_pages.device)
        for sl in slices:
            err = launch(*args, sl.page_ids.buffer_info()[0],
                         sl.offsets.buffer_info()[0], sl.start,
                         len(sl.page_ids), B, L, P, page, tok_bytes, stream)
            _build.check(_LIB, err, "token_append_kernel")
            token_append_kernel.launches += 1
    return k_pages, v_pages


def _check_tokens(k_pages, k_tok, v_tok, B: int, what: str) -> None:
    L, _, _, KV, Dh = k_pages.shape
    for tok in (k_tok, v_tok):
        if tuple(tok.shape) != (L, B, KV, Dh) or tok.dtype != k_pages.dtype \
                or tok.device != k_pages.device or not tok.is_contiguous():
            raise ValueError(f"{what}: token rows {tuple(tok.shape)} "
                             f"{tok.dtype} do not fit pools "
                             f"{tuple(k_pages.shape)} {k_pages.dtype}")


def token_append_indexed_kernel(k_pages: torch.Tensor, v_pages: torch.Tensor,
                                k_tok: torch.Tensor, v_tok: torch.Tensor,
                                page_ids: torch.Tensor,
                                offsets: torch.Tensor):
    """:func:`token_append_kernel` with its slots on the device: one
    launch of grid (B, L) whose blocks read ``page_ids[b]`` and
    ``offsets[b]``, (B,) contiguous int32 tensors on the pools' GPU. The
    ids are not read on the host (that would sync, and a captured graph
    would keep the first step's): the caller checks them before the
    upload, and a slot out of range copies nothing. Returns ``(k_pages,
    v_pages)``."""
    what = "token_append_indexed_kernel"
    for name, t in (("page_ids", page_ids), ("offsets", offsets)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.int32 \
                or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous 1-D "
                             f"int32 tensor")
    B = page_ids.shape[0]
    if offsets.shape[0] != B:
        raise ValueError(f"{what}: {B} page ids but {offsets.shape[0]} "
                         f"offsets")
    if k_pages.dim() != 5:
        raise ValueError(f"{what}: the pool must be a (L, P, page, KV, Dh) "
                         f"tensor, got {tuple(k_pages.shape)}")
    if v_pages.shape != k_pages.shape or v_pages.dtype != k_pages.dtype \
            or v_pages.device != k_pages.device:
        raise ValueError(f"{what}: k and v pools differ")
    _check_tokens(k_pages, k_tok, v_tok, B, what)
    _check_pool(k_pages, what)
    _check_pool(v_pages, what)
    if page_ids.device != k_pages.device or offsets.device != k_pages.device:
        raise ValueError(f"{what}: page_ids and offsets must be on the "
                         f"pools' device")
    L, P, page = k_pages.shape[:3]
    if B == 0 or L == 0:
        return k_pages, v_pages
    launch = _build.function(_LIB, "token_append_indexed_launch",
                             [_P] * 6 + [_I] * 4 + [_L, _P])
    with device_guard(k_pages.device):
        err = launch(k_pages.data_ptr(), v_pages.data_ptr(), k_tok.data_ptr(),
                     v_tok.data_ptr(), page_ids.data_ptr(),
                     offsets.data_ptr(), B, L, P, page,
                     math.prod(k_pages.shape[3:]) * k_pages.element_size(),
                     stream_handle(k_pages.device))
    _build.check(_LIB, err, what)
    token_append_indexed_kernel.launches += 1
    return k_pages, v_pages


page_gather_kernel.launches = 0
page_scatter_kernel.launches = 0
token_append_kernel.launches = 0
token_append_indexed_kernel.launches = 0
