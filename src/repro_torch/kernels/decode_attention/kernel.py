"""CUDA paged decode attention: the checked launcher of
``csrc/decode_attention.cu``, the port of the Pallas
``paged_decode_attention_kernel`` (``src/repro/kernels/decode_attention/
kernel.py``).

The kernel runs one thread block per (sequence, KV head) over the
sequence's live pages only, ~64 tokens per step; see the source for its
bound and design.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_LIB = "decode_attention"
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block may use
_TILE_TOKENS = 64             # kTileTokens in the source: tokens per step


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def paged_decode_attention_kernel(q, k_pages, v_pages, block_tables,
                                  seq_lens, *, layer: int = 0,
                                  scale: float | None = None,
                                  return_residuals: bool = False):
    """q (B, H, D) on the GPU; k/v_pages (P, page, KV, D) or layer-stacked
    (L, P, page, KV, D) in q's dtype (float32 or bfloat16); block_tables
    (B, n_tab) and seq_lens (B,) int32 on the same GPU.

    Returns the normalized output (B, H, D) in q's dtype, or with
    ``return_residuals=True`` the unnormalized fp32 ``(acc (B, KV, G, D),
    m (B, KV, G), l (B, KV, G))``. Live table slots (``ip * page <
    seq_lens[b]``) must hold valid page ids; dead slots are never read.
    Launches on the current stream and does not synchronize."""
    if k_pages.dim() == 4:
        k_pages, v_pages = k_pages[None], v_pages[None]
    if not (q.is_cuda and k_pages.device == q.device
            and v_pages.device == q.device
            and block_tables.device == q.device
            and seq_lens.device == q.device):
        raise ValueError("paged_decode_attention_kernel: every tensor must "
                         "be on the same CUDA device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q and the pools must share float32 or bfloat16, "
                        f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    if k_pages.dim() != 5 or k_pages.shape != v_pages.shape or q.dim() != 3:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    L, P, page, KV, D = k_pages.shape
    B, H, Dq = q.shape
    if Dq != D or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)}")
    G = H // KV
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.shape[1] < 1 or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"seq_lens {tuple(seq_lens.shape)} for batch {B}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    vec = 16 // q.element_size()
    if D % vec:
        raise ValueError(f"head_dim {D} must be a multiple of {vec}")
    for t in (q, k_pages, v_pages, block_tables, seq_lens):
        if not t.is_contiguous():
            raise ValueError("paged_decode_attention_kernel takes "
                             "contiguous tensors")
    if q.data_ptr() % 16 or k_pages.data_ptr() % 16 \
            or v_pages.data_ptr() % 16:
        raise ValueError("q and the pools must be 16-byte aligned")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's y limit")
    tile = (1 if page >= _TILE_TOKENS else _TILE_TOKENS // page) * page
    smem = 4 * (2 * G * D + 2 * tile * (D + 1) + G * tile + 3 * G)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"page {page} x head_dim {D} needs {smem} bytes "
                         f"of shared memory")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    if return_residuals:
        acc = torch.empty((B, KV, G, D), dtype=torch.float32, device=q.device)
        m = torch.empty((B, KV, G), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        out = None
    else:
        acc = m = l = None
        out = torch.empty_like(q)
    fn = _build.function(_LIB, "paged_decode_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(block_tables),
                 _ptr(seq_lens), _ptr(acc), _ptr(out), _ptr(m), _ptr(l),
                 B, KV, G, D, P, page, block_tables.shape[1], int(layer),
                 float(scale), _DTYPES[q.dtype], stream)
    _build.check(_LIB, err, "paged_decode_attention_kernel")
    paged_decode_attention_kernel.launches += 1
    if return_residuals:
        return acc, m, l
    return out


paged_decode_attention_kernel.launches = 0
