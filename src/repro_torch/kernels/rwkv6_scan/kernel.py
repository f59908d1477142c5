"""CUDA RWKV6 WKV scan: the checked launcher of ``csrc/rwkv6_scan.cu``, the
port of the Pallas ``rwkv6_scan_kernel`` (``src/repro/kernels/rwkv6_scan/
kernel.py``).

One thread block per (batch row, head) carries the head's (K, K) fp32
state in shared memory across the chunks; see the source for its bound
and design. The kernel consumes the log-decay (what the model computes)
rather than the decay itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_LIB = "rwkv6_scan"
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
MAX_DIM = 64      # largest head size K and chunk L the kernel takes


def rwkv6_scan_kernel(r, k, v, logw, u, init_state=None, *,
                      chunk: int = 64):
    """r/k/v/logw (B, T, H, K) float32 on one GPU, T a multiple of
    ``L = min(chunk, T)``; u (H, K); init_state (B, H, K, K) or None.
    Returns (o (B, T, H, K), final_state (B, H, K, K)), both float32.
    Launches on the current stream and does not synchronize."""
    tensors = [r, k, v, logw, u] + ([] if init_state is None
                                    else [init_state])
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError("rwkv6_scan_kernel: every tensor must be on the "
                         "same CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("rwkv6_scan_kernel takes float32 tensors, got "
                        f"{[t.dtype for t in tensors]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"r/k/v/logw must share a (B, T, H, K) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, T, H, K = r.shape
    L = min(chunk, T)
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u {tuple(u.shape)} != {(H, K)}")
    if init_state is not None and tuple(init_state.shape) != (B, H, K, K):
        raise ValueError(f"init_state {tuple(init_state.shape)} != "
                         f"{(B, H, K, K)}")
    if not 1 <= K <= MAX_DIM or (T and not 1 <= L <= MAX_DIM) \
            or (T and T % L):
        raise ValueError(f"head size {K} and chunk {L} must lie in [1, "
                         f"{MAX_DIM}] with T={T} a multiple of the chunk")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rwkv6_scan_kernel takes contiguous tensors")
    if B > 65535 or H > 2 ** 31 - 1:
        raise ValueError(f"grid limits: batch {B}, heads {H}")
    o = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    fn = _build.function(_LIB, "rwkv6_scan_launch", _ARGTYPES)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(),
                 None if init_state is None else init_state.data_ptr(),
                 o.data_ptr(), state.data_ptr(), B, T, H, K, max(L, 1),
                 stream)
    _build.check(_LIB, err, "rwkv6_scan_kernel")
    rwkv6_scan_kernel.launches += 1
    return o, state


rwkv6_scan_kernel.launches = 0
