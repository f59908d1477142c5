"""RWKV6 WKV, dispatched by device: a CUDA tensor launches the hand-written
kernel (:mod:`.kernel`), a CPU tensor takes the plain chunked version
(:mod:`.ref`), and so does a ``meta`` tensor (shapes only: the step
counter counts the plain arithmetic)."""
from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_kernel
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_chunked_ref


def wkv_chunked(r, k, v, logw, u, init_state=None, *, chunk: int = 64):
    """r/k/v/logw (B, T, H, K) fp32 with logw <= 0 the log decay, T a
    multiple of ``min(chunk, T)``; u (H, K); init_state (B, H, K, K) or
    None -> (o (B, T, H, K), final_state (B, H, K, K) fp32)."""
    if r.device.type == "cuda":
        return rwkv6_scan_kernel(r, k, v, logw, u, init_state, chunk=chunk)
    if r.device.type in ("cpu", "meta"):
        return rwkv6_chunked_ref(r, k, v, logw, u, init_state, chunk=chunk)
    raise ValueError(f"wkv_chunked: unsupported device {r.device}")


def rwkv6_scan(r, k, v, w, u, init_state=None, *, chunk: int = 64):
    """The JAX package's signature: w (B, T, H, K) the decay in (0, 1)."""
    logw = torch.log(w.float().clamp_min(1e-38))
    return wkv_chunked(r, k, v, logw, u, init_state, chunk=chunk)
