"""CUDA flash attention: the checked launcher of
``csrc/flash_attention.cu``, the port of the Pallas
``flash_attention_kernel`` (``src/repro/kernels/flash_attention/
kernel.py``).

One thread block per (64-row query tile, head, batch row) walks the live
key tiles of its KV group with an fp32 online softmax; see the source for
its bound and design. The tensors are read and written through their
strides (unit stride along D only), so a caller holding (B, S, H, D)
activations passes ``x.transpose(1, 2)`` views and no copy is made.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_LIB = "flash_attention"
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_int, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def flash_attention_kernel(q, k, v, *, scale: float | None = None,
                           causal: bool = True, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """q (B, H, S, D); k/v (B, KV, S, D) on one GPU, float32 or bfloat16,
    any strides with a unit stride along D. Returns (B, H, S, D) in q's
    dtype, laid out like q (``torch.empty_like``). Launches on the current
    stream and does not synchronize."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_kernel: q, k and v must be on the "
                         "same CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}"
                         f", v {tuple(v.shape)}")
    B, H, S, D = q.shape
    KV = k.shape[1]
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} outside [1, {MAX_HEAD_DIM}]")
    out = torch.empty_like(q)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", out)):
        if t.stride(3) != 1 and D > 1:
            raise ValueError(f"flash_attention_kernel: {name} needs unit "
                             f"stride along D, got strides {t.stride()}")
    if H > 65535 or B > 65535:
        raise ValueError(f"grid limits: heads {H}, batch {B}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    fn = _build.function(_LIB, "flash_attention_launch", _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), B, H, KV, S, D, float(scale),
                 int(bool(causal)), int(window), float(softcap),
                 _DTYPES[q.dtype], stream)
    _build.check(_LIB, err, "flash_attention_kernel")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
