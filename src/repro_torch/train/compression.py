"""Gradient compression with error feedback: the port of the JAX package's
``train/compression.py``.

Gradients are quantized to int8 with one symmetric scale per block of
``block`` values and dequantized again; the quantization residual is
carried in an error-feedback buffer, so the compression is unbiased over
steps (1-bit-Adam / EF-SGD lineage). The numerics are what an int8 wire
format across a data-parallel reduction would produce. ``torch.round``
rounds half to even like ``jnp.round``, so the result equals the
reference's bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    block: int = 256
    enabled: bool = True


def init_error_state(grads: dict[str, torch.Tensor]) -> dict:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def _quantize_dequantize(x: torch.Tensor, block: int):
    """Per-block int8 symmetric quantization; returns (dq, residual)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    fp = F.pad(flat, (0, -n % block)).reshape(-1, block)
    scale = fp.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
    dq = (q.float() * scale).reshape(-1)[:n].reshape(x.shape)
    return dq, x - dq


@torch.no_grad()
def compress_grads(grads: dict[str, torch.Tensor], error_state: dict,
                   cfg: CompressionConfig = CompressionConfig()):
    """grads + carried error -> (compressed grads in each grad's dtype, new
    error state). Apply before the optimizer (``apply_updates``'
    ``transform_grads``)."""
    if not cfg.enabled:
        return grads, error_state
    new_g, new_e = {}, {}
    for k, g in grads.items():
        dq, new_e[k] = _quantize_dequantize(g.float() + error_state[k],
                                            cfg.block)
        new_g[k] = dq.to(g.dtype)
    return new_g, new_e
