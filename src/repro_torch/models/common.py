"""Shared model building blocks: parameter specs, init, the numpy bridge,
norms, RoPE, activations.

Parameters are a flat ``dict[str, Tensor]`` whose dotted names follow the
JAX package's nested param tree (``"blocks.attn.wq"`` is
``params["blocks"]["attn"]["wq"]``), with the same layouts: ``wq (D, H,
Dh)``, ``wk``/``wv (D, KV, Dh)``, ``wo (H, Dh, D)``, ``embed (V, D)``,
``w1``/``w3 (D, F)``, ``w2 (F, D)``, and every ``blocks.*`` leaf stacked
with a leading layer dimension L. That is what lets one ``Model.init``
tree from the JAX package drive both implementations
(:func:`params_from_numpy`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise NotImplementedError(f"dtype {name!r} is not supported by the "
                                  f"port")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"                    # normal | zeros | embed
    dtype: str = "float32"


def init_param(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """Same distributions as the JAX package's ``init_param``: zeros,
    N(0, 1) for embeddings, N(0, 1/fan_in) otherwise, with fan_in the
    second-to-last dimension of the (stacked) shape."""
    dtype = torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = 1.0 if spec.init == "embed" else 1.0 / math.sqrt(fan_in)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def init_params(cfg, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """The port's own init: every parameter of ``cfg``'s model, in name
    order, drawn from one seeded generator on the generator's device, in
    the param dtype. (Different numbers from ``jax.random``; tests that
    compare the two implementations pass one tree through
    :func:`params_from_numpy` instead.)"""
    from repro_torch.models.transformer import model_specs
    specs = model_specs(cfg)
    return {name: init_param(specs[name], generator, generator.device)
            for name in sorted(specs)}


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dict -> {dotted name: leaf}."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, name + "."))
        else:
            out[name] = v
    return out


def params_from_numpy(tree) -> dict[str, torch.Tensor]:
    """The weight bridge: a JAX ``Model.init`` tree converted leaf by leaf
    to numpy (same keys, same layouts, stacked ``blocks`` with a leading
    L) -> the port's flat parameter dict of CPU tensors, dtypes kept.
    ``Model(cfg, params)`` casts and places them."""
    out = {}
    for name, leaf in flatten_tree(tree).items():
        arr = np.asarray(leaf)
        if arr.dtype.name == "bfloat16":        # ml_dtypes bf16 from JAX
            out[name] = torch.from_numpy(
                arr.astype(np.float32)).to(torch.bfloat16)
        else:
            out[name] = torch.from_numpy(np.array(arr))
    return out


def cast_params(params: dict[str, torch.Tensor],
                compute_dtype: str) -> dict[str, torch.Tensor]:
    """Cast every leaf to the compute dtype. Done once, when a model is
    built: the JAX package casts on every forward call inside ``jit``.
    (No dense-family leaf is ``keep_dtype``.)"""
    cd = torch_dtype(compute_dtype)
    return {k: v.to(cd) for k, v in params.items()}


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm in fp32 with a ``(1 + scale)`` gain, cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor, scale: torch.Tensor,
                 eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual add followed by RMS norm: returns ``(x + delta, norm)``.
    The residual stream is rounded to x's dtype, but the norm reads the
    fp32 sum before that rounding, which is what XLA's fusion of the JAX
    package computes; bf16 hidden states then match it bit for bit."""
    total = x.float() + delta.float()
    return total.to(x.dtype), rms_norm(total, scale, eps).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return torch.tanh(x / cap) * cap


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) spelled as ``jax.nn.silu`` lowers it,
    ``x * (1 / (1 + exp(-x)))`` with every op rounded to x's dtype, so bf16
    activations match the JAX package bit for bit."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return _silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(name)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------
def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                fraction: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables; positions (...,) -> (..., rot_dim/2), fp32."""
    rot_dim = int(head_dim * fraction) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=positions.device) / rot_dim
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, Dh); cos/sin: (B, S, rot/2) or (S, rot/2). Rotates the
    leading ``rot`` channels (partial rotary), in x's dtype."""
    rot = cos.shape[-1] * 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., :rot // 2], xr[..., rot // 2:]
    cos = cos[..., None, :].to(x.dtype)          # broadcast over heads
    sin = sin[..., None, :].to(x.dtype)
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.cat([out1, out2, xp], dim=-1)
