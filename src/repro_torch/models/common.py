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
import functools
import math
from typing import Callable

import numpy as np
import torch

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
    init: str = "normal"            # normal | zeros | ones | embed | small
    scale: float = 1.0
    dtype: str = "float32"
    keep_dtype: bool = False                # never cast to the compute dtype


def init_param(spec: ParamSpec, generator: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """Same distributions as the JAX package's ``init_param``: zeros, ones,
    N(0, 1) for embeddings, N(0, 1/fan_in) otherwise (``small`` too), with
    fan_in the second-to-last dimension of the (stacked) shape, times the
    spec's ``scale``."""
    dtype = torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = 1.0 if spec.init == "embed" else 1.0 / math.sqrt(fan_in)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    # in place, in the order of ``x * std * scale``: the same roundings
    # without two more fp32 temporaries of the leaf's size
    return x.mul_(std).mul_(spec.scale).to(dtype)


def init_params(cfg, generator: torch.Generator,
                compute_dtype: str | None = None) -> dict[str, torch.Tensor]:
    """The port's own init: every parameter of ``cfg``'s model, in name
    order, drawn from one seeded generator on the generator's device, in
    the param dtype. (Different numbers from ``jax.random``; tests that
    compare the two implementations pass one tree through
    :func:`params_from_numpy` instead.)

    With ``compute_dtype`` each leaf is cast as soon as it is drawn
    (``keep_dtype`` leaves stay as they are): the same values as
    :func:`cast_params` of the whole tree, with one fp32 leaf alive at a
    time instead of the fp32 tree (~64 GB for six qwen3-moe layers)."""
    from repro_torch.models.transformer import model_specs
    specs = model_specs(cfg)
    out = {}
    for name in sorted(specs):
        leaf = init_param(specs[name], generator, generator.device)
        if compute_dtype is not None and not specs[name].keep_dtype:
            leaf = leaf.to(torch_dtype(compute_dtype))
        out[name] = leaf
    return out


def meta_params(cfg, compute_dtype: str | None = None
                ) -> dict[str, torch.Tensor]:
    """Every parameter of ``cfg``'s model as a tensor on the ``meta``
    device: the shapes and dtypes :func:`init_params` gives, with no
    storage and nothing drawn (what the step counter runs on)."""
    from repro_torch.models.transformer import model_specs
    out = {}
    for name, spec in sorted(model_specs(cfg).items()):
        dt = spec.dtype if compute_dtype is None or spec.keep_dtype \
            else compute_dtype
        out[name] = torch.empty(spec.shape, dtype=torch_dtype(dt),
                                device="meta")
    return out


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


def cast_params(params: dict[str, torch.Tensor], specs: dict[str, ParamSpec],
                compute_dtype: str) -> dict[str, torch.Tensor]:
    """Cast every leaf to the compute dtype except the ``keep_dtype`` ones
    (RWKV6's decay base ``w0`` and bonus ``u`` stay fp32). Done once, when
    a serving model is built, and in every forward of a trainable one (the
    JAX package casts on every forward call inside ``jit``)."""
    cd = torch_dtype(compute_dtype)
    return {k: v if specs[k].keep_dtype else v.to(cd)
            for k, v in params.items()}


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


@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype: torch.dtype) -> tuple[float, float]:
    """GELU's two constants rounded to ``dtype``, as Python floats: a CUDA
    op reads them as scalars, and a product with a value the dtype holds
    exactly rounds as the product of two tensors of that dtype."""
    return tuple(torch.tensor(c, dtype=dtype).item()
                 for c in (0.044715, math.sqrt(2.0 / math.pi)))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU spelled as ``jax.nn.gelu(approximate=True)``
    computes it: ``x * 0.5 * (1 + tanh(c * (x + 0.044715 * x^3)))`` with
    the constants in x's dtype and every op rounded to it, so bf16
    activations match the JAX package bit for bit. ``F.gelu``'s one fused
    op rounds once: gemma2's bf16 logits then part from the reference's by
    up to 0.42 at smoke size (0.15 with this spelling), past the 0.25 its
    tests hold. Both spellings are timed on the card by
    ``launch/gelu_spellings.py``."""
    k, c = _gelu_constants(x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return _silu
    if name == "gelu":
        return _gelu_tanh
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


def sinusoidal_emb(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(...,) int positions -> (..., dim) fp32 sinusoidal embedding, sin
    then cos (musicgen)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    angles = positions[..., None].float() * freqs
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


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
