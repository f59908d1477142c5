"""Dense gated-linear-unit FFN (SwiGLU / GeGLU)."""
from __future__ import annotations

import torch

from repro_torch.dist.sharding import matmul
from repro_torch.models.common import ParamSpec, activation_fn


def mlp_specs(d_model: int, d_ff: int, dtype: str) -> dict[str, ParamSpec]:
    return {
        "w1": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "w3": ParamSpec((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "w2": ParamSpec((d_ff, d_model), ("mlp", "embed"), dtype=dtype),
    }


def mlp_apply(p: dict, x: torch.Tensor, activation: str,
              gated_act=None) -> torch.Tensor:
    """``act(x w1) * (x w3)`` times w2; ``gated_act(gate, up)``, when
    given, computes the gated product (the paged decode step's fused
    op)."""
    if gated_act is not None:
        return matmul(gated_act(matmul(x, p["w1"]), matmul(x, p["w3"])),
                      p["w2"])
    act = activation_fn(activation)
    return matmul(act(matmul(x, p["w1"])) * matmul(x, p["w3"]), p["w2"])
