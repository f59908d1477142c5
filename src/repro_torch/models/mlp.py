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
              gate_up=None) -> torch.Tensor:
    """``act(x w1) * (x w3)`` times w2; ``gate_up(x, w1, w3)``, when
    given, computes the gated product (the fused op,
    ``fusions.gate_up_act``)."""
    if gate_up is not None:
        return matmul(gate_up(x, p["w1"], p["w3"]), p["w2"])
    act = activation_fn(activation)
    return matmul(act(matmul(x, p["w1"])) * matmul(x, p["w3"]), p["w2"])
