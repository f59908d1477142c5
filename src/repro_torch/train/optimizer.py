"""AdamW + schedules in plain torch: the port of the JAX package's
``train/optimizer.py`` (no ``torch.optim``: its bias correction, decay
placement and clip differ from the reference's).

Params, grads and the moments are flat ``{dotted name: tensor}`` dicts
(the port's parameter trees). The state is ``{"m": dict, "v": dict,
"count": int32 scalar}``; the moments are kept in ``state_dtype``
(``cfg.opt_state_dtype``: bf16 for the 235B MoE config) and every update
is computed in fp32. ``apply_updates`` writes params and state in place.
On a mesh the params are DTensors: the moments take their placements,
and the global grad norm sums every shard's squares over the ranks (the
reference's jitted step reduces it over the whole array too).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.dist.sharding import full
from repro_torch.models.common import torch_dtype


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    schedule: str = "cosine"       # "cosine" | "constant" | "linear"
    state_dtype: str = "float32"


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), fp32: linear
    warmup, then constant, linear or cosine decay to 0 at
    ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((step - cfg.warmup_steps) /
                           max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
        # the cosine of the fp32 angle, rounded once from fp64: torch's
        # fp32 cos is off the correctly rounded value by an ulp on ~5% of
        # inputs, XLA's (the reference's) on ~1.4%
        decay = 1.0 - frac if cfg.schedule == "linear" else \
            0.5 * (1.0 + torch.cos((math.pi * frac).double()).float())
    return cfg.lr * warm * decay


def init_state(params: dict[str, torch.Tensor], cfg: AdamWConfig) -> dict:
    dt = torch_dtype(cfg.state_dtype)

    def zeros():            # a DTensor param: zeros on its placement
        return {k: torch.zeros_like(p, dtype=dt,
                                    memory_format=torch.contiguous_format)
                .detach() for k, p in params.items()}

    device = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [full(x.float().square().sum()) for x in tree.values()]).sum())


@torch.no_grad()
def apply_updates(params: dict[str, torch.Tensor],
                  grads: dict[str, torch.Tensor], state: dict,
                  cfg: AdamWConfig,
                  transform_grads: Callable | None = None):
    """One AdamW step, in place: params and the state's moments and count
    are overwritten. Returns (params, state, metrics) like the reference
    (the same dicts), metrics ``{"grad_norm", "lr"}`` as fp32 scalars."""
    state["count"] += 1
    c = state["count"].float()
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip > 0 else 1.0
    grads = {k: g.float() * scale for k, g in grads.items()}
    if transform_grads is not None:
        grads = transform_grads(grads)

    lr = schedule_lr(cfg, c)
    bc1 = 1.0 - torch.pow(cfg.b1, c)
    bc2 = 1.0 - torch.pow(cfg.b2, c)
    for k, p in params.items():
        g, m, v = grads.pop(k), state["m"][k], state["v"][k]
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v2 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        del g
        step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        m.copy_(m2)
        v.copy_(v2)
        del m2, v2
        if p.ndim >= 2:
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
