"""Config-driven decoder LM: the dense family of the JAX package's
``Model``, as an ``nn.Module``.

Parameters mirror ``Model.specs()`` of the JAX package (same dotted keys,
same layouts, ``blocks.*`` stacked over a leading L) and are cast to the
compute dtype once, when the model is built. The layer stack is a Python
loop over L. Modes: "prefill" (fresh causal attention, optional cache
write), "extend" (a chunk against an existing cache) and "decode".

Only the dense family is ported; the others raise and name the ROADMAP
item that ports them.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamSpec, add_rms_norm, cast_params,
                                       init_params, rms_norm, softcap,
                                       torch_dtype)
from repro_torch.models.mlp import mlp_apply, mlp_specs


def require_dense(cfg: ModelConfig) -> None:
    """Raise for the families this slice of the port does not cover."""
    if cfg.family in ("moe", "audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet "
            f"(ROADMAP queue 1 item 9)")
    if cfg.family in ("ssm", "hybrid") or cfg.local_global_alternating \
            or cfg.sandwich_norm:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (local/global, SSM, hybrid) "
            f"is not ported yet (ROADMAP queue 1 item 11)")


def model_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """Flat {dotted name: ParamSpec} of the dense family, the same tree as
    the JAX package's ``Model.specs()``."""
    require_dense(cfg)
    dt = cfg.param_dtype
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    specs = {"embed": ParamSpec((V, D), init="embed", dtype=dt),
             "final_norm": ParamSpec((D,), init="zeros", dtype=dt)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((D, V), dtype=dt)
    layer = {"ln1": ParamSpec((D,), init="zeros", dtype=dt),
             "ln2": ParamSpec((D,), init="zeros", dtype=dt)}
    layer.update({f"attn.{k}": s
                  for k, s in attn.attention_specs(cfg, dt).items()})
    layer.update({f"mlp.{k}": s
                  for k, s in mlp_specs(D, cfg.d_ff, dt).items()})
    for k, s in layer.items():
        specs[f"blocks.{k}"] = ParamSpec((L,) + s.shape, init=s.init,
                                         dtype=s.dtype)
    return specs


class Model(nn.Module):
    """The dense decoder. ``params`` is a flat dict (e.g. from
    :func:`~repro_torch.models.common.params_from_numpy`); without it the
    weights are drawn from ``seed`` on ``device``. Either way they are cast
    to ``cfg.compute_dtype`` once, here, and never change device."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 device="cuda", seed: int = 0):
        super().__init__()
        specs = model_specs(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen)
        if set(params) != set(specs):
            raise ValueError(f"parameter names differ from the specs: "
                             f"{sorted(set(params) ^ set(specs))}")
        for name, spec in specs.items():
            if tuple(params[name].shape) != spec.shape:
                raise ValueError(f"{name}: shape {tuple(params[name].shape)}"
                                 f" != {spec.shape}")
        params = {k: v.to(self.device) for k, v in params.items()}
        for name, t in cast_params(params, cfg.compute_dtype).items():
            self._register(name, t)
        self.params: dict[str, torch.Tensor] = dict(self.named_parameters())
        # per-layer views of the stacked blocks: {"ln1", "attn": {...}, ...}
        self.layers = [self._layer(i) for i in range(cfg.num_layers)]

    def _register(self, name: str, tensor: torch.Tensor) -> None:
        *path, leaf = name.split(".")
        mod: nn.Module = self
        for part in path:
            if part not in mod._modules:
                mod.add_module(part, nn.Module())
            mod = mod._modules[part]
        mod.register_parameter(leaf, nn.Parameter(tensor,
                                                  requires_grad=False))

    def _layer(self, i: int) -> dict:
        out: dict = {}
        for name, t in self.params.items():
            if not name.startswith("blocks."):
                continue
            *path, leaf = name.split(".")[1:]
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = t[i]
        return out

    # ------------------------------------------------------------------ cache
    def cache_shapes(self, batch: int, max_len: int) -> dict:
        """Tree of (shape, dtype) for the serving cache."""
        cfg = self.cfg
        cd = cfg.kv_cache_dtype or cfg.compute_dtype
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"k": (shape, cd), "v": (shape, cd)}

    def init_cache(self, batch: int, max_len: int) -> dict:
        return {k: torch.zeros(shape, dtype=torch_dtype(dt),
                               device=self.device)
                for k, (shape, dt) in self.cache_shapes(batch,
                                                        max_len).items()}

    # ---------------------------------------------------------------- layers
    def _attn_layer(self, i: int, x, cache, cache_len, positions, mode):
        cfg = self.cfg
        p = self.layers[i]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = attn.qkv_project(p["attn"], h, cfg, positions)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        if cache is not None:
            attn.write_cache(cache["k"][i], cache["v"][i], k, v, cache_len)
        if mode == "prefill":
            o = attn.attend_causal(q, k, v, scale=scale, cap=cfg.attn_softcap)
        else:
            o = attn.attend_decode(q, cache["k"][i], cache["v"][i], cache_len,
                                   scale=scale, cap=cfg.attn_softcap)
        x, h = add_rms_norm(x, attn.out_project(p["attn"], o), p["ln2"],
                            cfg.norm_eps)
        return x + mlp_apply(p["mlp"], h, cfg.activation)

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, cache: dict | None = None,
                cache_len=0, mode: str = "prefill",
                logits_slice: int | None = None):
        """tokens (B, S) -> (fp32 logits (B, S or logits_slice, V), cache).
        The cache is written in place and returned. ``cache_len`` is a
        scalar or a (B,) tensor of per-sequence offsets."""
        cfg = self.cfg
        if mode not in ("prefill", "extend", "decode"):
            raise ValueError(f"mode {mode!r}")
        if mode != "prefill" and cache is None:
            raise ValueError(f"mode {mode!r} needs a cache")
        tokens = tokens.to(self.device)
        S = tokens.shape[-1]
        x = self.params["embed"][tokens]
        if cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        steps = torch.arange(S, device=self.device)
        if cache is None or isinstance(cache_len, int):
            # a host offset stays on the host: reading a device offset
            # back per layer would stall the stream once a layer
            positions = steps + (0 if cache is None else cache_len)
        else:
            cl = torch.as_tensor(cache_len, device=self.device)
            positions = cl[..., None] + steps if cl.dim() else cl + steps
        for i in range(cfg.num_layers):
            x = self._attn_layer(i, x, cache, cache_len, positions, mode)
        x = rms_norm(x, self.params["final_norm"], cfg.norm_eps)
        if logits_slice is not None:
            x = x[:, -logits_slice:]
        logits = (x @ self.head()).float()
        if cfg.final_softcap:
            logits = softcap(logits, cfg.final_softcap)
        return logits, cache

    def head(self) -> torch.Tensor:
        """The (D, V) output projection in the compute dtype."""
        if self.cfg.tie_embeddings:
            return self.params["embed"].t()
        return self.params["lm_head"]
