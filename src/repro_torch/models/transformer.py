"""Config-driven decoder LM: every family of the JAX package's ``Model``
(dense, MoE, audio, VLM, gemma2's local/global layers, RWKV6 ``ssm`` and
zamba2's Mamba2 ``hybrid``), as an ``nn.Module``.

Parameters mirror ``Model.specs()`` of the JAX package (same dotted keys,
same layouts). A serving model casts them to the compute dtype once, when
it is built (``keep_dtype`` leaves stay fp32); a trainable one keeps fp32
masters and casts them in every forward, as the reference does. The
stacks are the reference's:
``blocks.*`` over a leading L (``dense_layers.*`` over the leading dense
layers of a ``first_k_dense`` MoE model); gemma2's ``blocks.{local,
global}.*`` over L / 2 (local, global) pairs; zamba2's ``blocks.mamba.*``
over (L / E, E) groups of E = ``shared_attn_every`` Mamba2 layers, each
group led by shared attention block g mod ``num_shared_blocks``
(``shared.*``). The layer stack is a Python loop over per-layer views.
Modes: "prefill" (fresh causal or windowed attention, a fresh WKV or SSD
scan, optional cache write), "extend" (a chunk against an existing cache),
"decode", and "train" (:meth:`Model.loss`: no cache, the plain attention
blocks and WKV scan on any device, layers recomputed in backward).
"""
from __future__ import annotations

import contextlib
import functools
import math
from typing import NamedTuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (axis_rules, constrain, current_rules,
                                       default_rules, distribute_params,
                                       matmul, placements_of,
                                       recompute_context,
                                       replicated_like)
from repro_torch.kernels import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.common import (ParamSpec, add_rms_norm, cast_params,
                                       init_params, meta_params, rms_norm,
                                       sinusoidal_emb, softcap, torch_dtype)
from repro_torch.models.mlp import mlp_apply, mlp_specs
from repro_torch.models.moe import moe_apply, moe_specs

#: the families whose ``Model.forward`` the port runs: all of them
PORTED_FAMILIES = ("dense", "moe", "audio", "vlm", "ssm", "hybrid")


def first_k_dense(cfg: ModelConfig) -> int:
    """Leading dense layers of a MoE model (0 for every other model)."""
    return cfg.moe.first_k_dense if cfg.moe else 0


def _stacked(layer: dict[str, ParamSpec], L: int,
             prefix: str) -> dict[str, ParamSpec]:
    return {f"{prefix}.{k}": ParamSpec((L,) + s.shape, ("layers",) + s.axes,
                                       init=s.init, scale=s.scale,
                                       dtype=s.dtype, keep_dtype=s.keep_dtype)
            for k, s in layer.items()}


def model_specs(cfg: ModelConfig) -> dict[str, ParamSpec]:
    """Flat {dotted name: ParamSpec}, the same tree as the JAX package's
    ``Model.specs()``."""
    dt = cfg.param_dtype
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    norm = ParamSpec((D,), ("embed",), init="zeros", dtype=dt)
    specs = {"embed": ParamSpec((V, D), ("vocab", "embed"), init="embed",
                                dtype=dt),
             "final_norm": norm}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((D, V), ("embed", "vocab"), dtype=dt)
    norms = {"ln1": norm, "ln2": norm}
    if cfg.family == "ssm":
        specs.update(_stacked({**norms, **rwkv6.rwkv_specs(cfg, dt)}, L,
                              "blocks"))
        return specs

    def layer(ffn: dict[str, ParamSpec]) -> dict[str, ParamSpec]:
        return {**norms,
                **{f"attn.{k}": s
                   for k, s in attn.attention_specs(cfg, dt).items()},
                **{f"mlp.{k}": s for k, s in ffn.items()}}

    if cfg.family == "hybrid":
        E = cfg.shared_attn_every
        mamba = {"ln": norms["ln1"], **mamba2.mamba_specs(cfg, dt)}
        specs.update(_stacked(_stacked(mamba, E, "mamba"), L // E,
                              "blocks"))
        shared = {"win": ParamSpec((2 * D, D), ("embed_concat", "embed"),
                                   dtype=dt),
                  **layer(mlp_specs(D, cfg.d_ff, dt))}
        specs.update(_stacked(shared, cfg.num_shared_blocks, "shared"))
        return specs
    if cfg.sandwich_norm:
        norms.update(ln1_post=norms["ln1"], ln2_post=norms["ln1"])
    if cfg.local_global_alternating:
        one = layer(mlp_specs(D, cfg.d_ff, dt))
        pair = {f"{kind}.{k}": s for kind in ("local", "global")
                for k, s in one.items()}
        specs.update(_stacked(pair, L // 2, "blocks"))
        return specs

    first_k = first_k_dense(cfg)
    if first_k:
        dff = cfg.moe.dense_d_ff or cfg.d_ff
        specs.update(_stacked(layer(mlp_specs(D, dff, dt)), first_k,
                              "dense_layers"))
    ffn = moe_specs(cfg, dt) if cfg.moe else mlp_specs(D, cfg.d_ff, dt)
    specs.update(_stacked(layer(ffn), L - first_k, "blocks"))
    return specs


class Weights(NamedTuple):
    """What a forward reads: the flat parameter dict in the forward's
    dtypes and the per-layer views of its stacked leaves ({"ln1", "attn":
    {...}, ...}): the leading dense layers (first_k_dense), then the
    blocks (gemma2 local, global, local, ...; zamba2 its Mamba2 layers in
    order), and zamba2's shared blocks apart."""
    params: dict
    first_layers: list
    layers: list
    shared_blocks: list


class Model(nn.Module):
    """The decoder. ``params`` is a flat dict (e.g. from
    :func:`~repro_torch.models.common.params_from_numpy`); without it the
    weights are drawn from ``seed`` on ``device`` leaf by leaf (on the
    ``meta`` device, for the step counter, they are shapes alone). Either
    way they never change device.

    ``mesh`` (a ``DeviceMesh`` with axes "data"/"model", and "pod"): every
    rank holds the whole tree, and each leaf becomes a DTensor placed by
    its spec's logical axes under ``rules`` (default: the mesh's serving
    rules, or its training rules for a trainable model). The forward then
    runs on DTensors under the rules (:mod:`repro_torch.dist.sharding`),
    its attention and MoE dispatch on each rank's local pieces.

    Serving (the default) casts the leaves to ``cfg.compute_dtype`` once,
    here, each as it is drawn (the same values), and ``forward`` reads
    per-layer views built once. ``trainable=True`` keeps fp32 masters
    (``cfg.param_dtype``) that require grad; each forward casts them to
    the compute dtype and takes its per-layer views from that cast, as
    the reference's ``cast_params`` does on every call, so the grads
    arrive in fp32. :meth:`loss` is the training forward."""

    def __init__(self, cfg: ModelConfig, params: dict | None = None, *,
                 device="cuda", seed: int = 0, trainable: bool = False,
                 mesh=None, rules: dict | None = None):
        super().__init__()
        specs = model_specs(cfg)
        self.cfg = cfg
        self.specs = specs
        self.trainable = trainable
        self.mesh = mesh
        self.rules = None if mesh is None else rules or default_rules(
            cfg, mesh, "train" if trainable else "prefill")
        self.device = resolve_device(device, allow_meta=True)
        store = None if trainable else cfg.compute_dtype
        given = params is not None
        if params is None and self.device.type == "meta":
            params = meta_params(cfg, store)
        elif params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_params(cfg, gen, store)
        if set(params) != set(specs):
            raise ValueError(f"parameter names differ from the specs: "
                             f"{sorted(set(params) ^ set(specs))}")
        for name, spec in specs.items():
            if tuple(params[name].shape) != spec.shape:
                raise ValueError(f"{name}: shape {tuple(params[name].shape)}"
                                 f" != {spec.shape}")
        if trainable:       # copied: training writes the masters in place
            params = {k: v.to(self.device, torch_dtype(specs[k].dtype),
                              copy=given) for k, v in params.items()}
        else:
            params = cast_params({k: v.to(self.device)
                                  for k, v in params.items()}, specs,
                                 cfg.compute_dtype)
        if mesh is not None:
            params = distribute_params(params, specs, mesh, self.rules)
        for name, t in params.items():
            self._register(name, t)
        self.params: dict[str, torch.Tensor] = dict(self.named_parameters())
        with torch.no_grad():
            self._built = self._weights(self.params)
        self.first_layers, self.layers, self.shared_blocks = self._built[1:]

    def sharded(self, mesh, rules: dict | None = None) -> "Model":
        """A model over ``mesh`` holding this one's weights (copied into
        DTensors; a trainable model's masters and their dtype kept)."""
        params = {k: v.detach() for k, v in self.params.items()}
        return Model(self.cfg, params, device=self.device,
                     trainable=self.trainable, mesh=mesh, rules=rules)

    def _sharding(self):
        """The model's rules while no step has installed its own."""
        if self.mesh is None or current_rules() is not None:
            return contextlib.nullcontext()
        return axis_rules(self.rules)

    def _register(self, name: str, tensor: torch.Tensor) -> None:
        *path, leaf = name.split(".")
        mod: nn.Module = self
        for part in path:
            if part not in mod._modules:
                mod.add_module(part, nn.Module())
            mod = mod._modules[part]
        mod.register_parameter(leaf, nn.Parameter(
            tensor, requires_grad=self.trainable))

    @staticmethod
    def _unstack(params: dict, stack: str) -> list[dict]:
        """Per-layer nested dicts of views of the ``stack.*`` leaves: one
        ``unbind`` a leaf (under autograd its backward is one stack of the
        layers' grads, not a full-size zero tensor a layer)."""
        out: list[dict] = []
        for name, t in params.items():
            if not name.startswith(stack + "."):
                continue
            *path, leaf = name.split(".")[1:]
            parts = t.unbind(0)
            out = out or [{} for _ in parts]
            for node, part in zip(out, parts):
                for key in path:
                    node = node.setdefault(key, {})
                node[leaf] = part
        return out

    def _weights(self, params: dict) -> Weights:
        cfg = self.cfg
        shared = self._unstack(params, "shared") \
            if cfg.family == "hybrid" else []
        blocks = self._unstack(params, "blocks")
        if cfg.family == "hybrid":
            layers = [dict(zip(grp["mamba"], views))
                      for grp in blocks
                      for views in zip(*(t.unbind(0)
                                         for t in grp["mamba"].values()))]
        elif cfg.local_global_alternating:
            layers = [pair[kind] for pair in blocks
                      for kind in ("local", "global")]
        else:
            layers = blocks
        return Weights(params, self._unstack(params, "dense_layers"),
                       layers, shared)

    def _forward_weights(self) -> Weights:
        """Serving: the views built with the model. A trainable model: the
        masters cast to the compute dtype, viewed anew on every call, so
        no step backpropagates through an earlier step's views."""
        if not self.trainable:
            return self._built
        return self._weights(cast_params(self.params, self.specs,
                                         self.cfg.compute_dtype))

    # ------------------------------------------------------------------ cache
    def cache_shapes(self, batch: int, max_len: int) -> dict:
        """Tree of (shape, dtype) for the serving cache, the reference's:
        ``k``/``v`` of the ``blocks`` layers and, for a ``first_k_dense``
        model, ``k0``/``v0`` of its leading dense layers; gemma2's
        ``k_local``/``v_local`` rings of min(window, max_len) slots beside
        ``k_global``/``v_global``; zamba2's Mamba2 ``conv`` and fp32
        ``ssm`` states over (groups, E) and its shared blocks'
        ``shared_k``/``shared_v`` a group."""
        cfg = self.cfg
        cd = cfg.kv_cache_dtype or cfg.compute_dtype
        L = cfg.num_layers
        if cfg.family == "ssm":
            H, K = rwkv6.rwkv_dims(cfg)
            return {"shift1": ((L, batch, cfg.d_model), cd),
                    "wkv": ((L, batch, H, K, K), "float32"),
                    "shift2": ((L, batch, cfg.d_model), cd)}
        first_k = first_k_dense(cfg)
        tail = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        if cfg.family == "hybrid":
            E = cfg.shared_attn_every
            st = mamba2.mamba_state_shapes(cfg, batch)
            return {"conv": ((L // E, E) + st["conv"][0], st["conv"][1]),
                    "ssm": ((L // E, E) + st["ssm"][0], st["ssm"][1]),
                    "shared_k": ((L // E,) + tail, cd),
                    "shared_v": ((L // E,) + tail, cd)}
        if cfg.local_global_alternating:
            ring = (L // 2, batch, min(cfg.sliding_window, max_len)) + \
                tail[2:]
            return {"k_local": (ring, cd), "v_local": (ring, cd),
                    "k_global": ((L // 2,) + tail, cd),
                    "v_global": ((L // 2,) + tail, cd)}
        out = {"k": ((L - first_k,) + tail, cd),
               "v": ((L - first_k,) + tail, cd)}
        if first_k:
            out["k0"] = ((first_k,) + tail, cd)
            out["v0"] = ((first_k,) + tail, cd)
        return out

    def cache_logical_axes(self) -> dict:
        """Logical axes of each cache leaf (for its placement), the
        reference's."""
        cfg = self.cfg
        kv_axes = ("layers", "act_batch", "cache_seq", "cache_kv_heads",
                   None)
        if cfg.family == "ssm":
            return {"shift1": ("layers", "act_batch", None),
                    "wkv": ("layers", "act_batch", "rwkv_heads", "rwkv_k",
                            "rwkv_v"),
                    "shift2": ("layers", "act_batch", None)}
        if cfg.family == "hybrid":
            return {"conv": ("layers", None, "act_batch", None, "conv_dim"),
                    "ssm": ("layers", None, "act_batch", "ssm_heads", None,
                            "ssm_state"),
                    "shared_k": kv_axes, "shared_v": kv_axes}
        if cfg.local_global_alternating:
            return {"k_local": kv_axes, "v_local": kv_axes,
                    "k_global": kv_axes, "v_global": kv_axes}
        out = {"k": kv_axes, "v": kv_axes}
        if first_k_dense(cfg):
            out["k0"] = kv_axes
            out["v0"] = kv_axes
        return out

    def init_cache(self, batch: int, max_len: int,
                   rules: dict | None = None) -> dict:
        """Zeros of :meth:`cache_shapes`. On a mesh each leaf is a DTensor
        placed by :meth:`cache_logical_axes` under ``rules`` (default:
        the model's), each rank allocating its own piece."""
        shapes = self.cache_shapes(batch, max_len)
        if self.mesh is None:
            return {k: torch.zeros(shape, dtype=torch_dtype(dt),
                                   device=self.device)
                    for k, (shape, dt) in shapes.items()}
        rules = rules or self.rules
        axes = self.cache_logical_axes()
        return {k: sharded_zeros(shape, torch_dtype(dt), self.device,
                                 rules, axes[k])
                for k, (shape, dt) in shapes.items()}

    # ---------------------------------------------------------------- layers
    def _step(self, mode: str, fn, *args):
        """``fn(*args)``, recomputed in backward (non-reentrant activation
        checkpointing) in a training forward when ``cfg.remat`` is not
        "none": the reference's ``jax.checkpoint`` of its scan body, taken
        per layer. ``fn`` binds its layer's weights (a partial), never a
        loop variable."""
        if mode == "train" and self.cfg.remat != "none":
            return checkpoint(fn, *args, use_reentrant=False,
                              context_fn=recompute_context())
        return fn(*args)

    def _attn_apply(self, p: dict, h, kv, cache_len, positions, mode,
                    window: int = 0):
        """One attention sublayer on the normed input ``h``; ``kv`` is the
        layer's (k, v) cache pair, written in place, or None. ``window``
        > 0: gemma2's sliding window (its cache a ring when it has exactly
        ``window`` slots). Mode "train" runs the plain blocks on any
        device, each recomputed in backward unless the whole layer is
        (``cfg.remat``): nested, the blocks' forward would run a third
        time for nothing the backward needs."""
        cfg = self.cfg
        q, k, v = attn.qkv_project(p, h, cfg, positions)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        if isinstance(q, DTensor):
            o = attn.attend_sharded(q, k, v, kv, cache_len, mode=mode,
                                    scale=scale, cap=cfg.attn_softcap,
                                    window=window,
                                    remat=cfg.remat == "none")
            return attn.out_project(p, o)
        if kv is not None:
            attn.write_cache(kv[0], kv[1], k, v, cache_len,
                             ring=attn.is_ring(kv[0], window))
        if mode in ("extend", "decode"):
            o = attn.attend_decode(q, kv[0], kv[1], cache_len, scale=scale,
                                   cap=cfg.attn_softcap, window=window)
        elif mode == "train" and window:
            o = attn.windowed_blocks(q, k, v, scale=scale, window=window,
                                     cap=cfg.attn_softcap,
                                     remat=cfg.remat == "none")
        elif mode == "train":
            o = attn.causal_blocks(q, k, v, scale=scale,
                                   cap=cfg.attn_softcap,
                                   remat=cfg.remat == "none")
        elif window:
            o = attn.attend_windowed(q, k, v, scale=scale, window=window,
                                     cap=cfg.attn_softcap)
        else:
            o = attn.attend_causal(q, k, v, scale=scale, cap=cfg.attn_softcap)
        return attn.out_project(p, o)

    def _attn_layer(self, p: dict, x, kv, cache_len, positions, mode,
                    fused: bool = True, window: int = 0, delta=None):
        """One attention layer; ``kv`` is the layer's (k, v) cache pair or
        None. Returns the residual stream before the FFN's output and that
        output, for the caller to add. The FFN is MoE where the layer has
        a router; gemma2's sandwich norms (``ln1_post``, ``ln2_post``) norm
        each sublayer's output before its residual add. ``fused``: ln2
        reads the fp32 residual sum before it is rounded, as XLA's fusion
        computes the reference's scanned layers (ROADMAP P2); the
        reference runs its leading dense layers outside the scan, op by
        op, where ln2 reads the rounded sum (``fused=False``). ``delta``:
        the previous layer's FFN output, added here, ln1 reading the sum
        unrounded (gemma2's global layer after its local one: the
        reference's pair is one fused scan body)."""
        cfg = self.cfg
        if delta is None:
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
        else:
            x, h = add_rms_norm(x, delta, p["ln1"], cfg.norm_eps)
        a = self._attn_apply(p["attn"], h, kv, cache_len, positions, mode,
                             window)
        if cfg.sandwich_norm:
            a = rms_norm(a, p["ln1_post"], cfg.norm_eps)
        if fused:
            x, h = add_rms_norm(x, a, p["ln2"], cfg.norm_eps)
        else:
            x = x + a
            h = rms_norm(x, p["ln2"], cfg.norm_eps)
        f = ffn_apply(p["mlp"], h, cfg)
        if cfg.sandwich_norm:
            f = rms_norm(f, p["ln2_post"], cfg.norm_eps)
        return x, f

    def _dense_layer(self, p: dict, x, kv, cache_len, positions, mode,
                     fused: bool):
        """An attention layer with its FFN's output added."""
        x, f = self._attn_layer(p, x, kv, cache_len, positions, mode, fused)
        return x + f

    def _shared_block(self, p: dict, x, x0, kv, cache_len, positions,
                      mode):
        """zamba2's shared attention + MLP block: its input is
        ``concat(x, x0) @ win``, with x0 the (scaled) embeddings; its
        output is added to the residual stream."""
        cfg = self.cfg
        h = matmul(torch.cat([x, x0], dim=-1), p["win"])
        a = self._attn_apply(p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                             kv, cache_len, positions, mode)
        h, h2 = add_rms_norm(h, a, p["ln2"], cfg.norm_eps)
        return x + (h + mlp_apply(p["mlp"], h2, cfg.activation))

    def _mamba_layer(self, p: dict, x, state, mode):
        """One Mamba2 layer and its residual add; returns (x, new state)."""
        out, new = mamba2.mamba_apply(
            p, rms_norm(x, p["ln"], self.cfg.norm_eps), self.cfg, state,
            mode)
        return x + out, new

    def _hybrid(self, w: Weights, x, cache, cache_len, positions, mode):
        """zamba2's stack: per group g, shared block g mod
        ``num_shared_blocks`` (its KV in ``shared_k/v[g]``), then the
        group's E Mamba2 layers (their states in ``conv/ssm[g, e]``,
        written back in place)."""
        cfg = self.cfg
        E = cfg.shared_attn_every
        x0 = x
        for g in range(cfg.num_layers // E):
            kv = None if cache is None else (cache["shared_k"][g],
                                             cache["shared_v"][g])
            shared = w.shared_blocks[g % len(w.shared_blocks)]
            x = _act(self._step(mode, functools.partial(
                self._shared_block, shared, kv=kv, cache_len=cache_len,
                positions=positions, mode=mode), x, x0))
            for e in range(E):
                state = None if cache is None else {
                    "conv": cache["conv"][g, e], "ssm": cache["ssm"][g, e]}
                x, new = self._step(mode, functools.partial(
                    self._mamba_layer, w.layers[g * E + e], state=state,
                    mode=mode), x)
                x = _act(x)
                if cache is not None:
                    cache["conv"][g, e] = new["conv"]
                    cache["ssm"][g, e] = new["ssm"]
        return x

    def _rwkv_layer(self, p: dict, x, cache, i: int, mode):
        """Time mix + channel mix; layer ``i``'s token-shift and WKV states
        are read from and written back into ``cache`` in place."""
        cfg = self.cfg
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        tm_state = None if cache is None else {"shift": cache["shift1"][i],
                                               "wkv": cache["wkv"][i]}
        a, tm_new = rwkv6.time_mix_apply(p["tmix"], h, cfg, tm_state, mode)
        x, h = add_rms_norm(x, a, p["ln2"], cfg.norm_eps)
        f, cm_new = rwkv6.channel_mix_apply(
            p["cmix"], h, cfg, None if cache is None else cache["shift2"][i],
            mode)
        if cache is not None:
            cache["shift1"][i] = tm_new["shift"]
            cache["wkv"][i] = tm_new["wkv"]
            cache["shift2"][i] = cm_new
        return x + f

    # --------------------------------------------------------------- forward
    @torch.no_grad()
    def forward(self, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None, cache: dict | None = None,
                cache_len=0, mode: str = "prefill",
                logits_slice: int | None = None):
        """tokens (B, S), or embeds (B, S, D) for the VLM family's patch
        embeddings (no position embedding added) -> (fp32 logits (B, S or
        logits_slice, V), cache). The cache is written in place and
        returned. ``cache_len`` is a scalar or a (B,) tensor of
        per-sequence offsets."""
        if mode not in ("prefill", "extend", "decode"):
            raise ValueError(f"mode {mode!r}")
        if mode != "prefill" and cache is None:
            raise ValueError(f"mode {mode!r} needs a cache")
        if (tokens is None) == (embeds is None):
            raise ValueError("pass exactly one of tokens or embeds")
        with self._sharding():
            w = self._forward_weights()
            x = self._hidden(w, tokens, embeds, cache, cache_len, mode)
            if logits_slice is not None:
                x = x[:, -logits_slice:]
            return self._logits(w, x), cache

    def _hidden(self, w: Weights, tokens, embeds, cache, cache_len, mode):
        """Embedding, the layer stack and the final norm."""
        cfg = self.cfg
        if embeds is None:
            tokens = tokens.to(self.device)
            S = tokens.shape[-1]
            table = w.params["embed"]
            x = _embed_sharded(table, tokens) \
                if isinstance(table, DTensor) else table[tokens]
        else:
            x = embeds.to(self.device, torch_dtype(cfg.compute_dtype))
            S = x.shape[1]
        if cfg.family == "ssm":
            x = _act(self._scale_embeddings(x))
            for i, p in enumerate(w.layers):
                x = _act(self._step(mode, functools.partial(
                    self._rwkv_layer, p, cache=cache, i=i, mode=mode), x))
            return rms_norm(x, w.params["final_norm"], cfg.norm_eps)
        steps = torch.arange(S, device=self.device)
        if cache is None or isinstance(cache_len, int):
            # a host offset stays on the host: reading a device offset
            # back per layer would stall the stream once a layer
            positions = steps + (0 if cache is None else cache_len)
        else:
            cl = torch.as_tensor(cache_len, device=self.device)
            positions = cl[..., None] + steps if cl.dim() else cl + steps
        if embeds is None and cfg.pos_emb == "sinusoidal":
            x = x + replicated_like(
                sinusoidal_emb(positions, cfg.d_model).to(x.dtype), x)
        x = _act(self._scale_embeddings(x))
        if cfg.family == "hybrid":
            x = self._hybrid(w, x, cache, cache_len, positions, mode)
        elif cfg.local_global_alternating:
            W = cfg.sliding_window
            # extend and decode both read the ring after the chunk's write
            if mode in ("extend", "decode") and \
                    attn.is_ring(cache["k_local"][0], W):
                attn.refuse_ring_extend(cache_len, S, W)
            for i, p in enumerate(w.layers):
                kind, g = ("local", "global")[i % 2], i // 2
                kv = None if cache is None else (cache[f"k_{kind}"][g],
                                                 cache[f"v_{kind}"][g])
                layer = functools.partial(self._attn_layer, p, kv=kv,
                                          cache_len=cache_len,
                                          positions=positions, mode=mode)
                if kind == "local":
                    x, f = self._step(mode, functools.partial(
                        layer, window=W), x)
                else:
                    x, f = self._step(mode, lambda x, f, layer=layer:
                                      layer(x, delta=f), x, f)
                    x = _act(x + f)
        else:
            for stack, k, v, fused in ((w.first_layers, "k0", "v0", False),
                                       (w.layers, "k", "v", True)):
                for i, p in enumerate(stack):
                    kv = None if cache is None else (cache[k][i],
                                                     cache[v][i])
                    x = _act(self._step(mode, functools.partial(
                        self._dense_layer, p, kv=kv, cache_len=cache_len,
                        positions=positions, mode=mode, fused=fused), x))
        return rms_norm(x, w.params["final_norm"], cfg.norm_eps)

    def _scale_embeddings(self, x):
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(self.cfg.d_model), dtype=x.dtype)
        return x

    def _logits(self, w: Weights, x):
        logits = matmul(x, self._head(w)).float()
        if self.cfg.final_softcap:
            logits = softcap(logits, self.cfg.final_softcap)
        return constrain(logits, "act_batch", "act_seq", "vocab")

    def _head(self, w: Weights) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return w.params["embed"].t()
        return w.params["lm_head"]

    def head(self) -> torch.Tensor:
        """The (D, V) output projection in the compute dtype."""
        return self._head(self._built)

    # ------------------------------------------------------------------ loss
    def _train_weights(self) -> Weights:
        if not self.trainable:
            raise ValueError("the training forward needs a "
                             "Model(..., trainable=True): a serving model "
                             "holds no fp32 masters")
        return self._forward_weights()

    def hidden_states(self, tokens: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states of the training forward (no logits)."""
        with self._sharding():
            return self._hidden(self._train_weights(), tokens, None, None,
                                0, "train")

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor | None = None,
             loss_chunk: int = 1024) -> torch.Tensor:
        """Mean next-token cross entropy (the reference's ``Model.loss``),
        differentiable with respect to the fp32 masters. The logits are
        computed a chunk of ``loss_chunk`` positions at a time and each
        chunk is recomputed in backward, so the (B, S, V) fp32 logits
        never exist whole (a length not a multiple of the chunk is one
        chunk, as in the reference)."""
        with self._sharding():
            w = self._train_weights()
            hidden = self._hidden(w, tokens, None, None, 0, "train")
            # the head's grad stays sharded like the head
            head = constrain(self._head(w), "embed", "vocab")
            labels = labels.to(self.device).long()
            S = hidden.shape[1]
            C = min(loss_chunk, S)
            if S % C:
                C = S
            nll = torch.cat([checkpoint(self._chunk_nll, hidden[:, i:i + C],
                                        labels[:, i:i + C], head,
                                        use_reentrant=False,
                                        context_fn=recompute_context())
                             for i in range(0, S, C)], dim=1)
            if mask is not None:
                mask = mask.to(self.device, nll.dtype)
                return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
            return nll.mean()

    def _chunk_nll(self, h, labels, head):
        """-log p(label) at each position of one chunk, from its fp32
        logits."""
        logits = matmul(h, head).float()
        if self.cfg.final_softcap:
            logits = softcap(logits, self.cfg.final_softcap)
        logits = constrain(logits, "act_batch", "act_seq", "vocab")
        picked = _pick_sharded(logits, labels) \
            if isinstance(logits, DTensor) else \
            logits.gather(-1, labels[..., None])[..., 0]
        return torch.logsumexp(logits, dim=-1) - picked


def _embed_sharded(table: DTensor, tokens) -> DTensor:
    """The embedding lookup on a mesh, vocab-parallel: each rank looks up
    the ids its rows of the table hold (zeros for the others), and the
    pieces are a partial sum over the ranks that split the vocab (exact:
    one nonzero term)."""
    from torch.distributed.tensor import Partial, Shard
    from repro_torch.dist.sharding import local_offset, place, to_local
    table = place(table, "vocab", None)
    tokens = place(tokens, "act_batch", None)
    out = [Partial() if pt.is_shard(0) else
           Shard(0) if pb.is_shard(0) else pb
           for pt, pb in zip(table.placements, tokens.placements)]
    tl, ids = to_local(table, out), tokens.to_local()
    if tl.shape[0] == table.shape[0]:
        xl = tl[ids]
    else:
        ids = ids - local_offset(table)[0]
        hit = (ids >= 0) & (ids < tl.shape[0])
        xl = tl[ids.clamp(0, tl.shape[0] - 1)] * hit[..., None].to(tl.dtype)
    return DTensor.from_local(xl, table.device_mesh, out, run_check=False)


def _pick_sharded(logits: DTensor, labels) -> DTensor:
    """``logits[..., labels]`` on a mesh, vocab-parallel: each rank picks
    the labels its vocab piece holds (zero for the others), a partial sum
    over the ranks that split the vocab."""
    from torch.distributed.tensor import Partial, Shard
    from repro_torch.dist.sharding import local_offset, place
    logits = place(logits, "act_batch", "act_seq", "vocab")
    labels = place(labels, "act_batch", "act_seq")
    ll, ids = logits.to_local(), labels.to_local()
    ids = ids - local_offset(logits)[2]
    hit = (ids >= 0) & (ids < ll.shape[2])
    got = ll.gather(-1, ids.clamp(0, ll.shape[2] - 1)[..., None])[..., 0]
    got = got * hit.to(got.dtype)
    out = [Partial() if pl.is_shard(2) else pl for pl in logits.placements]
    return DTensor.from_local(got, logits.device_mesh, out, run_check=False)


def _act(x):
    """The residual stream's placement (the reference's constrain after
    the embedding and each layer)."""
    return constrain(x, "act_batch", "act_seq", "act_embed")


def sharded_zeros(shape, dtype, device, rules: dict, axes) -> DTensor:
    """A DTensor of zeros placed by ``axes`` under ``rules``; each rank
    allocates only its piece."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = rules["__mesh__"]
    place = placements_of(axes, rules, shape)
    local = compute_local_shape_and_global_offset(shape, mesh, place)[0]
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, place, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def ffn_apply(p: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A layer's FFN: MoE where its params hold a router, else the dense
    gated MLP (the reference's ``"router" in p["mlp"]``)."""
    if "router" in p:
        return moe_apply(p, h, cfg)
    return mlp_apply(p, h, cfg.activation)
