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

``Model.forward(..., fused=True)`` (the paged runtime's prefill chunk
with its ``fused`` switch on; ``build_prefill_step`` and
``build_decode_step`` on one card by default) runs the attention layers'
RMS norms, with their residual adds (zamba2's shared blocks' too), the
final norm and the dense FFN's gated product (``gate_up_act``: its one
launch at up to 16 bf16 rows, else the two products and the gated
activation's kernel) through :mod:`repro_torch.kernels.fusions`, a
prefill or extend chunk's qkv bias, qk norm, RoPE and cache write over a
plain cache as one launch of the fusions' qkv kernel, a one-token step's
qkv products with that chain as the decode qkv launch (or the products
and the row pass's kernel, by shape) before its cache write, a chunk's
attention over the cache as the flash kernels' extend launch and a
one-token step's as decode attention's dense launch, on CUDA tensors;
the default keeps the plain spelling of all of them (the fresh
prefill's attention is the flash kernel either way). Both give the same
bits on the CPU. zamba2's Mamba2 layers take their norm through the norm
kernel and their mixer through the Mamba2 kernels when ``fused``
(:mod:`repro_torch.kernels.mamba2`: a one-token step's conv, recurrence,
gate and norm as one launch, a prompt's SSD with its gate and norm as
another; on CUDA tensors only, so the CPU keeps the plain bits).
RWKV6 layers keep their own ops either way.
The rotary tables are built once a forward, from its positions.
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
from repro_torch.kernels import fusions
from repro_torch.models import mamba2, rwkv6
from repro_torch.models.common import (ParamSpec, add_rms_norm, cast_params,
                                       init_params, meta_params, rms_norm,
                                       rope_tables, sinusoidal_emb, softcap,
                                       torch_dtype)
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
        loop variable. No RNG state is stashed for the recomputation: the
        training forward draws no random numbers, and the captured step
        (``train/train_graph.py``) then touches no generator."""
        if mode == "train" and self.cfg.remat != "none":
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False,
                              context_fn=recompute_context())
        return fn(*args)

    def _attn_apply(self, p: dict, h, kv, cache_len, rope, mode,
                    window: int = 0, fused: bool = False):
        """One attention sublayer on the normed input ``h``; ``kv`` is the
        layer's (k, v) cache pair, written in place, or None; ``rope`` the
        forward's (cos, sin) tables or None. ``window`` > 0: gemma2's
        sliding window (its cache a ring when it has exactly ``window``
        slots). Mode "train" runs the plain blocks on any device, each
        recomputed in backward unless the whole layer is (``cfg.remat``):
        nested, the blocks' forward would run a third time for nothing the
        backward needs. ``fused``: a prefill or extend chunk on CUDA
        tensors over a plain cache (not a ring) takes its qkv bias, qk
        norm, RoPE and cache write as one launch (:func:`_fused_qkv_write`),
        a one-token step on CUDA tensors its qkv pass through
        ``fusions.qkv_proj`` before its cache write
        (:func:`_fused_decode_qkv`), and extend and decode attention the
        extend launch or decode attention's dense launch where
        ``attend_decode`` takes them; else (and on the CPU) the plain
        spelling."""
        cfg = self.cfg
        scale = 1.0 / math.sqrt(cfg.head_dim)
        if _takes_qkv_launch(fused, h, kv, mode, window):
            q, k, v = attn.qkv_project(p, h, cfg, rope=rope, finish=(
                functools.partial(_fused_qkv_write, cache=kv,
                                  cache_len=cache_len,
                                  rows=mode == "prefill")))
        elif _takes_decode_qkv(fused, h, kv, mode, cfg, rope):
            q, k, v = attn.qkv_project(p, h, cfg, rope=rope, project=(
                functools.partial(_fused_decode_qkv, cache=kv,
                                  cache_len=cache_len,
                                  ring=attn.is_ring(kv[0], window))))
        else:
            q, k, v = attn.qkv_project(p, h, cfg, rope=rope)
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
                                   cap=cfg.attn_softcap, window=window,
                                   plain=not fused, mode=mode)
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

    def _norm(self, x, scale, delta=None, *, fp32_sum: bool = False,
              fused: bool = False):
        """``rms_norm(x)``, or with ``delta`` ``(x + delta, norm)``, the
        norm reading the fp32 sum (``fp32_sum``: ``add_rms_norm``) or the
        rounded one: :func:`repro_torch.kernels.fusions.rms_norm`, its
        kernel on CUDA tensors when ``fused``, else the plain spelling on
        any device (the same ops, bit for bit)."""
        return fusions.rms_norm(x, scale, self.cfg.norm_eps, delta,
                                fp32_sum=fp32_sum, plain=not fused)

    def _attn_layer(self, p: dict, x, kv, cache_len, rope, mode,
                    scanned: bool = True, window: int = 0, delta=None,
                    fused: bool = False):
        """One attention layer; ``kv`` is the layer's (k, v) cache pair or
        None. Returns the residual stream before the FFN's output and that
        output, for the caller to add. The FFN is MoE where the layer has
        a router; gemma2's sandwich norms (``ln1_post``, ``ln2_post``) norm
        each sublayer's output before its residual add. ``scanned``: ln2
        reads the fp32 residual sum before it is rounded, as XLA's fusion
        computes the reference's scanned layers (ROADMAP P2); the
        reference runs its leading dense layers outside the scan, op by
        op, where ln2 reads the rounded sum (``scanned=False``).
        ``delta``: the previous layer's FFN output, added here, ln1
        reading the sum unrounded (gemma2's global layer after its local
        one: the reference's pair is one fused scan body). ``fused``: as
        :meth:`forward`'s."""
        cfg = self.cfg
        if delta is None:
            h = self._norm(x, p["ln1"], fused=fused)
        else:
            x, h = self._norm(x, p["ln1"], delta, fp32_sum=True, fused=fused)
        a = self._attn_apply(p["attn"], h, kv, cache_len, rope, mode,
                             window, fused)
        if cfg.sandwich_norm:
            a = self._norm(a, p["ln1_post"], fused=fused)
        x, h = self._norm(x, p["ln2"], a, fp32_sum=scanned, fused=fused)
        f = ffn_apply(p["mlp"], h, cfg, functools.partial(
            fusions.gate_up_act, activation=cfg.activation) if fused
            else None)
        if cfg.sandwich_norm:
            f = self._norm(f, p["ln2_post"], fused=fused)
        return x, f

    def _dense_layer(self, p: dict, x, kv, cache_len, rope, mode,
                     scanned: bool, fused: bool = False):
        """An attention layer with its FFN's output added."""
        x, f = self._attn_layer(p, x, kv, cache_len, rope, mode,
                                scanned, fused=fused)
        return x + f

    def _shared_block(self, p: dict, x, x0, kv, cache_len, rope, mode,
                      fused: bool = False):
        """zamba2's shared attention + MLP block: its input is
        ``concat(x, x0) @ win``, with x0 the (scaled) embeddings; its
        output is added to the residual stream. ``fused``: its ln1 and
        its add + ln2 (reading the fp32 sum) through the norm kernel, its
        attention as :meth:`_attn_apply`'s and its MLP's gated product as
        ``gate_up_act`` (the plain spelling: ``rms_norm``,
        ``add_rms_norm`` and ``mlp_apply``'s ops, bit for bit)."""
        cfg = self.cfg
        h = matmul(torch.cat([x, x0], dim=-1), p["win"])
        a = self._attn_apply(p["attn"],
                             self._norm(h, p["ln1"], fused=fused), kv,
                             cache_len, rope, mode, fused=fused)
        h, h2 = self._norm(h, p["ln2"], a, fp32_sum=True, fused=fused)
        f = mlp_apply(p["mlp"], h2, cfg.activation, functools.partial(
            fusions.gate_up_act, activation=cfg.activation) if fused
            else None)
        return x + (h + f)

    def _mamba_layer(self, p: dict, x, state, mode, fused: bool = False):
        """One Mamba2 layer and its residual add; returns (x, new state).
        ``fused``: its norm through the norm kernel and its mixer through
        the Mamba2 kernels (``mamba2.mamba_apply(fused=True)``) on CUDA
        tensors."""
        out, new = mamba2.mamba_apply(
            p, self._norm(x, p["ln"], fused=fused), self.cfg, state, mode,
            fused=fused)
        return x + out, new

    def _hybrid(self, w: Weights, x, cache, cache_len, rope, mode,
                fused: bool = False):
        """zamba2's stack: per group g, shared block g mod
        ``num_shared_blocks`` (its KV in ``shared_k/v[g]``; ``fused`` as
        :meth:`forward`'s), then the group's E Mamba2 layers (their
        states in ``conv/ssm[g, e]``, written back in place; a state the
        kernels updated in place is not copied)."""
        cfg = self.cfg
        E = cfg.shared_attn_every
        x0 = x
        for g in range(cfg.num_layers // E):
            kv = None if cache is None else (cache["shared_k"][g],
                                             cache["shared_v"][g])
            shared = w.shared_blocks[g % len(w.shared_blocks)]
            x = _act(self._step(mode, functools.partial(
                self._shared_block, shared, kv=kv, cache_len=cache_len,
                rope=rope, mode=mode, fused=fused), x, x0))
            for e in range(E):
                state = None if cache is None else {
                    "conv": cache["conv"][g, e], "ssm": cache["ssm"][g, e]}
                x, new = self._step(mode, functools.partial(
                    self._mamba_layer, w.layers[g * E + e], state=state,
                    mode=mode, fused=fused), x)
                x = _act(x)
                if cache is not None:
                    for key in ("conv", "ssm"):
                        if new[key] is not state[key]:
                            cache[key][g, e] = new[key]
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
                logits_slice: int | None = None,
                rows: torch.Tensor | None = None,
                fused: bool = False):
        """tokens (B, S), or embeds (B, S, D) for the VLM family's patch
        embeddings (no position embedding added) -> (fp32 logits (B, S or
        logits_slice, V), cache). The cache is written in place and
        returned. ``cache_len`` is a scalar or a (B,) tensor of
        per-sequence offsets. ``rows``: an (n,) index tensor; the logits
        of those rows only (B, n, V), picked before the final norm, so the
        norm and the head run on n rows (the paged runtime's chunk: its
        last real row, an index on the device). ``fused``: the chains the
        paged runtime's switch covers through their kernels (the module's
        docstring); refused on a mesh (the fusions take local CUDA
        tensors, never a DTensor)."""
        if mode not in ("prefill", "extend", "decode"):
            raise ValueError(f"mode {mode!r}")
        if mode != "prefill" and cache is None:
            raise ValueError(f"mode {mode!r} needs a cache")
        if (tokens is None) == (embeds is None):
            raise ValueError("pass exactly one of tokens or embeds")
        if fused and self.mesh is not None:
            raise ValueError("fused=True runs the fusion kernels on local "
                             "tensors, never on a meshed model's DTensors")
        with self._sharding(), attn.forward_scope():
            w = self._forward_weights()
            x = self._hidden(w, tokens, embeds, cache, cache_len, mode,
                             rows, fused)
            if logits_slice is not None:
                x = x[:, -logits_slice:]
            return self._logits(w, x), cache

    def _hidden(self, w: Weights, tokens, embeds, cache, cache_len, mode,
                rows=None, fused: bool = False):
        """Embedding, the layer stack and the final norm (of ``rows``
        alone when given); ``fused`` as :meth:`forward`'s, read by the
        attention layers (zamba2's shared blocks too) and the final norm
        (not by RWKV6's layers and norms, which keep their ops)."""
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
            return self._final_norm(w, x, rows)
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
        # the rotary tables once a forward, every layer's positions
        rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                           cfg.rope_fraction) \
            if cfg.pos_emb == "rope" else None
        x = _act(self._scale_embeddings(x))
        if fused and mode == "decode" and rope is not None and x.is_cuda:
            rope = _row_tables(rope, x.shape[0], S)
        if cfg.family == "hybrid":
            x = self._hybrid(w, x, cache, cache_len, rope, mode, fused)
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
                                          rope=rope, mode=mode,
                                          fused=fused)
                if kind == "local":
                    x, f = self._step(mode, functools.partial(
                        layer, window=W), x)
                else:
                    x, f = self._step(mode, lambda x, f, layer=layer:
                                      layer(x, delta=f), x, f)
                    x = _act(x + f)
        else:
            for stack, k, v, scanned in ((w.first_layers, "k0", "v0", False),
                                         (w.layers, "k", "v", True)):
                for i, p in enumerate(stack):
                    kv = None if cache is None else (cache[k][i],
                                                     cache[v][i])
                    x = _act(self._step(mode, functools.partial(
                        self._dense_layer, p, kv=kv, cache_len=cache_len,
                        rope=rope, mode=mode, scanned=scanned,
                        fused=fused), x))
        return self._final_norm(w, x, rows, fused)

    def _final_norm(self, w: Weights, x, rows=None,
                    fused: bool = False):
        if rows is not None:
            x = x.index_select(1, rows)
        return self._norm(x, w.params["final_norm"], fused=fused)

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
                                        preserve_rng_state=False,
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


def _takes_qkv_launch(fused: bool, h, kv, mode: str, window: int) -> bool:
    """Whether an attention sublayer's qkv pass and cache write are the
    chunk's one launch (:func:`_fused_qkv_write`): ``fused``, a prefill
    or extend chunk, CUDA tensors, a plain cache (not a ring). A mesh
    never gets here fused (``Model.forward`` refuses it)."""
    return fused and kv is not None and mode in ("prefill", "extend") \
        and h.is_cuda and not attn.is_ring(kv[0], window)


def _takes_decode_qkv(fused: bool, h, kv, mode: str, cfg: ModelConfig,
                      rope) -> bool:
    """Whether a one-token step's qkv pass goes through
    ``fusions.qkv_proj`` (:func:`_fused_decode_qkv`): ``fused``, a
    decode step of one token a row, CUDA tensors, and head rows the row
    pass takes (``fusions.takes_row_pass``: gemma2's fp32 Dh 256 does
    not, and keeps the plain spelling). Within it, ``qkv_proj`` picks its
    one launch or the products and the row pass by shape."""
    rot_half = 0 if rope is None else rope[0].shape[-1]
    return fused and kv is not None and mode == "decode" \
        and h.shape[1] == 1 and h.is_cuda \
        and fusions.takes_row_pass(cfg.head_dim, rot_half, h.element_size())


def _fused_decode_qkv(x, wq, wk, wv, *, cache, cache_len, ring: bool,
                      **chain):
    """A one-token step's qkv pass from x (B, 1, d_model) as
    ``fusions.qkv_proj`` (the three products with bias, qk norm and RoPE
    in one launch where its plan takes the shapes, else the products and
    the row pass's kernel), k and v then written into the layer's
    ``cache`` pair at ``cache_len`` as :func:`attention.write_cache` writes
    them (a ring's slot mod its length). Returns (q (B, 1, H, Dh), None,
    None)."""
    B = x.shape[0]
    KV, Dh = wk.shape[1:]
    k, v = (x.new_empty((B, KV, Dh)) for _ in range(2))
    q = fusions.qkv_proj(x, wq, wk, wv, k_out=k, v_out=v, **chain)
    attn.write_cache(cache[0], cache[1], k[:, None], v[:, None], cache_len,
                     ring=ring)
    return q[:, None], None, None


def _row_tables(rope, B: int, S: int):
    """The rotary tables with one row a token, (B, S, rot/2) and
    contiguous, as the qkv launches read them: a host offset's (S,
    rot/2) tables broadcast over the batch, copied once a forward."""
    if rope[0].shape[:-1] == (B, S):
        return rope
    return tuple(t.expand(B, S, t.shape[-1]).contiguous() for t in rope)


def _fused_qkv_write(q, k, v, *, cache, cache_len, rows: bool, **finish):
    """``qkv_finish`` and ``write_cache`` of a prefill or extend chunk's
    projections q (B, C, H, Dh), k and v (B, C, KV, Dh) as one
    ``fusions.qkv_rope_chunk``: k and v written into the layer's
    ``cache`` pair at ``cache_len`` (the forward's int32 device offsets,
    made once a forward: one graph replays every start). Returns (q, k,
    v) as (B, C, heads, Dh); k and v (the chunk's rows, which a prefill's
    attention reads) only with ``rows``, else None."""
    B, C, H, Dh = q.shape
    KV = k.shape[2]
    kr = vr = None
    if rows:
        kr, vr = (t.new_empty((B * C, KV, Dh)) for t in (k, v))
    qo = fusions.qkv_rope_chunk(
        q.reshape(B * C, H, Dh), k.reshape(B * C, KV, Dh),
        v.reshape(B * C, KV, Dh), cache_k=cache[0], cache_v=cache[1],
        offsets=attn._extend_offsets(cache_len, B, q.device), k_rows=kr,
        v_rows=vr, **finish)
    if not rows:
        return qo.view(B, C, H, Dh), None, None
    return (qo.view(B, C, H, Dh), kr.view(B, C, KV, Dh),
            vr.view(B, C, KV, Dh))


def ffn_apply(p: dict, h: torch.Tensor, cfg: ModelConfig,
              gate_up=None) -> torch.Tensor:
    """A layer's FFN: MoE where its params hold a router, else the dense
    gated MLP (the reference's ``"router" in p["mlp"]``), its gated
    product by ``gate_up`` when given (``mlp_apply``)."""
    if "router" in p:
        return moe_apply(p, h, cfg)
    return mlp_apply(p, h, cfg.activation, gate_up)
