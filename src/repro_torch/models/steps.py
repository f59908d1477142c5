"""Step builders: the train, prefill and decode steps of a (cfg, mesh,
shape), the port of the JAX package's ``models/steps.py``. They are what
the trainer runs, what the step counter (:mod:`repro_torch.dist.roofline`)
counts and what the dry run (:mod:`repro_torch.launch.dryrun`) builds.

A built step is plain callables over a :class:`Model` that holds the
weights: no jit. ``mesh=None`` is one device. With a ``DeviceMesh`` the
step takes ``default_rules(cfg, mesh, kind)`` (or ``rules``): the model's
weights are DTensors placed by their logical axes, the caches by
:meth:`Model.cache_logical_axes` (:func:`cache_shardings`), the batch
inputs on "act_batch", and the step runs under those rules, as the
reference's ``in_shardings`` and ``axis_rules`` place them.
``input_specs(cfg, shape)`` gives each input's shape and dtype, the
counterpart of the reference's ``ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.dist.sharding import (axis_rules, default_rules, distribute,
                                       full, local_offset, logical_to_spec,
                                       place, placements, placements_of)
from repro_torch.models.common import torch_dtype
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt_mod


def _rules(cfg: ModelConfig, mesh, kind: str, rules: dict | None):
    """The step's rules: None on one device, else ``rules`` or the
    mesh's defaults for ``kind``."""
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch DeviceMesh "
                        f"(launch/mesh.py), not {type(mesh).__name__}")
    return rules or default_rules(cfg, mesh, step_kind=kind)


def _model(cfg: ModelConfig, model: Model | None, mesh, rules, *, device,
           seed: int, trainable: bool = False) -> Model:
    """The step's model: ``model`` (placed on ``mesh`` if it is not there
    yet), or one drawn from ``seed``."""
    if model is None:
        return Model(cfg, device=device, seed=seed, trainable=trainable,
                     mesh=mesh, rules=rules)
    if mesh is not None and model.mesh is not mesh:
        return model.sharded(mesh, rules)
    return model


def _context(rules: dict | None):
    """The step's rules, installed while it runs (none on one device)."""
    return contextlib.nullcontext() if rules is None else axis_rules(rules)


def _batch(x, rules: dict | None):
    """An input placed on "act_batch" (its other dims replicated)."""
    if rules is None or isinstance(x, DTensor):
        return x
    return distribute(x, rules["__mesh__"], placements_of(
        ("act_batch",) + (None,) * (x.ndim - 1), rules, x.shape))


def cache_shardings(model: Model, mesh, rules: dict, batch: int,
                    max_len: int) -> dict:
    """The placements of each cache leaf (the reference's
    ``cache_shardings``)."""
    axes = model.cache_logical_axes()
    return {k: placements(logical_to_spec(axes[k], rules, shape=shape,
                                          mesh=mesh), mesh)
            for k, (shape, _) in model.cache_shapes(batch, max_len).items()}


def _placed_cache(cache: dict, model: Model, rules: dict | None) -> dict:
    """The cache on the step's placements (a cache from another step kind
    is redistributed, a copy; one already placed is written in place)."""
    if rules is None:
        return cache
    mesh = rules["__mesh__"]
    want = cache_shardings(model, mesh, rules, *_cache_dims(model, cache))
    return {k: v if tuple(v.placements) == want[k]
            else v.redistribute(mesh, want[k]) for k, v in cache.items()}


def _cache_dims(model: Model, cache: dict) -> tuple[int, int]:
    """(batch, max_len) of a cache."""
    cfg = model.cfg
    if cfg.family == "ssm":
        return cache["wkv"].shape[1], 0
    key = "shared_k" if cfg.family == "hybrid" else \
        "k_global" if cfg.local_global_alternating else "k"
    return cache[key].shape[1], cache[key].shape[2]


def _next_tokens(last) -> torch.Tensor:
    """The greedy next tokens (B,) int32 of the last position's logits (B,
    V), whole on every rank. On a mesh each rank takes its vocab piece's
    largest logit and its index, and the ranks that split the vocab keep
    the first largest (the lowest index, ``argmax``'s rule): the values
    and indices move, never the (B, V) logits."""
    if not isinstance(last, DTensor):
        return last.argmax(-1).to(torch.int32)
    from torch.distributed._functional_collectives import all_gather_tensor
    last = place(last, "act_batch", "vocab")
    ll = last.to_local()
    names = last.device_mesh.mesh_dim_names
    split = [i for i, pl in enumerate(last.placements) if pl.is_shard(1)]
    if not split:
        idx = ll.argmax(-1)
    else:
        val, idx = ll.max(-1)
        idx = idx + local_offset(last)[1]
        for i in reversed(split):        # minor to major, as they split V
            group = last.device_mesh.get_group(names[i])
            vals = all_gather_tensor(val, 0, group).view(-1, *val.shape)
            idxs = all_gather_tensor(idx, 0, group).view(-1, *idx.shape)
            best = vals.argmax(0, keepdim=True)
            val = vals.gather(0, best)[0]
            idx = idxs.gather(0, best)[0]
    rows = [pl if pl.is_shard(0) else Replicate() for pl in last.placements]
    return DTensor.from_local(idx.to(torch.int32), last.device_mesh, rows,
                              run_check=False).full_tensor()


def uses_embeds(cfg: ModelConfig) -> bool:
    """Audio/VLM archs take precomputed frontend embeddings for prefill."""
    return cfg.family in ("audio", "vlm")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """{input name: (shape, dtype name)} of a step's data inputs."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": ((B, S), "int32"), "labels": ((B, S), "int32")}
    if shape.kind == "prefill":
        if uses_embeds(cfg):
            return {"embeds": ((B, S, cfg.d_model), cfg.compute_dtype)}
        return {"tokens": ((B, S), "int32")}
    # decode: one new token against a cache of length S
    return {"tokens": ((B, 1), "int32"), "cache_len": ((B,), "int32")}


@dataclasses.dataclass
class BuiltStep:
    """``fn(*make_inputs())`` runs the step once; ``model`` holds the
    weights the step reads (and, for a train step, updates in place)."""
    fn: Callable
    model: Model
    make_inputs: Callable[[], tuple]
    rules: dict | None = None       # the step's rules on a mesh


def _zeros(spec: tuple, device) -> torch.Tensor:
    """Zeros of an input spec; token ids as int64, torch's index dtype."""
    shape, dtype = spec
    dt = torch.int64 if dtype == "int32" else torch_dtype(dtype)
    return torch.zeros(shape, dtype=dt, device=device)


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeSpec,
                     adamw: opt_mod.AdamWConfig | None = None,
                     microbatches: int = 0, *, rules: dict | None = None,
                     model: Model | None = None, device="cuda",
                     seed: int = 0) -> BuiltStep:
    """``fn(opt_state, tokens, labels) -> {"loss", "grad_norm", "lr"}``:
    the loss and its grads, then one AdamW step on ``model``'s fp32
    masters and ``opt_state``, both in place. ``model``: a trainable
    model (default: one drawn from ``seed`` on ``device``).
    ``cfg.train_microbatches`` (or ``microbatches``) > 1 splits the batch
    and accumulates the grads in fp32, as the reference's scan does. On a
    mesh each grad is reduced onto its master's placement (a sum over
    the ranks that hold it whole, a reduce-scatter where it is sharded)
    and the moments share the masters' placements."""
    microbatches = microbatches or cfg.train_microbatches
    rules = _rules(cfg, mesh, "train", rules)
    model = _model(cfg, model, mesh, rules, device=device, seed=seed,
                   trainable=True)
    if not model.trainable:
        raise ValueError("build_train_step needs a trainable Model")
    if shape.global_batch % microbatches:
        raise ValueError(f"batch {shape.global_batch} does not split into "
                         f"{microbatches} microbatches")
    adamw = adamw or opt_mod.AdamWConfig(state_dtype=cfg.opt_state_dtype)
    names = list(model.params)
    leaves = [model.params[k] for k in names]

    def grads_of(tokens, labels):
        loss = model.loss(tokens, labels)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), {k: torch.zeros_like(p) if g is None else
                               _like(g, p)
                               for k, p, g in zip(names, leaves, grads)}

    def train_step(opt_state, tokens, labels):
        with _context(rules):
            tokens = torch.as_tensor(tokens, device=model.device).long()
            labels = torch.as_tensor(labels, device=model.device).long()
            if microbatches > 1:
                mb = tokens.shape[0] // microbatches
                loss = 0.0
                grads = {k: torch.zeros_like(p, dtype=torch.float32)
                         for k, p in zip(names, leaves)}
                for i in range(microbatches):
                    # each microbatch placed on "act_batch" by itself
                    part = slice(i * mb, (i + 1) * mb)
                    l_i, g_i = grads_of(_batch(tokens[part], rules),
                                        _batch(labels[part], rules))
                    loss = loss + l_i
                    for k, g in g_i.items():
                        grads[k] += g
                    del g_i
                loss = loss / microbatches
                for g in grads.values():
                    g /= microbatches
            else:
                loss, grads = grads_of(_batch(tokens, rules),
                                       _batch(labels, rules))
            _, _, metrics = opt_mod.apply_updates(model.params, grads,
                                                  opt_state, adamw)
            return {"loss": full(loss), **metrics}

    def make_inputs():
        specs = input_specs(cfg, shape)
        return (opt_mod.init_state(model.params, adamw),
                _zeros(specs["tokens"], model.device),
                _zeros(specs["labels"], model.device))

    return BuiltStep(train_step, model, make_inputs, rules)


def _like(g, p):
    """A grad on its parameter's placement."""
    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                       rules: dict | None = None, model: Model | None = None,
                       device="cuda", seed: int = 0) -> BuiltStep:
    """``fn(cache, inputs) -> (next token (B,) int32, cache)``: the whole
    prompt (tokens, or embeddings for audio/VLM) through ``Model.forward``
    into a fresh dense cache of ``shape.seq_len`` positions
    (``logits=True``: the last position's fp32 logits too). On a mesh the
    next tokens and logits come back whole and the cache as DTensors."""
    rules = _rules(cfg, mesh, "prefill", rules)
    model = _model(cfg, model, mesh, rules, device=device, seed=seed)
    B, S = shape.global_batch, shape.seq_len
    embeds_in = uses_embeds(cfg)

    def prefill_step(cache, inputs, logits: bool = False):
        with _context(rules):
            cache = _placed_cache(cache, model, rules)
            inputs = _batch(inputs, rules)
            out, cache = model.forward(
                tokens=None if embeds_in else inputs,
                embeds=inputs if embeds_in else None, cache=cache,
                cache_len=0, mode="prefill", logits_slice=1)
            nxt = _next_tokens(out[:, -1])
            return (nxt, cache, full(out)) if logits else (nxt, cache)

    def make_inputs():
        (spec,) = input_specs(cfg, shape).values()
        return model.init_cache(B, S, rules), _zeros(spec, model.device)

    return BuiltStep(prefill_step, model, make_inputs, rules)


def build_decode_step(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                      rules: dict | None = None, model: Model | None = None,
                      device="cuda", seed: int = 0) -> BuiltStep:
    """``fn(cache, tokens, cache_len) -> (next token (B,) int32, cache)``:
    one new token a row against a dense cache of ``shape.seq_len``
    positions. The inputs put every row at the cache's last position, with
    ``cache_len`` on the host (the port reads cache offsets there);
    ``logits=True`` returns the fp32 logits too. On a
    mesh a batch under 8 takes the long-decode rules (the cache spread
    over its sequence), as the reference does; a cache placed by another
    step is redistributed to them."""
    rules = _rules(cfg, mesh, "decode_long" if shape.global_batch < 8
                   else "decode", rules)
    model = _model(cfg, model, mesh, rules, device=device, seed=seed)
    B, S = shape.global_batch, shape.seq_len

    def decode_step(cache, tokens, cache_len, logits: bool = False):
        with _context(rules):
            cache = _placed_cache(cache, model, rules)
            out, cache = model.forward(tokens=_batch(tokens, rules),
                                       cache=cache, cache_len=cache_len,
                                       mode="decode", logits_slice=1)
            nxt = _next_tokens(out[:, -1])
            return (nxt, cache, full(out)) if logits else (nxt, cache)

    def make_inputs():
        specs = input_specs(cfg, shape)
        return (model.init_cache(B, S, rules),
                _zeros(specs["tokens"], model.device),
                torch.full((B,), S - 1, dtype=torch.int32))

    return BuiltStep(decode_step, model, make_inputs, rules)


def build_step(cfg: ModelConfig, mesh, shape: ShapeSpec, **kw) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_decode_step(cfg, mesh, shape, **kw)
