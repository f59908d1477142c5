"""Step builders: the train, prefill and decode steps of a (cfg, shape), the
port of the JAX package's ``models/steps.py``. They are what the trainer
runs and what the step counter (:mod:`repro_torch.dist.roofline`) counts.

A built step is plain callables over a :class:`Model` that holds the
weights: no jit, no shardings. One device has no mesh: ``mesh`` stays in
each signature and must be None (the multi-device steps come with ROADMAP
queue 1 item 14). ``input_specs(cfg, shape)`` gives each input's shape and
dtype, the counterpart of the reference's ``ShapeDtypeStruct`` stand-ins.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.common import torch_dtype
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt_mod


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "the port's steps run on one device: a mesh (sharded steps) "
            "comes with ROADMAP queue 1 item 14")


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


def _zeros(spec: tuple, device) -> torch.Tensor:
    """Zeros of an input spec; token ids as int64, torch's index dtype."""
    shape, dtype = spec
    dt = torch.int64 if dtype == "int32" else torch_dtype(dtype)
    return torch.zeros(shape, dtype=dt, device=device)


def build_train_step(cfg: ModelConfig, mesh, shape: ShapeSpec,
                     adamw: opt_mod.AdamWConfig | None = None,
                     microbatches: int = 0, *, model: Model | None = None,
                     device="cuda", seed: int = 0) -> BuiltStep:
    """``fn(opt_state, tokens, labels) -> {"loss", "grad_norm", "lr"}``:
    the loss and its grads, then one AdamW step on ``model``'s fp32
    masters and ``opt_state``, both in place. ``model``: a trainable
    model (default: one drawn from ``seed`` on ``device``).
    ``cfg.train_microbatches`` (or ``microbatches``) > 1 splits the batch
    and accumulates the grads in fp32, as the reference's scan does."""
    _no_mesh(mesh)
    microbatches = microbatches or cfg.train_microbatches
    model = model if model is not None else Model(
        cfg, device=device, seed=seed, trainable=True)
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
        return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                               for k, p, g in zip(names, leaves, grads)}

    def train_step(opt_state, tokens, labels):
        tokens = torch.as_tensor(tokens, device=model.device).long()
        labels = torch.as_tensor(labels, device=model.device).long()
        if microbatches > 1:
            mb = tokens.shape[0] // microbatches
            loss = 0.0
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in zip(names, leaves)}
            for i in range(microbatches):
                part = slice(i * mb, (i + 1) * mb)
                l_i, g_i = grads_of(tokens[part], labels[part])
                loss = loss + l_i
                for k, g in g_i.items():
                    grads[k] += g
                del g_i
            loss = loss / microbatches
            for g in grads.values():
                g /= microbatches
        else:
            loss, grads = grads_of(tokens, labels)
        _, _, metrics = opt_mod.apply_updates(model.params, grads, opt_state,
                                              adamw)
        return {"loss": loss, **metrics}

    def make_inputs():
        specs = input_specs(cfg, shape)
        return (opt_mod.init_state(model.params, adamw),
                _zeros(specs["tokens"], model.device),
                _zeros(specs["labels"], model.device))

    return BuiltStep(train_step, model, make_inputs)


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                       model: Model | None = None, device="cuda",
                       seed: int = 0) -> BuiltStep:
    """``fn(cache, inputs) -> (next token (B,) int32, cache)``: the whole
    prompt (tokens, or embeddings for audio/VLM) through ``Model.forward``
    into a fresh dense cache of ``shape.seq_len`` positions."""
    _no_mesh(mesh)
    model = model if model is not None else Model(cfg, device=device,
                                                  seed=seed)
    B, S = shape.global_batch, shape.seq_len
    embeds_in = uses_embeds(cfg)

    def prefill_step(cache, inputs):
        logits, cache = model.forward(
            tokens=None if embeds_in else inputs,
            embeds=inputs if embeds_in else None, cache=cache, cache_len=0,
            mode="prefill", logits_slice=1)
        return logits[:, -1].argmax(-1).to(torch.int32), cache

    def make_inputs():
        (spec,) = input_specs(cfg, shape).values()
        return model.init_cache(B, S), _zeros(spec, model.device)

    return BuiltStep(prefill_step, model, make_inputs)


def build_decode_step(cfg: ModelConfig, mesh, shape: ShapeSpec, *,
                      model: Model | None = None, device="cuda",
                      seed: int = 0) -> BuiltStep:
    """``fn(cache, tokens, cache_len) -> (next token (B,) int32, cache)``:
    one new token a row against a dense cache of ``shape.seq_len``
    positions. The inputs put every row at the cache's last position, with
    ``cache_len`` on the host (the port reads cache offsets there)."""
    _no_mesh(mesh)
    model = model if model is not None else Model(cfg, device=device,
                                                  seed=seed)
    B, S = shape.global_batch, shape.seq_len

    def decode_step(cache, tokens, cache_len):
        logits, cache = model.forward(tokens=tokens, cache=cache,
                                      cache_len=cache_len, mode="decode",
                                      logits_slice=1)
        return logits[:, -1].argmax(-1).to(torch.int32), cache

    def make_inputs():
        specs = input_specs(cfg, shape)
        return (model.init_cache(B, S), _zeros(specs["tokens"], model.device),
                torch.full((B,), S - 1, dtype=torch.int32))

    return BuiltStep(decode_step, model, make_inputs)


def build_step(cfg: ModelConfig, mesh, shape: ShapeSpec, **kw) -> BuiltStep:
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_decode_step(cfg, mesh, shape, **kw)
