"""Mixture-of-Experts FFN with static-capacity (GShard-style) dispatch: the
PyTorch port of ``repro.models.moe``.

Each expert takes at most ``C`` token-copies a group (:func:`_capacity`);
copies past it are dropped, as in the reference, so a chunk's padding
tokens take part in routing and capacity too. The dispatch plan is
sort-based (one stable argsort, a searchsorted of the expert bounds, the
rank of each copy within its expert), index work in 1-D only; rows reach
the ``(E, C, D)`` expert batches by gathers through an appended zero row,
and the three expert products are batched matmuls over all ``E`` experts
every call, as the reference's einsums are (an empty expert is not
skipped).

One device holds every expert, so there is no mesh and a chunk's tokens
are one dispatch group: every ``sharding_mode`` takes the grouped path
with one group, as the reference does without a mesh (its ``G`` axis, the
mesh's data shards, comes back with the multi-device path, ROADMAP queue
1 item 14, beside ``moe_apply_a2a``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, activation_fn
from repro_torch.models.mlp import mlp_apply, mlp_specs

#: a group of more tokens than this is dispatched in sub-chunks, which
#: bounds the (E*C, D) dispatch buffers (a 32k-token prefill would hold
#: ~5 GB a layer)
MAX_GROUP_TOKENS = 8192


def moe_specs(cfg: ModelConfig, dtype: str) -> dict[str, ParamSpec]:
    """Flat {name: ParamSpec} of one MoE layer: the ``router`` (D, E), the
    stacked experts ``w1``/``w3`` (E, D, F) and ``w2`` (E, F, D), and
    ``shared.*``, a dense FFN of width ``F * num_shared_experts``, where
    the config has shared experts.

    The router is cast to the compute dtype with the other leaves. The
    reference declares it ``keep_dtype``, but its ``Model.specs()`` stacks
    the layer specs without that flag (``_stack_specs``), so its forward
    casts the router too, and its router product runs in fp32 on the
    rounded weights (ROADMAP R6). The port computes what it computes."""
    m = cfg.moe
    D, F, E = cfg.d_model, m.d_ff_expert, m.num_experts
    specs = {
        "router": ParamSpec((D, E), dtype="float32"),
        "w1": ParamSpec((E, D, F), dtype=dtype),
        "w3": ParamSpec((E, D, F), dtype=dtype),
        "w2": ParamSpec((E, F, D), dtype=dtype),
    }
    if m.num_shared_experts:
        specs.update({f"shared.{k}": s for k, s in
                      mlp_specs(D, F * m.num_shared_experts, dtype).items()})
    return specs


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert a group: ``tokens * top_k * capacity_factor / E``
    truncated, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(tokens * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, (c + 7) // 8 * 8)


def route(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (T, D) -> (probs (T, k) fp32, expert ids (T, k)): the router
    product in fp32 (the router read in fp32 whatever its dtype), the top
    k logits in ``lax.top_k``'s order (largest first, ties to the lower
    id: a stable descending sort), and a softmax over those k alone (the
    Qwen3 / Mixtral convention)."""
    logits = x.float() @ p["router"].float()
    top_logits, ids = torch.sort(logits, dim=-1, descending=True,
                                 stable=True)
    k = cfg.moe.top_k
    return torch.softmax(top_logits[:, :k], dim=-1), ids[:, :k]


def _dispatch_plan(flat_ids: torch.Tensor, E: int, C: int):
    """Sort-based dispatch plan for one group. ``flat_ids`` (N,): the
    expert of each token-copy. Returns ``src`` (E*C,), the copy each
    expert slot takes (``N``: an empty slot), and ``dest`` (N,), the slot
    each copy lands in (``E*C``: dropped, the expert was full). Within an
    expert, copies keep their order (a stable sort), so the first ``C``
    copies an expert receives are the ones it keeps."""
    N = flat_ids.shape[0]
    dev = flat_ids.device
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    bounds = torch.searchsorted(
        sorted_ids, torch.arange(E + 1, device=dev, dtype=sorted_ids.dtype),
        side="left")
    pos_sorted = torch.arange(N, device=dev) - bounds[sorted_ids]
    dest_sorted = torch.where(pos_sorted < C, sorted_ids * C + pos_sorted,
                              E * C)
    inv = torch.empty_like(order)                # copy -> sorted position
    inv[order] = torch.arange(N, device=dev)
    dest = dest_sorted[inv]

    slots = torch.arange(E * C, device=dev)
    e, c = slots // C, slots % C
    counts = bounds[1:] - bounds[:-1]
    sorted_pos = (bounds[:-1][e] + c).clamp(0, N - 1)
    src = torch.where(c < counts[e], order[sorted_pos], N)
    return src, dest


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D). One dispatch group; a group of more than
    ``MAX_GROUP_TOKENS`` tokens (and an even count) is split in halves
    until it fits or turns odd, and the sub-chunks are dispatched one
    after the other, each with its own capacity."""
    B, S, D = x.shape
    T = B * S
    n_sub = 1
    while T // n_sub > MAX_GROUP_TOKENS and (T // n_sub) % 2 == 0:
        n_sub *= 2
    ys = [_moe_group(p, xc, cfg) for xc in x.reshape(n_sub, T // n_sub, D)]
    return torch.cat(ys).reshape(B, S, D)


def _moe_group(p: dict, xt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xt (T, D) -> (T, D): one group's dispatch, experts and combine."""
    m = cfg.moe
    T, D = xt.shape
    E, k = m.num_experts, m.top_k
    C = _capacity(T, cfg)
    probs, ids = route(p, xt, cfg)
    src, dest = _dispatch_plan(ids.reshape(T * k), E, C)

    # gather rows into expert batches (E, C, D); copy n comes from token
    # n // k, and an empty slot reads the appended zero row
    zero = xt.new_zeros(1, D)
    tok = torch.where(src >= T * k, T, src // k)
    xe = torch.cat([xt, zero])[tok].reshape(E, C, D)

    act = activation_fn(cfg.activation)
    h = act(torch.bmm(xe, p["w1"])) * torch.bmm(xe, p["w3"])
    ye = torch.bmm(h, p["w2"])

    # combine: each copy gathers its slot's row (a dropped copy the zero
    # row) and weighs it by its probability rounded to ye's dtype; the
    # products and their sum over k stay in fp32 and are rounded once, as
    # XLA computes them in the reference's jitted layer (ROADMAP P2)
    rows = torch.cat([ye.reshape(E * C, D), zero])[dest].reshape(T, k, D)
    weights = probs[..., None].to(ye.dtype).float()
    out = (rows.float() * weights).sum(1).to(ye.dtype)
    if m.num_shared_experts:
        out = out + mlp_apply(p["shared"], xt, cfg.activation)
    return out.to(xt.dtype)


def aux_load_balance_loss(p: dict, x: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (the reference's, used in
    training examples): E * sum over experts of the share of tokens whose
    top expert it is times its mean router probability."""
    m = cfg.moe
    logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.argmax(logits, dim=-1)          # ties to the lower id
    frac = torch.nn.functional.one_hot(top, m.num_experts).float().mean(0)
    return m.num_experts * torch.sum(frac * probs.mean(0))
