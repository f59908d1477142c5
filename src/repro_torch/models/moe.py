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

On one device a chunk's tokens are one dispatch group: every
``sharding_mode`` takes the grouped path with one group, as the reference
does without a mesh. On a mesh the groups are the data shards
(``_num_groups``, the reference's ``G`` axis), the experts are split over
"model", and ``sharding_mode="ep_a2a"`` takes the explicit all-to-all
path (:mod:`repro_torch.models.moe_a2a`).
"""
from __future__ import annotations

import torch

from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (constrain, current_rules, from_local,
                                       mesh_axis_names, mesh_axis_sizes,
                                       place, to_local)
from repro_torch.models.common import ParamSpec, activation_fn, torch_dtype
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
        "router": ParamSpec((D, E), ("embed", "experts_router"),
                            dtype="float32"),
        "w1": ParamSpec((E, D, F), ("experts", "embed", "moe_mlp"),
                        dtype=dtype),
        "w3": ParamSpec((E, D, F), ("experts", "embed", "moe_mlp"),
                        dtype=dtype),
        "w2": ParamSpec((E, F, D), ("experts", "moe_mlp", "embed"),
                        dtype=dtype),
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


def _num_groups(T: int) -> int:
    """Dispatch groups = the size of the data axes (GShard "groups"): each
    data shard dispatches its own tokens with a *local* capacity, so the
    plan stays shard-local. 1 without a mesh, as on one device."""
    rules = current_rules()
    if not rules or rules.get("__mesh__") is None:
        return 1
    ax = rules.get("act_batch")
    if ax is None:
        return 1
    sizes = mesh_axis_sizes(rules["__mesh__"])
    g = 1
    for a in (ax if isinstance(ax, (tuple, list)) else (ax,)):
        g *= sizes[a]
    return g if g > 1 and T % g == 0 else 1


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D). G dispatch groups (:func:`_num_groups`,
    one on one device), each of T / G tokens; a group of more than
    ``MAX_GROUP_TOKENS`` tokens (and an even count) is split in halves
    until it fits or turns odd, and the sub-chunks are dispatched one
    after the other, each with its own capacity. On a mesh with
    ``sharding_mode="ep_a2a"`` (and the experts dividing the model axis)
    the explicit all-to-all path runs instead
    (:func:`repro_torch.models.moe_a2a.moe_apply_a2a`)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    if m.sharding_mode == "ep_a2a":
        rules = current_rules() or {}
        mesh = rules.get("__mesh__")
        if mesh is not None and "model" in mesh_axis_names(mesh) and \
                m.num_experts % mesh_axis_sizes(mesh)["model"] == 0:
            from repro_torch.models.moe_a2a import moe_apply_a2a
            ax = rules.get("act_batch") or ()
            axes = tuple(ax) if isinstance(ax, (tuple, list)) else (ax,)
            return moe_apply_a2a(p, x, cfg, mesh, expert_axis="model",
                                 batch_axes=axes)
    G = _num_groups(T)
    Tg = T // G
    n_sub = 1
    while Tg // n_sub > MAX_GROUP_TOKENS and (Tg // n_sub) % 2 == 0:
        n_sub *= 2
    if not isinstance(x, DTensor):
        ys = [_moe_group(p, xc, cfg)
              for xc in x.reshape(n_sub, T // n_sub, D)]
        return torch.cat(ys).reshape(B, S, D)
    xs = x.reshape(G, n_sub, Tg // n_sub, D)
    ys = torch.stack([_moe_group_sharded(p, xs[:, i], cfg)
                      for i in range(n_sub)], dim=1)
    # the groups back on x's batch shards only: a group split finer than
    # the rows (G ranks, fewer rows) has no placement on (B, S, D)
    ys = ys.redistribute(ys.device_mesh, [
        py if px.is_shard(0) else Replicate()
        for py, px in zip(ys.placements, x.placements)])
    return ys.reshape(B, S, D)


def _dispatch(p: dict, xt: torch.Tensor, cfg: ModelConfig, C: int):
    """One group's routing and plan, and its rows gathered into expert
    batches: (probs (T, k), dest (T*k,), rows (E*C, D)). Copy n comes
    from token n // k; an empty slot reads the appended zero row."""
    T, D = xt.shape
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    probs, ids = route(p, xt, cfg)
    src, dest = _dispatch_plan(ids.reshape(T * k), E, C)
    tok = torch.where(src >= T * k, T, src // k)
    return probs, dest, torch.cat([xt, xt.new_zeros(1, D)])[tok]


def _combine(rows: torch.Tensor, dest: torch.Tensor, probs: torch.Tensor,
             k: int) -> torch.Tensor:
    """Each copy gathers its slot's row of ``rows`` (E*C, D) (a dropped
    copy the zero row) and weighs it by its probability rounded to the
    rows' dtype; the products and their sum over k stay in fp32 and are
    rounded once, as XLA computes them in the reference's jitted layer
    (ROADMAP P2). Returns (T, D)."""
    D = rows.shape[-1]
    T = dest.shape[0] // k
    got = torch.cat([rows, rows.new_zeros(1, D)])[dest].reshape(T, k, D)
    weights = probs[..., None].to(rows.dtype).float()
    return (got.float() * weights).sum(1).to(rows.dtype)


def _experts(xe, w1, w3, w2, activation: str) -> torch.Tensor:
    """The expert FFNs, batched over experts: xe (E, C, D) -> (E, C, D)."""
    act = activation_fn(activation)
    h = act(torch.bmm(xe, w1)) * torch.bmm(xe, w3)
    return torch.bmm(h, w2)


def _moe_group(p: dict, xt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xt (T, D) -> (T, D): one group's dispatch, experts and combine."""
    m = cfg.moe
    T, D = xt.shape
    E, C = m.num_experts, _capacity(T, cfg)
    probs, dest, rows = _dispatch(p, xt, cfg, C)
    ye = _experts(rows.reshape(E, C, D), p["w1"], p["w3"], p["w2"],
                  cfg.activation)
    out = _combine(ye.reshape(E * C, D), dest, probs, m.top_k)
    if m.num_shared_experts:
        out = out + mlp_apply(p["shared"], xt, cfg.activation)
    return out.to(xt.dtype)


def _moe_group_sharded(p: dict, xt: DTensor,
                       cfg: ModelConfig) -> DTensor:
    """xt (G, Tg, D) on a mesh -> (G, Tg, D), the reference's grouped layer
    and its constrain sites: each data shard routes and plans its own
    groups (local index work), the (G, E*C, D) expert batches are placed
    on the experts' axis and exchanged G -> E (the EP exchange), each
    rank runs its experts, and the rows go back E -> G for a local
    combine."""
    m = cfg.moe
    G, Tg, D = xt.shape
    E, C = m.num_experts, _capacity(Tg, cfg)
    cd = torch_dtype(cfg.compute_dtype)
    xt = place(xt, "act_batch", None, None)
    router = to_local(place(p["router"], None, None), xt.placements)
    plans = [_dispatch({"router": router}, xg, cfg, C)
             for xg in to_local(xt, xt.placements)]
    buf = from_local(torch.stack([rows for _, _, rows in plans]), xt)
    buf = constrain(buf, "act_batch", "experts", None)
    # (G, E, C, D) -> (E, G*C, D): the G -> E transpose is the exchange,
    # kept in the compute dtype
    xe = buf.reshape(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    xe = place(xe.to(cd), "experts", "moe_capacity", None)
    # each rank runs its experts on its slice of their hidden dim where
    # "moe_mlp" splits it (expert-FSDP): a partial sum over those ranks
    w13 = [place(p[w].to(cd), "experts", None, "moe_mlp") for w in ("w1",
                                                                   "w3")]
    w2 = place(p["w2"].to(cd), "experts", "moe_mlp", None)
    out = [Partial() if pw.is_shard(2) else px
           for px, pw in zip(xe.placements, w13[0].placements)]
    yl = _experts(to_local(xe, out), *(to_local(w, out) for w in w13),
                  to_local(w2, out), cfg.activation).to(cd)
    ye = DTensor.from_local(yl, xe.device_mesh, out, run_check=False)
    ye = constrain(ye, "experts", "moe_capacity", None)
    yb = ye.reshape(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    yb = place(yb, "act_batch", None, None)
    out = from_local(torch.stack([
        _combine(rows, dest, probs, m.top_k) for (probs, dest, _), rows
        in zip(plans, to_local(yb, xt.placements))]), xt)
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
