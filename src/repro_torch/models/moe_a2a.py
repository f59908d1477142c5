"""Explicit all-to-all expert parallelism (``MoEConfig.sharding_mode =
"ep_a2a"``): the port of the JAX package's ``models/moe_a2a.py``.

The grouped path (:mod:`repro_torch.models.moe`) places the expert batches
on the experts' axis and lets DTensor move them. This path writes the
canonical EP schedule by hand on each rank's local pieces:

    per shard: route -> sort-based local plan -> all_to_all (send each
    expert shard its token slabs) -> local expert FFNs -> all_to_all back
    -> local combine.

Wire bytes per device: 2 x T_local * k * cf * D (dispatch and return),
the EP minimum. The trade: a fixed per-(shard pair) capacity ``C_pair =
_capacity(T_local)``, so imbalance drops more tokens than one global
capacity would (with a single EP shard the two are the same plan).
The all-to-alls are functional collectives with autograd
(``all_to_all_single_autograd``): NCCL's all-to-all on the cards, gloo's
on the CPU, the fake group's in the dry run.
"""
from __future__ import annotations

import torch
from torch.distributed._functional_collectives import (
    all_to_all_single_autograd)
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import (distribute, logical_to_spec,
                                       mesh_axis_names, placements, to_local)
from repro_torch.models.common import torch_dtype
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.moe import (_capacity, _combine, _dispatch_plan,
                                    _experts, route)


def moe_apply_a2a(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh,
                  expert_axis: str = "model",
                  batch_axes=("data",)) -> DTensor:
    """x (B, S, D) (a DTensor, or a tensor every rank holds whole) ->
    (B, S, D) placed on ``batch_axes``. Requires E % mesh[expert_axis] ==
    0; the router is read whole on every rank."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    names = mesh_axis_names(mesh)
    n_ep = mesh.size(names.index(expert_axis))
    E_loc = E // n_ep
    cd = torch_dtype(cfg.compute_dtype)
    group = mesh.get_group(expert_axis)

    rows = placements(logical_to_spec(("b", None, None),
                                      {"b": tuple(batch_axes) or None},
                                      shape=x.shape, mesh=mesh), mesh)
    if not isinstance(x, DTensor):
        x = distribute(x, mesh, [Replicate()] * mesh.ndim)
    x = x.redistribute(mesh, rows)
    whole = [Replicate()] * mesh.ndim
    experts = [Shard(0) if n == expert_axis and n_ep > 1 else Replicate()
               for n in names]
    router = to_local(p["router"].redistribute(mesh, whole)
                      if isinstance(p["router"], DTensor) else
                      distribute(p["router"], mesh, whole), rows)
    ws = [to_local((p[w] if isinstance(p[w], DTensor) else
                    distribute(p[w], mesh, whole)).redistribute(mesh,
                                                                experts),
                   rows).to(cd) for w in ("w1", "w3", "w2")]

    xl = to_local(x, rows)
    Bl = xl.shape[0]
    T = Bl * S
    xt = xl.reshape(T, D)
    probs, ids = route({"router": router}, xt, cfg)
    # the local plan against ALL experts; C_pair is this shard's capacity
    # an expert (the global one is n_ep * C_pair, the grouped path's)
    C_pair = _capacity(T, cfg)
    src, dest = _dispatch_plan(ids.reshape(-1), E, C_pair)
    tok = torch.where(src >= T * k, T, src // k)
    send = torch.cat([xt, xt.new_zeros(1, D)])[tok]          # (E*C_pair, D)
    # slab j (rows for expert shard j's experts) goes to rank j
    recv = all_to_all_single_autograd(send.contiguous(), None, None, group)
    xe = recv.reshape(n_ep, E_loc, C_pair, D).transpose(0, 1) \
        .reshape(E_loc, n_ep * C_pair, D).to(cd)
    ye = _experts(xe, *ws, cfg.activation).to(cd)
    back = ye.reshape(E_loc, n_ep, C_pair, D).transpose(0, 1) \
        .reshape(n_ep * E_loc * C_pair, D)
    ret = all_to_all_single_autograd(back.contiguous(), None, None, group)
    out = _combine(ret, dest, probs, k).reshape(Bl, S, D)
    out = DTensor.from_local(out, mesh, rows, run_check=False)
    if m.num_shared_experts:
        out = out + mlp_apply(p["shared"], x.to(cd), cfg.activation)
    return out
