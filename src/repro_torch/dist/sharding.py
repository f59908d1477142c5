"""Logical-axis sharding rules on DTensor: the port of the JAX package's
``dist/sharding.py``.

Model code names tensor dimensions with *logical* axes ("embed", "mlp",
"act_batch", "cache_seq", ...). A *rules* dict maps each logical axis to a
mesh axis (or a tuple of mesh axes, or None). :func:`logical_to_spec`
turns a tuple of logical axes into a spec (one entry a dimension: None, a
mesh-axis name, or a tuple of them) under the reference's two invariants:

- a mesh axis appears at most once in a spec (first occurrence wins);
- a dimension is sharded only if its size divides the mesh-axis product
  (the assignment is trimmed from the right until it does).

:func:`placements` maps a spec onto DTensor placements, :func:`constrain`
is ``with_sharding_constraint``'s counterpart (``redistribute``), and
:func:`distribute_params` is ``param_shardings``': it places a parameter
dict by its specs' axes. :func:`default_rules` derives the per-(config,
mesh, step kind) rules line for line as the reference does.

``axis_rules(...)`` installs rules for the duration of a step;
``constrain`` is the identity outside it (and on tensors that are not
DTensors), so the model code runs unchanged on one device. The reference
module imports ``jax.sharding``, so it is not one of the port's verbatim
copies: ``tests/test_torch_sharding.py`` holds the two equal instead.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Sequence

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs.base import ModelConfig

_SPECIAL_PREFIX = "__"          # rules keys like "__mesh__" are not axes

_state = threading.local()


def mesh_axis_names(mesh) -> tuple[str, ...]:
    """Axis names of a ``DeviceMesh`` or of a test stand-in
    (``axis_names`` and a ``shape`` dict)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """axis name -> size, for a ``DeviceMesh`` and for test stand-ins."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh_axis_names(mesh), tuple(mesh.shape)))


def logical_to_spec(axes: Sequence[str | None], rules: dict,
                    shape: Sequence[int] | None = None,
                    mesh=None) -> tuple:
    """Map logical ``axes`` (one entry a tensor dim) to a spec tuple.

    ``rules[name]`` may be a mesh-axis name, a tuple of them, or None.
    With ``shape`` (and a mesh, from the argument or ``rules["__mesh__"]``),
    assignments whose mesh-axis product does not divide the dim are
    trimmed from the right until it does (usually to nothing)."""
    mesh = mesh if mesh is not None else rules.get("__mesh__")
    sizes = mesh_axis_sizes(mesh) if mesh is not None else None
    used: set[str] = set()
    out: list[Any] = []
    for i, name in enumerate(axes):
        target = rules.get(name) if isinstance(name, str) else None
        if target is None or (isinstance(name, str)
                              and name.startswith(_SPECIAL_PREFIX)):
            out.append(None)
            continue
        raw = list(target) if isinstance(target, (tuple, list)) else [target]
        cand: list[str] = []
        for a in raw:   # dedup against earlier dims AND within this tuple
            if a not in used and a not in cand \
                    and (sizes is None or a in sizes):
                cand.append(a)
        if shape is not None and sizes is not None:
            while cand:
                prod = 1
                for a in cand:
                    prod *= sizes[a]
                if prod and shape[i] % prod == 0:
                    break
                cand.pop()                       # trim from the right
        if not cand:
            out.append(None)
            continue
        used.update(cand)
        out.append(cand[0] if len(cand) == 1 else tuple(cand))
    return tuple(out)


def placements(spec: Sequence, mesh) -> tuple:
    """DTensor placements of a spec: for each mesh dimension, ``Shard(d)``
    when tensor dim d names it, else ``Replicate()``. A dim that names a
    tuple of mesh axes is split by them major to minor, which DTensor
    does when they are in mesh order; a tuple out of mesh order would be
    a strided shard, and is refused. A mesh axis of size 1 splits nothing
    and stays ``Replicate()`` (a shard of it would hold the whole dim, and
    DTensor then refuses views that merge that dim into another)."""
    names = mesh_axis_names(mesh)
    sizes = mesh_axis_sizes(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = list(entry) if isinstance(entry, (tuple, list)) else [entry]
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} of dim {d} is not in "
                             f"mesh order {names}: DTensor cannot place "
                             f"it without a strided shard")
        for i in idx:
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def placements_of(axes: Sequence[str | None], rules: dict,
                  shape: Sequence[int]) -> tuple:
    """Placements of a tensor of ``shape`` whose dims are ``axes``, under
    ``rules`` and their mesh."""
    mesh = rules["__mesh__"]
    return placements(logical_to_spec(axes, rules, shape=shape, mesh=mesh),
                      mesh)


# ---------------------------------------------------------------------------
# rules context (installed per step by models/steps.py)
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def axis_rules(rules: dict):
    prev = getattr(_state, "rules", None)
    _state.rules = rules
    try:
        yield rules
    finally:
        _state.rules = prev


def current_rules() -> dict | None:
    return getattr(_state, "rules", None)


def recompute_context():
    """A ``checkpoint(..., context_fn=...)`` that re-installs the active
    rules while a layer is recomputed in backward (the recomputation may
    run on another thread, and the rules are per thread)."""
    rules = current_rules()
    return lambda: (contextlib.nullcontext(),
                    axis_rules(rules) if rules else contextlib.nullcontext())


def replicated_like(t: torch.Tensor, x) -> torch.Tensor:
    """A tensor every rank holds whole (a RoPE table, a position
    embedding) as a replicated DTensor on ``x``'s mesh when ``x`` is a
    DTensor; unchanged otherwise."""
    if not isinstance(x, DTensor) or isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, x.device_mesh,
                              [Replicate()] * x.device_mesh.ndim,
                              run_check=False)


def matmul_in(x, w):
    """``x (..., D)`` times ``w (D, N, ...)`` -> ``(..., N, ...)``. A plain
    ``w``: the product on whole tensors. A DTensor ``w``: on local
    pieces: x keeps its shards of the leading dims, w its shards of N (its
    D gathered, the FSDP all-gather), and each rank multiplies its rows
    by its columns. (Left to DTensor, the choice of strategy shifts with
    the operands' placements: it may gather a column-sharded weight, or
    split the flattened (D, N*K) weight on columns that cut a head, which
    the view back to (N, K), or its grad's, cannot express.)"""
    if not isinstance(w, DTensor):
        return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])
    nd = x.ndim
    xp, wp, out = [], [], []
    for px, pw in zip(x.placements, w.placements):
        rows = px.is_shard() and px.dim < nd - 1
        cols = pw.is_shard(1) and not rows
        xp.append(px if rows else Replicate())
        wp.append(Shard(1) if cols else Replicate())
        out.append(px if rows else Shard(nd - 1) if cols else Replicate())
    mesh = x.device_mesh
    xl = to_local(x.redistribute(mesh, xp), out)
    wl = to_local(w.redistribute(mesh, wp), out)
    yl = (xl @ wl.reshape(wl.shape[0], -1)).unflatten(-1, wl.shape[1:])
    return DTensor.from_local(yl, mesh, out, run_check=False)


def matmul_out(o, w):
    """``o (..., N, ...)`` times ``w (N, ..., D)`` -> ``(..., D)``, the
    last ``w.ndim - 1`` dims of o contracted. A plain ``w``: the product
    on whole tensors. A DTensor ``w``: on local pieces: o keeps its
    shards of the leading dims and of N, w takes the same N shards (its D
    gathered); where N is split the result is a partial sum."""
    from torch.distributed.tensor import Partial
    k = w.ndim - 1
    lead = o.ndim - k
    if not isinstance(w, DTensor):
        return o.flatten(lead) @ w.reshape(-1, w.shape[-1]) if k > 1 else \
            o @ w
    op, wp, out = [], [], []
    for po in o.placements:
        rows = po.is_shard() and po.dim < lead
        split = po.is_shard(lead)
        op.append(po if rows or split else Replicate())
        wp.append(Shard(0) if split else Replicate())
        out.append(po if rows else Partial() if split else Replicate())
    mesh = o.device_mesh
    ol = to_local(o.redistribute(mesh, op), out)
    wl = to_local(w.redistribute(mesh, wp), out)
    yl = ol.flatten(lead) @ wl.reshape(-1, wl.shape[-1]) if k > 1 else \
        ol @ wl
    return DTensor.from_local(yl, mesh, out, run_check=False)


def matmul(x, w):
    """``x @ w`` for a (D, F) weight. On a mesh: :func:`matmul_out` when
    x's last dim (the contraction) is split, else :func:`matmul_in`, so
    the product never depends on DTensor's choice of strategy."""
    if not isinstance(w, DTensor):
        return x @ w
    if any(p.is_shard(x.ndim - 1) for p in x.placements):
        return matmul_out(x, w)
    return matmul_in(x, w)


def constrain(x, *axes: str | None):
    """``redistribute`` to the active rules' placements for ``axes``; the
    identity with no rules, no mesh, a tensor that is not a DTensor, or a
    spec that names no mesh axis (as the reference leaves such a tensor
    to the partitioner)."""
    rules = current_rules()
    if not rules or not isinstance(x, DTensor):
        return x
    mesh = rules.get("__mesh__")
    if mesh is None or x.ndim != len(axes):
        return x
    spec = logical_to_spec(axes, rules, shape=x.shape, mesh=mesh)
    if all(e is None for e in spec):
        return x
    target = placements(spec, mesh)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def place(x: DTensor, *axes: str | None) -> DTensor:
    """``x`` redistributed to exactly the active rules' placements for
    ``axes`` (a dim that names no mesh axis replicated, a partial sum
    reduced): what a local computation on ``x.to_local()`` relies on."""
    rules = current_rules()
    target = placements_of(axes, rules, x.shape)
    if tuple(x.placements) == target:
        return x
    return x.redistribute(rules["__mesh__"], target)


def to_local(x: DTensor, out_placements) -> torch.Tensor:
    """``x``'s piece for a computation on local tensors whose result is
    placed by ``out_placements``. Where that result is sharded over a mesh
    dim on which ``x`` is whole, each rank uses ``x`` for its own part, so
    the grads the ranks send back are partial sums of ``x``'s grad."""
    from torch.distributed.tensor import Partial
    grad = [px if px.is_shard() else Partial() if po.is_shard()
            or isinstance(po, Partial) else px
            for px, po in zip(x.placements, out_placements)]
    return x.to_local(grad_placements=grad)


def local_offset(x: DTensor) -> tuple[int, ...]:
    """The global index of the first element of this rank's piece."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    return tuple(compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, x.placements)[1])


def from_local(t: torch.Tensor, like: DTensor) -> DTensor:
    """This rank's piece ``t`` as a DTensor on ``like``'s mesh and
    placements (its global shape: ``t``'s, each sharded dim times its
    shards)."""
    return DTensor.from_local(t, like.device_mesh, like.placements,
                              run_check=False)


def full(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank: a DTensor's ``full_tensor()`` (a
    partial sum reduced over the mesh), any other tensor itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def placed_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A whole tensor (every rank holds it) on ``like``'s device, and on
    its mesh and placements when ``like`` is a DTensor."""
    if isinstance(like, DTensor):
        return distribute(t.to(like.to_local().device), like.device_mesh,
                          like.placements)
    return t.to(like.device)


def distribute(t: torch.Tensor, mesh, place) -> DTensor:
    """``distribute_tensor`` of a tensor every rank holds whole: each rank
    keeps its own piece, nothing is sent."""
    return distribute_tensor(t, mesh, list(place), src_data_rank=None)


def distribute_params(params: dict[str, torch.Tensor], specs: dict, mesh,
                      rules: dict) -> dict[str, DTensor]:
    """Each leaf placed by its spec's logical axes (divisibility checked,
    as the reference's ``param_shardings``)."""
    return {name: distribute(t, mesh, placements(logical_to_spec(
        specs[name].axes, rules, shape=specs[name].shape, mesh=mesh), mesh))
        for name, t in params.items()}


# ---------------------------------------------------------------------------
# default rules
# ---------------------------------------------------------------------------
# Shard the per-expert FFN dim over "data" (expert-FSDP) above this many
# expert parameters per layer — the 235B-class configs where even one
# layer's expert bank exceeds a chip's HBM share.
_MOE_FSDP_PARAM_THRESHOLD = 1e9


def default_rules(cfg: ModelConfig, mesh, step_kind: str = "train") -> dict:
    """Per-(config, mesh, step-kind) logical->mesh axis rules.

    step_kind: "train" | "prefill" | "decode" | "decode_long".
    Only the mesh's axis names and sizes are consulted, so tests can pass
    lightweight mesh stand-ins."""
    names = mesh_axis_names(mesh)
    sizes = mesh_axis_sizes(mesh)
    msize = sizes.get("model", 1)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    train = step_kind == "train"
    long_decode = step_kind == "decode_long"

    H, KV = cfg.num_heads, cfg.num_kv_heads

    rules: dict[str, Any] = {
        "__mesh__": mesh,
        # ---- params: tensor parallelism over "model" -------------------
        "q_heads": "model",
        "kv_heads": "model" if KV % msize == 0 else None,
        "head_dim": None,
        "mlp": "model",
        "embed_out": "model",
        "vocab": "model",
        "layers": None,
        "embed_concat": None,
        # FSDP over the d_model dim of every param — training only (the
        # serving path keeps params fully resident for latency).
        "embed": (("data",) if "data" in names else None) if train else None,
        # ---- activations ----------------------------------------------
        "act_batch": None if long_decode else (data_axes or None),
        "act_seq": (data_axes or None) if long_decode else None,
        "act_embed": None,
        "act_heads": "model",
        "act_kv_heads": "model" if KV % msize == 0 else None,
        # ---- KV cache: kv-head TP when divisible, else ride seq --------
        "cache_kv_heads": "model" if KV % msize == 0 else None,
        # ---- SSM / RWKV -------------------------------------------------
        "conv_dim": "model",
        "ssm_heads": "model",
        "ssm_state": None,
        "ssm_groups": None,
        "rwkv_heads": "model",
        "rwkv_k": None,
        "rwkv_v": None,
        # RWKV head counts are usually not model-divisible; per-chunk fp32
        # tensors ride the chunk dim instead (see models/rwkv6.py).
        "rwkv_chunks": "model",
    }
    rules["cache_seq"] = "model" if rules["cache_kv_heads"] is None else None
    if long_decode:
        # batch=1: nothing to shard there; spread the cache over everything
        seq_axes = data_axes + (("model",) if rules["cache_kv_heads"] is None
                                else ())
        rules["cache_seq"] = seq_axes or None

    # TP head padding: when H doesn't divide the model axis, the attention
    # core pads Q heads up to a multiple of the axis (models/transformer.py)
    # rather than replicating the whole (B,S,H,Dh) tensor.
    rules["__attn_head_pad__"] = msize if (msize > 1 and H % msize) else 0

    # ---- MoE ---------------------------------------------------------------
    if cfg.moe is not None:
        m = cfg.moe
        ep = m.num_experts % msize == 0 and m.sharding_mode != "tp"
        rules["experts"] = "model" if ep else None
        rules["experts_router"] = None
        rules["moe_capacity"] = None
        expert_params = 3 * m.num_experts * cfg.d_model * m.d_ff_expert
        if ep and expert_params > _MOE_FSDP_PARAM_THRESHOLD \
                and "data" in names:
            rules["moe_mlp"] = ("data",)       # expert-FSDP for the giants
        else:
            rules["moe_mlp"] = None if ep else "model"
    return rules
