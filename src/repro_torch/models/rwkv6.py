"""RWKV-6 (Finch) block: linear attention with a data-dependent
per-channel decay, the port of the JAX package's ``models/rwkv6.py``.

Recurrence per head (K = V = head_size)::

    o_t[v] = sum_k r_t[k] * (S_{t-1}[k,v] + u[k] * k_t[k] * v_t[v])
    S_t[k,v] = w_t[k] * S_{t-1}[k,v] + k_t[k] * v_t[v]

with w_t = exp(-exp(w0 + lora_w(x_t))) in (0, 1). A prompt runs the
chunked form (:func:`_wkv_chunked`): on CUDA tensors the hand-written WKV
scan kernel, on CPU tensors its plain chunked version, and in a training
forward (mode "train") the plain version on any device (the kernel has no
backward; the reference's train step runs its jnp ``_wkv_chunked``); a
one-token decode step runs the recurrence directly, as in the reference. Token-shift and
WKV states are carried for serving. Parameter names and layouts follow
the JAX package's spec tree. On a mesh the recurrence runs on each
rank's batch rows and heads (:func:`_wkv_sharded`).
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import matmul, matmul_in, matmul_out
from repro_torch.kernels.rwkv6_scan import rwkv6_chunked_ref, wkv_chunked
from repro_torch.models.common import ParamSpec, _silu

LORA_MIX = 32
LORA_DECAY = 64


def rwkv_dims(cfg: ModelConfig) -> tuple[int, int]:
    K = cfg.rwkv.head_size
    return cfg.d_model // K, K


def rwkv_specs(cfg: ModelConfig, dtype: str) -> dict[str, ParamSpec]:
    """Flat {"tmix.*" / "cmix.*": ParamSpec} of one layer."""
    D, F_ = cfg.d_model, cfg.d_ff
    H, K = rwkv_dims(cfg)
    tm = {
        # token-shift ddlerp: base mix + 5-way LoRA (w, k, v, r, g)
        "mix_base": ParamSpec((D,), ("embed",), init="zeros", dtype=dtype),
        "mix": ParamSpec((5, D), (None, "embed"), init="zeros", dtype=dtype),
        "mix_w1": ParamSpec((D, 5, LORA_MIX), ("embed", None, None),
                            init="small", scale=0.1, dtype=dtype),
        "mix_w2": ParamSpec((5, LORA_MIX, D), (None, None, "embed"),
                            init="small", scale=0.1, dtype=dtype),
        "wr": ParamSpec((D, H, K), ("embed", "rwkv_heads", "rwkv_k"),
                        dtype=dtype),
        "wk": ParamSpec((D, H, K), ("embed", "rwkv_heads", "rwkv_k"),
                        dtype=dtype),
        "wv": ParamSpec((D, H, K), ("embed", "rwkv_heads", "rwkv_v"),
                        dtype=dtype),
        "wg": ParamSpec((D, H, K), ("embed", "rwkv_heads", "rwkv_v"),
                        dtype=dtype),
        "wo": ParamSpec((H, K, D), ("rwkv_heads", "rwkv_v", "embed"),
                        dtype=dtype),
        # decay w = exp(-exp(w0 + lora)); bonus u (both kept in fp32)
        "w0": ParamSpec((H, K), ("rwkv_heads", "rwkv_k"), init="zeros",
                        dtype="float32", keep_dtype=True),
        "dec_w1": ParamSpec((D, LORA_DECAY), ("embed", None), init="small",
                            scale=0.1, dtype=dtype),
        "dec_w2": ParamSpec((LORA_DECAY, H, K),
                            (None, "rwkv_heads", "rwkv_k"), init="small",
                            scale=0.1, dtype=dtype),
        "u": ParamSpec((H, K), ("rwkv_heads", "rwkv_k"), init="zeros",
                       dtype="float32", keep_dtype=True),
        "ln_scale": ParamSpec((H, K), ("rwkv_heads", "rwkv_v"),
                              init="zeros", dtype=dtype),
        "ln_bias": ParamSpec((H, K), ("rwkv_heads", "rwkv_v"),
                             init="zeros", dtype=dtype),
    }
    cm = {
        "mix_k": ParamSpec((D,), ("embed",), init="zeros", dtype=dtype),
        "mix_r": ParamSpec((D,), ("embed",), init="zeros", dtype=dtype),
        "wk": ParamSpec((D, F_), ("embed", "mlp"), dtype=dtype),
        "wv": ParamSpec((F_, D), ("mlp", "embed"), dtype=dtype),
        "wr": ParamSpec((D, D), ("embed", "embed_out"), dtype=dtype),
    }
    return {**{f"tmix.{k}": s for k, s in tm.items()},
            **{f"cmix.{k}": s for k, s in cm.items()}}


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None):
    """x (B,S,D) -> (x_{t-1} (B,S,D), last token (B,D)); prev (B,D) is
    the carried-in token (zeros without one)."""
    if prev is None:
        prev = torch.zeros_like(x[:, 0])
    shifted = torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return shifted, x[:, -1]


def _wkv_chunked(r, k, v, logw, u, init_state, chunk: int,
                 scan=wkv_chunked):
    """Chunked WKV. r/k/v (B,S,H,K) fp32, logw (B,S,H,K) (< 0), u (H,K),
    init_state (B,H,K,V). Pads S to a multiple of the chunk (k = 0 adds
    nothing, logw = 0 is decay 1), as the reference does. ``scan``: the
    device dispatch, or the plain version for a training forward. Returns
    (o (B,S,H,V), state)."""
    S = r.shape[1]
    L = min(chunk, S)
    pad = -S % L
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    o, state = scan(r.contiguous(), k.contiguous(), v.contiguous(),
                    logw.contiguous(), u.contiguous(),
                    init_state.float().contiguous(), chunk=L)
    return o[:, :S], state


def _wkv(r, k, v, logw, u, wkv0, *, chunk: int, mode: str):
    """The WKV recurrence over r/k/v/logw (B,S,H,K) from the state wkv0
    (B,H,K,V): one step for a one-token decode, else the chunked scan
    (the kernel's dispatch, or its plain version for a training
    forward). Returns (o (B,S,H,V), state)."""
    if mode == "decode" and r.shape[1] == 1:
        r1, k1, v1, w1 = r[:, 0], k[:, 0], v[:, 0], torch.exp(logw[:, 0])
        kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
        o = torch.einsum("bhk,bhkv->bhv", r1, wkv0 + u[None, :, :, None] * kv)
        return o[:, None], w1[..., None] * wkv0 + kv
    return _wkv_chunked(r, k, v, logw, u, wkv0, chunk,
                        rwkv6_chunked_ref if mode == "train" else wkv_chunked)


def _wkv_sharded(scan, r, k, v, logw, u, wkv0):
    """:func:`_wkv` on a mesh. The recurrence is independent per batch row
    and head, so r/k/v/logw are placed on ("act_batch", None,
    "rwkv_heads", None) (the reference's constrain sites; its scan
    rides the chunk dim instead, which the port's sequential carry over
    chunks cannot split) and each rank scans its own rows and heads."""
    from repro_torch.dist.sharding import from_local, place, to_local
    r, k, v, logw = (place(t, "act_batch", None, "rwkv_heads", None)
                     for t in (r, k, v, logw))
    out = r.placements
    ul = to_local(place(u, "rwkv_heads", None), out)
    rl, kl, vl, wl = (to_local(t, out) for t in (r, k, v, logw))
    if wkv0 is None:
        B, _, H, K = rl.shape
        s0 = rl.new_zeros((B, H, K, K))
        state_like = None
    else:
        state_like = place(wkv0, "act_batch", "rwkv_heads", None, None)
        s0 = to_local(state_like, out)
    ol, sl = scan(rl, kl, vl, wl, ul, s0)
    o = from_local(ol.contiguous(), r)
    if state_like is None:
        from torch.distributed.tensor import Shard
        state = DTensor.from_local(sl, r.device_mesh, [
            Shard(1) if pl.is_shard(2) else pl for pl in out],
            run_check=False)
    else:
        state = from_local(sl, state_like)
    return o, state


def _group_norm(o: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Per-head LayerNorm over the V dim. o (B,S,H,V)."""
    f = o.float()
    mu = f.mean(-1, keepdim=True)
    var = f.var(-1, keepdim=True, unbiased=False)
    out = (f - mu) * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float()) + bias.float()).to(o.dtype)


def time_mix_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   state: dict | None, mode: str):
    """The RWKV6 attention replacement. state: {"shift": (B,D), "wkv":
    (B,H,K,V) fp32} or None. Returns (out (B,S,D), new state)."""
    B, S, D = x.shape
    H, K = rwkv_dims(cfg)
    prev = None if state is None else state["shift"]
    xprev, new_shift = _token_shift(x, prev)
    dx = xprev - x

    # data-dependent 5-way mix (w, k, v, r, g)
    base = x + dx * p["mix_base"]
    lora = torch.einsum("bsd,dne->bsne", base, p["mix_w1"])
    lora = torch.einsum("bsne,ned->bsnd", torch.tanh(lora), p["mix_w2"])
    mixes = p["mix"][None, None] + lora                   # (B,S,5,D)
    xw, xk, xv, xr, xg = (x + dx * mixes[:, :, i] for i in range(5))

    r = matmul_in(xr, p["wr"]).float()
    k = matmul_in(xk, p["wk"]).float()
    v = matmul_in(xv, p["wv"]).float()
    g = _silu(matmul_in(xg, p["wg"]))

    dec = torch.tanh(matmul(xw, p["dec_w1"]))
    dec = matmul_in(dec, p["dec_w2"])
    logw = -torch.exp((p["w0"].float() + dec.float()).clamp(-8.0, 1.0))
    u = p["u"].float()

    wkv0 = None if state is None else state["wkv"].float()
    scan = functools.partial(_wkv, chunk=cfg.rwkv.chunk, mode=mode)
    if isinstance(r, DTensor):
        o, new_wkv = _wkv_sharded(scan, r, k, v, logw, u, wkv0)
    else:
        if wkv0 is None:
            wkv0 = torch.zeros((B, H, K, K), dtype=torch.float32,
                               device=x.device)
        o, new_wkv = scan(r, k, v, logw, u, wkv0)

    o = _group_norm(o.to(x.dtype), p["ln_scale"], p["ln_bias"], 64e-5)
    o = o * g
    return matmul_out(o, p["wo"]), {"shift": new_shift, "wkv": new_wkv}


def channel_mix_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      state: torch.Tensor | None, mode: str):
    """The RWKV6 FFN with token shift. state: (B,D) last token or None."""
    xprev, new_shift = _token_shift(x, state)
    dx = xprev - x
    xk = x + dx * p["mix_k"]
    xr = x + dx * p["mix_r"]
    kk = torch.square(torch.relu(matmul(xk, p["wk"])))
    vv = matmul(kk, p["wv"])
    rr = torch.sigmoid(matmul(xr, p["wr"]))
    return rr * vv, new_shift


def rwkv_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    H, K = rwkv_dims(cfg)
    return {
        "tmix_shift": ((batch, cfg.d_model), cfg.compute_dtype),
        "wkv": ((batch, H, K, K), "float32"),
        "cmix_shift": ((batch, cfg.d_model), cfg.compute_dtype),
    }
