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
the JAX package's spec tree.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
        "mix_base": ParamSpec((D,), init="zeros", dtype=dtype),
        "mix": ParamSpec((5, D), init="zeros", dtype=dtype),
        "mix_w1": ParamSpec((D, 5, LORA_MIX), init="small", scale=0.1,
                            dtype=dtype),
        "mix_w2": ParamSpec((5, LORA_MIX, D), init="small", scale=0.1,
                            dtype=dtype),
        "wr": ParamSpec((D, H, K), dtype=dtype),
        "wk": ParamSpec((D, H, K), dtype=dtype),
        "wv": ParamSpec((D, H, K), dtype=dtype),
        "wg": ParamSpec((D, H, K), dtype=dtype),
        "wo": ParamSpec((H, K, D), dtype=dtype),
        # decay w = exp(-exp(w0 + lora)); bonus u (both kept in fp32)
        "w0": ParamSpec((H, K), init="zeros", dtype="float32",
                        keep_dtype=True),
        "dec_w1": ParamSpec((D, LORA_DECAY), init="small", scale=0.1,
                            dtype=dtype),
        "dec_w2": ParamSpec((LORA_DECAY, H, K), init="small", scale=0.1,
                            dtype=dtype),
        "u": ParamSpec((H, K), init="zeros", dtype="float32",
                       keep_dtype=True),
        "ln_scale": ParamSpec((H, K), init="zeros", dtype=dtype),
        "ln_bias": ParamSpec((H, K), init="zeros", dtype=dtype),
    }
    cm = {
        "mix_k": ParamSpec((D,), init="zeros", dtype=dtype),
        "mix_r": ParamSpec((D,), init="zeros", dtype=dtype),
        "wk": ParamSpec((D, F_), dtype=dtype),
        "wv": ParamSpec((F_, D), dtype=dtype),
        "wr": ParamSpec((D, D), dtype=dtype),
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


def _group_norm(o: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                eps: float) -> torch.Tensor:
    """Per-head LayerNorm over the V dim. o (B,S,H,V)."""
    f = o.float()
    mu = f.mean(-1, keepdim=True)
    var = f.var(-1, keepdim=True, unbiased=False)
    out = (f - mu) * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float()) + bias.float()).to(o.dtype)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) @ w (D,H,K) -> (B,S,H,K)."""
    D, H, K = w.shape
    return (x @ w.reshape(D, H * K)).unflatten(-1, (H, K))


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

    r = _heads(xr, p["wr"]).float()
    k = _heads(xk, p["wk"]).float()
    v = _heads(xv, p["wv"]).float()
    g = _silu(_heads(xg, p["wg"]))

    dec = torch.tanh(xw @ p["dec_w1"])
    dec = _heads(dec, p["dec_w2"])
    logw = -torch.exp((p["w0"].float() + dec.float()).clamp(-8.0, 1.0))
    u = p["u"].float()

    wkv0 = torch.zeros((B, H, K, K), dtype=torch.float32, device=x.device) \
        if state is None else state["wkv"].float()
    if mode == "decode" and S == 1:
        r1, k1, v1, w1 = r[:, 0], k[:, 0], v[:, 0], torch.exp(logw[:, 0])
        kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
        o = torch.einsum("bhk,bhkv->bhv", r1, wkv0 + u[None, :, :, None] * kv)
        new_wkv = w1[..., None] * wkv0 + kv
        o = o[:, None]                                    # (B,1,H,V)
    else:
        o, new_wkv = _wkv_chunked(
            r, k, v, logw, u, wkv0, cfg.rwkv.chunk,
            rwkv6_chunked_ref if mode == "train" else wkv_chunked)

    o = _group_norm(o.to(x.dtype), p["ln_scale"], p["ln_bias"], 64e-5)
    o = o * g
    H_, K_, D_ = p["wo"].shape
    out = o.flatten(-2) @ p["wo"].reshape(H_ * K_, D_)
    return out, {"shift": new_shift, "wkv": new_wkv}


def channel_mix_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      state: torch.Tensor | None, mode: str):
    """The RWKV6 FFN with token shift. state: (B,D) last token or None."""
    xprev, new_shift = _token_shift(x, state)
    dx = xprev - x
    xk = x + dx * p["mix_k"]
    xr = x + dx * p["mix_r"]
    kk = torch.square(torch.relu(xk @ p["wk"]))
    vv = kk @ p["wv"]
    rr = torch.sigmoid(xr @ p["wr"])
    return rr * vv, new_shift


def rwkv_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    H, K = rwkv_dims(cfg)
    return {
        "tmix_shift": ((batch, cfg.d_model), cfg.compute_dtype),
        "wkv": ((batch, H, K, K), "float32"),
        "cmix_shift": ((batch, cfg.d_model), cfg.compute_dtype),
    }
