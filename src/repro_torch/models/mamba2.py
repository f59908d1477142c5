"""Mamba2 (SSD) block in the chunked state-space-duality form: the port of
the JAX package's ``models/mamba2.py``.

A prompt is split into chunks of ``cfg.ssm.chunk`` tokens: the
intra-chunk terms are dense products, and the state is carried from chunk
to chunk in fp32 (:func:`ssd_chunked`). A one-token decode step runs the
recurrence directly. The reference has no Pallas kernel here (its SSD is
einsums), so neither has the port: the arithmetic is plain torch on
either device. The reference carries the state across chunks with an
associative scan; the port runs the same affine recurrence as a loop over
the chunks (the same products, summed in another order).

Layouts: x (B, S, D); SSM heads H = expand * D / head_dim; state (B, H,
P, N) with P = head_dim, N = d_state; the conv state (B, K - 1, C) holds
the last K - 1 inputs of the depthwise causal convolution.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, _silu, rms_norm


def mamba_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, SSM heads, conv channels)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim, d_in + 2 * s.n_groups * s.d_state


def mamba_specs(cfg: ModelConfig, dtype: str) -> dict[str, ParamSpec]:
    """Flat {name: ParamSpec} of one Mamba2 layer (without its norm).

    ``A_log``, ``D`` and ``dt_bias`` are drawn in fp32 and cast to the
    compute dtype with the other leaves: the reference declares them
    ``keep_dtype``, but its ``Model.specs()`` stacks the layer specs
    without that flag, so its forward casts them too (ROADMAP R6)."""
    s = cfg.ssm
    D = cfg.d_model
    _, H, conv_dim = mamba_dims(cfg)
    P, N, G = s.head_dim, s.d_state, s.n_groups
    return {
        "wz": ParamSpec((D, H, P), dtype=dtype),
        "wx": ParamSpec((D, H, P), dtype=dtype),
        "wB": ParamSpec((D, G, N), dtype=dtype),
        "wC": ParamSpec((D, G, N), dtype=dtype),
        "wdt": ParamSpec((D, H), dtype=dtype),
        "conv_w": ParamSpec((s.d_conv, conv_dim), init="small", scale=0.1,
                            dtype=dtype),
        "conv_b": ParamSpec((conv_dim,), init="zeros", dtype=dtype),
        "A_log": ParamSpec((H,), init="zeros", dtype="float32"),
        "D": ParamSpec((H,), init="ones", dtype="float32"),
        "dt_bias": ParamSpec((H,), init="zeros", dtype="float32"),
        "norm": ParamSpec((H, P), init="zeros", dtype=dtype),
        "wo": ParamSpec((H, P, D), dtype=dtype),
    }


def mamba_state_shapes(cfg: ModelConfig, batch: int) -> dict:
    """{"conv": (shape, dtype), "ssm": (shape, "float32")} of one layer."""
    _, H, conv_dim = mamba_dims(cfg)
    s = cfg.ssm
    return {"conv": ((batch, s.d_conv - 1, conv_dim), cfg.compute_dtype),
            "ssm": ((batch, H, s.head_dim, s.d_state), "float32")}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None):
    """Depthwise causal conv. x (B, S, C), w (K, C), b (C,), state (B, K-1,
    C) or None (zeros). Returns (y (B, S, C), new_state (B, K-1, C)), both
    in x's dtype, every product and sum rounded to it as in the
    reference (bf16 outputs then match it bit for bit)."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + S] * w[i] for i in range(K)) + b
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return y, new_state


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA (..., L) -> (..., L, L) with out[i, j] = sum_{s=j+1..i} dA_s for
    j <= i and -inf above the diagonal."""
    c = torch.cumsum(dA, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    L = dA.shape[-1]
    keep = torch.ones(L, L, dtype=torch.bool, device=dA.device).tril()
    return diff.masked_fill(~keep, float("-inf"))


def ssd_chunked(xh, dt, A, Bm, Cm, init_state, chunk: int):
    """The SSD over a whole sequence. xh (B, S, H, P) inputs, dt (B, S, H)
    (>= 0, after the softplus), A (H,) (< 0), Bm/Cm (B, S, G, N),
    init_state (B, H, P, N). Returns (y (B, S, H, P) fp32, final state
    (B, H, P, N) fp32). A sequence that is not a whole number of chunks is
    padded with dt = 0: decay 1 and no input, so the pad leaves the state
    as the last real token left it."""
    B_, S, H, P = xh.shape
    G = Bm.shape[2]
    L = min(chunk, S)
    S0 = S
    if S % L:
        pad = L - S % L
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S += pad
    nc = S // L
    rep = H // G
    dtf = dt.float()
    dA = dtf * A.float()                                      # (B,S,H) <= 0
    xbar = xh.float() * dtf[..., None]                        # dt folded in

    def chunks(t):                                            # (B,nc,L,...)
        return t.reshape((B_, nc, L) + t.shape[2:])

    xc = chunks(xbar)                                         # (B,nc,L,H,P)
    Bh = chunks(Bm.float()).repeat_interleave(rep, dim=3)     # (B,nc,L,H,N)
    Ch = chunks(Cm.float()).repeat_interleave(rep, dim=3)
    dAh = chunks(dA).movedim(-1, 2)                           # (B,nc,H,L)

    # intra-chunk (diagonal) term
    decay_ij = torch.exp(_segsum(dAh))                        # (B,nc,H,L,L)
    scores = torch.einsum("bclhn,bcmhn->bchlm", Ch, Bh) * decay_ij
    y = torch.einsum("bchlm,bcmhp->bclhp", scores, xc)
    del decay_ij, scores

    # each chunk's contribution to the state at its end
    cum = torch.cumsum(dAh, dim=-1)                           # (B,nc,H,L)
    total = cum[..., -1]                                      # (B,nc,H)
    decay_out = torch.exp(total[..., None] - cum)
    states = torch.einsum("bclhn,bclhp->bchpn",
                          Bh * decay_out.movedim(2, 3)[..., None], xc)

    # the state entering each chunk: S_c = exp(total_c) S_{c-1} + states_c
    chunk_decay = torch.exp(total)[..., None, None]           # (B,nc,H,1,1)
    run = init_state.float()
    prev = []
    for c in range(nc):
        prev.append(run)
        run = chunk_decay[:, c] * run + states[:, c]
    prev = torch.stack(prev, dim=1)                           # (B,nc,H,P,N)

    # off-diagonal term: the queries against the carried-in state
    decay_in = torch.exp(cum).movedim(2, 3)[..., None]        # (B,nc,L,H,1)
    y = y + torch.einsum("bclhn,bchpn->bclhp", Ch * decay_in, prev)
    return y.reshape(B_, S, H, P)[:, :S0], run


def mamba_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: dict | None, mode: str):
    """x (B, S, D) -> (out (B, S, D), {"conv", "ssm"}). ``state`` holds the
    layer's conv and SSM states (None starts from zeros). A decode step of
    one token runs the recurrence; everything else runs
    :func:`ssd_chunked` from the given state."""
    s = cfg.ssm
    B_, S, D = x.shape
    _, H, _ = mamba_dims(cfg)
    P, N, G = s.head_dim, s.d_state, s.n_groups

    def proj(w):                                  # (D, ...) -> (B, S, ...)
        return (x @ w.reshape(D, -1)).unflatten(-1, w.shape[1:])

    z = proj(p["wz"])                                         # (B,S,H,P)
    conv_in = torch.cat([x @ p["wx"].reshape(D, -1),
                         x @ p["wB"].reshape(D, -1),
                         x @ p["wC"].reshape(D, -1)], dim=-1)
    dt = x @ p["wdt"]                                         # (B,S,H)
    conv_out, new_conv = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"],
        None if state is None else state["conv"])
    conv_out = _silu(conv_out)
    xr = conv_out[..., :H * P].unflatten(-1, (H, P))
    Bm = conv_out[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cm = conv_out[..., H * P + G * N:].unflatten(-1, (G, N))

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    ssm = (x.new_zeros((B_, H, P, N), dtype=torch.float32) if state is None
           else state["ssm"].float())
    if mode == "decode" and S == 1:
        dA = torch.exp(dt[:, 0] * A)                          # (B,H)
        xb = xr[:, 0].float() * dt[:, 0, :, None]             # (B,H,P)
        Bh = Bm[:, 0].float().repeat_interleave(H // G, dim=1)  # (B,H,N)
        Ch = Cm[:, 0].float().repeat_interleave(H // G, dim=1)
        new_ssm = dA[..., None, None] * ssm + xb[..., None] * Bh[:, :, None]
        y = torch.einsum("bhn,bhpn->bhp", Ch, new_ssm)[:, None]
    else:
        y, new_ssm = ssd_chunked(xr, dt, A, Bm, Cm, ssm, s.chunk)

    y = y + xr.float() * p["D"].float()[:, None]
    # the gate's product feeds the norm unrounded, as XLA's fusion of the
    # reference computes it (bf16 outputs then match it bit for bit)
    y = y.to(x.dtype).float() * _silu(z).float()
    y = rms_norm(y, p["norm"], cfg.norm_eps).to(x.dtype)
    out = y.flatten(-2) @ p["wo"].reshape(H * P, D)
    return out, {"conv": new_conv, "ssm": new_ssm}
