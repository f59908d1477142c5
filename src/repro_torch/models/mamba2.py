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
the last K - 1 inputs of the depthwise causal convolution. On a mesh
the SSD runs on each rank's batch rows and heads (:func:`_ssd_sharded`).

``mamba_apply(..., fused=True)`` (``Model.forward(fused=True)``'s
prefill, extend and decode; never training) runs the mixer through
:mod:`repro_torch.kernels.mamba2` where ``takes_mamba2_launch`` takes the
layer's widths and dtype: a one-token decode step's conv, recurrence, D
skip, gate and norm as one launch from the in-products, both states
updated in place in the cache; any other call's SSD with its D skip,
gate and norm as one launch after the plain conv and SiLU, the SSM state
overwritten in place. Only CUDA tensors take that route: on the CPU
``fused=True`` keeps the plain spelling's bits.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.sharding import matmul, matmul_in, matmul_out
from repro_torch.kernels import mamba2 as mamba2_kernels
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
        "wz": ParamSpec((D, H, P), ("embed", "ssm_heads", None), dtype=dtype),
        "wx": ParamSpec((D, H, P), ("embed", "ssm_heads", None), dtype=dtype),
        "wB": ParamSpec((D, G, N), ("embed", "ssm_groups", "ssm_state"),
                        dtype=dtype),
        "wC": ParamSpec((D, G, N), ("embed", "ssm_groups", "ssm_state"),
                        dtype=dtype),
        "wdt": ParamSpec((D, H), ("embed", "ssm_heads"), dtype=dtype),
        "conv_w": ParamSpec((s.d_conv, conv_dim), (None, "conv_dim"),
                            init="small", scale=0.1,
                            dtype=dtype),
        "conv_b": ParamSpec((conv_dim,), ("conv_dim",), init="zeros",
                            dtype=dtype),
        "A_log": ParamSpec((H,), ("ssm_heads",), init="zeros",
                           dtype="float32"),
        "D": ParamSpec((H,), ("ssm_heads",), init="ones", dtype="float32"),
        "dt_bias": ParamSpec((H,), ("ssm_heads",), init="zeros",
                             dtype="float32"),
        "norm": ParamSpec((H, P), ("ssm_heads", None), init="zeros",
                          dtype=dtype),
        "wo": ParamSpec((H, P, D), ("ssm_heads", None, "embed"), dtype=dtype),
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


def _ssd(xr, dt, A, Bm, Cm, ssm, *, chunk: int, mode: str):
    """The SSD from the state ``ssm`` (B,H,P,N): one recurrence step for a
    one-token decode, else :func:`ssd_chunked`. Returns (y (B,S,H,P)
    fp32, state)."""
    if mode == "decode" and xr.shape[1] == 1:
        H, G = xr.shape[2], Bm.shape[2]
        dA = torch.exp(dt[:, 0] * A)                          # (B,H)
        xb = xr[:, 0].float() * dt[:, 0, :, None]             # (B,H,P)
        Bh = Bm[:, 0].float().repeat_interleave(H // G, dim=1)  # (B,H,N)
        Ch = Cm[:, 0].float().repeat_interleave(H // G, dim=1)
        new_ssm = dA[..., None, None] * ssm + xb[..., None] * Bh[:, :, None]
        return torch.einsum("bhn,bhpn->bhp", Ch, new_ssm)[:, None], new_ssm
    return ssd_chunked(xr, dt, A, Bm, Cm, ssm, chunk)


def _ssd_sharded(scan, xr, dt, A, Bm, Cm, ssm):
    """:func:`_ssd` on a mesh: per batch row and head the scan is
    independent, so the inputs are placed on "act_batch" and "ssm_heads"
    (the reference's constrain sites) and each rank scans its rows and
    heads, B and C taken for its heads' groups (one group a head: the
    same values the repeat gives)."""
    from repro_torch.dist.sharding import (from_local, local_offset, place,
                                           to_local)
    xr = place(xr, "act_batch", None, "ssm_heads", None)
    out = xr.placements
    dt = place(dt, "act_batch", None, "ssm_heads")
    Bm, Cm = (place(t, "act_batch", None, None, None) for t in (Bm, Cm))
    xl = to_local(xr, out)
    Hl, h0 = xl.shape[2], local_offset(xr)[2]
    groups = torch.tensor([(h0 + i) // (xr.shape[2] // Bm.shape[2])
                           for i in range(Hl)], device=xl.device)
    Bl, Cl = (to_local(t, out).index_select(2, groups) for t in (Bm, Cm))
    Al = to_local(place(A, "ssm_heads"), out)
    if ssm is None:
        s0 = xl.new_zeros((xl.shape[0], Hl, xl.shape[3], Bl.shape[3]),
                          dtype=torch.float32)
        state_like = None
    else:
        state_like = place(ssm, "act_batch", "ssm_heads", None, None)
        s0 = to_local(state_like, out)
    yl, sl = scan(xl, to_local(dt, out), Al, Bl, Cl, s0)
    y = from_local(yl.contiguous(), xr)
    if state_like is None:
        from torch.distributed.tensor import Shard
        return y, DTensor.from_local(sl, xr.device_mesh, [
            Shard(1) if pl.is_shard(2) else pl for pl in out],
            run_check=False)
    return y, from_local(sl, state_like)


#: the device type whose tensors take the kernels' route
_KERNEL_DEVICE = "cuda"


def _takes_kernels(fused: bool, x, cfg: ModelConfig, mode: str) -> bool:
    """Whether :func:`mamba_apply` runs the Mamba2 kernels' route:
    ``fused``, CUDA tensors (the CPU keeps the plain spelling's bits), a
    serving mode (training keeps the plain ops: the kernels have no
    backward), local tensors (a mesh keeps the plain route), and widths
    and a dtype the kernels take."""
    return fused and x.device.type == _KERNEL_DEVICE \
        and mode in ("prefill", "extend", "decode") \
        and not isinstance(x, DTensor) \
        and mamba2_kernels.takes_mamba2_launch(cfg, x.dtype)


def mamba_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                state: dict | None, mode: str, fused: bool = False):
    """x (B, S, D) -> (out (B, S, D), {"conv", "ssm"}). ``state`` holds the
    layer's conv and SSM states (None starts from zeros). A decode step of
    one token runs the recurrence; everything else runs
    :func:`ssd_chunked` from the given state. ``fused``: where
    :func:`_takes_kernels`, a one-token decode step after the in-products
    is one ``mamba2_step`` launch and any other call's SSD with its
    epilogue one ``ssd_chunk`` launch (the module's docstring), the
    states updated in place and returned; else the plain spelling, which
    never writes into ``state``."""
    s = cfg.ssm
    B_, S, D = x.shape
    _, H, conv_dim = mamba_dims(cfg)
    P, N, G = s.head_dim, s.d_state, s.n_groups
    kernels = _takes_kernels(fused, x, cfg, mode)

    z = matmul_in(x, p["wz"])                                 # (B,S,H,P)
    xs, bs, cs = (matmul(x, p[k].reshape(D, -1)) for k in ("wx", "wB", "wC"))
    dt = matmul(x, p["wdt"])                                  # (B,S,H)
    if kernels and mode == "decode" and S == 1:
        if state is None:
            state = {"conv": x.new_zeros((B_, s.d_conv - 1, conv_dim)),
                     "ssm": x.new_zeros((B_, H, P, N), dtype=torch.float32)}
        y = mamba2_kernels.mamba2_step(
            z[:, 0], xs[:, 0], bs[:, 0], cs[:, 0], dt[:, 0], p["conv_w"],
            p["conv_b"], p["dt_bias"], p["A_log"], p["D"], p["norm"],
            conv_state=state["conv"], ssm_state=state["ssm"],
            eps=cfg.norm_eps)
        return matmul_out(y[:, None], p["wo"]), state
    conv_out, new_conv = _causal_conv(
        torch.cat([xs, bs, cs], dim=-1), p["conv_w"], p["conv_b"],
        None if state is None else state["conv"])
    conv_out = _silu(conv_out)
    xr = conv_out[..., :H * P].unflatten(-1, (H, P))
    Bm = conv_out[..., H * P:H * P + G * N].unflatten(-1, (G, N))
    Cm = conv_out[..., H * P + G * N:].unflatten(-1, (G, N))

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    if kernels:
        y, new_ssm = mamba2_kernels.ssd_chunk(
            xr, dt, p["A_log"], Bm, Cm, z, p["D"], p["norm"],
            None if state is None else state["ssm"], chunk=s.chunk,
            eps=cfg.norm_eps)
        return matmul_out(y, p["wo"]), {"conv": new_conv, "ssm": new_ssm}
    A = -torch.exp(p["A_log"].float())
    ssm = None if state is None else state["ssm"].float()
    scan = functools.partial(_ssd, chunk=s.chunk, mode=mode)
    if isinstance(xr, DTensor):
        y, new_ssm = _ssd_sharded(scan, xr, dt, A, Bm, Cm, ssm)
    else:
        if ssm is None:
            ssm = x.new_zeros((B_, H, P, N), dtype=torch.float32)
        y, new_ssm = scan(xr, dt, A, Bm, Cm, ssm)

    out = matmul_out(_gate_norm(y, xr, z, p, cfg), p["wo"])
    return out, {"conv": new_conv, "ssm": new_ssm}


def _gate_norm(y, xr, z, p: dict, cfg: ModelConfig) -> torch.Tensor:
    """The SSD's epilogue in the plain spelling: y (B, S, H, P) fp32 plus
    the D skip, gated by SiLU(z), normed over P, in z's dtype."""
    y = y + xr.float() * p["D"].float()[:, None]
    # the gate's product feeds the norm unrounded, as XLA's fusion of the
    # reference computes it (bf16 outputs then match it bit for bit)
    y = y.to(z.dtype).float() * _silu(z).float()
    return rms_norm(y, p["norm"], cfg.norm_eps).to(z.dtype)
