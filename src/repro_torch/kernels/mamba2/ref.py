"""Plain PyTorch versions of the Mamba2 kernels: the same functions as
``csrc/mamba2.cu``, with the reductions in the kernels' orders where the
order is the kernels' own (the decode step's readout over N and both
norms over P; the chunk's cumulative decay token by token and the state
carried chunk by chunk). ``ops`` sends a CPU tensor to them (the model
itself keeps its plain spelling on the CPU); the tests and
``chip_smoke.py`` hold the kernels against them. Each elementwise op is the plain spelling's
(``models/mamba2.py``): the conv rounded op by op, SiLU as
``common._silu``, torch's softplus, the state update as three ops."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import _silu

#: the kernels' lanes: the step's readout sums a state row in 4 lanes of
#: 16 consecutive n, a norm sums a head row in 16 lanes of 4 consecutive
#: p; each over 64 slots, the ones past N or P zero
TILE, READOUT_LANES, NORM_LANES = 64, 4, 16


def lane_sum(t: torch.Tensor, lanes: int) -> torch.Tensor:
    """The kernels' sum over t's last dim (at most ``TILE`` values, zeros
    past it): ``lanes`` lanes of ``TILE / lanes`` consecutive values, each
    summed in order from its first, then the lanes added by a xor-shuffle
    tree (adjacent pairs first). Returns the sums, (..., 1)."""
    t = F.pad(t, (0, TILE - t.shape[-1]))
    t = t.unflatten(-1, (lanes, TILE // lanes))
    s = t[..., 0]
    for i in range(1, t.shape[-1]):
        s = s + t[..., i]
    while s.shape[-1] > 1:
        s = s[..., 0::2] + s[..., 1::2]
    return s


def gate_norm_ref(y, xs, z, D, norm, eps: float) -> torch.Tensor:
    """The epilogue both kernels run: y (..., H, P) fp32 plus the D skip
    ``xs D`` in fp32, rounded to the compute dtype, times SiLU(z) in
    fp32, then the norm over P with a ``(1 + norm)`` gain, its sum of
    squares in the kernels' order (:func:`lane_sum`), rounded once."""
    dtype = z.dtype
    y = y + xs.float() * D.float()[:, None]
    g = y.to(dtype).float() * _silu(z).float()
    var = lane_sum(g * g, NORM_LANES) * (1.0 / g.shape[-1])
    return (g * torch.rsqrt(var + eps) * (1.0 + norm.float())).to(dtype)


def _groups(t: torch.Tensor, H: int) -> torch.Tensor:
    """(..., G, N) -> (..., H, N): each head's group (the repeat the plain
    spelling makes, read in place by the kernels)."""
    G = t.shape[-2]
    idx = torch.arange(H, device=t.device) // (H // G)
    return t.index_select(-2, idx)


def step_core_ref(x, bm, cm, dt, conv_w, conv_b, dt_bias, A_log, *,
                  conv_state, ssm_state):
    """The decode step before its epilogue: the conv (shifting
    ``conv_state`` in place) and SiLU, dt's softplus, the recurrence
    (updating ``ssm_state`` in place) and its readout in the kernel's
    order. Returns (y (B, H, P) fp32, the conv'd x (B, H, P) and C (B, H,
    N) a head, the new state)."""
    B, N = x.shape[0], ssm_state.shape[-1]
    H, P = ssm_state.shape[1:3]
    G = bm.shape[-1] // N
    K = conv_w.shape[0]
    xp = torch.cat([conv_state.to(x.dtype),
                    torch.cat([x, bm, cm], dim=-1)[:, None]], dim=1)
    conv = sum(xp[:, i] * conv_w[i] for i in range(K)) + conv_b
    conv_state.copy_(xp[:, 1:])
    conv = _silu(conv)
    xs = conv[:, :H * P].unflatten(-1, (H, P))
    Bh = _groups(conv[:, H * P:H * P + G * N].unflatten(-1, (G, N)), H)
    Ch = _groups(conv[:, H * P + G * N:].unflatten(-1, (G, N)), H).float()
    dtv = F.softplus(dt.float() + dt_bias.float())
    dA = torch.exp(dtv * -torch.exp(A_log.float()))
    xb = xs.float() * dtv[..., None]
    new = dA[..., None, None] * ssm_state + xb[..., None] * \
        Bh.float()[:, :, None]
    ssm_state.copy_(new)
    y = lane_sum(Ch[:, :, None] * new, READOUT_LANES)[..., 0]
    return y, xs, Ch, new


def mamba2_step_ref(z, x, bm, cm, dt, conv_w, conv_b, dt_bias, A_log, D,
                    norm, *, conv_state, ssm_state, eps: float):
    """``mamba2_step_kernel``'s function: z (B, H, P), x (B, H P), bm and
    cm (B, G N), dt (B, H), conv_w (K, C), conv_b (C,), dt_bias, A_log
    and D (H,), norm (H, P), conv_state (B, K - 1, C) in the compute
    dtype, ssm_state (B, H, P, N) fp32. Shifts ``conv_state`` and updates
    ``ssm_state`` in place; returns the normed y (B, H, P)."""
    y, xs, _, _ = step_core_ref(x, bm, cm, dt, conv_w, conv_b, dt_bias,
                                A_log, conv_state=conv_state,
                                ssm_state=ssm_state)
    return gate_norm_ref(y, xs, z, D, norm, eps)


def _cum_in_order(t: torch.Tensor) -> torch.Tensor:
    """Inclusive sum over t's last dim, one value after another in fp32."""
    out = [t[..., 0]]
    for i in range(1, t.shape[-1]):
        out.append(out[-1] + t[..., i])
    return torch.stack(out, dim=-1)


def ssd_ref(xr, dt, A_log, Bm, Cm, state=None, *, chunk: int,
            acc: torch.dtype = torch.float32):
    """The chunked SSD before its epilogue, in ``acc`` (float32, the
    kernel's; float64 for a tolerance's magnitudes): chunks of ``chunk``
    tokens, the last padded with dt = 0 (decay 1, no input); each chunk's
    cumulative decay summed token by token, its diagonal term, and the
    state carried into it, chunk by chunk. Returns (y (B, S, H, P), the
    final state (B, H, P, N)), both in ``acc``."""
    B, S, H, P = xr.shape
    N = Bm.shape[-1]
    L = chunk
    nc = -(-S // L)
    pad = nc * L - S
    A = -torch.exp(A_log.to(acc))
    dtf = F.pad(dt.to(acc), (0, 0, 0, pad))                  # (B,Sp,H)
    xbar = F.pad(xr.to(acc), (0, 0, 0, 0, 0, pad)) * dtf[..., None]
    Bh = _groups(F.pad(Bm.to(acc), (0, 0, 0, 0, 0, pad)), H)
    Ch = _groups(F.pad(Cm.to(acc), (0, 0, 0, 0, 0, pad)), H)

    def chunks(t):                                          # (B,nc,L,...)
        return t.reshape((B, nc, L) + t.shape[2:])

    xc, Bc, Cc = chunks(xbar), chunks(Bh), chunks(Ch)
    cum = _cum_in_order(chunks(dtf * A).movedim(-1, 2))     # (B,nc,H,L)
    total = cum[..., -1]                                     # (B,nc,H)
    causal = torch.ones(L, L, dtype=torch.bool, device=xr.device).tril()
    decay = torch.exp(cum[..., :, None] - cum[..., None, :]) \
        .masked_fill(~causal, 0.0)                           # (B,nc,H,L,L)
    scores = torch.einsum("bclhn,bcmhn->bchlm", Cc, Bc) * decay
    y = torch.einsum("bchlm,bcmhp->bclhp", scores, xc)
    decay_out = torch.exp(total[..., None] - cum).movedim(2, 3)[..., None]
    summaries = torch.einsum("bclhn,bclhp->bchpn", Bc * decay_out, xc)
    run = torch.zeros((B, H, P, N), dtype=acc, device=xr.device) \
        if state is None else state.to(acc)
    prev = []
    for c in range(nc):
        prev.append(run)
        run = torch.exp(total[:, c])[..., None, None] * run + summaries[:, c]
    prev = torch.stack(prev, dim=1)                          # (B,nc,H,P,N)
    y_off = torch.einsum("bclhn,bchpn->bclhp", Cc, prev)
    y = y + torch.exp(cum).movedim(2, 3)[..., None] * y_off
    return y.reshape(B, nc * L, H, P)[:, :S], run


def ssd_chunk_ref(xr, dt, A_log, Bm, Cm, z, D, norm, state=None, *,
                  chunk: int, eps: float):
    """``ssd_chunk_kernel``'s function: xr (B, S, H, P), Bm / Cm (B, S,
    G, N), z (B, S, H, P), A_log and D (H,), norm (H, P) in the compute
    dtype, dt (B, S, H) fp32 after the softplus, state (B, H, P, N) fp32
    (overwritten with the final state) or None: :func:`ssd_ref`, then
    the epilogue. Returns (normed y (B, S, H, P) in the compute dtype,
    final state)."""
    y, run = ssd_ref(xr, dt, A_log, Bm, Cm, state, chunk=chunk)
    out = gate_norm_ref(y, xr, z, D, norm, eps)
    if state is None:
        return out, run
    state.copy_(run)
    return out, state
