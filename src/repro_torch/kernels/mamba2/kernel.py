"""CUDA Mamba2 mixer: the checked launchers of ``csrc/mamba2.cu``.

``mamba2_step_kernel``: a one-token decode step of one Mamba2 layer (the
conv over the layer's conv state, SiLU, dt's softplus, the recurrence on
the fp32 SSM state and its readout, the D skip, the gate and the norm
over P), both states updated in place, one launch. ``ssd_chunk_kernel``:
a prompt's chunked SSD from a carried state with its D skip, gate and
norm, one launch. :func:`takes_mamba2_launch` is the domain both kernels
take, decided from a config's widths and the dtype alone, so the CPU
tests reach every refusal.

No Pallas kernel is their counterpart: the reference's Mamba2 block
(``src/repro/models/mamba2.py``) is einsums and elementwise chains that
XLA fuses. Each wrapper checks shapes, dtypes and layout before it checks
the device; a CPU tensor is refused (``ops.py`` sends it to the plain
version). Each launches on the current stream, does not synchronize and
counts its launches in ``launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, device_guard, stream_handle

_LIB = "mamba2"
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_STEP_ARGS = [_P] * 15 + [_I] * 6 + [_F, _I, _P]
_CHUNK_ARGS = [_P, _L, _L] * 5 + [_P] * 6 + [_I] * 7 + [_F, _I, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_DIM = 64            # kDim in the source: P, N and the chunk at most
STATE_LANE = 16         # kLaneCols: N a whole number of these
MAX_CONV = 8            # kMaxConv: d_conv at most
TILE_LD = MAX_DIM + 4             # kLd: a staged tile's row stride
#: ssd_chunk_kernel's dynamic shared memory (kChunkSmem): six 64 x 68
#: fp32 tiles and four 64-float rows
CHUNK_SMEM = (6 * MAX_DIM * TILE_LD + 4 * MAX_DIM) * 4
GRID_YZ = 65535


def _dims_refusal(H: int, P: int, N: int, G: int) -> str | None:
    if not 1 <= P <= MAX_DIM or not STATE_LANE <= N <= MAX_DIM \
            or N % STATE_LANE:
        return (f"head dim P {P} must lie in [1, {MAX_DIM}], the state N "
                f"{N} be a multiple of {STATE_LANE} in [{STATE_LANE}, "
                f"{MAX_DIM}]")
    if G < 1 or H < G or H % G:
        return f"{H} heads are not a whole number of {G} B/C groups"
    return None


def mamba2_refusal(H: int, P: int, N: int, G: int, d_conv: int, chunk: int,
                   dtype: torch.dtype) -> str | None:
    """Why the two kernels do not take a Mamba2 layer of these widths in
    ``dtype``, or None."""
    if dtype not in _DTYPES:
        return f"float32 or bfloat16 activations, got {dtype}"
    why = _dims_refusal(H, P, N, G)
    if why:
        return why
    if not 2 <= d_conv <= MAX_CONV:
        return f"d_conv {d_conv} must lie in [2, {MAX_CONV}]"
    if not 1 <= chunk <= MAX_DIM:
        return f"chunk {chunk} must lie in [1, {MAX_DIM}]"
    return None


def takes_mamba2_launch(cfg, dtype: torch.dtype) -> bool:
    """Whether a Mamba2 layer of ``cfg`` in ``dtype`` takes the two
    kernels: a config with a Mamba2 block whose widths (heads, P, N, G,
    d_conv, chunk) and dtype :func:`mamba2_refusal` takes. Decided on the
    host before any launch; a False keeps the plain spelling."""
    s = getattr(cfg, "ssm", None)
    if cfg.family != "hybrid" or s is None:
        return False
    H = s.expand * cfg.d_model // s.head_dim
    return mamba2_refusal(H, s.head_dim, s.d_state, s.n_groups, s.d_conv,
                          s.chunk, dtype) is None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(what: str, ref: torch.Tensor, *others) -> None:
    if not ref.is_cuda or any(t is not None and t.device != ref.device
                              for t in others):
        raise ValueError(f"{what}: every tensor must be on the same CUDA "
                         f"device")


def _check_shape(what: str, name: str, t: torch.Tensor, shape: tuple):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: {name} {tuple(t.shape)} != {shape}")


def mamba2_step_kernel(z, x, bm, cm, dt, conv_w, conv_b, dt_bias, A_log, D,
                       norm, *, conv_state, ssm_state, eps: float):
    """One decode step of a Mamba2 layer, one token a row: z (B, H, P),
    the x, B and C products x (B, H P), bm and cm (B, G N), the raw dt
    (B, H), conv_w (K, C), conv_b (C,), dt_bias, A_log and D (H,), norm
    (H, P) and the conv state (B, K - 1, C) in one compute dtype (float32
    or bfloat16), the SSM state (B, H, P, N) float32, all contiguous on
    one GPU. Shifts ``conv_state`` and updates ``ssm_state`` in place
    (the same bits as ``ref.mamba2_step_ref``) and returns the normed y
    (B, H, P), within the readout's and the norm's summation orders of
    it. Every check comes before the launch. One launch of a CTA a head,
    its tickets the stream's counters (decode attention's
    ``ticket_counters``: zero between launches, each launch leaves
    them so)."""
    what = "mamba2_step_kernel"
    if z.dim() != 3 or ssm_state.dim() != 4:
        raise ValueError(f"{what}: z (B, H, P) and the SSM state (B, H, P, "
                         f"N), got {tuple(z.shape)}, "
                         f"{tuple(ssm_state.shape)}")
    B, H, P = z.shape
    N = ssm_state.shape[-1]
    GN = bm.shape[-1] if bm.dim() == 2 else -1
    G = GN // N if N and GN > 0 and GN % N == 0 else 0
    K = conv_w.shape[0] if conv_w.dim() == 2 else 0
    C = H * P + 2 * GN
    for name, t, shape in (
            ("x", x, (B, H * P)), ("bm", bm, (B, GN)), ("cm", cm, (B, GN)),
            ("dt", dt, (B, H)), ("conv_w", conv_w, (K, C)),
            ("conv_b", conv_b, (C,)), ("dt_bias", dt_bias, (H,)),
            ("A_log", A_log, (H,)), ("D", D, (H,)), ("norm", norm, (H, P)),
            ("conv_state", conv_state, (B, K - 1, C)),
            ("ssm_state", ssm_state, (B, H, P, N))):
        _check_shape(what, name, t, shape)
    why = mamba2_refusal(H, P, N, G, K, 1, z.dtype)
    if why:
        raise ValueError(f"{what}: {why}")
    tensors = (z, x, bm, cm, dt, conv_w, conv_b, dt_bias, A_log, D, norm,
               conv_state)
    if any(t.dtype != z.dtype for t in tensors) \
            or ssm_state.dtype != torch.float32:
        raise ValueError(f"{what}: every tensor in {z.dtype} but the SSM "
                         f"state in float32, got "
                         f"{[t.dtype for t in tensors + (ssm_state,)]}")
    if not all(t.is_contiguous() for t in tensors + (ssm_state,)):
        raise ValueError(f"{what}: contiguous tensors only")
    if ssm_state.data_ptr() % 16:
        raise ValueError(f"{what}: the SSM state at a 16-byte aligned "
                         f"address (the kernel copies it in bulk)")
    if B > GRID_YZ or G > GRID_YZ:
        raise ValueError(f"{what}: grid limits: batch {B}, groups {G}")
    _check_cuda(what, z, *tensors, ssm_state)
    from repro_torch.kernels.decode_attention.kernel import ticket_counters
    dev = z.device
    stream = stream_handle(dev)
    tickets = ticket_counters(dev, stream, max(B * G, 1))
    y = torch.empty_like(z)
    fn = _build.function(_LIB, "mamba2_step_launch", _STEP_ARGS)
    with device_guard(dev):
        err = fn(*(_ptr(t) for t in tensors), _ptr(ssm_state), _ptr(y),
                 _ptr(tickets), B, H, P, N, G, K, float(eps),
                 _DTYPES[z.dtype], stream)
    _build.check(_LIB, err, what)
    if B:
        mamba2_step_kernel.launches += 1
    return y


mamba2_step_kernel.launches = 0


def _check_inner(what: str, name: str, t: torch.Tensor, inner: tuple):
    """t's trailing dims ``inner`` dense (the kernel reads them at a
    token's offset + i), its batch and token strides anything."""
    want, stride = [], 1
    for n in reversed(inner):
        want.append(stride)
        stride *= n
    if tuple(t.stride()[-len(inner):]) != tuple(reversed(want)):
        raise ValueError(f"{what}: {name}'s trailing {inner} dense, got "
                         f"strides {t.stride()}")


def ssd_chunk_kernel(xr, dt, A_log, Bm, Cm, z, D, norm, state=None, *,
                     chunk: int, eps: float):
    """A prompt's SSD with its D skip, gate and norm: xr (B, S, H, P)
    after the conv and SiLU, Bm and Cm (B, S, G, N) (any batch and token
    strides, the inner two dims dense: a slice of the conv's output), z
    (B, S, H, P), A_log and D (H,) and norm (H, P) in one compute dtype
    (float32 or bfloat16); dt (B, S, H) float32 after the softplus; the
    initial SSM state (B, H, P, N) float32 contiguous, overwritten with
    the final state, or None (zeros; a new state is returned), S >= 1.
    Returns (the normed y (B, S, H, P) in the compute dtype, the final
    state): ``ref.ssd_chunk_ref``'s function, its products summed in
    another order. Chunks of ``chunk`` tokens, the last cut short. Every
    check comes before the launch. One launch."""
    what = "ssd_chunk_kernel"
    if xr.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"{what}: xr (B, S, H, P) and Bm (B, S, G, N), "
                         f"got {tuple(xr.shape)}, {tuple(Bm.shape)}")
    B, S, H, P = xr.shape
    G, N = Bm.shape[2:]
    for name, t, shape in (
            ("dt", dt, (B, S, H)), ("Bm", Bm, (B, S, G, N)),
            ("Cm", Cm, (B, S, G, N)), ("z", z, (B, S, H, P)),
            ("A_log", A_log, (H,)), ("D", D, (H,)), ("norm", norm, (H, P))):
        _check_shape(what, name, t, shape)
    if state is not None:
        _check_shape(what, "state", state, (B, H, P, N))
    if S < 1:
        raise ValueError(f"{what}: a prompt of {S} tokens")
    why = mamba2_refusal(H, P, N, G, 2, chunk, xr.dtype)
    if why:
        raise ValueError(f"{what}: {why}")
    tensors = (xr, Bm, Cm, z, A_log, D, norm)
    if any(t.dtype != xr.dtype for t in tensors) \
            or dt.dtype != torch.float32 \
            or (state is not None and state.dtype != torch.float32):
        raise ValueError(f"{what}: every tensor in {xr.dtype} but dt and "
                         f"the state in float32")
    for name, t, inner in (("xr", xr, (H, P)), ("Bm", Bm, (G, N)),
                           ("Cm", Cm, (G, N)), ("z", z, (H, P)),
                           ("dt", dt, (H,))):
        _check_inner(what, name, t, inner)
    if not all(t.is_contiguous() for t in (A_log, D, norm)) or (
            state is not None and not state.is_contiguous()):
        raise ValueError(f"{what}: A_log, D, norm and the state "
                         f"contiguous")
    if B > GRID_YZ:
        raise ValueError(f"{what}: grid limits: batch {B}")
    _check_cuda(what, xr, dt, state, *tensors)
    y = torch.empty((B, S, H, P), dtype=xr.dtype, device=xr.device)
    out = state if state is not None else torch.empty(
        (B, H, P, N), dtype=torch.float32, device=xr.device)
    fn = _build.function(_LIB, "ssd_chunk_launch", _CHUNK_ARGS)
    strided = [a for t in (xr, Bm, Cm, z, dt)
               for a in (_ptr(t), t.stride(0), t.stride(1))]
    with device_guard(xr.device):
        err = fn(*strided, _ptr(A_log), _ptr(D), _ptr(norm), _ptr(state),
                 _ptr(out), _ptr(y), B, S, H, P, N, G, chunk, float(eps),
                 _DTYPES[xr.dtype], stream_handle(xr.device))
    _build.check(_LIB, err, what)
    if B:
        ssd_chunk_kernel.launches += 1
    return y, out


ssd_chunk_kernel.launches = 0


def step_work(B: int, H: int, P: int, N: int, G: int, K: int,
              esz: int) -> tuple[int, float]:
    """(bytes, flops) the decode step needs, each input read once and each
    output written once: the fp32 state read and written, the products'
    rows, the conv's weights and state, the head parameters, y; 5 flops
    a state element (decay, input and their sum, the readout's product
    and sum), the conv's 2 K a channel, ~12 a y element."""
    C = H * P + 2 * G * N
    nbytes = 2 * B * H * P * N * 4 + esz * (
        B * (H * P + C + H) + (K + 1) * C + 3 * H + H * P
        + 2 * B * (K - 1) * C + B * H * P)
    return nbytes, float(B * (5 * H * P * N + 2 * K * C + 12 * H * P))


def chunk_work(B: int, S: int, H: int, P: int, N: int, G: int, L: int,
               esz: int) -> tuple[int, float]:
    """(bytes, flops) of a prompt's SSD: each input read once and each
    output written once (xr, z, y, dt, B and C a group, the state in and
    out), and the chunked form's four products a (row, head, chunk) of n
    tokens: the causal scores over N and their product with x over the
    chunk (n (n + 1) / 2 pairs each, 2 flops a pair and a width), the
    carried state's readout and its update (2 n P N each); the last chunk
    cut to its tokens."""
    nbytes = esz * B * S * (3 * H * P + 2 * G * N) + 4 * B * S * H \
        + 2 * 4 * B * H * P * N
    flops = 0.0
    for c0 in range(0, S, L):
        n = min(L, S - c0)
        flops += n * (n + 1) * (N + P) + 4 * n * P * N
    return nbytes, float(B * H * flops)


__all__ = ["CHUNK_SMEM", "MAX_DIM", "chunk_work", "mamba2_refusal",
           "mamba2_step_kernel", "ssd_chunk_kernel", "step_work",
           "takes_mamba2_launch"]
