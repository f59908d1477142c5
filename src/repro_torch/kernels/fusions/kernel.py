"""CUDA fusions of the paged decode step: the checked launchers of
``csrc/fusions.cu`` (the RMS norms, qkv bias + RoPE, the gated
activation); qkv bias + RoPE also as the prefill / extend chunk's launch,
a position a row, k and v written into the layer's cache at offsets read
on the device (``qkv_rope_chunk_kernel``, counted apart; both laid out by
:func:`rope_geometry`); the decode step's qkv products with bias + RoPE
in their epilogue (``qkv_proj_kernel``, planned by :func:`plan_qkv`) and
its gate and up products with the activation in theirs
(``gate_up_act_kernel``, planned by :func:`plan_gate_up`). The new
token's merge is decode attention's own, given ``new_kv``
(``paged_decode_attention_kernel``, ``csrc/decode_attention.cu``).

No Pallas kernel is their counterpart: the reference's decode step is one
XLA program (``jax.jit(PagedKVRuntime._decode_step_impl)``,
``src/repro/serving/paged_runtime.py:69``), and these are the fusions XLA
makes of its elementwise chains. Each wrapper checks shapes, dtypes,
layout and alignment before it checks the device, so the CPU tests reach
every refusal; a CPU tensor is refused (``ops.py`` sends it to the plain
version). Each launches on the current stream, does not synchronize and
counts its launches in ``launches``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build, device_guard, stream_handle
from repro_torch.models.common import _gelu_constants

_LIB = "fusions"
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_NORM_ARGS = [_P] * 5 + [_I, _I, _F] + [_I] * 5 + [_P]
_ROPE_ARGS = [_P] * 13 + [_I] * 5 + [_F] + [_I] * 3 + [_P]
_CACHE_ARGS = [_P] * 16 + [_I] * 10 + [_L, _F, _I, _P]
_QP_ARGS = [_P] * 12 + [_I] * 8 + [_F, _P]
_ACT_ARGS = [_P] * 3 + [_L, _I, _F, _F, _I, _P]
_GU_ARGS = [_P] * 3 + [_I] * 4 + [_F, _F, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256                            # kMaxHeadDim in the source
ROPE_MAX_LANES = 32                           # a head row on one warp, at most
ACTIVATIONS = ("silu", "gelu")
NORM_MAX_THREADS = 512                        # kNormMaxThreads in the source
NORM_BLOCK = 256                              # threads a block of short rows
NORM_REGISTER_CHUNKS = (1, 2, 4)              # rms_norm_kernel's CPT > 0
# the gate/up product (gate_up_kernel): columns a CTA and rows of K a
# stage (kGuBox, kGuK), threads a CTA, the ring's stages, tokens at most,
# the two tensor maps' bytes, the dynamic shared memory a CTA (kGuSmem)
GATE_UP_BOX, GATE_UP_K, GATE_UP_THREADS, GATE_UP_STAGES = 64, 64, 128, 3
GATE_UP_MAX_ROWS = 16
GATE_UP_MAP_BYTES = 256
GATE_UP_SMEM = 1024 + GATE_UP_STAGES * (2 * GATE_UP_BOX + 16) \
    * GATE_UP_K * 2 + 8 * GATE_UP_STAGES
#: CTAs an SM holds (its shared memory)
GATE_UP_CTAS_PER_SM = 3
# the qkv pass (qkv_proj_kernel): columns a TMA box and rows of K a stage
# (kQpBox, kQpK), tokens at most, the cluster splits the plan takes (at
# most kQpMaxSplit), the three tensor maps' bytes
QKV_BOX, QKV_K, QKV_MAX_ROWS = 64, 64, 16
QKV_SPLITS = (1, 2, 4, 8)
#: K tiles a rank streams at least: fewer leave a rank's fixed costs
#: (its first loads, the cluster barrier, the epilogue) over too little
#: streaming (launch/qkv_probes.py)
QKV_MIN_TILES = 6
QKV_MAP_BYTES = 384
SMEM_PER_BLOCK = 232_448          # bytes of shared memory a Hopper block
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class NormGeometry:
    """The norm's launch for rows of one length: ``row_threads`` threads a
    row (a multiple of 32), thread t summing the row's 16-byte chunks t, t
    + row_threads, ... in that order; ``chunks_per_thread`` of them held
    in registers (0: streamed, the row read twice); ``rows_per_block``
    rows a block of ``threads``."""
    row_threads: int
    chunks_per_thread: int
    rows_per_block: int
    threads: int


@functools.lru_cache(maxsize=None)
def norm_geometry(D: int, element_size: int) -> NormGeometry:
    """The norm kernel's launch for rows of ``D`` elements of
    ``element_size`` bytes: a function of the row alone, so a row's sum
    runs in one order whatever the batch. Up to 64 chunks, one warp (the
    qkv kernel's qk norm sums a head row in the same order); past that one
    thread a chunk, at most 512 a row, each taking up to 4 chunks; past
    2048 chunks 512 threads stream the row. Rows of at most 128 threads
    share a block of 256. Raises ``ValueError`` for a row that is not a
    whole number of 16-byte chunks."""
    if D < 1 or (D * element_size) % 16:
        raise ValueError(f"rms_norm_kernel: rows of {D} elements of "
                         f"{element_size} bytes are not a whole number of "
                         f"16-byte chunks")
    chunks = D * element_size // 16
    if chunks <= 64:
        rt, cpt = 32, math.ceil(chunks / 32)
    else:
        cpt = math.ceil(chunks / NORM_MAX_THREADS)
        rt = 32 * math.ceil(math.ceil(chunks / cpt) / 32)
    if cpt not in NORM_REGISTER_CHUNKS:
        cpt = next((c for c in NORM_REGISTER_CHUNKS if c >= cpt), 0)
    rows = max(1, NORM_BLOCK // rt)
    return NormGeometry(row_threads=rt, chunks_per_thread=cpt,
                        rows_per_block=rows, threads=rt * rows)


@dataclasses.dataclass(frozen=True)
class RopeGeometry:
    """The qkv row pass's layout for head rows of one shape: a row's
    16-byte chunks on ``row_threads`` lanes of one warp (the power of two
    at or above the chunk count); the RoPE partner channel from another
    lane's registers (``"lanes"``: rot_half a whole number of chunks) or
    from a copy of the row in shared memory (``"shared"``)."""
    row_threads: int
    partner: str


def _row_pass_refusal(Dh: int, rot_half: int,
                      element_size: int) -> str | None:
    """Why the row pass does not take head rows of ``Dh`` elements of
    ``element_size`` bytes rotating ``2 rot_half`` channels, or None."""
    if not 1 <= Dh <= MAX_HEAD_DIM or (Dh * element_size) % 16:
        return (f"qkv_rope_kernel: head rows of {Dh} elements of "
                f"{element_size} bytes must be a multiple of 16 bytes, head "
                f"dim at most {MAX_HEAD_DIM}")
    chunks = Dh * element_size // 16
    if chunks > ROPE_MAX_LANES:
        return (f"qkv_rope_kernel: head rows of {chunks} 16-byte chunks; "
                f"one warp takes at most {ROPE_MAX_LANES}")
    if not 0 <= 2 * rot_half <= Dh:
        return f"qkv_rope_kernel: rot/2 {rot_half} for head dim {Dh}"
    return None


@functools.lru_cache(maxsize=None)
def rope_geometry(Dh: int, rot_half: int, element_size: int) -> RopeGeometry:
    """The row pass's layout for head rows of ``Dh`` elements of
    ``element_size`` bytes rotating their leading ``2 rot_half`` channels:
    a function of the shape alone (the qk norm's sum runs in one order
    whatever the batch). Raises ``ValueError`` for a row that is not a
    whole number of 16-byte chunks or is longer than one warp's lanes take
    (32 chunks: 256 bf16 or 128 fp32 elements)."""
    why = _row_pass_refusal(Dh, rot_half, element_size)
    if why:
        raise ValueError(why)
    chunks = Dh * element_size // 16
    return RopeGeometry(
        row_threads=1 << (chunks - 1).bit_length(),
        partner="lanes" if (rot_half * element_size) % 16 == 0 else "shared")


def takes_row_pass(Dh: int, rot_half: int, element_size: int) -> bool:
    """Whether the row pass (and so ``qkv_proj``'s routes) takes head rows
    of ``Dh`` elements of ``element_size`` bytes rotating ``2 rot_half``
    channels: :func:`rope_geometry`'s conditions, as a shape rule decided
    on the host (gemma2's fp32 Dh 256, 64 chunks a row, is not taken)."""
    return _row_pass_refusal(Dh, rot_half, element_size) is None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_dtype(what: str, ref: torch.Tensor, *others) -> None:
    if ref.dtype not in _DTYPES:
        raise ValueError(f"{what}: float32 or bfloat16, got {ref.dtype}")
    for t in others:
        if t is not None and t.dtype != ref.dtype:
            raise ValueError(f"{what}: every tensor in {ref.dtype}, got "
                             f"{t.dtype}")


def _check_rows(what: str, n: int, *tensors) -> None:
    """Contiguous tensors of 16-byte rows of ``n`` elements at 16-byte
    aligned addresses: the kernels move 16 bytes a load."""
    for t in tensors:
        if t is None:
            continue
        if not t.is_contiguous():
            raise ValueError(f"{what}: contiguous tensors only")
        if (n * t.element_size()) % 16 or t.data_ptr() % 16:
            raise ValueError(
                f"{what}: rows of {n} {t.dtype} elements must be a multiple "
                f"of 16 bytes at 16-byte aligned addresses")


def _check_cuda(what: str, ref: torch.Tensor, *others) -> None:
    if not ref.is_cuda or any(t is not None and t.device != ref.device
                              for t in others):
        raise ValueError(f"{what}: every tensor must be on the same CUDA "
                         f"device")


def rms_norm_kernel(x, scale, eps: float, delta=None,
                    fp32_sum: bool = False):
    """x (..., D) and ``scale`` (D,) in float32 or bfloat16 on the GPU.
    Returns ``rms_norm(x, scale, eps)``, or with ``delta`` (x's shape)
    ``(x + delta, norm)`` where the norm reads the sum in fp32
    (``fp32_sum``) or rounded to x's dtype, as ``ref.rms_norm_ref``. One
    launch, shaped by :func:`norm_geometry` of D alone."""
    what = "rms_norm_kernel"
    D = x.shape[-1]
    _check_dtype(what, x, scale, delta)
    if tuple(scale.shape) != (D,) or (delta is not None
                                      and delta.shape != x.shape):
        raise ValueError(f"{what}: scale {tuple(scale.shape)}, delta "
                         f"{None if delta is None else tuple(delta.shape)} "
                         f"for x {tuple(x.shape)}")
    _check_rows(what, D, x, scale, delta)
    # an empty x launches nothing (the source returns at 0 rows)
    geo = norm_geometry(D, x.element_size()) if x.numel() else \
        NormGeometry(0, 0, 0, 0)
    _check_cuda(what, x, scale, delta)
    h = torch.empty_like(x)
    x_out = None if delta is None else torch.empty_like(x)
    # the source's modes: 0 the norm alone, 1 the fp32 sum, 2 the rounded
    mode = 0 if delta is None else 1 if fp32_sum else 2
    fn = _build.function(_LIB, "rms_norm_launch", _NORM_ARGS)
    with device_guard(x.device):
        err = fn(_ptr(x), _ptr(delta), _ptr(scale), _ptr(x_out), _ptr(h),
                 x.numel() // D if x.numel() else 0, D, float(eps), mode,
                 geo.row_threads, geo.chunks_per_thread, geo.rows_per_block,
                 _DTYPES[x.dtype], stream_handle(x.device))
    _build.check(_LIB, err, what)
    if x.numel():
        rms_norm_kernel.launches += 1
    return h if delta is None else (x_out, h)


rms_norm_kernel.launches = 0


def _check_aligned(what: str, *tensors) -> None:
    for t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors at 16-byte aligned addresses "
                             f"(the kernels move 16 bytes a load)")


def _check_rope_rows(what: str, q, k, v, bias, norm, rope, outs,
                     tab_rows) -> tuple[int, RopeGeometry]:
    """The checks both qkv launches share: q (N, H, Dh), k and v (N, KV,
    Dh); biases (H, Dh), (KV, Dh), (KV, Dh); norm scales (Dh,); fp32
    tables (rows, rot/2) of ``tab_rows`` rows (any leading shape), rot <=
    Dh; one dtype, contiguous and 16-byte aligned, head rows the row
    pass's :func:`rope_geometry` takes, on one CUDA device (``outs`` too,
    checked by the caller for shape). Returns rot/2 and the geometry."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"{what}: q (N, H, Dh), k and v (N, KV, Dh), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    N, H, Dh = q.shape
    if k.shape[0] != N or k.shape[2] != Dh or not 1 <= Dh <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: q {tuple(q.shape)}, k {tuple(k.shape)}; "
                         f"head dim at most {MAX_HEAD_DIM}")
    bq, bk, bv = bias if bias is not None else (None, None, None)
    qn, kn = norm if norm is not None else (None, None)
    if bias is not None and (bq.shape != q.shape[1:]
                             or bk.shape != k.shape[1:]
                             or bv.shape != k.shape[1:]):
        raise ValueError(f"{what}: biases (H, Dh), (KV, Dh), (KV, Dh)")
    if norm is not None and (tuple(qn.shape) != (Dh,)
                             or tuple(kn.shape) != (Dh,)):
        raise ValueError(f"{what}: norm scales (Dh,)")
    _check_dtype(what, q, k, v, bq, bk, bv, qn, kn, *outs)
    cos = sin = None
    rot_half = 0
    if rope is not None:
        cos, sin = rope
        rot_half = cos.shape[-1]
        if cos.dtype != torch.float32 or sin.shape != cos.shape \
                or sin.dtype != torch.float32 \
                or cos.numel() != tab_rows * rot_half or 2 * rot_half > Dh:
            raise ValueError(f"{what}: rope tables fp32 of {tab_rows} rows "
                             f"of rot/2 with rot <= Dh, got "
                             f"{tuple(cos.shape)} {cos.dtype}")
    geo = rope_geometry(Dh, rot_half, q.element_size())
    for t in (q, k, v, bq, bk, bv, qn, kn, cos, sin, *outs):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{what}: contiguous tensors only")
    _check_aligned(what, q, k, v, bq, bk, bv, qn, kn, *outs)
    if geo.partner == "lanes":     # a chunk's table entries: 16-byte loads
        _check_aligned(what, cos, sin)
    _check_cuda(what, q, k, v, bq, bk, bv, qn, kn, cos, sin, *outs)
    return rot_half, geo


def _rope_ptrs(bias, norm, rope) -> list:
    bq, bk, bv = bias if bias is not None else (None, None, None)
    qn, kn = norm if norm is not None else (None, None)
    cos, sin = rope if rope is not None else (None, None)
    return [_ptr(t) for t in (bq, bk, bv, qn, kn, cos, sin)]


def qkv_rope_kernel(q, k, v, *, k_out, v_out, bias=None, norm=None,
                    eps: float = 0.0, rope=None):
    """One token's projections q (B, H, Dh), k and v (B, KV, Dh) on the
    GPU, contiguous, in float32 or bfloat16; ``bias = (bq (H, Dh), bk, bv
    (KV, Dh))``, ``norm = (q_norm, k_norm)`` (Dh,) and ``rope = (cos,
    sin)`` fp32 (B, 1, rot/2), each optional. Writes k and v into
    ``k_out``, ``v_out`` (B, KV, Dh) and returns q (B, H, Dh): the same
    bits as ``ref.qkv_rope_ref`` (the norm within its one-ulp order). One
    launch of the row pass, laid out by :func:`rope_geometry`."""
    what = "qkv_rope_kernel"
    if q.dim() == 3 and (k_out.shape != k.shape or v_out.shape != k.shape):
        raise ValueError(f"{what}: k {tuple(k.shape)}, outputs "
                         f"{tuple(k_out.shape)} / {tuple(v_out.shape)}")
    rot_half, geo = _check_rope_rows(what, q, k, v, bias, norm, rope,
                                     (k_out, v_out), q.shape[0])
    B, H, Dh = q.shape
    q_out = torch.empty_like(q)
    fn = _build.function(_LIB, "qkv_rope_launch", _ROPE_ARGS)
    bq, bk, bv, qn, kn, cos, sin = _rope_ptrs(bias, norm, rope)
    with device_guard(q.device):
        err = fn(_ptr(q), _ptr(k), _ptr(v), bq, bk, bv, qn, kn, cos, sin,
                 _ptr(q_out), _ptr(k_out), _ptr(v_out), B, H, k.shape[1],
                 Dh, rot_half, float(eps), geo.row_threads,
                 int(geo.partner == "shared"), _DTYPES[q.dtype],
                 stream_handle(q.device))
    _build.check(_LIB, err, what)
    if B:
        qkv_rope_kernel.launches += 1
    return q_out


qkv_rope_kernel.launches = 0


def qkv_rope_chunk_kernel(q, k, v, *, cache_k, cache_v, offsets,
                          k_rows=None, v_rows=None, bias=None, norm=None,
                          eps: float = 0.0, rope=None):
    """A chunk's projections, ``qkv_rope_kernel``'s chain at a position a
    row, with k and v written into the layer's cache: q (N, H, Dh), k and
    v (N, KV, Dh) the chunk's N = nb * C rows (sequence s's C tokens at
    rows s * C ...), contiguous, in float32 or bfloat16; ``cache_k``,
    ``cache_v`` (nb, T, KV, Dh) in q's dtype, each sequence's (T, KV, Dh)
    contiguous, T >= C; ``offsets`` a contiguous int32 (nb,) tensor on
    the device; ``rope = (cos, sin)`` fp32 tables of N rows (a position a
    row) or C (the positions the sequences share), each (..., rot/2).
    Row c of sequence s lands in slot ``clamp(offsets[s], 0, T - C) + c``
    (``attention.write_cache``'s clamp), read on the device, and in
    ``k_rows`` / ``v_rows`` (N, KV, Dh) where given. Returns q (N, H,
    Dh): the same bits as ``ref.qkv_rope_chunk_ref``, the norm within
    its one-ulp order. Every check comes before the launch. One launch."""
    what = "qkv_rope_chunk_kernel"
    if cache_k.dim() != 4 or cache_v.shape != cache_k.shape \
            or cache_v.stride() != cache_k.stride() or q.dim() != 3 \
            or k.dim() != 3 or cache_k.shape[2:] != k.shape[1:]:
        raise ValueError(f"{what}: caches (nb, T, KV, Dh) of one layout for "
                         f"k {tuple(k.shape)}, got {tuple(cache_k.shape)} / "
                         f"{tuple(cache_v.shape)}")
    nb, T, KV, Dh = cache_k.shape
    N = q.shape[0]
    if not nb or N % nb or T < N // nb:
        raise ValueError(f"{what}: {N} rows are not {nb} sequences of C <= "
                         f"T = {T} tokens")
    C = N // nb
    if cache_k.stride()[1:] != (KV * Dh, Dh, 1):
        raise ValueError(f"{what}: each sequence's cache (T, KV, Dh) "
                         f"contiguous, got strides {cache_k.stride()}")
    if not isinstance(offsets, torch.Tensor) \
            or offsets.dtype != torch.int32 or offsets.shape != (nb,) \
            or not offsets.is_contiguous():
        raise ValueError(f"{what}: offsets a contiguous int32 ({nb},) "
                         f"tensor, got {offsets!r}")
    if (k_rows is None) != (v_rows is None) or (
            k_rows is not None and (k_rows.shape != k.shape
                                    or v_rows.shape != k.shape)):
        raise ValueError(f"{what}: k_rows and v_rows both (N, KV, Dh) or "
                         f"neither")
    tab_rows = 0
    if rope is not None:
        tab_rows = rope[0].numel() // max(rope[0].shape[-1], 1)
        if tab_rows not in (N, C):
            raise ValueError(f"{what}: rope tables of {N} or {C} rows, got "
                             f"{tuple(rope[0].shape)}")
    _check_dtype(what, q, cache_k, cache_v)
    rot_half, geo = _check_rope_rows(what, q, k, v, bias, norm, rope,
                                     (k_rows, v_rows), tab_rows)
    if cache_k.data_ptr() % 16 or cache_v.data_ptr() % 16 \
            or (cache_k.stride(0) * cache_k.element_size()) % 16:
        raise ValueError(f"{what}: caches at 16-byte aligned addresses, "
                         f"their sequences a multiple of 16 bytes apart")
    _check_cuda(what, q, cache_k, cache_v, offsets)
    q_out = torch.empty_like(q)
    fn = _build.function(_LIB, "qkv_rope_cache_launch", _CACHE_ARGS)
    bq, bk, bv, qn, kn, cos, sin = _rope_ptrs(bias, norm, rope)
    with device_guard(q.device):
        err = fn(_ptr(q), _ptr(k), _ptr(v), bq, bk, bv, qn, kn, cos, sin,
                 _ptr(q_out), _ptr(cache_k), _ptr(cache_v), _ptr(k_rows),
                 _ptr(v_rows), _ptr(offsets), N, q.shape[1], KV, Dh,
                 rot_half, tab_rows, geo.row_threads,
                 int(geo.partner == "shared"), C, T, cache_k.stride(0),
                 float(eps), _DTYPES[q.dtype], stream_handle(q.device))
    _build.check(_LIB, err, what)
    if N:
        qkv_rope_chunk_kernel.launches += 1
    return q_out


qkv_rope_chunk_kernel.launches = 0


def gated_act_kernel(gate, up, activation: str):
    """``act(gate) * up`` for ``activation`` "silu" or "gelu" (tanh),
    gate and up of one shape in float32 or bfloat16 on the GPU, bit-equal
    to ``ref.gated_act_ref``. One launch."""
    what = "gated_act_kernel"
    if activation not in ACTIVATIONS:
        raise ValueError(f"{what}: activation {activation!r} not in "
                         f"{ACTIVATIONS}")
    if gate.shape != up.shape:
        raise ValueError(f"{what}: gate {tuple(gate.shape)} and up "
                         f"{tuple(up.shape)} differ")
    _check_dtype(what, gate, up)
    _check_rows(what, gate.shape[-1] if gate.dim() else 1, gate, up)
    _check_cuda(what, gate, up)
    out = torch.empty_like(gate)
    k, c = _gelu_constants(gate.dtype)
    fn = _build.function(_LIB, "gated_act_launch", _ACT_ARGS)
    with device_guard(gate.device):
        err = fn(_ptr(gate), _ptr(up), _ptr(out), gate.numel(),
                 int(activation == "gelu"), k, c, _DTYPES[gate.dtype],
                 stream_handle(gate.device))
    _build.check(_LIB, err, what)
    if gate.numel():
        gated_act_kernel.launches += 1
    return out


gated_act_kernel.launches = 0


@dataclasses.dataclass(frozen=True)
class GateUpPlan:
    """The gate/up product's launch: ``tiles`` CTAs, one a GATE_UP_BOX
    column tile of w1 and w3, each streaming ``k_tiles`` pieces of
    GATE_UP_K rows of K, ``token_tiles`` 8-row tiles of tokens (the mma's
    N side), in ``waves`` waves of GATE_UP_CTAS_PER_SM CTAs an SM."""
    tiles: int
    k_tiles: int
    token_tiles: int
    waves: int


@functools.lru_cache(maxsize=256)
def plan_gate_up(rows: int, d_model: int, d_ff: int,
                 sms: int = H100_SMS) -> GateUpPlan:
    """The gate/up product's launch for ``rows`` tokens of ``d_model``
    against (d_model, d_ff) weights on a card of ``sms`` SMs. Every sum
    runs over all of K in one CTA, so a token's bits do not depend on
    ``rows``. Raises ``ValueError`` on what the kernel does not take."""
    if not 1 <= rows <= GATE_UP_MAX_ROWS:
        raise ValueError(f"gate_up_act_kernel: {rows} token rows, the kernel "
                         f"takes 1 to {GATE_UP_MAX_ROWS}")
    if d_model < 8 or d_model % 8 or d_ff < 8 or d_ff % 8:
        raise ValueError(f"gate_up_act_kernel: d_model {d_model} and d_ff "
                         f"{d_ff} must be multiples of 8 (16-byte rows)")
    tiles = -(-d_ff // GATE_UP_BOX)
    return GateUpPlan(tiles=tiles, k_tiles=-(-d_model // GATE_UP_K),
                      token_tiles=1 if rows <= 8 else 2,
                      waves=-(-tiles // (sms * GATE_UP_CTAS_PER_SM)))


#: (device index, w1's and w3's addresses, their shape) -> the encoded
#: tensor maps (host bytes), made once a weight address
_GATE_UP_MAPS: dict[tuple, ctypes.Array] = {}


def _gate_up_maps(w1, w3) -> ctypes.Array:
    key = (w1.device.index, w1.data_ptr(), w3.data_ptr(), *w1.shape)
    maps = _GATE_UP_MAPS.get(key)
    if maps is None:
        maps = ctypes.create_string_buffer(GATE_UP_MAP_BYTES)
        fn = _build.function(_LIB, "gate_up_maps", [_P, _P, _I, _I, _P])
        with device_guard(w1.device):
            err = fn(w1.data_ptr(), w3.data_ptr(), w1.shape[0], w1.shape[1],
                     ctypes.addressof(maps))
        _build.check(_LIB, err, "gate_up_act_kernel: tensor maps")
        _GATE_UP_MAPS[key] = maps
    return maps


def takes_gate_up(x) -> bool:
    """Whether the fused decode step's FFN runs ``x``'s gated product as
    :func:`gate_up_act_kernel`: bf16 on the card, at most GATE_UP_MAX_ROWS
    tokens. Anything else (fp32, a chunk's rows) keeps the products and
    ``gated_act_kernel``. A host decision on shapes, made before any
    capture."""
    rows = x.numel() // x.shape[-1] if x.dim() else 0
    return x.is_cuda and x.dtype == torch.bfloat16 \
        and 1 <= rows <= GATE_UP_MAX_ROWS


def gate_up_act_kernel(x, w1, w3, activation: str):
    """``act(x @ w1) * (x @ w3)`` for x (..., d_model) of at most
    GATE_UP_MAX_ROWS tokens and w1, w3 (d_model, d_ff) as stored, all
    bf16, contiguous and 16-byte aligned on one GPU; ``activation`` "silu"
    or "gelu" (tanh). Each product is an fp32 sum rounded once to bf16, in
    an order fixed by d_model (:func:`plan_gate_up`), not by the batch;
    the activation and the product with up are ``ref.gated_act_ref``'s
    ops. Returns (..., d_ff). Every check comes before the launch. One
    launch."""
    what = "gate_up_act_kernel"
    if activation not in ACTIVATIONS:
        raise ValueError(f"{what}: activation {activation!r} not in "
                         f"{ACTIVATIONS}")
    if w1.dim() != 2 or w3.shape != w1.shape or x.dim() < 1 \
            or x.shape[-1] != w1.shape[0]:
        raise ValueError(f"{what}: x (..., d_model) against w1 and w3 "
                         f"(d_model, d_ff), got {tuple(x.shape)}, "
                         f"{tuple(w1.shape)}, {tuple(w3.shape)}")
    for t in (x, w1, w3):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: bfloat16 tensors only, got {t.dtype}")
    K, N = w1.shape
    _check_rows(what, K, x)
    _check_rows(what, N, w1, w3)
    plan_gate_up(x.numel() // K, K, N)
    _check_cuda(what, x, w1, w3)
    out = x.new_empty((*x.shape[:-1], N))
    maps = _gate_up_maps(w1, w3)
    k, c = _gelu_constants(x.dtype)
    fn = _build.function(_LIB, "gate_up_launch", _GU_ARGS)
    with device_guard(x.device):
        err = fn(ctypes.addressof(maps), _ptr(x), _ptr(out), x.numel() // K,
                 K, N, int(activation == "gelu"), k, c,
                 stream_handle(x.device))
    _build.check(_LIB, err, what)
    gate_up_act_kernel.launches += 1
    return out


gate_up_act_kernel.launches = 0


@dataclasses.dataclass(frozen=True)
class QkvPlan:
    """The decode step's qkv launch: ``head_rows`` (H + 2 KV) clusters of
    ``split`` CTAs, rank r of a head row streaming its share of the
    ``k_tiles`` QKV_K-row pieces of K through ``boxes`` QKV_BOX-column
    TMA boxes, ``token_tiles`` 8-row tiles of tokens (the mma's N side);
    ``ctas`` in all."""
    head_rows: int
    split: int
    k_tiles: int
    boxes: int
    token_tiles: int
    ctas: int


@functools.lru_cache(maxsize=256)
def plan_qkv(rows: int, d_model: int, H: int, KV: int, Dh: int,
             sms: int = H100_SMS, *, rot_half: int = 0) -> QkvPlan:
    """The qkv launch for ``rows`` tokens of ``d_model`` against wq (d_model,
    H, Dh), wk and wv (d_model, KV, Dh), rotating ``2 rot_half`` channels,
    on a card of ``sms`` SMs. A head row is a tile (its epilogue needs the
    whole row), so K is split over a cluster of ``split`` CTAs: the
    largest of QKV_SPLITS with (H + 2 KV) x split at most one CTA an SM
    and at least QKV_MIN_TILES K tiles a rank (qwen2-1.5b: 4 x 16 CTAs of
    6 tiles). A function of the shapes alone, so a token's sums run in
    one order at every batch. Raises ``ValueError`` on what the kernel
    does not take (the decode step then keeps the three products and the
    row pass)."""
    what = "qkv_proj_kernel"
    if not 1 <= rows <= QKV_MAX_ROWS:
        raise ValueError(f"{what}: {rows} token rows, the kernel takes 1 "
                         f"to {QKV_MAX_ROWS}")
    if d_model < 8 or d_model % 8:
        raise ValueError(f"{what}: d_model {d_model} must be a multiple of "
                         f"8 (16-byte rows)")
    if Dh not in (QKV_BOX, 2 * QKV_BOX, 4 * QKV_BOX):
        raise ValueError(f"{what}: head dim {Dh}: a head row is 1, 2 or 4 "
                         f"boxes of {QKV_BOX} columns")
    if rot_half % 8 or not 0 <= 2 * rot_half <= Dh:
        raise ValueError(f"{what}: rot/2 {rot_half} must be a whole number "
                         f"of 8-channel chunks within the head dim {Dh}")
    if H < 1 or KV < 1:
        raise ValueError(f"{what}: {H} query heads, {KV} KV heads")
    head_rows = H + 2 * KV
    k_tiles = -(-d_model // QKV_K)
    split = max(s for s in QKV_SPLITS
                if s == 1 or (head_rows * s <= sms
                              and s * QKV_MIN_TILES <= k_tiles))
    return QkvPlan(head_rows=head_rows, split=split, k_tiles=k_tiles,
                   boxes=Dh // QKV_BOX, token_tiles=1 if rows <= 8 else 2,
                   ctas=head_rows * split)


#: (device index, the three weights' addresses, their shapes) -> the
#: encoded tensor maps (host bytes), made once a weight address
_QKV_MAPS: dict[tuple, ctypes.Array] = {}


def _qkv_maps(wq, wk, wv) -> ctypes.Array:
    key = (wq.device.index, wq.data_ptr(), wk.data_ptr(), wv.data_ptr(),
           *wq.shape, *wk.shape)
    maps = _QKV_MAPS.get(key)
    if maps is None:
        maps = ctypes.create_string_buffer(QKV_MAP_BYTES)
        D, H, Dh = wq.shape
        fn = _build.function(_LIB, "qkv_proj_maps", [_P] * 3 + [_I] * 4
                             + [_P])
        with device_guard(wq.device):
            err = fn(wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), D, H,
                     wk.shape[1], Dh, ctypes.addressof(maps))
        _build.check(_LIB, err, "qkv_proj_kernel: tensor maps")
        _QKV_MAPS[key] = maps
    return maps


def takes_qkv_proj(x, wq, wk, rope=None) -> bool:
    """Whether the fused decode step's qkv pass runs as
    :func:`qkv_proj_kernel`: bf16 on the card, 1 to QKV_MAX_ROWS tokens
    of plain (not DTensor) weights whose shapes :func:`plan_qkv` takes.
    Anything else (fp32, more tokens, a chunk's rows, a mesh, a head dim
    of no whole boxes) keeps the three products and the row pass. A host
    decision on shapes, made before any capture."""
    from torch.distributed.tensor import DTensor
    rows = x.numel() // x.shape[-1] if x.dim() else 0
    if not (x.is_cuda and x.dtype == torch.bfloat16 and wq.dim() == 3
            and not isinstance(wq, DTensor)):
        return False
    rot_half = 0 if rope is None else rope[0].shape[-1]
    try:
        plan_qkv(rows, wq.shape[0], wq.shape[1], wk.shape[1], wq.shape[2],
                 rot_half=rot_half)
    except ValueError:
        return False
    return True


def qkv_proj_kernel(x, wq, wk, wv, *, k_out, v_out, bias=None, norm=None,
                    eps: float = 0.0, rope=None):
    """The decode step's q, k and v of x (B, 1, d_model) (or (B,
    d_model)), B <= QKV_MAX_ROWS, against wq (d_model, H, Dh), wk and wv
    (d_model, KV, Dh) as stored, then the row pass's chain: ``bias``,
    ``norm`` and ``rope`` (fp32 (B, 1, rot/2) tables) as
    :func:`qkv_rope_kernel` takes them. All bf16, contiguous and 16-byte
    aligned on one GPU. Each projection is an fp32 sum rounded once to
    bf16, in an order fixed by the shapes (:func:`plan_qkv`), not by the
    batch. Writes k and v into ``k_out``, ``v_out`` (B, KV, Dh) and
    returns q (B, H, Dh). Every check comes before the launch. One
    launch."""
    what = "qkv_proj_kernel"
    if wq.dim() != 3 or wk.dim() != 3 or wv.shape != wk.shape \
            or wk.shape[0] != wq.shape[0] or wk.shape[2] != wq.shape[2] \
            or x.dim() < 1 or x.shape[-1] != wq.shape[0]:
        raise ValueError(f"{what}: x (..., d_model) against wq (d_model, "
                         f"H, Dh), wk and wv (d_model, KV, Dh), got "
                         f"{tuple(x.shape)}, {tuple(wq.shape)}, "
                         f"{tuple(wk.shape)}, {tuple(wv.shape)}")
    D, H, Dh = wq.shape
    KV = wk.shape[1]
    B = x.numel() // D
    if k_out.shape != (B, KV, Dh) or v_out.shape != (B, KV, Dh):
        raise ValueError(f"{what}: outputs ({B}, {KV}, {Dh}), got "
                         f"{tuple(k_out.shape)} / {tuple(v_out.shape)}")
    for t in (x, wq, wk, wv, k_out, v_out):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{what}: bfloat16 tensors only, got {t.dtype}")
    plan = plan_qkv(B, D, H, KV, Dh,
                    rot_half=0 if rope is None else rope[0].shape[-1])
    _check_rows(what, D, x)
    for t in (wq, wk, wv):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: weights contiguous at 16-byte aligned "
                             f"addresses")
    q_rows = x.new_empty((B, H, Dh))
    rot_half, _ = _check_rope_rows(what, q_rows, k_out, v_out, bias, norm,
                                   rope, (), B)
    _check_cuda(what, x, wq, wk, wv, k_out, v_out)
    maps = _qkv_maps(wq, wk, wv)
    fn = _build.function(_LIB, "qkv_proj_launch", _QP_ARGS)
    bq, bk, bv, qn, kn, cos, sin = _rope_ptrs(bias, norm, rope)
    with device_guard(x.device):
        err = fn(ctypes.addressof(maps), _ptr(x), bq, bk, bv, qn, kn, cos,
                 sin, _ptr(q_rows), _ptr(k_out), _ptr(v_out), B, D, H, KV,
                 Dh, rot_half, B if rope is not None else 0, plan.split,
                 float(eps), stream_handle(x.device))
    _build.check(_LIB, err, what)
    qkv_proj_kernel.launches += 1
    return q_rows


qkv_proj_kernel.launches = 0


def empty_kernel_launch(device) -> None:
    """One launch of an empty kernel on ``device``'s current stream: the
    floor a launch (a graph node) costs, timed beside the norm. It runs no
    function of the port and counts no launch."""
    fn = _build.function(_LIB, "empty_launch", [_P])
    with device_guard(device):
        err = fn(stream_handle(device))
    _build.check(_LIB, err, "empty_kernel_launch")
