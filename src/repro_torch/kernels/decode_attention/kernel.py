"""CUDA paged decode attention: the checked launcher of
``csrc/decode_attention.cu``, the port of the Pallas
``paged_decode_attention_kernel`` (``src/repro/kernels/decode_attention/
kernel.py``).

The kernel is split-KV: one thread block a (split, KV head, row), each
split ``split_pages(page)`` whole pages of the row's live tokens; the
block that finishes a row's splits last (a ticket counter a (row, KV
head)) merges them in split order, in the same launch: one launch a
call. bf16 at the head dims of ``TC_HEAD_DIMS`` runs the splits on the
tensor cores, fp32 and other head dims on the CUDA cores. With ``new_kv``
the merge also takes the decode step's new token exactly (the fusion XLA
makes of that merge in the reference's decode scan). See the source for
its bound and design. :func:`plan_decode` is the host side of the launch
as a pure function of integers, so the CPU tests reach it;
:func:`ticket_counters` keeps the counters.

:func:`dense_decode_attention_kernel` is the same launch over a layer's
dense ``(B, T, KV, D)`` cache (``Model.forward``'s one-token step: the
reference's ``attend_decode`` at C == 1, which XLA fuses), read by its
strides, each row's length from the step's device offsets, with gemma2's
tanh softcap; :func:`plan_dense_decode` is its host side.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build, device_guard, stream_handle
from repro_torch.kernels.decode_attention.ref import SPLIT_TOKENS

_LIB = "decode_attention"
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + \
    [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_DENSE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
    [ctypes.c_longlong] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int] + \
    [ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SMEM_PER_BLOCK = 232_448      # bytes of shared memory a Hopper block may use
# constants of the source: threads (warps) a block, K/V stages in flight,
# bytes of K (and of V) a stage, tokens a stage at most
THREADS, STAGES, STAGE_BYTES, MAX_TILE = 256, 3, 32768, 64
MAX_HEAD_DIM = 256
HEAD_GROUPS = (1, 2, 4, 8, 16)   # the CUDA-core kernel's bounds on G
# bf16 at these head dims runs the tensor-core split kernel (kTcThreads
# threads, kTcTile tokens a stage, rows padded by 8 elements); the rest
# the CUDA-core one
TC_HEAD_DIMS = (16, 64, 80, 128, 256)
TC_THREADS, TC_TILE = 128, 64
# the merge's shared scratch (kMergeSmemBytes: three rows of 16 heads, the
# weights of kCombineChunk = 64 splits, the row's sums and q's rows, kMaxGD
# = 2048 elements each, the new token's k and v, 256 each, and the bulk
# copy's mbarrier; the staged records follow it)
MAX_GD = 2048
MERGE_SMEM = 4 * (3 * 16 + 64 * 16 + 2 * MAX_GD + 2 * 256) + 16
#: ticket counters (int32, one a (row, KV head)) a stream takes at least,
#: out of a device's arena of ARENA_COUNTERS
MIN_COUNTERS, ARENA_COUNTERS = 4096, 1 << 16


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """The launch of one call: ``split_pages`` pages a split,
    ``max_splits`` split blocks a (row, KV head) of the tensor-core or
    the CUDA-core kernel, ``tile`` tokens a K/V stage, ``smem_bytes`` of
    dynamic shared memory a block (its ring, the warps' merge, then the
    row's merge), a workspace of ``workspace_floats`` fp32 and
    ``counters`` int32 tickets, one a (row, KV head)."""
    split_pages: int
    max_splits: int
    tensor_cores: bool
    tile: int
    smem_bytes: int
    workspace_floats: int
    counters: int
    grid: tuple[int, int, int]


def record_floats(G: int, D: int) -> int:
    """fp32 of a split's workspace record (acc [G][D], m [G], l [G], a
    poison flag), padded to 16 bytes: the row's merge stages records with
    16-byte copies (``record_floats`` in the source)."""
    return -(-(G * D + 2 * G + 1) // 4) * 4


@functools.lru_cache(maxsize=256)
def plan_decode(B: int, KV: int, G: int, D: int, esz: int, page: int,
                n_tab: int, split_tokens: int = SPLIT_TOKENS) -> DecodePlan:
    """The launch of a call as the source computes it; raises
    ``ValueError`` on what the kernel does not take."""
    if not 1 <= D <= MAX_HEAD_DIM or D % (16 // esz):
        raise ValueError(f"head_dim {D} must be a multiple of {16 // esz} "
                         f"in [1, {MAX_HEAD_DIM}]")
    if not 1 <= G <= HEAD_GROUPS[-1] or (D > 128 and G > 8):
        raise ValueError(f"{G} query heads a KV head at head_dim {D}: at "
                         f"most 16 (8 above head_dim 128)")
    if page < 1 or n_tab < 1 or B > 65535 or KV > 65535:
        raise ValueError(f"page {page}, table width {n_tab}, batch {B}, "
                         f"KV heads {KV}")
    spp = max(1, split_tokens // page)
    tensor_cores = esz == 2 and D in TC_HEAD_DIMS
    if tensor_cores:
        tile = TC_TILE
        smem = max(STAGES * 2 * tile * (D + 8) * esz,
                   4 * (TC_THREADS // 32) * 16 * (D + 2))
    else:
        tile = MAX_TILE
        while tile > THREADS // 32 and tile * D * esz > STAGE_BYTES:
            tile //= 2
        smem = max(STAGES * 2 * tile * D * esz,
                   4 * (THREADS // 32) * G * (D + 2))
    record = record_floats(G, D)
    # the row's merge stages at least one record after its scratch
    smem = max(smem, MERGE_SMEM + 4 * record)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"head_dim {D} needs {smem} bytes of shared memory")
    max_splits = -(-n_tab // spp)
    return DecodePlan(spp, max_splits, tensor_cores, tile, smem,
                      B * KV * max_splits * record, B * KV,
                      (max_splits, KV, B))


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


#: (device index, stream handle) -> the int32 ticket counters of the calls
#: on that stream, all zero between calls (each row's last block resets
#: its own); a stream's calls run one after another, so they share them
_COUNTERS: dict[tuple, torch.Tensor] = {}
#: device index -> [zeroed arena, its next free offset]: the streams'
#: counters are slices of it, so a stream first seen inside a capture (a
#: capture stream) takes its counters without an allocation
_ARENAS: dict = {}
#: every arena ever made: a captured graph keeps its slices' addresses
_KEPT: list[torch.Tensor] = []


def ticket_counters(device: torch.device, stream: int,
                    need: int) -> torch.Tensor:
    """The counters of the calls on ``stream`` of ``device``, at least
    ``need`` of them: a slice of MIN_COUNTERS or more (a power of two) of
    the device's arena of ARENA_COUNTERS, given to the stream once. The
    arena is allocated and zeroed outside any capture, so it lies in no
    graph's memory pool (a replay reuses pool memory for its other nodes,
    which would not come back as zeros), and is never freed. Raises
    ``RuntimeError`` if a capture would need a new arena (the device's
    first call, or an arena used up, inside a capture)."""
    key = (device.index, stream)
    buf = _COUNTERS.get(key)
    if buf is not None and buf.numel() >= need:
        return buf
    size = max(MIN_COUNTERS, 1 << (need - 1).bit_length())
    arena = _ARENAS.get(device.index)
    if arena is None or arena[1] + size > arena[0].numel():
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"paged_decode_attention_kernel: {size} ticket counters "
                f"needed inside a capture and no arena holds them; run one "
                f"call on {device} before capturing")
        arena = [torch.zeros(max(ARENA_COUNTERS, size), dtype=torch.int32,
                             device=device), 0]
        if device.type == "cuda":   # zeroed before any stream reads it
            torch.cuda.current_stream(device).synchronize()
        _KEPT.append(arena[0])
        _ARENAS[device.index] = arena
    buf = arena[0][arena[1]:arena[1] + size]
    arena[1] += size
    _COUNTERS[key] = buf
    return buf


def check_new_kv(q, new_kv, n_kv: int) -> None:
    """Raise ``ValueError`` unless ``new_kv`` is a pair ``(k_new, v_new)``
    of contiguous ``(B, KV, D)`` tensors in q's dtype on q's device."""
    B, _, D = q.shape
    if len(new_kv) != 2:
        raise ValueError("new_kv is a pair (k_new, v_new)")
    for t in new_kv:
        if tuple(t.shape) != (B, n_kv, D) or t.dtype != q.dtype \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(
                f"new_kv: contiguous {(B, n_kv, D)} {q.dtype} tensors on "
                f"{q.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def paged_decode_attention_kernel(q, k_pages, v_pages, block_tables,
                                  seq_lens, *, layer: int = 0,
                                  scale: float | None = None,
                                  return_residuals: bool = False,
                                  new_kv=None,
                                  _split_tokens: int | None = None):
    """q (B, H, D) on the GPU; k/v_pages (P, page, KV, D) or layer-stacked
    (L, P, page, KV, D) in q's dtype (float32 or bfloat16); block_tables
    (B, n_tab) and seq_lens (B,) int32 on the same GPU.

    Returns the normalized output (B, H, D) in q's dtype, or with
    ``return_residuals=True`` the unnormalized fp32 ``(acc (B, KV, G, D),
    m (B, KV, G), l (B, KV, G))``. ``new_kv=(k_new, v_new)``, each (B, KV,
    D) in q's dtype: the row's merge also takes that token (one the pages
    do not hold yet) exactly, as ``ref.merge_new_token_ref`` merges it into
    the residuals, and the output is the normalized (B, H, D). Live table
    slots (``ip * page < seq_lens[b]``) must hold valid page ids; dead
    slots are never read. Launches on the current stream and does not
    synchronize; one launch a call, counted in ``launches``.

    For measurements only: ``_split_tokens`` overrides the split length."""
    if new_kv is not None and return_residuals:
        raise ValueError("new_kv merges into the normalized output: not "
                         "with return_residuals")
    if k_pages.dim() == 4:
        k_pages, v_pages = k_pages[None], v_pages[None]
    if not (q.is_cuda and k_pages.device == q.device
            and v_pages.device == q.device
            and block_tables.device == q.device
            and seq_lens.device == q.device):
        raise ValueError("paged_decode_attention_kernel: every tensor must "
                         "be on the same CUDA device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q and the pools must share float32 or bfloat16, "
                        f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if block_tables.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("block_tables and seq_lens must be int32")
    if k_pages.dim() != 5 or k_pages.shape != v_pages.shape or q.dim() != 3:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    L, P, page, KV, D = k_pages.shape
    B, H, Dq = q.shape
    if Dq != D or H % KV:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pages.shape)}")
    G = H // KV
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.shape[1] < 1 or tuple(seq_lens.shape) != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"seq_lens {tuple(seq_lens.shape)} for batch {B}")
    if not 0 <= int(layer) < L:
        raise ValueError(f"layer {layer} outside [0, {L})")
    for t in (q, k_pages, v_pages, block_tables, seq_lens):
        if not t.is_contiguous():
            raise ValueError("paged_decode_attention_kernel takes "
                             "contiguous tensors")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("the pools must be 16-byte aligned")
    if new_kv is not None:
        check_new_kv(q, new_kv, KV)
    n_tab = block_tables.shape[1]
    plan = plan_decode(B, KV, G, D, q.element_size(), page, n_tab,
                       _split_tokens or SPLIT_TOKENS)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    dev = q.device
    stream = stream_handle(dev)
    counters = ticket_counters(dev, stream, plan.counters)
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32, device=dev)
    if return_residuals:
        acc = torch.empty((B, KV, G, D), dtype=torch.float32, device=dev)
        m = torch.empty((B, KV, G), dtype=torch.float32, device=dev)
        l = torch.empty_like(m)
        out = None
    else:
        acc = m = l = None
        out = torch.empty_like(q)
    k_new, v_new = (None, None) if new_kv is None else new_kv
    fn = _build.function(_LIB, "paged_decode_launch", _ARGTYPES)
    with device_guard(dev):
        err = fn(_ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(block_tables),
                 _ptr(seq_lens), _ptr(ws), _ptr(counters), _ptr(acc),
                 _ptr(out), _ptr(m), _ptr(l), _ptr(k_new), _ptr(v_new), B,
                 KV, G, D, P, page, n_tab, int(layer), float(scale),
                 _DTYPES[q.dtype], plan.split_pages if _split_tokens else 0,
                 stream)
    _build.check(_LIB, err, "paged_decode_attention_kernel")
    if B:
        paged_decode_attention_kernel.launches += 1
    if return_residuals:
        return acc, m, l
    return out


paged_decode_attention_kernel.launches = 0


def plan_dense_decode(B: int, T: int, KV: int, G: int, D: int,
                      esz: int) -> DecodePlan:
    """The dense launch of a call over a ``T``-slot cache: the paged plan
    of SPLIT_TOKENS-token "pages", ceil(T / SPLIT_TOKENS) of them, one a
    split (the source's ``dense_decode_launch``), so the splits depend on
    T alone, never on B or the offsets. Raises ``ValueError`` on what the
    kernel does not take, before any launch."""
    if T < 1:
        raise ValueError(f"a dense cache of {T} slots")
    return plan_decode(B, KV, G, D, esz, SPLIT_TOKENS, -(-T // SPLIT_TOKENS))


def check_dense_operands(q, cache_k, cache_v, offsets, window: int,
                         softcap: float) -> tuple:
    """The dense launch's host checks, all before any launch: q (B, H, D)
    contiguous; the caches (B, T, KV, D) in q's dtype, the same strides,
    heads D apart and elements contiguous, every address and stride a
    multiple of 16 bytes; offsets a (B,) int32 tensor; everything on one
    CUDA device; no window mask to apply (``window`` 0 or at least T:
    at one query a ring's slots and a plain cache shorter than the
    window hold only positions the window keeps); ``softcap`` >= 0.
    Returns (B, T, KV, G, D, row stride, token stride) in elements."""
    what = "dense_decode_attention_kernel"
    if not (q.is_cuda and cache_k.device == q.device
            and cache_v.device == q.device and offsets.device == q.device):
        raise ValueError(f"{what}: every tensor must be on the same CUDA "
                         f"device")
    if q.dtype not in _DTYPES or cache_k.dtype != q.dtype \
            or cache_v.dtype != q.dtype:
        raise TypeError(f"{what}: q and the caches must share float32 or "
                        f"bfloat16, got {q.dtype}, {cache_k.dtype}, "
                        f"{cache_v.dtype}")
    if q.dim() != 3 or cache_k.dim() != 4 or cache_v.shape != cache_k.shape:
        raise ValueError(f"{what}: q (B, H, D), caches (B, T, KV, D), got "
                         f"{tuple(q.shape)}, {tuple(cache_k.shape)} / "
                         f"{tuple(cache_v.shape)}")
    B, H, D = q.shape
    Bc, T, KV, Dc = cache_k.shape
    if Bc != B or Dc != D or H % KV:
        raise ValueError(f"{what}: q {tuple(q.shape)} does not fit caches "
                         f"{tuple(cache_k.shape)}")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (B,) \
            or not offsets.is_contiguous():
        raise ValueError(f"{what}: offsets a contiguous ({B},) int32 "
                         f"tensor, got {tuple(offsets.shape)} "
                         f"{offsets.dtype}")
    if window > 0 and T > window:
        raise ValueError(f"{what}: a {T}-slot cache under a {window}-token "
                         f"window needs the window mask, which the launch "
                         f"does not apply")
    if not softcap >= 0:
        raise ValueError(f"{what}: softcap {softcap}")
    if not q.is_contiguous():
        raise ValueError(f"{what}: q must be contiguous")
    esz = q.element_size()
    strides = cache_k.stride()
    if cache_v.stride() != strides or strides[3] != 1 or strides[2] != D \
            or strides[1] < KV * D:
        raise ValueError(f"{what}: caches with heads D apart and contiguous "
                         f"elements, the same strides, got {strides} / "
                         f"{cache_v.stride()}")
    for t in (q, cache_k, cache_v):
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: 16-byte aligned addresses")
    if any((st * esz) % 16 for st in strides[:3]):
        raise ValueError(f"{what}: strides of whole 16-byte chunks, got "
                         f"{strides}")
    return B, T, KV, H // KV, D, strides[0], strides[1]


def dense_decode_attention_kernel(q, cache_k, cache_v, offsets, *,
                                  scale: float | None = None,
                                  softcap: float = 0.0, window: int = 0):
    """One token a row, q (B, H, D), against a layer's dense cache
    ``cache_k`` / ``cache_v`` (B, T, KV, D) that already holds it (views
    of the model's cache: their strides are read), ``offsets`` (B,) int32
    the rows' positions on the device (never read on the host): row b
    attends over its first min(offsets[b] + 1, T) slots. A plain cache
    holds position s in slot s; a ring (T == the window) holds, once
    full, exactly the positions of the window, so at one query neither
    takes a window mask (``window``: a cache longer than it is refused).
    ``softcap`` > 0: each fp32 score s becomes tanh(s / softcap) *
    softcap before the row's max. Returns the normalized output (B, H, D)
    in q's dtype. One launch (counted in ``launches``); every check comes
    before it (:func:`check_dense_operands`, :func:`plan_dense_decode`)."""
    B, T, KV, G, D, row_stride, tok_stride = check_dense_operands(
        q, cache_k, cache_v, offsets, window, softcap)
    plan = plan_dense_decode(B, T, KV, G, D, q.element_size())
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    fn = _build.function(_LIB, "dense_decode_launch", _DENSE_ARGTYPES)
    dev = q.device
    stream = stream_handle(dev)
    counters = ticket_counters(dev, stream, plan.counters)
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32, device=dev)
    out = torch.empty_like(q)
    with device_guard(dev):
        err = fn(_ptr(q), _ptr(cache_k), _ptr(cache_v), _ptr(offsets),
                 _ptr(ws), _ptr(counters), _ptr(out), B, T, KV, G, D,
                 row_stride, tok_stride, float(scale), float(softcap),
                 _DTYPES[q.dtype], stream)
    _build.check(_LIB, err, "dense_decode_attention_kernel")
    if B:
        dense_decode_attention_kernel.launches += 1
    return out


dense_decode_attention_kernel.launches = 0
