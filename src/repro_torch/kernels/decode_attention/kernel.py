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

:func:`dense_decode_attention_kernel` is decode attention over a layer's
dense ``(B, T, KV, D)`` cache (``Model.forward``'s one-token step: the
reference's ``attend_decode`` at C == 1, which XLA fuses), read by its
strides, each row's length from the step's device offsets, with gemma2's
tanh softcap. In bf16 at the head dims of ``DENSE_HEAD_DIMS`` it is a
kernel of its own (``csrc/dense_decode.cu``: a row's splits one
thread-block cluster, fed by bulk copies through an mbarrier ring,
merged in distributed shared memory; :func:`plan_dense_split`); in fp32
and at other head dims the paged split kernels over the cache.
:func:`plan_dense_decode` is its host side.
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
_CLUSTER_LIB = "dense_decode"
_ARGTYPES = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 8 + \
    [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_DENSE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + \
    [ctypes.c_longlong] * 2 + [ctypes.c_float] * 2 + [ctypes.c_int] + \
    [ctypes.c_void_p]
_CLUSTER_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
    [ctypes.c_float] * 2 + [ctypes.c_void_p]
_MAPS_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + \
    [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
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


#: the dense launch's own kernel (``csrc/dense_decode.cu``): bf16 at these
#: head dims (the old tensor-core route's); a CTA is DENSE_CONSUMERS
#: consumer warps and a producer warp, stages of DENSE_STAGE_TOKENS
#: tokens, at most DENSE_MAX_STAGES of them, clusters of at most
#: DENSE_MAX_CLUSTER CTAs, DENSE_BAR_BYTES of mbarriers (the source's
#: kConsumers, kStageTokens, kMaxStages, kMaxCluster, kBarBytes)
DENSE_HEAD_DIMS = (16, 64, 80, 128, 256)
DENSE_CONSUMERS, DENSE_STAGE_TOKENS, DENSE_MAX_STAGES = 4, 16, 8
DENSE_MAX_CLUSTER, DENSE_BAR_BYTES = 16, 256
#: the plan's: Q, the merge's inbox and the ring within DENSE_SMEM_BUDGET
#: bytes (two CTAs an SM), a CTA's KV heads at most DENSE_HEAD_BYTES of a
#: token's K, about DENSE_CTA_BYTES of K and V a CTA at a full cache
DENSE_SMEM_BUDGET, DENSE_HEAD_BYTES = 113 * 1024, 640
DENSE_CTA_BYTES = 384 * 1024
#: the plan's clusters stop at 14 CTAs: 8 clusters of 14 lie one CTA an SM
#: on the H100 (112 SMs), where 8 of 16 put 2 CTAs on 16 SMs, whose
#: clusters then finish last (gemma2-9b's global layer 0.0233 ms against
#: 0.0253 in one call, ``launch/kernel_pair.py --only dense``)
DENSE_PLAN_CLUSTER = 14
#: two tensor maps (K's, V's), the bytes of CUtensorMap each (kMapBytes)
DENSE_MAP_BYTES = 2 * 128


def dense_boxes(D: int) -> tuple[int, int]:
    """(boxes, width): a head's row of D elements as TMA boxes of 16 tokens
    x ``width`` elements (past D zero-filled), the width 8 times an odd
    number so a box's rows read conflict-free (``box_count`` /
    ``box_width`` in the source)."""
    n = 1 if D <= 248 else 2
    w = -(-(-(-D // n)) // 8) * 8
    return n, w if (w // 8) % 2 else w + 8


@dataclasses.dataclass(frozen=True)
class DenseSplitPlan:
    """The dense kernel's geometry, from (T, KV, G, D) alone: ``heads``
    KV heads a CTA, ``cluster`` CTAs (the row's splits, one cluster) a
    (row, head group) of ``split`` tokens each, ``stages`` ring slots,
    ``chunk`` output elements a rank finishes (a power of two),
    ``smem_bytes`` of dynamic shared memory a CTA."""
    heads: int
    cluster: int
    split: int
    stages: int
    chunk: int
    smem_bytes: int

    @property
    def warps_per_head(self) -> int:
        return DENSE_CONSUMERS // self.heads


def dense_geometry(T: int, KV: int, G: int, D: int,
                   cluster: int = 0) -> DenseSplitPlan:
    """The dense kernel's plan at any head dim (the kernel itself takes
    DENSE_HEAD_DIMS; :func:`plan_dense_split` checks): the heads a
    CTA where a token's K of them fits DENSE_HEAD_BYTES (4, 2 or 1,
    dividing KV); the cluster the power of two (at most a stage of tokens
    each) that gives a CTA about DENSE_CTA_BYTES of K and V over all T
    slots, capped at DENSE_PLAN_CLUSTER, each split ceil(T / cluster)
    tokens rounded up to a stage; a rank finishing a power of two of the
    row's outputs, at or above ceil(heads G D / cluster); as many ring
    slots (at most DENSE_MAX_STAGES) as fit beside Q and the merge's
    inbox within DENSE_SMEM_BUDGET; the shared memory the source lays out
    for it (``checked_plan``, which refuses a plan it cannot hold).
    ``cluster`` > 0 forces the cluster size (measurements, and the tests'
    schedules)."""
    heads = next((h for h in (4, 2) if KV % h == 0
                  and h * D * 2 <= DENSE_HEAD_BYTES), 1)
    want = -(-4 * heads * D * T // DENSE_CTA_BYTES)
    c = 1
    while c < want and c < DENSE_MAX_CLUSTER:
        c *= 2
    while c > 1 and c > -(-T // DENSE_STAGE_TOKENS):
        c //= 2
    c = cluster or min(c, DENSE_PLAN_CLUSTER)
    split = -(-(-(-T // c)) // DENSE_STAGE_TOKENS) * DENSE_STAGE_TOKENS
    P = heads * G
    chunk = 1
    while chunk * c < P * D:
        chunk *= 2
    q_bytes = 2 * heads * 16 * (D + 8)
    in_bytes = -(-4 * (c * chunk + 2 * c * P) // 128) * 128
    nbx, width = dense_boxes(D)
    stage = 2 * 2 * heads * nbx * DENSE_STAGE_TOKENS * width
    n_st = min(DENSE_MAX_STAGES, max(1, (
        DENSE_SMEM_BUDGET - DENSE_BAR_BYTES - q_bytes - in_bytes) // stage))
    merge = 4 * (DENSE_CONSUMERS * G * (D + 2) + c * P + P)
    smem = DENSE_BAR_BYTES + q_bytes + in_bytes + max(n_st * stage, merge)
    return DenseSplitPlan(heads, c, split, n_st, chunk, smem)


@functools.lru_cache(maxsize=256)
def plan_dense_split(T: int, KV: int, G: int, D: int,
                     cluster: int = 0) -> DenseSplitPlan:
    """The dense kernel's plan (:func:`dense_geometry`), a function of
    (T, KV, G, D) alone; the launch passes it to the source, which keeps
    no plan of its own. Raises ``ValueError`` on what the kernel does not
    take: another head dim, G past 16 (8 above head_dim 128), a forced
    cluster past the source's or shared memory past a block's."""
    if D not in DENSE_HEAD_DIMS:
        raise ValueError(f"head_dim {D}: the dense kernel takes "
                         f"{DENSE_HEAD_DIMS}")
    if T < 1 or KV < 1 or not 1 <= G <= 16 or (D > 128 and G > 8):
        raise ValueError(f"{G} query heads a KV head at head_dim {D}: at "
                         f"most 16 (8 above head_dim 128); T {T}, KV {KV}")
    if not 0 <= cluster <= DENSE_MAX_CLUSTER:
        raise ValueError(f"cluster {cluster}: at most {DENSE_MAX_CLUSTER}")
    plan = dense_geometry(T, KV, G, D, cluster)
    if plan.smem_bytes > SMEM_PER_BLOCK:
        raise ValueError(f"{plan.smem_bytes} bytes of shared memory")
    return plan


def dense_split_ranges(T: int, plan: DenseSplitPlan,
                       length: int) -> list[tuple[int, int]]:
    """Each rank's token range ``[t0, t1)`` of a row of ``length`` live
    slots (empty past it), rank 0 first: the kernel's splits."""
    return [(min(r * plan.split, length),
             min(length, (r + 1) * plan.split)) for r in range(plan.cluster)]


@dataclasses.dataclass(frozen=True)
class DensePlan:
    """The dense launch of a call: ``route`` "cluster" (bf16 at
    DENSE_HEAD_DIMS: the kernel of ``csrc/dense_decode.cu``, ``split``
    its plan) or "split" (fp32 and other head dims: the paged split
    kernels over the cache, ``split`` their plan, with its workspace and
    ticket counters); ``grid`` the launch's."""
    route: str
    split: DenseSplitPlan | DecodePlan
    grid: tuple[int, int, int]


def plan_dense_decode(B: int, T: int, KV: int, G: int, D: int, esz: int,
                      cluster: int = 0) -> DensePlan:
    """The dense launch of a call over a ``T``-slot cache, a function of
    (T, KV, G, D) and the dtype, never of B or the offsets (B sets only
    the grid's last dimension). bf16 at DENSE_HEAD_DIMS:
    :func:`plan_dense_split` (``cluster`` for measurements);
    otherwise the paged plan of SPLIT_TOKENS-token "pages",
    ceil(T / SPLIT_TOKENS) of them, one a split (the source's
    ``dense_decode_launch``). Raises ``ValueError`` on what neither
    takes, before any launch."""
    if T < 1:
        raise ValueError(f"a dense cache of {T} slots")
    if esz == 2 and D in DENSE_HEAD_DIMS:
        plan = plan_dense_split(T, KV, G, D, cluster)
        return DensePlan("cluster", plan, (plan.cluster, KV // plan.heads, B))
    if cluster:
        raise ValueError("cluster: the bf16 dense kernel's alone")
    plan = plan_decode(B, KV, G, D, esz, SPLIT_TOKENS, -(-T // SPLIT_TOKENS))
    return DensePlan("split", plan, plan.grid)


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


#: (device index, k's and v's addresses, shape, strides) -> the encoded
#: tensor maps (host bytes) of a dense cache, made once a cache address
_DENSE_MAPS: dict[tuple, ctypes.Array] = {}
_DENSE_MAPS_MAX = 4096


def _dense_maps(cache_k, cache_v, row_stride: int,
                tok_stride: int) -> ctypes.Array:
    key = (cache_k.device.index, cache_k.data_ptr(), cache_v.data_ptr(),
           *cache_k.shape, row_stride, tok_stride)
    maps = _DENSE_MAPS.get(key)
    if maps is None:
        B, T, KV, D = cache_k.shape
        maps = ctypes.create_string_buffer(DENSE_MAP_BYTES)
        fn = _build.function(_CLUSTER_LIB, "dense_cluster_maps",
                             _MAPS_ARGTYPES)
        with device_guard(cache_k.device):
            err = fn(cache_k.data_ptr(), cache_v.data_ptr(), B, T, KV, D,
                     row_stride, tok_stride, ctypes.addressof(maps))
        _build.check(_CLUSTER_LIB, err,
                     "dense_decode_attention_kernel: tensor maps")
        if len(_DENSE_MAPS) >= _DENSE_MAPS_MAX:
            _DENSE_MAPS.clear()
        _DENSE_MAPS[key] = maps
    return maps


def dense_decode_attention_kernel(q, cache_k, cache_v, offsets, *,
                                  scale: float | None = None,
                                  softcap: float = 0.0, window: int = 0,
                                  _cluster: int = 0):
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
    in q's dtype. One launch (counted in ``launches``), of the route
    :func:`plan_dense_decode` picks; every check comes before it
    (:func:`check_dense_operands`, the plan).

    For measurements only: ``_cluster`` forces the bf16 kernel's cluster
    size."""
    B, T, KV, G, D, row_stride, tok_stride = check_dense_operands(
        q, cache_k, cache_v, offsets, window, softcap)
    plan = plan_dense_decode(B, T, KV, G, D, q.element_size(), _cluster)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    if plan.route == "cluster":
        fn = _build.function(_CLUSTER_LIB, "dense_cluster_launch",
                             _CLUSTER_ARGTYPES)
        maps = _dense_maps(cache_k, cache_v, row_stride, tok_stride)
        stream = stream_handle(dev)
        out = torch.empty_like(q)
        sp = plan.split
        with device_guard(dev):
            err = fn(ctypes.addressof(maps), _ptr(q), _ptr(offsets),
                     _ptr(out), B, T, KV, G, D, sp.heads, sp.cluster,
                     sp.split, sp.stages, sp.chunk, float(scale),
                     float(softcap), stream)
        _build.check(_CLUSTER_LIB, err, "dense_decode_attention_kernel")
    else:
        fn = _build.function(_LIB, "dense_decode_launch", _DENSE_ARGTYPES)
        stream = stream_handle(dev)
        out = torch.empty_like(q)
        counters = ticket_counters(dev, stream, plan.split.counters)
        ws = torch.empty(plan.split.workspace_floats, dtype=torch.float32,
                         device=dev)
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

