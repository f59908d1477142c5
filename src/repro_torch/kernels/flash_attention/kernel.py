"""CUDA flash attention: the checked launchers of
``csrc/flash_attention.cu``, the port of the Pallas
``flash_attention_kernel`` (``src/repro/kernels/flash_attention/
kernel.py``).

The kernel is picked by dtype alone. bf16 runs on the tensor cores: TMA
loads q, k and v tiles into swizzled shared memory, a ring of K/V stages
runs ahead of one or two warpgroups, and each warpgroup runs both
products with ``wgmma`` and an fp32 online softmax (see the source).
fp32, used by the equivalence checks, runs the CUDA-core kernel. The
tensors are read through their strides (unit stride along D), so a caller
holding (B, S, H, D) activations passes ``x.transpose(1, 2)`` views and no
copy is made.

Two launches: :func:`flash_attention_kernel`, the prefill (queries and
keys the same S positions), and :func:`flash_extend_kernel`, a chunk of
queries at per-row offsets read from device memory against a longer
cache (the reference's ``attend_decode`` over a plain cache, which XLA
fuses; no Pallas kernel is its counterpart). In fp32 both run the
CUDA-core kernel; in bf16 the extend launch has a kernel of its own:
two heads of a GQA group a CTA sharing each K/V stage, and the live key
tiles of a query tile split over a thread-block cluster of CTAs that
merge their partial softmax states through distributed shared memory,
so that a chunk fills the card. Each launch counts its own launches.

:func:`plan_bf16`, :func:`plan_extend`, :func:`extend_tile_ranges`,
:func:`tma_strides` and :func:`operand_shapes` are the host side of the
launches as pure functions, so the CPU tests reach them; every refusal
is raised before any launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import _build, device_guard, stream_handle

_LIB = "flash_attention"
# q, k, v, o, strides; B, H, KV, Sq, Sk, D; scale, causal, window,
# softcap; the offsets (null for the prefill launch)
_COMMON_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
     ctypes.c_void_p]
_FP32_ARGS = _COMMON_ARGS + [ctypes.c_void_p]
_BF16_ARGS = _COMMON_ARGS + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
# q, k, v, o, strides; B, H, KV, Sq, Sk, D; scale, window, softcap; the
# offsets; pair, slices, stages; the stream
_EXTEND_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + \
    [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p] + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]
MAX_HEAD_DIM = 256
MAX_SLICES = 4        # kMaxSlices in the source
# the extend plan's cost of a CTA beyond its key tiles, in key tiles of
# ~2 us, as the launch's probes and slice sweep read on the H100 (PERF.md
# §6): its launch, start and stores (~6 us), and a split's merge (~4.5 us)
START_TILES, MERGE_TILES = 3, 2

# Hopper's shared memory (H100, H200): 227 KB a block. Every tile shape
# holds one CTA an SM (registers: see ``TcConfig`` in the source).
SMEM_PER_BLOCK = 232_448
MAX_STAGES = 4        # kMaxStages in the source
ALIGN_SLACK = 1024    # the tiles are aligned to 1024 bytes in the kernel
STATIC_SMEM = 256     # the mbarriers, rounded up


@dataclasses.dataclass(frozen=True)
class Bf16Plan:
    """The tensor-core launch: ``q_tile`` query rows a CTA (64 per
    consumer warpgroup), D padded to ``head_pad`` in shared memory,
    ``block_k`` keys a stage, ``stages`` stages in the K/V ring, the
    K/V tensor maps ``key_tiles`` tiles long."""
    q_tile: int
    head_pad: int
    block_k: int
    stages: int
    threads: int
    smem_bytes: int
    grid: tuple[int, int, int]
    key_tiles: int


def _check_bf16_head_dim(D: int) -> None:
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash attention in bf16 takes a head dim that is "
                         f"a multiple of 8 in [8, {MAX_HEAD_DIM}] (TMA moves "
                         f"whole 16-byte rows), got {D}")


def _tiles(D: int, q_rows: int) -> tuple[int, int, int]:
    """(head_pad, block_k, stages) of a CTA holding ``q_rows`` query rows
    of a padded head: 128-key tiles up to D = 128, 64-key tiles above,
    as many K/V stages (up to 4) as fit 227 KB."""
    head_pad = math.ceil(D / 64) * 64
    block_k = 128 if head_pad <= 128 else 64
    stage_bytes = 2 * block_k * head_pad * 2
    stages = min(MAX_STAGES, (SMEM_PER_BLOCK - ALIGN_SLACK - STATIC_SMEM
                              - q_rows * head_pad * 2) // stage_bytes)
    return head_pad, block_k, stages


@functools.lru_cache(maxsize=256)
def plan_bf16(B: int, H: int, S: int, D: int, q_tile: int | None = None,
              num_sms: int = 132) -> Bf16Plan:
    """Tile shapes and shared memory of the bf16 prefill kernel
    (``TcConfig`` in the source) for S query rows against as many keys:
    64 query rows a warpgroup, 128-key tiles up to D = 128 and 64-key
    tiles above. ``q_tile`` None picks 128 rows (two warpgroups) when
    their grid alone fills the card's ``num_sms`` SMs, else 64 (twice the
    CTAs). The K/V ring takes as many stages (up to 4) as fit 227 KB."""
    _check_bf16_head_dim(D)
    if q_tile is None:
        q_tile = 128 if math.ceil(S / 128) * H * B >= num_sms else 64
    if q_tile not in (64, 128):
        raise ValueError(f"q_tile must be 64 or 128, got {q_tile}")
    head_pad, block_k, stages = _tiles(D, q_tile)
    return Bf16Plan(q_tile=q_tile, head_pad=head_pad, block_k=block_k,
                    stages=stages, threads=2 * q_tile,
                    smem_bytes=ALIGN_SLACK + q_tile * head_pad * 2
                    + stages * 2 * block_k * head_pad * 2,
                    grid=(math.ceil(S / q_tile), H, B),
                    key_tiles=math.ceil(S / block_k))


@dataclasses.dataclass(frozen=True)
class ExtendPlan:
    """The bf16 extend launch (``flash_extend_kernel`` in the source):
    CTAs of two consumer warpgroups (``threads`` 256) on ``q_tile`` query
    rows, two heads of a GQA group over 64 rows when ``pair`` (G even),
    else one head's 128; each query tile's live key tiles split into
    ``slices`` ranges, one CTA each, the ``slices`` CTAs along x a
    ``cluster``; D padded to ``head_pad``, ``block_k`` keys a stage,
    ``stages`` in the ring. ``key_tiles`` is the most live key tiles a
    CTA can have at these shapes (any offset); ``partial_bytes`` the
    shared memory the merge takes in a CTA (0 unsplit)."""
    pair: bool
    q_tile: int
    head_pad: int
    block_k: int
    stages: int
    threads: int
    smem_bytes: int
    slices: int
    cluster: tuple[int, int, int]
    grid: tuple[int, int, int]
    key_tiles: int
    partial_bytes: int

    @property
    def ctas(self) -> int:
        return math.prod(self.grid)


def pick_slices(base: int, key_tiles: int, num_sms: int) -> int:
    """The slice count for ``base`` CTAs a slice whose heaviest sees
    ``key_tiles`` tiles: of 1 .. min(MAX_SLICES, ``key_tiles``), the one
    with the least estimated time, the smaller on a tie. A CTA holds an
    SM (its registers and shared memory), so the CTAs run in waves of
    ``num_sms``, each as long as its heaviest CTA: waves x (its tiles +
    START_TILES, + MERGE_TILES when split)."""
    def cost(s: int) -> tuple[int, int]:
        per_cta = math.ceil(key_tiles / s) + START_TILES + \
            (MERGE_TILES if s > 1 else 0)
        return math.ceil(base * s / num_sms) * per_cta, s
    return min(range(1, max(1, min(MAX_SLICES, key_tiles)) + 1), key=cost)


@functools.lru_cache(maxsize=256)
def plan_extend(B: int, H: int, KV: int, C: int, T: int, D: int,
                window: int = 0, num_sms: int = 132,
                slices: int | None = None) -> ExtendPlan:
    """The bf16 extend launch's plan for a chunk of C queries of H heads
    against a cache of T keys of KV heads: a function of these shapes and
    the SM count alone, never of the offsets (read on the device), so a
    captured graph replays every start. ``slices`` None picks the split
    (:func:`pick_slices`); a number forces it (a measurement hook)."""
    _check_bf16_head_dim(D)
    if KV < 1 or H % KV:
        raise ValueError(f"flash_extend_kernel: {H} heads are not groups "
                         f"of {KV} KV heads")
    pair = (H // KV) % 2 == 0
    q_tile = 64 if pair else 128
    head_pad, block_k, stages = _tiles(D, 128)
    tiles_q = math.ceil(C / q_tile)
    heads = H // 2 if pair else H
    key_tiles = math.ceil(T / block_k)
    if window > 0:         # the window's keys and the tile's rows, any start
        key_tiles = min(key_tiles,
                        math.ceil((window + q_tile - 1) / block_k) + 1)
    if slices is None:
        slices = pick_slices(tiles_q * heads * B, key_tiles, num_sms)
    if not 1 <= slices <= MAX_SLICES:
        raise ValueError(f"flash_extend_kernel: slices {slices} outside "
                         f"[1, {MAX_SLICES}]")
    return ExtendPlan(pair=pair, q_tile=q_tile, head_pad=head_pad,
                      block_k=block_k, stages=stages, threads=256,
                      smem_bytes=ALIGN_SLACK + 128 * head_pad * 2
                      + stages * 2 * block_k * head_pad * 2,
                      slices=slices, cluster=(slices, 1, 1),
                      grid=(tiles_q * slices, heads, B), key_tiles=key_tiles,
                      partial_bytes=_partial_bytes(head_pad, slices))


def _partial_bytes(head_pad: int, slices: int) -> int:
    """The shared memory a CTA's merge takes (the source's layout): a
    float4 a thread for each slice of each column group the CTA owns
    (head_pad / 8 groups over the slices), and each slice's (m, l)."""
    if slices == 1:
        return 0
    groups = head_pad // 8
    return 16 * 256 * slices * (math.ceil(groups / slices) + 1)


def extend_tile_ranges(plan: ExtendPlan, C: int, T: int, offsets,
                       window: int = 0) -> list:
    """The key tiles each CTA of the extend launch walks, as the kernel
    works them out on the device from the offsets: for batch row b and
    query tile qt, ``[(first, end) for each slice]`` (end exclusive; a
    slice may be empty). The CTA's live keys run from its window's first
    (0 without a window) to min(T, off + its last row + 1); of their n
    tiles slice s takes [ceil(s n / S), ceil((s + 1) n / S)), so a
    longer slice comes first and the last, holding the masked diagonal,
    is never the longest."""
    bk, rows, S = plan.block_k, plan.q_tile, plan.slices
    out = []
    for off in offsets:
        off = max(int(off), 0)
        per_b = []
        for qt in range(math.ceil(C / rows)):
            q0 = qt * rows
            kv_end = min(T, off + min(C, q0 + rows))
            kv_begin = max(0, off + q0 - window + 1) if window > 0 else 0
            first = kv_begin // bk
            n = max(0, -(-kv_end // bk) - first)
            per_b.append([(first - (-s * n // S),
                           first - (-(s + 1) * n // S)) for s in range(S)])
        out.append(per_b)
    return out


def tma_strides(name: str, shape, strides, data_ptr: int,
                esz: int = 2) -> tuple[int, int, int]:
    """Element strides (batch, head, position) of a (B, heads, S, D)
    operand as its tensor map will hold them, raising ``ValueError`` where
    TMA cannot read it: a base address or a stride that is not a whole
    number of 16 bytes. A dimension of size 1 is never stepped, so its
    stride is replaced by an aligned one."""
    if data_ptr % 16:
        raise ValueError(f"flash_attention_kernel: {name}'s base address is "
                         f"not 16-byte aligned (TMA needs it)")
    span = math.ceil(math.prod(shape) * esz / 16) * 16 // esz
    out = []
    for size, stride, what in zip(shape[:3], strides[:3],
                                  ("batch", "head", "position")):
        if size == 1:
            stride = span
        elif (stride * esz) % 16:
            raise ValueError(f"flash_attention_kernel: {name}'s {what} "
                             f"stride {stride} is not a whole number of "
                             f"16 bytes (TMA needs it)")
        out.append(stride)
    return tuple(out)


def operand_shapes(q, k, v, what: str, q_offset=None
                   ) -> tuple[int, int, int, int, int, int]:
    """(B, H, KV, Sq, Sk, D) of q (B, H, Sq, D) and k/v (B, KV, Sk, D),
    raising ``ValueError`` (``TypeError`` for a dtype) for what the
    kernels cannot take: other ranks or dtypes, K and V apart, H not a
    multiple of KV, a head dim outside [1, 256], queries but no keys, a D
    stride other than 1, grid limits; and with ``q_offset`` anything but
    a contiguous int32 (B,) tensor. Reads shapes, dtypes and strides
    only, so a CPU tensor reaches every refusal."""
    if q.dtype not in (torch.float32, torch.bfloat16) \
            or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k and v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: bad shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KV or (Sq and Sk < 1):
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head_dim {D} outside [1, "
                         f"{MAX_HEAD_DIM}]")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1 and D > 1:
            raise ValueError(f"{what}: {name} needs unit stride along D, "
                             f"got strides {t.stride()}")
    if H > 65535 or B > 65535:
        raise ValueError(f"{what}: grid limits: heads {H}, batch {B}")
    if q_offset is not None and (
            not isinstance(q_offset, torch.Tensor)
            or q_offset.dtype != torch.int32
            or tuple(q_offset.shape) != (B,)
            or (B > 1 and q_offset.stride(0) != 1)):
        raise ValueError(
            f"{what}: q_offset must be a contiguous int32 ({B},) tensor, "
            f"got {getattr(q_offset, 'dtype', type(q_offset))} "
            f"{tuple(getattr(q_offset, 'shape', ()))}")
    return B, H, KV, Sq, Sk, D


def _launch(q, k, v, q_offset, dims, *, scale, causal: bool, window: int,
            softcap: float, q_tile: int | None = None,
            slices: int | None = None, what: str) -> torch.Tensor:
    """One launch of the kernel q's dtype (and in bf16 the offsets)
    picks, the output allocated like q; ``q_offset`` None is the prefill
    launch. Raises before the launch for TMA's rules and the plans (bf16)
    and after it for a CUDA error."""
    B, H, KV, Sq, Sk, D = dims
    tensors = (q, k, v) + (() if q_offset is None else (q_offset,))
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(f"{what}: every tensor must be on the same CUDA "
                         f"device")
    out = torch.empty_like(q)      # unit stride along D, as q
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    off = None if q_offset is None else q_offset.data_ptr()
    if q.dtype == torch.bfloat16:
        st = [s for name, t in (("q", q), ("k", k), ("v", v))
              for s in tma_strides(name, t.shape, t.stride(),
                                   t.data_ptr())]
        st += out.stride()[:3]
        if q_offset is None:
            plan = plan_bf16(B, H, Sq, D, q_tile, _num_sms(q.device.index))
            tail = (int(bool(causal)), int(window), float(softcap), off,
                    plan.q_tile, plan.stages)
            fn = _build.function(_LIB, "flash_attention_bf16_launch",
                                 _BF16_ARGS)
        else:
            plan = plan_extend(B, H, KV, Sq, Sk, D, int(window),
                               _num_sms(q.device.index), slices)
            tail = (int(window), float(softcap), off, int(plan.pair),
                    plan.slices, plan.stages)
            fn = _build.function(_LIB, "flash_extend_bf16_launch",
                                 _EXTEND_ARGS)
    else:
        st = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        tail = (int(bool(causal)), int(window), float(softcap), off)
        fn = _build.function(_LIB, "flash_attention_fp32_launch", _FP32_ARGS)
    strides = (ctypes.c_longlong * 12)(*st)
    with device_guard(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), B, H, KV, Sq, Sk, D,
                 float(scale), *tail, stream_handle(q.device))
    _build.check(_LIB, err, what)
    return out


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_attention_kernel(q, k, v, *, scale: float | None = None,
                           causal: bool = True, window: int = 0,
                           softcap: float = 0.0,
                           _q_tile: int | None = None) -> torch.Tensor:
    """q (B, H, S, D); k/v (B, KV, S, D) on one GPU, float32 or bfloat16,
    any strides with a unit stride along D (bf16 also: D a multiple of 8
    and 16-byte-aligned addresses and strides). Returns (B, H, S, D) in
    q's dtype, laid out like q (``torch.empty_like``). Launches on the
    current stream and does not synchronize. ``_q_tile`` is a measurement
    hook, set by no caller of the port: it forces the bf16 kernel's query
    tile to 64 or 128 rows instead of :func:`plan_bf16`'s pick."""
    what = "flash_attention_kernel"
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{what}: q, k and v must be on the same CUDA "
                         f"device")
    dims = operand_shapes(q, k, v, what)
    if dims[4] != dims[3]:
        raise ValueError(f"{what}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (the extend launch, "
                         f"flash_extend_kernel, takes more keys)")
    out = _launch(q, k, v, None, dims, scale=scale, causal=causal,
                  window=window, softcap=softcap, q_tile=_q_tile, what=what)
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0


def flash_extend_kernel(q, k, v, q_offset, *, scale: float | None = None,
                        window: int = 0, softcap: float = 0.0,
                        _slices: int | None = None) -> torch.Tensor:
    """A chunk's causal attention against a cache: q (B, H, C, D) the
    chunk's queries, k/v (B, KV, T, D) the cache, already holding the
    chunk's keys, and ``q_offset`` a contiguous int32 (B,) tensor on
    their GPU: query row i of batch row b sits at position q_offset[b] +
    i and sees the keys at positions j <= q_offset[b] + i (and j >
    q_offset[b] + i - ``window`` where ``window`` > 0) below T; the
    caller keeps q_offset[b] + C <= T. Keys past the last one a CTA's
    rows see are never read into a result, whatever they hold. The
    offsets are read on the device alone, so a captured graph replays
    the launch for new offsets. Same dtypes, layouts and rules as
    :func:`flash_attention_kernel`; one launch, in bf16 shaped by
    :func:`plan_extend`. ``_slices`` is a measurement hook, set by no
    caller of the port: it forces the bf16 launch's split over keys
    (1..8) instead of the plan's pick."""
    what = "flash_extend_kernel"
    dims = operand_shapes(q, k, v, what, q_offset)
    out = _launch(q, k, v, q_offset, dims, scale=scale, causal=True,
                  window=window, softcap=softcap, slices=_slices, what=what)
    flash_extend_kernel.launches += 1
    return out


flash_extend_kernel.launches = 0
