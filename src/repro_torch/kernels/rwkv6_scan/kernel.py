"""CUDA RWKV6 WKV scan: the checked launcher of ``csrc/rwkv6_scan.cu``, the
port of the Pallas ``rwkv6_scan_kernel`` (``src/repro/kernels/rwkv6_scan/
kernel.py``).

Two launches a call: a chunk pass, one block a (chunk, head, batch row),
writes each chunk's intra-chunk output, and its state summary, decayed
queries and total decay to a workspace; a carry pass, one block a (slice
of the state's columns, head, batch row), walks the chunks in order, adds
the readout of the carried state and carries it. See the source for its
bound and design. :func:`plan_scan` is the host side of the launch as a
pure function of integers, so the CPU tests reach it. The kernel consumes
the log-decay (what the model computes) rather than the decay itself.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build, device_guard, stream_handle

_LIB = "rwkv6_scan"
_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
MAX_DIM = 64      # largest head size K and chunk L the kernel takes
SMEM_PER_BLOCK = 232_448      # bytes of shared memory a Hopper block may use
GRID_YZ = 65535               # largest grid y (heads) and z (batch rows)
GRID_X = 2 ** 31 - 1          # largest grid x (chunks)
# constants of the source: threads a block (both passes), prefix-sum
# segments a channel, state columns a carry block by default, chunks the
# carry pass stages at once, and the slice widths it is built for
THREADS, PARTS, SLICE, STAGES = 256, 4, 32, 3
SLICES = (8, 16, 32)


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """The launches of one call: the chunk pass on ``chunk_grid`` (none
    when T = 0) and the carry pass on ``carry_grid``, ``slice_cols`` state
    columns a carry block; each pass's dynamic shared memory; and the fp32
    workspace the chunk pass hands the carry pass: a record a (batch row,
    head, chunk) of its summary (K, K), its decayed queries (L, K) and its
    total decay (K)."""
    slice_cols: int
    chunk_grid: tuple[int, int, int]
    carry_grid: tuple[int, int, int]
    chunk_smem: int
    carry_smem: int
    workspace_floats: int
    launches: int


def tile_ld(n: int) -> int:
    """Row stride (floats) of a staged tile whose rows hold n values."""
    return -(-n // 4) * 4 + 4


@functools.lru_cache(maxsize=256)
def plan_scan(B: int, T: int, H: int, K: int, L: int,
              slice_cols: int = SLICE) -> ScanPlan:
    """The launches of a call as the source computes them; raises
    ``ValueError`` on what the kernels do not take."""
    if not 1 <= K <= MAX_DIM or not 1 <= L <= MAX_DIM or T < 0 or T % L:
        raise ValueError(f"head size {K} and chunk {L} must lie in [1, "
                         f"{MAX_DIM}] with T={T} a multiple of the chunk")
    if slice_cols not in SLICES:
        raise ValueError(f"slice of {slice_cols} state columns: one of "
                         f"{SLICES}")
    nc = T // L
    if not 0 <= B <= GRID_YZ or not 0 <= H <= GRID_YZ or nc > GRID_X:
        raise ValueError(f"grid limits: batch {B}, heads {H}, chunks {nc}")
    ld, lt = tile_ld(K), tile_ld(L)
    chunk_smem = 4 * (max(L * ld, K * lt, L * lt) + 2 * L * ld
                      + max(L * ld, K * lt) + L + K + PARTS * K)
    carry_smem = 4 * (STAGES * (L * ld + K * slice_cols + L * slice_cols
                                + ld) + 2 * -(-K // 4) * 4 * slice_cols)
    launches = 0 if B == 0 or H == 0 else 1 + (nc > 0)
    return ScanPlan(slice_cols, (nc, H, B), (-(-K // slice_cols), H, B),
                    chunk_smem, carry_smem,
                    B * H * nc * (K * K + L * K + K), launches)


def rwkv6_scan_kernel(r, k, v, logw, u, init_state=None, *,
                      chunk: int = 64, _slice: int | None = None):
    """r/k/v/logw (B, T, H, K) float32 on one GPU, T a multiple of
    ``L = min(chunk, T)``; u (H, K); init_state (B, H, K, K) or None.
    Returns (o (B, T, H, K), final_state (B, H, K, K)), both float32.
    Launches on the current stream and does not synchronize; two launches
    a call. ``_slice`` overrides the carry pass's state columns a block,
    for measurements only."""
    tensors = [r, k, v, logw, u] + ([] if init_state is None
                                    else [init_state])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("rwkv6_scan_kernel takes float32 tensors, got "
                        f"{[t.dtype for t in tensors]}")
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, logw)):
        raise ValueError(f"r/k/v/logw must share a (B, T, H, K) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, T, H, K = r.shape
    L = min(chunk, T) if T else 1
    if tuple(u.shape) != (H, K):
        raise ValueError(f"u {tuple(u.shape)} != {(H, K)}")
    if init_state is not None and tuple(init_state.shape) != (B, H, K, K):
        raise ValueError(f"init_state {tuple(init_state.shape)} != "
                         f"{(B, H, K, K)}")
    plan = plan_scan(B, T, H, K, L, _slice or SLICE)
    if not all(t.is_cuda and t.device == r.device for t in tensors):
        raise ValueError("rwkv6_scan_kernel: every tensor must be on the "
                         "same CUDA device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("rwkv6_scan_kernel takes contiguous tensors")
    dev = r.device
    o = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=dev)
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32, device=dev)
    fn = _build.function(_LIB, "rwkv6_scan_launch", _ARGTYPES)
    with device_guard(dev):
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                 u.data_ptr(),
                 None if init_state is None else init_state.data_ptr(),
                 o.data_ptr(), state.data_ptr(), ws.data_ptr(), B, T, H, K,
                 L, plan.slice_cols, stream_handle(dev))
    _build.check(_LIB, err, "rwkv6_scan_kernel")
    rwkv6_scan_kernel.launches += plan.launches
    return o, state


rwkv6_scan_kernel.launches = 0
