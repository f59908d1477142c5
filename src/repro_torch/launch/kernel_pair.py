"""Paged decode attention, page gather, page scatter, the RWKV6 WKV scan,
the RMS norm, the flash kernels' extend launch, decode attention with the
new token merged, the decode step's gate / up products and its qkv pass,
the chunk's qkv pass, decode attention's dense launch and zamba2's Mamba2
mixer timed the same way on any tree of the port, so that two trees can
be compared in one call on one card.

It calls only the wrappers' public signatures, which every tree of the
port shares, so this file times whichever tree ``PYTHONPATH`` names; run
it from the root of the tree that holds it::

    PYTHONPATH=<tree>/src python3 src/repro_torch/launch/kernel_pair.py

Cases (seeded inputs, bf16 pools of qwen2-1.5b's 28 layers, KV 2, Dh 128,
G 6, page 16):

- decode attention at ``chip_smoke.py``'s phase-2 shape (B 8, lengths
  4096, 0, 1, 17, 1000, 2048, 3333, 4095) and at the serve path's (B 4,
  2048 tokens each), the layer rotating over all 28 so that every call
  finds its pages cold in the 50 MB L2, as a decode step does;
- page gather of 128 pages x 28 layers out of a 1024-page pool, each call
  taking the next of 4 id sets (so that it finds its pages cold in the 50
  MB L2, as chip_smoke's page-move timings do), beside ``index_select``
  with the ids already on the device; device time also kernel by kernel
  (and copy by copy: a tree that uploads its ids shows the copy);
- page scatter of 128 pages x 28 layers, beside ``index_copy_`` with the
  ids already on the device;
- the WKV scan at rwkv6-3b's prefill (fp32, T 2048, H 40, K = L = 64,
  with an initial state) at B 1 (``chip_smoke.py``'s ``SCAN_MAIN``) and at
  B 2 (its phase 4), with the decays ``chip_smoke.check_scan`` times
  (log-decay -exp(0.1 N(0, 1)), near -1 a token);
- the RMS norm at path A's decode step (4 rows of qwen2-1.5b's 1536, bf16)
  in its three modes (alone, the residual sum read in fp32, rounded) and
  at a 512-token chunk's rows, and the flash kernels' extend launch at
  path A's chunk (512 queries of 12 heads on 2048 cached tokens of 2
  KV heads, 2560 slots, D 128, bf16), each by CUDA-graph replay
  (``graph_ms``: 20 calls a graph, 5 replays, device time alone) beside
  its bound; where the tree has it, an empty kernel's launch, the floor
  a graph node costs (``launch_floor``);
- the flash kernels' prefill launch at qwen2-1.5b's 2048 tokens (bf16,
  12 heads of 2 KV heads, D 128) by CUDA-graph replay, with a digest of
  its output's bits on inputs of their own seed, so two trees' outputs
  can be compared bit for bit;
- decode attention as the decode step calls it (``merge``): the serve
  path's pools with the new token merged (``new_kv``), the layer rotating,
  by CUDA-graph replay and by ``torch.profiler`` kernel by kernel, beside
  the residual call; with digests of the residuals, the normalized output
  and the merged output on inputs of their own seed (the phase-2 lengths,
  an empty row among them);
- the decode step's gate / up products with their activation
  (``gate_up``) at qwen2-1.5b's 4 x 1536 rows against (1536, 8960)
  weights, bf16, rotating over 3 weight copies so that each call finds
  them cold in L2: the route the tree's decode step takes (the parent's
  two cuBLAS products and ``gated_act_kernel``; where the tree has it,
  ``gate_up_act_kernel``'s one launch, and the parent's route timed
  beside it) by CUDA-graph replay, with digests of the outputs at 4 and
  16 rows;
- the decode step's qkv pass (``qkv``) at qwen2-1.5b's 4 and 16 x 1536
  rows against wq (1536, 12, 128), wk and wv (1536, 2, 128), bf16, with
  the qkv bias and RoPE at positions up to 32k, rotating over 12 weight
  copies (75 MB, past the L2): the parent's route (three cuBLAS products,
  then ``qkv_rope_kernel``) and, where the tree has it,
  ``qkv_proj_kernel``'s one launch, by CUDA-graph replay, with digests
  of q, k and v;
- the chunk's qkv pass (``chunk``: ``qkv_rope_chunk_kernel``) at path
  A's 512-row chunk (qwen2-1.5b's heads, offset 2048 on 2560 slots; the
  extend's, k / v into the cache alone, and the prefill's, the rows
  kept too), at qwen3-moe-235b-a22b's heads with the qk norm (128 rows),
  at stablelm-3b's partial rotary (128 rows) and in fp32 (qwen2's heads
  and stablelm's, 128 and 64 rows), by CUDA-graph replay beside one
  contiguous device copy of the same bytes, with a digest of q, the
  caches and the rows on inputs of their own seed;
- decode attention's dense launch (``dense``: path E's one-token
  attention) at gemma2-9b's global layer (B 1 and 4) and ring and at
  zamba2-2.7b's shared block, bf16, by CUDA-graph replay over 4 caches
  in turn, beside its bound and, without the softcap, SDPA with the
  length mask; a digest of its output; where the tree has them, the
  bf16 kernel's plan and other cluster sizes (``_cluster``, for
  measurements only);
- zamba2-2.7b's Mamba2 mixer (``mamba2``) at path E's shapes, bf16: the
  decode step after its in-products at B 2 (H 80, P 64, N 64, d_conv 4,
  from random conv and fp32 SSM states) and a B 2 x 2000-token prompt's
  SSD with its D skip, gate and norm, each as the tree's plain chain
  (``models/mamba2.py``'s ops, ``fused=False``) and, where the tree has
  them, as ``mamba2_step_kernel`` / ``ssd_chunk_kernel``, by CUDA-graph
  replay beside the bound, with digests of the kernels' outputs.

Each is timed eager (CUDA events around a loop of calls, host work
included where it is the slower side) and on the device (``torch.profiler``:
the device time of the kernels and copies a call enqueues, summed, gaps
excluded; for the scan also kernel by kernel), beside the least time the
card could take (bytes over 3.35 TB/s; for the scan the larger of that and
its fp32 flops over 67 TFLOP/s). Prints one JSON object with the card's
name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import subprocess

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.decode_attention import paged_decode_attention_kernel
from repro_torch.kernels.page_copy import (page_gather_kernel,
                                           page_scatter_kernel)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_kernel

HBM_BW = 3.35e12            # H100 SXM data sheet, bytes/s
FP32_PEAK = 67e12           # H100 SXM data sheet, fp32 FLOP/s
BF16_PEAK = 989e12          # H100 SXM data sheet, dense bf16 FLOP/s
LAYERS, KV, G, DH, PAGE = 28, 2, 6, 128, 16
DECODE_CASES = {"phase2": (4096, 0, 1, 17, 1000, 2048, 3333, 4095),
                "serve": (2048,) * 4}
SCATTER_PAGES = 128
GATHER_PAGES, GATHER_POOL, GATHER_SETS = 128, 1024, 4
SCAN_CASES = {"rwkv6_scan": dict(B=1, T=2048, H=40, K=64, L=64),
              "rwkv6_scan_b2": dict(B=2, T=2048, H=40, K=64, L=64)}


def eager_ms(fn, iters: int = 28, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int = 28, warmup: int = 3) -> dict:
    """Device time a call by kernel or copy name: each one's time in a
    profiled loop of ``iters`` calls, over ``iters``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            v = getattr(e, "self_device_time_total", None)
            v = float(v if v is not None else e.self_cuda_time_total)
            out[e.key] = out.get(e.key, 0.0) + v / 1e3 / iters
    return out


def device_ms(fn, iters: int = 28, warmup: int = 3) -> float:
    """Device time a call: every kernel's and copy's time, summed."""
    return sum(device_profile(fn, iters, warmup).values())


def decode_case(lens, gen) -> dict:
    rng = np.random.default_rng(0)
    n_live = [math.ceil(n / PAGE) for n in lens]
    n_tab = max(1, max(n_live))
    P = sum(n_live) + 16
    tables = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(len(lens), n_tab),
                          dtype=np.int64).astype(np.int32)
    perm, used = rng.permutation(P), 0
    for b, n in enumerate(n_live):
        tables[b, :n] = perm[used:used + n]
        used += n
    pool = (LAYERS, P, PAGE, KV, DH)
    rand = lambda *s: torch.randn(s, generator=gen,  # noqa: E731
                                  device="cuda").to(torch.bfloat16)
    live = int(sum(lens))
    nbytes = (len(lens) * KV * G * DH * 2 + 2 * live * KV * DH * 2
              + 4 * sum(n_live) + 4 * len(lens) + len(lens) * KV * G * DH * 4
              + 2 * len(lens) * KV * G * 4)
    return dict(q=rand(len(lens), KV * G, DH), k=rand(*pool), v=rand(*pool),
                tables=torch.from_numpy(tables).cuda(),
                lens=torch.tensor(lens, dtype=torch.int32, device="cuda"),
                bound_ms=nbytes / HBM_BW * 1e3)


def time_decode(case: dict) -> dict:
    layers = itertools.cycle(range(LAYERS))

    def call():
        return paged_decode_attention_kernel(
            case["q"], case["k"], case["v"], case["tables"], case["lens"],
            layer=next(layers), return_residuals=True)

    return dict(eager_ms=eager_ms(call), device_ms=device_ms(call),
                bound_ms=case["bound_ms"])


def time_gather(gen) -> dict:
    pool = torch.randn((LAYERS, GATHER_POOL, PAGE, KV, DH), generator=gen,
                       device="cuda").to(torch.bfloat16)
    rng = np.random.default_rng(2)
    sets = [rng.permutation(GATHER_POOL)[:GATHER_PAGES]
            for _ in range(GATHER_SETS)]
    sets_dev = [torch.from_numpy(ids).cuda() for ids in sets]
    for ids, ids_dev in zip(sets, sets_dev):
        assert torch.equal(page_gather_kernel(pool, ids),
                           torch.index_select(pool, 1, ids_dev)), \
            "gather differs from index_select"
    turn = itertools.cycle(range(GATHER_SETS))
    kern = lambda: page_gather_kernel(pool, sets[next(turn)])  # noqa: E731
    lib = lambda: torch.index_select(pool, 1,  # noqa: E731
                                     sets_dev[next(turn)])
    moved = 2 * LAYERS * GATHER_PAGES * PAGE * KV * DH * 2 + 4 * GATHER_PAGES
    by_kernel = device_profile(kern)
    return dict(eager_ms=eager_ms(kern), device_ms=sum(by_kernel.values()),
                device_ms_by_kernel=by_kernel, library_ms=eager_ms(lib),
                library_device_ms=device_ms(lib),
                bound_ms=moved / HBM_BW * 1e3)


def time_scatter(gen) -> dict:
    P = 1024
    pool = torch.randn((LAYERS, P, PAGE, KV, DH), generator=gen,
                       device="cuda").to(torch.bfloat16)
    lib_pool = pool.clone()
    ids = np.random.default_rng(1).permutation(P)[:SCATTER_PAGES]
    ids_dev = torch.from_numpy(ids).cuda()
    staging = torch.randn((LAYERS, SCATTER_PAGES, PAGE, KV, DH),
                          generator=gen, device="cuda").to(torch.bfloat16)
    kern = lambda: page_scatter_kernel(pool, staging, ids)  # noqa: E731
    lib = lambda: lib_pool.index_copy_(1, ids_dev, staging)  # noqa: E731
    kern()
    lib()
    torch.cuda.synchronize()
    assert torch.equal(pool, lib_pool), "scatter differs from index_copy_"
    moved = 2 * staging.numel() * staging.element_size() + 4 * len(ids)
    return dict(eager_ms=eager_ms(kern), device_ms=device_ms(kern),
                library_ms=eager_ms(lib), library_device_ms=device_ms(lib),
                bound_ms=moved / HBM_BW * 1e3)


def time_scan(shape: dict, gen) -> dict:
    """The scan's public call at ``shape``; the bound is the function's:
    r, k, v, log-decay read and o written once, u and the states in and
    out; the strictly-lower scores and their product with v, the readout
    and the state update (``chip_smoke.scan_work``)."""
    B, T, H, K, L = (shape[x] for x in ("B", "T", "H", "K", "L"))
    n = lambda *d: torch.randn(d, generator=gen, device="cuda")  # noqa
    r, k, v = n(B, T, H, K) * 0.5, n(B, T, H, K) * 0.5, n(B, T, H, K) * 0.5
    lw, u, s0 = -torch.exp(0.1 * n(B, T, H, K)), n(H, K) * 0.3, \
        n(B, H, K, K) * 0.1
    call = lambda: rwkv6_scan_kernel(r, k, v, lw, u, s0, chunk=L)  # noqa
    nbytes = 4 * (5 * B * T * H * K + 2 * B * H * K * K + H * K)
    flops = 2.0 * B * H * (T // L) * (2 * (L * (L - 1) // 2) * K
                                      + 2 * L * K * K)
    by_kernel = device_profile(call)
    return dict(eager_ms=eager_ms(call), device_ms=sum(by_kernel.values()),
                device_ms_by_kernel=by_kernel,
                bound_ms=max(nbytes / HBM_BW, flops / FP32_PEAK) * 1e3)


def graph_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 5) -> float:
    """Device ms a call: ``iters`` calls captured in one CUDA graph,
    ``reps`` replays timed with CUDA events (as ``chip_smoke.graph_ms``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


NORM_D, NORM_ROWS = 1536, (4, 512)
EXTEND = dict(B=1, H=12, KV=2, C=512, T=2560, D=128, off=2048)


def time_norms(gen) -> dict:
    """The norm's public call at path A's rows: device ms of each mode at
    4 rows and of the fp32-sum mode at 512, beside each one's bytes over
    the HBM rate; the launch floor where the tree has an empty kernel."""
    from repro_torch.kernels.fusions import rms_norm_kernel
    out = {}
    scale = torch.randn(NORM_D, generator=gen, device="cuda").to(
        torch.bfloat16)
    for rows in NORM_ROWS:
        x, d = (torch.randn((rows, 1, NORM_D), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        modes = {"add_fp32": (d, True)} if rows > 4 else \
            {"plain": (None, False), "add_fp32": (d, True),
             "add_rounded": (d, False)}
        for mode, (delta, f32) in modes.items():
            nbytes = (2 + 2 * (delta is not None)) * rows * NORM_D * 2 \
                + NORM_D * 2
            out[f"rows{rows}_{mode}"] = dict(
                device_ms=graph_ms(lambda: rms_norm_kernel(x, scale, 1e-6,
                                                           delta, f32)),
                bound_ms=nbytes / HBM_BW * 1e3)
    try:
        from repro_torch.kernels.fusions.kernel import empty_kernel_launch
    except ImportError:
        return out
    device = scale.device
    out["launch_floor"] = dict(device_ms=graph_ms(
        lambda: empty_kernel_launch(device)))
    return out


def time_extend(gen) -> dict:
    """The extend launch's public call at path A's chunk, the cache NaN
    past the chunk's end (none at this offset); bound: its flops over the
    bf16 peak (``chip_smoke.extend_work``'s count)."""
    from repro_torch.kernels.flash_attention import flash_extend_kernel
    B, H, KV, C, T, D, off = (EXTEND[x] for x in
                              ("B", "H", "KV", "C", "T", "D", "off"))
    q = torch.randn((B, C, H, D), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((B, T, KV, D), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2) for _ in range(2))
    offs = torch.full((B,), off, dtype=torch.int32, device="cuda")
    pairs = sum(off + i + 1 for i in range(C))
    return dict(device_ms=graph_ms(lambda: flash_extend_kernel(q, k, v,
                                                               offs)),
                bound_ms=4.0 * D * pairs * H / BF16_PEAK * 1e3)


FLASH = dict(B=1, H=12, KV=2, S=2048, D=128)


def time_flash() -> dict:
    """The prefill launch's public call at FLASH, inputs from their own
    seed; ``bits``: a digest of the output's bytes."""
    import hashlib
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, H, KV, S, D = (FLASH[x] for x in ("B", "H", "KV", "S", "D"))
    q, k, v = (torch.randn((B, S, n, D), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2) for n in (H, KV, KV))
    out = flash_attention_kernel(q, k, v)
    bits = hashlib.sha256(out.contiguous().view(torch.int16).cpu().numpy()
                          .tobytes()).hexdigest()[:16]
    flops = 4.0 * D * H * B * S * (S + 1) / 2
    return dict(device_ms=graph_ms(lambda: flash_attention_kernel(q, k, v)),
                bound_ms=flops / BF16_PEAK * 1e3, bits=bits)


def digest(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy()
                          .tobytes()).hexdigest()[:16]


def time_merge(gen) -> dict:
    """Decode attention as the decode step calls it, the new token merged,
    at the serve path's pools (the layer rotating), beside the residual
    call; digests of every mode's output on seeded inputs."""
    case = decode_case(DECODE_CASES["serve"], gen)
    args = (case["q"], case["k"], case["v"], case["tables"], case["lens"])
    B = case["q"].shape[0]
    toks = [torch.randn((2, B, KV, DH), generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(LAYERS)]
    layers = itertools.cycle(range(LAYERS))

    def merged():
        li = next(layers)
        return paged_decode_attention_kernel(*args, layer=li,
                                             new_kv=(toks[li][0],
                                                     toks[li][1]))

    def residual():
        return paged_decode_attention_kernel(*args, layer=next(layers),
                                             return_residuals=True)

    out = dict(merged_graph_ms=graph_ms(merged, iters=LAYERS),
               residual_graph_ms=graph_ms(residual, iters=LAYERS),
               merged_by_kernel=device_profile(merged),
               bound_ms=case["bound_ms"])
    g = torch.Generator(device="cuda").manual_seed(3)
    case = decode_case(DECODE_CASES["phase2"], g)
    args = (case["q"], case["k"], case["v"], case["tables"], case["lens"])
    B = case["q"].shape[0]
    kn, vn = (torch.randn((B, KV, DH), generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))
    acc, m, l = paged_decode_attention_kernel(*args, layer=5,
                                              return_residuals=True)
    out["bits"] = dict(
        residuals=digest(torch.cat([acc.flatten(), m.flatten(),
                                    l.flatten()])),
        normalized=digest(paged_decode_attention_kernel(*args, layer=5)),
        merged=digest(paged_decode_attention_kernel(*args, layer=5,
                                                    new_kv=(kn, vn))))
    return out


GATE_UP = dict(D=1536, F=8960, rows=(4, 16), sets=3)


def time_gate_up(gen) -> dict:
    """The decode step's gated product at qwen2-1.5b's widths: the tree's
    route and, where the tree has it, the one-launch kernel; digests."""
    from repro_torch.kernels import fusions
    D, F = GATE_UP["D"], GATE_UP["F"]
    ws = [tuple((torch.randn((D, F), generator=gen, device="cuda") *
                 D ** -0.5).to(torch.bfloat16) for _ in range(2))
          for _ in range(GATE_UP["sets"])]
    turn = itertools.cycle(ws)
    one = getattr(fusions, "gate_up_act_kernel", None)
    out = dict(bound_ms=2 * D * F * 2 / HBM_BW * 1e3,
               has_kernel=one is not None)
    for rows in GATE_UP["rows"]:
        x = torch.randn((rows, 1, D), generator=gen, device="cuda").to(
            torch.bfloat16)

        def route():
            w1, w3 = next(turn)
            return fusions.gated_act_kernel(x @ w1, x @ w3, "silu")

        rec = {"route_graph_ms": [graph_ms(route)]}
        if one is not None:
            rec["kernel_graph_ms"] = graph_ms(
                lambda: one(x, *next(turn), "silu"))
            rec["route_graph_ms"].append(graph_ms(route))
            rec["kernel_by_kernel"] = device_profile(
                lambda: one(x, *next(turn), "silu"))
            rec["kernel_bits"] = digest(one(x, *ws[0], "silu"))
        rec["route_bits"] = digest(fusions.gated_act_kernel(
            x @ ws[0][0], x @ ws[0][1], "silu"))
        out[f"rows{rows}"] = rec
    return out


QKV = dict(D=1536, H=12, KV=2, Dh=128, rows=(4, 16), sets=12)


def time_qkv() -> dict:
    """The decode step's qkv pass at qwen2-1.5b's widths: the parent's
    route and, where the tree has it, the one launch; digests of q, k
    and v. Inputs from their own seed."""
    from repro_torch.kernels import fusions
    from repro_torch.models.common import rope_tables
    gen = torch.Generator(device="cuda").manual_seed(4)
    D, H, KV, Dh = (QKV[x] for x in ("D", "H", "KV", "Dh"))

    def r(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") *
                std).to(torch.bfloat16)

    ws = [(r(D, H, Dh, std=D ** -0.5), r(D, KV, Dh, std=D ** -0.5),
           r(D, KV, Dh, std=D ** -0.5)) for _ in range(QKV["sets"])]
    bias = (r(H, Dh, std=0.5), r(KV, Dh, std=0.5), r(KV, Dh, std=0.5))
    turn = itertools.cycle(ws)
    one = getattr(fusions, "qkv_proj_kernel", None)
    out = dict(bound_ms=2 * D * (H + 2 * KV) * Dh / HBM_BW * 1e3,
               has_kernel=one is not None)
    for rows in QKV["rows"]:
        x = r(rows, 1, D)
        pos = torch.randint(0, 32768, (rows, 1), generator=gen,
                            device="cuda")
        kw = dict(k_out=r(rows, KV, Dh), v_out=r(rows, KV, Dh), bias=bias,
                  rope=rope_tables(pos, Dh, 1e6, 1.0))

        def route(w=None):
            wq, wk, wv = w or next(turn)
            q, k, v = ((x @ t.reshape(D, -1)).reshape(rows, -1, Dh)
                       for t in (wq, wk, wv))
            return fusions.qkv_rope_kernel(q, k, v, **kw)

        def bits(f):
            q = f(ws[0])
            torch.cuda.synchronize()
            return digest(torch.cat([q.flatten(), kw["k_out"].flatten(),
                                     kw["v_out"].flatten()]))

        rec = {"route_graph_ms": [graph_ms(route)],
               "route_bits": bits(route)}
        if one is not None:
            rec["kernel_graph_ms"] = graph_ms(
                lambda: one(x, *next(turn), **kw))
            rec["route_graph_ms"].append(graph_ms(route))
            rec["kernel_bits"] = bits(lambda w: one(x, *w, **kw))
        out[f"rows{rows}"] = rec
    return out


#: (H, KV, Dh, rope fraction, bias, qk norm, dtype, rows, slots, rows
#: kept): path A's chunk as the extend and as the prefill takes it, a
#: qk-normed family, partial rotary, fp32
CHUNKS = {"qwen2_extend": (12, 2, 128, 1.0, True, False, "bfloat16", 512,
                           2560, False),
          "qwen2_prefill": (12, 2, 128, 1.0, True, False, "bfloat16", 512,
                            2560, True),
          "qwen3moe": (64, 4, 128, 1.0, False, True, "bfloat16", 128, 640,
                       False),
          "stablelm": (32, 32, 80, 0.25, False, False, "bfloat16", 128, 640,
                       False),
          "qwen2_fp32": (12, 2, 128, 1.0, True, False, "float32", 128, 640,
                         False),
          "stablelm_fp32": (32, 32, 80, 0.25, False, True, "float32", 64,
                            320, True)}


def time_chunk() -> dict:
    """The chunk's qkv launch on each of CHUNKS at offset slots - rows
    (path A's 512 rows: 2048 of 2560 slots), by CUDA-graph replay beside
    its bytes' bound; digests of q, the caches and the rows. Inputs from
    their own seed."""
    from repro_torch.kernels.fusions import qkv_rope_chunk_kernel
    from repro_torch.models.common import rope_tables
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = {}
    for name, (H, KV, Dh, frac, bias, norm, dt, C, T, rows) in \
            CHUNKS.items():
        dtype = getattr(torch, dt)

        def r(*shape, std=1.0):
            return (torch.randn(shape, generator=gen, device="cuda") *
                    std).to(dtype)

        off = torch.tensor([T - C], dtype=torch.int32, device="cuda")
        pos = off.long()[:, None] + torch.arange(C, device="cuda")
        kw = dict(cache_k=r(1, T, KV, Dh), cache_v=r(1, T, KV, Dh),
                  offsets=off,
                  bias=(r(H, Dh, std=0.5), r(KV, Dh, std=0.5),
                        r(KV, Dh, std=0.5)) if bias else None,
                  norm=(r(Dh, std=0.1), r(Dh, std=0.1)) if norm else None,
                  eps=1e-6, rope=rope_tables(pos, Dh, 1e4, frac))
        if rows:
            kw.update(k_rows=r(C, KV, Dh), v_rows=r(C, KV, Dh))
        q, k, v = r(C, H, Dh), r(C, KV, Dh), r(C, KV, Dh)
        esz = q.element_size()
        nbytes = esz * (C * (H + 2 * KV) * Dh * 2
                        + (C * 2 * KV * Dh if rows else 0)
                        + ((H + 2 * KV) * Dh if bias else 0)) \
            + 2 * kw["rope"][0].numel() * 4 + 4
        call = lambda: qkv_rope_chunk_kernel(q, k, v, **kw)  # noqa: E731
        ms = graph_ms(call)
        qo = call()
        torch.cuda.synchronize()
        # the same bytes moved by one contiguous device copy (half read,
        # half written): a single-wave pass's floor on this card
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device="cuda")
        dst = torch.empty_like(src)
        out[name] = dict(graph_ms=ms, bound_ms=nbytes / HBM_BW * 1e3,
                         copy_graph_ms=graph_ms(lambda: dst.copy_(src)),
                         bits=digest(torch.cat([
                             t.flatten() for t in (qo, kw["cache_k"],
                                                   kw["cache_v"],
                                                   kw.get("k_rows"),
                                                   kw.get("v_rows"))
                             if t is not None])))
    return out


#: decode attention's dense launch (path E's one-token attention): the
#: shapes of ``chip_smoke.py``'s DENSE_DECODE (gemma2-9b's global layer and
#: ring with the softcap 50, zamba2-2.7b's shared block) and gemma2-9b's
#: global layer at B 4: (B, T, KV, G, D, softcap, offset)
DENSE = {"gemma2-9b global": (1, 4672, 8, 2, 256, 50.0, 4631),
         "gemma2-9b local ring": (1, 4096, 8, 2, 256, 50.0, 4631),
         "zamba2-2.7b shared": (2, 2048, 32, 1, 80, 0.0, 2031),
         "gemma2-9b global B4": (4, 4672, 8, 2, 256, 50.0, 4631)}
DENSE_SETS = 4            # caches a timed call rotates over (cold in L2)
#: the bf16 kernel's cluster sizes timed where the tree has them
#: (``_cluster``), beside its own plan
DENSE_SWEEP = {"gemma2-9b global": (16, 8),
               "zamba2-2.7b shared": (6, 16)}


def time_dense() -> dict:
    """The dense launch at DENSE's shapes in bf16, by CUDA-graph replay
    over DENSE_SETS caches in turn (``graph_ms``), beside its bound (q, the
    live K / V rows and the output once at 3.35 TB/s) and, where the
    scores take no softcap, ``scaled_dot_product_attention`` with the
    rows' length mask on the same caches; a digest of its output's bits
    on inputs of their own seed. Where the tree has them, the plan the
    kernel takes and the DENSE_SWEEP cluster sizes (each checked bit for bit against the plan's output when the
    split is the same, else within 2e-2)."""
    import inspect
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.decode_attention import kernel as dk
    kern = da.dense_decode_attention_kernel
    tunable = "_cluster" in inspect.signature(kern).parameters
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = {}
    for name, (B, T, KV, G, D, cap, off) in DENSE.items():
        caches = [torch.randn((DENSE_SETS, B, T, KV, D), generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2)]
        q = torch.randn((B, KV * G, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        offs = torch.full((B,), off, dtype=torch.int32, device="cuda")
        live = min(off + 1, T)
        window = T if "ring" in name else 0
        scale = 1.0 / math.sqrt(D)
        sets = itertools.cycle(range(DENSE_SETS))

        def call(**kw):
            i = next(sets)
            return kern(q, caches[0][i], caches[1][i], offs, scale=scale,
                        softcap=cap, window=window, **kw)

        nbytes = 2 * 2 * B * KV * G * D + 2 * 2 * B * live * KV * D + 4 * B
        rec = dict(graph_ms=graph_ms(call, iters=4 * DENSE_SETS),
                   bound_ms=nbytes / HBM_BW * 1e3)
        ref = kern(q, caches[0][0], caches[1][0], offs, scale=scale,
                   softcap=cap, window=window)
        rec["bits"] = digest(ref)
        if not cap:
            mask = (torch.arange(T, device="cuda") < live)[None, None, None]
            kc = [c.transpose(2, 3) for c in caches]

            def sdpa():
                i = next(sets)
                k, v = kc[0][i], kc[1][i]
                if G > 1:
                    k, v = (t.repeat_interleave(G, 1) for t in (k, v))
                return F.scaled_dot_product_attention(
                    q.view(B, KV * G, 1, D), k, v, attn_mask=mask,
                    scale=scale)

            rec["sdpa_graph_ms"] = graph_ms(sdpa, iters=4 * DENSE_SETS)
        if tunable:
            plan = dk.plan_dense_decode(B, T, KV, G, D, 2)
            rec["plan"] = dataclasses.asdict(plan.split)
            for cl in DENSE_SWEEP.get(name, ()):
                got = kern(q, caches[0][0], caches[1][0], offs, scale=scale,
                           softcap=cap, window=window, _cluster=cl)
                gap = (got.float() - ref.float()).abs().max().item()
                assert (torch.equal(got, ref) if cl == plan.split.cluster
                        else gap <= 2e-2), (name, cl, gap)
                rec[f"cluster {cl}"] = dict(
                    graph_ms=graph_ms(lambda: call(_cluster=cl),
                                      iters=4 * DENSE_SETS),
                    max_abs_gap=gap)
        out[name] = rec
        del caches
        torch.cuda.empty_cache()
    return out


#: zamba2-2.7b's Mamba2 widths and path E's shapes: heads, head dim,
#: state, groups, d_conv, chunk; the decode batch; the prompt's (B, S)
MAMBA2 = dict(H=80, P=64, N=64, G=1, K=4, chunk=64, B=2, prompt=(2, 2000))


def _mamba2_plain(inp: dict, w: dict, decode: bool, eps: float):
    """The plain spelling's Mamba2 chain after the in-products
    (``models/mamba2.py``, ``fused=False``): for a decode step the conv,
    SiLU, softplus and recurrence, for a prompt the SSD (from
    conv'd inputs); then the D skip, gate and norm; the states written
    back as the model's cache copy does."""
    import torch.nn.functional as F
    from repro_torch.models import mamba2
    from repro_torch.models.common import _silu, rms_norm
    H, P, N, G = (w[k] for k in ("H", "P", "N", "G"))
    A = -torch.exp(inp["A_log"].float())
    if decode:
        conv, new_conv = mamba2._causal_conv(
            torch.cat([inp["x"], inp["bm"], inp["cm"]], dim=-1)[:, None],
            inp["conv_w"], inp["conv_b"], inp["conv_state"])
        conv = _silu(conv)
        xr = conv[..., :H * P].unflatten(-1, (H, P))
        Bm = conv[..., H * P:H * P + G * N].unflatten(-1, (G, N))
        Cm = conv[..., H * P + G * N:].unflatten(-1, (G, N))
        dt = F.softplus(inp["dt"][:, None].float()
                        + inp["dt_bias"].float())
        state, z, mode = inp["ssm_state"], inp["z"][:, None], "decode"
        inp["conv_state"].copy_(new_conv)
    else:
        xr, Bm, Cm, dt = inp["xr"], inp["Bm"], inp["Cm"], inp["dt"]
        state, z, mode = inp["state"], inp["z"], "prefill"
    y, new = mamba2._ssd(xr, dt, A, Bm, Cm, state, chunk=w["chunk"],
                         mode=mode)
    y = y + xr.float() * inp["D"].float()[:, None]
    y = y.to(z.dtype).float() * _silu(z).float()
    state.copy_(new)
    return rms_norm(y, inp["norm"], eps).to(z.dtype)


def time_mamba2() -> dict:
    """zamba2-2.7b's Mamba2 decode step and prompt SSD, bf16: the plain
    chain and, where the tree has them, the kernels, by CUDA-graph replay
    (the states updated in place each call), beside each kernel's bound
    (bytes at 3.35 TB/s or fp32 flops at 67 TFLOP/s, the larger); digests
    of the kernels' outputs on inputs of their own seed."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models.common import _silu
    try:
        from repro_torch.kernels import mamba2 as mk
    except ImportError:
        mk = None
    w = MAMBA2
    eps = get_config("zamba2-2.7b").norm_eps
    H, P, N, G, K = (w[k] for k in ("H", "P", "N", "G", "K"))
    C = H * P + 2 * G * N
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rand(*shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda") * std
                + mean).to(dtype)

    prm = dict(conv_w=rand(K, C, std=0.3), conv_b=rand(C, std=0.1),
               dt_bias=rand(H, std=0.5, mean=-1.0),
               A_log=rand(H, std=0.5, mean=0.5),
               D=rand(H, std=0.3, mean=1.0), norm=rand(H, P, std=0.1))
    B = w["B"]
    step = dict(z=rand(B, H, P), x=rand(B, H * P), bm=rand(B, G * N),
                cm=rand(B, G * N), dt=rand(B, H), **prm,
                conv_state=rand(B, K - 1, C),
                ssm_state=rand(B, H, P, N, dtype=torch.float32))
    Bp, S = w["prompt"]
    conv = _silu(rand(Bp, S, C))
    prompt = dict(xr=conv[..., :H * P].unflatten(-1, (H, P)),
                  dt=F.softplus(rand(Bp, S, H, dtype=torch.float32)
                                + prm["dt_bias"].float()),
                  A_log=prm["A_log"],
                  Bm=conv[..., H * P:H * P + G * N].unflatten(-1, (G, N)),
                  Cm=conv[..., H * P + G * N:].unflatten(-1, (G, N)),
                  z=rand(Bp, S, H, P), D=prm["D"], norm=prm["norm"],
                  state=rand(Bp, H, P, N, dtype=torch.float32))
    step_bytes = 2 * B * H * P * N * 4
    out = dict(step=dict(plain_graph_ms=graph_ms(
        lambda: _mamba2_plain(step, w, True, eps)),
        bound_ms=step_bytes / HBM_BW * 1e3),
        prompt=dict(plain_graph_ms=graph_ms(
            lambda: _mamba2_plain(prompt, w, False, eps), iters=3,
            reps=2)))
    if mk is None:
        return out
    from repro_torch.kernels.mamba2.kernel import chunk_work, step_work
    sargs = {k: v for k, v in step.items()
             if k not in ("conv_state", "ssm_state")}
    skern = lambda: mk.mamba2_step_kernel(  # noqa: E731
        **sargs, conv_state=step["conv_state"],
        ssm_state=step["ssm_state"], eps=eps)
    order = ("xr", "dt", "A_log", "Bm", "Cm", "z", "D", "norm", "state")
    ckern = lambda: mk.ssd_chunk_kernel(  # noqa: E731
        *(prompt[k] for k in order), chunk=w["chunk"], eps=eps)
    nbytes, ops = step_work(B, H, P, N, G, K, 2)
    out["step"].update(graph_ms=graph_ms(skern), bits=digest(skern()),
                       bound_ms=max(nbytes / HBM_BW, ops / FP32_PEAK) * 1e3)
    nbytes, ops = chunk_work(Bp, S, H, P, N, G, w["chunk"], 2)
    out["prompt"].update(graph_ms=graph_ms(ckern, iters=5),
                         bits=digest(ckern()[0]),
                         bound_ms=max(nbytes / HBM_BW, ops / FP32_PEAK)
                         * 1e3)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--only", default="",
                    help="comma-separated cases to time (decode, gather, "
                         "scatter, scan, norm, extend, flash, merge, "
                         "gate_up, qkv, chunk, dense, mamba2); all by "
                         "default")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_pair: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    only = set(filter(None, args.only.split(",")))
    want = lambda case: not only or case in only  # noqa: E731
    out = {"label": args.label, "card": smi}
    if want("decode"):
        for name, lens in DECODE_CASES.items():
            case = decode_case(lens, gen)
            out[f"decode_{name}"] = time_decode(case)
            del case
            torch.cuda.empty_cache()
    if want("gather"):
        out["page_gather"] = time_gather(gen)
        torch.cuda.empty_cache()
    if want("scatter"):
        out["page_scatter"] = time_scatter(gen)
    if want("scan"):
        for name, shape in SCAN_CASES.items():
            out[name] = time_scan(shape, gen)
            torch.cuda.empty_cache()
    if want("norm"):
        out["rms_norm"] = time_norms(gen)
    if want("extend"):
        out["flash_extend"] = time_extend(gen)
    if want("flash"):
        out["flash_attention"] = time_flash()
    if want("merge"):
        out["decode_merge"] = time_merge(gen)
        torch.cuda.empty_cache()
    if want("gate_up"):
        out["gate_up"] = time_gate_up(gen)
    if want("qkv"):
        out["qkv"] = time_qkv()
        torch.cuda.empty_cache()
    if want("chunk"):
        out["chunk"] = time_chunk()
        torch.cuda.empty_cache()
    if want("dense"):
        out["dense"] = time_dense()
        torch.cuda.empty_cache()
    if want("mamba2"):
        out["mamba2"] = time_mamba2()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
