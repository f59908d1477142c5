#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with one card::

    python3 chip_smoke.py

Phase 0  the device: name and power limit (nvidia-smi), TF32 off.
Phase 1  build every CUDA kernel from ``src/repro_torch/csrc`` (nvcc,
         sm_90a), all sources in parallel; log each kernel's registers and
         spills, and the HGMMA (wgmma) count of each flash kernel in the
         built library's SASS, which must be > 0 for the bf16 kernels
         (where the toolkit has ``cuobjdump``; else "not checked").
Phase 2  every kernel against its plain PyTorch version on the card, at
         the main paths' shapes, timed beside the least time the card
         could take and, where one exists, the one PyTorch call computing
         the same function, each by an eager loop (``ms``) and by CUDA-graph
         replay (``device_ms``, device time alone); a bound share over 100%
         fails the run. Paged decode attention and the page moves at
         full-width qwen2-1.5b (L=28, KV=2, Dh=128, H=12, page=16, bf16
         pools, B=8, ragged lengths up to 4096 with a zero-length row and
         garbage in dead table slots), decode timed with the layer rotating
         over all 28 (cold in L2, as a decode step's layer loop finds its
         pages) and beside it at the serve step (B=4 x 2048 tokens), with
         the device time of each split length of SPLIT_CHOICES logged; the
         page moves timed over 4 id sets and staging buffers (cold too).
         Decode also at glm4-9b's width (G=16) with rows up to 8k tokens,
         one 16k-token row, stablelm-3b's, musicgen-large's and a gemma2-
         like layer's heads (Dh 80, 64, 256) and the smoke models' shapes
         (Dh=8, G=3, page=8; Dh=16, G=2, page=16), in bf16 and fp32; at
         every shape
         batched equals one-row and a table widened with garbage changes
         nothing, bit for bit, empty rows are exact and a live id outside
         the pool turns its row (only) to NaN. Flash attention at qwen2-
         1.5b's prefill shape (B=1, H=12, KV=2, S=2048, D=128, bf16),
         through the model's strided layout too, at D=80 with S not a
         multiple of the tile, at a gemma2-like shape (D=256, window
         4096, softcap 50, S=8192), at qwen3-moe's heads (H=64, KV=4,
         D=128; S=512 and 16) and at zamba2-2.7b's shared blocks (B=2,
         H=KV=32, D=80, S=2000), in bf16 (both query-tile heights) and
         fp32, beside SDPA at the prefill shape, at the serving path's
         512-token chunk and at the gemma2-like shape, with bf16 inputs TMA
         cannot take refused; token append also at 300 rows (two launches)
         and page scatter at 600 pages (two launches), bad ids refused;
         page gather at 700 pages with repeated ids (two launches), rows
         of several bulk pieces and rows the bulk copy cannot take, an id
         out of range refused, and its device time on the bulk path beside
         the row kernel's (an edited build of the source); the tier-move
         legs at qwen2-1.5b width, 128 pages x 28 layers, both pools: the
         stage-out (two gathers, then a blocking copy of each pool's
         staging into fresh pinned memory) and the reload (the H2D copy
         and two scatters), each in ms with its gather or scatter share
         and its host-link GB/s against the profile's h2d_bw; the
         RWKV6 scan at rwkv6-3b's prefill shape (T=2048, H=40, K=64) and
         at the smoke shape (K=L=16) with a carried state, where it is also
         held against the sequential recurrence; at one chunk, K=64 with
         L=32 and K=10 (4-byte copies), with and without an initial state;
         a B=2 call's rows equal B=1 calls bit for bit; and its device time
         logged for each carry-pass slice width at B=1 and B=2.
Phase 3  path A, the serving main path: full-width qwen2-1.5b (28 layers,
         seeded random weights cast once to bf16) serving agent programs
         through the unchanged ``Engine`` with a ``TorchModelBackend``:
         (a) the differential replay, the physical leg on a shadow clock
         priced by the card's datasheet profile, which must make the
         logical leg's decisions with every restore and COW split bit-exact
         and with pins, TTL hits, demotions, restores and COW splits all
         exercised; (b) the same programs on the measured clock, for JCT
         and throughput; between them, the card's mfu and decode_eff
         fitted to 3a's measured step times (``calibrate_hardware``) and
         logged with their residuals (3b keeps the datasheet profile).
         Launch counts are zeroed before phase 3 and read
         after it: every kernel of the path (decode attention, the page
         moves, flash attention in each fresh prefill) must have run there,
         flash attention in 3a and in 3b. Then the prefill logits through
         the flash kernel against prefill + extend (dense attention) of
         the same 1024-token prompt, in bf16 and fp32, on the first 2
         layers at full width, and a logged depth sweep.
Phase 4  path B: full-width rwkv6-3b (32 layers, seeded random weights)
         through ``Model.forward``: B=2, a 2048-token prompt, then 32
         decode steps, for tokens/s in bf16, with the counts zeroed before
         and read after (two WKV-scan launches, chunk and carry pass, per
         layer and prefill); then,
         in fp32 on the first 4 layers at full width, the prefill's final
         WKV states and last logits against prefill of all but 64 tokens
         followed by 64 decode steps (the plain recurrence), and against
         two prefill calls with the state carried; a depth sweep up to 32
         layers is logged, with the greedy token asserted at full depth.

Phase 5  path C, the cluster: the phase-3 model's weights shared by every
         replica, each a shadow-clocked ``TorchModelBackend`` with phase
         3's pool of 512 blocks, the telemetry plane attached, ``Cluster.
         check`` after every step: (a) three replicas under
         ``kv_aware_migrate`` on a skewed agent workload (3 tenants, tool
         storms, churn; contexts up to ~2k tokens), (b) the elastic fleet
         (two decode replicas and one prefill replica to start, the
         autoscaler on thresholds scaled to the card). Each physical trace
         must equal its logical trace byte for byte, with no conservation
         violation, every staging and COW check bit-exact, no shortfall,
         each replica's runtime events (stage-out, restore, COW split)
         equal to its backend's counters and a valid Perfetto export; at
         least one migration and one host copy restored on another
         replica than the one that staged it out in each leg, a scale-up
         and a prefill handoff in (b), and every kernel of path A launched
         in each leg (counts zeroed before it and read after). Logs the
         per-replica counts, migrations, cold re-homes, launches, pinned
         host allocations and wall time.

Phase 6  path D, the MoE, VLM and audio families, after phase 3's model
         is freed: (a) full-width qwen3-moe-235b-a22b (d_model 4096, 64
         heads / 4 KV heads of 128, 128 experts top-8 of 1536, vocab
         151936) cut to 6 of its 94 layers, seeded weights cast to bf16
         leaf by leaf as they are drawn, serving phase 3's agent
         programs (block bytes from its own KV width) through the
         unchanged ``Engine``: the physical decision stream must equal
         the logical leg's, with pins, TTL hits, demotions, restores and
         COW splits exercised, every check bit-exact, no shortfall, every
         kernel of path A launched (counts zeroed before it and read
         after), padded prefill chunks dropping expert copies and decode
         steps dropping none; logs steps, the physical leg's wall time
         and ms a step, the dropped copies and the peak memory. (b) qwen3-moe, moonshot-v1-
         16b-a3b (its leading dense layer and two MoE layers, shared
         experts), pixtral-12b and musicgen-large at full width and cut
         depth in fp32: a 256-token prompt's prefill against prefill of
         all but 8 tokens and 8 decode steps with the cache (capacity
         where no copy drops); for the three the paged runtime serves,
         its prefill and 8 decode steps against ``Model.forward``; for
         pixtral, the ``embeds`` input against the token path (bit for
         bit). Each gap within 1e-3 of the logits' rms, argmax equal.

Phase 7  path E, the families the engine does not page, through
         ``Model.forward`` after phase 6 is freed: (a) gemma2-9b at full
         width and depth (42 local/global layers, 16 heads / 8 KV heads
         of 256, window 4096, softcaps, sandwich norms; ~9.24 B params,
         seeded, bf16), B=1, a 4600-token prompt into a 4672-position
         cache (the local layers' 4096-slot rings wrap in prefill), then
         32 greedy decode steps; (c) zamba2-2.7b (54 Mamba2 layers in 9
         groups of 6, each led by one of 2 shared attention blocks, MHA
         at D=80; ~2.45 B params, bf16), B=2, a 2000-token prompt, 32
         decode steps. Each is timed after an untimed warm-up run and
         logs prefill s and tokens/s, decode ms a step and tokens/s, flash
         launches (counts zeroed before, read after: 42 and 9 a prefill,
         asserted), weight GB and peak memory.
         (b, d) each at full width cut to 2 and 4 (gemma2: 1 and 2 pairs)
         and 6 and 12 layers (zamba2: 1 and 2 groups) in fp32: the
         prompt's prefill against prefill of all but 64 tokens and 64
         decode steps (across gemma2's ring), and the prefill through the
         flash kernel against the plain version; each gap within 1e-3 of
         the logits' rms, argmax equal.

Phase 8  path F, training and the roofline cost source, after phase 7 is
         freed: (a) full-width, full-depth qwen2-1.5b (28 layers, ~1.54 B
         params, drawn with its published initializer, N(0, 0.02))
         trained by ``Trainer`` on ``TokenStream`` batches: fp32
         masters and moments, bf16 compute, remat "full", two
         microbatches; train_4k's 4096-token rows with its global batch
         cut from 256 to 2; a warm-up step and 6 timed ones, each
         logging loss, grad norm, step ms, tokens/s and the model-FLOPs
         share 6 N tokens / (step s x the bf16 peak), then the peak
         memory and the launch counts (zeroed before: every kernel 0, the
         training forward runs the reference's plain arithmetic); every
         loss finite, the last three's mean below the first. (b) The same
         config cut to 2 layers at full width, fp32, B 1 x 128 tokens, 2
         steps on the card and on the CPU from one set of seeded params:
         losses and grad norms within 1e-4 relative; a run saved at step
         1 and resumed into a fresh trainer equals the uninterrupted
         step 2 within 1e-4. (c) ``CostModel.from_roofline`` at full
         width (the port's steps counted on the meta device) beside
         ``build_profile``, within 2x, both pricing phase 3a's measured
         prefill-only and decode-only steps; then ``Engine(cost_source=
         "roofline")`` on 12 SWE-Bench programs under the virtual clock
         must pin.

Phase 9  path G, the sharded steps, after phase 8: a one-rank NCCL
         process group (a free local port) and ``make_host_mesh()``, a
         (1, 1) ("data", "model") DeviceMesh. (a) Full-width, full-depth
         qwen2-1.5b in bf16: the sharded prefill step (B 1 x 2048, every
         weight and cache a DTensor, the flash kernel launched on each
         rank's local pieces) and 16 sharded decode steps beside the
         meshless steps on the same weights: next tokens equal and logits
         bit-equal, flash launches > 0, the wall ms a step of both legs
         (a warm-up run of each first). (b) The same config cut to 2
         layers, fp32, from its published init: step 1 of a sharded
         Trainer against a meshless one (loss and grad norm within 1e-6
         relative), then ``reshard_for_mesh(make_host_mesh())`` and 2
         more steps, each loss finite. (c) One full-width qwen3-moe layer
         (E 128, top 8) in bf16 with ``sharding_mode="ep_a2a"`` under the
         mesh's rules (NCCL's all-to-all, seen by the step counter)
         against the grouped layer on the same input; one EP shard, so
         the same plan and drops; the error and both times logged. (d)
         In subprocesses, one a cell, all started together (the fake
         process group cannot share a process with NCCL's): the dry run
         on the meta device of qwen2-1.5b x {train_4k, prefill_32k,
         decode_32k} on 16 x 16 and qwen3-moe-235b-a22b x train_4k on
         2 x 16 x 16: per-device FLOPs, bytes, collective bytes and
         argument bytes (also as a share of the card's memory), each
         finite and positive. The process group is torn down at the end.

Prints a ``{"kernels": [...]}`` line (``launches``: phases 3 and 4;
``launches_phase5``: each leg of phase 5; ``launches_phase6``: phase
6a; ``launches_phase7``: legs 7a and 7c; ``launches_phase8``: phase 8a;
``launches_phase9``: the sharded prefill and decode steps of 9a),
the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``. Any failed check raises: the script
then exits non-zero and prints no result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Datasheet peaks (NVIDIA H100/H200 data sheets; dense rates, full power
# limit): HBM bytes/s, bf16 tensor-core FLOP/s, fp32 FLOP/s, HBM bytes,
# host link (PCIe Gen5 x16) bytes/s. Matched against the nvidia-smi name,
# most specific first.
CARDS = (
    ("H100 PCIe", dict(hbm_bw=2.0e12, bf16=756e12, fp32=51e12,
                       hbm_bytes=80e9, h2d=64e9)),
    ("H100 NVL", dict(hbm_bw=3.9e12, bf16=835e12, fp32=60e12,
                      hbm_bytes=94e9, h2d=64e9)),
    ("H200", dict(hbm_bw=4.8e12, bf16=989e12, fp32=67e12,
                  hbm_bytes=141e9, h2d=64e9)),
    ("H100", dict(hbm_bw=3.35e12, bf16=989e12, fp32=67e12,
                  hbm_bytes=80e9, h2d=64e9)),
)

# Phase-2 shapes: qwen2-1.5b at full width, and the qwen2 and glm4 smoke
# models' (Dh 8 and 16, G 3 and 2, pages of 8 and 16).
FULL = dict(L=28, KV=2, G=6, Dh=128, page=16, B=8,
            lens=(4096, 0, 1, 17, 1000, 2048, 3333, 4095), stage_pages=128)
SMOKE = dict(L=2, KV=2, G=3, Dh=8, page=8, B=4, lens=(0, 5, 17, 40),
             stage_pages=5)
GLM4_SMOKE = dict(L=2, KV=2, G=2, Dh=16, page=16, B=3, lens=(7, 0, 33),
                  stage_pages=3)
# Decode attention, beside FULL: the serve path's step (B 4 x 2048 tokens,
# timed), glm4-9b's width (G 16) with rows up to 8k tokens, and one 16k-
# token row at qwen2-1.5b's width.
SERVE_DECODE = dict(FULL, B=4, lens=(2048,) * 4)
GLM4_WIDE = dict(L=2, KV=2, G=16, Dh=128, page=16, B=4,
                 lens=(8192, 5000, 257, 0), stage_pages=4)
LONG_ROW = dict(FULL, L=2, B=1, lens=(16384,), stage_pages=1)
# and the other head dims of the tensor-core kernel: stablelm-3b's (G 1,
# Dh 80), musicgen-large's (G 1, Dh 64) and a gemma2-9b-like layer's (G 2,
# Dh 256), each at its own page size
DECODE_WIDTHS = (
    GLM4_WIDE, LONG_ROW,
    dict(L=2, KV=4, G=1, Dh=80, page=32, B=3, lens=(300, 0, 77),
         stage_pages=3),
    dict(L=2, KV=4, G=1, Dh=64, page=64, B=3, lens=(1000, 64, 0),
         stage_pages=3),
    dict(L=2, KV=4, G=2, Dh=256, page=16, B=2, lens=(700, 129),
         stage_pages=2))
# split lengths (tokens) timed at FULL and SERVE_DECODE, the kernel's
# (kSplitTokens) among them
SPLIT_CHOICES = (64, 128, 256, 512)
# Page scatter past one launch's capacity (K_MAX_SCATTER = 512 pages), at
# the smoke width.
SCATTER_WIDE = dict(L=2, P=700, page=8, KV=2, Dh=8, n=600)
# Page gather past one launch's capacity (K_MAX_GATHER = 512 pages) with
# repeated ids, at the smoke width (256-byte rows, one bulk piece each);
# then rows of several 4 KB bulk pieces (10 KB: the last piece 2 KB;
# stablelm-3b's 80 KB) and rows the bulk copy cannot take (30 and 12
# bytes: the row kernel, 2- and 4-byte units).
GATHER_WIDE = dict(L=2, P=600, page=8, KV=2, Dh=8, n=700)
GATHER_ROWS = (dict(L=2, P=40, page=16, KV=4, Dh=80, n=50, dtype="bfloat16"),
               dict(L=2, P=24, page=16, KV=32, Dh=80, n=30,
                    dtype="bfloat16"),
               dict(L=2, P=50, page=3, KV=1, Dh=5, n=60, dtype="bfloat16"),
               dict(L=3, P=50, page=1, KV=1, Dh=3, n=60, dtype="float32"))
# The tier-move legs: a program of 128 pages (2048 tokens) of a 1024-page
# qwen2-1.5b pool, staged out and reloaded this many times (the first of
# each leg allocates its pinned buffers; the rest reuse the cache).
TIER_PAGES, TIER_POOL, TIER_REPS = 128, 1024, 6
MOVE_SETS = 4     # id sets and staging buffers a page-move timing rotates
# Flash attention: qwen2-1.5b's fresh prefill (timed), then D=80 with S not
# a multiple of the 64-row tile, and a gemma2-9b-like layer (16 heads of
# 256, 8 KV heads, window 4096, softcap 50) at S=8192.
FLASH_MAIN = dict(B=1, H=12, KV=2, S=2048, D=128, window=0, softcap=0.0)
FLASH_OTHER = (dict(B=2, H=8, KV=2, S=1000, D=80, window=0, softcap=0.0),
               dict(B=1, H=16, KV=8, S=8192, D=256, window=4096,
                    softcap=50.0))
FLASH_TILES = (64, 128)   # the bf16 kernel's query-tile heights
# The serving path's fresh prefill chunk (chunk_size=512 in replay_config):
# timed beside FLASH_MAIN, with both query-tile heights, to choose one.
FLASH_BUCKET = dict(B=1, H=12, KV=2, S=512, D=128, window=0, softcap=0.0)
# Phase 6a's fresh prefills at qwen3-moe's heads (64 of 128 over 4 KV
# heads, G = 16): the 512-token chunk and the smallest padded bucket.
FLASH_MOE = (dict(B=1, H=64, KV=4, S=512, D=128, window=0, softcap=0.0),
             dict(B=1, H=64, KV=4, S=16, D=128, window=0, softcap=0.0))
# Phase 7c's fresh prefill in zamba2-2.7b's shared blocks: MHA (G = 1) at
# D = 80, S not a multiple of either tile height.
FLASH_ZAMBA = dict(B=2, H=32, KV=32, S=2000, D=80, window=0, softcap=0.0)
# Phase 7a's fresh prefill in gemma2-9b's layers: 4600 tokens, not a
# multiple of either tile height; the local layers' window 4096 and the
# global layers' none, both under the attention softcap 50.
FLASH_GEMMA2 = (dict(B=1, H=16, KV=8, S=4600, D=256, window=4096,
                     softcap=50.0),
                dict(B=1, H=16, KV=8, S=4600, D=256, window=0, softcap=50.0))
# Token append past one launch's capacity (K_MAX_APPEND = 256 rows), at
# the smoke width.
APPEND_WIDE = dict(L=2, P=320, page=8, KV=2, Dh=8, B=300)
# RWKV6 scan: rwkv6-3b's prefill (timed), and the smoke model's heads
# (K = L = 16) with a carried state, decays inside the +-38 clip.
SCAN_MAIN = dict(B=1, T=2048, H=40, K=64, L=64)
SCAN_SMOKE = dict(B=2, T=256, H=4, K=16, L=16)
# and its edges: one chunk (T = L), K = 64 in 32-token chunks, a head size
# the 16-byte copies cannot take (K = 10: 4-byte copies, a ragged slice);
# batch rows checked one by one at rwkv6-3b's heads; the carry pass's
# slice widths timed at SCAN_MAIN and at phase 4's prefill (B = 2)
SCAN_EDGES = (dict(B=2, T=64, H=4, K=64, L=64),
              dict(B=2, T=256, H=4, K=64, L=32),
              dict(B=2, T=96, H=3, K=10, L=8))
SCAN_ROWS = dict(B=2, T=512, H=40, K=64, L=64)
SCAN_PREFILL = dict(SCAN_MAIN, B=2)
# Path A's kernels (the serving path) and path B's run (rwkv6-3b).
PATH_A = ("paged_decode_attention", "page_gather", "page_scatter",
          "token_append", "flash_attention")
RWKV_RUN = dict(B=2, T=2048, decode_steps=32)


def log(*args) -> None:
    print(*args, flush=True)


def card_datasheet(name: str) -> dict:
    for key, sheet in CARDS:
        if key in name:
            return sheet
    raise RuntimeError(f"no datasheet for card {name!r}")


def hardware_profile(name: str):
    """The engine's HardwareProfile for this card, from its datasheet
    (mfu / decode_eff keep the profile's defaults)."""
    from repro_torch.serving.profiler import HardwareProfile
    s = card_datasheet(name)
    return HardwareProfile(name=name, flops=s["bf16"], hbm_bw=s["hbm_bw"],
                           hbm_bytes=s["hbm_bytes"], ici_bw=450e9,
                           h2d_bw=s["h2d"])


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call, CUDA events around ``iters``
    calls after ``warmup`` untimed ones."""
    import torch
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


def graph_ms(fn, iters: int = 20, warmup: int = 3, reps: int = 5) -> float:
    """Device milliseconds per call: ``iters`` calls captured in one CUDA
    graph after ``warmup`` eager ones, ``reps`` replays timed with CUDA
    events, so no host work falls inside the timed span."""
    import torch
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
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


def bound_ms(nbytes: float, ops: float, sheet: dict, op_rate: str):
    """The least time for the work: the larger of bytes / HBM bandwidth
    and operations / the peak rate of their type. Returns (ms, bound_by)."""
    t_bytes = nbytes / sheet["hbm_bw"] * 1e3
    t_ops = ops / sheet[op_rate] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 1
def cuobjdump() -> str | None:
    """The toolkit's ``cuobjdump`` beside ``nvcc``, or None."""
    from repro_torch.kernels import _build
    cand = pathlib.Path(_build.nvcc()).with_name("cuobjdump")
    return str(cand) if cand.exists() else shutil.which("cuobjdump")


def count_sass(text: str, opcode: str = "HGMMA") -> dict[str, int]:
    """Per function of a ``cuobjdump -sass`` listing, the number of
    instructions whose opcode is ``opcode`` (any suffix, any predicate)."""
    counts: dict[str, int] = {}
    fn = None
    pattern = re.compile(r"\*/\s+(?:@!?U?P\w+\s+)?" + opcode + r"[.\s]")
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and pattern.search(line):
            counts[fn] += 1
    return counts


def check_hgmma(library: pathlib.Path) -> None:
    """The bf16 flash kernels run on the tensor cores: every
    ``flash_wgmma_kernel`` instance of the built library holds HGMMA
    instructions (checked where the toolkit has ``cuobjdump``)."""
    tool = cuobjdump()
    if tool is None:
        log("phase1 flash_attention HGMMA count: not checked (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = count_sass(sass)
    for fn, n in sorted(counts.items()):
        log(f"phase1 flash_attention {fn}: {n} HGMMA")
    wgmma = {fn: n for fn, n in counts.items() if "flash_wgmma_kernel" in fn}
    assert wgmma and all(n > 0 for n in wgmma.values()), counts


# ---------------------------------------------------------------- phase 2
def make_case(shape: dict, dtype, gen, device):
    """Pools, queries, ragged block tables (garbage in every dead slot) and
    token rows at ``shape``."""
    import numpy as np
    import torch
    L, KV, G, Dh, page, B = (shape[k] for k in ("L", "KV", "G", "Dh",
                                                 "page", "B"))
    lens = np.asarray(shape["lens"], np.int32)
    n_live = [math.ceil(n / page) for n in lens]
    n_tab = max(1, max(n_live))
    P = max(sum(n_live), shape["stage_pages"], B) + 16
    rng = np.random.default_rng(0)
    tables = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(B, n_tab),
                          dtype=np.int64).astype(np.int32)
    perm = rng.permutation(P)
    used = 0
    for b, n in enumerate(n_live):
        tables[b, :n] = perm[used:used + n]
        used += n
    pool = (L, P, page, KV, Dh)
    return dict(
        lens=lens, tables=tables, P=P,
        q=torch.randn((B, KV * G, Dh), generator=gen, device=device).to(dtype),
        k=torch.randn(pool, generator=gen, device=device).to(dtype),
        v=torch.randn(pool, generator=gen, device=device).to(dtype),
        k_tok=torch.randn((L, B, KV, Dh), generator=gen,
                          device=device).to(dtype),
        v_tok=torch.randn((L, B, KV, Dh), generator=gen,
                          device=device).to(dtype),
        stage_ids=rng.permutation(P)[:shape["stage_pages"]],
        app_pages=rng.permutation(P)[:B],
        app_offs=rng.integers(0, page, size=B))


def decode_args(case: dict) -> tuple:
    """(q, k pool, v pool, block tables, lengths) of a case on its device."""
    import torch
    dev = case["q"].device
    return (case["q"], case["k"], case["v"],
            torch.from_numpy(case["tables"]).to(dev),
            torch.from_numpy(case["lens"]).to(dev))


def check_decode(case: dict, layer: int, timed: bool, sheet: dict):
    import torch
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_kernel, paged_decode_attention_ref)
    args = decode_args(case)
    acc, m, l = paged_decode_attention_kernel(*args, layer=layer,
                                              return_residuals=True)
    out = paged_decode_attention_kernel(*args, layer=layer)
    torch.cuda.synchronize()
    acc_r, m_r, l_r = paged_decode_attention_ref(*args, layer=layer,
                                                 return_residuals=True)
    out_r = paged_decode_attention_ref(*args, layer=layer)
    # fp32 residuals from identical inputs differ only in summation order
    # over at most 16384 terms: 2e-3 covers it with a wide margin
    for got, ref in ((acc, acc_r), (m, m_r), (l, l_r)):
        torch.testing.assert_close(got, ref, atol=2e-3, rtol=2e-3)
    # the normalized output is rounded to q's dtype on both sides: one
    # bf16 ulp (2^-8 relative) apart at most
    torch.testing.assert_close(out.float(), out_r.float(), atol=1e-2,
                               rtol=1e-2)
    empty = [b for b, n in enumerate(case["lens"]) if n == 0]
    for b in empty:                 # exact empty-row contract
        assert (m[b] == -2.0e38).all() and (l[b] == 0).all() \
            and (acc[b] == 0).all(), "empty row residuals"
    check_decode_contracts(args, layer, (acc, m, l), out)
    err = max((acc - acc_r).abs().max().item(),
              (out.float() - out_r.float()).abs().max().item())
    if not timed:
        return err, None
    return err, time_decode(case, sheet)


def check_decode_contracts(args: tuple, layer: int, residuals: tuple,
                           out) -> None:
    """Bit for bit on the card: each row alone gives its row of the
    batched call; a table widened with garbage in 300 more dead slots
    changes nothing; a live id outside the pool turns its row, and only
    its row, to NaN."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention_kernel as kernel
    q, k, v, tables, lens = args
    B = q.shape[0]
    for b in range(B):
        row = kernel(q[b:b + 1], k, v, tables[b:b + 1].contiguous(),
                     lens[b:b + 1], layer=layer, return_residuals=True)
        assert all(torch.equal(r[0], full[b]) for r, full in
                   zip(row, residuals)), f"row {b} alone differs"
    garbage = np.random.default_rng(5).integers(
        -2 ** 31, 2 ** 31 - 1, size=(B, 300), dtype=np.int64)
    wide = torch.cat([tables, torch.from_numpy(garbage.astype(np.int32))
                      .to(tables.device)], 1).contiguous()
    assert all(torch.equal(a, b) for a, b in zip(
        kernel(q, k, v, wide, lens, layer=layer, return_residuals=True),
        residuals)), "a wider table changed the residuals"
    assert torch.equal(kernel(q, k, v, wide, lens, layer=layer), out), \
        "a wider table changed the output"
    lens_h = lens.cpu().tolist()
    b = int(np.argmax(lens_h))
    if lens_h[b] == 0:
        return
    page = k.shape[-3]
    bad = tables.clone()
    bad[b, (lens_h[b] - 1) // page] = k.shape[-4]      # P: outside the pool
    poisoned = kernel(q, k, v, bad, lens, layer=layer, return_residuals=True)
    others = [i for i in range(B) if i != b]
    for got, want in zip(poisoned, residuals):
        assert torch.isnan(got[b]).all(), "a bad live id did not give NaN"
        assert torch.equal(got[others], want[others]), "poison spread"
    assert torch.isnan(kernel(q, k, v, bad, lens, layer=layer)[b]).all()


def decode_bound(case: dict, sheet: dict) -> tuple[float, str]:
    """q and the live K/V rows read once, the live table slots and the
    lengths, the fp32 residuals written once; 4 * Dh flops a (query
    head, live token)."""
    B, H, Dh = case["q"].shape
    KV, page = case["k"].shape[3], case["k"].shape[2]
    live = int(case["lens"].sum())
    esz = case["q"].element_size()
    n_live = sum(math.ceil(n / page) for n in case["lens"])
    nbytes = (B * H * Dh * esz + 2 * live * KV * Dh * esz + 4 * n_live
              + 4 * B + B * H * Dh * 4 + 2 * B * H * 4)
    return bound_ms(nbytes, 4.0 * live * H * Dh, sheet, "fp32")


def time_decode(case: dict, sheet: dict) -> dict:
    """Decode attention's residual call with the layer rotating over all
    the pool's layers, so that every call finds its pages cold in the 50
    MB L2, as a decode step's layer loop does: an eager loop (``ms``) and
    the same calls replayed from a CUDA graph (``device_ms``), beside the
    plain version and the bound."""
    import itertools
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_kernel, paged_decode_attention_ref)
    args = decode_args(case)
    L = case["k"].shape[0]
    layers = itertools.cycle(range(L))

    def kern():
        return paged_decode_attention_kernel(*args, layer=next(layers),
                                             return_residuals=True)

    bms, by = decode_bound(case, sheet)
    return dict(
        ms=time_ms(kern, iters=L),
        plain_ms=time_ms(lambda: paged_decode_attention_ref(
            *args, layer=next(layers), return_residuals=True), iters=3,
            warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        device_ms=graph_ms(kern, iters=L))


def decode_split_times(case: dict) -> dict:
    """Device ms (CUDA-graph replay, layers rotating) of the kernel with
    each split length of SPLIT_CHOICES, each checked against the plain
    version first (residuals, 2e-3): how the split length was chosen."""
    import itertools
    import torch
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_kernel, paged_decode_attention_ref)
    args = decode_args(case)
    L = case["k"].shape[0]
    ref = paged_decode_attention_ref(*args, layer=0, return_residuals=True)
    out = {}
    for split in SPLIT_CHOICES:
        got = paged_decode_attention_kernel(*args, layer=0,
                                            return_residuals=True,
                                            _split_tokens=split)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, atol=2e-3, rtol=2e-3)
        layers = itertools.cycle(range(L))
        out[split] = graph_ms(lambda: paged_decode_attention_kernel(
            *args, layer=next(layers), return_residuals=True,
            _split_tokens=split), iters=L)
    return out


def check_page_copy(case: dict, timed: bool, sheet: dict) -> dict:
    """Gather, scatter, copy (gather + scatter) and append: bit-exact
    against the plain versions. Returns {kernel: (err, timing or None)}."""
    import itertools
    import numpy as np
    import torch
    from repro_torch.kernels.page_copy import (
        append_tokens_ref, copy_pages, copy_pages_ref, page_gather_kernel,
        page_gather_ref, page_scatter_kernel, page_scatter_ref,
        token_append_kernel)
    k = case["k"]
    dev = k.device
    ids = case["stage_ids"]
    res = {}

    staging = page_gather_kernel(k, ids)
    torch.cuda.synchronize()
    assert torch.equal(staging, page_gather_ref(k, ids)), "gather"
    res["page_gather"] = 0.0

    pool, pool_r = k.clone(), k.clone()
    fresh = torch.randn(staging.shape, device=dev).to(k.dtype)
    page_scatter_kernel(pool, fresh, ids)
    page_scatter_ref(pool_r, fresh, ids)
    torch.cuda.synchronize()
    assert torch.equal(pool, pool_r), "scatter"
    res["page_scatter"] = 0.0

    src, dst = ids[: len(ids) // 2], ids[len(ids) // 2:][: len(ids) // 2]
    copy_pages(pool, src, dst)
    copy_pages_ref(pool_r, src, dst)
    torch.cuda.synchronize()
    assert torch.equal(pool, pool_r), "copy"

    kp, vp = k.clone(), case["v"].clone()
    kr, vr = k.clone(), case["v"].clone()
    token_append_kernel(kp, vp, case["k_tok"], case["v_tok"],
                        case["app_pages"], case["app_offs"])
    append_tokens_ref(kr, vr, case["k_tok"], case["v_tok"],
                      case["app_pages"], case["app_offs"])
    torch.cuda.synchronize()
    assert torch.equal(kp, kr) and torch.equal(vp, vr), "append"
    res["token_append"] = 0.0
    if not timed:
        return {name: (err, None) for name, err in res.items()}

    L, P = k.shape[:2]
    row = k[0, 0].numel() * k.element_size()
    moved = len(ids) * L * row
    # every timed call takes the next of MOVE_SETS id sets and staging
    # buffers (4 x 29 MB at the phase-2 shape), so that it finds its pages
    # and its staging cold in the 50 MB L2, as a restore does
    rng = np.random.default_rng(9)
    sets = [rng.permutation(P)[:len(ids)] for _ in range(MOVE_SETS)]
    sets_dev = [torch.from_numpy(x).to(dev) for x in sets]
    stages = [staging.clone() for _ in range(MOVE_SETS)]
    turn = itertools.cycle(range(MOVE_SETS))
    out = {}
    for name, kern, plain, lib in (
            ("page_gather",
             lambda i: page_gather_kernel(k, sets[i]),
             lambda i: page_gather_ref(k, sets[i]),
             lambda i: torch.index_select(k, 1, sets_dev[i])),
            ("page_scatter",
             lambda i: page_scatter_kernel(pool, stages[i], sets[i]),
             lambda i: page_scatter_ref(pool_r, stages[i], sets[i]),
             lambda i: pool_r.index_copy_(1, sets_dev[i], stages[i]))):
        bms, by = bound_ms(2 * moved + 4 * len(ids), 0, sheet, "bf16")
        out[name] = (res[name], dict(
            ms=time_ms(lambda: kern(next(turn))),
            plain_ms=time_ms(lambda: plain(next(turn))), bound_ms=bms,
            bound_by=by, library_ms=time_ms(lambda: lib(next(turn))),
            device_ms=graph_ms(lambda: kern(next(turn))),
            library_device_ms=graph_ms(lambda: lib(next(turn)))))
    out["page_gather"][1]["device_ms_by_path"] = gather_path_times(k, sets)
    pid_dev = torch.from_numpy(case["app_pages"]).to(dev)
    off_dev = torch.from_numpy(case["app_offs"]).to(dev)

    def library_append():
        kr[:, pid_dev, off_dev] = case["k_tok"]
        vr[:, pid_dev, off_dev] = case["v_tok"]

    tok_bytes = case["k_tok"].numel() * case["k_tok"].element_size()
    bms, by = bound_ms(4 * tok_bytes + 8 * len(case["app_pages"]), 0, sheet,
                       "bf16")
    out["token_append"] = (res["token_append"], dict(
        ms=time_ms(lambda: token_append_kernel(
            kp, vp, case["k_tok"], case["v_tok"], case["app_pages"],
            case["app_offs"])),
        plain_ms=time_ms(lambda: append_tokens_ref(
            kr, vr, case["k_tok"], case["v_tok"], case["app_pages"],
            case["app_offs"])),
        bound_ms=bms, bound_by=by, library_ms=time_ms(library_append),
        device_ms=graph_ms(lambda: token_append_kernel(
            kp, vp, case["k_tok"], case["v_tok"], case["app_pages"],
            case["app_offs"])),
        library_device_ms=graph_ms(library_append)))
    return out


def gather_path_times(k, sets) -> dict:
    """Device ms (``torch.profiler``, the wrapper rotating over the id
    sets) of the gather's two device paths at the phase-2 shape, each
    bit-exact against the plain version first: the bulk copies (the
    default build), the row kernel taking every row (an edited copy of
    the source, ``launch/gather_probes.py``), the bulk copies again. The
    default is bound again afterwards."""
    from repro_torch.launch import gather_probes
    rows = gather_probes.build_probes(["rows"])["rows"]
    out = {}
    try:
        for name, bind in (("bulk", gather_probes.bind_default),
                           ("rows", lambda: gather_probes.bind(rows)),
                           ("bulk_again", gather_probes.bind_default)):
            bind()
            out[name] = gather_probes.gather_ms(k, sets)
    finally:
        gather_probes.bind_default()
    return out


def check_scatter_wide(gen) -> float:
    """Page scatter of SCATTER_WIDE's 600 pages, past one launch's
    capacity: one launch per K_MAX_SCATTER pages, bit-exact against the
    plain version; out-of-range or repeated ids raise before any launch.
    Returns the max abs error (0)."""
    import numpy as np
    import torch
    from repro_torch.kernels.page_copy import page_scatter_ref
    from repro_torch.kernels.page_copy.kernel import (K_MAX_SCATTER,
                                                      page_scatter_kernel)
    L, P, page, KV, Dh, n = (SCATTER_WIDE[x] for x in
                             ("L", "P", "page", "KV", "Dh", "n"))
    pool = torch.randn((L, P, page, KV, Dh), generator=gen,
                       device="cuda").to(torch.bfloat16)
    staging = torch.randn((L, n, page, KV, Dh), generator=gen,
                          device="cuda").to(torch.bfloat16)
    ids = np.random.default_rng(4).permutation(P)[:n]
    ref = pool.clone()
    before = page_scatter_kernel.launches
    page_scatter_kernel(pool, staging, ids)
    assert page_scatter_kernel.launches - before == math.ceil(
        n / K_MAX_SCATTER)
    page_scatter_ref(ref, staging, ids)
    torch.cuda.synchronize()
    assert torch.equal(pool, ref), "scatter past one launch"
    before = page_scatter_kernel.launches
    for what, bad in (("repeated id", np.concatenate([ids[:-1], ids[:1]])),
                      ("id out of range", np.where(ids == ids[7], P, ids))):
        expect_value_error(lambda: page_scatter_kernel(pool, staging, bad),
                           what)
    assert page_scatter_kernel.launches == before
    return 0.0


def check_gather_wide(gen) -> float:
    """Page gather of GATHER_WIDE's 700 pages with repeated ids, past one
    launch's capacity: one launch per K_MAX_GATHER pages, bit-exact
    against the plain version; the same at GATHER_ROWS (rows of several
    bulk pieces, rows for the row kernel) and from a pool whose address
    is off 16 bytes; an id out of range raises before any launch.
    Returns the max abs error (0)."""
    import numpy as np
    import torch
    from repro_torch.kernels.page_copy import page_gather_ref
    from repro_torch.kernels.page_copy.kernel import (K_MAX_GATHER,
                                                      page_gather_kernel)
    rng = np.random.default_rng(6)

    def pool_of(shape, dtype=torch.bfloat16):
        dims = tuple(shape[x] for x in ("L", "P", "page", "KV", "Dh"))
        return torch.randn(dims, generator=gen, device="cuda").to(dtype)

    P, n = GATHER_WIDE["P"], GATHER_WIDE["n"]
    pool = pool_of(GATHER_WIDE)
    ids = rng.permutation(np.concatenate([np.arange(P),
                                          rng.integers(0, P, n - P)]))
    assert len(set(ids.tolist())) < n
    before = page_gather_kernel.launches
    got = page_gather_kernel(pool, ids)
    assert page_gather_kernel.launches - before == math.ceil(
        n / K_MAX_GATHER)
    torch.cuda.synchronize()
    assert torch.equal(got, page_gather_ref(pool, ids)), \
        "gather past one launch"
    for shape in GATHER_ROWS:
        other = pool_of(shape, getattr(torch, shape["dtype"]))
        sel = rng.integers(0, shape["P"], shape["n"])
        got = page_gather_kernel(other, sel)
        torch.cuda.synchronize()
        assert torch.equal(got, page_gather_ref(other, sel)), shape
    flat = torch.zeros(pool.numel() + 1, dtype=pool.dtype, device="cuda")
    shifted = flat[1:].view(pool.shape)
    shifted.copy_(pool)
    got = page_gather_kernel(shifted, ids[:40])
    torch.cuda.synchronize()
    assert torch.equal(got, page_gather_ref(pool, ids[:40])), "misaligned"
    before = page_gather_kernel.launches
    for bad in (np.where(ids == ids[7], P, ids), np.append(ids[:5], -1)):
        expect_value_error(lambda: page_gather_kernel(pool, bad),
                           "id out of range")
    assert page_gather_kernel.launches == before
    return 0.0


def tier_move_legs(hw) -> dict:
    """The tier-move legs at qwen2-1.5b width: a program of TIER_PAGES
    scattered pages in a TIER_POOL-page runtime, both pools. Stage-out:
    ``PagedKVRuntime.stage_out`` (two gathers) then
    ``TorchModelBackend._to_host`` of each pool (a blocking copy into
    fresh pinned memory); reload: ``PagedKVRuntime.restore`` (the H2D copy
    and two scatters), bit-exact. Each leg TIER_REPS times on the host
    clock (the first allocates its pinned buffers); the gather, scatter
    and host-link shares each timed apart with CUDA events. GB/s: the
    bytes of both staging buffers over the time."""
    import random
    import statistics
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.page_copy import scatter_pages
    from repro_torch.serving.backend import TorchModelBackend
    from repro_torch.serving.paged_runtime import PagedKVRuntime
    cfg = get_config("qwen2-1.5b")
    rt = PagedKVRuntime(cfg, n_pages=TIER_POOL, page_size=16, device="cuda")
    random.Random(0).shuffle(rt.free)    # the program's pages scattered
    gen = torch.Generator(device="cuda").manual_seed(8)
    k0, v0 = (torch.randn((cfg.num_layers, TIER_PAGES)
                          + tuple(rt.k_pages.shape[2:]), generator=gen,
                          device="cuda").to(rt.k_pages.dtype)
              for _ in range(2))
    rt.restore("p", k0, v0, TIER_PAGES * 16)
    nbytes = 2 * k0.numel() * k0.element_size()

    def events_ms(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    out_ms, in_ms = [], []
    for _ in range(TIER_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k, v, n = rt.stage_out("p")
        hk, hv = TorchModelBackend._to_host(k), TorchModelBackend._to_host(v)
        out_ms.append((time.perf_counter() - t0) * 1e3)
        rt.evict("p", force=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = rt.restore("p", hk, hv, n)
        torch.cuda.synchronize()
        in_ms.append((time.perf_counter() - t0) * 1e3)
        back_k, back_v, _ = rt.stage_out("p")
        assert torch.equal(back_k, k0) and torch.equal(back_v, v0), \
            "tier move not bit-exact"
    gather = events_ms(lambda: rt.stage_out("p"))
    pinned = [torch.empty(k0.shape, dtype=k0.dtype, pin_memory=True)
              for _ in range(2)]
    d2h = events_ms(lambda: [h.copy_(d, non_blocking=True)
                             for h, d in zip(pinned, (k0, v0))])
    h2d = events_ms(lambda: [h.to("cuda", non_blocking=True)
                             for h in pinned])
    dev = [k0.clone(), v0.clone()]
    scatter = events_ms(lambda: [scatter_pages(pool, d, ids) for pool, d in
                                 zip((rt.k_pages, rt.v_pages), dev)])

    def leg(times, part_name, part_ms, link_ms):
        warm = statistics.median(times[1:])
        return {"ms": warm, "first_ms": times[0], "all_ms": times,
                f"{part_name}_ms": part_ms,
                f"{part_name}_share": part_ms / warm,
                "link_ms": link_ms,
                "link_GBps": nbytes / link_ms / 1e6,
                "leg_GBps": nbytes / warm / 1e6,
                "link_vs_h2d_bw": nbytes / link_ms * 1e3 / hw.h2d_bw}

    return {"bytes": nbytes, "h2d_bw_GBps": hw.h2d_bw / 1e9,
            "stage_out": leg(out_ms, "gather", gather, d2h),
            "reload": leg(in_ms, "scatter", scatter, h2d)}


def flash_work(shape: dict, esz: int) -> tuple[int, float]:
    """(bytes, flops) causal flash attention must move and do: q, k, v
    read once and o written once; 4 * D flops (q.k and p.v) per live
    (query, key) pair, query i seeing min(i + 1, window) keys."""
    B, H, KV, S, D = (shape[k] for k in ("B", "H", "KV", "S", "D"))
    nbytes = (2 * B * H * S * D + 2 * B * KV * S * D) * esz
    W = shape.get("window") or S
    n = min(S, W)
    pairs = n * (n + 1) // 2 + (S - n) * W
    return nbytes, 4.0 * D * pairs * B * H


def scan_work(shape: dict) -> tuple[int, float]:
    """(bytes, flops) of the chunked WKV scan: r, k, v, log-decay read and
    o written once, u and the states in and out, all fp32; per chunk the
    strictly-lower intra-chunk scores and their product with v (L(L-1)/2 x
    K multiply-adds each), the state readout and the state update (L x K x
    K each)."""
    B, T, H, K, L = (shape[x] for x in ("B", "T", "H", "K", "L"))
    nbytes = 4 * (5 * B * T * H * K + 2 * B * H * K * K + H * K)
    per_chunk = 2 * (L * (L - 1) // 2) * K + 2 * L * K * K
    return nbytes, 2.0 * B * H * (T // L) * per_chunk


def flash_case(shape: dict, dtype, gen):
    import torch
    B, H, KV, S, D = (shape[k] for k in ("B", "H", "KV", "S", "D"))
    return [torch.randn(dims, generator=gen, device="cuda").to(dtype)
            for dims in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))]


def check_flash(shape: dict, dtype, gen, timed: bool, sheet: dict):
    """Flash attention against its plain version; in bf16 with each
    query-tile height. Tolerances: fp32 outputs 1e-3 (both are fp32
    softmaxes over the same scores, summed in other orders over up to 8192
    keys: n * 2^-24 * max|v| ~ 2e-3 at worst, ~1e-6 typical); bf16
    outputs 1e-2, one bf16 rounding of the output apart plus the kernel's
    rounding of P to bf16 before P.V (bounded on the CPU by
    tests/test_torch_flash_attention.py). Timed like every kernel, an
    eager loop (``ms``, SDPA's ``library_ms``), and also by CUDA-graph
    replay (``device_ms``, ``library_device_ms``: device time alone)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_kernel,
                                                     flash_attention_ref)
    q, k, v = flash_case(shape, dtype, gen)
    opts = dict(window=shape["window"], softcap=shape["softcap"])
    out = flash_attention_kernel(q, k, v, **opts)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v, **opts)
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    err = (out.float() - ref.float()).abs().max().item()
    if dtype == torch.bfloat16:
        for q_tile in FLASH_TILES:
            tiled = flash_attention_kernel(q, k, v, _q_tile=q_tile, **opts)
            torch.cuda.synchronize()
            torch.testing.assert_close(tiled.float(), ref.float(), atol=tol,
                                       rtol=tol)
            err = max(err, (tiled.float() - ref.float()).abs().max().item())
    del ref
    # the model's layout: (B, S, H, D) memory read through strides
    qm, km, vm = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    strided = flash_attention_kernel(qm, km, vm, **opts)
    torch.cuda.synchronize()
    assert torch.equal(strided, out), "strided flash attention differs"
    assert strided.transpose(1, 2).is_contiguous()
    if not timed:
        return err, None
    bms, by = bound_ms(*flash_work(shape, q.element_size()), sheet, "bf16")

    def kern():
        return flash_attention_kernel(q, k, v, **opts)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)

    rec = dict(
        ms=time_ms(kern),
        plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, **opts),
                         iters=5, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=time_ms(sdpa),
        device_ms=graph_ms(kern), library_device_ms=graph_ms(sdpa))
    return err, rec


def flash_tile_times(gen, sheet: dict) -> dict:
    """Device ms (CUDA-graph replay) of the bf16 kernel with each
    query-tile height, and with the wrapper's own pick, at qwen2-1.5b's
    2048-token prefill, at the serving path's 512-token chunk and at the
    gemma2-like layer, SDPA beside each (at the gemma2-like layer SDPA is
    plain causal, no window or softcap: it visits more keys than the
    kernel). Also the eager, host-inclusive time of a call of each.
    Logged."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    from repro_torch.kernels.flash_attention.kernel import plan_bf16
    out = {}
    for label, shape in (("S2048", FLASH_MAIN), ("S512", FLASH_BUCKET),
                         ("gemma2_like", FLASH_OTHER[1])):
        q, k, v = flash_case(shape, torch.bfloat16, gen)
        opts = dict(window=shape["window"], softcap=shape["softcap"])
        row = {}
        for q_tile in FLASH_TILES:
            row[f"q_tile_{q_tile}_ms"] = graph_ms(
                lambda: flash_attention_kernel(q, k, v, _q_tile=q_tile,
                                               **opts))
        row["picked_q_tile"] = plan_bf16(
            *(shape[x] for x in ("B", "H", "S", "D")),
            num_sms=torch.cuda.get_device_properties(0)
            .multi_processor_count).q_tile
        row["eager_ms"] = time_ms(
            lambda: flash_attention_kernel(q, k, v, **opts))
        row["sdpa_ms"] = graph_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
        row["sdpa_eager_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True))
        row["bound_ms"] = bound_ms(*flash_work(shape, 2), sheet, "bf16")[0]
        out[label] = row
        del q, k, v
    return out


def expect_value_error(fn, what: str) -> None:
    try:
        fn()
    except ValueError:
        return
    raise AssertionError(f"{what}: no ValueError")


def check_flash_refusals(gen) -> None:
    """bf16 inputs TMA cannot take raise ValueError before any launch: a
    position stride that is not a whole number of 16 bytes, a base
    address off 16 bytes, a head dim not a multiple of 8."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention_kernel
    q, k, v = flash_case(dict(B=1, H=4, KV=2, S=128, D=128),
                         torch.bfloat16, gen)
    padded = torch.zeros((1, 4, 128, 129), dtype=torch.bfloat16,
                         device="cuda")[..., :128]
    padded.copy_(q)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    before = flash_attention_kernel.launches
    for what, args in (("misaligned stride", (padded, k, v)),
                       ("misaligned address", (shifted, k, v)),
                       ("head dim 100", tuple(x[..., :100].contiguous()
                                              for x in (q, k, v)))):
        expect_value_error(lambda: flash_attention_kernel(*args), what)
    assert flash_attention_kernel.launches == before


def check_append_wide(gen) -> float:
    """Token append of APPEND_WIDE's 300 rows, past one launch's capacity:
    one launch per K_MAX_APPEND rows, bit-exact against the plain
    version; out-of-range or repeated ids raise before any launch.
    Returns the max abs error (0)."""
    import numpy as np
    import torch
    from repro_torch.kernels.page_copy import append_tokens_ref
    from repro_torch.kernels.page_copy.kernel import (K_MAX_APPEND,
                                                      token_append_kernel)
    L, P, page, KV, Dh, B = (APPEND_WIDE[x] for x in
                             ("L", "P", "page", "KV", "Dh", "B"))
    pools = [torch.randn((L, P, page, KV, Dh), generator=gen,
                         device="cuda").to(torch.bfloat16) for _ in range(2)]
    toks = [torch.randn((L, B, KV, Dh), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2)]
    rng = np.random.default_rng(3)
    ids, offs = rng.permutation(P)[:B], rng.integers(0, page, size=B)
    refs = [x.clone() for x in pools]
    before = token_append_kernel.launches
    token_append_kernel(*pools, *toks, ids, offs)
    assert token_append_kernel.launches - before == math.ceil(
        B / K_MAX_APPEND)
    append_tokens_ref(*refs, *toks, ids, offs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(pools, refs)), "append"
    before = token_append_kernel.launches
    for what, bad in (("repeated id", np.concatenate([ids[:-1], ids[:1]])),
                      ("id out of range", np.where(ids == ids[5], P,
                                                   ids))):
        expect_value_error(lambda: token_append_kernel(
            *pools, *toks, bad, offs), what)
    assert token_append_kernel.launches == before
    return 0.0


def scan_case(shape: dict, gen, spread: float, shift: float):
    """r, k, v, log-decay (B, T, H, K), u (H, K), init state (B, H, K, K);
    logw = -exp(spread * N(0, 1) - shift)."""
    import torch
    B, T, H, K = (shape[k] for k in ("B", "T", "H", "K"))
    n = lambda *d: torch.randn(d, generator=gen, device="cuda")  # noqa
    return (n(B, T, H, K) * 0.5, n(B, T, H, K) * 0.5, n(B, T, H, K) * 0.5,
            -torch.exp(spread * n(B, T, H, K) - shift), n(H, K) * 0.3,
            n(B, H, K, K) * 0.1)


def check_scan(shape: dict, gen, timed: bool, sheet: dict):
    """The WKV-scan kernel against its chunked plain version (same math,
    same clip), fp32, 1e-4: the bound of the JAX package's own scan tests.
    At the smoke shape the decays stay inside the clip, so the sequential
    recurrence must agree too (1e-4), and two calls with the state carried
    must equal one call (1e-4)."""
    import torch
    from repro_torch.kernels.rwkv6_scan import (rwkv6_chunked_ref,
                                                rwkv6_scan_kernel,
                                                rwkv6_scan_ref)
    L = shape["L"]
    # timed: rwkv6-3b's decay at init, per-token log-decay near -1 (chunk
    # totals near -64, inside the clip); smoke: the JAX tests' range
    r, k, v, lw, u, s0 = scan_case(shape, gen, *((0.1, 0.0) if timed
                                                 else (1.0, 2.0)))
    o, st = rwkv6_scan_kernel(r, k, v, lw, u, s0, chunk=L)
    torch.cuda.synchronize()
    o_r, st_r = rwkv6_chunked_ref(r, k, v, lw, u, s0, chunk=L)
    for got, want in ((o, o_r), (st, st_r)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    err = max((o - o_r).abs().max().item(), (st - st_r).abs().max().item())
    if not timed:
        o_s, st_s = rwkv6_scan_ref(r, k, v, torch.exp(lw), u, s0)
        torch.testing.assert_close(o, o_s, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(st, st_s, atol=1e-4, rtol=1e-4)
        half = shape["T"] // 2
        o1, st1 = rwkv6_scan_kernel(r[:, :half].contiguous(),
                                    k[:, :half].contiguous(),
                                    v[:, :half].contiguous(),
                                    lw[:, :half].contiguous(), u, s0, chunk=L)
        o2, st2 = rwkv6_scan_kernel(r[:, half:].contiguous(),
                                    k[:, half:].contiguous(),
                                    v[:, half:].contiguous(),
                                    lw[:, half:].contiguous(), u, st1,
                                    chunk=L)
        torch.testing.assert_close(torch.cat([o1, o2], 1), o, atol=1e-4,
                                   rtol=1e-4)
        torch.testing.assert_close(st2, st, atol=1e-4, rtol=1e-4)
        return err, None
    bms, by = bound_ms(*scan_work(shape), sheet, "fp32")
    rec = dict(
        ms=time_ms(lambda: rwkv6_scan_kernel(r, k, v, lw, u, s0, chunk=L)),
        plain_ms=time_ms(lambda: rwkv6_chunked_ref(r, k, v, lw, u, s0,
                                                   chunk=L)),
        bound_ms=bms, bound_by=by, library_ms=None,
        device_ms=graph_ms(lambda: rwkv6_scan_kernel(r, k, v, lw, u, s0,
                                                     chunk=L)))
    return err, rec


def check_scan_edges(gen) -> float:
    """The scan at SCAN_EDGES with and without an initial state (1e-4
    against the chunked plain version), and a batch row of a B = 2 call
    against a B = 1 call on that row, bit for bit: every sum of the
    kernel stays inside one (row, head). Returns the largest error."""
    import torch
    from repro_torch.kernels.rwkv6_scan import (rwkv6_chunked_ref,
                                                rwkv6_scan_kernel)
    err = 0.0
    for shape in SCAN_EDGES:
        r, k, v, lw, u, s0 = scan_case(shape, gen, 1.0, 2.0)
        for init in (s0, None):
            got = rwkv6_scan_kernel(r, k, v, lw, u, init, chunk=shape["L"])
            torch.cuda.synchronize()
            want = rwkv6_chunked_ref(r, k, v, lw, u, init, chunk=shape["L"])
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
                err = max(err, (g - w).abs().max().item())
    r, k, v, lw, u, s0 = scan_case(SCAN_ROWS, gen, 0.1, 0.0)
    both = rwkv6_scan_kernel(r, k, v, lw, u, s0, chunk=SCAN_ROWS["L"])
    for b in range(SCAN_ROWS["B"]):
        one = rwkv6_scan_kernel(*(x[b:b + 1].contiguous()
                                  for x in (r, k, v, lw)), u,
                                s0[b:b + 1].contiguous(),
                                chunk=SCAN_ROWS["L"])
        torch.cuda.synchronize()
        for g, w in zip(one, both):
            assert torch.equal(g[0], w[b]), f"scan row {b} depends on B"
    return err


def scan_slice_times(gen) -> dict:
    """Device ms (CUDA-graph replay) of the scan at each carry-pass slice
    width, at SCAN_MAIN and SCAN_PREFILL, the timed decays."""
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_kernel
    from repro_torch.kernels.rwkv6_scan.kernel import SLICES
    out = {}
    for name, shape in (("B1", SCAN_MAIN), ("B2", SCAN_PREFILL)):
        r, k, v, lw, u, s0 = scan_case(shape, gen, 0.1, 0.0)
        out[name] = {vs: graph_ms(lambda vs=vs: rwkv6_scan_kernel(
            r, k, v, lw, u, s0, chunk=shape["L"], _slice=vs))
            for vs in SLICES}
    return out


def phase2(sheet: dict, hw) -> dict:
    """Returns {kernel name: record} at the main paths' shapes."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = {}
    full = make_case(FULL, torch.bfloat16, gen, "cuda")
    err, rec = check_decode(full, layer=FULL["L"] - 1, timed=True,
                            sheet=sheet)
    records["paged_decode_attention"] = dict(max_abs_err=err, **rec)
    log(f"phase2 paged_decode_attention device ms by split length "
        f"(tokens; CUDA-graph replay, layers rotating) at the phase-2 "
        f"shape: {json.dumps(decode_split_times(full))}")
    for name, (err, rec) in check_page_copy(full, True, sheet).items():
        records[name] = dict(max_abs_err=err, **rec)
    del full
    serve = make_case(SERVE_DECODE, torch.bfloat16, gen, "cuda")
    err, rec = check_decode(serve, layer=0, timed=True, sheet=sheet)
    log(f"phase2 paged_decode_attention at the serve step (B 4 x 2048 "
        f"tokens): {json.dumps(dict(max_abs_err=err, **rec))}; device ms "
        f"by split length: {json.dumps(decode_split_times(serve))}")
    del serve
    for shape in DECODE_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            case = make_case(shape, dtype, gen, "cuda")
            err, _ = check_decode(case, layer=1, timed=False, sheet=sheet)
            log(f"phase2 paged_decode_attention {dtype} G={shape['G']} "
                f"Dh={shape['Dh']} page={shape['page']} lens "
                f"{shape['lens']}: max_abs_err {err:.3g}")
            records["paged_decode_attention"]["max_abs_err"] = max(
                records["paged_decode_attention"]["max_abs_err"], err)
            del case
    for shape in (SMOKE, GLM4_SMOKE):
        for dtype in (torch.bfloat16, torch.float32):
            smoke = make_case(shape, dtype, gen, "cuda")
            err, _ = check_decode(smoke, layer=1, timed=False, sheet=sheet)
            records["paged_decode_attention"]["max_abs_err"] = max(
                records["paged_decode_attention"]["max_abs_err"], err)
            check_page_copy(smoke, False, sheet)
    log("phase2 paged_decode_attention: batched = one-row and padding-"
        "invariant bitwise, empty rows exact, a bad live id gives NaN, at "
        "every shape")

    records["token_append"]["max_abs_err"] = max(
        records["token_append"]["max_abs_err"], check_append_wide(gen))
    log(f"phase2 token_append: {APPEND_WIDE['B']} rows in "
        f"{math.ceil(APPEND_WIDE['B'] / 256)} launches bit-exact, bad ids "
        f"refused")
    records["page_scatter"]["max_abs_err"] = max(
        records["page_scatter"]["max_abs_err"], check_scatter_wide(gen))
    log(f"phase2 page_scatter: {SCATTER_WIDE['n']} pages in "
        f"{math.ceil(SCATTER_WIDE['n'] / 512)} launches bit-exact, bad ids "
        f"refused")
    records["page_gather"]["max_abs_err"] = max(
        records["page_gather"]["max_abs_err"], check_gather_wide(gen))
    log(f"phase2 page_gather: {GATHER_WIDE['n']} pages with repeated ids in "
        f"{math.ceil(GATHER_WIDE['n'] / 512)} launches bit-exact; rows of "
        f"10 and 80 KB (several bulk pieces), of 30 and 12 bytes and from a "
        f"pool off 16 bytes (the row kernel) bit-exact; bad ids refused")
    log(f"phase2 page_gather device ms by path at the phase-2 shape "
        f"(torch.profiler, the wrapper over 4 id sets): "
        f"{json.dumps(records['page_gather'].pop('device_ms_by_path'))}")
    log(f"phase2 tier-move legs, qwen2-1.5b width, {TIER_PAGES} pages x 28 "
        f"layers, both pools: {json.dumps(tier_move_legs(hw))}")

    err, rec = check_flash(FLASH_MAIN, torch.bfloat16, gen, True, sheet)
    records["flash_attention"] = dict(max_abs_err=err, **rec)
    check_flash_refusals(gen)
    log("phase2 flash_attention: misaligned stride, misaligned address and "
        "head dim 100 refused in bf16")
    for shape in FLASH_OTHER + FLASH_MOE + (FLASH_ZAMBA,) + FLASH_GEMMA2:
        for dtype in (torch.bfloat16, torch.float32):
            err, _ = check_flash(shape, dtype, gen, False, sheet)
            log(f"phase2 flash_attention {shape} {dtype}: max_abs_err "
                f"{err:.3g}")
            records["flash_attention"]["max_abs_err"] = max(
                records["flash_attention"]["max_abs_err"], err)
            torch.cuda.empty_cache()
    log(f"phase2 flash_attention device ms by query tile (CUDA-graph "
        f"replay): {json.dumps(flash_tile_times(gen, sheet))}")
    err, rec = check_scan(SCAN_MAIN, gen, True, sheet)
    records["rwkv6_scan"] = dict(max_abs_err=err, **rec)
    err, _ = check_scan(SCAN_SMOKE, gen, False, sheet)
    records["rwkv6_scan"]["max_abs_err"] = max(
        records["rwkv6_scan"]["max_abs_err"], err, check_scan_edges(gen))
    log(f"phase2 rwkv6_scan: T = L, K 64 with L 32 and K 10 with L 8, each "
        f"with and without an initial state, within 1e-4; a B = 2 call's "
        f"rows equal B = 1 calls bitwise")
    log(f"phase2 rwkv6_scan device ms by carry slice width (state columns "
        f"a block; CUDA-graph replay) at B 1 and B 2, T 2048, H 40, K = L = "
        f"64: {json.dumps(scan_slice_times(gen))}")
    check_bound_shares(records)
    for name, rec in records.items():
        log(f"phase2 {name}: kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}), library "
            f"{'n/a' if rec['library_ms'] is None else '%.4f ms' % rec['library_ms']}"
            f", max_abs_err {rec['max_abs_err']:.3g}"
            + f"; device (CUDA-graph replay) kernel {rec['device_ms']:.4f} ms"
            + (f", library {rec['library_device_ms']:.4f} ms"
               if "library_device_ms" in rec else ""))
    return records


def check_bound_shares(records: dict) -> None:
    """No kernel beats the least time the card could take: a bound share
    over 100% means a wrong bound or a timing that misses work."""
    for name, rec in records.items():
        for key in ("ms", "device_ms"):
            assert rec["bound_ms"] <= rec[key], \
                f"{name}: {key} {rec[key]} below its bound {rec['bound_ms']}"


# ---------------------------------------------------------------- phase 3
def agent_spec(name: str):
    """Agent turns of up to ~2k tokens of context with tool pauses on the
    scale of a step on the card: short local tools (milliseconds: ls /
    cat) and slow ones (seconds: pytest)."""
    from repro_torch.sim.workload import WorkloadSpec
    return WorkloadSpec(
        name=name, mean_turns=2.6, std_turns=0.5,
        tool_mean_s=0.5, tool_std_s=1.0, tokens_mean=1500, tokens_std=300,
        output_frac=0.02, max_context=2048,
        tools=(("ls", 0.35, 0.002, 0.3), ("cat", 0.3, 0.004, 0.3),
               ("pytest", 0.35, 2.0, 0.3)),
        min_turn_tokens=64, min_output_tokens=6, min_new_tokens=32)


def agent_programs(seed: int = 0):
    """Eight agent programs of 2-3 turns with contexts up to ~2.2k
    tokens, a fleet-wide shared preamble, and a twin pair whose second
    member adopts the first one's prompt pages mid-page (the COW split).
    Tool pauses are short local tools (milliseconds: ls / cat) and slow
    ones (seconds: pytest), on the millisecond scale of a step on the
    card, so that TTL pins are both kept and left to expire."""
    from repro_torch.core.types import Program, Turn
    from repro_torch.sim.workload import generate_programs
    spec = agent_spec("chip-smoke")
    # a burst (8 sessions within ~40 ms): returning turns queue behind
    # the others' prefills, which is when the TTL solver pins
    progs = generate_programs(spec, n=6, rate_jps=200.0, seed=seed,
                              share_ratio=0.25, prefix_groups=1)
    tmpl = "chip-smoke/twin"
    for j, t0 in ((0, 0.0), (1, 0.03)):
        progs.append(Program(
            program_id=f"chip-smoke-twin{j}", arrival_time=t0,
            turns=[Turn(new_tokens=512, output_tokens=6, tool="ls",
                        tool_duration=0.002,
                        output_text="```bash\nls twin\n```"),
                   Turn(new_tokens=96, output_tokens=6, tool=None,
                        tool_duration=0.0, output_text="Final answer.")],
            shared_prefix_tokens=512, shared_prefix_id=tmpl))
    return progs


def replay_config(cfg=None):
    """Engine and tier sizing of the serve phase: the replay harness's
    ReplayConfig scaled to 2k contexts on the card. A KV pool of 512
    blocks (8k tokens) for 8 programs of ~2k, at most 4 running, a DRAM
    tier that takes every demotion, tier links at PCIe Gen5 and NVMe
    rates (in blocks of ``cfg``, qwen2-1.5b's by default), and TTLs
    capped at 0.5 s with a 2 ms cold-start unit, the scale of a step on
    the card."""
    from repro_torch.configs import get_config
    from repro_torch.core.ttl import TTLConfig
    from repro_torch.sim.replay import ReplayConfig
    cfg = cfg if cfg is not None else get_config("qwen2-1.5b")

    @dataclasses.dataclass
    class ServeConfig(ReplayConfig):
        exp_unit_mean: float = 0.002

        def engine_config(self, block_bytes):
            return dataclasses.replace(
                super().engine_config(block_bytes),
                ttl=TTLConfig(cold_start_k=4, max_ttl=self.max_ttl,
                              exp_unit_mean=self.exp_unit_mean))

    block = 16 * cfg.kv_bytes_per_token()     # bytes of one 16-token block
    return ServeConfig(arch=cfg.name, chunk_size=512, max_batch=4,
                       total_blocks=512, dram_blocks=2048, ssd_blocks=256,
                       h2d_bw_blocks=64e9 / block, ssd_bw_blocks=3e9 / block,
                       max_ttl=0.5, max_len=4096)


def serve_differential(cfg, hw, model, device):
    """Phase 3a: logical leg vs physical leg on the analytic clock.
    Returns the physical leg's engine, its decision steps and its wall
    seconds (the physical leg alone, ending in a device sync)."""
    from repro_torch.sim import replay
    rc = replay_config(cfg)
    progs = agent_programs()
    log_l, _ = replay.run_engine(progs, rc, physical=False, cfg=cfg, hw=hw)
    t0 = time.perf_counter()
    log_p, eng = replay.run_engine(progs, rc, device=device, cfg=cfg, hw=hw,
                                   model=model)
    synchronize(device)
    wall = time.perf_counter() - t0
    div = replay._first_divergence(log_l, log_p)
    assert div is None, f"decision streams diverge: {div}"
    return eng, len(log_p), wall


def serve_measured(cfg, hw, model, device):
    """Phase 3b: the same programs on the measured clock."""
    from repro_torch.serving.backend import TorchModelBackend
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.profiler import CostModel, build_profile
    from repro_torch.serving.router import Router
    from repro_torch.sim.runner import Simulator
    rc = replay_config(cfg)
    prof = build_profile(cfg, 1)
    cost = CostModel(prof, hw)
    ecfg = rc.engine_config(rc.block_size * prof.kv_bytes_per_token)
    backend = TorchModelBackend(cfg, model=model, max_len=rc.max_len,
                                page_size=rc.block_size, device=device)
    backend.verify_staging = True
    backend.runtime.verify_copies = True
    eng = Engine(cfg, ecfg, hw, backend=backend, cost=cost)
    progs = agent_programs()
    router = Router([eng])
    router.register_programs(progs)
    sim = Simulator([eng], router, max_seconds=rc.max_seconds)
    sim.add_programs(progs)
    summary = sim.run()
    return eng, summary, len(progs)


def calibration(shadow, hw) -> dict:
    """``mfu`` and ``decode_eff`` fitted to a shadow-clocked leg's step
    samples (``ShadowClockBackend.calibrate``), with the step-time gap
    before and after and the residuals: summarized by step kind (prefill
    only, decode only, both), the largest five listed."""
    from repro_torch.serving.profiler import calibration_report
    fit = shadow.calibrate()
    assert 0 < fit.mfu < math.inf and 0 < fit.decode_eff < math.inf, fit
    report = calibration_report(shadow.samples, shadow.cost.prof, hw, fit)
    residuals = report.pop("residuals")
    kinds = {}
    for r in residuals:
        kind = ("prefill" if not r["decode_batch"] else "decode"
                if not r["prefill_tokens"] else "mixed")
        kinds.setdefault(kind, []).append(r["residual_s"])
    report["residual_s_by_kind"] = {
        kind: {"steps": len(v), "median": sorted(v)[len(v) // 2],
               "min": min(v), "max": max(v)} for kind, v in kinds.items()}
    report["largest_residuals"] = sorted(
        residuals, key=lambda r: -abs(r["residual_s"]))[:5]
    return report


def mechanism_stats(eng) -> dict:
    b = eng.backend.inner if hasattr(eng.backend, "inner") else eng.backend
    st = eng.scheduler.stats
    return dict(pins=st.pins, ttl_hits=st.ttl_hits,
                ttl_expiries=st.ttl_expiries, demotions=b.demotions,
                restores=b.restores, cow_splits=b.runtime.cow_splits,
                preemptions=st.preemptions, prefix_hits=st.prefix_hits,
                shortfall_tokens=b.shortfall_tokens,
                staging_checks=len(b.staging_checks),
                staging_ok=all(ok for _, ok in b.staging_checks),
                copy_checks=len(b.runtime.copy_checks),
                copy_ok=all(b.runtime.copy_checks),
                prefill_tokens=b.prefill_tokens_computed,
                decode_tokens=b.decode_tokens_computed)


def phase3(hw):
    """The main path at full qwen2-1.5b width on the card. Returns the
    launch counts of the two serve legs, the model (phase 5 serves on the
    same weights) and 3a's measured step samples (phase 8c prices
    them)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    cfg = get_config("qwen2-1.5b")
    device = "cuda"
    t0 = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    torch.cuda.synchronize()
    log(f"phase3 model {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B params "
        f"in {next(model.parameters()).dtype}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"phase3 hardware profile: {hw}")

    reset_launch_counts()
    t0 = time.perf_counter()
    eng_a, steps, _ = serve_differential(cfg, hw, model, device)
    wall_a = time.perf_counter() - t0
    counts_a = launch_counts()
    st_a = mechanism_stats(eng_a)
    samples = eng_a.backend.samples
    log(f"phase3a differential: {steps} decision steps identical to the "
        f"logical leg, {wall_a:.1f} s wall, {st_a}, launches {counts_a}")
    assert all(p.finish_time >= 0 for p in eng_a.programs.values())
    for key in ("pins", "ttl_hits", "demotions", "restores", "cow_splits"):
        assert st_a[key] > 0, f"phase 3a exercised no {key}"
    assert st_a["staging_ok"] and st_a["copy_ok"], "staging / COW mismatch"
    assert st_a["staging_checks"] and st_a["copy_checks"]
    assert st_a["shortfall_tokens"] == 0, st_a["shortfall_tokens"]
    b = eng_a.backend.inner
    b.runtime.check(b.prefix_index)
    log(f"phase3a calibration of the card's profile to 3a's measured "
        f"steps (3b keeps the datasheet profile): "
        f"{json.dumps(calibration(eng_a.backend, hw))}")

    reset_after_a = dict(counts_a)
    t0 = time.perf_counter()
    eng_b, summary, n_progs = serve_measured(cfg, hw, model, device)
    wall_b = time.perf_counter() - t0
    counts = launch_counts()
    st_b = mechanism_stats(eng_b)
    assert summary.n_programs == n_progs == len(eng_b.programs)
    assert st_b["staging_ok"] and st_b["copy_ok"]
    eng_b.backend.runtime.check(eng_b.backend.prefix_index)
    busy = eng_b.busy_seconds
    log(f"phase3b measured clock: {summary.n_programs} programs, avg JCT "
        f"{summary.avg_jct:.4f} s (p90 {summary.p90_jct:.4f} s), avg TTFT "
        f"{summary.avg_ttft:.4f} s, {eng_b.steps} steps, engine busy "
        f"{busy:.3f} s, {wall_b:.1f} s wall, {st_b}")
    pre_s = sum(s.measured_s for s in samples if s.decode_batch == 0)
    pre_t = sum(s.prefill_tokens for s in samples if s.decode_batch == 0)
    dec_s = sum(s.measured_s for s in samples if s.prefill_tokens == 0)
    dec_t = sum(s.decode_batch for s in samples if s.prefill_tokens == 0)
    rates = dict(
        prefill_tokens_per_s=pre_t / pre_s if pre_s else None,
        decode_tokens_per_s=dec_t / dec_s if dec_s else None,
        avg_decode_batch=(dec_t / sum(1 for s in samples
                                      if s.prefill_tokens == 0 and
                                      s.decode_batch))
        if dec_t else None,
        measured_avg_jct_s=summary.avg_jct,
        measured_tokens_per_s=(st_b["prefill_tokens"] + st_b["decode_tokens"])
        / busy)
    log(f"phase3 throughput (measured step times, 3a prefill-only / "
        f"decode-only steps): {json.dumps(rates)}")
    for name in PATH_A:
        assert counts[name] > 0, f"kernel {name} never launched on path A"
    assert counts_a["flash_attention"] > 0, "no flash prefill in 3a"
    assert counts["flash_attention"] > counts_a["flash_attention"], \
        "no flash prefill in 3b"
    log(f"phase3 launches: 3a {reset_after_a}, 3a+3b {counts}")

    prefill_logit_checks(cfg, device)
    return counts, model, samples


# The logit check of a fresh flash prefill against prefill + extend runs
# on the first CHECK_DEPTH layers of the full-width model. This seeded
# init (the JAX package's: N(0, 1/fan_in) with fan_in the stacked shape's
# second-to-last dim, H = 12 for wq) gives attention scores of std ~100,
# so the softmax is near one-hot and two exact-equivalent paths part
# chaotically with depth: with the plain version in place of the kernel
# the fp32 gap grows ~20x every two layers (logged by the sweep below).
CHECK_DEPTH = 2
SWEEP_DEPTHS = (1, 2, 4, 8, 28)
# Bounds on |flash prefill - prefill + extend| at the last position, as a
# share of the logits' rms. fp32: summation order only (~6e-5 measured at
# two layers), 1e-3. bf16: the extend path rounds its scores to bf16 (as
# the reference does), a rounding of up to 0.5 at |score| ~ 100 that
# shifts softmax weights by e^0.5; 1/4 of the rms.
PREFILL_BOUND = {"bfloat16": 0.25, "float32": 1e-3}


def assert_prefill_vs_extend(check: dict, dtype: str) -> None:
    assert check["argmax_equal"], check
    assert check["max_abs_diff"] <= PREFILL_BOUND[dtype] * \
        check["rms_logit"], check


@contextlib.contextmanager
def plain_prefill_attention():
    """Within the block, the model's fresh-prefill attention (causal and
    sliding-window) runs the flash plain version instead of the kernel
    (for the depth sweep and phase 7's checks)."""
    from repro_torch.kernels.flash_attention import flash_attention_ref
    from repro_torch.models import attention
    kernel_paths = attention.attend_causal, attention.attend_windowed

    def plain(q, k, v, *, scale, cap=0.0, window=0, **_):
        return flash_attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            scale=scale, window=window, softcap=cap).transpose(1, 2)

    attention.attend_causal = attention.attend_windowed = plain
    try:
        yield
    finally:
        attention.attend_causal, attention.attend_windowed = kernel_paths


def sweep_depths(depths, num_layers: int) -> list[int]:
    """The sweep's depths that fit the model, ending at its full depth."""
    return sorted({d for d in depths if d < num_layers} | {num_layers})


def layers_per_block(cfg) -> int:
    """Layers a ``blocks.*`` slice holds: a (local, global) pair for
    gemma2, a group of ``shared_attn_every`` Mamba2 layers for zamba2,
    else one layer."""
    if cfg.family == "hybrid":
        return cfg.shared_attn_every
    return 2 if cfg.local_global_alternating else 1


def cut_model(params: dict, cfg, depth: int, dtype: str, device):
    """The first ``depth`` layers of a model at full width (whole pairs or
    groups of a stack of them; zamba2 keeps both shared blocks)."""
    from repro_torch.models import Model
    per = layers_per_block(cfg)
    if depth % per:
        raise ValueError(f"{cfg.name}: depth {depth} is not a whole number "
                         f"of {per}-layer blocks")
    return Model(dataclasses.replace(cfg, num_layers=depth,
                                     compute_dtype=dtype),
                 {k: v[:depth // per] if k.startswith("blocks.") else v
                  for k, v in params.items()}, device=device)


def prefill_logit_checks(cfg, device) -> None:
    """Flash prefill vs prefill + extend at CHECK_DEPTH layers in bf16 and
    fp32 (asserted), and the fp32 depth sweep, kernel and plain (logged)."""
    import torch
    from repro_torch.models import Model
    params = dict(Model(dataclasses.replace(cfg, compute_dtype="float32"),
                        device=device, seed=0).params)
    depth = min(CHECK_DEPTH, cfg.num_layers)
    for dtype in ("bfloat16", "float32"):
        check = prefill_vs_extend(cut_model(params, cfg, depth, dtype,
                                            device))
        log(f"phase3 flash prefill vs prefill + extend, 1024-token prompt, "
            f"{depth} full-width layers, {dtype}: {json.dumps(check)}")
        assert_prefill_vs_extend(check, dtype)
    sweep = {}
    for depth in sweep_depths(SWEEP_DEPTHS, cfg.num_layers):
        model = cut_model(params, cfg, depth, "float32", device)
        kernel = prefill_vs_extend(model)
        with plain_prefill_attention():
            plain = prefill_vs_extend(model)
        sweep[depth] = dict(kernel=kernel["max_abs_diff"],
                            plain=plain["max_abs_diff"],
                            rms=kernel["rms_logit"])
        del model
    del params
    torch.cuda.empty_cache()
    log(f"phase3 fp32 depth sweep, max |prefill - prefill + extend| with "
        f"the kernel and with the plain version: {json.dumps(sweep)}")


def prefill_vs_extend(model, n: int = 1024, split: int = 512,
                      seed: int = 1) -> dict:
    """Final-position logits of a fresh prefill of an ``n``-token prompt
    (flash attention) against prefill of the first ``split`` tokens then
    extend of the rest (dense ``attend_decode`` over the cache)."""
    import torch
    gen = torch.Generator(device=model.device).manual_seed(seed)
    toks = torch.randint(0, model.cfg.vocab_size, (1, n), generator=gen,
                         device=model.device)
    full, _ = model.forward(toks, cache=model.init_cache(1, n),
                            mode="prefill", logits_slice=1)
    cache = model.init_cache(1, n)
    model.forward(toks[:, :split], cache=cache, mode="prefill",
                  logits_slice=1)
    ext, _ = model.forward(toks[:, split:], cache=cache, cache_len=split,
                           mode="extend", logits_slice=1)
    full, ext = full[0, -1], ext[0, -1]
    assert torch.isfinite(full).all() and torch.isfinite(ext).all()
    return dict(argmax_equal=bool(full.argmax() == ext.argmax()),
                max_abs_diff=(full - ext).abs().max().item(),
                rms_logit=full.square().mean().sqrt().item())


# ---------------------------------------------------------------- phase 4
def synchronize(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def forward_throughput(model, toks, n_dec: int,
                       max_len: int | None = None) -> dict:
    """A timed prefill of ``toks`` (B, T) into a cache of ``max_len``
    (default T) positions and ``n_dec`` timed greedy decode steps, each
    timed after the device has finished."""
    import torch
    B, T = toks.shape
    synchronize(model.device)
    t0 = time.perf_counter()
    logits, cache = model.forward(toks, cache=model.init_cache(
        B, max_len or T), mode="prefill", logits_slice=1)
    synchronize(model.device)
    t_pre = time.perf_counter() - t0
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    t0 = time.perf_counter()
    for i in range(n_dec):
        logits, cache = model.forward(nxt, cache=cache, cache_len=T + i,
                                      mode="decode")
        nxt = logits[:, -1].argmax(-1, keepdim=True)
    synchronize(model.device)
    t_dec = time.perf_counter() - t0
    assert torch.isfinite(logits).all()
    assert all(torch.isfinite(c).all() for c in cache.values())
    return dict(prefill_tokens_per_s=B * T / t_pre,
                decode_tokens_per_s=B * n_dec / t_dec, prefill_s=t_pre,
                decode_step_ms=t_dec / n_dec * 1e3, batch=B, prompt=T)


def rwkv_equivalence(model, toks, tail: int = 64) -> dict:
    """Final WKV states and last logits of one prefill of ``toks`` against
    (a) prefill of all but ``tail`` tokens then ``tail`` one-token decode
    steps (the plain recurrence) and (b) two prefill calls split
    mid-chunk with the state carried in the cache."""
    import torch
    B, T = toks.shape
    full, c_full = model.forward(toks, cache=model.init_cache(B, T),
                                 mode="prefill", logits_slice=1)
    seq, c_seq = model.forward(toks[:, :T - tail],
                               cache=model.init_cache(B, T),
                               mode="prefill", logits_slice=1)
    for t in range(T - tail, T):
        seq, c_seq = model.forward(toks[:, t:t + 1], cache=c_seq,
                                   mode="decode")
    split = T // 2 + 7
    _, c_two = model.forward(toks[:, :split], cache=model.init_cache(B, T),
                             mode="prefill", logits_slice=1)
    two, c_two = model.forward(toks[:, split:], cache=c_two,
                               mode="prefill", logits_slice=1)
    out = {}
    for name, (logit, c) in (("recurrence", (seq, c_seq)),
                             ("two_calls", (two, c_two))):
        out[name] = dict(
            argmax_equal=bool(torch.equal(full[:, -1].argmax(-1),
                                          logit[:, -1].argmax(-1))),
            max_abs_logit_diff=(full[:, -1] - logit[:, -1]).abs().max()
            .item(),
            rms_logit=full[:, -1].square().mean().sqrt().item(),
            max_abs_wkv_diff=(c_full["wkv"] - c["wkv"]).abs().max().item(),
            max_abs_wkv=c_full["wkv"].abs().max().item())
    return out


# The fp32 equivalence checks are asserted on the first RWKV_CHECK_DEPTH
# layers at full width: at this seeded init each layer amplifies a
# perturbation of the residual stream ~1.3x (the logged sweep), so at 32
# layers summation-order noise alone reaches ~4% of the logits' rms. At
# full depth the greedy token must still agree.
RWKV_CHECK_DEPTH = 4
RWKV_SWEEP_DEPTHS = (1, 4, 8, 16, 32)


def assert_rwkv_equivalence(checks: dict) -> None:
    """fp32 on both sides, the same function summed in other orders (the
    chunked scan reassociates up to 64-term sums): within 1e-3 of each
    quantity's scale, argmax equal."""
    for name, c in checks.items():
        assert c["argmax_equal"], (name, c)
        assert c["max_abs_logit_diff"] <= 1e-3 * c["rms_logit"], (name, c)
        assert c["max_abs_wkv_diff"] <= 1e-3 * c["max_abs_wkv"], (name, c)


def rwkv_equivalence_checks(params: dict, cfg, toks, device) -> None:
    """The fp32 checks at RWKV_CHECK_DEPTH layers (asserted), then the
    depth sweep (logged; argmax asserted at full depth)."""
    depth = min(RWKV_CHECK_DEPTH, cfg.num_layers)
    checks = rwkv_equivalence(cut_model(params, cfg, depth, "float32",
                                        device), toks)
    log(f"phase4 fp32, {depth} full-width layers, prefill of "
        f"{toks.shape[1]} tokens against {json.dumps(checks)}")
    assert_rwkv_equivalence(checks)
    sweep = {}
    for depth in sweep_depths(RWKV_SWEEP_DEPTHS, cfg.num_layers):
        checks = rwkv_equivalence(cut_model(params, cfg, depth, "float32",
                                            device), toks)
        sweep[depth] = {name: [c["max_abs_logit_diff"], c["argmax_equal"]]
                        for name, c in checks.items()}
    log(f"phase4 fp32 depth sweep, [max |logit diff|, argmax equal] "
        f"(logits' rms ~1): {json.dumps(sweep)}")
    assert all(ok for _, ok in sweep[depth].values()), sweep


def phase4(smi: str) -> dict:
    """Path B: rwkv6-3b at full width through ``Model.forward``. Returns
    the launch counts of one bf16 prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    cfg = get_config("rwkv6-3b")
    B, T, n_dec = RWKV_RUN["B"], RWKV_RUN["T"], RWKV_RUN["decode_steps"]
    t0 = time.perf_counter()
    m32 = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                device="cuda", seed=0)
    m16 = Model(cfg, dict(m32.params), device="cuda")
    torch.cuda.synchronize()
    log(f"phase4 model {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.d_model // cfg.rwkv.head_size} heads of "
        f"{cfg.rwkv.head_size}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{sum(p.numel() for p in m16.parameters()) / 1e9:.3f} B params, "
        f"fp32 and bf16 copies built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(2)
    toks = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                         device="cuda")

    # bf16, the serving dtype: one prefill with the counts zeroed
    reset_launch_counts()
    logits, _ = m16.forward(toks, cache=m16.init_cache(B, T),
                            mode="prefill", logits_slice=1)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["rwkv6_scan"] == 2 * cfg.num_layers, counts
    assert torch.isfinite(logits).all()
    rates = forward_throughput(m16, toks, n_dec)
    log(f"phase4 throughput (bf16, measured after synchronize) on {smi}: "
        f"{json.dumps(rates)}")
    del m16
    rwkv_equivalence_checks(dict(m32.params), cfg, toks, "cuda")
    del m32
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------- phase 5
#: the cluster workload: phase 3's agent turns (contexts up to ~2k tokens,
#: millisecond local tools and seconds-long pytest) in the skewed shape of
#: the replay harness's ``cluster_programs`` (3 tenants with Zipf skew and
#: a preamble each, tool storms, churn), with arrivals and storm gaps
#: scaled to steps of milliseconds on the card
CLUSTER_RUN = dict(n=10, rate_jps=100.0, storm_gap_s=0.1)
#: the elastic workload: ``elastic_programs``' diurnal wave and bursts on
#: the same turns, over a 1 s period in place of 40 s
ELASTIC_RUN = dict(n=12, rate_jps=50.0, period_s=1.0)


def cluster_agent_programs(seed: int = 0):
    """Phase 5a's programs: ``replay.cluster_programs``' skew (tenants,
    storms, churn) at ``CLUSTER_RUN``'s size and time scale."""
    from repro_torch.sim.workload import generate_skewed_programs
    run = CLUSTER_RUN
    return generate_skewed_programs(
        agent_spec("chip-cluster"), n=run["n"], rate_jps=run["rate_jps"],
        seed=seed, tenants=3, tenant_skew=1.4, share_ratio=0.3, storm_frac=0.4,
        storm_gap_s=run["storm_gap_s"], churn_frac=0.3, churn_scale=6.0)


def elastic_agent_programs(seed: int = 0):
    """Phase 5b's programs: ``replay.elastic_programs``' diurnal wave,
    bursts and skew, with every time scaled by ``period_s`` / 40 s."""
    from repro_torch.sim.workload import generate_diurnal_programs
    run = ELASTIC_RUN
    scale = run["period_s"] / 40.0
    return generate_diurnal_programs(
        agent_spec("chip-cluster"), n=run["n"], rate_jps=run["rate_jps"],
        seed=seed, period_s=run["period_s"], peak_mult=5.0, burst_frac=0.25,
        burst_size=3, burst_span_s=0.5 * scale, tenants=3, tenant_skew=1.4,
        share_ratio=0.3, storm_frac=0.3, storm_gap_s=2.0 * scale,
        churn_frac=0.2, churn_scale=4.0)


def card_scaling_config():
    """``replay.elastic_scaling_config`` with its queue-ETA thresholds and
    holds cut from seconds (a CPU-slow virtual chip) to tens of
    milliseconds (a step on the card is milliseconds)."""
    from repro_torch.serving.cluster import ScalingConfig
    return ScalingConfig(min_replicas=1, max_replicas=5,
                         scale_up_eta_s=0.03, scale_down_eta_s=0.005,
                         pool_pressure=0.9, up_hold_s=0.01,
                         down_hold_s=0.06, cooldown_s=0.06)


def cluster_legs(cfg, hw, model, device, elastic: bool) -> dict:
    """One phase-5 leg: the logical cluster trace, then the physical one
    (every replica a shadow-clocked ``TorchModelBackend`` over ``model``,
    the telemetry plane attached, ``Cluster.check`` after every step).
    Asserts what holds at any width: the traces byte-identical, no
    conservation violation, every staging and COW check bit-exact, no
    shortfall, one model and one stream seed for the fleet, each
    replica's runtime events equal to its backend's counters, and a
    valid Perfetto export. Returns the leg's counts."""
    import torch
    from repro_torch.obs import export as obs_export
    from repro_torch.sim import replay
    rc = replay_config(cfg)
    if elastic:
        progs = elastic_agent_programs()
        kw = dict(replicas=2, scaling=card_scaling_config(),
                  prefill_replicas=1)
    else:
        progs = cluster_agent_programs()
        kw = dict(replicas=3)
    lines_l, viol_l, _ = replay.run_cluster_trace(progs, rc, cfg=cfg, hw=hw,
                                                  **kw)
    host0 = torch.cuda.host_memory_stats() \
        if torch.device(device).type == "cuda" else None
    t0 = time.perf_counter()
    lines_p, viol_p, cluster = replay.run_cluster_trace(
        progs, rc, telemetry=True, physical=True, device=device, cfg=cfg,
        hw=hw, model=model, **kw)
    wall = time.perf_counter() - t0
    assert lines_p == lines_l, next(
        (i, a, b) for i, (a, b) in enumerate(
            zip(lines_l + [None], lines_p + [None])) if a != b)
    assert not viol_l and not viol_p, (viol_l[:3], viol_p[:3])
    fleet = cluster.all_engines()
    backends = [e.backend.inner for e in fleet]
    assert all(b.model is model and b.seed == 0 for b in backends), \
        "replicas must share one Model and one stream seed"
    per = replay.physical_stats(cluster)
    for eid, r in per.items():
        assert r["staging_failures"] == 0 and r["cow_failures"] == 0, \
            (eid, r)
        assert r["shortfall_tokens"] == 0, (eid, r)
        assert r["stage_out_events"] == r["demotions"], (eid, r)
        assert r["restore_events"] == r["restores"], (eid, r)
        assert r["cow_split_events"] == r["cow_splits"], (eid, r)
    errors = obs_export.validate(obs_export.to_chrome(cluster.obs.trace))
    assert not errors, errors[:5]
    cross = replay.cross_replica_restores(cluster.obs)
    out = dict(
        wall_s=wall, steps=sum(e.steps for e in fleet),
        trace_lines=len(lines_p), migrations=cluster.stats.migrations,
        cold_rehomes=cluster.stats.cold_rehomes,
        scale_ups=cluster.stats.scale_ups,
        retired=cluster.stats.retired,
        prefill_handoffs=cluster.stats.prefill_handoffs,
        cross_replica_restores=len(cross), replicas=per,
        telemetry_events=len(cluster.obs.trace.events))
    if host0 is not None:       # pinned buffers the stage-outs allocated
        host1 = torch.cuda.host_memory_stats()
        for key in ("num_host_alloc", "host_alloc_time.total"):
            out[f"pinned_{key}"] = host1[key] - host0[key] \
                if key in host0 and key in host1 else "not measured"
    return out


def phase5(model, hw) -> dict:
    """Path C: the cluster on the card. (a) three full-width qwen2-1.5b
    replicas under ``kv_aware_migrate``, (b) the elastic fleet (two
    decode replicas and one prefill replica to start, the autoscaler
    adding and draining replicas), each leg's physical run held to its
    logical run, with the launch counts zeroed before it and read after.
    Returns ``{leg: counts}``."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    cfg = model.cfg
    t_phase = time.perf_counter()
    counts = {}
    for leg, elastic in (("5a", False), ("5b", True)):
        reset_launch_counts()
        st = cluster_legs(cfg, hw, model, "cuda", elastic)
        counts[leg] = launch_counts()
        log(f"phase{leg} {'elastic fleet' if elastic else 'fixed fleet'}: "
            f"{json.dumps(st)}; launches {counts[leg]}")
        assert st["migrations"] >= 1, f"phase {leg}: no migration"
        assert st["cross_replica_restores"] >= 1, \
            f"phase {leg}: no host copy restored on another replica"
        if elastic:
            assert st["scale_ups"] >= 1, "phase 5b: no scale-up"
            assert st["prefill_handoffs"] >= 1, "phase 5b: no handoff"
        for name in PATH_A:
            assert counts[leg][name] > 0, \
                f"kernel {name} never launched in phase {leg}"
    log(f"phase5 wall {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------- phase 6
#: path D: full-width qwen3-moe-235b-a22b with its depth cut from 94 to 6
#: layers (every layer is alike: one layer is a whole period), bf16
MOE_ARCH, MOE_DEPTH = "qwen3-moe-235b-a22b", 6
#: phase 6b's models at full width in fp32, each cut to this depth (P5):
#: two layers, moonshot its leading dense layer and two MoE layers
FAMILY_DEPTHS = {"qwen3-moe-235b-a22b": 2, "moonshot-v1-16b-a3b": 3,
                 "pixtral-12b": 2, "musicgen-large": 2}
#: the ones the paged runtime serves (moonshot's leading dense layer is
#: refused, ROADMAP R4)
FAMILY_PAGED = ("qwen3-moe-235b-a22b", "pixtral-12b", "musicgen-large")
#: 6b's prompt: ``FAMILY_PROMPT`` tokens, the last ``FAMILY_TAIL`` of
#: them decoded one at a time in the split path
FAMILY_PROMPT, FAMILY_TAIL = 256, 8
#: fp32 bound on |a - b| at the last position as a share of the logits'
#: rms, for two exact-equivalent paths that differ in summation order
#: (flash or the paged kernel against dense attention), as phase 3's
FAMILY_BOUND = PREFILL_BOUND["float32"]


@contextlib.contextmanager
def moe_drop_counts():
    """Within the block, the token-copies each MoE dispatch drops are
    summed on the device, apart for the paged runtime's decode steps and
    for everything else (prefill and extend chunks). Yields the dict of
    0-d tensors' lists; read it after the block."""
    from repro_torch.models import moe
    from repro_torch.serving.paged_runtime import PagedKVRuntime
    drops = {"prefill": [], "decode": []}
    kind = ["prefill"]
    plan, step = moe._dispatch_plan, PagedKVRuntime._decode_step

    def counted_plan(flat_ids, E, C):
        src, dest = plan(flat_ids, E, C)
        drops[kind[0]].append((dest == E * C).sum())
        return src, dest

    def decode_step(self, *args, **kwargs):
        kind[0] = "decode"
        try:
            return step(self, *args, **kwargs)
        finally:
            kind[0] = "prefill"

    moe._dispatch_plan = counted_plan
    PagedKVRuntime._decode_step = decode_step
    try:
        yield drops
    finally:
        moe._dispatch_plan = plan
        PagedKVRuntime._decode_step = step


def summed(tensors: list) -> int:
    import torch
    return int(torch.stack(tensors).sum()) if tensors else 0


def serve_moe(cfg, hw, device) -> tuple[dict, dict]:
    """Phase 6a's leg: ``cfg`` (a MoE model, bf16) serving phase 3's agent
    programs through the unchanged ``Engine``, the physical decision
    stream held to the logical leg's, with the launch counts zeroed before
    it and the MoE dispatches' dropped copies counted. Its wall time and
    ms a step are the physical leg's alone, and include the drop count's
    two device ops a MoE dispatch (a compare and a sum, no sync). Asserts
    what holds at any width: no divergence, every staging and COW check
    bit-exact, no shortfall, refcounts conserved, no copy dropped in a
    decode step. Returns the leg's counts and its launch counts."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, device=device, seed=0)
    synchronize(device)
    built_s = time.perf_counter() - t0
    reset_launch_counts()
    with moe_drop_counts() as drops:
        eng, steps, wall = serve_differential(cfg, hw, model, device)
    counts = launch_counts()
    st = mechanism_stats(eng)
    out = dict(decision_steps=steps, engine_steps=eng.steps,
               physical_wall_s=wall, ms_per_step=1e3 * wall / eng.steps,
               dropped_copies_prefill=summed(drops["prefill"]),
               dropped_copies_decode=summed(drops["decode"]),
               moe_dispatches={k: len(v) for k, v in drops.items()},
               params=sum(p.numel() for p in model.parameters()),
               model_built_s=built_s, **st)
    if cuda:
        out["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
    assert all(p.finish_time >= 0 for p in eng.programs.values())
    assert st["staging_ok"] and st["copy_ok"], "staging / COW mismatch"
    assert st["shortfall_tokens"] == 0, st["shortfall_tokens"]
    b = eng.backend.inner
    b.runtime.check(b.prefix_index)
    assert out["dropped_copies_decode"] == 0, "a decode step dropped"
    return out, counts


def family_checks(cfg, device) -> dict:
    """Phase 6b for one model (at full width and cut depth on the card),
    in fp32: ``Model.forward``'s prefill of the whole prompt against
    prefill of all but the tail followed by decode steps with the cache
    (k0/v0 too); for the families the paged runtime serves, its prefill
    and decode against ``Model.forward`` on the same tokens; for the VLM
    family, the ``embeds`` input against the token path fed the same
    embedding rows. The split check runs with the capacity factor at E /
    top_k, where no copy can drop: a whole prefill groups its tokens
    otherwise than one-token decode steps do, and a copy dropped in one
    grouping and kept in the other is the reference's semantics, not a
    fault (the paged checks group tokens alike and keep the config's
    capacity). Returns the measured gaps."""
    import torch
    from repro_torch.models import Model
    from repro_torch.serving.paged_runtime import require_paged
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    model = Model(cfg, device=device, seed=0)
    gen = torch.Generator(device=model.device).manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (1, FAMILY_PROMPT),
                         generator=gen, device=model.device)
    out = {}
    split = model
    if cfg.moe:
        m = cfg.moe
        split = Model(dataclasses.replace(cfg, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k)),
            dict(model.params), device=device)
    with moe_drop_counts() as drops:
        out["prefill_vs_decode"] = prefill_vs_decode(split, toks,
                                                     FAMILY_TAIL)
    out["prefill_vs_decode"]["dropped_copies"] = summed(
        drops["prefill"] + drops["decode"])
    del split
    try:
        require_paged(cfg)
        paged = True
    except ValueError:          # leading dense layers (ROADMAP R4)
        paged = False
    if paged:
        out["paged_vs_forward"] = paged_vs_forward(model, toks, FAMILY_TAIL)
    if cfg.family == "vlm":
        rows = model.params["embed"][toks]
        by_tokens, _ = model.forward(toks, cache=model.init_cache(
            1, FAMILY_PROMPT), logits_slice=1)
        by_embeds, _ = model.forward(embeds=rows, cache=model.init_cache(
            1, FAMILY_PROMPT), logits_slice=1)
        out["embeds_vs_tokens"] = gap(by_tokens[0, -1], by_embeds[0, -1])
    cuda = model.device.type == "cuda"
    del model
    if cuda:
        torch.cuda.empty_cache()
    return out


def gap(a, b) -> dict:
    """The last position's logits of two paths: argmax agreement, max
    |a - b| and the rms of ``a``."""
    import torch
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    return dict(argmax_equal=bool(a.argmax() == b.argmax()),
                max_abs_diff=(a - b).abs().max().item(),
                rms_logit=a.square().mean().sqrt().item())


def prefill_vs_decode(model, toks, tail: int) -> dict:
    """Prefill of the whole prompt against prefill of all but ``tail``
    tokens followed by ``tail`` decode steps with the cache."""
    import torch
    n = toks.shape[1]
    full, _ = model.forward(toks, cache=model.init_cache(1, n),
                            logits_slice=1)
    cache = model.init_cache(1, n)
    model.forward(toks[:, :n - tail], cache=cache, logits_slice=1)
    for t in range(n - tail, n):
        step, cache = model.forward(toks[:, t:t + 1], cache=cache,
                                    cache_len=torch.full((1,), t),
                                    mode="decode")
    return gap(full[0, -1], step[0, -1])


def paged_vs_forward(model, toks, steps: int) -> dict:
    """The paged runtime's prefill of the prompt and ``steps`` greedy
    decode steps against ``Model.forward`` on the same tokens; the worst
    step's gap."""
    import torch
    from repro_torch.serving.paged_runtime import PagedKVRuntime
    n = toks.shape[1]
    cache = model.init_cache(1, n + steps)
    ref, cache = model.forward(toks, cache=cache, logits_slice=1)
    rt = PagedKVRuntime(model.cfg, n_pages=(n + steps) // 16 + 2,
                        page_size=16, device=model.device)
    gaps = [gap(ref[0, -1], rt.prefill(model, "p", toks[0]))]
    tok = ref[0, -1].argmax()
    for t in range(n, n + steps):
        ref, cache = model.forward(tok.reshape(1, 1), cache=cache,
                                   cache_len=torch.full((1,), t),
                                   mode="decode")
        gaps.append(gap(ref[0, -1], rt.decode(model, "p")))
        tok = ref[0, -1].argmax()
    worst = max(gaps, key=lambda g: g["max_abs_diff"] / g["rms_logit"])
    return dict(worst, steps=steps,
                argmax_equal=all(g["argmax_equal"] for g in gaps))


def assert_family_checks(checks: dict) -> None:
    for name, g in checks.items():
        assert g["argmax_equal"], (name, g)
        if name == "embeds_vs_tokens":      # the same ops on the same rows
            assert g["max_abs_diff"] == 0, (name, g)
        else:
            assert g["max_abs_diff"] <= FAMILY_BOUND * g["rms_logit"], \
                (name, g)
    assert checks["prefill_vs_decode"]["dropped_copies"] == 0, checks


def phase6(hw) -> dict:
    """Path D: (a) full-width qwen3-moe (``MOE_DEPTH`` layers) served on
    the card, with every mechanism and every kernel of path A exercised
    and prefill chunks dropping copies; (b) the four new families'
    equivalence checks at full width and cut depth. Returns 6a's launch
    counts."""
    import torch
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_DEPTH)
    st, counts = serve_moe(cfg, hw, "cuda")
    log(f"phase6a {cfg.name}, {cfg.num_layers} of 94 layers at full width "
        f"(d_model {cfg.d_model}, {cfg.num_heads} heads / "
        f"{cfg.num_kv_heads} KV heads of {cfg.head_dim}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} of "
        f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab_size}), bf16: "
        f"{json.dumps(st)}; launches {counts}")
    for key in ("pins", "ttl_hits", "demotions", "restores", "cow_splits",
                "staging_checks", "copy_checks", "dropped_copies_prefill"):
        assert st[key] > 0, f"phase 6a exercised no {key}"
    for name in PATH_A:
        assert counts[name] > 0, f"kernel {name} never launched in phase 6a"
    # 6a's engine and backends refer to each other: only the cycle
    # collector frees their model's weights
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase6a freed: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"still allocated")
    torch.cuda.reset_peak_memory_stats()
    for arch, depth in FAMILY_DEPTHS.items():
        t0 = time.perf_counter()
        checks = family_checks(
            dataclasses.replace(get_config(arch), num_layers=depth), "cuda")
        log(f"phase6b {arch}, {depth} full-width layers, fp32, "
            f"{FAMILY_PROMPT}-token prompt, tail {FAMILY_TAIL}: "
            f"{json.dumps(checks)} ({time.perf_counter() - t0:.1f} s)")
        assert_family_checks(checks)
        assert ("paged_vs_forward" in checks) == (arch in FAMILY_PAGED)
    log(f"phase6 wall {time.perf_counter() - t_phase:.1f} s, 6b peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")
    return counts


# ---------------------------------------------------------------- phase 7
#: path E: the families the engine does not page, through Model.forward
#: at full published width and depth (bf16, seeded weights): a prompt
#: past gemma2's 4096-token window into a cache whose local rings wrap in
#: prefill, and zamba2 at B = 2; neither prompt a whole number of 64-row
#: flash tiles or 64-token SSD chunks. ``flash``: launches a prefill (one
#: a gemma2 layer, one a zamba2 shared block: 9 groups of 6). ``depths``:
#: the fp32 checks' cut depths (P5): 1 and 2 pairs, 1 and 2 groups.
PATH_E = {"7a": dict(arch="gemma2-9b", B=1, prompt=4600, max_len=4672,
                     flash=42, check="7b", depths=(2, 4)),
          "7c": dict(arch="zamba2-2.7b", B=2, prompt=2000, max_len=2032,
                     flash=9, check="7d", depths=(6, 12))}
PATH_E_DECODE = 32
#: 7b / 7d: the last PATH_E_TAIL prompt tokens decoded one at a time in
#: the split path (across gemma2's ring: the prefill of 4536 tokens wraps
#: it, every decode step overwrites its oldest slot)
PATH_E_TAIL = 64


def kernel_vs_plain(model, toks) -> dict:
    """The last position's logits of a fresh prefill with the flash
    kernel (on the card; the blocked plain attention on the CPU) against
    the same prefill under ``plain_prefill_attention``."""
    n = toks.shape[1]
    kern, _ = model.forward(toks, cache=model.init_cache(1, n),
                            logits_slice=1)
    with plain_prefill_attention():
        plain, _ = model.forward(toks, cache=model.init_cache(1, n),
                                 logits_slice=1)
    return gap(kern[0, -1], plain[0, -1])


def path_e_checks(params: dict, cfg, depth: int, prompt: int, tail: int,
                  device) -> dict:
    """Phase 7b / 7d at one cut depth, fp32: the prefill of ``prompt``
    tokens against prefill of all but ``tail`` and ``tail`` decode steps,
    and the prefill through the flash kernel against the plain version
    (on the card the flash launches are counted and asserted)."""
    import torch
    from repro_torch.kernels import launch_counts
    model = cut_model(params, cfg, depth, "float32", device)
    gen = torch.Generator(device=model.device).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen,
                         device=model.device)
    before = launch_counts()["flash_attention"]
    out = dict(prefill_vs_decode=prefill_vs_decode(model, toks, tail),
               kernel_vs_plain=kernel_vs_plain(model, toks))
    if model.device.type == "cuda":
        assert launch_counts()["flash_attention"] > before, "no flash"
    del model
    return out


def assert_path_e_checks(checks: dict) -> None:
    """fp32 on both sides, the same function summed in other orders:
    within 1e-3 of the logits' rms, argmax equal (as phase 6b)."""
    for name, g in checks.items():
        assert g["argmax_equal"], (name, g)
        assert g["max_abs_diff"] <= FAMILY_BOUND * g["rms_logit"], (name, g)


def phase7(smi: str) -> dict:
    """Path E: gemma2-9b (7a) and zamba2-2.7b (7c) at full width and depth
    in bf16 through ``Model.forward``, a timed prefill and
    ``PATH_E_DECODE`` greedy decode steps each after an untimed warm-up
    (a prefill and two steps), with the counts zeroed before and read
    after (flash launched ``flash`` times); then each at its cut depths in
    fp32 (7b, 7d). Returns each leg's launch counts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    t_phase = time.perf_counter()
    counts = {}
    for leg, run in PATH_E.items():
        cfg = get_config(run["arch"])
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg, device="cuda", seed=0)
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        gen = torch.Generator(device="cuda").manual_seed(2)
        toks = torch.randint(0, cfg.vocab_size, (run["B"], run["prompt"]),
                             generator=gen, device="cuda")
        warm = forward_throughput(model, toks, 2, run["max_len"])
        reset_launch_counts()
        rates = forward_throughput(model, toks, PATH_E_DECODE,
                                   run["max_len"])
        rates["first_call_prefill_s"] = warm["prefill_s"]
        counts[leg] = launch_counts()
        rates.update(flash_launches=counts[leg]["flash_attention"],
                     params=sum(p.numel() for p in model.parameters()),
                     weight_gb=sum(p.numel() * p.element_size()
                                   for p in model.parameters()) / 1e9,
                     model_built_s=built_s,
                     max_memory_allocated_gb=torch.cuda
                     .max_memory_allocated() / 1e9)
        log(f"phase{leg} {cfg.name}, {cfg.num_layers} layers at full width "
            f"(d_model {cfg.d_model}, {cfg.num_heads} heads / "
            f"{cfg.num_kv_heads} KV heads of {cfg.head_dim}), bf16, "
            f"max_len {run['max_len']}, on {smi}: {json.dumps(rates)}; "
            f"launches {counts[leg]}")
        assert counts[leg]["flash_attention"] == run["flash"], counts[leg]
        del model, toks
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        top = max(run["depths"])
        params = dict(Model(dataclasses.replace(
            cfg, num_layers=top, compute_dtype="float32"), device="cuda",
            seed=0).params)
        for depth in run["depths"]:
            checks = path_e_checks(params, cfg, depth, run["prompt"],
                                   PATH_E_TAIL, "cuda")
            log(f"phase{run['check']} {cfg.name}, {depth} full-width "
                f"layers, fp32, {run['prompt']}-token prompt, tail "
                f"{PATH_E_TAIL}: {json.dumps(checks)}")
            assert_path_e_checks(checks)
        del params
        torch.cuda.empty_cache()
        log(f"phase{run['check']} wall {time.perf_counter() - t0:.1f} s")
    log(f"phase7 wall {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------- phase 8
#: path F, 8a: training at qwen2-1.5b's full width and depth, bf16 compute
#: over fp32 masters and moments, remat "full": train_4k's 4096-token rows
#: with its global batch of 256 cut to 2 (one row a microbatch at the
#: config's train_microbatches = 2), a warm-up step and then ``steps``
#: timed; 10 made phase 8 take 72.0 s (3.0-3.9 s a step, host-bound), 6
#: keep it near 60
TRAIN_F = dict(arch="qwen2-1.5b", seq=4096, batch=2, full_batch=256,
               steps=6)
#: 8b: the card against the CPU, the same config cut to 2 layers at full
#: width (P5), fp32 compute, one 128-token row, two steps; checkpoint at
#: step 1 and resume into a fresh trainer for step 2
TRAIN_CHECK = dict(layers=2, seq=128, batch=1, steps=2)
#: 8b's bound on the card-vs-CPU and resumed-vs-uninterrupted gaps
#: (relative): fp32 on both sides, other summation orders (and the
#: embedding's backward accumulates with atomics on the card); the
#: reference's own resume bound (tests/test_train.py)
TRAIN_RTOL = 1e-4


#: path F's weights: qwen2-1.5b's published initializer (initializer_range
#: 0.02 in its Hugging Face config), N(0, 0.02) for every matrix and
#: embedding, zeros for biases and norm offsets. The port's seeded init
#: (the reference's, fan_in the stacked shape's second-to-last dim) gives
#: a full-depth grad norm past fp32's range and a 2-layer model whose
#: step-2 grad norm moves 2% when half the weights move one ulp (P5)
INIT_STD = 0.02


def published_init(cfg, gen) -> dict:
    """Every fp32 master of ``cfg``'s model drawn from ``gen`` on its
    device, leaf by leaf in name order, with ``INIT_STD``."""
    import torch
    from repro_torch.models.transformer import model_specs
    out = {}
    for name, spec in sorted(model_specs(cfg).items()):
        if spec.init in ("zeros", "ones"):
            out[name] = torch.full(spec.shape, float(spec.init == "ones"),
                                   device=gen.device)
        else:
            out[name] = torch.randn(spec.shape, generator=gen,
                                    device=gen.device).mul_(INIT_STD)
    return out


def train_adamw(steps: int):
    """A short run's schedule: the reference's AdamW defaults (lr 3e-4),
    warmup of one step, cosine decay to 0 one step past the run (its
    last step still updates). At lr 1e-3 the first steps overshoot: the
    loss of a 4-layer full-width cut went 12.17 -> 15.28 by step 5 (my
    CPU run), 12.20 -> 14.78 at full depth (my chip call 2)."""
    from repro_torch.train.optimizer import AdamWConfig
    return AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=steps + 1)


def make_trainer(cfg, shape, steps: int, device, ckpt_dir,
                 ckpt_every: int = 10 ** 9):
    from repro_torch.train.train_loop import TrainConfig, Trainer
    tcfg = TrainConfig(steps=steps, ckpt_every=ckpt_every,
                       ckpt_dir=str(ckpt_dir), log_every=10 ** 9,
                       adamw=train_adamw(steps))
    return Trainer(cfg, None, shape, tcfg, log_fn=log, device=device)


def train_steps(cfg, shape, steps: int, device, ckpt_dir,
                peak_flops: float | None = None) -> list[dict]:
    """8a: a trainer from :func:`published_init` (seed 0), its warm-up
    step and ``steps`` more through ``Trainer.run``, one step a call.
    Each record: loss, grad norm,
    ``step_ms`` (the trainer's own time of the step, which ends in the
    loss's read back and so waits for the stream, AdamW update
    included), ``wall_ms`` (with the host's batch and a device sync),
    tokens/s and, with ``peak_flops``, the model-FLOPs share ``6 N
    tokens / (step s x peak)``."""
    import torch
    tr = make_trainer(cfg, shape, steps + 1, device, ckpt_dir)
    tr.init_state(published_init(
        cfg, torch.Generator(device=tr.device).manual_seed(0)))
    tokens = shape.global_batch * shape.seq_len
    n = cfg.param_count()
    out = []
    for _ in range(steps + 1):
        t0 = time.perf_counter()
        rec = dict(tr.run(steps=tr.step + 1)[-1])
        synchronize(device)
        rec["wall_ms"] = (time.perf_counter() - t0) * 1e3
        rec["step_ms"] = rec.pop("sec") * 1e3
        rec["tokens_per_s"] = tokens / rec["step_ms"] * 1e3
        if peak_flops:
            rec["flops_share"] = 6 * n * tokens / (
                rec["step_ms"] / 1e3 * peak_flops)
        out.append(rec)
    return out


def assert_training(recs: list[dict]) -> None:
    """Every loss finite, and the mean of the last three below the
    first."""
    losses = [r["loss"] for r in recs]
    assert all(math.isfinite(x) for x in losses), losses
    assert sum(losses[-3:]) / 3 < losses[0], losses


def card_vs_cpu(cfg, device, ckpt_dir, layers: int, seq: int, batch: int,
                steps: int) -> dict:
    """8b: ``cfg`` cut to ``layers`` at full width, fp32, one microbatch,
    from one set of fp32 params (:func:`published_init`, seed 0, drawn on
    ``device`` and copied to the host): ``steps`` steps
    on ``device`` and on the CPU; then ``device`` again, saving at step 1,
    and a fresh trainer resumed from it for the rest. Returns the
    histories' relative gaps."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    cut = dataclasses.replace(cfg, num_layers=layers,
                              compute_dtype="float32", train_microbatches=1)
    params = {k: v.cpu() for k, v in published_init(
        cut, torch.Generator(device=device).manual_seed(0)).items()}
    shape = ShapeSpec("f_check", "train", seq, batch)
    ckpt_dir = pathlib.Path(ckpt_dir)

    def run(dev, sub, init=True, ckpt_every=10 ** 9, upto=steps):
        tr = make_trainer(cut, shape, steps, dev, ckpt_dir / sub, ckpt_every)
        if init:
            tr.init_state(params)
        else:
            assert tr.resume() and tr.step == 1, tr.step
        return tr.run(steps=upto)

    card = run(device, "card")
    host = run("cpu", "cpu")
    run(device, "resume", ckpt_every=1, upto=1)
    resumed = run(device, "resume", init=False)

    def rel(a, b):
        return abs(a - b) / abs(b)

    return dict(losses=[r["loss"] for r in card],
                loss_gaps=[rel(a["loss"], b["loss"])
                           for a, b in zip(card, host)],
                grad_norm_gaps=[rel(a["grad_norm"], b["grad_norm"])
                                for a, b in zip(card, host)],
                resume_gap=rel(resumed[-1]["loss"], card[-1]["loss"]))


def assert_card_vs_cpu(gaps: dict) -> None:
    worst = max(gaps["loss_gaps"] + gaps["grad_norm_gaps"] +
                [gaps["resume_gap"]])
    assert worst <= TRAIN_RTOL and all(map(math.isfinite, gaps["losses"])), \
        gaps


def roofline_checks(cfg, hw, samples) -> dict:
    """8c: ``CostModel.from_roofline`` at ``cfg``'s full width (counted on
    the meta device) beside the analytic profile; both cost models'
    seconds for phase 3a's prefill-only and decode-only steps beside the
    measured ones; then ``Engine(cost_source="roofline")`` under the
    virtual-clock simulator on 12 SWE-Bench programs (the reference's
    ``test_engine_runs_with_roofline_cost_source`` on this card's
    profile), which must pin."""
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.profiler import CostModel, build_profile
    from repro_torch.sim.runner import run_workload
    from repro_torch.sim.workload import SWE_BENCH, generate_programs
    t0 = time.perf_counter()
    roof = CostModel.from_roofline(cfg, hw=hw)
    counted_s = time.perf_counter() - t0
    models = {"roofline": roof, "analytic": CostModel(build_profile(cfg), hw)}
    out = {"count_s": counted_s, "profiles": {
        name: dict(flops_per_token=m.prof.flops_per_token,
                   active_param_bytes=m.prof.active_param_bytes)
        for name, m in models.items()}}
    kinds = {"prefill": (lambda s: s.decode_batch == 0,
                         lambda m, s: m.prefill_seconds(s.prefill_tokens,
                                                        s.prefill_context)),
             "decode": (lambda s: s.prefill_tokens == 0 and s.decode_batch,
                        lambda m, s: m.decode_step_seconds(
                            s.decode_batch, s.decode_avg_context))}
    for kind, (pick, seconds) in kinds.items():
        chosen = [s for s in samples if pick(s)]
        measured = sum(s.measured_s for s in chosen)
        rec = {"steps": len(chosen), "measured_s": measured}
        for name, m in models.items():
            rec[f"{name}_s"] = sum(seconds(m, s) for s in chosen)
            rec[f"measured_over_{name}"] = measured / rec[f"{name}_s"] \
                if rec[f"{name}_s"] else None
        out[kind] = rec
    programs = generate_programs(SWE_BENCH, n=12, rate_jps=0.2, seed=0)
    eng = Engine(cfg, EngineConfig(policy="continuum", chips=1,
                                   kv_budget_bytes=10e9,
                                   cost_source="roofline"), hw)
    summary = run_workload(programs, [eng], max_seconds=1e6)
    out["engine"] = dict(programs=summary.n_programs,
                         pins=eng.scheduler.stats.pins,
                         ttl_hits=eng.scheduler.stats.ttl_hits,
                         avg_jct_s=summary.avg_jct)
    return out


def assert_roofline(checks: dict) -> None:
    """The counted profile within 2x of the analytic one (the bound of
    tests/test_dist_cost.py), and the roofline-priced engine pinned."""
    a, r = (checks["profiles"][k] for k in ("analytic", "roofline"))
    for key in ("flops_per_token", "active_param_bytes"):
        assert 0.5 < r[key] / a[key] < 2.0, (key, r, a)
    assert checks["engine"]["programs"] == 12, checks["engine"]
    assert checks["engine"]["pins"] > 0, checks["engine"]


def phase8(hw, smi: str, sheet: dict, samples) -> dict:
    """Path F: 8a trains full-width, full-depth qwen2-1.5b on the card
    (counts zeroed before, read after: no kernel launches, the training
    forward runs the reference's plain arithmetic); 8b holds the card
    against the CPU and a resumed run against an uninterrupted one; 8c
    builds the roofline cost model at full width and prices phase 3a's
    steps with it. Returns 8a's launch counts."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_F["arch"])
    shape = ShapeSpec("train_4k_cut", "train", TRAIN_F["seq"],
                      TRAIN_F["batch"])
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        recs = train_steps(cfg, shape, TRAIN_F["steps"], "cuda",
                           pathlib.Path(tmp) / "8a", sheet["bf16"])
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
        for i, rec in enumerate(recs):
            log(f"phase8a step {i} ({'warm-up' if i == 0 else 'timed'}): "
                f"{json.dumps(rec)}")
        timed = recs[1:]
        step_ms = sorted(r["step_ms"] for r in timed)
        log(f"phase8a {cfg.name} training, {cfg.num_layers} layers at full "
            f"width (d_model {cfg.d_model}, {cfg.param_count() / 1e9:.3f} B "
            f"params), fp32 masters and {cfg.opt_state_dtype} moments, "
            f"{cfg.compute_dtype} compute, remat {cfg.remat}, "
            f"{cfg.train_microbatches} microbatches; train_4k's "
            f"{TRAIN_F['seq']}-token rows, global batch cut from "
            f"{TRAIN_F['full_batch']} to {TRAIN_F['batch']}; on {smi}: "
            + json.dumps(dict(
                timed_steps=len(timed), median_step_ms=step_ms[len(step_ms)
                                                              // 2],
                min_step_ms=step_ms[0], max_step_ms=step_ms[-1],
                median_tokens_per_s=sorted(r["tokens_per_s"] for r in timed)
                [len(timed) // 2],
                median_flops_share=sorted(r["flops_share"] for r in timed)
                [len(timed) // 2],
                first_loss=recs[0]["loss"], last_loss=recs[-1]["loss"],
                max_memory_allocated_gb=peak))
            + f"; launches {counts}")
        assert_training(recs)
        assert not any(counts.values()), f"a kernel ran on path F: {counts}"

        t0 = time.perf_counter()
        gaps = card_vs_cpu(cfg, "cuda", pathlib.Path(tmp) / "8b",
                           **TRAIN_CHECK)
        log(f"phase8b {cfg.name} cut to {TRAIN_CHECK['layers']} full-width "
            f"layers, fp32, B {TRAIN_CHECK['batch']} x {TRAIN_CHECK['seq']} "
            f"tokens, {TRAIN_CHECK['steps']} steps, card vs CPU and resumed "
            f"vs uninterrupted (bound {TRAIN_RTOL} relative): "
            f"{json.dumps(gaps)}; {time.perf_counter() - t0:.1f} s")
        assert_card_vs_cpu(gaps)
    torch.cuda.empty_cache()

    roof = roofline_checks(cfg, hw, samples)
    log(f"phase8c roofline cost model of {cfg.name} at full width (counted "
        f"on the meta device) beside the analytic profile, and phase 3a's "
        f"measured steps priced by each, hardware profile {hw.name}: "
        f"{json.dumps(roof)}")
    assert_roofline(roof)
    log(f"phase8 wall {time.perf_counter() - t_phase:.1f} s")
    return counts


# ------------------------------------------------------------------ phase 9
#: path G: 9a's serving legs, 9b's training cut, 9c's MoE layer, 9d's
#: production dry-run cells (arch, shape, two pods)
PATH_G = dict(arch="qwen2-1.5b", batch=1, prompt=2048, steps=16)
PATH_G_TRAIN = dict(layers=2, seq=128, batch=1, steps=2)
PATH_G_TRAIN_RTOL = 1e-6
PATH_G_MOE = dict(arch="qwen3-moe-235b-a22b", batch=1, tokens=512)
#: 9c's bound: bf16 outputs, the max error over the reference's rms
PATH_G_MOE_BOUND = 1e-2
PATH_G_DRYRUN = (("qwen2-1.5b", "train_4k", False),
                 ("qwen2-1.5b", "prefill_32k", False),
                 ("qwen2-1.5b", "decode_32k", False),
                 ("qwen3-moe-235b-a22b", "train_4k", True))
DRYRUN_TIMEOUT_S = 600


def wall_ms(fn, device, iters: int = 5, warmup: int = 1) -> float:
    """Mean wall milliseconds per call (host included), ``device``
    synchronised around ``iters`` calls after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / iters


def init_group(backend: str, device) -> None:
    """A one-rank process group on a free local port (``device``'s
    card bound for NCCL)."""
    import socket

    import torch
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    kw = {}
    if backend == "nccl":
        torch.cuda.set_device(torch.device(device))
        kw["device_id"] = torch.device(device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, **kw)


def serve_legs(pf, dc, toks, steps: int, device) -> dict:
    """A prefill step then ``steps`` decode steps from its tokens: each
    step's next tokens and fp32 logits, and its wall ms."""
    import torch
    B, prompt = toks.shape
    cache = pf.model.init_cache(B, prompt + steps, pf.rules)
    synchronize(device)
    t0 = time.perf_counter()
    nxt, cache, lg = pf.fn(cache, toks, logits=True)
    synchronize(device)
    ms = [(time.perf_counter() - t0) * 1e3]
    tokens, logits = [nxt], [lg]
    for i in range(steps):
        t0 = time.perf_counter()
        nxt, cache, lg = dc.fn(cache, nxt[:, None].long(),
                               torch.full((B,), prompt + i,
                                          dtype=torch.int32), logits=True)
        synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(nxt)
        logits.append(lg)
    return dict(tokens=tokens, logits=logits, prefill_ms=ms[0],
                decode_ms=sorted(ms[1:])[len(ms[1:]) // 2])


def sharded_serving(cfg, mesh, device, batch: int, prompt: int, steps: int,
                    seed: int = 0) -> dict:
    """9a: ``cfg``'s model drawn from ``seed``, its meshless prefill and
    decode steps and the same steps on ``mesh`` (the weights copied into
    DTensors), a warm-up run of each leg, then a timed one, the sharded
    leg's kernel launches counted. Returns the legs' times, the launch
    counts and whether tokens and logits agree bit for bit."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.models.steps import build_decode_step, build_prefill_step
    model = Model(cfg, device=device, seed=seed)
    pshape = ShapeSpec("g_prefill", "prefill", prompt + steps, batch)
    dshape = ShapeSpec("g_decode", "decode", prompt + steps, batch)
    legs = {}
    for name, m in (("meshless", None), ("sharded", mesh)):
        pf = build_prefill_step(cfg, m, pshape, model=model, device=device)
        legs[name] = (pf, build_decode_step(cfg, m, dshape, model=pf.model,
                                            device=device))
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                         generator=torch.Generator().manual_seed(seed)
                         ).to(device)
    for name in legs:                                   # warm-up
        serve_legs(*legs[name], toks, steps, device)
    reset_launch_counts()
    runs = {"sharded": serve_legs(*legs["sharded"], toks, steps, device)}
    counts = launch_counts()
    runs["meshless"] = serve_legs(*legs["meshless"], toks, steps, device)
    a, b = runs["sharded"], runs["meshless"]
    return dict(
        tokens_equal=all(torch.equal(x, y) for x, y in zip(a["tokens"],
                                                           b["tokens"])),
        logits_bit_equal=all(torch.equal(x, y) for x, y in
                             zip(a["logits"], b["logits"])),
        max_abs_logit_gap=max(float((x - y).abs().max()) for x, y in
                              zip(a["logits"], b["logits"])),
        **{f"{leg}_{k}": runs[leg][k] for leg in runs
           for k in ("prefill_ms", "decode_ms")},
        launches=counts)


def assert_sharded_serving(check: dict) -> None:
    assert check["tokens_equal"] and check["logits_bit_equal"], check
    assert check["launches"]["flash_attention"] > 0, check


def sharded_training(cfg, mesh_fn, device, ckpt_dir, layers: int, seq: int,
                     batch: int, steps: int) -> dict:
    """9b: ``cfg`` cut to ``layers`` at full width, fp32, one microbatch,
    from :func:`published_init` (seed 0): step 1 of a meshless trainer
    and of one on ``mesh_fn()``; then the sharded one moved to a fresh
    ``mesh_fn()`` (``reshard_for_mesh``) and run ``steps`` more steps.
    Returns the step-1 gaps and the later losses."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train.train_loop import TrainConfig, Trainer
    cut = dataclasses.replace(cfg, num_layers=layers,
                              compute_dtype="float32", train_microbatches=1)
    params = {k: v.cpu() for k, v in published_init(
        cut, torch.Generator(device=device).manual_seed(0)).items()}
    shape = ShapeSpec("g_train", "train", seq, batch)

    def trainer(mesh, sub):
        tcfg = TrainConfig(steps=steps + 1, ckpt_every=10 ** 9,
                           ckpt_dir=str(pathlib.Path(ckpt_dir) / sub),
                           log_every=10 ** 9, adamw=train_adamw(steps + 1))
        tr = Trainer(cut, mesh, shape, tcfg, log_fn=log, device=device)
        tr.init_state(params)
        return tr

    (plain,) = trainer(None, "plain").run(steps=1)
    tr = trainer(mesh_fn(), "sharded")
    (first,) = tr.run(steps=1)
    tr.reshard_for_mesh(mesh_fn())
    later = tr.run(steps=1 + steps)[1:]

    def rel(x, y):
        return abs(x - y) / abs(y)

    return dict(loss=first["loss"], meshless_loss=plain["loss"],
                loss_gap=rel(first["loss"], plain["loss"]),
                grad_norm_gap=rel(first["grad_norm"], plain["grad_norm"]),
                resharded_losses=[r["loss"] for r in later])


def assert_sharded_training(check: dict) -> None:
    assert max(check["loss_gap"], check["grad_norm_gap"]) <= \
        PATH_G_TRAIN_RTOL, check
    assert len(check["resharded_losses"]) == PATH_G_TRAIN["steps"] and \
        all(map(math.isfinite, check["resharded_losses"])), check


def a2a_vs_grouped(cfg, mesh, device, batch: int, tokens: int,
                   seed: int = 0) -> dict:
    """9c: one MoE layer of ``cfg`` (``sharding_mode="ep_a2a"``) in its
    compute dtype, drawn from ``seed``: the all-to-all path under the
    mesh's prefill rules (run under the step counter, which sees the
    collectives) against the grouped path without a mesh on the same
    input. Returns the error, both times and the collective bytes."""
    import torch
    from repro_torch.dist.roofline import _Counter
    from repro_torch.dist.sharding import (axis_rules, default_rules,
                                           distribute, distribute_params,
                                           placements_of)
    from repro_torch.models.common import init_param, torch_dtype
    from repro_torch.models.moe import moe_apply, moe_specs
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, sharding_mode="ep_a2a"))
    cd = torch_dtype(cfg.compute_dtype)
    specs = moe_specs(cfg, cfg.compute_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = {k: init_param(s, gen, torch.device(device)).to(cd)
            for k, s in sorted(specs.items())}
    x = torch.randn((batch, tokens, cfg.d_model), generator=gen,
                    device=device).to(cd)

    def nest(d):
        out = {k: v for k, v in d.items() if "." not in k}
        shared = {k.split(".", 1)[1]: v for k, v in d.items()
                  if k.startswith("shared.")}
        return {**out, "shared": shared} if shared else out

    rules = default_rules(cfg, mesh, "prefill")
    sharded = nest(distribute_params(flat, specs, mesh, rules))
    xd = distribute(x, mesh, placements_of(("act_batch", None, None), rules,
                                           x.shape))

    def a2a():
        with axis_rules(rules):
            return moe_apply(sharded, xd, cfg).full_tensor()

    def grouped():
        return moe_apply(nest(flat), x, cfg)

    with torch.no_grad():
        ref = grouped()
        with _Counter() as counter:
            got = a2a()
        err = float((got.float() - ref.float()).abs().max())
        rms = float(ref.float().square().mean().sqrt())
        times = {name: wall_ms(fn, device)
                 for name, fn in (("a2a_ms", a2a), ("grouped_ms", grouped))}
    return dict(max_abs_err=err, ref_rms=rms, rel_err=err / rms,
                bound=PATH_G_MOE_BOUND, bit_equal=bool(torch.equal(got, ref)),
                coll_bytes=counter.cost.coll_bytes, **times)


def assert_a2a(check: dict) -> None:
    assert check["rel_err"] <= PATH_G_MOE_BOUND, check
    assert check["coll_bytes"] > 0, check


def dryrun_cells(cells, out_dir, smoke: bool = False,
                 timeout: float = DRYRUN_TIMEOUT_S) -> list[dict]:
    """9d: ``python -m repro_torch.launch.dryrun`` a cell a subprocess,
    all started together, records written under ``out_dir``; every
    process is waited for or killed. Returns the records."""
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "CUDA_VISIBLE_DEVICES": ""}
    procs = []
    try:
        for arch, shape, two_pods in cells:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--out", str(out_dir),
                 "--multipod-only" if two_pods else "--single-pod-only"]
                + (["--smoke"] if smoke else []), env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        t_end = time.monotonic() + timeout
        for proc in procs:
            out, err = proc.communicate(
                timeout=max(1.0, t_end - time.monotonic()))
            assert proc.returncode == 0, (proc.args, err[-3000:])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tags = {True: "2x16x16", False: "16x16"}
    return [json.loads((pathlib.Path(out_dir) / (
        f"{arch}_{shape}_{'2x4smoke' if smoke else tags[two_pods]}.json"))
        .read_text()) for arch, shape, two_pods in cells]


def assert_dryrun(records: list[dict]) -> None:
    keys = ("flops_per_device", "bytes_accessed_per_device", "coll_bytes",
            "argument_bytes")
    for rec in records:
        assert all(math.isfinite(rec[k]) and rec[k] > 0 for k in keys), rec


def phase9(smi: str) -> dict:
    """Path G: the sharded steps on a one-rank NCCL mesh (9a-9c) and the
    production dry run (9d). Returns 9a's sharded-leg launch counts."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    t_phase = time.perf_counter()
    init_group("nccl", "cuda:0")
    try:
        mesh = make_host_mesh()
        assert tuple(mesh.shape) == (1, 1), mesh
        cfg = get_config(PATH_G["arch"])
        check = sharded_serving(cfg, mesh, "cuda", PATH_G["batch"],
                                PATH_G["prompt"], PATH_G["steps"])
        log(f"phase9a {cfg.name} at full width and depth ({cfg.num_layers} "
            f"layers, {cfg.compute_dtype}), B {PATH_G['batch']} x "
            f"{PATH_G['prompt']} prefill + {PATH_G['steps']} decode steps, "
            f"sharded on a {tuple(mesh.shape)} NCCL mesh vs meshless on the "
            f"same weights, on {smi}: {json.dumps(check)}")
        assert_sharded_serving(check)
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            train = sharded_training(cfg, make_host_mesh, "cuda", tmp,
                                     **PATH_G_TRAIN)
        log(f"phase9b {cfg.name} cut to {PATH_G_TRAIN['layers']} full-width "
            f"layers, fp32, B {PATH_G_TRAIN['batch']} x {PATH_G_TRAIN['seq']}"
            f", sharded trainer vs meshless (bound {PATH_G_TRAIN_RTOL} "
            f"relative), then reshard_for_mesh(make_host_mesh()): "
            f"{json.dumps(train)}")
        assert_sharded_training(train)
        gc.collect()
        torch.cuda.empty_cache()
        moe_cfg = get_config(PATH_G_MOE["arch"])
        moe = a2a_vs_grouped(moe_cfg, mesh, "cuda", PATH_G_MOE["batch"],
                             PATH_G_MOE["tokens"])
        log(f"phase9c one {moe_cfg.name} MoE layer at full width (E "
            f"{moe_cfg.moe.num_experts}, top {moe_cfg.moe.top_k}, d_model "
            f"{moe_cfg.d_model}, {moe_cfg.compute_dtype}), B "
            f"{PATH_G_MOE['batch']} x {PATH_G_MOE['tokens']} tokens, ep_a2a "
            f"(NCCL all-to-all) vs the grouped layer, on {smi}: "
            f"{json.dumps(moe)}")
        assert_a2a(moe)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            records = dryrun_cells(PATH_G_DRYRUN, tmp)
        memory = torch.cuda.get_device_properties(0).total_memory
        for rec in records:
            log(f"phase9d dry run {rec['arch']} x {rec['shape']} on "
                f"{rec['mesh']} ({rec['chips']} ranks, meta device, counted "
                f"not timed): " + json.dumps(dict(
                    {k: rec[k] for k in (
                        "flops_per_device", "bytes_accessed_per_device",
                        "coll_bytes", "argument_bytes", "output_bytes",
                        "lower_s", "counted")},
                    argument_share_of_card=rec["argument_bytes"] / memory)))
        log(f"phase9d {len(records)} cells in "
            f"{time.perf_counter() - t0:.1f} s (card memory {memory} B)")
        assert_dryrun(records)
    finally:
        dist.destroy_process_group()
    log(f"phase9 wall {time.perf_counter() - t_phase:.1f} s")
    return check["launches"]


# ------------------------------------------------------------------ main
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    sheet = card_datasheet(kind)
    log(f"phase0 device {kind} x{torch.cuda.device_count()}, torch "
        f"{torch.__version__}, cuda {torch.version.cuda}; allow_tf32 "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}; datasheet {sheet}")

    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"phase1 built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(paths):
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "error", "C75")):
                log(f"phase1 {name}: {line.strip()}")
    check_hgmma(paths["flash_attention"])

    hw = hardware_profile(kind)
    records = phase2(sheet, hw)
    counts, qwen, samples = phase3(hw)
    counts.update(rwkv6_scan=phase4(smi)["rwkv6_scan"])
    path_c = phase5(qwen, hw)
    del qwen                  # phase 6 needs the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    path_d = phase6(hw)
    gc.collect()
    torch.cuda.empty_cache()
    path_e = phase7(smi)
    gc.collect()
    torch.cuda.empty_cache()
    path_f = phase8(hw, smi, sheet, samples)
    gc.collect()
    torch.cuda.empty_cache()
    path_g = phase9(smi)

    sources = {
        "paged_decode_attention": (
            "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:116"),
        "page_gather": ("src/repro_torch/csrc/page_copy.cu",
                        "src/repro/kernels/page_copy/kernel.py:45"),
        "page_scatter": ("src/repro_torch/csrc/page_copy.cu",
                         "src/repro/kernels/page_copy/kernel.py:70"),
        "token_append": ("src/repro_torch/csrc/page_copy.cu",
                         "src/repro/kernels/page_copy/kernel.py:114"),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:85"),
        "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                       "src/repro/kernels/rwkv6_scan/kernel.py:75"),
    }
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=counts[name],
                    launches_phase5={leg: c[name]
                                     for leg, c in path_c.items()},
                    launches_phase6=path_d[name],
                    launches_phase7={leg: c[name]
                                     for leg, c in path_e.items()},
                    launches_phase8=path_f[name],
                    launches_phase9=path_g[name],
                    **records[name])
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
