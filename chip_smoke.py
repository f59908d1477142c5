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
         the device-indexed token append (its slots int32 tensors on the
         card, the captured decode step's) bit-exact against the plain
         version at the phase-2 shape and at 300 rows (one launch), timed
         beside the by-value launch, slots of the wrong dtype, shape,
         layout or device refused;
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
         logged for each carry-pass slice width at B=1 and B=2. The decode
         step's four fusions (``kernels/fusions``: the RMS norms, qkv bias
         + RoPE, the gated activation, and the new token's merge in decode
         attention's combine) against their plain versions at every paged
         family's published width, rows 1, 4 and 64, bf16 and fp32: RoPE
         and the activation bit-equal (the activation over every finite
         bf16 gate), the norm within one ulp, the merge within one bf16 ulp
         or 2e-5 in fp32; each timed at the serve step (qwen2-1.5b, B=4)
         beside ``F.rms_norm`` and ``F.silu(a) * b``; the norm also at
         512 rows, each row bit-equal across 1, 4, 64 and 512-row calls in
         its three modes, and timed beside an empty kernel's launch (the
         floor a graph node costs). The decode step's qkv launch
         (``qkv_proj``: the three products with bias, qk norm and RoPE)
         at every paged family whose heads its plan takes, 16 rows, bf16,
         within ``ref.qkv_proj_bound`` of its plain version, rows bit-equal
         across 1-16-row calls, its share of outputs off cuBLAS's route
         logged, timed beside that route and one matmul of the
         concatenated weights. The flash kernels' extend launch
         (``flash_extend``) against its plain version at path A's extend
         chunk (512 queries on 2048 cached tokens, 2560 slots; timed
         beside SDPA given the same boolean mask, and at each slice count
         1-4 its plan can take) and at FLASH_EXTEND_EDGES (offset 0 and
         1000, B 2 with other offsets, gemma2-9b's heads with window and
         softcap on a plain cache, qwen3-moe's heads, D 80, an odd
         group), bf16 and fp32, every dead slot NaN: finite, within row
         5's tolerances, the same bits through either layout; one graph
         replayed at offsets 2048, 0 and 1037 bit-equal to eager
         launches; bad offsets and inputs TMA cannot take refused.
         Decode attention's dense launch (path E's one-token step over
         ``Model.forward``'s cache; in bf16 its own kernel,
         ``csrc/dense_decode.cu``, a row's splits one cluster) against
         its plain version at
         gemma2-9b's global layer (4672 slots) and local ring (4096,
         wrapped), softcap 50, and zamba2-2.7b's shared block (B 2, Dh
         80), and at edges (a ring not yet full, rows at other offsets
         and at the last slot, a row stride past the slots, Dh 32, q x
         20 so the softcap bends the scores), bf16 and fp32, every dead
         slot NaN: finite, each element within ``dense_tolerance`` of
         the plain version in float64 (a bound from the launch's own
         roundings), rows alone bit-equal to the batched call (and a
         row alone bit-equal to the same row in a B = 3 batch at path
         E's shapes), dead slots never entering the result; the plan
         of path E's shapes logged; timed over 4 caches in turn beside the
         bound and, at zamba2's shape (no softcap), SDPA; one graph
         replayed at 64 offset sets bit-equal to eager calls; what it
         does not take refused before any launch. zamba2-2.7b's Mamba2
         kernels (``csrc/mamba2.cu``) at its full widths (H 80, P 64, N
         64, G 1, d_conv 4, C 5248): the decode step at B 2 from random
         conv and fp32 states, its new states bit-equal to the plain
         version's and a row alone bit-equal to the same row of a B = 3
         batch; the prompt's SSD over 2000 tokens (not a whole number of
         chunks) and a 37-token extend, each from a nonzero state, its
         state overwritten in place, rows alone and in a batch
         bit-equal; edges at smoke widths (two and three B/C groups, P
         40, N 32, d_conv 3, chunk 24); bf16 and fp32, each output
         element within ``mamba2_tolerance`` of the plain version (from
         the magnitudes of its summed terms) and four planted faults
         (no D skip, no decay, no carried state) failing the checks;
         each timed eager and by graph replay beside the plain chain it
         replaces and its bound.
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
         The decode steps are CUDA graphs, one per (B, table width)
         bucket, captured on first use and replayed, and so are the
         prefill chunks, one per (mode, padded length, capacity) bucket,
         captured at second use (each family's captures, their seconds
         and the graph pool's bytes are logged). Launch counts are
         zeroed before 3a and read after 3b (the kernels line's): every
         kernel of the path (decode attention, the page moves, the
         indexed token append, flash attention in each fresh prefill, its
         extend launch in each extend chunk, the fusions) must have run,
         flash attention in 3a and in 3b, and the by-value
         append, which no runtime path calls, never. Then 3b three times
         more, eager (``cuda_graphs=False``), graphed, and graphed with
         the decode step's chains plain (``fused=False``), for JCT, busy
         seconds and each family's capture seconds paired in one call,
         each with its launches (the extend launch in the fused legs
         alone).
         (c) On the same weights, programs of 2040, 1000 and 500 tokens
         and a twin of the second on its pages: 20 decode steps eager
         (``cuda_graphs=False``), the runtime's state restored, the same
         steps graphed; logits, next tokens and both pools must be equal
         (``torch.equal``) across four buckets, a page boundary (offset
         15 -> 0) where a table widens from 128 to 256 pages, and a COW
         split; each bucket captured once, no replay growing the graph
         pool, both legs appending through the indexed launch once a
         step; wall ms of an eager and a replayed step and each leg's
         launches logged.
         (d) The prefill chunk likewise (``PREFILL_OPS``): a fresh
         2040-token prompt in 512-token chunks, three 2048-token prompts
         and a 512-token extend each, a twin of the first, and extends at
         Sp 16, 64 and 256 from a mid-page start, across page boundaries
         and through a COW split; eager (on the buckets' buffers, under
         torch's sync debug mode "error") and graphed from the same empty
         runtime; logits, next tokens and both pools equal
         (``torch.equal``), every bucket used twice captured once, no
         replay growing the graph pool, flash and its extend launch
         launched as often in both legs; wall ms of eager and replayed chunks a bucket, each leg's
         launches, and the ms of a capture through ``capture_begin``
         against ``torch.cuda.graph`` (3c's decode bucket too) with the
         pinned blocks a stage-out allocates after each.
         Then the prefill logits through
         the flash kernel against prefill + extend (dense attention) of
         the same 1024-token prompt, in bf16 and fp32, on the first 2
         layers at full width, and a logged depth sweep. 3c runs twice,
         with the decode step's fusions and with ``fused=False`` (the
         plain spelling on the card). Last, the fused decode step against
         ``fused=False`` from the same pools at the 2-layer cut, bf16 and
         fp32: argmax equal, |logit gap| within 0.25 / 1e-3 of the rms,
         every fusion launched by the fused leg alone, and one traced
         eager step of each leg whose kernel list shows the fused leg
         running none of the plain chains' kernels; a bf16 depth sweep of
         the gap logged. Then the extend chunk (CHUNK_EXTENDS: 512, 100,
         88 and 1 tokens, each alone from one prefilled state) fused,
         fused with its attention plain, and with ``fused=False``, at the
         2-layer cut in bf16 and fp32: in fp32 argmax equal and the chunk
         within 1e-3 of the rms, in both its fusions alone within the
         decode step's bounds (bf16: the chunk's gap logged, as the plain
         attention rounds its scores to bf16); at full depth one traced
         eager extend chunk of each leg: 28 extend launches and none of
         the plain attention's exp / row-max kernels in the fused leg,
         its wheres only the scratch gather's two.
Phase 4  path B: full-width rwkv6-3b (32 layers, seeded random weights)
         through ``Model.forward``: B=2, a 2048-token prompt in bf16, with
         the counts zeroed before and read after (two WKV-scan launches,
         chunk and carry pass, per layer and prefill); then the decode
         pair: a timed prefill and, from its cache (cloned), 2 + 32 + 3
         decode steps through ``build_decode_step``'s step as a replayed
         CUDA graph (its first step eager, captured at the second; the 32
         timed replays under torch's sync debug mode "error") and as the
         eager step (``cuda_graphs=False``, offsets host ints): every
         step's logits and the final caches bit-equal (``torch.equal``),
         one capture, a replay at most 10 host launch calls; each leg's
         wall ms and tokens/s over the 32 timed steps, and device ms,
         busy share, device ops and host launch calls a step over 3
         traced ones (torch.profiler), the capture's s and the graph
         pool's bytes logged; then,
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
         steps dropping none (the drops summed in place, so replays add
         to them); logs steps, the physical leg's wall time and ms a
         step, the dropped copies and the peak memory; then the graphed
         decode step against the eager one over 6 steps and two buckets,
         as in 3c, and the graphed prefill chunk against the eager one
         over ``MOE_PREFILL_OPS`` (15 chunks, four buckets captured), as
         in 3d. (b) qwen3-moe, moonshot-v1-
         16b-a3b (its leading dense layer and two MoE layers, shared
         experts), pixtral-12b, musicgen-large, stablelm-3b and glm4-9b
         (each paged family also fused against ``fused=False`` as in
         phase 3, in fp32) at full width and cut
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
         decode steps. Each is timed after an untimed warm-up run (a
         prefill and two decode steps) as phase 4's decode pair (a graph
         leg and an eager leg from one prefill, bit-equal), and logs
         prefill s and tokens/s, each leg's decode ms a step, tokens/s,
         device ms, device ops and host launch calls, the capture's s,
         the graph pool's bytes, flash launches (counts zeroed before,
         read after: 42 and 9 a prefill, asserted), weight GB and peak
         memory. The steps are ``build_prefill_step`` /
         ``build_decode_step`` with their default ``fused`` on: each
         decode step runs decode attention's dense launch once a
         sublayer (42 / 9) and the plain dense arithmetic never, the
         decode qkv pass (gemma2: the qkv launch; zamba2: the row pass
         after cuBLAS's products) and the gate/up launch once a
         sublayer (asserted), zamba2's ``mamba2_step`` once a Mamba2
         layer and step and ``ssd_chunk`` once a layer in the prefill,
         the plain Mamba2 arithmetic never; then the same pair with
         ``fused=False``
         (8 timed steps), the two logged side by side (wall ms, device
         ms by part, kernels a step). Then the fused steps against
         ``fused=False`` (a prefill and 6 eager steps, the fused leg fed
         the plain leg's tokens): at the seeded init logged (P5); at
         the published init (N(0, 0.02), drawn in bf16) at 2, 4 and 42
         layers (zamba2: 6, 12 and 54) held to ``path_e_bound`` (P13 /
         P14's count: the norms, the scores the plain arithmetic rounds,
         bounded by the softcap, the gate/up and qkv launches' shares,
         zamba2's Mamba2 layers' norms and their kernels' share), an
         argmax flip only within twice it.
         (b, d) each at full width cut to 2 and 4 (gemma2: 1 and 2 pairs)
         and 6 and 12 layers (zamba2: 1 and 2 groups) in fp32: the
         prompt's prefill against prefill of all but 64 tokens and 64
         decode steps (across gemma2's ring), and the prefill through the
         flash kernel against the plain version, zamba2's fused (both
         Mamba2 kernels launched in fp32); each gap within 1e-3 of the
         logits' rms, argmax equal.

Phase 8  path F, training and the roofline cost source, after phase 7 is
         freed: (a) full-width, full-depth qwen2-1.5b (28 layers, ~1.54 B
         params, drawn with its published initializer, N(0, 0.02))
         trained by ``Trainer`` on ``TokenStream`` batches: fp32
         masters and moments, bf16 compute, remat "full", two
         microbatches; train_4k's 4096-token rows with its global batch
         cut from 256 to 2. The graph leg: the step a CUDA graph
         (``train/train_graph.py``), its eager warm-up, the step that
         captures, 6 timed replays and one traced; then an eager leg
         from the same init on the same schedule: a warm-up, 3 timed
         steps and one traced. Each step logs loss, grad norm, step,
         wall and enqueue ms, tokens/s and the model-FLOPs share 6 N
         tokens / (step s x the bf16 peak); each leg its device ms,
         device ops and host launch calls a step (torch.profiler),
         capture s, graph pool bytes and peak memory; then the launch
         counts (zeroed before: every kernel 0, the training forward
         runs the reference's plain arithmetic). Every loss of the graph
         leg finite, the last three's mean below the first; a replay
         under 10 host launch calls and as many device ops as the eager
         step. (b) The same config cut to 2 layers at full width: two
         eager legs and a graph leg of 3 steps from one init, bit for
         bit equal (losses, grad norms, lr, masters, moments, count);
         then in fp32, B 1 x 128 tokens, 2 steps on the card and on the
         CPU from one set of seeded params: losses and grad norms within
         1e-4 relative; a run saved at step 1 and resumed into a fresh
         trainer equals the uninterrupted step 2 within 1e-4, graphs
         on. (c) ``CostModel.from_roofline`` at full width (the port's
         steps counted on the meta device) beside
         ``build_profile``, within 2x, both pricing phase 3a's measured
         prefill-only and decode-only steps; then ``Engine(cost_source=
         "roofline")`` on 12 SWE-Bench programs under the virtual clock
         must pin.

Phase 9  path G, the sharded steps, after phase 8: a one-rank NCCL
         process group (a free local port) and ``make_host_mesh()``, a
         (1, 1) ("data", "model") DeviceMesh. (a) Full-width, full-depth
         qwen2-1.5b in bf16: the sharded prefill step (B 1 x 2048, every
         weight and cache a DTensor, the flash kernel launched on each
         rank's local pieces) and 16 sharded decode steps, eager and as
         the step's CUDA graph (the two from one sharded prefill), beside
         the meshless prefill and decode graph on the same weights:
         every step's next tokens, logits and the final caches bit-equal
         across the three legs, flash launches > 0, the graph captured
         and replayed on >= 14 steps with <= 6 host launch calls a
         replay; the wall ms a step of each leg (a warm-up run first),
         and one more step of each traced (device ms, device ops, host
         launch calls, NCCL kernels: none on one rank). (b) The same
         config cut to 2 layers, fp32, from its published init: step 1
         of a sharded Trainer against a meshless one (loss and grad norm
         within 1e-6 relative), then ``reshard_for_mesh(make_host_mesh())`` and 2
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
         finite and positive. (e) Path G's training step as each rank's
         CUDA graph (``Trainer(cfg, mesh)``'s ``TrainGraph``) against the
         eager sharded step (``cuda_graphs=False``): (i) full-width,
         full-depth qwen2-1.5b from its published init, bf16 compute
         over fp32 masters, remat, 2 microbatches, B 2 x 2048; the eager
         leg's warm-up, 2 steps and 1 traced, the graph leg's warm-up,
         capture, replays to step 4 and 1 traced: every loss and grad
         norm both legs ran bit-equal, <= 8 host launch calls a replay,
         the replay's device ms within 5% of the eager step's; each
         leg's wall, enqueue and device ms, busy share, device ops, NCCL
         kernels (none on one rank), tokens/s, model-FLOPs share,
         capture s, pool bytes, peak and reserved memory logged; (ii)
         the 2-layer cut of (b), fp32, B 1 x 128, 4 steps a leg: every
         loss, grad norm, master, moment and the count bit-equal, and
         the graph leg's step 1 within 1e-6 of the meshless graph
         trainer's. No kernel launches in (e). The process group is torn
         down at the end.

Prints a ``{"kernels": [...]}`` line (``launches``: phases 3a and 3b,
and 4, and for the dense decode launch and the two Mamba2 kernels phase
7; the by-value token
append has no runtime caller and reads 0;
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
import zlib

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
# The flash kernels' extend launch (row 5b): path A's extend chunk, 512
# queries on 2048 cached tokens in a 2560-slot scratch (profile_step's
# chunk; timed), then its edges, each in bf16 and fp32 with every slot
# past a row's offset + C NaN: offset 0 and 1000 (not a multiple of a
# tile), a cache that ends at the chunk, B 2 with other offsets, a
# gemma2-9b layer's heads on a plain cache (D 256, window 4096, softcap
# 50), phase 6a's qwen3-moe heads, stablelm-like D 80 at offsets 3 and
# 600 with a ragged chunk, and an odd group (G 3: a CTA takes one head's
# 128 rows) at D 64. Path A's chunk is also run with every slice count
# the bf16 launch takes (EXTEND_SLICES, timed) and replayed from one
# captured graph at EXTEND_GRAPH_OFFSETS.
FLASH_EXTEND = dict(B=1, H=12, KV=2, C=512, T=2560, D=128, offs=(2048,),
                    window=0, softcap=0.0)
FLASH_EXTEND_EDGES = (
    dict(FLASH_EXTEND, offs=(0,)),
    dict(FLASH_EXTEND, T=1512, offs=(1000,)),
    dict(FLASH_EXTEND, B=2, C=300, offs=(1000, 37)),
    dict(B=1, H=16, KV=8, C=200, T=4672, D=256, offs=(4400,), window=4096,
         softcap=50.0),
    dict(B=1, H=64, KV=4, C=512, T=1536, D=128, offs=(1000,), window=0,
         softcap=0.0),
    dict(B=2, H=8, KV=2, C=77, T=700, D=80, offs=(3, 600), window=0,
         softcap=0.0),
    dict(B=1, H=6, KV=2, C=200, T=1100, D=64, offs=(850,), window=0,
         softcap=0.0))
EXTEND_SLICES = (1, 2, 3, 4)
EXTEND_GRAPH_OFFSETS = (2048, 0, 1037)
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
# Path A's kernels (the serving path, its decode step a replayed CUDA
# graph, whose token append is the device-indexed one and whose bf16 qkv
# pass of at most 16 rows is the qkv launch; the row pass alone, qkv_rope,
# serves an fp32 step or more rows) and path B's run (rwkv6-3b). The by-value append has no caller in the runtime: the decode
# step appends through the indexed launch, graphed or eager
# (``cuda_graphs=False``); phase 2 holds it against its plain version.
PATH_A = ("paged_decode_attention", "page_gather", "page_scatter",
          "token_append_indexed", "flash_attention", "flash_extend",
          "rms_norm", "qkv_proj", "qkv_rope_chunk")
# A dense FFN's kernels (a MoE FFN keeps its own ops): on path A's
# qwen2-1.5b, not in phase 6a's qwen3-moe. The gated activation runs in
# the chunk (and in an fp32 or wider decode step), the gate/up product
# with its activation in the bf16 decode step.
CHUNK_FFN, DECODE_FFN = "gated_act", "gate_up_act"
DENSE_FFN = (CHUNK_FFN, DECODE_FFN)
BY_VALUE_APPEND = "token_append"
# Phase 3c: the graphed decode step against the eager one at full width.
# Prompts of p0..p2; p3 is p1's twin on shared pages, so p1's first
# append COW-splits its last page mid-batch. Steps run as (count, rows):
# p0 (2040 tokens) appends at offset 15 in step 7 and at offset 0 of a
# new page in step 8, its table widening from 128 to 256 pages there.
GRAPH_PROMPTS = (2040, 1000, 500)
GRAPH_SCHEDULE = ((6, (0, 1, 2)), (6, (0, 1, 2, 3)), (8, (2, 0, 3)))
# the plain chains' leg (fused=False) stops after the COW split and the
# page boundary: two buckets
GRAPH_SCHEDULE_PLAIN = GRAPH_SCHEDULE[:2]
# Phase 6a's check at qwen3-moe width: a capture and replays, and a
# second bucket.
MOE_GRAPH_PROMPTS = (300, 200, 100)
MOE_GRAPH_SCHEDULE = ((3, (0, 1, 2)), (3, (0, 1, 2, 3)))
# Phase 3d: the graphed prefill chunk against the eager one at full width,
# from the same empty runtime. Ops: (program, tokens, pad_to), or ("twin",
# new, of). q0 is a fresh 2040-token prompt in 512-token chunks (the last
# 504 padded); q1-q3 take 2048-token prompts and a 512-token extend in
# turns (each bucket used 3-4 times: eager, captured, replayed; the extend
# is profile_step's 512-on-2048 shape); q4 is q0's twin on its pages; then
# q0 and q4 extend in turns at Sp 16, 64 and 256, three chunks a bucket:
# q0's first, at its mid-page start 2040, COW-splits their shared last
# page; S = 1 and S = Sp are among them, and chunks start on and cross
# page boundaries. Every extend bucket's capacity is 2560 (unpadded).
PREFILL_OPS = tuple(
    [("q0", 512, 512)] * 3 + [("q0", 504, 512)]
    + [(f"q{i}", 512, 512) for _ in range(5) for i in (1, 2, 3)]
    + [("twin", "q4", "q0")]
    + [(pid, n, pad) for pid, (n, pad) in zip(("q0", "q4") * 5, (
        (1, 16), (16, 16), (7, 16), (50, 64), (33, 64), (64, 64),
        (200, 256), (129, 256), (256, 256)))])
# Phase 6a's: q0 300 tokens in 128-token chunks, q1 and q2 256 tokens and a
# 128-token extend in turns, q3 q0's twin, then extends at Sp 16 and 32.
MOE_PREFILL_OPS = tuple(
    [("q0", 128, 128)] * 2 + [("q0", 44, 64)]
    + [(f"q{i}", 128, 128) for _ in range(3) for i in (1, 2)]
    + [("twin", "q3", "q0")]
    + [(pid, n, pad) for pid, (n, pad) in zip(("q0", "q3") * 3, (
        (1, 16), (16, 16), (7, 16), (20, 32), (32, 32), (9, 32)))])
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
    ``flash_wgmma_kernel`` (prefill) and ``flash_extend_kernel`` instance
    of the built library holds HGMMA instructions (checked where the
    toolkit has ``cuobjdump``)."""
    tool = cuobjdump()
    if tool is None:
        log("phase1 flash_attention HGMMA count: not checked (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts = count_sass(sass)
    for fn, n in sorted(counts.items()):
        log(f"phase1 flash_attention {fn}: {n} HGMMA")
    for kind in ("flash_wgmma_kernel", "flash_extend_kernel"):
        wgmma = {fn: n for fn, n in counts.items() if kind in fn}
        assert wgmma and all(n > 0 for n in wgmma.values()), (kind, counts)


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
    plain version and the bound; and the decode step's call, the new
    token (the layer's token rows) merged in the launch, by graph replay
    (``merged_device_ms``)."""
    import itertools
    from repro_torch.kernels.decode_attention import (
        paged_decode_attention_kernel, paged_decode_attention_ref)
    args = decode_args(case)
    L = case["k"].shape[0]
    layers = itertools.cycle(range(L))

    def kern():
        return paged_decode_attention_kernel(*args, layer=next(layers),
                                             return_residuals=True)

    def merged():
        li = next(layers)
        return paged_decode_attention_kernel(
            *args, layer=li, new_kv=(case["k_tok"][li], case["v_tok"][li]))

    bms, by = decode_bound(case, sheet)
    return dict(
        ms=time_ms(kern, iters=L),
        plain_ms=time_ms(lambda: paged_decode_attention_ref(
            *args, layer=next(layers), return_residuals=True), iters=3,
            warmup=1),
        bound_ms=bms, bound_by=by, library_ms=None,
        device_ms=graph_ms(kern, iters=L),
        merged_device_ms=graph_ms(merged, iters=L))


#: the counters' check: graph replays of the serve step's merged call
COUNTER_REPLAYS = 1000


def check_decode_counters(gen, replays: int = COUNTER_REPLAYS) -> dict:
    """Decode attention's ticket counters after ``replays`` replays of
    one captured merged call (SERVE_DECODE's pools) whose lengths change
    every replay (0 to 2048 tokens a row, a zero-length row every 7th, a
    live id outside the pool every 11th): every counter of every arena
    reads 0, and every 97th replay's output equals an eager call's bit
    for bit. Returns the replays and the counters read."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import \
        paged_decode_attention_kernel as kernel
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    case = make_case(SERVE_DECODE, torch.bfloat16, gen, "cuda")
    q, k, v, tables, lens = decode_args(case)
    new_kv = (case["k_tok"][0], case["v_tok"][0])
    lens_in, tables_in = lens.clone(), tables.clone()
    out = {}

    def call():
        out["o"] = kernel(q, k, v, tables_in, lens_in, layer=0,
                          new_kv=new_kv)

    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    rng = np.random.default_rng(1)
    page, P = k.shape[2], k.shape[1]
    compared = 0
    for i in range(replays):
        n = rng.integers(0, SERVE_DECODE["lens"][0] + 1,
                         size=len(SERVE_DECODE["lens"])).astype(np.int32)
        if i % 7 == 0:
            n[rng.integers(0, len(n))] = 0
        bad = tables.clone()
        if i % 11 == 0 and n.max() > 0:
            b = int(np.argmax(n))
            bad[b, (n[b] - 1) // page] = P
        lens_in.copy_(torch.from_numpy(n))
        tables_in.copy_(bad)
        graph.replay()
        if i % 97 == 0:
            eager = kernel(q, k, v, bad, lens_in, layer=0, new_kv=new_kv)
            assert same_bits(eager, out["o"]), f"replay {i}"
            compared += 1
    torch.cuda.synchronize()
    counters = sum(a.numel() for a in decode_kernel._KEPT)
    assert all(int(a.abs().sum()) == 0 for a in decode_kernel._KEPT), \
        "a ticket counter was left non-zero"
    del graph
    return dict(replays=replays, compared_with_eager=compared,
                counters=counters)


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


#: decode attention's dense launch (path E's one-token attention over
#: ``Model.forward``'s cache, PERF.md §6 row 1b) at path E's shapes: a
#: gemma2-9b global layer (a plain cache of 4672 slots) and local layer
#: (a 4096-slot ring, wrapped) with the softcap 50, B 1, KV 8, G 2, Dh
#: 256, and a zamba2-2.7b shared block (B 2, KV 32, G 1, Dh 80, 2048
#: slots), each row at its position of phase 7's decode (``offs``: the
#: new token's, written). The first is the kernels line's record.
DENSE_DECODE = (
    dict(name="gemma2-9b global", B=1, T=4672, KV=8, G=2, D=256, window=0,
         softcap=50.0, offs=(4631,)),
    dict(name="gemma2-9b local ring", B=1, T=4096, KV=8, G=2, D=256,
         window=4096, softcap=50.0, offs=(4631,)),
    dict(name="zamba2-2.7b shared", B=2, T=2048, KV=32, G=1, D=80,
         window=0, softcap=0.0, offs=(2031, 2031)))
#: the dense kernel at the other head geometries it instantiates: G 16 at
#: Dh 128 (two n tiles of query heads; qwen3-moe-235b's and glm4-9b's
#: heads) with two KV heads a CTA and with one, Dh 64 with two KV heads a
#: CTA and the softcap, Dh 16 with four over a wrapped ring
DENSE_HEAD_EDGES = (
    dict(name="G 16 at Dh 128, two KV heads a CTA", B=2, T=1536, KV=4,
         G=16, D=128, window=0, softcap=0.0, offs=(1535, 600)),
    dict(name="G 16 at Dh 128, one KV head a CTA", B=2, T=4000, KV=1,
         G=16, D=128, window=0, softcap=0.0, offs=(3999, 31)),
    dict(name="Dh 64, two KV heads a CTA", B=3, T=3000, KV=2, G=6, D=64,
         window=0, softcap=30.0, offs=(2999, 100, 1777)),
    dict(name="Dh 16, four KV heads a CTA", B=2, T=5000, KV=4, G=3, D=16,
         window=5000, softcap=0.0, offs=(7000, 9)))
#: edges: a ring not yet full and the first token, rows at other offsets
#: (one at the last slot), a cache read through a row stride past its
#: slots (``pad``), the CUDA-core split at gemma2's smoke head dim 32,
#: DENSE_HEAD_EDGES, the softcap bending the scores
DENSE_EDGES = (
    dict(name="ring not full", B=2, T=4096, KV=8, G=2, D=256, window=4096,
         softcap=50.0, offs=(100, 0)),
    dict(name="plain, mixed offsets", B=3, T=4672, KV=8, G=2, D=256,
         window=0, softcap=50.0, offs=(4671, 1, 2999), pad=8),
    dict(name="zamba2 rows apart", B=2, T=2048, KV=32, G=1, D=80, window=0,
         softcap=0.0, offs=(2047, 640), pad=16),
    dict(name="smoke head dim", B=2, T=32, KV=2, G=2, D=32, window=32,
         softcap=50.0, offs=(40, 7)),
    *DENSE_HEAD_EDGES,
    # q x 20: scaled scores N(0, 20^2), most past +-30 and the largest
    # ~75, which the softcap bends to ~45: without it one token would
    # take the row
    dict(name="gemma2-9b global at the cap", B=1, T=4672, KV=8, G=2,
         D=256, window=0, softcap=50.0, offs=(4631,), qscale=20.0))
#: caches a timed call rotates over (cold in the 50 MB L2, as a step's
#: layers find theirs)
DENSE_SETS = 4


def dense_case(shape: dict, dtype, gen, device, sets: int = 1) -> dict:
    """q (B, H, D) N(0, qscale^2) (``shape``'s, else 1), ``sets`` caches
    (sets, B, T + pad, KV, D) N(0, 1) read as (B, T, KV, D) views, every
    slot past a row's live length NaN (the launch never reads one), and
    the int32 offsets."""
    import torch
    B, T, KV, D = (shape[k] for k in ("B", "T", "KV", "D"))
    T_all = T + shape.get("pad", 0)
    offs = torch.tensor(shape["offs"], dtype=torch.int32, device=device)
    caches = [torch.randn((sets, B, T_all, KV, D), generator=gen,
                          device=device).to(dtype) for _ in range(2)]
    live = (offs.long() + 1).clamp(max=T)
    dead = torch.arange(T_all, device=device)[None, :] >= live[:, None]
    for c in caches:
        c[:, dead] = float("nan")
    q = torch.randn((B, KV * shape["G"], D), generator=gen, device=device)
    return dict(q=(q * shape.get("qscale", 1.0)).to(dtype),
                k=caches[0][:, :, :T], v=caches[1][:, :, :T], offs=offs,
                live=live)


def dense_call(shape: dict, launch=None):
    """``launch(q, k, v, offsets)`` at ``shape``'s scale, window and
    softcap: the dense launch, or ``launch`` (a stand-in on the CPU)."""
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention_kernel)
    fn = launch or dense_decode_attention_kernel
    scale = 1.0 / math.sqrt(shape["D"])
    return lambda q, k, v, offs: fn(q, k, v, offs, scale=scale,
                                    softcap=shape["softcap"],
                                    window=shape["window"])


#: the dense launch's rounding budget against the exact arithmetic (unit
#: roundoffs): a sum two fp32 ulps a term (the tensor cores' sums
#: truncate), the hi + lo split of P (bf16's 2^-8 twice), an output's
#: rounding in its dtype
SUM_ULP = 2.0 ** -23
P_SPLIT = 2.0 ** -16
OUT_ULP = {"torch.bfloat16": 2.0 ** -8, "torch.float32": 2.0 ** -24}


def dense_exact(case: dict, shape: dict, k, v) -> tuple:
    """The plain version in float64 from the case's own q, K and V (the
    dead slots of ``k`` and ``v`` zeroed): the exact output o with its
    scores unrounded, as the launch keeps them in fp32, and the spread
    sum_t p_t |v_t| / l, the same softmax over |V|."""
    import torch
    from repro_torch.kernels.decode_attention import dense_decode_ref
    kw = dict(scale=1.0 / math.sqrt(shape["D"]), softcap=shape["softcap"],
              window=shape["window"])
    q, k, v = (t.double() for t in (case["q"], k, v))
    return (dense_decode_ref(q, k, v, case["offs"], **kw),
            dense_decode_ref(q, k, v.abs(), case["offs"], **kw))


def dense_tolerance(case: dict, shape: dict, dtype, k, exact, spread):
    """|launch - exact| allowed at each (row, head, d), from the launch's
    own roundings: a weight p_t moves by a factor within e^(+-eta), so the
    output by at most (e^(2 eta) - 1) spread, eta = S (D + 2) SUM_ULP (S
    = scale A, A the row and head's largest sum_d |q_d k_td|: the dot
    product's sum, the scale, the max's subtraction) + 2 cap SUM_ULP (the
    softcap's divide,
    tanh and multiply) + 2^-19 (exp, the rescales, the splits' merge);
    P's hi + lo split (bf16: P_SPLIT) and the two sums over the row's n
    live tokens, P V and l (2 n SUM_ULP), of the spread; the output's
    rounding, OUT_ULP of |o|."""
    import torch
    B, KV, G, D = case["q"].shape[0], shape["KV"], shape["G"], shape["D"]
    qa = case["q"].double().abs().reshape(B, KV, G, D)
    S = torch.einsum("bkgd,btkd->bkgt", qa, k.double().abs()).amax(-1) \
        / math.sqrt(D)
    eta = S * (D + 2) * SUM_ULP + 2 * shape["softcap"] * SUM_ULP \
        + 2.0 ** -19
    n = case["live"].double()[:, None, None]
    c = torch.expm1(2 * eta) + 2 * n * SUM_ULP + \
        (P_SPLIT if dtype == torch.bfloat16 else 0.0)
    u = OUT_ULP[str(dtype)]
    return u * exact.abs() + (1 + u) * c.reshape(B, KV * G, 1) * spread


def check_dense(shape: dict, dtype, gen, launch=None,
                device: str = "cuda", rows: bool = True) -> dict:
    """The dense launch against its plain version in float64 from the
    same inputs (``dense_exact``), every dead slot NaN: finite, each
    element within its ``dense_tolerance``; each row
    alone gives its row of the batched call bit for bit (``rows``: not
    for a CPU stand-in, whose fp32 products take another path for one
    row, ROADMAP P3); the same call on a copy with the dead slots zeroed
    gives the same bits (nothing past a row is read). Returns the largest
    |gap|, the largest tolerance and the largest gap / tolerance."""
    import torch
    case = dense_case(shape, dtype, gen, device)
    call = dense_call(shape, launch)
    q, k, v, offs = case["q"], case["k"][0], case["v"][0], case["offs"]
    got = call(q, k, v, offs)
    # the plain version reads every slot: its caches' dead slots zeroed
    zeroed = [torch.nan_to_num(c, nan=0.0) for c in (k, v)]
    exact, spread = dense_exact(case, shape, *zeroed)
    assert torch.isfinite(got).all(), (shape["name"], "not finite")
    tol = dense_tolerance(case, shape, dtype, zeroed[0], exact, spread)
    gap = (got.double() - exact).abs()
    ratio = (gap / tol).max().item()
    assert ratio <= 1.0, (shape["name"], dtype, gap.max().item(), ratio)
    for b in range(q.shape[0] if rows else 0):
        row = call(q[b:b + 1], k[b:b + 1], v[b:b + 1], offs[b:b + 1])
        assert same_bits(row[0], got[b]), (shape["name"], f"row {b} alone")
    assert same_bits(call(q, *zeroed, offs), got), (shape["name"],
                                                    "read a dead slot")
    return dict(max_abs_err=gap.max().item(), tolerance=tol.max().item(),
                gap_over_tolerance=ratio)


def dense_bound(shape: dict, esz: int, sheet: dict) -> tuple[float, str]:
    """q and each row's live K and V rows read once, the offsets, the
    output written once; 4 D flops a (query head, live token) and the
    softcap's 3 a score."""
    B, T, KV, G, D = (shape[k] for k in ("B", "T", "KV", "G", "D"))
    live = sum(min(o + 1, T) for o in shape["offs"])
    nbytes = 2 * B * KV * G * D * esz + 2 * live * KV * D * esz + 4 * B
    ops = live * KV * G * (4.0 * D + (3 if shape["softcap"] else 0))
    return bound_ms(nbytes, ops, sheet, "fp32")


def time_dense(shape: dict, gen, sheet: dict) -> dict:
    """The dense launch in bf16 at ``shape``, over DENSE_SETS caches in
    turn (cold in L2): an eager loop (``ms``) and CUDA-graph replay
    (``device_ms``) beside the plain version, the bound and, where the
    scores take no softcap, ``scaled_dot_product_attention`` given the
    rows' length mask (``library_ms``; None under the softcap, which
    SDPA does not apply)."""
    import itertools
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import dense_decode_ref
    case = dense_case(shape, torch.bfloat16, gen, "cuda", sets=DENSE_SETS)
    call = dense_call(shape)
    q, offs = case["q"], case["offs"]
    sets = itertools.cycle(range(DENSE_SETS))

    def kern():
        i = next(sets)
        return call(q, case["k"][i], case["v"][i], offs)

    scale = 1.0 / math.sqrt(shape["D"])
    bms, by = dense_bound(shape, q.element_size(), sheet)
    rec = dict(ms=time_ms(kern, iters=4 * DENSE_SETS),
               plain_ms=time_ms(lambda: dense_decode_ref(
                   q, case["k"][0], case["v"][0], offs, scale=scale,
                   softcap=shape["softcap"], window=shape["window"]),
                   iters=3, warmup=1),
               bound_ms=bms, bound_by=by, library_ms=None,
               device_ms=graph_ms(kern, iters=4 * DENSE_SETS))
    if not shape["softcap"]:
        B, H, D, T = q.shape[0], q.shape[1], shape["D"], shape["T"]
        G = shape["G"]
        mask = (torch.arange(T, device="cuda")[None, :]
                < case["live"][:, None])[:, None, None]
        # SDPA's dense clean caches: the NaN dead slots zeroed (a masked
        # NaN still poisons its product)
        kc = [torch.nan_to_num(c, nan=0.0).transpose(2, 3) for c in
              (case["k"], case["v"])]

        def sdpa():
            i = next(sets)
            k, v = kc[0][i], kc[1][i]
            if G > 1:
                k, v = (t.repeat_interleave(G, 1) for t in (k, v))
            return F.scaled_dot_product_attention(
                q.view(B, H, 1, D), k, v, attn_mask=mask, scale=scale)

        rec.update(library_ms=time_ms(sdpa, iters=4 * DENSE_SETS),
                   library_device_ms=graph_ms(sdpa, iters=4 * DENSE_SETS))
    return rec


def check_dense_graph(gen) -> int:
    """One captured dense call (zamba2's shape) replayed at offsets that
    change every replay, each replay's output bit-equal to an eager
    call's; the paged launch's ticket counters all zero after (the dense
    kernel keeps none). Returns the replays."""
    import numpy as np
    import torch
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    shape = DENSE_DECODE[2]
    case = dense_case(dict(shape, offs=(shape["T"] - 1,) * shape["B"]),
                      torch.bfloat16, gen, "cuda")
    case["k"], case["v"] = (torch.nan_to_num(c[0], nan=0.0)
                            for c in (case["k"], case["v"]))
    call = dense_call(shape)
    offs = case["offs"].clone()
    out = {}

    def run():
        out["o"] = call(case["q"], case["k"], case["v"], offs)

    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    rng = np.random.default_rng(3)
    replays = 0
    for i in range(64):
        n = rng.integers(0, shape["T"] + 200, size=shape["B"]).astype(
            np.int32)
        offs.copy_(torch.from_numpy(n))
        graph.replay()
        eager = call(case["q"], case["k"], case["v"], offs)
        assert same_bits(eager, out["o"]), f"replay {i}"
        replays += 1
    torch.cuda.synchronize()
    assert all(int(a.abs().sum()) == 0 for a in decode_kernel._KEPT), \
        "a ticket counter was left non-zero"
    del graph
    return replays


def check_dense_refusals(gen) -> None:
    """What the dense launch does not take raises before any launch: a
    cache longer than its window, int64 or host offsets, a q of another
    dtype, heads not D apart, a negative softcap."""
    import torch
    from repro_torch.kernels.decode_attention import (
        dense_decode_attention_kernel as kernel)
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    shape = DENSE_EDGES[3]
    case = dense_case(shape, torch.bfloat16, gen, "cuda")
    q, k, v, offs = case["q"], case["k"][0], case["v"][0], case["offs"]
    before = decode_kernel.dense_decode_attention_kernel.launches
    for what, fn in (
            ("window", lambda: kernel(q, k, v, offs, window=16)),
            ("int64", lambda: kernel(q, k, v, offs.long())),
            ("host", lambda: kernel(q, k, v, offs.cpu())),
            ("dtype", lambda: kernel(q.float(), k, v, offs)),
            ("heads", lambda: kernel(q, k.transpose(1, 2).contiguous()
                                     .transpose(1, 2), v, offs)),
            ("softcap", lambda: kernel(q, k, v, offs, softcap=-1.0))):
        try:
            fn()
        except (ValueError, TypeError):
            continue
        raise AssertionError(f"dense launch took a bad {what}")
    assert decode_kernel.dense_decode_attention_kernel.launches == before


def check_dense_row_in_batch(gen) -> int:
    """At each DENSE_DECODE and DENSE_HEAD_EDGES shape in bf16, one row
    called alone (its q
    and caches fresh contiguous copies) and the same row inside a B = 3
    batch, between rows at other offsets: bit-equal outputs (the dense
    plan never reads B, the offsets or the row strides). Returns the
    shapes checked."""
    import torch
    for shape in DENSE_DECODE + DENSE_HEAD_EDGES:
        off = shape["offs"][0]
        case = dense_case(dict(shape, B=3, offs=(17, off, shape["T"] - 1)),
                          torch.bfloat16, gen, "cuda")
        call = dense_call(shape)
        q, k, v, offs = case["q"], case["k"][0], case["v"][0], case["offs"]
        batch = call(q, k, v, offs)[1]
        alone = call(q[1:2].clone(), k[1:2].clone(), v[1:2].clone(),
                     offs[1:2].clone())[0]
        assert same_bits(alone, batch), (shape["name"], "row 1 alone")
        torch.cuda.empty_cache()
    return len(DENSE_DECODE + DENSE_HEAD_EDGES)


def check_dense_decodes(gen, sheet: dict) -> dict:
    """Phase 2's dense launch: DENSE_DECODE and DENSE_EDGES in bf16 and
    fp32 against the plain version in float64, the timed records of DENSE_DECODE
    (logged; the first is the kernels line's), one graph replayed at
    changing offsets, the refusals."""
    import torch
    from repro_torch.kernels.decode_attention import kernel as decode_kernel
    records = {}
    err = 0.0
    for shape in DENSE_DECODE:
        # path E's shapes take the dense kernel of csrc/dense_decode.cu
        plan = decode_kernel.plan_dense_decode(*(shape[k] for k in (
            "B", "T", "KV", "G", "D")), 2)
        assert plan.route == "cluster", (shape["name"], plan)
        log(f"phase2 dense_decode_attention plan {shape['name']}: "
            f"{json.dumps(dataclasses.asdict(plan.split))}, grid "
            f"{list(plan.grid)}")
    for shape in DENSE_DECODE + DENSE_EDGES:
        dims = {k: v for k, v in shape.items() if k != "name"}
        for dtype in (torch.bfloat16, torch.float32):
            got = check_dense(shape, dtype, gen)
            log(f"phase2 dense_decode_attention {shape['name']} "
                f"{json.dumps(dims)} {dtype}: {json.dumps(got)}")
            err = max(err, got["max_abs_err"])
            torch.cuda.empty_cache()
    for shape in DENSE_DECODE:
        records[shape["name"]] = time_dense(shape, gen, sheet)
        torch.cuda.empty_cache()
    log(f"phase2 dense_decode_attention timed (bf16, {DENSE_SETS} caches "
        f"in turn): {json.dumps(records)}")
    log(f"phase2 dense_decode_attention: one graph replayed at "
        f"{check_dense_graph(gen)} offset sets bit-equal to eager calls, "
        f"ticket counters all zero after")
    log(f"phase2 dense_decode_attention: a row alone bit-equal to the "
        f"same row in a B = 3 batch at {check_dense_row_in_batch(gen)} "
        f"shapes")
    check_dense_refusals(gen)
    log("phase2 dense_decode_attention: a cache past its window, int64 "
        "and host offsets, a q of another dtype, heads not D apart and a "
        "negative softcap refused before any launch")
    main = dict(records[DENSE_DECODE[0]["name"]], max_abs_err=err)
    main["by_shape"] = {name: {k: r[k] for k in ("device_ms", "bound_ms")}
                        for name, r in records.items()}
    zamba = records[DENSE_DECODE[2]["name"]]
    main["library_device_ms_zamba2"] = zamba.get("library_device_ms")
    return main


def check_page_copy(case: dict, timed: bool, sheet: dict) -> dict:
    """Gather, scatter, copy (gather + scatter) and append: bit-exact
    against the plain versions. Returns {kernel: (err, timing or None)}."""
    import itertools
    import numpy as np
    import torch
    from repro_torch.kernels.page_copy import (
        append_tokens_ref, copy_pages, copy_pages_ref, page_gather_kernel,
        page_gather_ref, page_scatter_kernel, page_scatter_ref,
        token_append_indexed_kernel, token_append_kernel)
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

    # the device-indexed append: its slots as int32 tensors on the card
    pid_i32 = torch.from_numpy(case["app_pages"].astype(np.int32)).to(dev)
    off_i32 = torch.from_numpy(case["app_offs"].astype(np.int32)).to(dev)
    ki, vi = k.clone(), case["v"].clone()
    token_append_indexed_kernel(ki, vi, case["k_tok"], case["v_tok"],
                                pid_i32, off_i32)
    torch.cuda.synchronize()
    assert torch.equal(ki, kr) and torch.equal(vi, vr), "indexed append"
    res["token_append_indexed"] = 0.0
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
    # the same rows and bound through the indexed launch
    out["token_append_indexed"] = (res["token_append_indexed"], dict(
        ms=time_ms(lambda: token_append_indexed_kernel(
            ki, vi, case["k_tok"], case["v_tok"], pid_i32, off_i32)),
        plain_ms=time_ms(lambda: append_tokens_ref(
            kr, vr, case["k_tok"], case["v_tok"], pid_i32, off_i32)),
        bound_ms=bms, bound_by=by, library_ms=time_ms(library_append),
        device_ms=graph_ms(lambda: token_append_indexed_kernel(
            ki, vi, case["k_tok"], case["v_tok"], pid_i32, off_i32)),
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


def extend_mask(shape: dict, device) -> "torch.Tensor":
    """(B, 1, C, T) bool: which cache slot each of a chunk's queries sees
    (position off[b] + i sees slots j <= off[b] + i, and j > off[b] + i -
    window with a window)."""
    import torch
    off = torch.tensor(shape["offs"], device=device)[:, None, None]
    pos = off + torch.arange(shape["C"], device=device)[None, :, None]
    key = torch.arange(shape["T"], device=device)
    mask = key <= pos
    if shape["window"]:
        mask &= key > pos - shape["window"]
    return mask[:, None]


def extend_work(shape: dict, esz: int) -> tuple[int, float]:
    """(bytes, flops) the extend launch must move and do on this data: q
    read and o written once, each row's live K/V slots read once (from
    its window's first to off + C), the offsets; 4 * D flops (q.k and
    p.v) per live (query, key) pair."""
    B, H, KV, C, D = (shape[k] for k in ("B", "H", "KV", "C", "D"))
    W = shape["window"]
    nbytes, pairs = 2 * B * H * C * D * esz + 4 * B, 0
    for off in shape["offs"]:
        first = max(0, off - W + 1) if W else 0
        nbytes += 2 * KV * (off + C - first) * D * esz
        pairs += sum(min(off + i + 1, W) if W else off + i + 1
                     for i in range(C))
    return nbytes, 4.0 * D * pairs * H


def extend_case(shape: dict, dtype, gen):
    """q (B, H, C, D) and the cache k/v (B, KV, T, D), views of the
    model's (B, C, H, D) / (B, T, KV, D) memory, and the int32 offsets;
    every slot past a row's offset + C is NaN (a cache's unwritten slots
    hold anything)."""
    import torch
    B, H, KV, C, T, D = (shape[k] for k in ("B", "H", "KV", "C", "T", "D"))
    q = torch.randn((B, C, H, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((B, T, KV, D), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    for b, off in enumerate(shape["offs"]):
        k[b, off + C:] = float("nan")
        v[b, off + C:] = float("nan")
    off = torch.tensor(shape["offs"], dtype=torch.int32, device="cuda")
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), off


def check_extend(shape: dict, dtype, gen, timed: bool, sheet: dict):
    """The extend launch against its plain version (the flash plain
    version at the same offsets), within row 5's tolerances (``check_
    flash``'s: fp32 1e-3, bf16 1e-2); finite wherever the cache's dead
    slots hold NaN; the same memory laid out (B, H, C, D) / (B, KV, T, D)
    giving the same bits. Timed like ``check_flash``, SDPA given the same
    boolean mask as ``library_ms``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention_ref,
                                                     flash_extend_kernel)
    q, k, v, off = extend_case(shape, dtype, gen)
    opts = dict(window=shape["window"], softcap=shape["softcap"])
    out = flash_extend_kernel(q, k, v, off, **opts)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all(), f"extend launch not finite at {shape}"
    ref = flash_attention_ref(q, k, v, q_offset=off, **opts)
    tol = 1e-3 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    err = (out.float() - ref.float()).abs().max().item()
    del ref
    dense = flash_extend_kernel(*(x.contiguous() for x in (q, k, v)), off,
                                **opts)
    torch.cuda.synchronize()
    assert torch.equal(dense, out), "extend launch differs by layout"
    if not timed:
        return err, None
    bms, by = bound_ms(*extend_work(shape, q.element_size()), sheet, "bf16")
    mask = extend_mask(shape, "cuda")

    def kern():
        return flash_extend_kernel(q, k, v, off, **opts)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)

    rec = dict(
        ms=time_ms(kern),
        plain_ms=time_ms(lambda: flash_attention_ref(q, k, v, q_offset=off,
                                                     **opts),
                         iters=5, warmup=1),
        bound_ms=bms, bound_by=by, library_ms=time_ms(sdpa),
        device_ms=graph_ms(kern), library_device_ms=graph_ms(sdpa))
    if dtype == torch.bfloat16:
        from repro_torch.kernels.flash_attention.kernel import (_num_sms,
                                                                plan_extend)
        plan = plan_extend(*(shape[x] for x in ("B", "H", "KV", "C", "T",
                                                "D")), shape["window"],
                           _num_sms(q.device.index))
        rec.update(slices=plan.slices, ctas=plan.ctas, pair=plan.pair,
                   device_ms_by_slices=extend_slice_times(
                       shape, q, k, v, off, opts, tol))
    return err, rec


def extend_slice_times(shape: dict, q, k, v, off, opts: dict,
                       tol: float) -> dict:
    """The bf16 extend launch forced to each of EXTEND_SLICES (its
    measurement hook), each within ``tol`` of the plain version and timed
    by CUDA-graph replay: {slices: device ms}."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_ref,
                                                     flash_extend_kernel)
    ref = flash_attention_ref(q, k, v, q_offset=off, **opts).float()
    out = {}
    for n in EXTEND_SLICES:
        got = flash_extend_kernel(q, k, v, off, _slices=n, **opts)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref, atol=tol, rtol=tol)
        out[n] = graph_ms(lambda n=n: flash_extend_kernel(
            q, k, v, off, _slices=n, **opts))
    return out


def check_extend_graph(shape: dict, dtype, gen) -> dict:
    """One CUDA graph of the extend launch captured at the first of
    EXTEND_GRAPH_OFFSETS and replayed with the offset buffer set to each:
    bit-equal to eager launches at those offsets (the slices' tile ranges
    are worked out on the device). The cache is NaN past the largest
    offset + C. Returns {offset: max |out - plain|}."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention_ref,
                                                     flash_extend_kernel)
    q, k, v, buf = extend_case(dict(shape, offs=(max(EXTEND_GRAPH_OFFSETS),)),
                               dtype, gen)
    opts = dict(window=shape["window"], softcap=shape["softcap"])
    eager = {}
    for o in EXTEND_GRAPH_OFFSETS:
        buf.fill_(o)
        eager[o] = flash_extend_kernel(q, k, v, buf, **opts)
    buf.fill_(EXTEND_GRAPH_OFFSETS[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_extend_kernel(q, k, v, buf, **opts)
    gaps = {}
    for o in EXTEND_GRAPH_OFFSETS:
        buf.fill_(o)
        graph.replay()
        torch.cuda.synchronize()
        assert same_bits(out, eager[o]), f"replay at offset {o} differs"
        ref = flash_attention_ref(q, k, v, q_offset=buf, **opts)
        gaps[o] = (out.float() - ref.float()).abs().max().item()
    del graph
    return gaps


def check_extend_refusals(gen) -> None:
    """The extend launch refuses before any launch: offsets in int64, of
    the wrong length or rank, or on the host, a misaligned position
    stride in bf16 (TMA), a head dim of 100 in bf16."""
    import torch
    from repro_torch.kernels.flash_attention import flash_extend_kernel
    shape = dict(FLASH_EXTEND, C=64, T=256, offs=(100,))
    q, k, v, off = extend_case(shape, torch.bfloat16, gen)
    padded = torch.zeros((1, 2, 256, 129), dtype=torch.bfloat16,
                         device="cuda")[..., :128]
    padded.copy_(k)
    before = flash_extend_kernel.launches
    for what, args in (
            ("int64 offsets", (q, k, v, off.long())),
            ("two offsets", (q, k, v, off.repeat(2))),
            ("2-D offsets", (q, k, v, off[None])),
            ("host offsets", (q, k, v, off.cpu())),
            ("misaligned stride", (q, padded, v, off)),
            ("head dim 100", tuple(x[..., :100].contiguous()
                                   for x in (q, k, v)) + (off,))):
        expect_value_error(lambda: flash_extend_kernel(*args), what)
    assert flash_extend_kernel.launches == before


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


def check_append_indexed_refusals(gen) -> float:
    """The device-indexed token append at APPEND_WIDE's 300 rows in one
    launch, bit-exact against the plain version with the same device
    slots; slots of the wrong dtype, shape or layout, or on the host,
    raise ``ValueError`` before any launch. Returns the max abs error
    (0)."""
    import numpy as np
    import torch
    from repro_torch.kernels.page_copy import (append_tokens_ref,
                                               token_append_indexed_kernel)
    L, P, page, KV, Dh, B = (APPEND_WIDE[x] for x in
                             ("L", "P", "page", "KV", "Dh", "B"))
    pools = [torch.randn((L, P, page, KV, Dh), generator=gen,
                         device="cuda").to(torch.bfloat16) for _ in range(2)]
    toks = [torch.randn((L, B, KV, Dh), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2)]
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.permutation(P)[:B].astype(np.int32)).cuda()
    offs = torch.from_numpy(rng.integers(0, page, size=B).astype(
        np.int32)).cuda()
    refs = [x.clone() for x in pools]
    before = token_append_indexed_kernel.launches
    token_append_indexed_kernel(*pools, *toks, ids, offs)
    assert token_append_indexed_kernel.launches - before == 1
    append_tokens_ref(*refs, *toks, ids, offs)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(pools, refs)), "append"
    before = token_append_indexed_kernel.launches
    for what, bad_ids, bad_offs in (
            ("int64 ids", ids.long(), offs),
            ("int64 offsets", ids, offs.long()),
            ("2-D ids", ids[:, None], offs),
            ("ids of another length", ids[:-1], offs[:-1]),
            ("strided ids", torch.stack([ids, ids], 1)[:, 0], offs),
            ("ids on the host", ids.cpu(), offs.cpu())):
        expect_value_error(lambda: token_append_indexed_kernel(
            *pools, *toks, bad_ids, bad_offs), what)
    assert token_append_indexed_kernel.launches == before
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


# ------------------------------------------------- phase 2: the fusions
#: The decode step's fusions (``kernels/fusions``): name -> (source, the
#: reference's jnp that XLA fuses in its jitted decode scan). The new
#: token's merge (the reference's ``paged_runtime.py:411``) has no kernel
#: of its own: decode attention's one launch merges it, checked below
#: (``decode_merge``) and counted as ``paged_decode_attention``.
FUSIONS = {
    "rms_norm": ("src/repro_torch/csrc/fusions.cu",
                 "src/repro/models/common.py:80"),
    "qkv_rope": ("src/repro_torch/csrc/fusions.cu",
                 "src/repro/models/attention.py:53"),
    "gated_act": ("src/repro_torch/csrc/fusions.cu",
                  "src/repro/models/mlp.py:19"),
    "gate_up_act": ("src/repro_torch/csrc/fusions.cu",
                    "src/repro/models/mlp.py:19"),
    "qkv_proj": ("src/repro_torch/csrc/fusions.cu",
                 "src/repro/models/attention.py:53"),
}
#: the paged families whose published widths the fusion checks take
FUSION_ARCHS = ("qwen2-1.5b", "stablelm-3b", "glm4-9b",
                "qwen3-moe-235b-a22b", "pixtral-12b", "musicgen-large")
#: decode batch rows the checks hold, and the serve step's (timed)
FUSION_ROWS = (1, 4, 64)
FUSION_TIMED_ROWS = 4
#: the norm also at a 512-token chunk's rows (timed too), each row
#: bit-equal across all these row counts
NORM_WIDE_ROWS = 512
#: the merge's cases: pools of (shape, dtype, layer whose token rows are
#: the new token's): the serve step, the phase-2 shape in bf16 and fp32,
#: glm4-9b's width (G 16) and the smoke width in fp32
FUSION_MERGE_CASES = (("SERVE_DECODE", "bfloat16", 0),
                      ("FULL", "bfloat16", FULL["L"] - 1),
                      ("FULL", "float32", 3),
                      ("GLM4_WIDE", "bfloat16", 1),
                      ("GLM4_SMOKE", "float32", 1))
#: up values the activation's exhaustive check pairs every finite bf16
#: gate with
ACT_UPS = (1.0, -1.5, 0.3125, 7.0, 2.0 ** -10)
#: the gate/up product's token rows: each row of a 16-row call bit-equal
#: to the same row of a call on fewer
GATE_UP_ROWS = tuple(range(1, 17))
#: weight copies a timing rotates over, so every call finds its weights
#: cold in the 50 MB L2, as a decode step's layer loop does
GATE_UP_SETS = 3
#: the qkv launch's token rows: each row of a 16-row call bit-equal to
#: the same row of a call on fewer
QKV_ROWS = tuple(range(1, 17))
#: weight copies its timing rotates over: 12 x 6.29 MB at qwen2-1.5b, past
#: the 50 MB L2, so every call finds its weights cold
QKV_SETS = 12
#: fp32 norms are checked on fresh draws of each of these seeds (P15):
#: the bound below holds for any input, not for one draw
NORM_FP32_SEEDS = (0, 1, 2)
#: the merge's plain spelling fed the kernel's residuals: fp32 within
#: 2e-5 (one dot product summed in another order), bf16 within one ulp
MERGE_FP32_ATOL = 2e-5


def rot_half(cfg) -> int:
    """The channels RoPE pairs (rot / 2; 0 without RoPE)."""
    return int(cfg.head_dim * cfg.rope_fraction) // 2 \
        if cfg.pos_emb == "rope" else 0


def decode_qkv(cfg) -> str:
    """The qkv pass a fused decode step of ``cfg`` (at most 16 rows)
    launches: the qkv launch (products and chain) where its plan takes
    the bf16 shapes, else the row pass after cuBLAS's products."""
    from repro_torch.kernels.fusions import plan_qkv
    if cfg.compute_dtype != "bfloat16":
        return "qkv_rope"
    try:
        plan_qkv(1, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                 cfg.head_dim, rot_half=rot_half(cfg))
    except ValueError:
        return "qkv_rope"
    return "qkv_proj"


def fused_names(cfg) -> list[str]:
    """The fusions a fused decode step of ``cfg`` (at most 16 rows, as
    every check's) launches: the norms and the qkv pass (``decode_qkv``),
    and in a dense FFN the gate/up product with its activation in bf16,
    the gated activation alone (after cuBLAS's products) in fp32."""
    names = ["rms_norm", decode_qkv(cfg)]
    if cfg.family != "moe":
        names.append(DECODE_FFN if cfg.compute_dtype == "bfloat16"
                     else CHUNK_FFN)
    return names


def fusion_kernels() -> dict:
    """name -> (CUDA call, plain version) of the fusions and of the new
    token's merge (a test hands in other callables). The merge's CUDA
    call is decode attention with ``new_kv``: one launch, whose last
    block of a row merges the token."""
    from repro_torch.kernels import fusions as fz
    return {"rms_norm": (fz.rms_norm_kernel, fz.rms_norm_ref),
            "qkv_rope": (fz.qkv_rope_kernel, fz.qkv_rope_ref),
            "decode_merge": (fz.attend_merged, fz.attend_merged_ref),
            "gated_act": (fz.gated_act_kernel, fz.gated_act_ref),
            "gate_up_act": (fz.gate_up_act_kernel, fz.gate_up_act_ref),
            "qkv_proj": (fz.qkv_proj_kernel, fz.qkv_proj_ref)}


def ulp_gap(a, b) -> dict:
    """Units in the last place of a's dtype (bf16 or fp32) between two
    finite tensors: the largest distance and how many elements differ."""
    import torch
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    it, mag = {torch.bfloat16: (torch.int16, 0x7FFF),
               torch.float32: (torch.int32, 0x7FFFFFFF)}[a.dtype]

    def order(t):
        i = t.contiguous().view(it).long()
        return torch.where(i < 0, -(i & mag), i)

    d = (order(a) - order(b)).abs()
    return dict(max_ulps=int(d.max()) if d.numel() else 0,
                differ=int((d > 0).sum()), n=d.numel(),
                max_abs=(a.float() - b.float()).abs().max().item()
                if d.numel() else 0.0)


def worst_gap(a: dict | None, b: dict) -> dict:
    """Two ``ulp_gap`` records as one: the larger distances, the counts
    summed."""
    if a is None:
        return dict(b)
    return {k: max(a[k], b[k]) if k.startswith("max") else a[k] + b[k]
            for k in b}


def same_bits(a, b) -> bool:
    """Equal bit for bit (a NaN equal to the same NaN)."""
    import torch
    it = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(it),
                                              b.contiguous().view(it))


def fusion_inputs(cfg, B: int, dtype, gen, device) -> dict:
    """A decode step's tensors at ``cfg``'s width: the residual stream,
    its delta and a norm scale; the three projections, biases, qk norm
    scales and RoPE tables at positions up to 32k; gate and up rows."""
    import torch
    from repro_torch.models.common import rope_tables
    H, KV, Dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.d_model

    def rand(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=device) *
                std).to(dtype)

    pos = torch.randint(0, 32768, (B, 1), generator=gen, device=device)
    return dict(
        x=rand(B, 1, D), delta=rand(B, 1, D), scale=rand(D, std=0.1),
        q=rand(B, H, Dh), k=rand(B, KV, Dh), v=rand(B, KV, Dh),
        bias=(rand(H, Dh, std=0.5), rand(KV, Dh, std=0.5),
              rand(KV, Dh, std=0.5)) if cfg.qkv_bias else None,
        norm=(rand(Dh, std=0.1), rand(Dh, std=0.1)) if cfg.qk_norm
        else None,
        rope=rope_tables(pos, Dh, cfg.rope_theta, cfg.rope_fraction)
        if cfg.pos_emb == "rope" else None,
        gate=rand(B, 1, cfg.d_ff, std=2.0), up=rand(B, 1, cfg.d_ff))


def norm_fp32_ulps(D: int) -> int:
    """The most fp32 ulps the norm kernel's output may lie from the norm
    of its input computed in float64 and rounded to fp32, for rows of
    ``D`` (P15). With u = 2^-24 (an error of e u relative is at most e
    ulps): a square and the kernel's adds (a thread's chunks in element
    order, the warp's 5-level xor tree, the warps' sums in warp order:
    ``norm_geometry``) put at most d roundings on any term's path, so the
    sum is within d u relative; the mean's two roundings and eps's add
    make d + 3; rsqrt halves its input's relative error and adds its own
    2 ulps (rsqrtf, 4 u); x r, 1 + g and their product round 3 times; the
    float64 value's rounding to fp32 is one ulp more at most."""
    from repro_torch.kernels.fusions.kernel import norm_geometry
    geo = norm_geometry(D, 4)
    chunks = D // 4
    per_thread = geo.chunks_per_thread or -(-chunks // geo.row_threads)
    d = 1 + (4 * per_thread - 1) + 5 + (geo.row_threads // 32 - 1)
    return math.ceil((d + 3) / 2) + 4 + 3 + 1


def norm_exact(x, scale, eps: float):
    """The RMS norm of ``x`` in float64, rounded to fp32: the value both
    fp32 spellings approximate."""
    import torch
    xd = x.double()
    out = xd * torch.rsqrt(xd.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale.double())
    return out.float()


def check_fusion_norms(cfg, B: int, dtype, device, kernels) -> dict:
    """The norm kernel in its three modes at ``cfg``'s d_model (and, with
    a qk norm, on the (B * H, Dh) head rows) against the plain version,
    on inputs drawn from a generator of their own (no other check's draws
    move them): bf16 within one ulp; fp32, on each of NORM_FP32_SEEDS,
    within ``norm_fp32_ulps`` of the float64 norm, and so within that
    plus the plain version's own measured distance from it of the plain
    version. Returns the worst gap to the plain version, with the worst
    fp32 gap to the float64 norm and its bound."""
    import torch
    kern, ref = kernels["rms_norm"]
    eps = cfg.norm_eps
    worst, exact = None, None
    seeds = NORM_FP32_SEEDS if dtype == torch.float32 else (0,)
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(zlib.crc32(
            f"{cfg.name} {B} {dtype} {seed}".encode()))
        t = fusion_inputs(cfg, B, dtype, gen, device)
        cases = [(t["x"], None, False), (t["x"], t["delta"], True),
                 (t["x"], t["delta"], False)]
        rows = [t["scale"]] * 3
        if cfg.qk_norm:
            cases.append((t["q"], None, False))
            rows.append(t["norm"][0])
        for (x, delta, f32), scale in zip(cases, rows):
            got, want = kern(x, scale, eps, delta, f32), ref(x, scale, eps,
                                                             delta, f32)
            if delta is not None:
                assert same_bits(got[0], want[0]), "residual sum differs"
                x, got, want = want[0], got[1], want[1]
            g = ulp_gap(got, want)
            if dtype == torch.bfloat16:
                assert g["max_ulps"] <= 1, (cfg.name, B, g)
            else:
                bound = norm_fp32_ulps(x.shape[-1])
                e64 = norm_exact(x, scale, eps)
                ge, gp = ulp_gap(got, e64), ulp_gap(want, e64)
                assert ge["max_ulps"] <= bound, (cfg.name, B, seed, ge,
                                                 bound)
                assert g["max_ulps"] <= bound + gp["max_ulps"], \
                    (cfg.name, B, seed, g, gp, bound)
                ge = dict(ge, bound_ulps=bound, plain_ulps=gp["max_ulps"])
                exact = ge if exact is None or \
                    ge["max_ulps"] > exact["max_ulps"] else exact
            worst = worst_gap(worst, g)
    return worst if exact is None else dict(worst, float64=exact)


def check_norm_rows(cfg, dtype, gen, device, kernels) -> int:
    """The norm kernel's rows do not depend on the batch: at ``cfg``'s
    d_model, in its three modes, the first n rows of a call on
    NORM_WIDE_ROWS rows bit-equal to a call on those n rows alone, for n
    in FUSION_ROWS (the sum's order is a function of the row length
    alone). Returns the rows compared."""
    import torch
    kern = kernels["rms_norm"][0]
    D, eps = cfg.d_model, cfg.norm_eps
    x, delta = (torch.randn((NORM_WIDE_ROWS, 1, D), generator=gen,
                            device=device).to(dtype) for _ in range(2))
    scale = (torch.randn(D, generator=gen, device=device) * 0.1).to(dtype)
    n_rows = 0
    for d, f32 in ((None, False), (delta, True), (delta, False)):
        full = kern(x, scale, eps, d, f32)
        for n in FUSION_ROWS:
            part = kern(x[:n], scale, eps, None if d is None else d[:n], f32)
            for a, b in (zip(full, part) if d is not None
                         else ((full, part),)):
                assert same_bits(a[:n], b), (cfg.name, dtype, n, f32)
            n_rows += n
    return n_rows


def check_fusion_rope(cfg, B: int, dtype, gen, device, kernels) -> dict:
    """The qkv bias + RoPE kernel against its plain version, bit for bit
    (q, k and v). With a qk norm the plain composition takes the norm
    kernel's row sums (the fused norm sums in its order); the gap to the
    all-plain spelling is returned in ulps."""
    import torch
    kern, ref = kernels["qkv_rope"]
    norm_kern = kernels["rms_norm"][0]
    t = fusion_inputs(cfg, B, dtype, gen, device)
    kw = dict(bias=t["bias"], norm=t["norm"], eps=cfg.norm_eps,
              rope=t["rope"])
    outs = [torch.empty_like(t["k"]) for _ in range(4)]
    qd = kern(t["q"], t["k"], t["v"], k_out=outs[0], v_out=outs[1], **kw)
    q, k, v = t["q"], t["k"], t["v"]
    if t["norm"] is not None:        # bias and norm first, by the kernel's
        if t["bias"] is not None:    # row order, then the plain rest
            q, k, v = (a + b for a, b in zip((q, k, v), t["bias"]))
        q = norm_kern(q, t["norm"][0], cfg.norm_eps)
        k = norm_kern(k, t["norm"][1], cfg.norm_eps)
        kw = dict(kw, bias=None, norm=None)
    want = ref(q, k, v, k_out=outs[2], v_out=outs[3], **kw)
    for a, b in ((qd, want), (outs[0], outs[2]), (outs[1], outs[3])):
        assert same_bits(a, b), (cfg.name, B, dtype, ulp_gap(a, b))
    gap = {}
    if t["norm"] is not None:
        plain = ref(t["q"], t["k"], t["v"], k_out=outs[2], v_out=outs[3],
                    bias=t["bias"], norm=t["norm"], eps=cfg.norm_eps,
                    rope=t["rope"])
        gap = ulp_gap(qd, plain)
    return gap


def check_fusion_act(gen, device, kernels) -> dict:
    """The gated activation, bit-equal to its plain version: every finite
    bf16 gate against each of ACT_UPS, for SiLU and the tanh GELU; and
    fp32 rows of qwen2-1.5b's d_ff. Returns the elements compared."""
    import torch
    kern, ref = kernels["gated_act"]
    bits = torch.arange(-32768, 32768, dtype=torch.int32,
                        device=device).to(torch.int16)
    every = bits.view(torch.bfloat16)
    every = every[torch.isfinite(every)]
    gate = every.repeat(len(ACT_UPS))
    up = torch.tensor(ACT_UPS, device=device).to(torch.bfloat16)
    up = up.repeat_interleave(every.numel())
    rows = torch.randn((FUSION_TIMED_ROWS, 1, 8960), generator=gen,
                       device=device)
    n = 0
    for act in ("silu", "gelu"):
        got, want = kern(gate, up, act), ref(gate, up, act)
        assert same_bits(got, want), (act, ulp_gap(got, want)
                                      if torch.isfinite(want).all()
                                      else "non-finite")
        got = kern(rows * 2, rows, act)
        assert same_bits(got, ref(rows * 2, rows, act)), (act, "fp32")
        n += gate.numel() + rows.numel()
    return dict(elements=n, finite_bf16_gates=every.numel(),
                ups=len(ACT_UPS))


def gate_up_inputs(cfg, rows: int, gen, device, sets: int = 1) -> dict:
    """The decode step's FFN input at ``cfg``'s width: ``rows`` normed
    token rows (unit scale) and ``sets`` copies of w1 and w3 (std
    d_model^-1/2, so gate and up are of unit scale), bf16."""
    import torch
    D, F = cfg.d_model, cfg.d_ff

    def rand(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=device) *
                std).to(torch.bfloat16)

    return dict(x=rand(rows, 1, D),
                ws=[(rand(D, F, std=D ** -0.5), rand(D, F, std=D ** -0.5))
                    for _ in range(sets)])


def gate_up_bound(gate, up, activation: str) -> float:
    """The gate/up product's bound against its plain version: the largest
    change that moving the plain spelling's bf16 gate and up each by one
    ulp (either way) makes in its output, over the tensor. The kernel's
    fp32 sums run in another order than cuBLAS's, so a product may round
    to the neighbouring bf16 value; the activation and the product with up
    are the same ops."""
    import torch
    from repro_torch.kernels.fusions import gated_act_ref

    def moved(t, d):
        f = t.float()
        e = torch.floor(torch.log2(f.abs().clamp_min(2.0 ** -126)))
        return (f + d * torch.exp2(e - 7)).to(t.dtype)

    base = gated_act_ref(gate, up, activation).float()
    worst = 0.0
    for dg in (-1, 0, 1):
        for du in (-1, 0, 1):
            near = gated_act_ref(moved(gate, dg), moved(up, du), activation)
            worst = max(worst, (near.float() - base).abs().max().item())
    return worst


def check_fusion_gate_up(cfg, gen, device, kernels) -> dict:
    """The gate/up product at ``cfg``'s (d_model, d_ff), bf16: against its
    plain version (the two products, then the gated activation) within
    ``gate_up_bound``, the elements that differ counted; each row of a
    16-row call bit-equal to the row in calls of GATE_UP_ROWS rows and
    across repeats (its sums' order depends on the widths alone)."""
    import torch
    kern, ref = kernels["gate_up_act"]
    t = gate_up_inputs(cfg, max(GATE_UP_ROWS), gen, device)
    x, (w1, w3) = t["x"], t["ws"][0]
    act = cfg.activation
    got = kern(x, w1, w3, act)
    for rows in GATE_UP_ROWS:
        assert same_bits(kern(x[:rows], w1, w3, act), got[:rows]), \
            (cfg.name, rows)
    assert same_bits(kern(x, w1, w3, act), got), (cfg.name, "repeat")
    want = ref(x, w1, w3, act)
    gap = ulp_gap(got, want)
    bound = gate_up_bound(x @ w1, x @ w3, act)
    assert gap["max_abs"] <= bound, (cfg.name, gap, bound)
    return dict(gap, bound=bound, share_differ=gap["differ"] / gap["n"])


def qkv_inputs(cfg, rows: int, gen, device, sets: int = 1) -> dict:
    """The decode step's qkv pass at ``cfg``'s width, bf16: ``rows``
    normed token rows (unit scale), ``sets`` copies of wq, wk and wv (std
    d_model^-1/2), the chain's bias, qk norm scales and tables at
    positions up to 32k, and k / v output rows."""
    import torch
    from repro_torch.models.common import rope_tables
    H, KV, Dh, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.d_model

    def rand(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=device) *
                std).to(torch.bfloat16)

    pos = torch.randint(0, 32768, (rows, 1), generator=gen, device=device)
    return dict(
        x=rand(rows, 1, D),
        ws=[(rand(D, H, Dh, std=D ** -0.5), rand(D, KV, Dh, std=D ** -0.5),
             rand(D, KV, Dh, std=D ** -0.5)) for _ in range(sets)],
        chain=dict(
            bias=(rand(H, Dh, std=0.5), rand(KV, Dh, std=0.5),
                  rand(KV, Dh, std=0.5)) if cfg.qkv_bias else None,
            norm=(rand(Dh, std=0.1), rand(Dh, std=0.1)) if cfg.qk_norm
            else None,
            eps=cfg.norm_eps,
            rope=rope_tables(pos, Dh, cfg.rope_theta, cfg.rope_fraction)
            if cfg.pos_emb == "rope" else None),
        k_out=rand(rows, KV, Dh), v_out=rand(rows, KV, Dh))


def check_fusion_qkv(cfg, gen, device, kernels) -> dict:
    """The qkv launch at ``cfg``'s (d_model, H, KV, Dh), bf16: against
    its plain version (the three products, then the chain) within
    ``ref.qkv_proj_bound`` element by element; against the parent route (the
    three products, then the row pass's kernel) the share of q, k and v
    elements that differ (``share_differ``: the products one ulp off
    cuBLAS's and what the chain makes of them); each row of a 16-row call
    bit-equal to the row in calls of QKV_ROWS rows and across repeats
    (its sums' order depends on the shapes alone)."""
    import torch
    from repro_torch.kernels.fusions.ref import qkv_products, qkv_proj_bound
    kern, ref = kernels["qkv_proj"]
    route = kernels["qkv_rope"][0]
    t = qkv_inputs(cfg, max(QKV_ROWS), gen, device)
    x, ws, chain = t["x"], t["ws"][0], t["chain"]

    def run(f, rows=None):
        n = x.shape[0] if rows is None else rows
        ko, vo = (torch.empty_like(o[:n]) for o in (t["k_out"],
                                                     t["v_out"]))
        rope = None if chain["rope"] is None else \
            tuple(c[:n] for c in chain["rope"])
        q = f(x[:n], *ws, k_out=ko, v_out=vo, **dict(chain, rope=rope))
        return q, ko, vo

    got = run(kern)
    for rows in QKV_ROWS:
        part = run(kern, rows)
        assert all(same_bits(a, b[:rows]) for a, b in zip(part, got)), \
            (cfg.name, rows)
    assert all(same_bits(a, b) for a, b in zip(run(kern), got)), \
        (cfg.name, "repeat")
    want = run(ref)
    parent = run(lambda xx, *w, **kw: route(*qkv_products(xx, *w), **kw))
    bounds = qkv_proj_bound(x, *ws, **chain)
    gap, off, n = None, 0, 0
    for a, b, c, bd in zip(got, want, parent, bounds):
        assert ((a.double() - b.double()).abs() <= bd).all(), \
            (cfg.name, ulp_gap(a, b), bd.max().item())
        gap = worst_gap(gap, ulp_gap(a, b))
        off += int((a != c).sum())
        n += a.numel()
    return dict(gap, bound=max(bd.max().item() for bd in bounds),
                share_differ=off / n)


def check_fusion_merge(case: dict, layer: int, kernels) -> float:
    """Decode attention with the new token merged in the combine against
    the plain merge fed the kernel's residuals, on the case's pools with
    the token rows of ``layer``: bf16 within one ulp, fp32 within
    MERGE_FP32_ATOL. Returns the largest gap."""
    import torch
    kern, ref = kernels["decode_merge"]
    args = decode_args(case)
    k_new, v_new = case["k_tok"][layer], case["v_tok"][layer]
    scale = 1.0 / math.sqrt(args[0].shape[-1])
    got = kern(*args, k_new, v_new, layer=layer, scale=scale)
    want = ref(*args, k_new, v_new, layer=layer, scale=scale)
    if got.dtype == torch.bfloat16:
        g = ulp_gap(got, want)
        assert g["max_ulps"] <= 1, g
    else:
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, atol=MERGE_FP32_ATOL, rtol=0)
    return (got.float() - want.float()).abs().max().item()


def time_fusions(gen, sheet: dict, kernels) -> dict:
    """Each fusion at the serve step (qwen2-1.5b, B = 4, bf16): an eager
    loop (``ms``) and CUDA-graph replay (``device_ms``) beside the plain
    version, the bound and, where torch calls compute the function, those
    calls: ``F.rms_norm`` of the same sum (the add before it, as in the
    timed mode), ``F.silu(a) * b``, and for the gate/up product two
    ``torch.matmul`` and ``F.silu(g) * u`` (timed as one graph too). Those
    calls round otherwise: yardsticks only. The gate/up product rotates
    over GATE_UP_SETS weight copies, its weights cold in L2; beside it
    the parent's route (two cuBLAS products, then ``gated_act_kernel``),
    ``parent_route_device_ms``, timed before and after it. The qkv launch
    likewise over QKV_SETS copies, beside one ``torch.matmul`` of the
    rows against the three weights concatenated (the products alone, no
    chain) and the parent's route (three cuBLAS products, then the row
    pass)."""
    import itertools
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels.fusions import plan_gate_up
    cfg = get_config("qwen2-1.5b")
    t = fusion_inputs(cfg, FUSION_TIMED_ROWS, torch.bfloat16, gen, "cuda")
    esz = 2
    B, D, F_ = FUSION_TIMED_ROWS, cfg.d_model, cfg.d_ff
    eps = cfg.norm_eps
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    weight = (1.0 + t["scale"].float()).to(torch.bfloat16)
    kout = [torch.empty_like(t["k"]) for _ in range(2)]
    kw = dict(bias=t["bias"], norm=t["norm"], eps=eps, rope=t["rope"])
    rot = t["rope"][0].shape[-1]

    def pair(name, call):
        kern, ref = kernels[name]
        return (lambda: call(kern)), (lambda: call(ref))

    gu = gate_up_inputs(cfg, B, gen, "cuda", sets=GATE_UP_SETS)
    turn = itertools.cycle(gu["ws"])

    def gate_up(f):
        return f(gu["x"], *next(turn), "silu")

    def gate_up_library():
        w1, w3 = next(turn)
        return F.silu(torch.matmul(gu["x"], w1)) * torch.matmul(gu["x"], w3)

    def parent_route():
        w1, w3 = next(turn)
        return kernels["gated_act"][0](gu["x"] @ w1, gu["x"] @ w3, "silu")

    from repro_torch.kernels.fusions import plan_qkv
    from repro_torch.kernels.fusions.ref import qkv_products
    qk = qkv_inputs(cfg, B, gen, "cuda", sets=QKV_SETS)
    qturn = itertools.cycle(qk["ws"])
    heads = H + 2 * KV

    def qkv(f):
        return f(qk["x"], *next(qturn), k_out=qk["k_out"],
                 v_out=qk["v_out"], **qk["chain"])

    cats = [torch.cat([w.reshape(D, -1) for w in ws], 1) for ws in qk["ws"]]
    cturn = itertools.cycle(cats)

    def qkv_library():
        return torch.matmul(qk["x"], next(cturn))

    def qkv_parent():
        return kernels["qkv_rope"][0](*qkv_products(qk["x"], *next(qturn)),
                                      k_out=qk["k_out"], v_out=qk["v_out"],
                                      **qk["chain"])

    work = {
        "qkv_proj": (*pair("qkv_proj", qkv),
                     (D * heads * Dh + B * D + B * heads * Dh
                      + heads * Dh) * esz + 2 * B * rot * 4,
                     2.0 * B * D * heads * Dh, qkv_library),
        "rms_norm": (*pair("rms_norm", lambda f: f(t["x"], t["scale"], eps,
                                                   t["delta"], True)),
                     (4 * B * D + D) * esz, 5.0 * B * D,
                     lambda: F.rms_norm(t["x"] + t["delta"], (D,), weight,
                                        eps)),
        "qkv_rope": (*pair("qkv_rope", lambda f: f(
            t["q"], t["k"], t["v"], k_out=kout[0], v_out=kout[1], **kw)),
                     2 * B * (H + 2 * KV) * Dh * esz
                     + (H + 2 * KV) * Dh * esz + 2 * B * rot * 4,
                     8.0 * B * (H + KV) * Dh, None),
        "gated_act": (*pair("gated_act", lambda f: f(t["gate"], t["up"],
                                                     "silu")),
                      3 * B * F_ * esz, 6.0 * B * F_,
                      lambda: F.silu(t["gate"]) * t["up"]),
        "gate_up_act": (*pair("gate_up_act", gate_up),
                        (2 * D * F_ + B * D + B * F_) * esz,
                        4.0 * B * D * F_, gate_up_library),
    }
    recs = {}
    parent = graph_ms(parent_route)
    qparent = graph_ms(qkv_parent)
    for name, (kern, ref, nbytes, ops, lib) in work.items():
        bms, by = bound_ms(nbytes, ops, sheet,
                           "bf16" if name in ("gate_up_act", "qkv_proj")
                           else "fp32")
        recs[name] = dict(ms=time_ms(kern), plain_ms=time_ms(ref),
                          bound_ms=bms, bound_by=by,
                          library_ms=None if lib is None else time_ms(lib),
                          device_ms=graph_ms(kern))
        if lib is not None:
            recs[name]["library_device_ms"] = graph_ms(lib)
    plan = plan_gate_up(B, D, F_, torch.cuda.get_device_properties(
        0).multi_processor_count)
    recs["gate_up_act"].update(
        parent_route_device_ms=[parent, graph_ms(parent_route)],
        plan=dataclasses.asdict(plan))
    recs["qkv_proj"].update(
        parent_route_device_ms=[qparent, graph_ms(qkv_parent)],
        plan=dataclasses.asdict(plan_qkv(
            B, D, H, KV, Dh, torch.cuda.get_device_properties(
                0).multi_processor_count, rot_half=rot)))
    recs["rms_norm"].update(norm_floor_times(gen, cfg, kernels, sheet))
    recs["gated_act"].update(gated_act_wide_times(gen, kernels, sheet))
    return recs


#: the gated activation's rows where its launches run: path A's 512-token
#: chunk (qwen2-1.5b's d_ff 8960, SiLU) and gemma2-9b's 4600-token
#: prefill (d_ff 14336, the tanh GELU)
GATED_ACT_WIDE = {"chunk": (512, 8960, "silu"),
                  "gemma2_prefill": (4600, 14336, "gelu")}


def gated_act_wide_times(gen, kernels, sheet: dict) -> dict:
    """The gated activation by CUDA-graph replay at GATED_ACT_WIDE's rows
    (``device_ms_<name>``), each beside its bytes' bound (gate and up
    read, the product written: ``bound_ms_<name>``) and one PyTorch
    spelling of the same function (``F.silu(gate) * up``, or the tanh
    GELU's ``F.gelu(gate, approximate="tanh") * up``) the same way
    (``library_device_ms_<name>``; a yardstick that rounds otherwise)."""
    import torch
    import torch.nn.functional as F
    kern = kernels["gated_act"][0]
    out = {}
    for name, (rows, F_, act) in GATED_ACT_WIDE.items():
        gate, up = (torch.randn((rows, 1, F_), generator=gen,
                                device="cuda").to(torch.bfloat16)
                    for _ in range(2))
        out[f"device_ms_{name}"] = graph_ms(lambda: kern(gate, up, act),
                                            iters=5)
        out[f"bound_ms_{name}"] = 3 * rows * F_ * 2 / sheet["hbm_bw"] * 1e3
        lib = (lambda: F.silu(gate) * up) if act == "silu" else \
            (lambda: F.gelu(gate, approximate="tanh") * up)
        out[f"library_device_ms_{name}"] = graph_ms(lib, iters=5)
        del gate, up
    return out


def norm_floor_times(gen, cfg, kernels, sheet: dict) -> dict:
    """Two yardsticks beside the norm's bound, by CUDA-graph replay: an
    empty kernel's launch (``launch_floor_device_ms``: the least a graph
    node costs on this card) and the norm (fp32-sum mode) at
    NORM_WIDE_ROWS rows of ``cfg``'s d_model (``device_ms_wide``, with
    its bytes' bound ``bound_ms_wide``)."""
    import torch
    from repro_torch.kernels.fusions.kernel import empty_kernel_launch
    kern = kernels["rms_norm"][0]
    D, eps = cfg.d_model, cfg.norm_eps
    x, delta = (torch.randn((NORM_WIDE_ROWS, 1, D), generator=gen,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
    scale = torch.randn(D, generator=gen, device="cuda").to(torch.bfloat16)
    device = x.device
    return dict(
        launch_floor_device_ms=graph_ms(lambda: empty_kernel_launch(device)),
        device_ms_wide=graph_ms(lambda: kern(x, scale, eps, delta, True)),
        bound_ms_wide=(4 * NORM_WIDE_ROWS * D + D) * 2 / sheet["hbm_bw"]
        * 1e3)


def check_fusions(gen, sheet: dict | None, device: str = "cuda",
                  kernels: dict | None = None) -> dict:
    """Phase 2's checks of the decode step's fusions against their plain
    versions at every paged family's published width, rows FUSION_ROWS,
    bf16 and fp32; the activation exhaustively over the finite bf16
    gates; the gate/up product at each family's (d_model, d_ff); the new
    token's merge on the serve step's, the phase-2 and glm4's (G 16)
    pools. With ``sheet`` (the card) each fusion is also timed. Returns
    {name: record} of FUSIONS, each with its ``max_abs_err``, and the
    merge's largest gap as ``decode_merge`` (a check of decode
    attention's launch, no kernel of its own)."""
    import torch
    from repro_torch.configs import get_config
    kernels = kernels or fusion_kernels()
    err = dict.fromkeys(FUSIONS, 0.0)
    norm_gaps, norm_far, rope_gaps, gate_up = {}, {}, {}, {}
    invariant = 0
    for arch in FUSION_ARCHS:
        cfg = get_config(arch)
        for dtype in (torch.bfloat16, torch.float32):
            key = f"{arch} {str(dtype)[6:]}"
            for B in FUSION_ROWS + (NORM_WIDE_ROWS,):
                g = check_fusion_norms(cfg, B, dtype, device, kernels)
                far = g.pop("float64", None)
                norm_gaps[key] = worst_gap(norm_gaps.get(key), g)
                if far is not None and far["max_ulps"] >= norm_far.get(
                        key, {}).get("max_ulps", -1):
                    norm_far[key] = far
            invariant += check_norm_rows(cfg, dtype, gen, device, kernels)
            for B in FUSION_ROWS:
                rg = check_fusion_rope(cfg, B, dtype, gen, device, kernels)
                if rg:
                    rope_gaps[key] = worst_gap(rope_gaps.get(key), rg)
    log(f"phase2 rms_norm: three modes (plain, residual sum read in fp32, "
        f"rounded) at each paged family's d_model (and qwen3-moe's qk norm "
        f"rows), rows {FUSION_ROWS + (NORM_WIDE_ROWS,)}: ulps from the "
        f"plain norm (largest, elements that differ, compared) "
        f"{json.dumps(norm_gaps)}; fp32 on seeds {NORM_FP32_SEEDS}, ulps "
        f"from the float64 norm (the worst row width's gap, its derived "
        f"bound norm_fp32_ulps, the plain version's own gap): "
        f"{json.dumps(norm_far)}; rows of {NORM_WIDE_ROWS}-row calls "
        f"bit-equal to calls of {FUSION_ROWS} rows ({invariant} rows)")
    log(f"phase2 qkv_rope: bit-equal to the plain spelling at "
        f"{FUSION_ARCHS}, rows {FUSION_ROWS}, bf16 and fp32 (the qk norm "
        f"by the norm kernel's row order); the qk-normed q against the "
        f"all-plain spelling: {json.dumps(rope_gaps)}")
    err["rms_norm"] = max(g["max_abs"] for g in norm_gaps.values())
    act = check_fusion_act(gen, device, kernels)
    log(f"phase2 gated_act: bit-equal, SiLU and tanh GELU, every finite "
        f"bf16 gate against ups {ACT_UPS}, and fp32 rows: {act}")
    merged = {}
    for shape, dtype, layer in FUSION_MERGE_CASES:
        case = make_case(globals()[shape], getattr(torch, dtype), gen,
                         device)
        merged[f"{shape} {dtype}"] = check_fusion_merge(case, layer,
                                                        kernels)
        del case
    log(f"phase2 decode_merge: decode attention's one launch with the new "
        f"token merged against the plain merge of the kernel's residuals, "
        f"max |diff| by pools: {json.dumps(merged)}")
    # the gate/up product's checks come after the parent tree's, which
    # keep the generator's draws they had
    for arch in FUSION_ARCHS:
        gate_up[arch] = check_fusion_gate_up(get_config(arch), gen, device,
                                             kernels)
    err["gate_up_act"] = max(g["max_abs"] for g in gate_up.values())
    qkv = {}
    for arch in FUSION_ARCHS:
        cfg = get_config(arch)
        if decode_qkv(cfg) == "qkv_proj":
            qkv[arch] = check_fusion_qkv(cfg, torch.Generator(
                device=device).manual_seed(zlib.crc32(
                    f"qkv {arch}".encode())), device, kernels)
    err["qkv_proj"] = max(g["max_abs"] for g in qkv.values())
    log(f"phase2 qkv_proj: against the plain products and chain at each "
        f"paged family's width its plan takes ("
        f"{sorted(set(FUSION_ARCHS) - set(qkv))} keep the products and "
        f"qkv_rope), {max(QKV_ROWS)} rows, bf16, element by element within "
        f"qkv_proj_bound (the two fp32 sums' orders' worst gap and one "
        f"bf16 ulp of each projection, carried through the chain; its "
        f"largest value), with the share of q, k and v elements "
        f"off the parent route's (cuBLAS's products and the row pass); "
        f"rows bit-equal across calls of {QKV_ROWS} rows and repeats: "
        f"{json.dumps(qkv)}")
    log(f"phase2 gate_up_act: against the plain products and activation at "
        f"each paged family's (d_model, d_ff), {max(GATE_UP_ROWS)} rows, "
        f"bf16, within the bound one bf16 ulp of gate and of up makes "
        f"(ulps, elements that differ and their share, the bound); rows "
        f"bit-equal across calls of {GATE_UP_ROWS} rows and repeats: "
        f"{json.dumps(gate_up)}")
    out = {name: dict(max_abs_err=e) for name, e in err.items()}
    if sheet is not None:
        timed = time_fusions(gen, sheet, kernels)
        out = {name: dict(max_abs_err=err[name], **timed[name])
               for name in FUSIONS}
    out["decode_merge"] = dict(max_abs_err=max(merged.values()))
    return out


# ------------------------------------- phase 2: the chunk's qkv launch
#: The prefill / extend chunk's qkv pass (``qkv_rope_chunk_kernel``): the
#: decode step's qkv_rope kernel at a position a row, k and v written into
#: the layer's cache at device offsets. No Pallas kernel: XLA's fusion of
#: the reference's qkv_project and write_cache in ``_attn_apply``.
CHUNK_QKV = ("src/repro_torch/csrc/fusions.cu",
             "src/repro/models/transformer.py:205")
#: path A's chunk: 512 rows at offsets 0, 2048 and an odd one, on a
#: 2560-slot scratch (profile_step's shape), rows kept (the prefill's)
#: and not; then nb 3 at offsets that differ, one clamped to T - C
#: (write_cache's clamp), with tables of a row each; and each paged
#: family's width at nb 2 with the positions shared by the sequences
CHUNK_QKV_MAIN = dict(arch="qwen2-1.5b", nb=1, C=512, T=2560, offs=(2048,))
CHUNK_QKV_OFFSETS = (0, 2048, 1037)
CHUNK_QKV_CASES = (
    dict(arch="qwen2-1.5b", nb=3, C=64, T=640, offs=(0, 301, 700)),
    *(dict(arch=a, nb=2, C=48, T=256, offs=(5, 200), shared=True)
      for a in FUSION_ARCHS))


def chunk_qkv_kernels() -> tuple:
    """(CUDA launch, plain version, norm kernel) of the chunk's qkv pass
    (a test hands in other callables)."""
    from repro_torch.kernels import fusions as fz
    return fz.qkv_rope_chunk_kernel, fz.qkv_rope_chunk_ref, \
        fz.rms_norm_kernel


def chunk_qkv_case(case: dict, dtype, gen, device) -> dict:
    """A chunk's tensors at ``case["arch"]``'s published width: N = nb *
    C rows of q, k and v, the biases and qk norm scales, the tables (a
    row each at position offs[s] + c, or C rows shared), the caches (nb,
    T, KV, Dh) holding random values and the int32 offsets."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.common import rope_tables
    cfg = get_config(case["arch"])
    nb, C, T = case["nb"], case["C"], case["T"]
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    N = nb * C

    def rand(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=device) *
                std).to(dtype)

    off = torch.tensor(case["offs"], dtype=torch.int32, device=device)
    pos = torch.arange(C, device=device) if case.get("shared") else \
        off.long()[:, None] + torch.arange(C, device=device)
    return dict(
        cfg=cfg, q=rand(N, H, Dh), k=rand(N, KV, Dh), v=rand(N, KV, Dh),
        bias=(rand(H, Dh, std=0.5), rand(KV, Dh, std=0.5),
              rand(KV, Dh, std=0.5)) if cfg.qkv_bias else None,
        norm=(rand(Dh, std=0.1), rand(Dh, std=0.1)) if cfg.qk_norm
        else None,
        rope=rope_tables(pos, Dh, cfg.rope_theta, cfg.rope_fraction)
        if cfg.pos_emb == "rope" else None,
        cache=(rand(nb, T, KV, Dh), rand(nb, T, KV, Dh)), off=off)


def check_chunk_qkv(t: dict, kernels, rows: bool = False) -> dict:
    """The chunk's qkv launch against its plain version on ``t``
    (``chunk_qkv_case``), each on its own copy of the caches: q, the
    whole caches (the chunk's slots and every other slot untouched) and,
    with ``rows``, the k / v rows, bit for bit. With a qk norm the plain
    composition takes the norm kernel's row sums (as ``check_fusion_
    rope``); the ulps from the all-plain spelling are returned."""
    import torch
    kern, ref, norm_kern = kernels
    eps = t["cfg"].norm_eps
    outs = []
    for _ in range(3):
        ck, cv = (c.clone() for c in t["cache"])
        kr, vr = (torch.empty_like(t["k"]) for _ in range(2)) if rows \
            else (None, None)
        outs.append(dict(cache_k=ck, cache_v=cv, offsets=t["off"],
                         k_rows=kr, v_rows=vr))
    kw = dict(bias=t["bias"], norm=t["norm"], eps=eps, rope=t["rope"])
    got = kern(t["q"], t["k"], t["v"], **outs[0], **kw)
    q, k, v = t["q"], t["k"], t["v"]
    if t["norm"] is not None:
        if t["bias"] is not None:
            q, k, v = (a + b for a, b in zip((q, k, v), t["bias"]))
        q = norm_kern(q, t["norm"][0], eps)
        k = norm_kern(k, t["norm"][1], eps)
        kw = dict(kw, bias=None, norm=None)
    want = ref(q, k, v, **outs[1], **kw)
    pairs = [(got, want)] + [(outs[0][n], outs[1][n]) for n in (
        "cache_k", "cache_v") + (("k_rows", "v_rows") if rows else ())]
    for a, b in pairs:
        assert same_bits(a, b), (t["cfg"].name, tuple(t["q"].shape),
                                 t["q"].dtype, ulp_gap(a, b))
    if t["norm"] is None:
        return {}
    plain = ref(t["q"], t["k"], t["v"], **outs[2], bias=t["bias"],
                norm=t["norm"], eps=eps, rope=t["rope"])
    return ulp_gap(got, plain)


def chunk_qkv_graph(t: dict, kernels, offsets) -> int:
    """The launch captured once in a CUDA graph with its offsets in a
    device buffer, replayed at each of ``offsets``: every replay's q and
    caches bit-equal to the plain version at that offset. Returns the
    replays."""
    import torch
    kern, ref, _ = kernels
    kw = dict(bias=t["bias"], norm=None, eps=t["cfg"].norm_eps)
    assert t["norm"] is None and t["rope"] is not None
    off = t["off"].clone()
    base = [c.clone() for c in t["cache"]]
    cache = [c.clone() for c in t["cache"]]
    rope = [x.clone() for x in t["rope"]]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kern(t["q"], t["k"], t["v"], cache_k=cache[0], cache_v=cache[1],
             offsets=off, rope=rope, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = kern(t["q"], t["k"], t["v"], cache_k=cache[0],
                   cache_v=cache[1], offsets=off, rope=rope, **kw)
    from repro_torch.models.common import rope_tables
    cfg = t["cfg"]
    C = t["q"].shape[0] // off.shape[0]
    for o in offsets:
        off.fill_(o)
        pos = off.long()[:, None] + torch.arange(C, device=off.device)
        for dst, src in zip(rope, rope_tables(pos, cfg.head_dim,
                                              cfg.rope_theta,
                                              cfg.rope_fraction)):
            dst.copy_(src.reshape(dst.shape))
        for c, b in zip(cache, base):
            c.copy_(b)
        graph.replay()
        wk, wv = (b.clone() for b in base)
        want = ref(t["q"], t["k"], t["v"], cache_k=wk, cache_v=wv,
                   offsets=off, rope=rope, **kw)
        torch.cuda.synchronize()
        for a, b in ((got, want), (cache[0], wk), (cache[1], wv)):
            assert same_bits(a, b), ("graph replay", o, ulp_gap(a, b))
    del graph
    return len(offsets)


def chunk_qkv_work(t: dict, rows: bool) -> tuple[int, float]:
    """The launch's bytes (q, k, v read, the biases, tables and offsets;
    q written, k and v into the caches, and into the rows with ``rows``)
    and operations (~8 an element of q and k, as the decode pass)."""
    N, H, Dh = t["q"].shape
    KV = t["k"].shape[1]
    esz = t["q"].element_size()
    tables = 0 if t["rope"] is None else 2 * t["rope"][0].numel() * 4
    nbytes = esz * (N * (H + 2 * KV) * Dh * 2
                    + (N * 2 * KV * Dh if rows else 0)
                    + ((H + 2 * KV) * Dh if t["bias"] is not None else 0)) \
        + tables + 4 * t["off"].numel()
    return nbytes, 8.0 * N * (H + KV) * Dh


def check_chunk_qkvs(gen, sheet: dict | None, device: str = "cuda",
                     kernels=None) -> dict:
    """Phase 2's checks of the chunk's qkv launch: path A's chunk (bf16,
    512 rows) at CHUNK_QKV_OFFSETS with and without the rows, then
    CHUNK_QKV_CASES in bf16 and fp32; on the card also a graph replayed
    at the three offsets and, with ``sheet``, the path-A chunk timed.
    Returns its record with ``max_abs_err`` (0: bit-equal)."""
    import torch
    kernels = kernels or chunk_qkv_kernels()
    gaps = {}
    main = None
    for o in CHUNK_QKV_OFFSETS:
        t = chunk_qkv_case(dict(CHUNK_QKV_MAIN, offs=(o,)), torch.bfloat16,
                           gen, device)
        for rows in (False, True):
            check_chunk_qkv(t, kernels, rows)
        main = t
    for case in CHUNK_QKV_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            t = chunk_qkv_case(case, dtype, gen, device)
            g = check_chunk_qkv(t, kernels, rows=case["arch"] ==
                                "musicgen-large")
            if g:
                gaps[f"{case['arch']} {str(dtype)[6:]}"] = g
    replays = chunk_qkv_graph(main, kernels, CHUNK_QKV_OFFSETS) \
        if torch.device(device).type == "cuda" else 0
    log(f"phase2 qkv_rope_chunk: bit-equal to the plain spelling (q, the "
        f"whole caches, the rows) at path A's chunk {CHUNK_QKV_MAIN} at "
        f"offsets {CHUNK_QKV_OFFSETS}, at {CHUNK_QKV_CASES[0]} and at each "
        f"paged family's width (nb 2, shared positions), bf16 and fp32; "
        f"{replays} replays of one graph at those offsets; the qk-normed q "
        f"against the all-plain spelling: {json.dumps(gaps)}")
    rec = dict(max_abs_err=0.0)
    if sheet is None:
        return rec
    kern, ref, _ = kernels
    t = main
    kw = dict(cache_k=t["cache"][0], cache_v=t["cache"][1],
              offsets=t["off"], bias=t["bias"], rope=t["rope"],
              eps=t["cfg"].norm_eps)
    bms, by = bound_ms(*chunk_qkv_work(t, False), sheet, "fp32")
    rec.update(ms=time_ms(lambda: kern(t["q"], t["k"], t["v"], **kw)),
               plain_ms=time_ms(lambda: ref(t["q"], t["k"], t["v"], **kw)),
               bound_ms=bms, bound_by=by, library_ms=None,
               device_ms=graph_ms(lambda: kern(t["q"], t["k"], t["v"],
                                               **kw)))
    return rec


# ------------------------------------------- phase 2: the Mamba2 kernels
#: zamba2's Mamba2 mixer (``csrc/mamba2.cu``): kernel -> (source, the
#: reference lines it computes: the decode branch with its epilogue, and
#: ``ssd_chunked``; no Pallas kernel, XLA's fusion of them)
MAMBA2 = {"mamba2_step": ("src/repro_torch/csrc/mamba2.cu",
                          "src/repro/models/mamba2.py:187"),
          "ssd_chunk": ("src/repro_torch/csrc/mamba2.cu",
                        "src/repro/models/mamba2.py:89")}
MAMBA2_ARCH = "zamba2-2.7b"
#: path E's decode batch; a row alone is held against the same row of a
#: B = 3 batch
MAMBA2_STEP_B = 2
#: (B, S): path E's 2000-token prompt (not a whole number of chunks) and a
#: 37-token extend, each from a nonzero state
MAMBA2_CHUNKS = ((2, 2000), (2, 37))
#: edges at smoke widths: zamba2 smoke's heads in two B/C groups, and
#: widths off the configs' (P 40, N 32, three groups, d_conv 3, chunk 24)
MAMBA2_EDGES = (dict(name="smoke_g2", H=8, P=16, N=16, G=2, K=4, chunk=16,
                     B=3, S=45),
                dict(name="odd", H=6, P=40, N=32, G=3, K=3, chunk=24, B=1,
                     S=50))
#: the unit roundoff of fp32
U32 = 2.0 ** -24
#: roundings a decode step's readout term passes, at most: 16 in a lane,
#: 2 in the lanes' tree, its product, the D skip's add
MAMBA2_STEP_DEPTH = 20
#: roundings a norm's sum of squares passes: 4 in a lane, 4 in the tree,
#: the 1 / P product
MAMBA2_NORM_DEPTH = 9
#: roundings a term of a prompt's y passes for each chunk the carried
#: state takes it across: the chunk's decay exp(total) (expf's 2 ulps),
#: its product with the state and the add of the chunk's summary
MAMBA2_CARRY_DEPTH = 4
#: roundings a term of a prompt's y passes once, beside its sums over the
#: chunk's tokens and over N: its operands' products (x dt, B decayed to
#: the chunk's end, the scores' decay) and their exps, the readout's
#: exp(cum) and product, the add of the chunk's and the state's terms
MAMBA2_CHUNK_EXTRA = 16


def mamba2_widths(cfg) -> dict:
    """``cfg``'s Mamba2 layer widths (H, P, N, G, K, chunk, eps)."""
    s = cfg.ssm
    return dict(H=s.expand * cfg.d_model // s.head_dim, P=s.head_dim,
                N=s.d_state, G=s.n_groups, K=s.d_conv, chunk=s.chunk,
                eps=cfg.norm_eps)


def mamba2_params(w: dict, dtype, gen, device) -> dict:
    """A layer's mixer parameters in ``dtype``, drawn as trained ones
    look: conv weights and bias, dt_bias around -1, A_log around 0.5, D
    around 1, a norm gain near 1."""
    import torch
    H, P, N, G, K = (w[k] for k in ("H", "P", "N", "G", "K"))
    C = H * P + 2 * G * N

    def rand(*shape, std=1.0, mean=0.0):
        return (torch.randn(shape, generator=gen, device=device) * std
                + mean).to(dtype)

    return dict(conv_w=rand(K, C, std=0.3), conv_b=rand(C, std=0.1),
                dt_bias=rand(H, std=0.5, mean=-1.0),
                A_log=rand(H, std=0.5, mean=0.5), D=rand(H, std=0.3,
                                                          mean=1.0),
                norm=rand(H, P, std=0.1))


def step_inputs(w: dict, B: int, dtype, gen, device) -> dict:
    """A decode step's in-products (z, x, bm, cm, the raw dt), the mixer's
    parameters and random conv and fp32 SSM states."""
    import torch
    H, P, N, G, K = (w[k] for k in ("H", "P", "N", "G", "K"))
    C = H * P + 2 * G * N

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    return dict(z=rand(B, H, P), x=rand(B, H * P), bm=rand(B, G * N),
                cm=rand(B, G * N), dt=rand(B, H),
                **mamba2_params(w, dtype, gen, device),
                conv_state=rand(B, K - 1, C),
                ssm_state=torch.randn((B, H, P, N), generator=gen,
                                      device=device))


def chunk_inputs(w: dict, B: int, S: int, dtype, gen, device) -> dict:
    """A prompt's SSD inputs as the model hands them over: xr, Bm and Cm
    slices of one (B, S, C) conv output after SiLU, dt after the softplus
    (fp32), z, the parameters and a random fp32 state."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.common import _silu
    H, P, N, G = (w[k] for k in ("H", "P", "N", "G"))
    HP, GN = H * P, G * N
    prm = mamba2_params(w, dtype, gen, device)
    conv = _silu(torch.randn((B, S, HP + 2 * GN), generator=gen,
                             device=device).to(dtype))
    dt = F.softplus(torch.randn((B, S, H), generator=gen, device=device)
                    + prm["dt_bias"].float())
    return dict(xr=conv[..., :HP].unflatten(-1, (H, P)), dt=dt,
                A_log=prm["A_log"],
                Bm=conv[..., HP:HP + GN].unflatten(-1, (G, N)),
                Cm=conv[..., HP + GN:].unflatten(-1, (G, N)),
                z=torch.randn((B, S, H, P), generator=gen,
                              device=device).to(dtype),
                D=prm["D"], norm=prm["norm"],
                state=torch.randn((B, H, P, N), generator=gen,
                                  device=device))


def out_ulp(t, dtype):
    """One ulp of ``dtype`` at |t| (float64; 0 for fp32, whose rounding
    the fp32 terms already count)."""
    import torch
    from repro_torch.kernels.fusions.ref import bf16_ulp
    return bf16_ulp(t) if dtype == torch.bfloat16 else torch.zeros_like(t)


def mamba2_tolerance(y, y_abs, depth, xs, z, D, norm, eps: float):
    """|kernel y - plain y| allowed at each element (float64) when the two
    sum the same pre-epilogue y (..., H, P) in other fp32 orders: each
    within gamma_d = d u / (1 - d u) of sum |terms| = ``y_abs`` (``depth``
    d: the roundings a term passes, a tensor or a number) and the D
    skip's |x D|, so the two y2 = y + x D within e = 2 gamma_d (y_abs +
    |x D|); rounded to the compute dtype, within e and one of its ulps;
    the gate's product by |SiLU(z)|, and its own rounding; the norm's
    mean square m moved by mean(2 |g| dg + dg^2) and its own sum
    (MAMBA2_NORM_DEPTH roundings, both sides), so rsqrt by half of that
    over m + eps and its own 2 ulps a side; the output g rs (1 + w)
    moved by |1 + w| (rs dg + |g| rs drs), its two roundings, and one
    ulp of the dtype where it rounds."""
    import torch
    from repro_torch.models.common import _silu
    dtype = z.dtype
    depth = torch.as_tensor(depth, dtype=torch.float64, device=y.device)
    gam = depth * U32 / (1 - depth * U32)
    skip = xs.double() * D.double()[:, None]
    y2 = y.double() + skip
    e = 2 * gam * (y_abs.double() + skip.abs())
    dyr = e + out_ulp(y2.abs() + e, dtype)
    zs = _silu(z).double()
    g = y2.to(dtype).double() * zs
    dg = zs.abs() * dyr + 2 * U32 * g.abs()
    ms = (g * g).mean(-1, keepdim=True)
    dms = (2 * g.abs() * dg + dg * dg).mean(-1, keepdim=True) \
        + 2 * MAMBA2_NORM_DEPTH * U32 * ms
    rs = torch.rsqrt(ms + eps)
    drs = 0.5 * dms / (ms + eps) + 6 * U32
    gain = (1.0 + norm.double()).abs()
    out = g * rs * gain
    tol = gain * (rs * dg + g.abs() * rs * drs) + 4 * U32 * out.abs()
    return tol + out_ulp(out.abs() + tol, dtype)


def tolerance_ratio(gap, tol) -> float:
    """The largest gap over its tolerance; an element whose tolerance is
    0 (an exact zero both sides must give) fails at any gap."""
    return (gap / tol.clamp_min(2.0 ** -1022)).max().item()


def run_step(fn, inp: dict, eps: float) -> tuple:
    """``fn`` on copies of ``inp``'s states: (y, conv state, SSM state)."""
    cs, ss = inp["conv_state"].clone(), inp["ssm_state"].clone()
    args = {k: v for k, v in inp.items()
            if k not in ("conv_state", "ssm_state")}
    y = fn(**args, conv_state=cs, ssm_state=ss, eps=eps)
    return y, cs, ss


def check_mamba2_step(w: dict, B: int, dtype, gen, device: str = "cuda",
                      launch=None, rows: bool = True) -> dict:
    """The decode step against its plain version from the same inputs:
    the new conv and SSM states bit-equal, y finite and each element
    within its ``mamba2_tolerance`` (the readout's terms |C_n h_pn| from
    the plain version's own new state); with ``rows``, row 1 of a B = 3
    call bit-equal (y and both states) to the same row called alone.
    Returns the largest |gap|, the largest tolerance and the largest gap
    over its tolerance."""
    import torch
    from repro_torch.kernels.mamba2 import (mamba2_step_kernel,
                                            mamba2_step_ref, step_core_ref)
    fn = launch or mamba2_step_kernel
    eps = w["eps"]
    inp = step_inputs(w, B, dtype, gen, device)
    y, cs, ss = run_step(fn, inp, eps)
    yr, csr, ssr = run_step(mamba2_step_ref, inp, eps)
    assert same_bits(cs, csr), ("mamba2_step", dtype, "conv state")
    assert same_bits(ss, ssr), ("mamba2_step", dtype, "SSM state")
    assert torch.isfinite(y).all(), ("mamba2_step", dtype, "not finite")
    core_in = {k: inp[k] for k in ("x", "bm", "cm", "dt", "conv_w",
                                   "conv_b", "dt_bias", "A_log")}
    pre, xs, Ch, new = step_core_ref(
        **core_in, conv_state=inp["conv_state"].clone(),
        ssm_state=inp["ssm_state"].clone())
    y_abs = torch.einsum("bhn,bhpn->bhp", Ch.double().abs(),
                         new.double().abs())
    tol = mamba2_tolerance(pre, y_abs, MAMBA2_STEP_DEPTH, xs, inp["z"],
                           inp["D"], inp["norm"], eps)
    gap = (y.double() - yr.double()).abs()
    ratio = tolerance_ratio(gap, tol)
    assert ratio <= 1.0, ("mamba2_step", dtype, gap.max().item(), ratio)
    if rows:
        three = step_inputs(w, 3, dtype, gen, device)
        yb, csb, ssb = run_step(fn, three, eps)
        one = {k: v[1:2].clone() if k in ("z", "x", "bm", "cm", "dt",
                                          "conv_state", "ssm_state")
               else v for k, v in three.items()}
        ya, csa, ssa = run_step(fn, one, eps)
        for a, b, what in ((ya[0], yb[1], "y"), (csa[0], csb[1], "conv"),
                           (ssa[0], ssb[1], "ssm")):
            assert same_bits(a, b), ("mamba2_step", dtype, what,
                                     "row 1 alone")
    return dict(max_abs_err=gap.max().item(), tolerance=tol.max().item(),
                gap_over_tolerance=ratio)


def chunk_depth(S: int, w: dict, device):
    """Roundings a term of token t's y passes, at most: one sum over a
    chunk's L tokens and one over N (the scores and their product with
    x, or a summary and the state's readout), MAMBA2_CARRY_DEPTH for each
    of the t // L chunks the state carries it across, and
    MAMBA2_CHUNK_EXTRA. An error the state carries was added in once and
    then only decays, so a chunk adds its carry's roundings, not its
    sums: about 270 at token 2000 of zamba2's L = N = 64."""
    import torch
    t = torch.arange(S, device=device, dtype=torch.float64)
    return (w["chunk"] + w["N"] + MAMBA2_CHUNK_EXTRA + MAMBA2_CARRY_DEPTH
            * (t // w["chunk"]))[None, :, None, None]


def mamba2_chunk_call(w: dict, launch=None):
    """``launch(xr, dt, A_log, Bm, Cm, z, D, norm, state)`` at ``w``'s
    chunk and eps: the kernel, or a stand-in."""
    from repro_torch.kernels.mamba2 import ssd_chunk_kernel
    fn = launch or ssd_chunk_kernel
    return lambda *a: fn(*a, chunk=w["chunk"], eps=w["eps"])


def check_ssd_chunk(w: dict, B: int, S: int, dtype, gen,
                    device: str = "cuda", launch=None,
                    rows: bool = True) -> dict:
    """The prompt's SSD against its plain version from the same inputs and
    state: y finite and each element within its ``mamba2_tolerance`` (the
    terms' magnitudes from the plain SSD over |x|, |B|, |C| and |state|
    in float64); the final state within 2 gamma_d of its own magnitudes
    (d the last token's depth); the state overwritten in place; with
    ``rows``, row 1 of a B = 3 call bit-equal to the row alone."""
    import torch
    from repro_torch.kernels.mamba2 import ssd_chunk_ref, ssd_ref
    call = mamba2_chunk_call(w, launch)
    inp = chunk_inputs(w, B, S, dtype, gen, device)
    order = ("xr", "dt", "A_log", "Bm", "Cm", "z", "D", "norm")
    args = [inp[k] for k in order]
    state = inp["state"].clone()
    y, final = call(*args, state)
    assert final.data_ptr() == state.data_ptr(), "state not in place"
    ref_state = inp["state"].clone()
    yr, fr = ssd_chunk_ref(*args, ref_state, chunk=w["chunk"], eps=w["eps"])
    assert torch.isfinite(y).all() and torch.isfinite(final).all(), \
        ("ssd_chunk", dtype, S, "not finite")
    pre, _ = ssd_ref(inp["xr"], inp["dt"], inp["A_log"], inp["Bm"],
                     inp["Cm"], inp["state"], chunk=w["chunk"])
    absd = ssd_ref(inp["xr"].abs(), inp["dt"], inp["A_log"],
                   inp["Bm"].abs(), inp["Cm"].abs(), inp["state"].abs(),
                   chunk=w["chunk"], acc=torch.float64)
    depth = chunk_depth(S, w, device)
    tol = mamba2_tolerance(pre, absd[0], depth, inp["xr"], inp["z"],
                           inp["D"], inp["norm"], w["eps"])
    gap = (y.double() - yr.double()).abs()
    ratio = tolerance_ratio(gap, tol)
    assert ratio <= 1.0, ("ssd_chunk", dtype, S, gap.max().item(), ratio)
    d = float(depth.max())
    stol = 2 * d * U32 / (1 - d * U32) * absd[1]
    sratio = tolerance_ratio((final.double() - fr.double()).abs(), stol)
    assert sratio <= 1.0, ("ssd_chunk", dtype, S, "state", sratio)
    if rows:
        three = chunk_inputs(w, 3, S, dtype, gen, device)
        targs = [three[k] for k in order]
        yb, sb = call(*targs, three["state"].clone())
        one = [t[1:2].clone() if t.dim() >= 3 else t for t in targs]
        ya, sa = call(*one, three["state"][1:2].clone())
        assert same_bits(ya[0], yb[1]) and same_bits(sa[0], sb[1]), \
            ("ssd_chunk", dtype, S, "row 1 alone")
    return dict(max_abs_err=gap.max().item(), tolerance=tol.max().item(),
                gap_over_tolerance=ratio, state_gap_over_tolerance=sratio)


def tf32(t):
    """``t`` rounded to TF32 (10 mantissa bits, to nearest even), in
    float32: what a TF32 product reads of an fp32 operand."""
    import torch
    i = t.float().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def planted_mamba2_faults(gen, device: str = "cuda") -> list[str]:
    """Stand-ins that each break one thing, every one of which the checks
    must fail: the decode step without its D skip (y off), with its state
    not decayed (the state's bits), the SSD without its carried-in state
    (y off), without its D skip, and (fp32 only) on TF32-rounded
    operands, as TF32 products would read them: on the card at zamba2's
    widths over path E's B 2 x 2000-token prompt, off it at the first
    edge's. Returns the faults caught."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.mamba2 import mamba2_step_ref, ssd_chunk_ref
    w = dict(MAMBA2_EDGES[0], eps=1e-5)
    if torch.device(device).type == "cuda":
        wt, (Bt, St) = mamba2_widths(get_config(MAMBA2_ARCH)), \
            MAMBA2_CHUNKS[0]
    else:
        wt, Bt, St = w, 2, w["S"]

    def no_skip(**kw):
        return mamba2_step_ref(**dict(kw, D=torch.zeros_like(kw["D"])))

    def no_decay(**kw):
        return mamba2_step_ref(**dict(kw, A_log=torch.full_like(
            kw["A_log"], float("-inf"))))

    def no_carry(xr, dt, A_log, Bm, Cm, z, D, norm, state, **kw):
        y, final = ssd_chunk_ref(xr, dt, A_log, Bm, Cm, z, D, norm, None,
                                 **kw)
        return y, state.copy_(final)

    def chunk_no_skip(xr, dt, A_log, Bm, Cm, z, D, norm, state, **kw):
        return ssd_chunk_ref(xr, dt, A_log, Bm, Cm, z, torch.zeros_like(D),
                             norm, state, **kw)

    def chunk_tf32(xr, dt, A_log, Bm, Cm, z, D, norm, state, **kw):
        y, final = ssd_chunk_ref(
            tf32(xr).view(xr.shape), tf32(dt).view(dt.shape), A_log,
            tf32(Bm).view(Bm.shape), tf32(Cm).view(Cm.shape), z, D, norm,
            tf32(state).view(state.shape), **kw)
        return y, state.copy_(final)

    both = (torch.bfloat16, torch.float32)
    caught = []
    for name, dtypes, run in (
            ("step_no_skip", both, lambda dt: check_mamba2_step(
                w, 2, dt, gen, device, no_skip, rows=False)),
            ("step_no_decay", both, lambda dt: check_mamba2_step(
                w, 2, dt, gen, device, no_decay, rows=False)),
            ("chunk_no_carry", both, lambda dt: check_ssd_chunk(
                w, 2, w["S"], dt, gen, device, no_carry, rows=False)),
            ("chunk_no_skip", both, lambda dt: check_ssd_chunk(
                w, 2, w["S"], dt, gen, device, chunk_no_skip,
                rows=False)),
            ("chunk_tf32", (torch.float32,), lambda dt: check_ssd_chunk(
                wt, Bt, St, dt, gen, device, chunk_tf32, rows=False))):
        for dtype in dtypes:
            try:
                run(dtype)
            except AssertionError:
                continue
            raise AssertionError(f"planted fault {name} ({dtype}) passed")
        caught.append(name)
    return caught


def plain_step_chain(inp: dict, cfg):
    """The plain spelling's decode step after the in-products
    (``models/mamba2.py``, ``fused=False``) at ``cfg``'s widths: the
    conv, SiLU, softplus, the recurrence, the epilogue; the states
    written back as the model's cache copy does. What ``mamba2_step``
    replaces."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import mamba2
    from repro_torch.models.common import _silu
    w = mamba2_widths(cfg)
    H, P, N, G = (w[k] for k in ("H", "P", "N", "G"))
    HP, GN = H * P, G * N
    conv, new_conv = mamba2._causal_conv(
        torch.cat([inp["x"], inp["bm"], inp["cm"]], dim=-1)[:, None],
        inp["conv_w"], inp["conv_b"], inp["conv_state"])
    conv = _silu(conv)
    xr = conv[..., :HP].unflatten(-1, (H, P))
    dt = F.softplus(inp["dt"][:, None].float() + inp["dt_bias"].float())
    y, new = mamba2._ssd(xr, dt, -torch.exp(inp["A_log"].float()),
                         conv[..., HP:HP + GN].unflatten(-1, (G, N)),
                         conv[..., HP + GN:].unflatten(-1, (G, N)),
                         inp["ssm_state"].float(), chunk=w["chunk"],
                         mode="decode")
    out = mamba2._gate_norm(y, xr, inp["z"][:, None], inp, cfg)
    inp["conv_state"].copy_(new_conv)
    inp["ssm_state"].copy_(new)
    return out


def plain_chunk_chain(inp: dict, cfg):
    """The plain spelling's SSD with its epilogue (``ssd_chunked``, the
    D skip, gate and norm; ``fused=False``) at ``cfg``'s chunk, the state
    written back as the model's cache copy does. What ``ssd_chunk``
    replaces."""
    import torch
    from repro_torch.models import mamba2
    y, new = mamba2._ssd(inp["xr"], inp["dt"],
                         -torch.exp(inp["A_log"].float()), inp["Bm"],
                         inp["Cm"], inp["state"], chunk=cfg.ssm.chunk,
                         mode="prefill")
    out = mamba2._gate_norm(y, inp["xr"], inp["z"], inp, cfg)
    inp["state"].copy_(new)
    return out


def mamba2_share(cfg, device) -> float:
    """The share of the Mamba2 kernels' y elements that leave the plain
    spelling's bits at ``cfg``'s widths in bf16 (P14's count for path
    E's bound): the decode step at path E's batch and the SSD over a
    2000-token prompt, each from random states, the larger share; 0 off
    the card (both legs there run the plain spelling) and where the model
    has no Mamba2 layer."""
    import torch
    from repro_torch.kernels.mamba2 import mamba2_step_kernel
    if torch.device(device).type != "cuda" or cfg.family != "hybrid":
        return 0.0
    w = mamba2_widths(cfg)
    gen = torch.Generator(device=device).manual_seed(zlib.crc32(
        f"mamba2 {cfg.name}".encode()))
    inp = step_inputs(w, MAMBA2_STEP_B, torch.bfloat16, gen, device)
    y, _, _ = run_step(mamba2_step_kernel, inp, w["eps"])
    plain = plain_step_chain({k: v.clone() for k, v in inp.items()}, cfg)
    shares = [ulp_gap(y, plain[:, 0])]
    B, S = MAMBA2_CHUNKS[0]
    cin = chunk_inputs(w, B, S, torch.bfloat16, gen, device)
    yc, _ = mamba2_chunk_call(w)(*(cin[k] for k in (
        "xr", "dt", "A_log", "Bm", "Cm", "z", "D", "norm")),
        cin["state"].clone())
    shares.append(ulp_gap(yc, plain_chunk_chain(dict(cin), cfg)))
    return max(s["differ"] / s["n"] for s in shares)


def time_mamba2(cfg, gen, sheet: dict) -> dict:
    """Both kernels at zamba2-2.7b's widths in bf16, path E's shapes: the
    decode step at B 2 and the SSD over a B 2 x 2000-token prompt, each
    by an eager loop (``ms``) and by CUDA-graph replay (``device_ms``),
    beside the plain chain each replaces (``plain_ms``,
    ``plain_device_ms``) and the bound; no one PyTorch call computes
    either (``library_ms`` None)."""
    import torch
    from repro_torch.kernels.mamba2 import (mamba2_step_kernel,
                                            ssd_chunk_kernel)
    from repro_torch.kernels.mamba2.kernel import chunk_work, step_work
    out = {}
    w = mamba2_widths(cfg)
    H, P, N, G, K = (w[k] for k in ("H", "P", "N", "G", "K"))
    B = MAMBA2_STEP_B
    inp = step_inputs(w, B, torch.bfloat16, gen, "cuda")
    args = {k: v for k, v in inp.items()
            if k not in ("conv_state", "ssm_state")}

    def step():
        return mamba2_step_kernel(**args, conv_state=inp["conv_state"],
                                  ssm_state=inp["ssm_state"], eps=w["eps"])

    plain_in = {k: v.clone() for k, v in inp.items()}
    nbytes, ops = step_work(B, H, P, N, G, K, 2)
    bms, by = bound_ms(nbytes, ops, sheet, "fp32")
    out["mamba2_step"] = dict(
        ms=time_ms(step), device_ms=graph_ms(step),
        plain_ms=time_ms(lambda: plain_step_chain(plain_in, cfg)),
        plain_device_ms=graph_ms(lambda: plain_step_chain(plain_in, cfg)),
        bound_ms=bms, bound_by=by, library_ms=None, bytes=nbytes)
    Bc, S = MAMBA2_CHUNKS[0]
    cin = chunk_inputs(w, Bc, S, torch.bfloat16, gen, "cuda")
    cargs = [cin[k] for k in ("xr", "dt", "A_log", "Bm", "Cm", "z", "D",
                              "norm")]

    def chunk():
        return ssd_chunk_kernel(*cargs, cin["state"], chunk=w["chunk"],
                                eps=w["eps"])

    plain_c = dict(cin, state=cin["state"].clone())
    nbytes, ops = chunk_work(Bc, S, H, P, N, G, w["chunk"], 2)
    bms, by = bound_ms(nbytes, ops, sheet, "fp32")
    out["ssd_chunk"] = dict(
        ms=time_ms(chunk, iters=10), device_ms=graph_ms(chunk, iters=10),
        plain_ms=time_ms(lambda: plain_chunk_chain(plain_c, cfg), iters=3,
                         warmup=1),
        plain_device_ms=graph_ms(lambda: plain_chunk_chain(plain_c, cfg),
                                 iters=3, warmup=1, reps=2),
        bound_ms=bms, bound_by=by, library_ms=None, flops=ops)
    return out


def check_mamba2s(gen, sheet: dict | None, device: str = "cuda",
                  launches: tuple | None = None) -> dict:
    """Phase 2's Mamba2 kernels: the decode step at zamba2-2.7b's widths
    (B 2, a row alone against a B = 3 batch) and the SSD at MAMBA2_CHUNKS
    from a nonzero state, both in bf16 and fp32, then MAMBA2_EDGES, each
    against its plain version (``check_mamba2_step``,
    ``check_ssd_chunk``); the planted faults each failing; with
    ``sheet``, the timed records (``time_mamba2``). ``launches``:
    (step, chunk) stand-ins for a CPU run. Returns {kernel: record}."""
    import torch
    from repro_torch.configs import get_config
    step_fn, chunk_fn = launches or (None, None)
    rows = launches is None
    cfg = get_config(MAMBA2_ARCH)
    w = mamba2_widths(cfg)
    errs = {"mamba2_step": [], "ssd_chunk": []}
    cases = [(w, MAMBA2_STEP_B, MAMBA2_CHUNKS)] + [
        (dict(e, eps=w["eps"]), e["B"], ((e["B"], e["S"]),))
        for e in MAMBA2_EDGES]
    for ws, B, chunks in cases:
        for dtype in (torch.bfloat16, torch.float32):
            got = check_mamba2_step(ws, B, dtype, gen, device, step_fn, rows)
            errs["mamba2_step"].append(got)
            log(f"phase2 mamba2_step {ws.get('name', MAMBA2_ARCH)} "
                f"(H {ws['H']}, P {ws['P']}, N {ws['N']}, G {ws['G']}, K "
                f"{ws['K']}) B {B} {dtype}: new states bit-equal, "
                f"{json.dumps(got)}")
            for Bc, S in chunks:
                got = check_ssd_chunk(ws, Bc, S, dtype, gen, device,
                                      chunk_fn, rows)
                errs["ssd_chunk"].append(got)
                log(f"phase2 ssd_chunk {ws.get('name', MAMBA2_ARCH)} B "
                    f"{Bc} S {S} chunk {ws['chunk']} {dtype}: "
                    f"{json.dumps(got)}")
            if device == "cuda":
                torch.cuda.empty_cache()
    caught = planted_mamba2_faults(gen, device)
    log(f"phase2 mamba2: planted faults failing the checks: {caught}")
    records = {}
    timed = time_mamba2(cfg, gen, sheet) if sheet is not None else {}
    for name, got in errs.items():
        records[name] = dict(
            timed.get(name, {}),
            max_abs_err=max(g["max_abs_err"] for g in got),
            gap_over_tolerance=max(g["gap_over_tolerance"] for g in got))
    return records


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
        f"tokens; merged: the token merged in the launch, the decode "
        f"step's call): {json.dumps(dict(max_abs_err=err, **rec))}; device "
        f"ms by split length: {json.dumps(decode_split_times(serve))}")
    records["paged_decode_attention"].update(
        serve_device_ms=rec["device_ms"],
        serve_merged_device_ms=rec["merged_device_ms"])
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
    records["token_append_indexed"]["max_abs_err"] = max(
        records["token_append_indexed"]["max_abs_err"],
        check_append_indexed_refusals(gen))
    log(f"phase2 token_append_indexed: {APPEND_WIDE['B']} rows in one "
        f"launch bit-exact; int64, 2-D, short, strided and host slots "
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
    err, rec = check_extend(FLASH_EXTEND, torch.bfloat16, gen, True, sheet)
    by_slices = rec.pop("device_ms_by_slices")
    records["flash_extend"] = dict(max_abs_err=err, **rec)
    log(f"phase2 flash_extend (bf16) at path A's chunk: {rec['slices']} "
        f"slices, {rec['ctas']} CTAs of two warpgroups (heads paired: "
        f"{rec['pair']}); device ms by forced slice count, each within "
        f"1e-2 of the plain version: {json.dumps(by_slices)}")
    for dtype in (torch.bfloat16, torch.float32):
        gaps = check_extend_graph(FLASH_EXTEND, dtype, gen)
        log(f"phase2 flash_extend {dtype}: one graph replayed at offsets "
            f"{EXTEND_GRAPH_OFFSETS}, bit-equal to eager launches; max "
            f"|diff| from the plain version {json.dumps(gaps)}")
    check_extend_refusals(gen)
    log("phase2 flash_extend: int64, two, 2-D and host offsets, a "
        "misaligned stride and head dim 100 refused")
    for shape in (FLASH_EXTEND,) + FLASH_EXTEND_EDGES:
        for dtype in (torch.bfloat16, torch.float32):
            if shape is FLASH_EXTEND and dtype == torch.bfloat16:
                continue                                  # checked above
            err, _ = check_extend(shape, dtype, gen, False, sheet)
            log(f"phase2 flash_extend {shape} {dtype}: max_abs_err "
                f"{err:.3g}, finite over NaN dead slots, layout-invariant")
            records["flash_extend"]["max_abs_err"] = max(
                records["flash_extend"]["max_abs_err"], err)
            torch.cuda.empty_cache()
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
    t0 = time.perf_counter()
    records["dense_decode_attention"] = check_dense_decodes(gen, sheet)
    records.update(check_fusions(gen, sheet))
    records["paged_decode_attention"]["merge_max_abs_err"] = records.pop(
        "decode_merge")["max_abs_err"]
    log(f"phase2 paged_decode_attention: ticket counters all zero after "
        f"graph replays with the token merged: "
        f"{json.dumps(check_decode_counters(gen))}")
    gu = records["gate_up_act"]
    log(f"phase2 gate_up_act at the serve step (4 rows, qwen2-1.5b, bf16, "
        f"weights cold): device {gu['device_ms']:.4f} ms, plan "
        f"{json.dumps(gu['plan'])}; the parent's route (two cuBLAS "
        f"products, then gated_act_kernel) before and after "
        f"{json.dumps(gu['parent_route_device_ms'])}; two torch.matmul and "
        f"F.silu(g) * u {gu['library_device_ms']:.4f}; bound "
        f"{gu['bound_ms']:.4f}")
    qp = records["qkv_proj"]
    log(f"phase2 qkv_proj at the serve step (4 rows, qwen2-1.5b, bf16, "
        f"weights cold): device {qp['device_ms']:.4f} ms, plan "
        f"{json.dumps(qp['plan'])}; the parent's route (three cuBLAS "
        f"products, then qkv_rope_kernel) before and after "
        f"{json.dumps(qp['parent_route_device_ms'])}; one torch.matmul "
        f"against the concatenated weights (no chain) "
        f"{qp['library_device_ms']:.4f}; bound {qp['bound_ms']:.4f}")
    norm = records["rms_norm"]
    log(f"phase2 rms_norm device {norm['device_ms']:.4f} ms at "
        f"{FUSION_TIMED_ROWS} rows beside an empty kernel's launch "
        f"{norm['launch_floor_device_ms']:.4f} ms (CUDA-graph replay) and "
        f"its bound {norm['bound_ms']:.7f} ms; {NORM_WIDE_ROWS} rows "
        f"{norm['device_ms_wide']:.4f} ms (bound "
        f"{norm['bound_ms_wide']:.5f} ms)")
    wide = {k: v for k, v in records["gated_act"].items()
            if k.endswith(tuple(GATED_ACT_WIDE))}
    log(f"phase2 gated_act device ms (CUDA-graph replay) at the rows its "
        f"launches run, beside its bound: {json.dumps(wide)}")
    records["qkv_rope_chunk"] = check_chunk_qkvs(gen, sheet)
    log(f"phase2 fusions checked and timed in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records.update(check_mamba2s(gen, sheet))
    for name in MAMBA2:
        rec = records[name]
        log(f"phase2 {name} at zamba2-2.7b's widths (bf16): device "
            f"{rec['device_ms']:.4f} ms by graph replay, eager "
            f"{rec['ms']:.4f}; the plain chain it replaces device "
            f"{rec['plain_device_ms']:.4f}, eager {rec['plain_ms']:.4f}; "
            f"bound {rec['bound_ms']:.5f} ({rec['bound_by']}); largest gap "
            f"over its tolerance {rec['gap_over_tolerance']:.3g}")
    log(f"phase2 mamba2 kernels checked and timed in "
        f"{time.perf_counter() - t0:.1f} s")
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


def serve_measured(cfg, hw, model, device, graphs: bool = True,
                   fused: bool = True):
    """Phase 3b: the same programs on the measured clock, the decode step
    graphed or (``graphs=False``) eager, its chains fused or (``fused=
    False``) plain."""
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
    backend.runtime.cuda_graphs = graphs
    backend.runtime.fused = fused
    eng = Engine(cfg, ecfg, hw, backend=backend, cost=cost)
    progs = agent_programs()
    router = Router([eng])
    router.register_programs(progs)
    sim = Simulator([eng], router, max_seconds=rc.max_seconds)
    sim.add_programs(progs)
    summary = sim.run()
    return eng, summary, len(progs)


def serve_pair_leg(cfg, hw, model, device, graphs: bool,
                   fused: bool = True) -> dict:
    """3b again with the decode step and the prefill chunk graphed or
    eager, the decode step's chains fused or plain, to pair them in one
    call: JCT and TTFT on the measured clock, engine busy seconds and
    steps, each graph family's captures, their seconds (inside the busy
    seconds) and replays, the prefill buckets, the graph pool's bytes and
    the leg's launch counts."""
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    t0 = time.perf_counter()
    eng, summary, n_progs = serve_measured(cfg, hw, model, device, graphs,
                                           fused)
    wall = time.perf_counter() - t0
    after = launch_counts()
    assert summary.n_programs == n_progs == len(eng.programs)
    rt = eng.backend.runtime
    g, pg = rt.graphs, rt.prefill_graphs
    return dict(cuda_graphs=graphs, fused=fused, avg_jct_s=summary.avg_jct,
                p90_jct_s=summary.p90_jct, avg_ttft_s=summary.avg_ttft,
                steps=eng.steps, busy_s=eng.busy_seconds, wall_s=wall,
                captures=g.captures, capture_s=g.capture_s,
                replays=g.replays, prefill_captures=pg.captures,
                prefill_capture_s=pg.capture_s, prefill_replays=pg.replays,
                prefill_buckets=len(pg.buckets()),
                graph_pool_bytes=g.pool_bytes(),
                launches={k: after[k] - before[k] for k in after})


def runtime_state(rt) -> dict:
    """A copy of everything a decode step reads or changes in ``rt``."""
    return dict(k=rt.k_pages.clone(), v=rt.v_pages.clone(),
                free=list(rt.free), refs=dict(rt.refs),
                programs={pid: dataclasses.replace(e, pages=list(e.pages))
                          for pid, e in rt.programs.items()},
                last={pid: t.clone() for pid, t in rt._last.items()},
                cow_splits=rt.cow_splits)


def restore_state(rt, st: dict) -> None:
    """Put ``runtime_state``'s copy back, the pools in place (their
    addresses, which the graphs hold, unchanged)."""
    rt.k_pages.copy_(st["k"])
    rt.v_pages.copy_(st["v"])
    rt.free, rt.refs = list(st["free"]), dict(st["refs"])
    rt.programs = {pid: dataclasses.replace(e, pages=list(e.pages))
                   for pid, e in st["programs"].items()}
    rt._last = {pid: t.clone() for pid, t in st["last"].items()}
    rt.cow_splits = st["cow_splits"]


def add_twin(rt, twin: str, of: str) -> None:
    """``twin``: a program on ``of``'s pages (refcounts bumped), so the
    first write of either to their shared last page COW-splits it."""
    from repro_torch.serving.paged_runtime import ProgramEntry
    src = rt.programs[of]
    for pi in src.pages:
        rt.refs[pi] += 1
    rt.programs[twin] = ProgramEntry(list(src.pages), src.length)
    rt._last[twin] = rt._last[of].clone()


def decode_leg(rt, model, schedule, device, graphs: bool) -> dict:
    """The schedule's decode steps with ``rt.cuda_graphs = graphs``: each
    step's logits and next tokens, its wall ms (ending in a device sync),
    whether it captured a graph, the graph pool's bytes after it, the
    launch counts of the leg and the pools at its end."""
    import torch
    from repro_torch.kernels import launch_counts
    rt.cuda_graphs = graphs
    before = launch_counts()
    steps = []
    for count, rows in schedule:
        pids = [f"p{i}" for i in rows]
        for _ in range(count):
            e = [rt.programs[pid] for pid in pids]
            ps = rt.page_size
            pages = max(max(len(x.pages), -(-(x.length + 1) // ps))
                        for x in e)
            n_tab = 1 << max(0, pages - 1).bit_length()
            offs = [x.length % ps for x in e]
            captures = rt.graphs.captures
            synchronize(device)
            t0 = time.perf_counter()
            logits = torch.stack(rt.decode_batch(model, pids))
            synchronize(device)
            steps.append(dict(
                ms=1e3 * (time.perf_counter() - t0), B=len(pids),
                n_tab=n_tab, offsets=offs, logits=logits,
                nxt=torch.stack([rt._last[pid] for pid in pids]),
                captured=rt.graphs.captures > captures,
                pool_bytes=rt.graphs.pool_bytes()))
    after = launch_counts()
    return dict(steps=steps, pools=(rt.k_pages.clone(), rt.v_pages.clone()),
                launches={k: after[k] - before[k] for k in after})


def graph_vs_eager(model, device, prompts, schedule, seed: int = 0,
                   fused: bool = True) -> dict:
    """The paged runtime's decode step, eager (``cuda_graphs=False``) and
    graphed, over the same steps from the same state: programs p0.. of
    ``prompts`` tokens (seeded), p<n> a twin of p1 on its pages (p1's
    first append COW-splits), ``schedule`` the steps as (count, rows).
    The state is snapshot after the prefills and restored between the
    legs. ``fused``: the runtime's, the step's chains fused or plain.
    Returns the comparison, the buckets, the captures and their seconds,
    the graph pool's bytes, the median wall ms of an eager step and of a
    replayed one, and each leg's launch counts (with the capture's cost
    when fused, as served)."""
    import numpy as np
    import torch
    from repro_torch.serving.paged_runtime import PagedKVRuntime
    cfg = model.cfg
    steps = sum(c for c, _ in schedule)
    rt = PagedKVRuntime(cfg, n_pages=sum(-(-(n + steps) // 16) + 1
                                         for n in prompts) + 8,
                        page_size=16, device=device, fused=fused)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(prompts):
        rt.prefill(model, f"p{i}", torch.from_numpy(
            rng.integers(0, cfg.vocab_size, n)))
    add_twin(rt, f"p{len(prompts)}", "p1")
    st = runtime_state(rt)
    eager = decode_leg(rt, model, schedule, device, graphs=False)
    cow_eager = rt.cow_splits - st["cow_splits"]
    restore_state(rt, st)
    graph = decode_leg(rt, model, schedule, device, graphs=True)
    rt.check()
    es, gs = eager["steps"], graph["steps"]
    replayed = [g["ms"] for g in gs if not g["captured"]]
    pool = [g["pool_bytes"] for g in gs]
    out = dict(
        fused=fused, fusions=fused_names(cfg) if fused else [],
        steps=len(gs),
        logits_equal=all(torch.equal(a["logits"], b["logits"])
                         for a, b in zip(es, gs)),
        nxt_equal=all(torch.equal(a["nxt"], b["nxt"]) for a, b in zip(es, gs)),
        pools_equal=all(torch.equal(a, b) for a, b in zip(eager["pools"],
                                                          graph["pools"])),
        finite=all(bool(torch.isfinite(g["logits"]).all()) for g in gs),
        buckets=sorted({(g["B"], g["n_tab"]) for g in gs}),
        page_boundary=any(o == 0 for g in gs for o in g["offsets"]),
        cow_splits=(cow_eager, rt.cow_splits - st["cow_splits"]),
        captures=rt.graphs.captures,
        capture_s=rt.graphs.capture_s,
        pool_bytes=pool[-1],
        pool_grew_on_replay=any(
            b["pool_bytes"] != a["pool_bytes"]
            for a, b in zip(gs, gs[1:]) if not b["captured"]),
        eager_ms_median=float(np.median([e["ms"] for e in es[1:]])),
        replay_ms_median=float(np.median(replayed)) if replayed else None,
        launches_eager=eager["launches"], launches_graph=graph["launches"])
    if torch.device(device).type == "cuda" and fused:
        b = max(rt.graphs.buckets().values(), key=lambda b: b.tables.numel())
        out["capture_cost"] = capture_cost(rt, lambda: rt._decode_step(
            model, *b.inputs(), out=(b.logits, b.nxt)), "p0")
    del rt
    return out


def assert_graph_vs_eager(check: dict, cuda: bool) -> None:
    """Bitwise equal, across a bucket change, a page boundary and a COW
    split; on the card every bucket captured once, the replays growing
    no pool, and both legs appending through the indexed launch alone,
    once a step."""
    assert check["logits_equal"] and check["nxt_equal"], check
    assert check["pools_equal"] and check["finite"], check
    assert len(check["buckets"]) >= 2 and check["page_boundary"], check
    assert check["cow_splits"][0] == check["cow_splits"][1] >= 1, check
    le, lg = check["launches_eager"], check["launches_graph"]
    if cuda:
        assert check["captures"] == len(check["buckets"]), check
        assert not check["pool_grew_on_replay"], check
        for leg in (le, lg):
            assert leg["token_append_indexed"] == check["steps"], check
            assert leg[BY_VALUE_APPEND] == 0, check
        assert lg["paged_decode_attention"] == \
            le["paged_decode_attention"] > 0, check
        for name in FUSIONS:     # the same fused launches in both legs
            assert lg[name] == le[name], check
            assert (le[name] > 0) == (name in check["fusions"]), check
    else:
        assert check["captures"] == 0 and sum(le.values()) == 0 == \
            sum(lg.values()), check


@contextlib.contextmanager
def sync_errors(device, on: bool = True):
    """torch's CUDA sync debug mode "error" inside the block (when ``on``
    and ``device`` is the card): a stream sync, such as reading a device
    value on the host, raises."""
    import torch
    if not on or torch.device(device).type != "cuda":
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def chunk_leg(rt, model, ops, device, graphs: bool, seed: int = 0) -> dict:
    """``ops``' prefill chunks with ``rt.cuda_graphs = graphs``, tokens
    seeded per op: each chunk's logits and next token, its bucket, its
    wall ms (ending in a device sync), whether it captured or replayed a
    graph, the graph pool's bytes after it; the leg's launch counts and
    the pools at its end. The eager leg's chunks run under the sync debug
    mode "error" (``sync_errors``): none may read a device value on the
    host."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.serving.prefill_graph import capacity
    rt.cuda_graphs = graphs
    g = rt.prefill_graphs
    before = launch_counts()
    chunks = []
    for i, op in enumerate(ops):
        if op[0] == "twin":
            add_twin(rt, op[1], op[2])
            continue
        pid, n, pad = op
        toks = torch.from_numpy(np.random.default_rng([seed, i]).integers(
            0, model.cfg.vocab_size, n))
        start = rt.programs[pid].length if pid in rt.programs else 0
        captures, replays = g.captures, g.replays
        synchronize(device)
        t0 = time.perf_counter()
        with sync_errors(device, on=not graphs):
            logits = rt.prefill(model, pid, toks, pad_to=pad)
        synchronize(device)
        chunks.append(dict(
            ms=1e3 * (time.perf_counter() - t0), start=start, S=n,
            bucket=("extend" if start else "prefill", pad,
                    capacity(start, pad)),
            logits=logits, nxt=rt._last[pid].clone(),
            captured=g.captures > captures, replayed=g.replays > replays,
            pool_bytes=g.pool_bytes()))
    after = launch_counts()
    return dict(chunks=chunks, pools=(rt.k_pages.clone(),
                                      rt.v_pages.clone()),
                launches={k: after[k] - before[k] for k in after})


def prefill_graph_vs_eager(model, device, ops, seed: int = 0) -> dict:
    """The paged runtime's prefill chunk, eager (``cuda_graphs=False``,
    on the same buckets' buffers) and graphed, over ``ops`` from the same
    empty runtime (its state restored between the legs). Returns the
    comparison, the buckets and their uses, the captures and their
    seconds, the graph pool's bytes, the median wall ms of an eager and
    of a replayed chunk of each bucket, each leg's launch counts and, on
    the card, the cost of a capture (``capture_cost``)."""
    import numpy as np
    import torch
    from repro_torch.serving.paged_runtime import PagedKVRuntime
    tokens = {}
    for op in ops:
        if op[0] != "twin":
            tokens[op[0]] = tokens.get(op[0], 0) + op[1]
    rt = PagedKVRuntime(model.cfg, n_pages=sum(
        -(-n // 16) + 1 for n in tokens.values()) + 8, page_size=16,
        device=device)
    st = runtime_state(rt)
    eager = chunk_leg(rt, model, ops, device, graphs=False, seed=seed)
    cow_eager = rt.cow_splits - st["cow_splits"]
    restore_state(rt, st)
    graph = chunk_leg(rt, model, ops, device, graphs=True, seed=seed)
    rt.check()
    es, gs = eager["chunks"], graph["chunks"]
    uses = {}
    for c in gs:
        uses[c["bucket"]] = uses.get(c["bucket"], 0) + 1

    def medians(chunks):
        by = {}
        for c in chunks:
            by.setdefault(str(c["bucket"]), []).append(c["ms"])
        return {k: float(np.median(v)) for k, v in by.items()}

    g = rt.prefill_graphs
    out = dict(
        chunks=len(gs),
        logits_equal=all(torch.equal(a["logits"], b["logits"])
                         for a, b in zip(es, gs)),
        nxt_equal=all(torch.equal(a["nxt"], b["nxt"]) for a, b in zip(es, gs)),
        pools_equal=all(torch.equal(a, b) for a, b in zip(eager["pools"],
                                                          graph["pools"])),
        finite=all(bool(torch.isfinite(c["logits"]).all()) for c in gs),
        buckets={str(k): n for k, n in sorted(uses.items())},
        to_capture=sum(n >= g.capture_at for n in uses.values()),
        replayed_chunks=sum(c["replayed"] for c in gs),
        mid_page_start=any(c["start"] % 16 for c in gs),
        page_start=any(c["start"] and not c["start"] % 16 for c in gs),
        crosses_page=any(c["start"] // 16 != (c["start"] + c["S"] - 1) // 16
                         for c in gs),
        s_one=any(c["S"] == 1 for c in gs),
        s_full=any(c["start"] and c["S"] == c["bucket"][1] for c in gs),
        cow_splits=(cow_eager, rt.cow_splits - st["cow_splits"]),
        captures=g.captures, capture_s=g.capture_s,
        pool_bytes=gs[-1]["pool_bytes"],
        pool_grew_on_replay=any(
            b["pool_bytes"] != a["pool_bytes"]
            for a, b in zip(gs, gs[1:]) if b["replayed"]),
        eager_ms_median=medians(es),
        replay_ms_median=medians([c for c in gs if c["replayed"]]),
        launches_eager=eager["launches"], launches_graph=graph["launches"])
    if torch.device(device).type == "cuda":
        (b,) = [b for key, b in g.buckets().items()
                if key == ("extend", 512, 2560)] or \
            [max(g.buckets().values(), key=lambda b: b.k.shape[2])]
        mode = "extend" if b.gather.numel() else "prefill"
        out["capture_cost"] = capture_cost(rt, lambda: rt._prefill_step(
            model, mode, *b.inputs(), out=(b.logits, b.nxt)),
            next(iter(rt.programs)))
    del rt
    return out


def assert_prefill_graph_vs_eager(check: dict, cuda: bool) -> None:
    """Bitwise equal across the schedule's buckets, page starts and
    crossings and a COW split; on the card every bucket used twice or
    more captured once, the replays growing no pool, and flash launched
    as often in both legs."""
    assert check["logits_equal"] and check["nxt_equal"], check
    assert check["pools_equal"] and check["finite"], check
    for key in ("mid_page_start", "page_start", "crosses_page", "s_one",
                "s_full"):
        assert check[key], (key, check)
    assert check["cow_splits"][0] == check["cow_splits"][1] >= 1, check
    le, lg = check["launches_eager"], check["launches_graph"]
    if cuda:
        assert check["captures"] == check["to_capture"] >= 3, check
        assert check["replayed_chunks"] > 0, check
        assert not check["pool_grew_on_replay"], check
        assert lg["flash_attention"] == le["flash_attention"] > 0, check
        assert lg["flash_extend"] == le["flash_extend"] > 0, check
    else:
        assert check["captures"] == 0 and sum(le.values()) == 0 == \
            sum(lg.values()), check


def capture_cost(rt, step, pid: str, reps: int = 3) -> dict:
    """The ms of capturing ``step`` (recorded, not run) into a throwaway
    graph and memory pool after a device sync, ``reps`` times each way in
    turns: through the runtime's ``capture`` and through ``torch.cuda.
    graph`` (the way before, with its sync, ``gc.collect``,
    ``empty_cache`` and release of the cached pinned host blocks). After
    each way, the pinned host blocks a stage-out's host copy allocates
    (``TorchModelBackend._to_host`` of ``pid``'s staging, warmed first;
    ``host_memory_stats``' ``num_host_alloc``)."""
    import torch
    from repro_torch.kernels import kernel_wrappers, launch_counts
    from repro_torch.serving.backend import TorchModelBackend
    from repro_torch.serving.decode_graph import capture
    counts = launch_counts()
    staging = rt.stage_out(pid)[0]
    TorchModelBackend._to_host(staging)
    side = torch.cuda.Stream()

    def allocs():
        stats = getattr(torch.cuda, "host_memory_stats", lambda: {})()
        return stats.get("num_host_alloc")

    def by_capture(graph, pool):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            capture(graph, pool, step)

    def by_context(graph, pool):
        with torch.cuda.graph(graph, pool=pool, stream=side):
            step()

    ms = {"capture": [], "torch.cuda.graph": []}
    pinned = {"capture": [], "torch.cuda.graph": []}
    for _ in range(reps):
        for name, how in (("capture", by_capture),
                          ("torch.cuda.graph", by_context)):
            graph = torch.cuda.CUDAGraph()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            how(graph, torch.cuda.graph_pool_handle())
            ms[name].append(1e3 * (time.perf_counter() - t0))
            del graph
            a0 = allocs()
            TorchModelBackend._to_host(staging)
            a1 = allocs()
            pinned[name].append(None if a0 is None else a1 - a0)
    torch.cuda.synchronize()
    for name, fn in kernel_wrappers().items():
        fn.launches = counts[name]
    return dict(ms=ms, pinned_allocs_after=pinned,
                staging_bytes=staging.numel() * staging.element_size())


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
    for name in PATH_A + DENSE_FFN:
        assert counts[name] > 0, f"kernel {name} never launched on path A"
    # the decode step appends through the indexed launch alone
    assert counts[BY_VALUE_APPEND] == 0, counts
    assert counts_a["flash_attention"] > 0, "no flash prefill in 3a"
    assert counts["flash_attention"] > counts_a["flash_attention"], \
        "no flash prefill in 3b"
    rts = [eng_a.backend.inner.runtime, eng_b.backend.runtime]
    for what, graphs in (("decode", [rt.graphs for rt in rts]),
                         ("prefill", [rt.prefill_graphs for rt in rts])):
        log(f"phase3 {what} graphs: 3a/3b captures "
            f"{[g.captures for g in graphs]} in "
            f"{[round(g.capture_s, 3) for g in graphs]} s, replays "
            f"{[g.replays for g in graphs]}, buckets "
            f"{[sorted(g.buckets()) for g in graphs]}, graph pool bytes "
            f"{[g.pool_bytes() for g in graphs]}")
    log(f"phase3 launches (the kernels line's): 3a {counts_a}, 3a+3b "
        f"{counts}")
    del eng_a, eng_b, b, graphs, rts
    gc.collect()

    t0 = time.perf_counter()
    pair = [serve_pair_leg(cfg, hw, model, device, graphs, fused)
            for graphs, fused in ((False, True), (True, True),
                                  (True, False))]
    log(f"phase3b pair, eager then graphed, then graphed with the decode "
        f"step's chains plain (fused=False), after 3b (graphed), "
        f"{time.perf_counter() - t0:.1f} s: {json.dumps(pair)}")
    assert pair[0]["captures"] == 0 < pair[1]["captures"], pair
    assert pair[0]["prefill_captures"] == 0 < pair[1]["prefill_captures"], \
        pair
    for leg in pair:
        assert leg["launches"]["token_append_indexed"] > 0, pair
        assert leg["launches"][BY_VALUE_APPEND] == 0, pair
        assert (leg["launches"][DECODE_FFN] > 0) == leg["fused"], pair
        assert (leg["launches"]["qkv_proj"] > 0) == leg["fused"], pair
        assert (leg["launches"]["flash_extend"] > 0) == leg["fused"], pair
        assert (leg["launches"]["qkv_rope_chunk"] > 0) == leg["fused"], pair

    for fused, schedule in ((True, GRAPH_SCHEDULE),
                            (False, GRAPH_SCHEDULE_PLAIN)):
        t0 = time.perf_counter()
        check = graph_vs_eager(model, device, GRAPH_PROMPTS, schedule,
                               fused=fused)
        log(f"phase3c graphed decode step vs eager, {cfg.name} full width, "
            f"{'fused' if fused else 'plain (fused=False)'}, "
            f"{time.perf_counter() - t0:.1f} s: {json.dumps(check)}")
        assert_graph_vs_eager(check, cuda=True)

    check = prefill_graph_vs_eager(model, device, PREFILL_OPS)
    log(f"phase3d graphed prefill chunk vs eager, {cfg.name} full width: "
        f"{json.dumps(check)}")
    assert_prefill_graph_vs_eager(check, cuda=True)

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
# two layers), 1e-3. bf16: the plain extend attention rounds its scores to
# bf16 (as the reference does), a rounding of up to 0.5 at |score| ~ 100
# that shifts softmax weights by e^0.5; 1/4 of the rms (measured 6.25 of
# rms 39 with the plain extend on the H100). The extend launch
# (``fused=True``) keeps fp32 scores as the prefill kernel does (0 apart
# in bf16 there); the bound is the plain extend's.
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
        model = cut_model(params, cfg, depth, dtype, device)
        for fused in (False, True):
            check = prefill_vs_extend(model, fused=fused)
            log(f"phase3 flash prefill vs prefill + extend"
                f"{' (fused: the extend launch)' if fused else ''}, "
                f"1024-token prompt, {depth} full-width layers, {dtype}: "
                f"{json.dumps(check)}")
            assert_prefill_vs_extend(check, dtype)
        del model
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
    log(f"phase3 fp32 depth sweep, max |prefill - prefill + extend| with "
        f"the kernel and with the plain version: {json.dumps(sweep)}")
    t0 = time.perf_counter()
    fused_step_checks(params, cfg, device)
    log(f"phase3 fused step checks {time.perf_counter() - t0:.1f} s")
    del params
    torch.cuda.empty_cache()


#: The fused decode step against ``fused=False`` (the plain spelling on
#: the card) from the same pools: programs of these many tokens, then
#: decode steps of the whole batch. Both legs are the served step, a
#: replayed graph (3c holds each graph bit-equal to its eager step).
FUSED_PROMPTS = (700, 300, 1000)
FUSED_STEPS = 6
#: |fused - plain| at every step's logits. The fusions round as the plain
#: ops do, but a norm and the merge's dot sum in their own order: a norm
#: output may sit one bf16 ulp off (a few per million elements), and fp32
#: differs by summation order alone. bf16: at most FUSED_BF16_ULPS ulps
#: of the largest plain logit (on the H100 the legs were bit-equal at
#: every depth from 1 to 28); fp32: FUSED_FP32_RMS of the plain logits'
#: rms (measured 4.0e-5 at qwen2-1.5b's 2-layer cut, up to 3.4e-4 for
#: pixtral-12b's in phase 6b).
FUSED_BF16_ULPS = 2
FUSED_FP32_RMS = 1e-3
#: kernels of the plain spelling's chains, by the names torch's CUDA
#: kernels carry (the norms' rsqrt and mean, the merge's maximum and
#: clamp_min, the GELU's tanh): the fused step runs none of them
PLAIN_FUSED_OPS = ("rsqrt", "MeanOps", "maximum", "clamp_min", "tanh")
#: cuBLAS's and CUTLASS's product kernels, by markers in their names
#: (``profile_step``'s "products" part, the port's gate/up kernel aside)
PRODUCT_MARKS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitK")


def fused_vs_plain(model, device, prompts=FUSED_PROMPTS,
                   steps: int = FUSED_STEPS, trace: bool = True,
                   seed: int = 0) -> dict:
    """The paged runtime's decode step fused and with ``fused=False``,
    the same ``steps`` from the same state (programs of ``prompts``
    tokens, seeded; the state restored between the legs), the fused leg
    fed the plain leg's next tokens, so that every step's logits answer
    the same history (fed its own, one argmax flip between near-equal
    logits would part every later step): whether every row's argmax
    agrees at every step, the largest |fused - plain| logit and the plain
    logits' rms, each leg's launch counts and, with ``trace`` on the
    card, one eager step of each leg under ``torch.profiler``: its device
    kernels and those named in ``PLAIN_FUSED_OPS``."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.serving.paged_runtime import PagedKVRuntime
    cfg = model.cfg
    cuda = torch.device(device).type == "cuda"
    rt = PagedKVRuntime(cfg, n_pages=sum(-(-(n + steps + 2) // 16)
                                         for n in prompts) + 4,
                        page_size=16, device=device)
    rng = np.random.default_rng(seed)
    pids = [f"p{i}" for i in range(len(prompts))]
    for pid, n in zip(pids, prompts):
        rt.prefill(model, pid, torch.from_numpy(
            rng.integers(0, cfg.vocab_size, n)))
    st = runtime_state(rt)
    legs, fed = {}, None
    for fused in (False, True):
        restore_state(rt, st)
        rt.fused = fused
        before = launch_counts()
        logits, tokens = [], []
        for i in range(steps):
            if fed is not None and i:
                rt._last.update(zip(pids, (t.clone() for t in fed[i - 1])))
            logits.append(torch.stack(rt.decode_batch(model, pids)))
            tokens.append([rt._last[pid].clone() for pid in pids])
        logits = torch.stack(logits).float()
        synchronize(device)
        after = launch_counts()
        legs[fused] = dict(logits=logits, launches={
            k: after[k] - before[k] for k in after})
        fed = tokens
    a, b = legs[True]["logits"], legs[False]["logits"]
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    top, mine = b.argmax(-1, keepdim=True), a.argmax(-1, keepdim=True)
    out = dict(argmax_equal=bool((mine == top).all()),
               argmax_gap=(b.gather(-1, top) - b.gather(-1, mine)).max()
               .item(),
               max_abs_diff=(a - b).abs().max().item(),
               rms_logit=b.square().mean().sqrt().item(),
               max_abs_logit=b.abs().max().item(), steps=steps,
               rows=len(pids), layers=cfg.num_layers,
               fusions=fused_names(cfg),
               launches_fused=legs[True]["launches"],
               launches_plain=legs[False]["launches"])
    if trace and cuda:
        rt.cuda_graphs = False
        for fused in (True, False):
            rt.fused = fused
            names = most_kernel_counts(
                lambda: rt.decode_batch(model, pids))
            leg = "fused" if fused else "plain"
            out[f"kernels_{leg}"] = sum(names.values())
            out[f"plain_ops_{leg}"] = sorted(
                {p for p in PLAIN_FUSED_OPS for n in names if p in n})
            out[f"combines_{leg}"] = sum(c for n, c in names.items()
                                         if "combine" in n)
            out[f"gated_act_{leg}"] = sum(c for n, c in names.items()
                                          if "gated_act_kernel" in n)
            out[f"products_{leg}"] = sum(
                c for n, c in names.items()
                if any(m in n for m in PRODUCT_MARKS))
    del rt
    return out


def step_kernel_counts(fn, reset=None) -> dict:
    """The device kernels one traced call of ``fn`` runs, by name. A trace
    that recorded no device event at all (CUPTI can drop a trace's
    device events, ROADMAP H10) measured nothing: ``reset`` (if given)
    restores what the call changed, ``fn`` is traced once more, and that
    trace counts, empty or not."""
    from repro_torch.launch.profile_step import traced
    names = traced(fn, top=1, reps=1, cpu=False, counts=True)[
        "kernel_counts"]
    if not names:
        log("a traced step recorded no device event: traced once more")
        if reset is not None:
            reset()
        names = traced(fn, top=1, reps=1, cpu=False, counts=True)[
            "kernel_counts"]
    return names


def most_kernel_counts(fn, traces: int = 2) -> dict:
    """Per kernel name, the largest count of ``traces`` traced calls of
    ``fn`` (``step_kernel_counts`` each, one step each): CUPTI can drop a
    trace's device events and never adds one (ROADMAP H10), so one trace
    can miss a kernel the step ran."""
    out = {}
    for _ in range(traces):
        for name, n in step_kernel_counts(fn).items():
            out[name] = max(out.get(name, 0), n)
    return out


def fused_bound(check: dict, dtype: str) -> float:
    """The largest |fused - plain| logit the check may show: in bf16
    FUSED_BF16_ULPS ulps of the largest plain logit, in fp32
    FUSED_FP32_RMS of their rms."""
    if dtype == "float32":
        return FUSED_FP32_RMS * check["rms_logit"]
    top = max(check["max_abs_logit"], 2.0 ** -126)
    return FUSED_BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


#: P14: past CHECK_DEPTH the fused bf16 decode step's gap to fused=False
#: is carried through the layers, each layer's reaching the logits once
#: (as P13 counts the chunk's): its norms, one bf16 ulp each, 2^-7 of the
#: layer's contribution together (P13's count), and its gate/up product,
#: whose fp32 sums run in another order than cuBLAS's: a share s of its
#: outputs one ulp (2^-7) off, with signs that do not line up, moves the
#: w2 product by 2^-7 sqrt(s) of its size. s is measured on the card at
#: the config's widths (``gate_up_share``). The qkv launch's projections
#: likewise (``qkv_share``, t): v's share moves the attention output, a
#: convex combination of v rows, by 2^-7 sqrt(t) of its size, and q's and
#: k's the scores by as much each, which reach the output at most
#: linearly where the scores are small (the published init's): three
#: terms. r = 2^-7 (1 + sqrt(s) + 3 sqrt(t)).
STEP_NORM_R = 2.0 ** -7


def step_bound(check: dict) -> float:
    """The largest |fused - plain| bf16 decode-step logit past
    CHECK_DEPTH (P14; at every depth once the qkv launch's share is not
    0): L r max|logit| + FUSED_BF16_ULPS ulps of it, r = STEP_NORM_R (1 +
    sqrt(``gate_up_share``) + 3 sqrt(``qkv_share``)) a layer. Held at
    qwen2's published init, where the reference's seeded init (scores of
    std ~100, P5) leaves the gap chaotic: logged there."""
    top = max(check["max_abs_logit"], 2.0 ** -126)
    r = STEP_NORM_R * (1.0 + math.sqrt(check["gate_up_share"])
                       + 3.0 * math.sqrt(check.get("qkv_share", 0.0)))
    return check["layers"] * r * top + \
        FUSED_BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def gate_up_share(cfg, device) -> float:
    """The share of the gate/up product's outputs that differ from the
    plain route's at ``cfg``'s (d_model, d_ff) in bf16
    (``check_fusion_gate_up``'s ``share_differ``, itself held within
    ``gate_up_bound``); 0 where the fused step runs no product (a MoE
    FFN) and off the card, where both legs run the plain version."""
    import torch
    if torch.device(device).type != "cuda" or cfg.family == "moe":
        return 0.0
    gen = torch.Generator(device=device).manual_seed(0)
    return check_fusion_gate_up(cfg, gen, device,
                                fusion_kernels())["share_differ"]


def qkv_share(cfg, device) -> float:
    """The share of the qkv launch's q, k and v elements that differ from
    the parent route's at ``cfg``'s widths in bf16 (``check_fusion_qkv``'s
    ``share_differ``, itself held within ``ref.qkv_proj_bound``); 0 where
    the fused step keeps the products and the row pass, and off the card,
    where both legs run the plain version."""
    import torch
    if torch.device(device).type != "cuda" or decode_qkv(cfg) != "qkv_proj":
        return 0.0
    gen = torch.Generator(device=device).manual_seed(zlib.crc32(
        f"qkv {cfg.name}".encode()))
    return check_fusion_qkv(cfg, gen, device,
                            fusion_kernels())["share_differ"]


def published_decode_checks(cfg, device) -> None:
    """P14: the fused bf16 decode step against ``fused=False`` at
    ``cfg``'s published init, at CHECK_DEPTH layers (``fused_bound``, the
    argmax equal) and at full depth (``step_bound`` from the products'
    measured ``gate_up_share`` and ``qkv_share``; an argmax flip only
    between plain logits within twice the bound: ``argmax_gap``); once
    the qkv launch's share is not 0, at CHECK_DEPTH too."""
    import torch
    cuda = torch.device(device).type == "cuda"
    share, qshare = gate_up_share(cfg, device), qkv_share(cfg, device)
    params = published_init(cfg, torch.Generator(
        device=device).manual_seed(0))
    for depth in sorted({min(CHECK_DEPTH, cfg.num_layers), cfg.num_layers}):
        check = fused_vs_plain(cut_model(params, cfg, depth, "bfloat16",
                                         device), device, trace=False)
        check.update(gate_up_share=share, qkv_share=qshare)
        derived = depth > CHECK_DEPTH or qshare > 0
        bound = step_bound(check) if derived \
            else fused_bound(check, "bfloat16")
        log(f"phase3 fused decode step vs fused=False at the published "
            f"init, {depth} full-width layers, bf16, {FUSED_STEPS} steps "
            f"(bound {bound:.4g}, twice it for an argmax flip): "
            f"{json.dumps(check)}")
        if not derived:
            assert_fused_vs_plain(check, "bfloat16", cuda)
        else:
            assert check["max_abs_diff"] <= bound, (bound, check)
            assert check["argmax_gap"] <= 2 * bound, (bound, check)
    del params
    if cuda:
        torch.cuda.empty_cache()


def assert_fused_vs_plain(check: dict, dtype: str, cuda: bool,
                          held: bool = True) -> None:
    """Argmax equal and the gap within ``fused_bound``; on the card the
    fused leg launches its fusions and no plain chain kernel, the plain
    leg no fusion, and both the same decode attention: one launch a layer
    and step (the fused leg's with the token merged). A traced step of
    the fused leg runs no combine kernel and, where its FFN takes the
    gate/up product, no gated activation and two products a layer fewer
    than the plain leg, and where it takes the qkv launch three more.
    ``held`` False (P14: the bf16 step at the seeded init once the qkv
    launch's products part from cuBLAS's) leaves the gap and the argmax
    to the caller's log."""
    if held:
        assert check["argmax_equal"], check
        assert check["max_abs_diff"] <= fused_bound(check, dtype), check
    lf, lp = check["launches_fused"], check["launches_plain"]
    if not cuda:
        assert sum(lf.values()) == 0 == sum(lp.values()), check
        return
    for name in FUSIONS:
        assert (lf[name] > 0) == (name in check["fusions"]), check
        assert lp[name] == 0, check
    assert lf["paged_decode_attention"] == lp["paged_decode_attention"] \
        == check["layers"] * check["steps"], check
    if "plain_ops_fused" in check:
        assert not check["plain_ops_fused"] and \
            "rsqrt" in check["plain_ops_plain"], check
        assert check["kernels_fused"] < check["kernels_plain"], check
        assert check["combines_fused"] == 0, check
        if DECODE_FFN in check["fusions"]:
            assert check["gated_act_fused"] == 0, check
        # a layer's cuBLAS products the fused leg runs fewer: gate and up
        # in the gate/up launch, q, k and v in the qkv launch (where it
        # replaces none, as an fp32 MoE step, the counts are not compared)
        fewer = 2 * (DECODE_FFN in check["fusions"]) \
            + 3 * ("qkv_proj" in check["fusions"])
        if fewer:
            assert check["products_plain"] - check["products_fused"] == \
                fewer * check["layers"], check


def fused_step_checks(params: dict, cfg, device) -> None:
    """The fused decode step against ``fused=False`` at CHECK_DEPTH
    full-width layers in bf16 and fp32 (asserted), and in bf16 at the
    cut and at full depth (logged); the fused extend chunk likewise
    (its qkv pass bit-equal to the qkv-plain spelling at every depth),
    then at the published init (``published_chunk_checks``)."""
    import torch
    depth = min(CHECK_DEPTH, cfg.num_layers)
    keys = ("argmax_equal", "max_abs_diff", "max_abs_logit", "rms_logit")
    sweep = {}
    # P14: once the qkv launch's products part from cuBLAS's, the bf16
    # step at this seeded init is chaotic at every depth: its gap logged,
    # the step held at the published init (published_decode_checks)
    held = qkv_share(cfg, device) == 0
    for dtype in ("bfloat16", "float32"):
        check = fused_vs_plain(cut_model(params, cfg, depth, dtype, device),
                               device)
        log(f"phase3 fused decode step vs fused=False, {depth} full-width "
            f"layers, {dtype}, {FUSED_STEPS} steps of {FUSED_PROMPTS} "
            f"(bound {fused_bound(check, dtype):.3g}"
            f"{'' if held or dtype == 'float32' else '; seeded init: logged'}"
            f"): {json.dumps(check)}")
        assert_fused_vs_plain(check, dtype,
                              cuda=torch.device(device).type == "cuda",
                              held=held or dtype == "float32")
        if dtype == "bfloat16":
            sweep[depth] = {k: check[k] for k in keys}
    cuda = torch.device(device).type == "cuda"
    for dtype in ("bfloat16", "float32"):
        check = chunk_fused_vs_plain(
            cut_model(params, cfg, depth, dtype, device), device,
            trace=False)
        log(f"phase3 fused extend chunk vs fused=False, {depth} full-width "
            f"layers, {dtype}, {len(CHUNK_EXTENDS)} chunks (bounds: the "
            f"chunk {chunk_bound(check, dtype):.3g}"
            f"{'' if dtype == 'float32' else ' (seeded init: logged)'}, "
            f"its fusions alone "
            f"{fused_bound(check['fusions'], dtype):.3g}): "
            f"{json.dumps(check)}")
        assert_chunk_fused_vs_plain(check, dtype, cuda)
        assert_chunk_qkv(check, dtype, cuda)
    if cfg.num_layers > depth:
        full = cut_model(params, cfg, cfg.num_layers, "bfloat16", device)
        check = fused_vs_plain(full, device, trace=False)
        sweep[cfg.num_layers] = {k: check[k] for k in keys}
        check = chunk_fused_vs_plain(full, device, trace=cuda)
        log(f"phase3 fused extend chunk vs fused=False, full depth "
            f"({cfg.num_layers} layers), bf16, gaps logged (chaotic at "
            f"depth), one traced extend chunk of each leg: "
            f"{json.dumps(check)}")
        assert_chunk_qkv(check, "bfloat16", cuda)
        if cuda:
            assert_chunk_trace(check, cfg.num_layers)
        del full
    log(f"phase3 bf16 by depth, fused decode step vs fused=False: "
        f"{json.dumps(sweep)}")
    published_decode_checks(cfg, device)
    published_chunk_checks(cfg, device)


def published_chunk_checks(cfg, device) -> None:
    """P13: the fused bf16 extend chunk against ``fused=False`` at
    ``cfg``'s published init, at CHECK_DEPTH layers and at full depth,
    held to ``chunk_bound`` (its argmax where the bound decides it) and
    bit-equal to the qkv-plain spelling."""
    import torch
    cuda = torch.device(device).type == "cuda"
    params = published_init(cfg, torch.Generator(
        device=device).manual_seed(0))
    for depth in sorted({min(CHECK_DEPTH, cfg.num_layers), cfg.num_layers}):
        check = chunk_fused_vs_plain(
            cut_model(params, cfg, depth, "bfloat16", device), device,
            trace=False, init="published")
        log(f"phase3 fused extend chunk vs fused=False at the published "
            f"init, {depth} full-width layers, bf16, {len(CHUNK_EXTENDS)} "
            f"chunks (bound {chunk_bound(check, 'bfloat16'):.4g}, twice it "
            f"for an argmax flip): {json.dumps(check)}")
        assert_chunk_fused_vs_plain(check, "bfloat16", cuda)
        assert_chunk_qkv(check, "bfloat16", cuda)
    del params
    if cuda:
        torch.cuda.empty_cache()


#: The prefill chunk fused against ``fused=False`` from one state: p0's
#: 1000-token and p1's 600-token prompts prefilled in 512-token chunks
#: (fused; the same state for every leg), then each extend of
#: CHUNK_EXTENDS alone from that state in each leg (the state restored
#: before each): 512 tokens and 100 padded to 128 on p0, 88 padded to 128
#: and 1 padded to 16 on p1. One chunk from one state, so a gap is the
#: chunk's own, not compounded over chained chunks (P5).
CHUNK_PROMPTS = (("p0", 1000), ("p1", 600))
CHUNK_EXTENDS = (("p0", 512, 512), ("p0", 100, 128), ("p1", 88, 128),
                 ("p1", 1, 16))
#: the traced chunk: a 512-token extend on p0 (profile_step's shape)
CHUNK_TRACED = CHUNK_EXTENDS[0]
#: kernels of the plain extend attention, by the names torch's CUDA
#: kernels carry: the softmax's exp and its row max over the (C, T)
#: scores; the fused chunk runs none (its SiLU is gated_act's)
PLAIN_ATTENTION_OPS = ("exp_kernel_cuda", "MaxNanFunctor")
#: the masks' where over the scores: the fused chunk runs none (its
#: scratch gather zeroes no row), at most the plain gather's two
CHUNK_WHERE = "where_kernel_impl"
GATHER_WHERES = 2


@contextlib.contextmanager
def plain_extend_attention():
    """Within the block, ``attend_decode`` takes its plain version on any
    device, whatever its caller passes: a fused chunk then differs from
    ``fused=False`` by its fusions alone."""
    from repro_torch.models import attention
    kernel_path = attention.attend_decode
    takes = attention.takes_extend_launch

    def plain(*args, **kw):
        return kernel_path(*args, **dict(kw, plain=True))

    # the runtime's scratch gather then zeroes the rows the plain
    # attention reads masked
    attention.attend_decode = plain
    attention.takes_extend_launch = lambda *a: False
    try:
        yield
    finally:
        attention.attend_decode = kernel_path
        attention.takes_extend_launch = takes


@contextlib.contextmanager
def plain_chunk_qkv():
    """Within the block, a fused chunk's qkv pass takes its plain version
    (``qkv_finish``, then ``write_cache`` at the device offsets) on any
    device: the fused chunk as it was spelled before the launch."""
    import functools
    from repro_torch.kernels import fusions
    launch = fusions.qkv_rope_chunk
    fusions.qkv_rope_chunk = functools.partial(launch, plain=True)
    try:
        yield
    finally:
        fusions.qkv_rope_chunk = launch


@contextlib.contextmanager
def raw_score_max():
    """Within the block, each ``attend_decode`` call also records the
    largest |q . k| before the scale over the keys its queries see (the
    plain dense arithmetic, scores in the compute dtype): the yielded
    list of device scalars."""
    import torch
    from repro_torch.models import attention
    inner = attention.attend_decode
    found = []

    def record(q, cache_k, cache_v, kv_len, **kw):
        top = [attention.decode_stats(x, cache_k, cache_v, kv_len,
                                      scale=1.0,
                                      window=kw.get("window", 0))[1].amax()
               for x in (q, -q)]
        found.append(torch.maximum(*top))
        return inner(q, cache_k, cache_v, kv_len, **kw)

    attention.attend_decode = record
    try:
        yield found
    finally:
        attention.attend_decode = inner


def chunk_fused_vs_plain(model, device, prompts=CHUNK_PROMPTS,
                         extends=CHUNK_EXTENDS, trace: bool = True,
                         seed: int = 0, init: str = "seeded") -> dict:
    """The paged runtime's extend chunk fused (its qkv pass the chunk's
    launch, its norms and gated activation the fusion kernels, its
    attention the extend launch), fused with its qkv pass plain (the
    spelling before that launch), fused with its attention plain (its
    fusions alone), and with ``fused=False``: each of ``extends`` run
    alone from one state (``prompts`` prefilled), in each leg. Returns
    argmax agreement and the largest |gap| of each fused leg to the plain
    one (the qkv-plain leg's to the fused one, ``qkv``), the plain logits'
    rms and largest |logit|, the largest raw score |q . k| the plain leg
    met (``score_max``), the depth, scale and ``init`` (the weights'
    name) that ``chunk_bound`` reads, each leg's launches and, with
    ``trace`` on the card, one eager CHUNK_TRACED of the fused and plain
    legs under ``torch.profiler``: its extend launches and its kernels by
    name."""
    import numpy as np
    import torch
    from repro_torch.kernels import launch_counts
    from repro_torch.serving.paged_runtime import PagedKVRuntime
    cfg = model.cfg
    cuda = torch.device(device).type == "cuda"
    rt = PagedKVRuntime(cfg, n_pages=256, page_size=16, device=device)
    rng = np.random.default_rng(seed)
    for pid, n in prompts:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
        for lo in range(0, n, 512):
            rt.prefill(model, pid, toks[lo:lo + 512], pad_to=512)
    st = runtime_state(rt)
    ext = [torch.from_numpy(rng.integers(0, cfg.vocab_size, n))
           for _, n, _ in extends]
    legs = {}
    scores = []
    for name, fused, within in (
            ("qkv_plain", True, plain_chunk_qkv),
            ("fused", True, contextlib.nullcontext),
            ("fusions", True, plain_extend_attention),
            ("plain", False, raw_score_max)):
        rt.fused = fused
        rt.prefill_graphs.clear()       # no leg replays another's graphs
        before = launch_counts()
        rows = []
        with within() as found:
            for (pid, _, pad), t in zip(extends, ext):
                restore_state(rt, st)
                rows.append(rt.prefill(model, pid, t, pad_to=pad).float())
            if found is not None:
                scores = found
        synchronize(device)
        after = launch_counts()
        legs[name] = dict(logits=torch.stack(rows),
                          launches={k: after[k] - before[k] for k in after})
        if trace and cuda and name in ("fused", "plain"):
            pid, _, pad = CHUNK_TRACED
            start = {}

            def reset():
                restore_state(rt, st)
                start.update(launch_counts())

            reset()
            rt.cuda_graphs = False
            names = step_kernel_counts(
                lambda: rt.prefill(model, pid, ext[0], pad_to=pad), reset)
            rt.cuda_graphs = True
            legs[name].update(
                traced_extend_launches=launch_counts()["flash_extend"]
                - start["flash_extend"],
                traced_kernels=sum(names.values()),
                traced_attention_ops=sorted({p for p in PLAIN_ATTENTION_OPS
                                             for n in names if p in n}),
                traced_wheres=sum(c for n, c in names.items()
                                  if CHUNK_WHERE in n))
    del rt
    b = legs["plain"]["logits"]
    assert all(torch.isfinite(leg["logits"]).all() for leg in legs.values())

    def gap(a, b=b) -> dict:
        top = b.argmax(-1, keepdim=True)
        mine = a.argmax(-1, keepdim=True)
        return dict(argmax_equal=bool((mine == top).all()),
                    argmax_gap=(b.gather(-1, top) - b.gather(-1, mine))
                    .max().item(),
                    max_abs_diff=(a - b).abs().max().item(),
                    rms_logit=b.square().mean().sqrt().item(),
                    max_abs_logit=b.abs().max().item())

    out = dict(gap(legs["fused"]["logits"]), chunks=len(extends),
               fusions=gap(legs["fusions"]["logits"]),
               qkv=gap(legs["fused"]["logits"], legs["qkv_plain"]["logits"]),
               score_max=max(x.item() for x in scores) if scores else 0.0,
               layers=cfg.num_layers, scale=1.0 / math.sqrt(cfg.head_dim),
               init=init, qk_norm=bool(cfg.qk_norm),
               chunk_fusions=[n for n in ("rms_norm", CHUNK_FFN)
                              if n != CHUNK_FFN or cfg.family != "moe"])
    for name, leg in legs.items():
        out[f"launches_{name}"] = leg["launches"]
        for k, v in leg.items():
            if k.startswith("traced_"):
                out[f"{k}_{name}"] = v
    return out


#: P13's bf16 bound on the fused chunk against ``fused=False``, held at
#: qwen2's published init (``published_init``). The plain attention rounds
#: each raw score s = q . k to bf16 (a relative error of at most 2^-9:
#: round to nearest, 8 significant bits) where the extend launch keeps it
#: in fp32; the scale carries that into the softmax, a score moving by at
#: most d = 2^-9 * scale * S, S the largest |raw score| the chunk meets
#: (measured in the run). A softmax weight then moves by a factor within
#: e^(+-2d), an attention output by r = e^(2d) - 1 of its values' range,
#: plus the two bf16 roundings (P, the output) that may land an ulp apart
#: (2^-8 each): r = e^(2d) - 1 + 2^-7 a layer. Each layer's error reaches
#: the logits once (the norms rescale, at this init nothing amplifies), so
#: |fused - plain| <= L * r * max|logit| + CHUNK_BF16_ULPS ulps of the
#: largest logit (the head's rounding, as ``fused_bound``). At the seeded
#: init (scores of std ~100, P5) the gap is logged, not held.
CHUNK_BF16_ULPS = 2


def chunk_bound(check: dict, dtype: str) -> float:
    """The largest |fused - plain| chunk logit: in fp32 the extend launch
    and the plain attention differ by summation order, FUSED_FP32_RMS of
    the rms as the decode step; in bf16 the P13 bound above, from the
    check's ``score_max``, ``scale`` and ``layers``."""
    if dtype == "float32":
        return FUSED_FP32_RMS * check["rms_logit"]
    d = 2.0 ** -9 * check["scale"] * check["score_max"]
    r = math.expm1(2 * d) + 2.0 ** -7
    top = max(check["max_abs_logit"], 2.0 ** -126)
    return check["layers"] * r * top + \
        CHUNK_BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def assert_chunk_fused_vs_plain(check: dict, dtype: str, cuda: bool) -> None:
    """The gap within ``chunk_bound`` in fp32, and in bf16 at the
    published init: the argmax equal in fp32, and in bf16 wherever the
    bound decides it (a flip only between plain logits within twice the
    bound: ``argmax_gap``); the fusions alone within the decode step's
    ``fused_bound`` in both dtypes at CHECK_DEPTH layers, and past it
    (the published init's full depth: each layer's one-ulp norm gap
    carried on) within ``chunk_bound``; on the card the fused leg launches
    the extend launch and the chunk's fusions, the fusions leg the
    fusions alone, the plain leg neither."""
    bound = chunk_bound(check, dtype)
    if dtype == "float32":
        assert check["argmax_equal"], check
        assert check["max_abs_diff"] <= bound, check
    elif check.get("init") == "published":
        assert check["max_abs_diff"] <= bound, (bound, check)
        assert check["argmax_gap"] <= 2 * bound, (bound, check)
    fz = check["fusions"]
    if check["layers"] <= CHECK_DEPTH:
        assert fz["argmax_equal"], check
        assert fz["max_abs_diff"] <= fused_bound(fz, dtype), check
    else:       # one-ulp norm gaps carried through every layer
        assert fz["max_abs_diff"] <= bound, (bound, check)
        assert fz["argmax_gap"] <= 2 * bound, (bound, check)
    lf, lz, lp = (check[f"launches_{n}"] for n in ("fused", "fusions",
                                                   "plain"))
    if not cuda:
        assert not any(lf.values()) and not any(lp.values()), check
        return
    assert lf["flash_extend"] > 0 == lz["flash_extend"] == \
        lp["flash_extend"], check
    # a MoE FFN keeps its own ops: no gated activation there
    for name in check.get("chunk_fusions", ("rms_norm", CHUNK_FFN)):
        assert lf[name] == lz[name] > 0 == lp[name], check


def assert_chunk_qkv(check: dict, dtype: str, cuda: bool) -> None:
    """The fused chunk against the same chunk with its qkv pass plain
    (the spelling before the chunk's launch): bit-equal where bias and
    RoPE are the whole chain, within ``fused_bound`` where a qk norm sums
    in the kernel's order; on the card the launch in the fused legs
    alone, one a layer and chunk in the fused leg."""
    g = check["qkv"]
    if check["qk_norm"]:
        assert g["argmax_equal"], check
        assert g["max_abs_diff"] <= fused_bound(g, dtype), check
    else:
        assert g["max_abs_diff"] == 0 and g["argmax_equal"], check
    lf, lq, lz, lp = (check[f"launches_{n}"] for n in (
        "fused", "qkv_plain", "fusions", "plain"))
    if not cuda:
        assert not any(lf.values()) and not any(lq.values()), check
        return
    assert lf["qkv_rope_chunk"] == lz["qkv_rope_chunk"] == \
        check["layers"] * check["chunks"], check
    assert lq["qkv_rope_chunk"] == 0 == lp["qkv_rope_chunk"], check
    assert lq["flash_extend"] == lf["flash_extend"] > 0, check


def assert_chunk_trace(check: dict, layers: int) -> None:
    """The traced extend chunk: one extend launch a layer and none of the
    plain attention's score kernels in the fused leg (its wheres only
    the scratch gather's), all of them in the plain one."""
    assert check["traced_extend_launches_fused"] == layers, check
    assert check["traced_extend_launches_plain"] == 0, check
    assert not check["traced_attention_ops_fused"], check
    assert check["traced_wheres_fused"] <= GATHER_WHERES, check
    assert set(check["traced_attention_ops_plain"]) == \
        set(PLAIN_ATTENTION_OPS), check
    assert check["traced_wheres_plain"] >= layers, check
    assert check["traced_kernels_fused"] < check["traced_kernels_plain"], \
        check


def prefill_vs_extend(model, n: int = 1024, split: int = 512,
                      seed: int = 1, fused: bool = False) -> dict:
    """Final-position logits of a fresh prefill of an ``n``-token prompt
    (flash attention) against prefill of the first ``split`` tokens then
    extend of the rest (dense ``attend_decode`` over the cache; with
    ``fused``, the model's forward as the paged chunk runs it: the extend
    launch on the card, and the fused norms and activation)."""
    import torch
    gen = torch.Generator(device=model.device).manual_seed(seed)
    toks = torch.randint(0, model.cfg.vocab_size, (1, n), generator=gen,
                         device=model.device)
    full, _ = model.forward(toks, cache=model.init_cache(1, n),
                            mode="prefill", logits_slice=1)
    cache = model.init_cache(1, n)
    model.forward(toks[:, :split], cache=cache, mode="prefill",
                  logits_slice=1, fused=fused)
    ext, _ = model.forward(toks[:, split:], cache=cache, cache_len=split,
                           mode="extend", logits_slice=1, fused=fused)
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
    (default T) positions through ``build_prefill_step``'s step and
    ``n_dec`` timed greedy decode steps through ``build_decode_step``'s
    step (on the card its CUDA graph, captured at the second step), both
    with their default ``fused``, each timed after the device has
    finished."""
    import torch
    B, T = toks.shape
    synchronize(model.device)
    t0 = time.perf_counter()
    nxt, cache = prefill_step_of(model, B, max_len or T).fn(
        model.init_cache(B, max_len or T), toks)
    synchronize(model.device)
    t_pre = time.perf_counter() - t0
    step = decode_step_of(model, B, max_len or T)
    t0 = time.perf_counter()
    for i in range(n_dec):
        nxt, cache, logits = step.fn(cache, nxt[:, None], T + i,
                                     logits=True)
    synchronize(model.device)
    t_dec = time.perf_counter() - t0
    assert torch.isfinite(logits).all()
    assert all(torch.isfinite(c).all() for c in cache.values())
    return dict(prefill_tokens_per_s=B * T / t_pre,
                decode_tokens_per_s=B * n_dec / t_dec, prefill_s=t_pre,
                decode_step_ms=t_dec / n_dec * 1e3, batch=B, prompt=T)


def decode_step_of(model, B: int, max_len: int, cuda_graphs: bool = True,
                   fused: bool | None = None):
    """``build_decode_step`` over ``model`` for B rows of ``max_len``
    (``fused`` None: the step's default, on for a model on the card)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.steps import build_decode_step
    return build_decode_step(model.cfg, None,
                             ShapeSpec("decode", "decode", max_len, B),
                             model=model, cuda_graphs=cuda_graphs,
                             fused=fused)


def prefill_step_of(model, B: int, max_len: int,
                    fused: bool | None = None):
    """``build_prefill_step`` over ``model`` for B rows into a cache of
    ``max_len`` positions (``fused`` as :func:`decode_step_of`'s)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.steps import build_prefill_step
    return build_prefill_step(model.cfg, None,
                              ShapeSpec("prefill", "prefill", max_len, B),
                              model=model, fused=fused)


#: decode steps each leg of :func:`decode_pair` runs before its timed
#: ones (the graph leg's eager warm-up, and the step that captures its
#: graph and replays it once), and under torch.profiler after them
DECODE_WARM = 2
DECODE_TRACED = 3


def decode_positions(n_dec: int) -> int:
    """Cache positions a :func:`decode_pair` leg of ``n_dec`` timed steps
    writes past the prompt."""
    return DECODE_WARM + n_dec + DECODE_TRACED


def forward_leg(step, cache, nxt, T: int, n_dec: int, device,
                graphs: bool) -> dict:
    """One leg of :func:`decode_pair`: ``DECODE_WARM`` untimed steps from
    the prefill's next tokens ``nxt``, ``n_dec`` timed (a graph leg's
    under the sync debug mode "error": a replay reads nothing back) and,
    on the card, ``DECODE_TRACED`` under torch.profiler (device ms,
    device ops and host launch calls a step; the CUDA activity alone).
    Returns every step's logits, the leg's wall ms a step and trace."""
    import torch
    logits = []
    state = dict(nxt=nxt, t=T)

    def one():
        nxt, _, lg = step.fn(cache, state["nxt"][:, None], state["t"],
                             logits=True)
        state.update(nxt=nxt, t=state["t"] + 1)
        logits.append(lg)

    for _ in range(DECODE_WARM):
        one()
    synchronize(device)
    t0 = time.perf_counter()
    with sync_errors(device, graphs):
        for _ in range(n_dec):
            one()
    synchronize(device)
    t_dec = time.perf_counter() - t0
    out = dict(cuda_graphs=graphs, wall_ms=t_dec / n_dec * 1e3,
               decode_tokens_per_s=len(state["nxt"]) * n_dec / t_dec,
               trace=None, logits=logits)
    if torch.device(device).type == "cuda":
        from repro_torch.launch.profile_step import traced
        out["trace"] = traced(one, top=6, reps=DECODE_TRACED, cpu=False,
                              counts=True)
    g = step.graph
    out.update(captures=g.captures if g else 0,
               capture_s=g.capture_s if g else 0.0,
               replays=g.replays if g else 0,
               graph_pool_bytes=g.pool_bytes() if g else None)
    return out


def decode_pair(model, toks, n_dec: int, max_len: int | None = None,
                fused: bool | None = None) -> dict:
    """One timed prefill of ``toks`` (B, T) into a cache of ``max_len``
    (default T) positions through ``build_prefill_step``'s step, then its
    greedy decode twice from it, the cache cloned after the prefill: the
    graph leg (``build_decode_step``'s step, a replayed CUDA graph on the
    card) and the eager leg (``cuda_graphs=False``, today's eager step,
    its offsets host ints), each as :func:`forward_leg`; every step with
    ``fused`` (None: the steps' default, on for a model on the card).
    Returns the prefill's s and tokens/s, each leg's summary and whether
    every step's logits, next tokens and the final caches are bit-equal
    between the legs."""
    import torch
    B, T = toks.shape
    max_len = max_len or T + decode_positions(n_dec)
    synchronize(model.device)
    t0 = time.perf_counter()
    nxt, cache = prefill_step_of(model, B, max_len, fused).fn(
        model.init_cache(B, max_len), toks)
    synchronize(model.device)
    t_pre = time.perf_counter() - t0
    caches = {"graph": cache,
              "eager": {k: v.clone() for k, v in cache.items()}}
    legs = {leg: forward_leg(decode_step_of(model, B, max_len,
                                            leg == "graph", fused),
                             caches[leg], nxt, T, n_dec, model.device,
                             leg == "graph")
            for leg in ("graph", "eager")}
    g, e = (legs[leg].pop("logits") for leg in ("graph", "eager"))
    out = dict(prefill_s=t_pre, prefill_tokens_per_s=B * T / t_pre,
               batch=B, prompt=T, max_len=max_len, timed_steps=n_dec,
               steps=len(g),
               logits_bit_equal=len(g) == len(e) and all(
                   torch.equal(a, b) for a, b in zip(g, e)),
               tokens_equal=all(torch.equal(a.argmax(-1), b.argmax(-1))
                                for a, b in zip(g, e)),
               caches_bit_equal=all(torch.equal(caches["graph"][k],
                                                caches["eager"][k])
                                    for k in cache),
               finite=bool(torch.isfinite(g[-1]).all()),
               legs={leg: leg_trace_summary(r) for leg, r in legs.items()})
    if legs["graph"]["trace"] is not None:
        out["device_ops_differ"] = kernel_diff(legs["graph"],
                                               legs["eager"])
    return out


def leg_trace_summary(leg: dict) -> dict:
    """A decode leg's numbers, its trace's as :func:`trace_fields`."""
    out = {k: v for k, v in leg.items() if k != "trace"}
    if leg["trace"] is not None:
        out.update(trace_fields(leg["trace"]))
    return out


def trace_fields(tr: dict) -> dict:
    """A ``profile_step.traced`` record reduced to a step's device ms,
    busy share, device ops run and host launch calls."""
    return dict(device_ms=tr["device_busy_ms_per_step"],
                device_ms_by_part=tr["device_ms_by_part"],
                device_busy_share=tr["device_busy_share"],
                traced_wall_ms=tr["traced_wall_ms_per_step"],
                kernels_run=tr["device_kernels_per_step"],
                host_launch_calls=tr["host_launch_calls_per_step"],
                host_launch_by_call=tr["host_launch_calls"],
                trace_read_s=tr["read_s"])


def assert_decode_pair(check: dict, cuda: bool) -> None:
    """The graph leg's logits at every step and its final caches equal the
    eager leg's bit for bit; on the card its bucket was captured once
    and replayed on every later step, a replay making at most
    ``MAX_GRAPH_LAUNCH_CALLS`` host launch calls; on the CPU nothing was
    captured."""
    assert check["logits_bit_equal"] and check["tokens_equal"], check
    assert check["caches_bit_equal"] and check["finite"], check
    g, e = check["legs"]["graph"], check["legs"]["eager"]
    assert e["captures"] == 0 and e["replays"] == 0, e
    if cuda:
        assert g["captures"] == 1, g
        assert g["replays"] == check["steps"] - 1, g
        assert g["host_launch_calls"] <= MAX_GRAPH_LAUNCH_CALLS, g
    else:
        assert g["captures"] == 0 and g["replays"] == 0, g


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
    """Path B: rwkv6-3b at full width through ``Model.forward``: one bf16
    prefill counted, then :func:`decode_pair` (the decode step graphed
    and eager from one prefill). Returns the launch counts of the one
    prefill."""
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
    pair = decode_pair(m16, toks, n_dec)
    log(f"phase4 decode pair (bf16; a prefill, then the graph leg and the "
        f"eager leg from its cache; ms after synchronize) on {smi}: "
        f"{json.dumps(pair)}")
    assert_decode_pair(pair, cuda=True)
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
                 "pixtral-12b": 2, "musicgen-large": 2, "stablelm-3b": 2,
                 "glm4-9b": 2}
#: the ones the paged runtime serves (moonshot's leading dense layer is
#: refused, ROADMAP R4); each also runs its fused decode step against
#: ``fused=False`` on programs of these many tokens
FAMILY_PAGED = ("qwen3-moe-235b-a22b", "pixtral-12b", "musicgen-large",
                "stablelm-3b", "glm4-9b")
FAMILY_FUSED_PROMPTS = (256, 100)
#: and its extend chunk fused against ``fused=False`` (with the qkv pass
#: plain as a fourth leg): these prompts, then these extends
FAMILY_CHUNK_PROMPTS = (("p0", 256), ("p1", 100))
FAMILY_CHUNK_EXTENDS = (("p0", 64, 64), ("p1", 17, 32))
#: 6b's prompt: ``FAMILY_PROMPT`` tokens, the last ``FAMILY_TAIL`` of
#: them decoded one at a time in the split path
FAMILY_PROMPT, FAMILY_TAIL = 256, 8
#: fp32 bound on |a - b| at the last position as a share of the logits'
#: rms, for two exact-equivalent paths that differ in summation order
#: (flash or the paged kernel against dense attention), as phase 3's
FAMILY_BOUND = PREFILL_BOUND["float32"]


@contextlib.contextmanager
def moe_drop_counts(device):
    """Within the block, the token-copies each MoE dispatch drops, and
    the dispatches, are summed on ``device``, apart for the paged
    runtime's decode steps and for everything else (prefill and extend
    chunks). Yields {kind: (2,) int64 tensor of (dropped copies,
    dispatches)}; read it after the block. The sums are in-place adds to
    tensors made before the block, so a captured decode step adds to
    them at every replay."""
    import torch
    from repro_torch.models import moe
    from repro_torch.serving.paged_runtime import PagedKVRuntime
    totals = {kind: torch.zeros(2, dtype=torch.long, device=device)
              for kind in ("prefill", "decode")}
    kind = ["prefill"]
    plan, step = moe._dispatch_plan, PagedKVRuntime._decode_step

    def counted_plan(flat_ids, E, C):
        src, dest = plan(flat_ids, E, C)
        t = totals[kind[0]]
        t[0] += (dest == E * C).sum()
        t[1] += 1
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
        yield totals
    finally:
        moe._dispatch_plan = plan
        PagedKVRuntime._decode_step = step


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
    with moe_drop_counts(model.device) as drops:
        eng, steps, wall = serve_differential(cfg, hw, model, device)
    counts = launch_counts()
    st = mechanism_stats(eng)
    out = dict(decision_steps=steps, engine_steps=eng.steps,
               physical_wall_s=wall, ms_per_step=1e3 * wall / eng.steps,
               dropped_copies_prefill=int(drops["prefill"][0]),
               dropped_copies_decode=int(drops["decode"][0]),
               moe_dispatches={k: int(v[1]) for k, v in drops.items()},
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
    del eng, b
    out["graph_vs_eager"] = check = graph_vs_eager(
        model, device, MOE_GRAPH_PROMPTS, MOE_GRAPH_SCHEDULE)
    assert_graph_vs_eager(check, cuda)
    out["prefill_graph_vs_eager"] = check = prefill_graph_vs_eager(
        model, device, MOE_PREFILL_OPS)
    assert_prefill_graph_vs_eager(check, cuda)
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
    with moe_drop_counts(model.device) as drops:
        out["prefill_vs_decode"] = prefill_vs_decode(split, toks,
                                                     FAMILY_TAIL)
    out["prefill_vs_decode"]["dropped_copies"] = int(
        drops["prefill"][0] + drops["decode"][0])
    del split
    try:
        require_paged(cfg)
        paged = True
    except ValueError:          # leading dense layers (ROADMAP R4)
        paged = False
    if paged:
        out["paged_vs_forward"] = paged_vs_forward(model, toks, FAMILY_TAIL)
        out["fused_vs_plain"] = fused_vs_plain(model, device,
                                               FAMILY_FUSED_PROMPTS,
                                               FAMILY_TAIL // 2)
        out["chunk_fused_vs_plain"] = chunk_fused_vs_plain(
            model, device, FAMILY_CHUNK_PROMPTS, FAMILY_CHUNK_EXTENDS,
            trace=False)
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


def prefill_vs_decode(model, toks, tail: int, fused: bool = False) -> dict:
    """Prefill of the whole prompt against prefill of all but ``tail``
    tokens followed by ``tail`` decode steps with the cache, every
    forward ``fused``."""
    import torch
    n = toks.shape[1]
    full, _ = model.forward(toks, cache=model.init_cache(1, n),
                            logits_slice=1, fused=fused)
    cache = model.init_cache(1, n)
    model.forward(toks[:, :n - tail], cache=cache, logits_slice=1,
                  fused=fused)
    for t in range(n - tail, n):
        step, cache = model.forward(toks[:, t:t + 1], cache=cache,
                                    cache_len=torch.full((1,), t),
                                    mode="decode", fused=fused)
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
    and prefill chunks dropping copies; (b) the other families'
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
        if arch in FAMILY_PAGED:
            assert_fused_vs_plain(checks["fused_vs_plain"], "float32", True)
            assert_chunk_fused_vs_plain(checks["chunk_fused_vs_plain"],
                                        "float32", True)
            assert_chunk_qkv(checks["chunk_fused_vs_plain"], "float32",
                             True)
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
#: ``published``: the depths the fused bf16 step is held at against
#: ``fused=False`` at the published init (P13 / P14's bound,
#: ``path_e_bound``): the cut depths and the full one.
PATH_E = {"7a": dict(arch="gemma2-9b", B=1, prompt=4600, max_len=4672,
                     flash=42, check="7b", depths=(2, 4),
                     published=(2, 4, 42), fused_checks=False),
          "7c": dict(arch="zamba2-2.7b", B=2, prompt=2000, max_len=2048,
                     flash=9, check="7d", depths=(6, 12),
                     published=(6, 12, 54), fused_checks=True)}
PATH_E_DECODE = 32
#: the plain legs' (``fused=False``) timed decode steps: their eager step
#: takes ~80 ms at gemma2's depth
PATH_E_PLAIN_DECODE = 8
#: 7b / 7d: the last PATH_E_TAIL prompt tokens decoded one at a time in
#: the split path (across gemma2's ring: the prefill of 4536 tokens wraps
#: it, every decode step overwrites its oldest slot)
PATH_E_TAIL = 64


def kernel_vs_plain(model, toks, fused: bool = False) -> dict:
    """The last position's logits of a fresh prefill with the flash
    kernel (on the card; the blocked plain attention on the CPU) against
    the same prefill under ``plain_prefill_attention``; both ``fused``."""
    n = toks.shape[1]
    kern, _ = model.forward(toks, cache=model.init_cache(1, n),
                            logits_slice=1, fused=fused)
    with plain_prefill_attention():
        plain, _ = model.forward(toks, cache=model.init_cache(1, n),
                                 logits_slice=1, fused=fused)
    return gap(kern[0, -1], plain[0, -1])


def path_e_checks(params: dict, cfg, depth: int, prompt: int, tail: int,
                  device, fused: bool = False) -> dict:
    """Phase 7b / 7d at one cut depth, fp32: the prefill of ``prompt``
    tokens against prefill of all but ``tail`` and ``tail`` decode steps,
    and the prefill through the flash kernel against the plain version
    (on the card the flash launches are counted and asserted). ``fused``
    (7d): every forward fused, zamba2's Mamba2 layers through their
    kernels (on the card both launched, asserted)."""
    import torch
    from repro_torch.kernels import launch_counts
    model = cut_model(params, cfg, depth, "float32", device)
    gen = torch.Generator(device=model.device).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=gen,
                         device=model.device)
    before = launch_counts()
    out = dict(prefill_vs_decode=prefill_vs_decode(model, toks, tail,
                                                   fused),
               kernel_vs_plain=kernel_vs_plain(model, toks, fused))
    if model.device.type == "cuda":
        after = launch_counts()
        assert after["flash_attention"] > before["flash_attention"], \
            "no flash"
        for name in MAMBA2 if fused and mamba_layers(cfg) else ():
            assert after[name] > before[name], f"no {name}"
    del model
    return out


def assert_path_e_checks(checks: dict) -> None:
    """fp32 on both sides, the same function summed in other orders:
    within 1e-3 of the logits' rms, argmax equal (as phase 6b)."""
    for name, g in checks.items():
        assert g["argmax_equal"], (name, g)
        assert g["max_abs_diff"] <= FAMILY_BOUND * g["rms_logit"], (name, g)


def attention_calls(cfg) -> int:
    """Attention sublayers a forward of ``cfg`` runs: every layer of a
    transformer, zamba2's shared block once a group, none in RWKV6."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.shared_attn_every
    return cfg.num_layers


def mamba_layers(cfg) -> int:
    """Mamba2 layers a forward of ``cfg`` runs: zamba2's every layer."""
    return cfg.num_layers if cfg.family == "hybrid" else 0


def path_e_fusions(cfg) -> dict:
    """The fusion kernels a fused path E step runs, with their launches a
    decode step: the norms (their count not fixed here: None), the decode
    qkv pass (``decode_qkv``: gemma2's one launch, zamba2's row pass after
    cuBLAS's products) and the gate/up launch, one a sublayer; and the
    prefill's gated activation and the qkv pass with its cache write
    over the plain caches (no decode launch: 0); zamba2's Mamba2 kernels,
    the decode step's one a layer, the prompt's SSD in the prefill
    alone."""
    n = attention_calls(cfg)
    out = {"rms_norm": None, decode_qkv(cfg): n, DECODE_FFN: n,
           CHUNK_FFN: 0, "qkv_rope_chunk": 0}
    if mamba_layers(cfg):
        out.update(mamba2_step=mamba_layers(cfg), ssd_chunk=0)
    return out


@contextlib.contextmanager
def counted_calls(module, name: str):
    """Within the block, each call of ``module.name`` appended to the
    yielded list."""
    inner = getattr(module, name)
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return inner(*args, **kw)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, inner)


def decode_stats_calls():
    """Each call of ``attention.decode_stats`` (the plain dense
    arithmetic) within the block."""
    from repro_torch.models import attention
    return counted_calls(attention, "decode_stats")


def plain_ssd_calls():
    """Each call of ``mamba2._ssd`` (the plain Mamba2 arithmetic: the
    decode recurrence or the chunked SSD) within the block."""
    from repro_torch.models import mamba2
    return counted_calls(mamba2, "_ssd")


def forward_fused_vs_plain(model, toks, steps: int, max_len: int,
                           init: str = "seeded") -> dict:
    """Path E's programs with ``fused=False`` and fused, from one prompt
    ``toks`` (B, T): ``build_prefill_step``'s prefill into a cache of
    ``max_len``, then ``steps`` eager ``build_decode_step`` steps, the
    fused leg fed the plain leg's tokens (fed its own, one flip at a
    near-tie would part every later step). Returns whether the argmax
    agrees at the prefill's last position and every step, the largest
    plain-logit gap of a flip (``argmax_gap``), the largest |fused -
    plain| logit, the plain logits' rms and largest |logit|, the largest
    raw score |q . k| the plain leg's decode attention met
    (``score_max``), and what ``path_e_bound`` reads (attention layers,
    Mamba2 layers, norms a layer, scale, softcap, ``init``), each leg's
    launches and the fused leg's calls of the plain dense arithmetic
    (``decode_stats``) and of the plain Mamba2 arithmetic (``_ssd``)."""
    import torch
    from repro_torch.kernels import launch_counts
    cfg = model.cfg
    B, T = toks.shape
    legs, fed = {}, None
    for fused in (False, True):
        before = launch_counts()
        prefill = prefill_step_of(model, B, max_len, fused)
        step = decode_step_of(model, B, max_len, cuda_graphs=False,
                              fused=fused)
        with (decode_stats_calls if fused else raw_score_max)() as found, \
                plain_ssd_calls() as ssd:
            nxt, cache, lg = prefill.fn(model.init_cache(B, max_len), toks,
                                        logits=True)
            logits, fed_now = [lg[:, -1]], []
            for i in range(steps):
                tok = nxt if fed is None else fed[i]
                fed_now.append(tok)
                nxt, cache, lg = step.fn(cache, tok[:, None], T + i,
                                         logits=True)
                logits.append(lg[:, -1])
        synchronize(model.device)
        after = launch_counts()
        legs[fused] = dict(logits=torch.stack(logits).float(),
                           launches={k: after[k] - before[k] for k in after
                                     if after[k] != before[k]},
                           found=list(found), ssd=len(ssd))
        fed = fed_now
        del cache
    a, b = legs[True]["logits"], legs[False]["logits"]
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    top, mine = b.argmax(-1, keepdim=True), a.argmax(-1, keepdim=True)
    scores = legs[False]["found"]
    return dict(argmax_equal=bool((mine == top).all()),
                argmax_gap=(b.gather(-1, top) - b.gather(-1, mine)).max()
                .item(),
                max_abs_diff=(a - b).abs().max().item(),
                rms_logit=b.square().mean().sqrt().item(),
                max_abs_logit=b.abs().max().item(), steps=steps, rows=B,
                layers=attention_calls(cfg), mamba_layers=mamba_layers(cfg),
                norms=4 if cfg.sandwich_norm else 2,
                scale=1.0 / math.sqrt(cfg.head_dim),
                softcap=cfg.attn_softcap, init=init,
                score_max=max(x.item() for x in scores) if scores else 0.0,
                decode_stats_fused=len(legs[True]["found"]),
                plain_ssd_fused=legs[True]["ssd"],
                fusions=path_e_fusions(cfg),
                launches_fused=legs[True]["launches"],
                launches_plain=legs[False]["launches"])


#: P13 / P14's bound carried to path E's step (prefill, then the decode
#: steps), a bf16 sublayer's gap reaching the logits once: its norms one
#: ulp each (2^-8; gemma2's four sandwich norms a layer, two in zamba2's
#: shared block), its attention's scores rounded to bf16 by the plain
#: arithmetic where the dense launch keeps them in fp32 (d = 2^-9 x the
#: largest scaled raw score; gemma2's softcap c tanh(s / c) has slope
#: sech^2 <= 1 and moves a score by at most 2^-9 max_x x sech^2(x / c) <=
#: 2^-9 x 0.45 c, which bounds d too), a weight moving within e^(+-2d),
#: its P and output roundings (2^-7 together), the gate/up launch's share
#: s and the qkv launch's share t as P14 counts them. The L sublayers'
#: gaps add in quadrature (sqrt(L) r), not in line: each is a sum of
#: round-to-nearest errors of its own operands, independent of another
#: sublayer's and of either sign, and the linear sum L r passes 1 (a
#: bound of max|logit|, which any output of the logits' size meets)
#: within gemma2-9b's 42 layers. zamba2's M Mamba2 layers are M
#: sublayers more, counted as P14 counts a product's share: a layer's
#: norm through the norm kernel (one ulp, 2^-8) and its mixer's y
#: elements off the plain spelling's bits at a share m (measured at
#: zamba2's widths, ``mamba2_share``; one bf16 ulp each, signs that do not
#: line up), which moves the out-projection by 2^-7 sqrt(m) of its size:
#: r_m = 2^-8 + 2^-7 sqrt(m), in quadrature with the attention
#: sublayers'.
PATH_E_NORM_ULP = 2.0 ** -8
SOFTCAP_SLOPE = 0.45


def path_e_bound(check: dict) -> float:
    """The largest |fused - plain| bf16 logit of
    ``forward_fused_vs_plain``: sqrt(L r^2 + M r_m^2) max|logit| +
    FUSED_BF16_ULPS ulps of it, r = e^(2d) - 1 + 2^-7 + norms 2^-8 + 2^-7
    (sqrt(s) + 3 sqrt(t)), d = 2^-9 min(scale S, 0.45 softcap), L the
    attention sublayers; r_m = 2^-8 + 2^-7 sqrt(m), M the Mamba2 layers
    (none: sqrt(L) r)."""
    x = check["scale"] * check["score_max"]
    if check["softcap"]:
        x = min(x, SOFTCAP_SLOPE * check["softcap"])
    d = 2.0 ** -9 * x
    r = math.expm1(2 * d) + STEP_NORM_R + check["norms"] * PATH_E_NORM_ULP \
        + STEP_NORM_R * (math.sqrt(check["gate_up_share"])
                         + 3.0 * math.sqrt(check["qkv_share"]))
    r_m = PATH_E_NORM_ULP + STEP_NORM_R * math.sqrt(
        check.get("mamba2_share", 0.0))
    spread = math.sqrt(check["layers"] * r * r
                       + check.get("mamba_layers", 0) * r_m * r_m)
    top = max(check["max_abs_logit"], 2.0 ** -126)
    return spread * top + \
        FUSED_BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)


def assert_path_e_fused_vs_plain(check: dict, cuda: bool,
                                 held: bool = True) -> None:
    """``held`` (the published init): the gap within ``path_e_bound``, an
    argmax flip only between plain logits within twice it. On the card
    the fused leg runs the dense launch once a sublayer and step, the
    plain dense arithmetic never, its fusion kernels (the decode ones
    once a sublayer and step), and the plain leg none of them; both the
    same flash prefill. Off the card neither launches anything and both
    give the same bits. (The legs' launches list the kernels launched.)"""
    bound = path_e_bound(check)
    if held:
        assert check["max_abs_diff"] <= bound, (bound, check)
        assert check["argmax_gap"] <= 2 * bound, (bound, check)
    lf, lp = check["launches_fused"], check["launches_plain"]
    assert check["decode_stats_fused"] == 0, check
    if not cuda:
        assert not lf and not lp and check["max_abs_diff"] == 0, check
        return
    assert check.get("plain_ssd_fused", 0) == 0, check
    n = check["layers"] * check["steps"]
    assert lf.get("dense_decode_attention") == n, check
    for name, per_step in check["fusions"].items():
        assert lf.get(name, 0) > 0 == lp.get(name, 0), (name, check)
        if per_step:
            assert lf[name] == per_step * check["steps"], (name, check)
    assert "dense_decode_attention" not in lp, check
    assert lf.get("flash_attention") == lp.get("flash_attention") == \
        check["layers"], check


def published_path_e_checks(cfg, run: dict, device) -> None:
    """The fused bf16 step against ``fused=False`` at ``cfg``'s published
    init (N(0, 0.02), drawn leaf by leaf in bf16) at ``run``'s
    ``published`` depths, held to ``path_e_bound`` with the gate/up and
    qkv launches' shares and the Mamba2 kernels' measured at ``cfg``'s
    widths."""
    import torch
    cuda = torch.device(device).type == "cuda"
    share, qshare = gate_up_share(cfg, device), qkv_share(cfg, device)
    mshare = mamba2_share(cfg, device)
    params = published_init(cfg, torch.Generator(device=device)
                            .manual_seed(0), dtype="bfloat16")
    gen = torch.Generator(device=device).manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (run["B"], run["prompt"]),
                         generator=gen, device=device)
    for depth in run["published"]:
        model = cut_model(params, cfg, depth, "bfloat16", device)
        check = forward_fused_vs_plain(model, toks, FUSED_STEPS,
                                       run["max_len"], init="published")
        check.update(gate_up_share=share, qkv_share=qshare,
                     mamba2_share=mshare)
        log(f"phase{run['check']} fused step vs fused=False at the "
            f"published init, {cfg.name} at {depth} full-width layers, "
            f"bf16, prefill + {FUSED_STEPS} steps (bound "
            f"{path_e_bound(check):.4g}, twice it for an argmax flip): "
            f"{json.dumps(check)}")
        assert_path_e_fused_vs_plain(check, cuda)
        del model
        if cuda:
            torch.cuda.empty_cache()
    del params


def path_e_legs(fused: dict, plain: dict) -> dict:
    """Path E's fused and plain decode pairs side by side: each graph and
    eager leg's wall ms, device ms (and by part) and kernels a step, and
    each prefill's s."""
    keys = ("wall_ms", "device_ms", "device_ms_by_part", "kernels_run",
            "host_launch_calls")
    out = {}
    for name, pair in (("fused", fused), ("plain", plain)):
        out[name] = dict(prefill_s=pair["prefill_s"], **{
            leg: {k: r.get(k) for k in keys}
            for leg, r in pair["legs"].items()})
    return out


def phase7(smi: str) -> dict:
    """Path E: gemma2-9b (7a) and zamba2-2.7b (7c) at full width and depth
    in bf16 through ``build_prefill_step`` / ``build_decode_step`` (and
    so ``Model.forward``), fused (their default on the card): after an
    untimed warm-up (a prefill and two decode steps),
    :func:`decode_pair`'s timed prefill and its graph and eager decode
    legs of ``PATH_E_DECODE`` timed steps, with the counts zeroed before
    and read after (flash launched ``flash`` times, in the one prefill;
    the dense decode launch, the decode qkv pass and the gate/up launch
    once a sublayer and step, the plain dense arithmetic never); then the
    same pair with ``fused=False`` (``PATH_E_PLAIN_DECODE`` timed steps),
    the two logged side by side; the fused steps against ``fused=False``
    at the seeded init (logged, P5) and at the published init at each
    ``published`` depth (held to ``path_e_bound``); then each at its cut
    depths in fp32 (7b, 7d). Returns each leg's launch counts."""
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
        with decode_stats_calls() as plain_calls, \
                plain_ssd_calls() as ssd_calls:
            rates = decode_pair(model, toks, PATH_E_DECODE, run["max_len"])
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
        assert_decode_pair(rates, cuda=True)
        # both legs' steps: one dense launch, decode qkv pass and gate/up
        # launch a sublayer, the plain arithmetic never
        steps = 2 * decode_positions(PATH_E_DECODE)
        for name, per_step in path_e_fusions(cfg).items():
            assert counts[leg][name] > 0, (name, counts[leg])
            if per_step:
                assert counts[leg][name] == per_step * steps, \
                    (name, counts[leg])
        assert counts[leg]["dense_decode_attention"] == \
            attention_calls(cfg) * steps and not plain_calls, counts[leg]
        # zamba2: the prompt's SSD once a layer in the one prefill, the
        # plain Mamba2 arithmetic never
        assert counts[leg]["ssd_chunk"] == mamba_layers(cfg) \
            and not ssd_calls, (counts[leg], len(ssd_calls))
        plain = decode_pair(model, toks, PATH_E_PLAIN_DECODE,
                            run["max_len"], fused=False)
        assert_decode_pair(plain, cuda=True)
        side = path_e_legs(rates, plain)
        log(f"phase{leg} {cfg.name} fused (the default) beside fused=False "
            f"in one run, a step's wall ms, device ms (by part) and "
            f"kernels: {json.dumps(side)}")
        assert side["fused"]["graph"]["kernels_run"] < \
            side["plain"]["graph"]["kernels_run"], side
        check = forward_fused_vs_plain(model, toks, FUSED_STEPS,
                                       run["max_len"])
        check.update(gate_up_share=0.0, qkv_share=0.0, mamba2_share=0.0)
        log(f"phase{leg} fused step vs fused=False at the seeded init "
            f"(P5: logged, not held), prefill + {FUSED_STEPS} steps: "
            f"{json.dumps(check)}")
        assert_path_e_fused_vs_plain(check, cuda=True, held=False)
        del model, toks
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        published_path_e_checks(cfg, run, "cuda")
        torch.cuda.empty_cache()
        log(f"phase{leg} published-init checks "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        top = max(run["depths"])
        params = dict(Model(dataclasses.replace(
            cfg, num_layers=top, compute_dtype="float32"), device="cuda",
            seed=0).params)
        for depth in run["depths"]:
            checks = path_e_checks(params, cfg, depth, run["prompt"],
                                   PATH_E_TAIL, "cuda",
                                   fused=run["fused_checks"])
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
#: config's train_microbatches = 2). The graph leg (the trainer's step a
#: replayed CUDA graph) runs its eager warm-up step, the step that
#: captures, ``steps`` timed replays and one traced step; the eager leg,
#: from the same init on the same schedule, its warm-up, ``eager_steps``
#: timed steps (3.0-3.9 s each, host-bound) and one traced
TRAIN_F = dict(arch="qwen2-1.5b", seq=4096, batch=2, full_batch=256,
               steps=6, eager_steps=3)
#: 8b: the card against the CPU, the same config cut to 2 layers at full
#: width (P5), fp32 compute, one 128-token row, two steps; checkpoint at
#: step 1 and resume into a fresh trainer for step 2
TRAIN_CHECK = dict(layers=2, seq=128, batch=1, steps=2)
#: 8b: the graph leg against two eager legs, 8a's config (bf16, two
#: microbatches, remat) and shape cut to 2 layers at full width; three
#: steps a leg: the graph's warm-up, its capture and a replay
TRAIN_EQUAL = dict(layers=2, seq=4096, batch=2, steps=3)
#: 8b's bound on the card-vs-CPU and resumed-vs-uninterrupted gaps
#: (relative): fp32 on both sides, other summation orders (and the
#: embedding's backward accumulates with atomics on the card); the
#: reference's own resume bound (tests/test_train.py)
TRAIN_RTOL = 1e-4
#: a replayed step's host launch calls: the graph launch and the batch's
#: upload, and the copies that read the loss, grad norm and lr back
MAX_GRAPH_LAUNCH_CALLS = 10
#: device ops a traced 8a step runs beside the step's own: the graph
#: leg's upload of the batch and the clones of its three outputs, the
#: eager leg's uploads of the tokens and the labels and their casts to
#: int64 (the reads of the three outputs are in both)
GRAPH_LEG_OPS = 1 + 3
EAGER_LEG_OPS = 2 + 2
#: a one-step trace loses some of the step's first and last device ops
#: (0-21 of ~90k seen, in either leg: the uploads, the first fills, the
#: reads back), so the replay is held to the eager step within this share
#: of its ops: a backward missing from the graph would be half of them.
#: Three-step traces (``profile_step --train``) count both steps whole
TRACE_LOST_SHARE = 1e-3


#: path F's weights: qwen2-1.5b's published initializer (initializer_range
#: 0.02 in its Hugging Face config), N(0, 0.02) for every matrix and
#: embedding, zeros for biases and norm offsets. The port's seeded init
#: (the reference's, fan_in the stacked shape's second-to-last dim) gives
#: a full-depth grad norm past fp32's range and a 2-layer model whose
#: step-2 grad norm moves 2% when half the weights move one ulp (P5)
INIT_STD = 0.02


def published_init(cfg, gen, dtype: str | None = None) -> dict:
    """Every fp32 master of ``cfg``'s model drawn from ``gen`` on its
    device, leaf by leaf in name order, with ``INIT_STD``; with ``dtype``
    each leaf cast to it as it is drawn (the same values as casting the
    fp32 tree, one fp32 leaf alive at a time: gemma2-9b's 9.24 B)."""
    import torch
    from repro_torch.models.common import torch_dtype
    from repro_torch.models.transformer import model_specs
    out = {}
    for name, spec in sorted(model_specs(cfg).items()):
        if spec.init in ("zeros", "ones"):
            t = torch.full(spec.shape, float(spec.init == "ones"),
                           device=gen.device)
        else:
            t = torch.randn(spec.shape, generator=gen,
                            device=gen.device).mul_(INIT_STD)
        out[name] = t if dtype is None else t.to(torch_dtype(dtype))
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
                 ckpt_every: int = 10 ** 9, cuda_graphs: bool = True,
                 mesh=None):
    from repro_torch.train.train_loop import TrainConfig, Trainer
    tcfg = TrainConfig(steps=steps, ckpt_every=ckpt_every,
                       ckpt_dir=str(ckpt_dir), log_every=10 ** 9,
                       adamw=train_adamw(steps))
    return Trainer(cfg, mesh, shape, tcfg, log_fn=log, device=device,
                   cuda_graphs=cuda_graphs)


def warm_steps(cuda_graphs: bool) -> int:
    """A leg's untimed first steps: the eager warm-up and, with graphs,
    the step that captures the graph (then replays it once)."""
    return 2 if cuda_graphs else 1


def train_leg(cfg, shape, steps: int, device, ckpt_dir,
              peak_flops: float | None = None, cuda_graphs: bool = True,
              total: int | None = None, trace: bool = False,
              mesh=None) -> dict:
    """8a (and 9e on ``mesh``), one leg: a trainer from
    :func:`published_init` (seed 0) through
    ``Trainer.run``, one step a call: its :func:`warm_steps`, ``steps``
    timed and, with ``trace``, one under ``torch.profiler`` (device ms,
    device ops and host launch calls a step; the CUDA activity alone, no
    host operators). The schedule is
    ``total`` steps long (default: the leg's). Each record: loss, grad
    norm, lr, ``kind`` (warm-up, capture, timed, traced), ``step_ms``
    (the trainer's own time of the step, which ends in the loss's read
    back and so waits for the stream, AdamW update included),
    ``enqueue_ms`` (until the step function returns, before that read),
    ``wall_ms`` (with the host's batch and a device sync), tokens/s and,
    with ``peak_flops``, the model-FLOPs share ``6 N tokens / (step s x
    peak)``. Returns the records, the trace and the leg's captures,
    capture s, graph pool bytes and, on the card, its peak memory."""
    import torch
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    warm = warm_steps(cuda_graphs)
    tr = make_trainer(cfg, shape, total or warm + steps + trace, device,
                      ckpt_dir, cuda_graphs=cuda_graphs, mesh=mesh)
    tr.init_state(published_init(
        cfg, torch.Generator(device=tr.device).manual_seed(0)))
    enqueue = []
    inner = tr.built.fn if tr.graph is None else tr.graph.step

    def step_fn(*args):
        t0 = time.perf_counter()
        out = inner(*args)
        enqueue.append(time.perf_counter() - t0)
        return out

    if tr.graph is None:
        tr.built.fn = step_fn
    else:
        tr.graph.step = step_fn
    tokens = shape.global_batch * shape.seq_len
    n = cfg.param_count()
    out = dict(cuda_graphs=cuda_graphs, records=[], trace=None)

    def record(kind: str, t0: float) -> None:
        rec = dict(tr.history[-1], kind=kind)
        rec["wall_ms"] = (time.perf_counter() - t0) * 1e3
        rec["step_ms"] = rec.pop("sec") * 1e3
        rec["enqueue_ms"] = enqueue[-1] * 1e3
        rec["tokens_per_s"] = tokens / rec["step_ms"] * 1e3
        if peak_flops:
            rec["flops_share"] = 6 * n * tokens / (
                rec["step_ms"] / 1e3 * peak_flops)
        out["records"].append(rec)

    for i in range(warm + steps):
        t0 = time.perf_counter()
        tr.run(steps=tr.step + 1)
        synchronize(device)
        record("timed" if i >= warm else "capture" if i else "warm-up", t0)
    if trace:
        from repro_torch.launch.profile_step import traced
        t0 = time.perf_counter()
        out["trace"] = traced(lambda: tr.run(steps=tr.step + 1), top=6,
                              reps=1, cpu=False, counts=True)
        record("traced", t0)
    g = tr.graph
    out.update(captures=int(g is not None and g.graph is not None),
               capture_s=g.capture_s if g else 0.0,
               replays=g.replays if g else 0,
               graph_pool_bytes=g.pool_bytes() if g else None)
    if cuda:
        out.update(max_memory_allocated_gb=torch.cuda.max_memory_allocated()
                   / 1e9,
                   memory_reserved_gb=torch.cuda.memory_reserved() / 1e9)
    return out


def leg_summary(leg: dict) -> dict:
    """A leg's medians over its timed steps, its first and last loss and
    what its trace and its graph recorded."""
    timed = [r for r in leg["records"] if r["kind"] == "timed"]

    def median(key):
        vals = sorted(r[key] for r in timed if key in r)
        return vals[len(vals) // 2] if vals else None

    out = dict(cuda_graphs=leg["cuda_graphs"], timed_steps=len(timed),
               **{f"median_{k}": median(k) for k in (
                   "step_ms", "wall_ms", "enqueue_ms", "tokens_per_s",
                   "flops_share")},
               min_step_ms=min(r["step_ms"] for r in timed),
               max_step_ms=max(r["step_ms"] for r in timed),
               first_loss=leg["records"][0]["loss"],
               last_loss=leg["records"][-1]["loss"])
    if leg["trace"] is not None:
        out.update(trace_fields(leg["trace"]))
    for k in ("captures", "capture_s", "replays", "graph_pool_bytes",
              "max_memory_allocated_gb", "memory_reserved_gb"):
        out[k] = leg.get(k)
    return out


def assert_training(recs: list[dict]) -> None:
    """Every loss finite, and the mean of the last three below the
    first."""
    losses = [r["loss"] for r in recs]
    assert all(math.isfinite(x) for x in losses), losses
    assert sum(losses[-3:]) / 3 < losses[0], losses


def assert_train_pair(graph: dict, eager: dict) -> None:
    """8a: the graph leg trains; a replay makes under
    ``MAX_GRAPH_LAUNCH_CALLS`` host launch calls and runs as many device
    ops as the eager step, as far as one-step traces count them."""
    assert_training(graph["records"])
    assert graph["captures"] == 1 and graph["replays"] >= 1, graph
    g, e = graph["trace"], eager["trace"]
    assert g["host_launch_calls_per_step"] < MAX_GRAPH_LAUNCH_CALLS, g
    gap = (g["device_kernels_per_step"] - GRAPH_LEG_OPS) - \
        (e["device_kernels_per_step"] - EAGER_LEG_OPS)
    assert abs(gap) <= TRACE_LOST_SHARE * e["device_kernels_per_step"], \
        kernel_diff(graph, eager)


def kernel_diff(graph: dict, eager: dict) -> dict:
    """The device ops whose runs a step differ between the legs' traces:
    {op: (graph, eager)}."""
    g, e = (leg["trace"]["kernel_counts"] for leg in (graph, eager))
    return {k: (g.get(k, 0), e.get(k, 0)) for k in sorted(set(g) | set(e))
            if g.get(k, 0) != e.get(k, 0)}


def train_state(tr) -> dict:
    """A trainer's masters, moments and count as one flat dict."""
    st = tr.opt_state
    return {**{f"p.{k}": t for k, t in tr.params.items()},
            **{f"{m}.{k}": t for m in ("m", "v") for k, t in st[m].items()},
            "count": st["count"]}


def compare_legs(a: dict, b: dict) -> dict:
    """Two legs' histories and final states: bit-equal or not, the leaves
    that differ (by name) and the largest gaps."""
    ha, hb = a["history"], b["history"]
    keys = ("loss", "grad_norm", "lr")
    differ = sorted(k for k in a["state"]
                    if not bool((a["state"][k] == b["state"][k]).all()))
    hist_equal = all(x[k] == y[k] for x, y in zip(ha, hb) for k in keys)
    return dict(
        bit_equal=hist_equal and not differ, history_equal=hist_equal,
        n_differing=len(differ), differing=differ[:12],
        max_abs=max((float((a["state"][k].double() - b["state"][k].double())
                           .abs().max()) for k in differ), default=0.0),
        loss_gap=max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                     for x, y in zip(ha, hb)),
        grad_norm_gap=max(abs(x["grad_norm"] - y["grad_norm"]) /
                          abs(y["grad_norm"]) for x, y in zip(ha, hb)))


def graph_vs_eager_training(cfg, device, ckpt_dir, layers: int, seq: int,
                            batch: int, steps: int) -> dict:
    """8b: ``cfg`` cut to ``layers`` at full width (its compute dtype,
    microbatches and remat kept), from one :func:`published_init` (seed
    0): two eager legs and a graph leg of ``steps`` steps each. Returns
    the eager legs against each other and the graph leg against the
    first."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    cut = dataclasses.replace(cfg, num_layers=layers)
    shape = ShapeSpec("f_equal", "train", seq, batch)
    params = published_init(cut, torch.Generator(device=device)
                            .manual_seed(0))
    legs = {}
    for name, graphs in (("eager", False), ("eager_again", False),
                         ("graph", True)):
        tr = make_trainer(cut, shape, steps, device,
                          pathlib.Path(ckpt_dir) / name, cuda_graphs=graphs)
        tr.init_state({k: v.clone() for k, v in params.items()})
        legs[name] = dict(history=tr.run(),
                          state={k: t.detach().clone()
                                 for k, t in train_state(tr).items()})
        if graphs and tr.graph.capture:
            assert tr.graph.replays == steps - 1, tr.graph.replays
        del tr
    return dict(eager_pair=compare_legs(legs["eager"], legs["eager_again"]),
                graph=compare_legs(legs["graph"], legs["eager"]),
                losses=[r["loss"] for r in legs["graph"]["history"]])


def assert_graph_vs_eager_training(check: dict) -> None:
    """Two eager legs bit-equal, and the graph leg bit-equal to them."""
    assert check["eager_pair"]["bit_equal"], check["eager_pair"]
    assert check["graph"]["bit_equal"], check["graph"]
    assert all(map(math.isfinite, check["losses"])), check["losses"]


def card_vs_cpu(cfg, device, ckpt_dir, layers: int, seq: int, batch: int,
                steps: int) -> dict:
    """8b: ``cfg`` cut to ``layers`` at full width, fp32, one microbatch,
    from one set of fp32 params (:func:`published_init`, seed 0, drawn on
    ``device`` and copied to the host): ``steps`` steps
    on ``device`` and on the CPU; then ``device`` again, saving at step 1,
    and a fresh trainer resumed from it for the rest; every trainer's
    step on its buffers, a CUDA graph on the card. Returns the
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
    """Path F: 8a trains full-width, full-depth qwen2-1.5b on the card,
    the step a replayed CUDA graph, beside an eager leg from the same
    init (counts zeroed before, read after: no kernel launches, the
    training forward runs the reference's plain arithmetic); 8b holds
    the graph leg bit-equal to two eager legs, the card against the CPU
    and a resumed run against an uninterrupted one; 8c builds the
    roofline cost model at full width and prices phase 3a's steps with
    it. Returns 8a's launch counts."""
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import launch_counts, reset_launch_counts
    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_F["arch"])
    shape = ShapeSpec("train_4k_cut", "train", TRAIN_F["seq"],
                      TRAIN_F["batch"])
    total = warm_steps(True) + TRAIN_F["steps"] + 1
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        legs = {}
        for name, graphs, steps in (("graph", True, TRAIN_F["steps"]),
                                    ("eager", False,
                                     TRAIN_F["eager_steps"])):
            t0 = time.perf_counter()
            legs[name] = train_leg(cfg, shape, steps, "cuda",
                                   pathlib.Path(tmp) / f"8a_{name}",
                                   sheet["bf16"], cuda_graphs=graphs,
                                   total=total, trace=True)
            gc.collect()
            torch.cuda.empty_cache()
            for i, rec in enumerate(legs[name]["records"]):
                log(f"phase8a {name} step {i} ({rec['kind']}): "
                    f"{json.dumps(rec)}")
            log(f"phase8a {name} leg {time.perf_counter() - t0:.1f} s")
        counts = launch_counts()
        g_loss, e_loss = ([r["loss"] for r in legs[k]["records"]]
                          for k in ("graph", "eager"))
        log(f"phase8a {cfg.name} training, {cfg.num_layers} layers at full "
            f"width (d_model {cfg.d_model}, {cfg.param_count() / 1e9:.3f} B "
            f"params), fp32 masters and {cfg.opt_state_dtype} moments, "
            f"{cfg.compute_dtype} compute, remat {cfg.remat}, "
            f"{cfg.train_microbatches} microbatches; train_4k's "
            f"{TRAIN_F['seq']}-token rows, global batch cut from "
            f"{TRAIN_F['full_batch']} to {TRAIN_F['batch']}; graph leg "
            f"and eager leg from one init on one schedule; on {smi}: "
            + json.dumps({name: leg_summary(leg)
                          for name, leg in legs.items()})
            + f"; the eager leg's {len(e_loss)} losses equal the graph "
            f"leg's first: {g_loss[:len(e_loss)] == e_loss}; launches "
            f"{counts}")
        for name, leg in legs.items():
            for rec in leg["trace"]["top_kernels"]:
                log(f"phase8a {name} top kernel: {json.dumps(rec)}")
            for rec in leg["trace"]["top_host"]:
                log(f"phase8a {name} top host op: {json.dumps(rec)}")
        log(f"phase8a device ops run a different number of times a step "
            f"(graph, eager): {json.dumps(kernel_diff(*legs.values()))}; "
            f"copies and fills a step: " + json.dumps({
                name: {k: n for k, n in leg["trace"]["kernel_counts"].items()
                       if k.startswith(("Memcpy", "Memset"))}
                for name, leg in legs.items()}))
        assert_train_pair(legs["graph"], legs["eager"])
        assert not any(counts.values()), f"a kernel ran on path F: {counts}"
        del legs

        t0 = time.perf_counter()
        check = graph_vs_eager_training(cfg, "cuda", pathlib.Path(tmp) /
                                        "8b_equal", **TRAIN_EQUAL)
        log(f"phase8b {cfg.name} cut to {TRAIN_EQUAL['layers']} full-width "
            f"layers, {cfg.compute_dtype}, B {TRAIN_EQUAL['batch']} x "
            f"{TRAIN_EQUAL['seq']} tokens, {TRAIN_EQUAL['steps']} steps "
            f"a leg, graph vs eager and eager vs eager (bit for bit): "
            f"{json.dumps(check)}; {time.perf_counter() - t0:.1f} s")
        assert_graph_vs_eager_training(check)
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        gaps = card_vs_cpu(cfg, "cuda", pathlib.Path(tmp) / "8b",
                           **TRAIN_CHECK)
        log(f"phase8b {cfg.name} cut to {TRAIN_CHECK['layers']} full-width "
            f"layers, fp32, B {TRAIN_CHECK['batch']} x {TRAIN_CHECK['seq']} "
            f"tokens, {TRAIN_CHECK['steps']} steps, graphs on, card vs CPU "
            f"and resumed vs uninterrupted (bound {TRAIN_RTOL} relative): "
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
#: 9e(i): the trainer's graph against its eager sharded step at full
#: width and depth (the config's bf16 compute, remat and 2 microbatches),
#: train_4k's rows halved, one row a microbatch: the graph leg's timed
#: replays after its warm-up and capture (to step 4), the eager leg's
#: timed steps after its warm-up (2.7-2.9 s each, host-bound; two keep
#: the script's time), then one traced step a leg: both legs run steps
#: 1-4
PATH_G_TRAIN_GRAPH = dict(seq=2048, batch=2, steps=2, eager_steps=2)
#: 9e(ii): the graph leg against the eager leg at 9b's cut, 4 steps a leg
PATH_G_TRAIN_EQUAL = dict(PATH_G_TRAIN, steps=4)
#: host launch calls a replay of 9e's graph may make: the graph launch,
#: the batch's upload, the clones of the loss, grad norm and lr and their
#: reads back
MAX_MESH_TRAIN_LAUNCH_CALLS = 8
#: 9e(i): the replay's device ms against the eager sharded step's
PATH_G_TRAIN_DEVICE_SHARE = 0.05
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


#: 9a's decode legs: the meshless step's graph, the sharded step eager
#: (``cuda_graphs=False``) and the sharded step's graph
PATH_G_LEGS = ("meshless", "sharded", "sharded_graph")
#: host launch calls a replay of 9a's sharded graph may make (the graph,
#: the inputs' upload and device copy, two clones)
MAX_SHARDED_LAUNCH_CALLS = 6


def decode_legs(dc, cache, nxt, prompt: int, steps: int, device) -> dict:
    """``steps`` decode steps of ``dc`` from a prefill's ``cache`` and
    next tokens ``nxt``: each step's next tokens and fp32 logits, the
    median wall ms a step, the final cache, and the step that continues
    it (one more position) for a trace."""
    import torch
    B = nxt.shape[0]
    state = dict(nxt=nxt, cache=cache, t=prompt)

    def one():
        state["nxt"], state["cache"], lg = dc.fn(
            state["cache"], state["nxt"][:, None].long(),
            torch.full((B,), state["t"], dtype=torch.int32), logits=True)
        state["t"] += 1
        return lg

    tokens, logits, ms = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        logits.append(one())
        synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(state["nxt"])
    return dict(tokens=tokens, logits=logits, cache=state["cache"],
                decode_ms=sorted(ms)[len(ms) // 2], one=one)


def sharded_serving(cfg, mesh, device, batch: int, prompt: int, steps: int,
                    seed: int = 0) -> dict:
    """9a: ``cfg``'s model drawn from ``seed``; its meshless prefill and
    the same prefill on ``mesh`` (the weights copied into DTensors), then
    ``steps`` decode steps of each of :data:`PATH_G_LEGS`, the two
    sharded legs from one sharded prefill (its cache cloned), the
    meshless leg from the meshless one. A warm-up run of it all, then a
    timed one, whose sharded prefill and eager sharded leg's kernel
    launches are counted; on the card, one more step of each leg under
    torch.profiler (device ms, device ops, host launch calls, NCCL
    kernels). Returns the legs' times and traces, the graph leg's
    captures and replays, the launch counts and whether the prefills'
    and every step's tokens and logits, and the final caches, agree bit
    for bit across the legs."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.sharding import full
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import Model
    from repro_torch.models.steps import build_decode_step, build_prefill_step
    model = Model(cfg, device=device, seed=seed)
    S = prompt + steps + 1                      # + the traced step
    pshape = ShapeSpec("g_prefill", "prefill", S, batch)
    dshape = ShapeSpec("g_decode", "decode", S, batch)
    # a mesh takes no fusion kernel: the meshless legs keep the same
    # plain spelling (fused=False), so that all three are bit-equal
    pf = {name: build_prefill_step(cfg, m, pshape, model=model,
                                   device=device, fused=False)
          for name, m in (("meshless", None), ("sharded", mesh))}
    dc = {leg: build_decode_step(cfg, None if leg == "meshless" else mesh,
                                 dshape, model=pf[leg.split("_")[0]].model,
                                 device=device,
                                 cuda_graphs=leg != "sharded", fused=False)
          for leg in PATH_G_LEGS}
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt),
                         generator=torch.Generator().manual_seed(seed)
                         ).to(device)

    def prefill(name):
        p = pf[name]
        synchronize(device)
        t0 = time.perf_counter()
        nxt, cache, lg = p.fn(p.model.init_cache(batch, S, p.rules), toks,
                              logits=True)
        synchronize(device)
        return nxt, cache, lg, (time.perf_counter() - t0) * 1e3

    def run():
        reset_launch_counts()
        pre = {"sharded": prefill("sharded")}
        clone = {k: v.clone() for k, v in pre["sharded"][1].items()}
        runs = {"sharded": decode_legs(dc["sharded"], pre["sharded"][1],
                                       pre["sharded"][0], prompt, steps,
                                       device)}
        counts = launch_counts()
        pre["meshless"] = prefill("meshless")
        runs["meshless"] = decode_legs(dc["meshless"], pre["meshless"][1],
                                       pre["meshless"][0], prompt, steps,
                                       device)
        runs["sharded_graph"] = decode_legs(
            dc["sharded_graph"], clone, pre["sharded"][0], prompt, steps,
            device)
        return pre, runs, counts

    run()                                               # warm-up
    pre, runs, counts = run()
    legs = {leg: dict(tokens=[pre[leg.split("_")[0]][0]] + r["tokens"],
                      logits=[pre[leg.split("_")[0]][2]] + r["logits"],
                      cache={k: full(v) for k, v in r["cache"].items()})
            for leg, r in runs.items()}
    a = legs["meshless"]
    out = dict(
        tokens_equal=all(torch.equal(x, y) for b in legs.values()
                         for x, y in zip(b["tokens"], a["tokens"])),
        logits_bit_equal=all(torch.equal(x, y) for b in legs.values()
                             for x, y in zip(b["logits"], a["logits"])),
        caches_bit_equal=all(torch.equal(b["cache"][k], a["cache"][k])
                             for b in legs.values() for k in a["cache"]),
        max_abs_logit_gap=max(float((x - y).abs().max())
                              for b in legs.values()
                              for x, y in zip(b["logits"], a["logits"])),
        finite=bool(torch.isfinite(a["logits"][-1]).all()),
        steps=steps,
        **{f"{name}_prefill_ms": p[3] for name, p in pre.items()},
        **{f"{leg}_decode_ms": r["decode_ms"] for leg, r in runs.items()},
        launches=counts)
    g = dc["sharded_graph"].graph
    out.update(graph_captures=g.captures, graph_capture_s=g.capture_s,
               graph_replays=g.replays, graph_pool_bytes=g.pool_bytes())
    if torch.device(device).type == "cuda":
        from repro_torch.launch.profile_step import traced
        for leg, r in runs.items():
            tr = traced(r["one"], top=6, reps=1, cpu=False, counts=True)
            out[f"{leg}_trace"] = dict(
                trace_fields(tr), nccl_kernels=sum(
                    n for k, n in tr["kernel_counts"].items()
                    if "nccl" in k.lower()))
    return out


def assert_sharded_serving(check: dict, cuda: bool = True) -> None:
    """The three legs agree bit for bit (the prefills' and every step's
    tokens and logits, the final caches); flash ran on the sharded path;
    on the card the sharded graph was captured and replayed on the later
    steps, a replay making at most ``MAX_SHARDED_LAUNCH_CALLS`` host
    launch calls; on the CPU nothing was captured."""
    assert check["tokens_equal"] and check["logits_bit_equal"], check
    assert check["caches_bit_equal"] and check["finite"], check
    if cuda:
        assert check["launches"]["flash_attention"] > 0, check
        assert check["graph_captures"] >= 1, check
        assert check["graph_replays"] >= check["steps"] - 2, check
        assert check["sharded_graph_trace"]["host_launch_calls"] <= \
            MAX_SHARDED_LAUNCH_CALLS, check
    else:
        assert check["graph_captures"] == 0, check


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


def sharded_train_legs(cfg, mesh, device, ckpt_dir, seq: int, batch: int,
                       steps: int, eager_steps: int,
                       peak_flops: float | None = None) -> dict:
    """9e(i): two :func:`train_leg` legs of ``cfg`` on ``mesh`` from one
    :func:`published_init` on one schedule, the graph leg (``steps``
    timed replays after its warm-up and capture) and the eager sharded
    leg (``eager_steps`` timed steps after its warm-up), each with one
    traced step on the card; each leg freed before the next. Returns the
    legs."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    cuda = torch.device(device).type == "cuda"
    shape = ShapeSpec("g_train_graph", "train", seq, batch)
    total = max(warm_steps(True) + steps, warm_steps(False) + eager_steps) \
        + 1
    legs = {}
    for name, graphs, n in (("graph", True, steps),
                            ("eager", False, eager_steps)):
        legs[name] = train_leg(cfg, shape, n, device,
                               pathlib.Path(ckpt_dir) / name, peak_flops,
                               cuda_graphs=graphs, total=total, trace=cuda,
                               mesh=mesh)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return legs


def nccl_kernels(trace: dict) -> float:
    """NCCL kernels a traced step ran."""
    return sum(n for k, n in trace["kernel_counts"].items()
               if "nccl" in k.lower())


def assert_sharded_train_legs(legs: dict, cuda: bool = True) -> None:
    """9e(i): every loss and grad norm that both legs ran bit-equal and
    finite; on the card the graph captured once and replayed, a replay
    making at most ``MAX_MESH_TRAIN_LAUNCH_CALLS`` host launch calls,
    its device ms within ``PATH_G_TRAIN_DEVICE_SHARE`` of the eager
    sharded step's."""
    g, e = (legs[k]["records"] for k in ("graph", "eager"))
    n = min(len(g), len(e))
    assert n >= warm_steps(False) + PATH_G_TRAIN_GRAPH["eager_steps"] + \
        cuda, (len(g), len(e))
    pairs = [((a["loss"], a["grad_norm"]), (b["loss"], b["grad_norm"]))
             for a, b in zip(g[:n], e[:n])]
    assert all(x == y for x, y in pairs), pairs
    assert all(math.isfinite(v) for x, _ in pairs for v in x), pairs
    if cuda:
        graph = legs["graph"]
        assert graph["captures"] == 1 and graph["replays"] >= 1, graph
        gt, et = graph["trace"], legs["eager"]["trace"]
        assert gt["host_launch_calls_per_step"] <= \
            MAX_MESH_TRAIN_LAUNCH_CALLS, gt["host_launch_calls"]
        gd, ed = gt["device_busy_ms_per_step"], et["device_busy_ms_per_step"]
        assert abs(gd - ed) <= PATH_G_TRAIN_DEVICE_SHARE * ed, (gd, ed)


def sharded_train_pair(cfg, mesh, device, ckpt_dir, layers: int, seq: int,
                       batch: int, steps: int) -> dict:
    """9e(ii): ``cfg`` cut to ``layers`` at full width, fp32, one
    microbatch, from :func:`published_init` (seed 0): ``steps`` steps of
    a graph leg and of an eager leg on ``mesh``, and step 1 of the
    meshless graph trainer, on one schedule. Returns the sharded legs
    against each other (histories, and every master, moment and the
    count by its local piece) and the graph leg's step-1 gaps to the
    meshless trainer."""
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.sharding import local
    cut = dataclasses.replace(cfg, num_layers=layers,
                              compute_dtype="float32", train_microbatches=1)
    params = {k: v.cpu() for k, v in published_init(
        cut, torch.Generator(device=device).manual_seed(0)).items()}
    shape = ShapeSpec("g_train_equal", "train", seq, batch)
    legs = {}
    for name, m, graphs, n in (("graph", mesh, True, steps),
                               ("eager", mesh, False, steps),
                               ("meshless", None, True, 1)):
        tr = make_trainer(cut, shape, steps, device,
                          pathlib.Path(ckpt_dir) / name, cuda_graphs=graphs,
                          mesh=m)
        tr.init_state(params)
        legs[name] = dict(history=tr.run(steps=n), state={
            k: local(t).detach().clone() for k, t in train_state(tr).items()})
        if graphs and tr.graph.capture:
            assert tr.graph.replays == n - 1, tr.graph.replays
        del tr
        gc.collect()

    def rel(x, y):
        return abs(x - y) / abs(y)

    (g1,), (p1,) = legs["graph"]["history"][:1], legs["meshless"]["history"]
    return dict(graph=compare_legs(legs["graph"], legs["eager"]),
                losses=[r["loss"] for r in legs["graph"]["history"]],
                loss_gap=rel(g1["loss"], p1["loss"]),
                grad_norm_gap=rel(g1["grad_norm"], p1["grad_norm"]))


def assert_sharded_train_pair(check: dict) -> None:
    """9e(ii): the graph leg bit-equal to the eager sharded leg, its step
    1 within ``PATH_G_TRAIN_RTOL`` of the meshless trainer's."""
    assert check["graph"]["bit_equal"], check["graph"]
    assert len(check["losses"]) == PATH_G_TRAIN_EQUAL["steps"] and \
        all(map(math.isfinite, check["losses"])), check
    assert max(check["loss_gap"], check["grad_norm_gap"]) <= \
        PATH_G_TRAIN_RTOL, check


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


def phase9(smi: str, sheet: dict) -> dict:
    """Path G: the sharded steps on a one-rank NCCL mesh (9a-9c), the
    production dry run (9d) and the sharded training step as a CUDA
    graph against the eager one (9e). Returns 9a's sharded-leg launch
    counts."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, one_rank_group
    t_phase = time.perf_counter()
    one_rank_group("cuda:0")
    try:
        mesh = make_host_mesh()
        assert tuple(mesh.shape) == (1, 1), mesh
        cfg = get_config(PATH_G["arch"])
        check = sharded_serving(cfg, mesh, "cuda", PATH_G["batch"],
                                PATH_G["prompt"], PATH_G["steps"])
        log(f"phase9a {cfg.name} at full width and depth ({cfg.num_layers} "
            f"layers, {cfg.compute_dtype}), B {PATH_G['batch']} x "
            f"{PATH_G['prompt']} prefill + {PATH_G['steps']} decode steps, "
            f"sharded on a {tuple(mesh.shape)} NCCL mesh (eager and its "
            f"CUDA graph) vs the meshless graph on the same weights, on "
            f"{smi}: {json.dumps(check)}")
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
        phase9e(cfg, mesh, smi, sheet)
    finally:
        dist.destroy_process_group()
    log(f"phase9 wall {time.perf_counter() - t_phase:.1f} s")
    return check["launches"]


def phase9e(cfg, mesh, smi: str, sheet: dict) -> None:
    """9e: path G's training step, each rank's CUDA graph against the
    eager sharded step on ``mesh``, (i) at full width and depth, (ii) at
    the 2-layer cut; no kernel launched."""
    import tempfile

    import torch
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        legs = sharded_train_legs(cfg, mesh, "cuda", tmp,
                                  peak_flops=sheet["bf16"],
                                  **PATH_G_TRAIN_GRAPH)
    for name, leg in legs.items():
        for i, rec in enumerate(leg["records"]):
            log(f"phase9e {name} step {i} ({rec['kind']}): "
                f"{json.dumps(rec)}")
    summary = {name: dict(leg_summary(leg),
                          nccl_kernels=nccl_kernels(leg["trace"]))
               for name, leg in legs.items()}
    log(f"phase9e(i) {cfg.name} training on a {tuple(mesh.shape)} NCCL "
        f"mesh, {cfg.num_layers} layers at full width, fp32 masters, "
        f"{cfg.compute_dtype} compute, remat {cfg.remat}, "
        f"{cfg.train_microbatches} microbatches, B "
        f"{PATH_G_TRAIN_GRAPH['batch']} x {PATH_G_TRAIN_GRAPH['seq']}; "
        f"graph leg vs eager sharded leg from one init on one schedule, on "
        f"{smi}: {json.dumps(summary)}; {time.perf_counter() - t0:.1f} s")
    for name, leg in legs.items():
        for rec in leg["trace"]["top_kernels"]:
            log(f"phase9e {name} top kernel: {json.dumps(rec)}")
    assert_sharded_train_legs(legs)
    del legs
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pair = sharded_train_pair(cfg, mesh, "cuda", tmp,
                                  **PATH_G_TRAIN_EQUAL)
    log(f"phase9e(ii) {cfg.name} cut to {PATH_G_TRAIN_EQUAL['layers']} "
        f"full-width layers, fp32, B {PATH_G_TRAIN_EQUAL['batch']} x "
        f"{PATH_G_TRAIN_EQUAL['seq']}, {PATH_G_TRAIN_EQUAL['steps']} steps "
        f"a leg: graph vs eager sharded (bit for bit) and step 1 vs the "
        f"meshless graph trainer (bound {PATH_G_TRAIN_RTOL} relative): "
        f"{json.dumps(pair)}; {time.perf_counter() - t0:.1f} s")
    assert_sharded_train_pair(pair)
    after = launch_counts()
    assert after == before, f"a kernel ran in 9e: {before} -> {after}"
    gc.collect()
    torch.cuda.empty_cache()


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

    t_start = t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"phase1 built {sorted(paths)} in {time.perf_counter() - t0:.1f} s")
    for name in sorted(paths):
        for line in _build.build_log(name).splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "error", "C75")):
                log(f"phase1 {name}: {line.strip()}")
    check_hgmma(paths["flash_attention"])

    hw = hardware_profile(kind)
    t0 = time.perf_counter()
    records = phase2(sheet, hw)
    log(f"phase2 wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts, qwen, samples = phase3(hw)
    log(f"phase3 wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    counts.update(rwkv6_scan=phase4(smi)["rwkv6_scan"])
    log(f"phase4 wall {time.perf_counter() - t0:.1f} s")
    path_c = phase5(qwen, hw)
    del qwen                  # phase 6 needs the card's memory
    gc.collect()
    torch.cuda.empty_cache()
    path_d = phase6(hw)
    gc.collect()
    torch.cuda.empty_cache()
    path_e = phase7(smi)
    # the dense launch's and the Mamba2 kernels' main path is path E's
    # steps (phase 7)
    for name in ("dense_decode_attention", *MAMBA2):
        counts[name] = sum(c[name] for c in path_e.values())
    gc.collect()
    torch.cuda.empty_cache()
    path_f = phase8(hw, smi, sheet, samples)
    gc.collect()
    torch.cuda.empty_cache()
    path_g = phase9(smi, sheet)
    log(f"chip_smoke wall {time.perf_counter() - t_start:.1f} s, the build "
        f"included")

    sources = {
        "paged_decode_attention": (
            "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention/kernel.py:116"),
        # no Pallas kernel: XLA's fusion of the reference's attend_decode
        # at C == 1 (Model.forward's one-token step)
        "dense_decode_attention": (
            "src/repro_torch/csrc/dense_decode.cu",
            "src/repro/models/attention.py:272"),
        "page_gather": ("src/repro_torch/csrc/page_copy.cu",
                        "src/repro/kernels/page_copy/kernel.py:45"),
        "page_scatter": ("src/repro_torch/csrc/page_copy.cu",
                         "src/repro/kernels/page_copy/kernel.py:70"),
        "token_append": ("src/repro_torch/csrc/page_copy.cu",
                         "src/repro/kernels/page_copy/kernel.py:114"),
        "token_append_indexed": ("src/repro_torch/csrc/page_copy.cu",
                                 "src/repro/kernels/page_copy/kernel.py:114"),
        "flash_attention": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/kernel.py:85"),
        # no Pallas kernel: XLA's fusion of the reference's attend_decode
        "flash_extend": ("src/repro_torch/csrc/flash_attention.cu",
                         "src/repro/models/attention.py:272"),
        "rwkv6_scan": ("src/repro_torch/csrc/rwkv6_scan.cu",
                       "src/repro/kernels/rwkv6_scan/kernel.py:75"),
        **FUSIONS,
        "qkv_rope_chunk": CHUNK_QKV,
        **MAMBA2,
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
