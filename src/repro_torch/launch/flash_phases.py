"""Where a key-tile iteration of the bf16 flash kernel spends its cycles.

Builds ``csrc/flash_attention.cu`` with ``-DREPRO_FLASH_PHASES`` (the
kernel's phase probes: ``clock64()`` stamps by the first warp of each
warpgroup of the heaviest CTA), runs the kernel at qwen2-1.5b's prefill
shapes with each query-tile height, and prints one JSON object: for each
case and warpgroup, the mean cycles of an iteration and of its phases

- ``wait_kv``: waiting for the stage's TMA bytes;
- ``turn``: waiting for the other warpgroup to hand over the tensor cores;
- ``issue``: issuing S_t = Q K_t^T and O += P_{t-1} V_{t-1} (blocks while
  the tensor cores are busy);
- ``wait_s``: waiting for S_t;
- ``softmax``: scale, mask, row max, exp and row sums of S_t;
- ``wait_pv``: waiting for P_{t-1} V_{t-1};
- ``rescale_pack``: releasing the stage (and refilling it, for the last
  group), rescaling O and packing P_t to bf16.

The same build stamps the bf16 extend launch (``flash_extend_kernel``):
thread 0 of every CTA at its start, after its barriers are set up, when Q
and its first K/V stage have landed, after its last P V, after the
cluster's first barrier, after its partial is pushed and the second
barrier, after the merge's sums and at its end (``EXTEND_POINTS``), with
the global timer at its start and end. At path A's chunk for each slice count in ``EXTEND_SLICES`` and
offsets 2048 and 0 it prints each segment's mean and largest cycles over
the CTAs, and the spread of the CTAs' start and end times (ns) against
the kernel's first start.

The probes are compiled out of the library the port runs. Needs one GPU::

    PYTHONPATH=src python -m repro_torch.launch.flash_phases
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as flash

PHASES = ("wait_kv", "turn", "issue", "wait_s", "softmax", "wait_pv",
          "rescale_pack")
CASES = ((2048, 128), (2048, 64), (512, 64), (512, 128))  # (S, q_tile)
SHAPE = dict(B=1, H=12, KV=2, D=128)                     # qwen2-1.5b


EXTEND_POINTS = ("start", "barriers", "first_tile", "last_pv",
                 "cluster_synced", "pushed", "merged", "end")
EXTEND_SLICES = (1, 2, 3, 4)
EXTEND_OFFSETS = (2048, 0)
EXTEND_SHAPE = dict(B=1, H=12, KV=2, C=512, T=2560, D=128)   # path A
PROBE_CTAS = 1024                                 # kProbeCtas


def extend_probes(lib, gen) -> dict:
    """Segments of the extend launch's CTAs, by slice count and offset."""
    B, H, KV, C, T, D = (EXTEND_SHAPE[k] for k in
                         ("B", "H", "KV", "C", "T", "D"))
    q = torch.randn((B, C, H, D), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2)
    k, v = (torch.randn((B, T, KV, D), generator=gen, device="cuda").to(
        torch.bfloat16).transpose(1, 2) for _ in range(2))
    out = {}
    for off in EXTEND_OFFSETS:
        offs = torch.full((B,), off, dtype=torch.int32, device="cuda")
        for slices in EXTEND_SLICES:
            plan = flash.plan_extend(B, H, KV, C, T, D, slices=slices)
            for _ in range(3):
                flash.flash_extend_kernel(q, k, v, offs, _slices=slices)
            torch.cuda.synchronize()
            clocks = np.zeros((PROBE_CTAS, len(EXTEND_POINTS)), np.int64)
            times = np.zeros((PROBE_CTAS, 2), np.uint64)
            err = lib.flash_extend_probes_read(
                ctypes.c_void_p(clocks.ctypes.data),
                ctypes.c_void_p(times.ctypes.data))
            if err:
                raise RuntimeError(f"flash_extend_probes_read: {err}")
            n = plan.ctas
            c, t = clocks[:n], times[:n].astype(np.int64)
            segs = {}
            for i in range(1, len(EXTEND_POINTS)):
                d = c[:, i] - c[:, i - 1]
                ok = (c[:, i] >= c[:, i - 1]) & (c[:, i] <= c[:, -1]) & \
                    (c[:, i - 1] >= c[:, 0])
                if ok.any():
                    segs[EXTEND_POINTS[i]] = dict(
                        mean=float(d[ok].mean()), max=int(d[ok].max()),
                        ctas=int(ok.sum()))
            t0 = t[:, 0].min()
            out[f"off{off}_slices{slices}"] = dict(
                ctas=n, cycles_start_to_end_max=int((c[:, -1] - c[:, 0])
                                                    .max()),
                segments=segs,
                start_ns_max=int((t[:, 0] - t0).max()),
                end_ns_min=int((t[:, 1] - t0).min()),
                end_ns_max=int((t[:, 1] - t0).max()))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("flash_phases: CUDA is not available")
    lib = _build.load_variant("flash_attention", ("-DREPRO_FLASH_PHASES",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    report = {}
    for S, q_tile in CASES:
        B, H, KV, D = (SHAPE[k] for k in ("B", "H", "KV", "D"))
        q, k, v = (torch.randn(dims, generator=gen, device="cuda")
                   .to(torch.bfloat16)
                   for dims in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D)))
        for _ in range(3):
            flash.flash_attention_kernel(q, k, v, _q_tile=q_tile)
        torch.cuda.synchronize()
        stamps = np.zeros((2, 64, 8), np.int64)
        err = lib.flash_phases_read(ctypes.c_void_p(stamps.ctypes.data))
        if err:
            raise RuntimeError(f"flash_phases_read: CUDA error {err}")
        plan = flash.plan_bf16(B, H, S, D, q_tile)
        n_tiles = -(-min(S, plan.q_tile * plan.grid[0]) // plan.block_k)
        rows = {}
        for wg in range(q_tile // 64):
            it = stamps[wg, 1:n_tiles]            # iterations 1 .. n - 1
            rows[f"warpgroup_{wg}"] = dict(
                iterations=len(it),
                cycles_per_iteration=float(np.diff(it[:, 0]).mean()),
                **{name: float(c) for name, c in
                   zip(PHASES, np.diff(it, axis=1).mean(0))})
        report[f"S{S}_q_tile{q_tile}"] = rows
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps(dict(card=smi, block_k=plan.block_k, phases=report,
                          extend=extend_probes(lib, gen))))


if __name__ == "__main__":
    main()
