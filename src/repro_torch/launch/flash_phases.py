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
    print(json.dumps(dict(card=smi, block_k=plan.block_k, phases=report)))


if __name__ == "__main__":
    main()
