"""Where decode attention's bf16 dense kernel spends its time.

Builds ``csrc/dense_decode.cu`` with ``-DREPRO_DENSE_PROBES`` (thread 0 of
every CTA stamps ``clock64()`` at its start, once set up, when its first
stage has landed, after consumer warp 0's last stage, when the producer
has issued its last stage, when every consumer is done, after the CTA's
record, after the cluster's first barrier and at its end; warp 0's cycles
waiting for stages and computing them, the producer's waiting for free
stages; the global timer at its start and end and its SM), and the same
build with ``-DREPRO_DENSE_SKIP=1`` (no arithmetic: the load pipeline
alone) and ``=2`` (no copies: the arithmetic alone). At path E's shapes
(``chip_smoke.py``'s DENSE_DECODE) it times each build by CUDA-graph
replay over 4 caches in turn (cold in L2), and prints one JSON object
with each segment's mean and largest cycles over the CTAs, the kernel's
span on the global timer, and the CTAs an SM held. The probes are
compiled out of the library the port runs. Needs one GPU::

    PYTHONPATH=src python -m repro_torch.launch.dense_probes
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.launch.kernel_pair import DENSE, DENSE_SETS, graph_ms

VARIANTS = {"probes": (), "no_compute": ("-DREPRO_DENSE_SKIP=1",),
            "no_loads": ("-DREPRO_DENSE_SKIP=2",)}
POINTS = ("start", "set_up", "first_in", "warp0_done", "producer_done",
          "consumers_done", "record", "cluster_synced", "end",
          "warp0_wait", "warp0_busy", "producer_wait")
SEGMENTS = {"set_up": (0, 1), "first_in": (1, 2), "warp0_loop": (2, 3),
            "producer": (1, 4), "consumers": (1, 5), "record": (5, 6),
            "cluster_wait": (6, 7), "merge": (7, 8), "total": (0, 8)}
PROBE_CTAS = 1024                                  # kProbeCtas
SHAPES = ("gemma2-9b global", "gemma2-9b local ring", "zamba2-2.7b shared")


def probe_case(lib, name: str, gen) -> dict:
    B, T, KV, G, D, cap, off = DENSE[name]
    caches = [torch.randn((DENSE_SETS, B, T, KV, D), generator=gen,
                          device="cuda").to(torch.bfloat16)
              for _ in range(2)]
    q = torch.randn((B, KV * G, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    offs = torch.full((B,), off, dtype=torch.int32, device="cuda")
    window = T if "ring" in name else 0
    turn = iter(range(1 << 30))

    def call():
        i = next(turn) % DENSE_SETS
        return dk.dense_decode_attention_kernel(
            q, caches[0][i], caches[1][i], offs, softcap=cap, window=window)

    out = dict(graph_ms=graph_ms(call, iters=4 * DENSE_SETS))
    call()
    torch.cuda.synchronize()
    clocks = np.zeros((PROBE_CTAS, len(POINTS)), np.int64)
    times = np.zeros((PROBE_CTAS, 3), np.uint64)
    err = lib.dense_probes_read(ctypes.c_void_p(clocks.ctypes.data),
                                ctypes.c_void_p(times.ctypes.data))
    if err:
        raise RuntimeError(f"dense_probes_read: CUDA error {err}")
    plan = dk.plan_dense_decode(B, T, KV, G, D, 2)
    n = int(np.prod(plan.grid))
    clocks, times = clocks[:n], times[:n]
    for k, (a, b) in SEGMENTS.items():
        d = (clocks[:, b] - clocks[:, a]).astype(np.float64)
        out[k] = dict(mean=float(d.mean()), max=float(d.max()))
    for i, k in ((9, "warp0_wait"), (10, "warp0_busy"),
                 (11, "producer_wait")):
        out[k] = dict(mean=float(clocks[:, i].mean()),
                      max=float(clocks[:, i].max()))
    t0 = times[:, 0].astype(np.int64)
    t1 = times[:, 1].astype(np.int64)
    out["span_ns"] = int(t1.max() - t0.min())
    out["start_spread_ns"] = int(t0.max() - t0.min())
    sms = np.bincount(times[:, 2].astype(np.int64))
    out["sms_used"] = int((sms > 0).sum())
    out["ctas_an_sm_max"] = int(sms.max())
    out["plan"] = dict(route=plan.route, grid=list(plan.grid),
                       **{k: getattr(plan.split, k) for k in (
                           "heads", "cluster", "split", "stages")})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dense_probes: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    out = {"card": smi}
    for variant, flags in VARIANTS.items():
        lib = _build.load_variant("dense_decode",
                                  ("-DREPRO_DENSE_PROBES",) + flags)
        lib.dense_probes_read.argtypes = [ctypes.c_void_p] * 2
        gen = torch.Generator(device="cuda").manual_seed(6)
        out[variant] = {name: probe_case(lib, name, gen) for name in SHAPES}
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
