"""Where a serving step's time goes on the GPU.

Builds the model at full width with seeded weights, prefills ``--batch``
programs of ``--context`` tokens into a ``PagedKVRuntime`` in engine-sized
chunks, then measures a decode step of the whole batch and one prefill
chunk on top of that context:

- wall seconds (ending in ``torch.cuda.synchronize()``) against the host's
  enqueue seconds (returning before the device has finished), over
  ``--steps`` steps after warm-up;
- a ``torch.profiler`` trace of three steps: device time summed over all
  kernels against the traced wall time (the device's busy share), and the
  operators with the most device and host time.

Prints one JSON object. Needs one GPU::

    PYTHONPATH=src python -m repro_torch.launch.profile_step \\
        [--arch qwen2-1.5b] [--batch 4] [--context 2048] [--steps 8]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, resolve_device
from repro_torch.models import Model
from repro_torch.serving.paged_runtime import PagedKVRuntime

CHUNK = 512                       # the serve phase's prefill chunk


def _device_us(evt) -> float:
    v = getattr(evt, "self_device_time_total", None)
    return float(v if v is not None else evt.self_cuda_time_total)


def _timed(fn, steps: int) -> dict:
    enqueue, wall = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        enqueue.append(t1 - t0)
    return {"wall_ms_median": 1e3 * float(np.median(wall)),
            "enqueue_ms_median": 1e3 * float(np.median(enqueue)),
            "steps": steps}


def _traced(fn, top: int = 12) -> dict:
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    avgs = prof.key_averages()
    # device-side events (kernels, memcpy/memset) carry the device time
    # once; the host operators that launched them repeat it
    kernels = [e for e in avgs if e.device_type == DeviceType.CUDA]
    device_us = sum(_device_us(e) for e in kernels)
    by_dev = sorted(kernels, key=_device_us, reverse=True)[:top]
    by_cpu = sorted((e for e in avgs if e.device_type == DeviceType.CPU),
                    key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    return {
        "traced_wall_ms_per_step": wall_us / 3e3,
        "device_busy_ms_per_step": device_us / 3e3,
        "device_busy_share": device_us / wall_us,
        "top_kernels": [{"op": e.key, "calls_per_step": e.count / 3,
                        "device_ms_per_step": _device_us(e) / 3e3}
                       for e in by_dev],
        "top_host": [{"op": e.key, "calls_per_step": e.count / 3,
                      "host_ms_per_step": e.self_cpu_time_total / 3e3}
                     for e in by_cpu]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    model = Model(cfg, device=dev, seed=args.seed)
    page = 16
    per_prog = (args.context + CHUNK + 64 * args.steps) // page + 2
    rt = PagedKVRuntime(cfg, n_pages=(args.batch + 1) * per_prog,
                        page_size=page, device=dev)
    rng = np.random.default_rng(args.seed)
    pids = [f"p{b}" for b in range(args.batch)]
    for pid in pids + ["extend"]:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             args.context))
        for lo in range(0, args.context, CHUNK):
            rt.prefill(model, pid, toks[lo:lo + CHUNK], pad_to=CHUNK)
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, CHUNK))

    def decode():
        rt.decode_batch(model, pids)

    def prefill():
        rt.prefill(model, "extend", chunk, pad_to=CHUNK)
        rt.programs["extend"].length = args.context   # same context each time

    for fn in (decode, prefill):           # warm-up: allocator, cuBLAS
        fn()
        fn()
    torch.cuda.synchronize()
    before = launch_counts()
    out = {"device": torch.cuda.get_device_name(0), "arch": cfg.name,
           "batch": args.batch, "context": args.context, "chunk": CHUNK,
           "decode": {**_timed(decode, args.steps), **_traced(decode)},
           "prefill": {**_timed(prefill, args.steps), **_traced(prefill)}}
    after = launch_counts()
    out["kernel_launches"] = {k: after[k] - before[k] for k in after}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
