"""Host and wall time of one MoE layer's ``moe_apply`` at full width.

One layer of ``--arch`` (default qwen3-moe-235b-a22b) with seeded bf16
weights, called at a decode batch (``--batch`` rows of one token) and at
a prefill chunk (``--chunk`` tokens): the median host enqueue ms and wall
ms (ending in a device sync) over ``--reps`` calls after ``--warmup``. With ``--against FILE``, another tree's
``models/moe.py``, that module's ``moe_apply`` is called in turn with
this tree's on the same weights and inputs (the order flipped every
round), its outputs held equal bit for bit first: two versions compared
inside one process, where the host's drift between processes does not
enter. Run from the root of a checkout, on the card::

    PYTHONPATH=src python3 -m repro_torch.launch.moe_layer \\
        [--against build/pair/parent/src/repro_torch/models/moe.py]

Prints one JSON object: the card's name and power limit, then each
shape's medians for each version (``this``, ``against``).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import resolve_device
from repro_torch.models import moe


def layer_params(cfg, gen) -> dict:
    """One MoE layer's leaves, normal with std fan_in^-1/2 (fan_in the
    second-to-last dim, as the seeded init takes it), in bf16 as the
    model holds them after its cast (the router too, ROADMAP R6), the
    shared experts nested."""
    p: dict = {}
    for name, spec in moe.moe_specs(cfg, "bfloat16").items():
        t = torch.randn(spec.shape, generator=gen, device=gen.device)
        t = t.mul_(spec.shape[-2] ** -0.5).to(torch.bfloat16)
        *path, leaf = name.split(".")
        node = p
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return p


def timed(fn) -> tuple[float, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--against", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    versions = {"this": moe}
    if args.against:
        spec = importlib.util.spec_from_file_location("moe_against",
                                                      args.against)
        versions["against"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(versions["against"])
    cfg = get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    p = layer_params(cfg, gen)
    out = {"card": smi, "arch": cfg.name, "reps": args.reps}
    for label, shape in ((f"decode_B{args.batch}", (args.batch, 1)),
                         (f"prefill_{args.chunk}", (1, args.chunk))):
        x = torch.randn(*shape, cfg.d_model, generator=gen,
                        device=dev).to(torch.bfloat16)
        ys = [v.moe_apply(p, x, cfg) for v in versions.values()]
        assert all(torch.equal(ys[0], y) for y in ys), "versions differ"
        samples = {name: [] for name in versions}
        names = list(versions)
        for r in range(args.warmup + args.reps):
            for name in (names if r % 2 else names[::-1]):
                t = timed(lambda: versions[name].moe_apply(p, x, cfg))
                if r >= args.warmup:
                    samples[name].append(t)
        out[label] = {name: {
            "enqueue_ms_median": float(np.median([e for e, _ in s])),
            "wall_ms_median": float(np.median([w for _, w in s]))}
            for name, s in samples.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
