"""Wall time of a GELU model's prefill and decode under the two spellings
of the tanh GELU, in one process on the card.

- ``jax``: the port's ``models.common._gelu_tanh``, the ops of
  ``jax.nn.gelu(approximate=True)`` each rounded to the compute dtype, bit
  for bit the JAX package's bf16 activations;
- ``fused``: ``F.gelu(x, approximate="tanh")``, one op rounded once.

One seeded bf16 model of ``--arch`` at full width (``--layers`` cuts its
depth) through ``Model.forward``: a fresh prefill of ``--batch`` x
``--prompt`` tokens into a ``--max-len`` cache, then ``--steps`` greedy
decode steps, each part timed after the device has finished. The two
spellings alternate, the order flipped every round (jax fused fused jax
...), after one warm-up of each; the host drifts between processes, so
only numbers from one run are compared. Also the GELU alone on one FFN
activation of the prefill's shape (tokens, d_ff), by CUDA events, and
how far the fused spelling's last logits part from the port's. Run from
the root of a checkout, on the card::

    PYTHONPATH=src python3 -m repro_torch.launch.gelu_spellings \\
        [--arch gemma2-9b] [--layers N] [--batch 1] [--prompt 4600] \\
        [--max-len 4672] [--steps 32] [--rounds 2]

Prints one JSON object: the card's name and power limit, then each
spelling's median prefill seconds and decode ms a step.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time

import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import common

SPELLINGS = {"jax": common._gelu_tanh,
             "fused": lambda x: F.gelu(x, approximate="tanh")}


def run(model, toks, max_len: int, steps: int):
    """Prefill seconds, decode ms a step and the last logits."""
    B, T = toks.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.forward(toks, cache=model.init_cache(B, max_len),
                                  mode="prefill", logits_slice=1)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = model.forward(nxt, cache=cache, cache_len=T + i,
                                      mode="decode")
        nxt = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / max(steps, 1) * 1e3
    assert torch.isfinite(logits).all()
    return prefill_s, decode_ms, logits[:, -1].float()


def op_ms(fn, x, iters: int = 20) -> float:
    """Median device ms of ``fn(x)`` by CUDA events."""
    fn(x)
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn(x)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-9b")
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt", type=int, default=4600)
    ap.add_argument("--max-len", type=int, default=4672)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    cfg = dataclasses.replace(get_config(args.arch),
                              compute_dtype="bfloat16")
    if cfg.activation != "gelu":
        raise SystemExit(f"{args.arch} has no GELU ({cfg.activation})")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = Model(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                         generator=gen, device="cuda")
    prefill = {k: [] for k in SPELLINGS}
    decode = {k: [] for k in SPELLINGS}
    last = {}
    order = ["jax", "fused"]
    try:
        for r in range(args.rounds + 1):
            for name in (order if r % 2 == 0 else order[::-1]):
                common._gelu_tanh = SPELLINGS[name]
                p, d, last[name] = run(model, toks, args.max_len,
                                       args.steps)
                if r:                   # round 0 warms both up
                    prefill[name].append(p)
                    decode[name].append(d)
    finally:
        common._gelu_tanh = SPELLINGS["jax"]
    x = torch.randn(args.batch * args.prompt, cfg.d_ff, generator=gen,
                    device="cuda").to(torch.bfloat16)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(json.dumps(dict(
        card=card, arch=args.arch, layers=cfg.num_layers, batch=args.batch,
        prompt=args.prompt, steps=args.steps, rounds=args.rounds,
        prefill_s={k: statistics.median(v) for k, v in prefill.items()},
        prefill_s_all=prefill,
        decode_ms_per_step={k: statistics.median(v)
                            for k, v in decode.items()},
        decode_ms_all=decode,
        gelu_op_ms={k: op_ms(fn, x) for k, fn in SPELLINGS.items()},
        gelu_op_shape=list(x.shape),
        fused_vs_jax_last_logits=dict(
            max_abs=(last["fused"] - last["jax"]).abs().max().item(),
            argmax_equal=bool(torch.equal(last["fused"].argmax(-1),
                                          last["jax"].argmax(-1)))))))


if __name__ == "__main__":
    main()
