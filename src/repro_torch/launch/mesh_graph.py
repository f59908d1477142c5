"""Path G across cards: the sharded decode step's CUDA graph against its
eager step on every rank of a multi-rank mesh, where the step's
collectives run (a one-rank mesh runs none).

Starts four processes, one a card (NCCL; with ``--device cpu`` gloo on
the CPU), on a free local port. On each of the meshes (1, 4) and (2, 2),
each rank draws full-width, full-depth qwen2-1.5b (``--smoke``: its
smoke width) from seed 0, runs ``build_prefill_step``'s sharded prefill
of a 4 x 512 prompt, clones the cache, and decodes 8 greedy tokens
twice from it: through ``build_decode_step``'s eager step
(``cuda_graphs=False``) and through its graph (captured at the second
step, replayed after). The batch of 4 takes the long-decode rules, so
qwen2's cache is split on its sequence (over "model" on (1, 4), over
"data" on (2, 2)) and its vocab on "model": the step all-reduces the
attention's softmax stats and all-gathers the argmax's candidates. Rank
0 prints one JSON line a mesh: whether every step's tokens and logits
and the final caches are bit-equal between the legs on every rank, each
leg's median wall ms a step, and on the card one more step of each leg
under torch.profiler (device ms, device ops, host launch calls, NCCL
kernels: the collectives a replay holds).

``--train``: path G's training step instead. On each mesh each rank
trains full-width, full-depth qwen2-1.5b (``--smoke``: its smoke width)
from seed 0 on 4 x 512-token rows in the config's 2 microbatches, 4
steps, twice: through ``Trainer(cfg, mesh, cuda_graphs=False)``'s eager
sharded step and through its graph (``TrainGraph``: warm-up, capture at
step 2, replays after). Rank 0 prints one JSON line a mesh: whether
every loss and grad norm and, after step 4, the rank's local masters,
moments and count are bit-equal between the legs on every rank, each
leg's median wall ms a step (after its warm-up, and capture) and on the
card one more step of each leg under torch.profiler (the NCCL kernels
are the grads' reductions onto their masters' placements and the grad
norm's sums: inside the graph). Needs four cards::

    PYTHONPATH=src python -m repro_torch.launch.mesh_graph [--train] \
        [--device cpu --smoke]
"""
from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time

import torch

LEGS = ("eager", "graph")
RANKS = 4
MESHES = ((1, 4), (2, 2))
ARCH = "qwen2-1.5b"
BATCH, PROMPT, STEPS = 4, 512, 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 4
TIMEOUT_S = 600


def _args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--train", action="store_true",
                    help="the training step's graph against its eager step")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    """The parent: builds the kernels once (the decode step's; the
    training step launches none), starts the ranks, waits for every one
    of them (or kills them all) and passes rank 0's lines on."""
    args = _args(argv)
    if args.rank is not None:
        return _rank(args)
    if args.device == "cuda":
        from repro_torch.kernels import _build, resolve_device
        resolve_device("cuda")
        if torch.cuda.device_count() < RANKS:
            raise SystemExit(f"{RANKS} ranks need {RANKS} cards, "
                             f"{torch.cuda.device_count()} visible")
        if not args.train:
            _build.build_all()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    argv = sys.argv[1:] if argv is None else list(argv)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.mesh_graph", *argv,
         "--rank", str(r), "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(RANKS)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r}: {err[-3000:]}" for r, (p, (_, err)) in
              enumerate(zip(procs, outs)) if p.returncode]
    if failed:
        print("\n".join(failed), file=sys.stderr)
        return 1
    print(outs[0][0], end="")
    return 0


def _rank(args) -> int:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    cuda = args.device == "cuda"
    dev = torch.device("cuda", args.rank) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)        # four ranks share the cores
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://127.0.0.1:{args.port}", rank=args.rank,
        world_size=RANKS, **({"device_id": dev} if cuda else {}))
    try:
        cfg = get_config(ARCH, smoke=args.smoke)
        for dims in MESHES:
            mesh = init_device_mesh(dev.type, dims,
                                    mesh_dim_names=("data", "model"))
            out = (_train_pair if args.train else _pair)(cfg, mesh, dev)
            same = [None] * RANKS
            dist.all_gather_object(same, out.pop("bit_equal"))
            if args.rank == 0:
                print(json.dumps(dict(
                    mesh=list(dims), arch=cfg.name, layers=cfg.num_layers,
                    device=torch.cuda.get_device_name(dev) if cuda else
                    "cpu", bit_equal_on_every_rank=all(same), **out)),
                    flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _pair(cfg, mesh, dev) -> dict:
    """One sharded prefill, then the eager and the graph decode legs from
    its cache (cloned): their agreement, times, captures and traces."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.sharding import full
    from repro_torch.models import Model
    from repro_torch.models.steps import build_decode_step, build_prefill_step
    B, S = BATCH, PROMPT + STEPS + 1
    model = Model(cfg, device=dev, seed=0)
    pf = build_prefill_step(cfg, mesh, ShapeSpec("p", "prefill", S, B),
                            model=model, device=dev)
    dc = {leg: build_decode_step(cfg, mesh, ShapeSpec("d", "decode", S, B),
                                 model=pf.model, device=dev,
                                 cuda_graphs=leg == "graph")
          for leg in LEGS}
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    nxt, cache = pf.fn(pf.model.init_cache(B, S, pf.rules), toks)
    caches = {"eager": cache,
              "graph": {k: v.clone() for k, v in cache.items()}}
    runs = {leg: _leg(dc[leg], caches[leg], nxt, dev) for leg in LEGS}
    e, g = runs["eager"], runs["graph"]
    bit_equal = all(torch.equal(a, b) for a, b in
                    zip(e["logits"] + e["tokens"], g["logits"] + g["tokens"]))
    bit_equal &= all(torch.equal(full(e["cache"][k]), full(g["cache"][k]))
                     for k in e["cache"])
    graph = dc["graph"].graph
    out = dict(bit_equal=bit_equal, batch=B, prompt=PROMPT, steps=STEPS,
               captures=graph.captures,
               capture_s=graph.capture_s, replays=graph.replays,
               **{f"{leg}_wall_ms": r["wall_ms"] for leg, r in runs.items()})
    if dev.type == "cuda":
        from repro_torch.launch.profile_step import traced
        for leg, r in runs.items():
            tr = traced(r["one"], top=6, reps=1, cpu=False, counts=True)
            out[f"{leg}_trace"] = dict(
                device_ms=tr["device_busy_ms_per_step"],
                device_ops=tr["device_kernels_per_step"],
                host_launch_calls=tr["host_launch_calls_per_step"],
                nccl_kernels={k: n for k, n in tr["kernel_counts"].items()
                              if "nccl" in k.lower()})
    return out


def _train_pair(cfg, mesh, dev) -> dict:
    """The eager and the graph training legs on ``mesh`` from one seeded
    init on one schedule, each freed before the next: their agreement,
    times, capture and traces."""
    import gc
    import tempfile

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.sharding import local
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import TrainConfig, Trainer
    cuda = dev.type == "cuda"
    shape = ShapeSpec("mesh_train", "train", TRAIN_SEQ, TRAIN_BATCH)
    runs = {}
    for leg in LEGS:
        with tempfile.TemporaryDirectory() as tmp:
            tr = Trainer(cfg, mesh, shape, TrainConfig(
                steps=TRAIN_STEPS + 1, ckpt_every=10 ** 9, ckpt_dir=tmp,
                log_every=10 ** 9, adamw=opt_mod.AdamWConfig(
                    lr=3e-4, warmup_steps=1, total_steps=TRAIN_STEPS + 1)),
                log_fn=lambda s: None, device=dev,
                cuda_graphs=leg == "graph")
            tr.init_state()
            ms = []
            for _ in range(TRAIN_STEPS):
                t0 = time.perf_counter()
                tr.run(steps=tr.step + 1)
                if cuda:
                    torch.cuda.synchronize(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            st = tr.opt_state
            timed = sorted(ms[2 if leg == "graph" else 1:])
            run = dict(
                history=[(h["loss"], h["grad_norm"]) for h in tr.history],
                state=[local(t).detach().clone() for t in (
                    *tr.params.values(), *st["m"].values(),
                    *st["v"].values(), st["count"])],
                wall_ms=timed[len(timed) // 2])
            if cuda:
                from repro_torch.launch.profile_step import traced
                trace = traced(lambda: tr.run(steps=tr.step + 1), top=6,
                               reps=1, cpu=False, counts=True)
                run["trace"] = dict(
                    device_ms=trace["device_busy_ms_per_step"],
                    device_ops=trace["device_kernels_per_step"],
                    host_launch_calls=trace["host_launch_calls_per_step"],
                    nccl_kernels={k: n for k, n in
                                  trace["kernel_counts"].items()
                                  if "nccl" in k.lower()})
            if tr.graph is not None:
                run.update(capture_s=tr.graph.capture_s,
                           replays=tr.graph.replays,
                           pool_bytes=tr.graph.pool_bytes())
            runs[leg] = run
            del tr
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    e, g = runs["eager"], runs["graph"]
    bit_equal = e["history"] == g["history"] and all(
        torch.equal(a, b) for a, b in zip(e["state"], g["state"]))
    out = dict(bit_equal=bit_equal, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               steps=TRAIN_STEPS, microbatches=cfg.train_microbatches,
               losses=[x for x, _ in g["history"]],
               **{k: g.get(k) for k in ("capture_s", "replays",
                                        "pool_bytes")},
               **{f"{leg}_wall_ms": r["wall_ms"] for leg, r in runs.items()})
    if cuda:
        out.update({f"{leg}_trace": r["trace"] for leg, r in runs.items()})
    return out


def _leg(step, cache, nxt, dev) -> dict:
    """``STEPS`` greedy decode steps from the prefill's next tokens: each
    step's logits and next tokens, the final cache, the median wall ms a
    step, and the step that continues the leg (for a trace)."""
    B = nxt.shape[0]
    state = dict(nxt=nxt, cache=cache, t=PROMPT)

    def one():
        state["nxt"], state["cache"], lg = step.fn(
            state["cache"], state["nxt"][:, None],
            torch.full((B,), state["t"], dtype=torch.int32), logits=True)
        state["t"] += 1
        return lg

    logits, tokens, ms = [], [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        logits.append(one())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
        tokens.append(state["nxt"])
    return dict(logits=logits, tokens=tokens, cache=state["cache"],
                wall_ms=sorted(ms)[len(ms) // 2], one=one)


if __name__ == "__main__":
    raise SystemExit(main())
