"""Where a serving step's time goes on the GPU.

Builds the model at full width with seeded weights, prefills ``--batch``
programs of ``--context`` tokens into a ``PagedKVRuntime`` in engine-sized
chunks, then measures a decode step of the whole batch and one prefill
chunk on top of that context:

- wall seconds (ending in ``torch.cuda.synchronize()``) against the host's
  enqueue seconds (returning before the device has finished), over
  ``--steps`` steps after warm-up;
- a ``torch.profiler`` trace of three steps: device time summed over all
  kernels against the traced wall time (the device's busy share), the
  kernels the device ran and the launch calls the host made a step
  (``cudaLaunchKernel`` and its kin, ``cudaGraphLaunch``), and the
  operators with the most device and host time.

The decode step and the prefill chunk are the paged runtime's CUDA
graphs, replayed (the chunk's bucket is captured at its second use,
inside the warm-up), unless ``--eager`` asks for the eager steps
(``PagedKVRuntime(cuda_graphs=False)``); run both in one call to compare
them. The decode step and the chunk run their chains as the fused kernels
of ``kernels/fusions``, and the extend chunk its attention as the flash
kernels' extend launch, unless ``--plain`` asks for their plain spelling
(``PagedKVRuntime(fused=False)``); a trace splits a step's device time
into products, attention, the Mamba2 mixer ("ssm"), fusions and the rest
(``device_ms_by_part``; the fused decode step's gate/up launch and its
qkv launch, products with their chains in the epilogue, count as
products).
Attention is the attention kernels by name and, in the chunk, every
device op launched inside ``attend_decode`` (its products too: the plain
spelling's); "ssm" is the two Mamba2 kernels by name and every device op
launched inside ``mamba_apply`` that its name puts in no other part (the
plain chain between the mixer's products): one eager chunk (and, through
``Model.forward``, one eager decode step) is traced with those functions
annotated (:func:`launch_marks`), and the traced steps' ops, eager or
replayed, are walked in stream order beside its ops (``attention_marks``:
how many ops it had, how many were marked, how many the traced steps had,
how many were aligned).
``--capacity-step N`` sets the extend scratch's capacity granularity
(``PagedKVRuntime.capacity_step``, 512 tokens by default), to measure
what padding the chunk's capacity costs.

``--layers N`` cuts the depth to N layers at full width (a full-width
qwen3-moe step fits the card at 6 of its 94). The JSON also gives the
bytes of weights a step reads: every layer's and the head's (a MoE
layer's products read all its experts, whatever the routing).

A family the paged runtime does not serve (gemma2, RWKV6, zamba2) is
stepped through ``Model.forward`` instead, as it is served: a decode
step of the batch against a contiguous cache of ``--context`` tokens,
``build_decode_step``'s step replayed as its CUDA graph
(``models/forward_graph.py``; captured at its second use, inside the
warm-up), or with ``--eager`` the eager step; and a fresh prefill of the
whole ``--context``-token prompt through ``build_prefill_step``'s step
(eager) in place of the chunk. Both steps are fused (their default on
the card: the norms, qkv passes, gated activations and the one-token
attention through the hand-written kernels) unless ``--plain`` asks for
``fused=False``.

``--train`` measures a training step instead: the trainer's step on a
``--batch`` x ``--context`` batch (fp32 masters, the config's compute
dtype, remat and microbatches; seeded weights), replayed as the
trainer's CUDA graph, or eager with ``--eager``. ``--train --mesh``:
path G's training step, the trainer on a one-rank process group's (1, 1)
host mesh, beside the same trainer on one device from the same seeded
weights (``train_meshless``); each trace also counts the step's tensor
subclass (DTensor) dispatches on the host.

``--mesh`` measures path G instead: a one-rank process group (NCCL on
the card), the (1, 1) host mesh, the model's weights as DTensors, and
``build_decode_step(cfg, mesh, ...)``'s step at position ``--context``
of a cache its sharded prefill filled (the same position every step),
beside the same decode step on one device over the same weights
(``decode_meshless``) and the sharded prefill of the whole prompt into
a fresh cache. Both decode steps are their CUDA graphs, or eager with
``--eager``. ``host_split`` times, within the sharded decode step, the
attention functions that read the offsets on the host (``_offsets``),
write the cache's pieces (``_write_piece``) and find the heads a rank
reads (``_kv_for``); the rest of what the sharded eager step costs over
the meshless one is DTensor's. ``--device cpu --smoke`` runs it on a
gloo group at smoke width, with the device metrics null.

Prints one JSON object. Needs one GPU (but ``--mesh --device cpu``,
with or without ``--train``)::

    PYTHONPATH=src python -m repro_torch.launch.profile_step \\
        [--arch qwen2-1.5b] [--layers N] [--batch 4] [--context 2048] \\
        [--steps 8] [--eager] [--plain] [--capacity-step N] [--train] \\
        [--mesh [--device cpu] [--smoke]]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, resolve_device
from repro_torch.models import Model
from repro_torch.serving.paged_runtime import PagedKVRuntime, require_paged
from repro_torch.serving.prefill_graph import CAPACITY_STEP, capacity

CHUNK = 512                       # the serve phase's prefill chunk
# the CUDA API calls that put work on a stream, as the
# profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                "cudaMemcpyAsync", "cudaMemsetAsync")
#: parts of a step's device time, each by markers in its kernels' names
#: (the first part whose marker a name holds takes it; the rest is
#: "other": copies, casts, the embedding, argmax, the token append, the
#: plain chains): decode attention (its paged and fp32 dense split
#: kernels, its bf16 dense cluster kernel) and flash attention, the
#: Mamba2 mixer's two kernels, the port's fused chains,
#: the products (cuBLAS's and CUTLASS's kernels, and the port's gate/up
#: product with its activation and its qkv products with their bias, qk
#: norm and RoPE)
DEVICE_PARTS = (("attention", ("split_kernel", "dense_cluster_kernel",
                               "flash_")),
                ("ssm", ("mamba2_step_kernel", "ssd_chunk_kernel")),
                ("fusions", ("rms_norm_kernel", "qkv_rope_kernel",
                             "gated_act_kernel")),
                ("products", ("gemm", "gemv", "nvjet", "xmma", "cutlass",
                              "splitK", "gate_up_kernel",
                              "qkv_proj_kernel")))


#: functions of ``models/attention.py`` whose device ops are a step's
#: attention whatever their names (the plain spelling's ops over the
#: score tensor and its products)
ATTENTION_FNS = ("attend_decode",)
#: functions of ``models/mamba2.py`` whose device ops are a step's "ssm"
#: part unless their names make them another part (the plain Mamba2
#: chain: the conv, SiLU, softplus, the SSD and its epilogue; its five
#: in-products and its out-projection stay products)
SSM_FNS = ("mamba_apply",)
#: (part, module, functions) of the marked launches
MARKED = (("attention", "attention", ATTENTION_FNS),
          ("ssm", "mamba2", SSM_FNS))


def device_parts(events: list, reps: int, marks: list | None = None
                 ) -> tuple[dict, dict | None]:
    """ms a step of each ``DEVICE_PARTS`` part and of the rest, from the
    trace's device ops ``[(start_ns, name, ns)]`` of ``reps`` steps. With
    ``marks`` (:func:`launch_marks` of one eager step) an op is attention
    when its counterpart in the marked step was launched inside an
    ``ATTENTION_FNS`` function, and "ssm" when inside an ``SSM_FNS``
    function and its name gives it no part: the traced ops, in stream
    order, are walked beside the marked step's repeated (:func:`align`),
    and an op that finds no counterpart takes its part by name. Returns
    the parts and, with ``marks``, how the walk went: the marked step's
    ops and marked ops, the traced ops, the ops aligned, the first op
    that was not."""
    out = dict.fromkeys([p for p, _ in DEVICE_PARTS] + ["other"], 0.0)
    events = sorted(events)
    names = [name for _, name, _ in events]
    pairs, first_miss = align(names, marks) if marks else ({}, None)
    for i, (_, name, ns) in enumerate(events):
        part = next((p for p, keys in DEVICE_PARTS
                     if any(m in name for m in keys)), "other")
        mark = marks[pairs[i]][1] if i in pairs else None
        if mark == "attention" or (mark and part == "other"):
            part = mark
        out[part] += ns / reps / 1e6
    if not marks:
        return out, None
    return out, dict(eager_ops=len(marks),
                     eager_marked=sum(m is not None for _, m in marks),
                     traced_ops=len(events), aligned_ops=len(pairs),
                     first_unaligned=first_miss)


def align(names: list, marks: list, window: int = 16):
    """Walk ``names`` beside ``marks``' names repeated: equal names pair
    up; at a difference the walk skips the fewest ops (up to ``window``)
    on either side that brings two equal names together, and pairs
    nothing when none does. Returns {traced index: marks index} and the
    first traced op left unpaired (index and name), or None."""
    ref = [name for name, _ in marks]
    n = len(ref)
    pairs, first_miss = {}, None
    i = j = 0
    while i < len(names):
        if names[i] == ref[j % n]:
            pairs[i] = j % n
            i, j = i + 1, j + 1
            continue
        if first_miss is None:
            first_miss = (i, names[i][:80])
        step = next(((di, dj) for k in range(1, window + 1)
                     for di, dj in ((k, 0), (0, k))
                     if i + di < len(names)
                     and names[i + di] == ref[(j + dj) % n]), None)
        if step is None:
            i += 1
        else:
            i, j = i + step[0], j + step[1]
    return pairs, first_miss


@contextlib.contextmanager
def _annotated():
    """Each ``MARKED`` function inside a ``record_function`` range of its
    name (the model calls them through their modules)."""
    import importlib
    saved = [(importlib.import_module(f"repro_torch.models.{mod}"), name)
             for _, mod, names in MARKED for name in names]
    inner = [getattr(mod, name) for mod, name in saved]

    def ranged(name, fn):
        def call(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return call

    for (mod, name), fn in zip(saved, inner):
        setattr(mod, name, ranged(name, fn))
    try:
        yield
    finally:
        for (mod, name), fn in zip(saved, inner):
            setattr(mod, name, fn)


def launch_marks(fn) -> list[tuple[str, str | None]]:
    """One call of ``fn`` (an eager step) under ``torch.profiler`` with
    the ``MARKED`` functions annotated: its device ops in stream order,
    each by name with the part of the range it was launched inside (its
    launching host op, or the runtime call of the same correlation id,
    starting inside one), or None."""
    torch.cuda.synchronize()
    with _annotated(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() != DeviceType.CUDA]
    part_of = {name: part for part, _, names in MARKED for name in names}
    ranges = [(e.start_ns(), e.end_ns(), part_of[e.name()]) for e in host
              if e.is_user_annotation() and e.name() in part_of]
    starts = {e.correlation_id(): e.start_ns() for e in host}

    def inside(corr) -> str | None:
        t = starts.get(corr)
        return None if t is None else next(
            (part for a, b, part in ranges if a <= t <= b), None)

    dev = sorted((e.start_ns(), e.name(), inside(e.linked_correlation_id())
                  or inside(e.correlation_id()))
                 for e in events if e.device_type() == DeviceType.CUDA
                 and not e.is_user_annotation())
    return [(name, mark) for _, name, mark in dev]


def _sync(cuda: bool) -> None:
    if cuda:
        torch.cuda.synchronize()


def _timed(fn, steps: int, cuda: bool = True) -> dict:
    enqueue, wall = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        _sync(cuda)
        wall.append(time.perf_counter() - t0)
        enqueue.append(t1 - t0)
    return {"wall_ms_median": 1e3 * float(np.median(wall)),
            "enqueue_ms_median": 1e3 * float(np.median(enqueue)),
            "steps": steps}


def traced(fn, top: int = 12, reps: int = 3, cpu: bool = True,
           counts: bool = False, cuda: bool = True,
           marks: list | None = None) -> dict:
    """``reps`` calls of ``fn`` under ``torch.profiler``: a step's device
    time, device ops run and host launch calls, and the ops with the most
    device time and host time (a host op's time includes what it calls).
    ``cpu`` False records the CUDA activity alone (the device ops and the
    runtime's calls, no host operators). ``counts``: every device op's
    runs a step too. ``read_s``: the seconds the trace took to read back
    after the steps. The profiler's raw events are read, not its parsed
    ones: parsing ~180k events a step took 10-17 s. ``cuda`` False (a
    rehearsal on the CPU): the host alone, every device metric None.
    ``marks``: :func:`launch_marks` of the step, for
    ``device_ms_by_part``."""
    _sync(cuda)
    acts = [ProfilerActivity.CUDA] * cuda + [ProfilerActivity.CPU] * cpu
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        _sync(cuda)
        t1 = time.perf_counter()
    dev: dict[str, list] = {}
    host: dict[str, list] = {}
    dev_events = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        on_dev = e.device_type() == DeviceType.CUDA
        side = dev if on_dev else host
        rec = side.setdefault(e.name(), [0, 0])
        rec[0] += 1
        rec[1] += e.duration_ns()
        if on_dev:
            dev_events.append((e.start_ns(), e.name(), e.duration_ns()))
    device_ns = sum(ns for _, ns in dev.values())
    calls = {k: n / reps for k, (n, _) in host.items()
             if k.startswith(LAUNCH_CALLS)}

    def tops(side: dict, unit: str) -> list:
        ranked = sorted(side.items(), key=lambda kv: kv[1][1],
                        reverse=True)[:top]
        return [{"op": k, "calls_per_step": n / reps,
                 f"{unit}_ms_per_step": ns / reps / 1e6}
                for k, (n, ns) in ranked]

    by_part, marks_walk = device_parts(dev_events, reps, marks)
    out = {
        "traced_wall_ms_per_step": (t1 - t0) / reps * 1e3,
        "device_busy_ms_per_step": device_ns / reps / 1e6,
        "device_busy_share": device_ns / 1e9 / (t1 - t0),
        "device_kernels_per_step": sum(n for n, _ in dev.values()) / reps,
        "device_ms_by_part": by_part,
        "attention_marks": marks_walk,
        "host_launch_calls_per_step": sum(calls.values()),
        "host_launch_calls": calls,
        # a tensor subclass's dispatch (DTensor's), host events only
        "python_subclass_dispatches_per_step":
            host.get("PythonSubclass", (0,))[0] / reps if cpu else None,
        "top_kernels": tops(dev, "device"),
        "top_host": tops(host, "host"),
        "read_s": time.perf_counter() - t1}
    if counts:
        out["kernel_counts"] = {k: n / reps for k, (n, _) in dev.items()}
    if not cuda:
        for k in ("device_busy_ms_per_step", "device_busy_share",
                  "device_kernels_per_step", "device_ms_by_part",
                  "attention_marks",
                  "host_launch_calls_per_step", "host_launch_calls",
                  "top_kernels", "kernel_counts"):
            if k in out:
                out[k] = None
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--context", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="a training step instead of serving steps")
    ap.add_argument("--eager", action="store_true",
                    help="the eager decode step and prefill chunk (or "
                    "training step), not the CUDA graphs")
    ap.add_argument("--plain", action="store_true",
                    help="the steps' chains in their plain spelling "
                    "(PagedKVRuntime(fused=False), or build_prefill_step "
                    "/ build_decode_step(fused=False)), not the fused "
                    "kernels")
    ap.add_argument("--capacity-step", type=int, default=None,
                    help="the extend scratch's capacity granularity")
    ap.add_argument("--mesh", action="store_true",
                    help="path G: the sharded decode step on a one-rank "
                    "mesh beside the same step on one device")
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal of --mesh on a gloo group")
    ap.add_argument("--smoke", action="store_true",
                    help="the config at its smoke width")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda" and not args.mesh:
        ap.error("only --mesh (and --train --mesh) runs off the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.train:
        return _train(cfg, args, dev)
    if args.mesh:
        return _mesh(cfg, args, dev)
    model = Model(cfg, device=dev, seed=args.seed)
    head = model.head()
    weight_bytes = head.numel() * head.element_size() + sum(
        t.numel() * t.element_size() for name, t in model.params.items()
        if name.startswith(("blocks.", "dense_layers.", "shared.")))
    try:
        require_paged(cfg)
    except NotImplementedError:            # served by Model.forward only
        steps = _forward_steps
    else:
        steps = _paged_steps
    decode, prefill, chunk_len = steps(model, args, dev)

    for fn in (decode, prefill):           # warm-up: allocator, cuBLAS
        fn()
        fn()
    torch.cuda.synchronize()
    marks = launch_marks(getattr(prefill, "eager", prefill))
    eager_decode = getattr(decode, "eager", None)
    decode_marks = None if eager_decode is None else \
        launch_marks(eager_decode)
    before = launch_counts()
    out = {"device": torch.cuda.get_device_name(0), "arch": cfg.name,
           "layers": cfg.num_layers, "weight_bytes_per_step": weight_bytes,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "batch": args.batch, "context": args.context, "chunk": chunk_len,
           "chunk_capacity": capacity(
               args.context, chunk_len, args.capacity_step or CAPACITY_STEP)
           if steps is _paged_steps else None,
           "decode_step": "eager" if args.eager else "cuda_graph",
           "fused": not args.plain,
           "capacity_step": args.capacity_step,
           "decode": {**_timed(decode, args.steps),
                      **traced(decode, marks=decode_marks)},
           "prefill": {**_timed(prefill, args.steps),
                       **traced(prefill, marks=marks)}}
    after = launch_counts()
    out["kernel_launches"] = {k: after[k] - before[k] for k in after}
    graph = getattr(decode, "graph", None)
    if graph is not None:                  # Model.forward's decode graph
        out.update(decode_captures=graph.captures,
                   decode_capture_s=graph.capture_s,
                   graph_pool_bytes=graph.pool_bytes())
    print(json.dumps(out, indent=1))
    return 0


def _train(cfg, args, dev) -> int:
    """Training steps of ``Trainer.run``, timed and traced (see
    :func:`_train_leg`). With ``--mesh``: the trainer on a one-rank
    process group's (1, 1) host mesh (its masters and moments DTensors),
    then, the group gone, the same trainer on one device from the same
    seeded weights (``train_meshless``)."""
    cuda = dev.type == "cuda"
    out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
           "arch": cfg.name, "layers": cfg.num_layers, "batch": args.batch,
           "context": args.context, "params": cfg.param_count(),
           "microbatches": cfg.train_microbatches, "remat": cfg.remat,
           "compute_dtype": cfg.compute_dtype}
    if not args.mesh:
        out.update(_train_leg(cfg, args, dev, None))
    else:
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_host_mesh, one_rank_group
        one_rank_group(dev)
        try:
            mesh = make_host_mesh()
            out.update(mesh=list(mesh.shape), backend=dist.get_backend(),
                       **_train_leg(cfg, args, dev, mesh))
        finally:
            dist.destroy_process_group()
        out["train_meshless"] = _train_leg(cfg, args, dev, None)
    print(json.dumps(out, indent=1))
    return 0


def _train_leg(cfg, args, dev, mesh) -> dict:
    """One trainer's steps (on ``mesh``, or one device): replays of the
    step's CUDA graph (after its eager warm-up step and the step that
    captures it), or with ``--eager`` the eager step after one warm-up.
    The enqueue time is the step function's (the trainer's own read of
    the loss waits for the device). The trainer is freed before this
    returns."""
    import gc
    import tempfile

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.train.train_loop import TrainConfig, Trainer
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, mesh,
                     ShapeSpec("profile", "train", args.context, args.batch),
                     TrainConfig(ckpt_every=10 ** 9, ckpt_dir=tmp,
                                 seed=args.seed),
                     log_fn=lambda s: None, device=dev,
                     cuda_graphs=not args.eager)
        tr.run(steps=1 if args.eager else 2)    # warm-up (and capture)
        fn = tr.built.fn if tr.graph is None else tr.graph.step

        def step():
            tokens, labels = tr.data.batch_at(tr.step)
            fn(tr.opt_state, tokens, labels)
            tr.step += 1

        _sync(cuda)
        out = {"train_step": "eager" if tr.graph is None else "cuda_graph",
               "train": {**_timed(step, args.steps, cuda),
                         **traced(step, top=20, cuda=cuda)},
               "kernel_launches": launch_counts()}
        if cuda:
            out.update(max_memory_allocated=torch.cuda.max_memory_allocated(
                dev), memory_reserved=torch.cuda.memory_reserved(dev))
        if tr.graph is not None:
            out.update(capture_s=tr.graph.capture_s,
                       graph_pool_bytes=tr.graph.pool_bytes())
        del tr, fn, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


#: functions of ``models/attention.py`` whose host time a sharded decode
#: step's split reports (each with what it calls: a read of the offsets
#: waits for the device, a write's index uploads)
HOST_SPLIT = ("_offsets", "_write_piece", "_kv_for")


def host_split(fn, reps: int = 3) -> dict:
    """``reps`` calls of ``fn`` with each ``HOST_SPLIT`` function timed
    on the host clock where it is called: its milliseconds a step, and
    the step's. A function the tree does not have, or that the step
    never calls (a replay calls none), reads 0."""
    from repro_torch.models import attention
    spent = dict.fromkeys(HOST_SPLIT, 0.0)
    saved = {name: getattr(attention, name) for name in HOST_SPLIT
             if hasattr(attention, name)}

    def timer(name, f):
        def timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return f(*args, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return timed

    for name, f in saved.items():
        setattr(attention, name, timer(name, f))
    try:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        total = time.perf_counter() - t0
    finally:
        for name, f in saved.items():
            setattr(attention, name, f)
    return {**{f"{k.lstrip('_')}_ms_per_step": v / reps * 1e3
               for k, v in spent.items()},
            "step_ms_per_step": total / reps * 1e3}


def _mesh(cfg, args, dev) -> int:
    """Path G on a one-rank mesh: the sharded decode step (timed, traced
    and its host time split), the same step on one device over the same
    weights, and the sharded prefill into a fresh cache."""
    import torch.distributed as dist

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh, one_rank_group
    from repro_torch.models.steps import (build_decode_step,
                                          build_prefill_step)
    cuda = dev.type == "cuda"
    B, S = args.batch, args.context + 1
    one_rank_group(dev)
    try:
        mesh = make_host_mesh()
        model = Model(cfg, device=dev, seed=args.seed)
        dshape = ShapeSpec("profile", "decode", S, B)
        pf = build_prefill_step(cfg, mesh,
                                ShapeSpec("profile", "prefill", S, B),
                                model=model, device=dev)
        # the meshless step in the sharded one's spelling (a mesh takes
        # no fusion kernel): fused=False
        steps = {name: build_decode_step(cfg, m, dshape, model=mm,
                                         device=dev,
                                         cuda_graphs=not args.eager,
                                         fused=False)
                 for name, m, mm in (("sharded", mesh, pf.model),
                                     ("meshless", None, model))}
        toks = torch.from_numpy(np.random.default_rng(args.seed).integers(
            0, cfg.vocab_size, (B, args.context))).to(dev)
        _, cache = pf.fn(pf.model.init_cache(B, S, pf.rules), toks)
        plain = model.init_cache(B, S)
        model.forward(toks, cache=plain, logits_slice=1)
        nxt = toks[:, -1:]
        legs = {}
        for name, c in (("sharded", cache), ("meshless", plain)):
            st = steps[name]
            # the offsets where the step's own inputs put them
            cl = st.make_inputs()[2].fill_(args.context)
            legs[name] = lambda st=st, c=c, cl=cl: st.fn(c, nxt, cl)

        def prefill():
            pf.fn(pf.model.init_cache(B, S, pf.rules), toks)

        for fn in (*legs.values(), prefill):   # warm-up (and capture)
            fn()
            fn()
        _sync(cuda)
        before = launch_counts()
        out = {"device": torch.cuda.get_device_name(dev) if cuda else "cpu",
               "arch": cfg.name, "layers": cfg.num_layers,
               "mesh": list(mesh.shape), "backend": dist.get_backend(),
               "batch": B, "context": args.context,
               "decode_step": "eager" if args.eager else "cuda_graph",
               "decode": {**_timed(legs["sharded"], args.steps, cuda),
                          **traced(legs["sharded"], cuda=cuda),
                          "host_split": host_split(legs["sharded"])},
               "decode_meshless": {**_timed(legs["meshless"], args.steps,
                                            cuda),
                                   **traced(legs["meshless"], cuda=cuda)},
               "prefill": {**_timed(prefill, args.steps, cuda),
                           **traced(prefill, cuda=cuda)}}
        after = launch_counts()
        out["kernel_launches"] = {k: after[k] - before[k] for k in after}
        for name, st in steps.items():
            if st.graph is not None:
                out[f"{name}_graph"] = {
                    "captures": st.graph.captures,
                    "capture_s": st.graph.capture_s,
                    "replays": st.graph.replays,
                    "pool_bytes": st.graph.pool_bytes()}
        if cuda:
            out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    finally:
        dist.destroy_process_group()
    print(json.dumps(out, indent=1))
    return 0


def _paged_steps(model, args, dev):
    """A decode step of ``--batch`` programs of ``--context`` tokens in a
    ``PagedKVRuntime``, and one prefill chunk on top of that context."""
    cfg = model.cfg
    page = 16
    per_prog = (args.context + CHUNK + 64 * args.steps) // page + 2
    rt = PagedKVRuntime(cfg, n_pages=(args.batch + 1) * per_prog,
                        page_size=page, device=dev,
                        cuda_graphs=not args.eager, fused=not args.plain)
    if args.capacity_step is not None:
        rt.capacity_step = args.capacity_step
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

    def eager():                   # the same chunk, eager, for its marks
        graphs, rt.cuda_graphs = rt.cuda_graphs, False
        try:
            prefill()
        finally:
            rt.cuda_graphs = graphs

    prefill.eager = eager
    return decode, prefill, CHUNK


def _forward_steps(model, args, dev):
    """``Model.forward``: a decode step of the batch at position
    ``--context`` of a contiguous cache (the same position every step)
    through ``build_decode_step``'s step (its CUDA graph, or eager with
    ``--eager``), and a fresh prefill of the ``--context``-token prompts
    through ``build_prefill_step``'s step; both ``fused`` unless
    ``--plain``."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models.steps import build_decode_step, \
        build_prefill_step
    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(rng.integers(
        0, model.cfg.vocab_size, (args.batch, args.context))).to(dev)
    cache = model.init_cache(args.batch, args.context + 1)
    shape = ShapeSpec("profile", "decode", args.context + 1, args.batch)
    pf = build_prefill_step(model.cfg, None, shape, model=model,
                            fused=not args.plain)
    pf.fn(cache, toks)
    nxt = toks[:, -1:]
    step = build_decode_step(model.cfg, None, shape, model=model,
                             cuda_graphs=not args.eager,
                             fused=not args.plain)
    eager = build_decode_step(model.cfg, None, shape, model=model,
                              cuda_graphs=False, fused=not args.plain)

    def decode():
        step.fn(cache, nxt, args.context)

    def prefill():
        pf.fn(cache, toks)

    decode.graph = step.graph
    # the decode step's ops, marked by their launching function
    decode.eager = lambda: eager.fn(cache, nxt, args.context)
    return decode, prefill, args.context


if __name__ == "__main__":
    raise SystemExit(main())
