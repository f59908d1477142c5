"""Multi-pod dry run: build and count every (arch x shape x mesh) cell on
the ``meta`` device, the port of the JAX package's ``launch/dryrun.py``.

One process stands for every rank: it initialises torch's fake process
group (``FakeStore``, world 256 for the 16 x 16 pod, 512 for two pods, 8
for ``--smoke`` on a 2 x 4 mesh with the reference's cut shapes), builds
the step at full width on the meta device (nothing drawn, nothing
allocated) and runs it once under the step counter
(:mod:`repro_torch.dist.roofline`), which counts rank 0's local work:
FLOPs, bytes and the collectives DTensor issues. A deep stack is counted
at one and two units of depth (and a train step at one and two
microbatches) and extended to the whole step, exactly, since the units
are identical (``tests/test_torch_dryrun.py`` holds the extension to
the whole step's count); the smoke configs are shallow enough to be
counted whole. The fake group is process-wide and cannot share a
process with a real one, so callers run a dry run in a subprocess.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \
        --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
        [--multipod-only]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
        --shape decode_32k --smoke      # smoke config, 2x4 mesh

Records (JSON) go to ``experiments/dryrun_torch/`` (``--out`` elsewhere),
with the reference's keys where they have a meaning here. What the
reference reads from XLA's compiled executable (compile time, temp and
alias bytes, the peak estimate, the HLO text) the port does not have; a
record lists those keys under ``"not_counted"`` instead of writing 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import (SHAPES, arch_shape_cells, get_config,
                                      shape_for)
from repro_torch.dist.roofline import Cost, count_step
from repro_torch.dist.sharding import placements_of
from repro_torch.models.steps import build_step, input_specs, uses_embeds
from repro_torch.models.transformer import first_k_dense

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "experiments" / \
    "dryrun_torch"

#: the reference record's keys this port does not produce, and why
NOT_COUNTED = {
    "compile_s": "no ahead-of-time compile: the step runs eagerly",
    "temp_bytes": "no compiled buffer assignment to read",
    "alias_bytes": "no compiled buffer assignment to read",
    "peak_bytes_estimate": "needs temp_bytes",
    "hlo_path": "no HLO",
}

_ITEMSIZE = {"int32": 4, "float32": 4, "bfloat16": 2, "float16": 2}


def init_fake_group(world: int) -> None:
    """One process standing for ``world`` ranks (rank 0's view)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _local_bytes(t) -> int:
    t = t.to_local() if isinstance(t, DTensor) else t
    return t.numel() * t.element_size()


def _input_bytes(cfg, shape, rules) -> int:
    """Local bytes of the data inputs at the reference's dtypes (int32
    ids), each placed on "act_batch" as the reference's step places it."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    total = 0
    for name, (shp, dt) in input_specs(cfg, shape).items():
        axes = ("act_batch",) + (None,) * (len(shp) - 1)
        local = compute_local_shape_and_global_offset(
            shp, rules["__mesh__"], placements_of(axes, rules, shp))[0]
        n = 1
        for d in local:
            n *= d
        total += n * _ITEMSIZE[dt]
    return total


def _arguments(step, inputs, cfg, shape) -> tuple[int, int]:
    """(argument bytes, output bytes) a device holds: params, optimizer
    state and caches as placed, the data inputs at the reference's
    dtypes; the outputs are what the reference's step returns (new
    params and state, or the next tokens and the cache)."""
    params = sum(_local_bytes(p) for p in step.model.params.values())
    data = _input_bytes(cfg, shape, step.rules)
    if shape.kind == "train":
        opt = inputs[0]
        state = sum(_local_bytes(t) for m in ("m", "v")
                    for t in opt[m].values()) + _local_bytes(opt["count"])
        return params + state + data, params + state + 3 * 4
    cache = sum(_local_bytes(t) for t in inputs[0].values())
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    B = shape.global_batch
    tok = compute_local_shape_and_global_offset(
        (B,), step.rules["__mesh__"],
        placements_of(("act_batch",), step.rules, (B,)))[0][0]
    return params + cache + data, cache + 4 * tok


def _depth(cfg) -> tuple[int, int, int, int]:
    """(leading dense layers, layers a repeated unit, units, layers left
    over): the stack is ``first + units * unit + rest`` layers deep."""
    first = first_k_dense(cfg)
    unit = cfg.shared_attn_every if cfg.family == "hybrid" else \
        2 if cfg.local_global_alternating else 1
    return first, unit, *divmod(cfg.num_layers - first, unit)


def _count(cfg, mesh, shape, step, inputs):
    """The cell's per-device cost and how it was counted. A stack of at
    most two units and two microbatches (every smoke config), or one that
    is not a whole number of units: the whole step once. Otherwise the
    step is counted at 1 and 2 units of depth and, for a train step, at 1
    and 2 microbatches of the same size, and the four counts are extended
    bilinearly: the units are identical, and so are the microbatches, so
    the cost is a + b * units + M * (c + d * units) exactly."""
    first, unit, n, rest = _depth(cfg)
    M = (cfg.train_microbatches or 1) if shape.kind == "train" else 1
    if rest or shape.global_batch % M or (n <= 2 and M <= 2):
        return count_step(step, inputs), "exact: the whole step once"
    mb = shape.global_batch // M
    runs = {}
    for u in (1, 2):
        for m in ((1, 2) if M > 1 else (1,)):
            c = dataclasses.replace(cfg, num_layers=first + u * unit,
                                    train_microbatches=m)
            s = dataclasses.replace(shape, global_batch=mb * m)
            runs[u, m] = count_step(build_step(c, mesh, s, device="meta"))

    def ext(f):
        c11, c21 = getattr(runs[1, 1], f), getattr(runs[2, 1], f)
        if M == 1:
            return c11 + (n - 1) * (c21 - c11)
        c12, c22 = getattr(runs[1, 2], f), getattr(runs[2, 2], f)
        return (c11 + (n - 1) * (c21 - c11) + (M - 1) * (c12 - c11)
                + (n - 1) * (M - 1) * (c22 - c21 - c12 + c11))

    how = (f"extended from {first + unit} and {first + 2 * unit} layers"
           + (f", 1 and 2 microbatches of {mb} rows" if M > 1 else "")
           + f" to {cfg.num_layers} layers"
           + (f" and {M} microbatches" if M > 1 else "")
           + " (identical units: exact)")
    return Cost(*(float(ext(f)) for f in ("flops", "bytes", "coll_bytes"))
                ), how


def cell(arch: str, shape_name: str, multi_pod: bool = False,
         smoke: bool = False):
    """(config, shape, mesh, mesh tag) of a cell, the fake group that
    stands for the mesh's ranks initialised."""
    from repro_torch.launch.mesh import make_production_mesh
    cfg = get_config(arch, smoke=smoke)
    shape = shape_for(shape_name)
    if smoke:
        shape = dataclasses.replace(
            shape, name=shape.name + "-smoke",
            seq_len=min(shape.seq_len, 256),
            global_batch=max(min(shape.global_batch, 8), 2))
        init_fake_group(8)
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        mesh_tag = "2x4smoke"
    else:
        init_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_tag = "2x16x16" if multi_pod else "16x16"
    return cfg, shape, mesh, mesh_tag


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             smoke: bool = False, out_dir: str | pathlib.Path | None = None,
             verbose: bool = True) -> dict:
    """Build the cell's step on the meta device over the fake group's
    mesh, count it (:func:`_count`), write and return its record."""
    cfg, shape, mesh, mesh_tag = cell(arch, shape_name, multi_pod, smoke)
    t0 = time.time()
    step = build_step(cfg, mesh, shape, device="meta")
    inputs = step.make_inputs()
    arg_bytes, out_bytes = _arguments(step, inputs, cfg, shape)
    cost, counted = _count(cfg, mesh, shape, step, inputs)
    lower_s = time.time() - t0
    rec = {
        "arch": arch,
        "shape": shape_name,
        "smoke": smoke,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "mesh": mesh_tag,
        "chips": int(mesh.size()),
        "lower_s": round(lower_s, 2),
        "flops_per_device": cost.flops,
        "bytes_accessed_per_device": cost.bytes,
        "coll_bytes": cost.coll_bytes,
        "argument_bytes": int(arg_bytes),
        "output_bytes": int(out_bytes),
        "counted": counted,
        "embeds_input": uses_embeds(cfg),
        "not_counted": NOT_COUNTED,
        "ok": True,
    }
    out = pathlib.Path(out_dir) if out_dir is not None else ART_DIR
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{arch}_{shape_name}_{mesh_tag}.json").write_text(
        json.dumps(rec, indent=2))
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_tag}: "
              f"{rec['lower_s']}s, flops/device "
              f"{rec['flops_per_device']:.3e}, bytes/device "
              f"{rec['bytes_accessed_per_device']:.3e}, coll/device "
              f"{rec['coll_bytes']:.3e}, arguments/device "
              f"{rec['argument_bytes'] / 2**30:.2f} GiB", flush=True)
    return rec


def main() -> int:
    torch.set_num_threads(1)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multipod-only", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-hlo", action="store_true",
                    help="accepted for the reference's CLI; the port "
                         "writes no HLO")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs on a 2x4 mesh")
    ap.add_argument("--out", default=None,
                    help=f"record directory (default {ART_DIR})")
    args = ap.parse_args()

    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multipod_only or args.multipod:
        meshes = [True]
    if args.all:
        cells = arch_shape_cells()
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]
    if args.smoke:
        meshes = [False]

    failures = []
    for arch, shape_name in cells:
        for mp in meshes:
            try:
                run_cell(arch, shape_name, mp, smoke=args.smoke,
                         out_dir=args.out)
            except Exception:
                failures.append((arch, shape_name, mp))
                traceback.print_exc()
    if dist.is_initialized():
        dist.destroy_process_group()
    if failures:
        print("FAILED cells:", failures)
        return 1
    print(f"dry-run OK: {len(cells)} cells x {len(meshes)} mesh(es)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
