"""Training launcher: the port of the JAX package's ``launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --steps 200 --batch 8 --seq 256 [--resume] [--ckpt-dir DIR] \
        [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch qwen2-1.5b --smoke --device cpu

Runs real steps on the card (``--device cuda``, the default; raises
without a GPU) or on the CPU, and demonstrates checkpoint/restart. Under
``torchrun`` (``WORLD_SIZE`` set) every rank joins the process group
(NCCL on the cards, each rank on card ``LOCAL_RANK``; gloo on the CPU)
and trains on ``make_host_mesh()``, a (world, 1) data-parallel mesh, as
the reference does; alone it trains on one device with no mesh.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_loop import TrainConfig, Trainer


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch, smoke=args.smoke)
    device, mesh = args.device, None
    if "WORLD_SIZE" in os.environ:
        import torch
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_host_mesh
        kw = {}
        if torch.device(device).type == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            torch.cuda.set_device(device)
            kw["device_id"] = torch.device(device)
        dist.init_process_group("nccl" if "cuda" in device else "gloo",
                                **kw)
        mesh = make_host_mesh()
    shape = ShapeSpec("cli", "train", args.seq, args.batch)
    tcfg = TrainConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                       ckpt_dir=args.ckpt_dir,
                       adamw=opt_mod.AdamWConfig(lr=args.lr,
                                                 total_steps=args.steps))
    trainer = Trainer(cfg, mesh, shape, tcfg, device=device)
    if args.resume:
        trainer.resume()
    hist = trainer.run()
    first, last = hist[0]["loss"], hist[-1]["loss"]
    print(f"[train] {args.arch}: step {trainer.step}, loss {first:.4f} -> "
          f"{last:.4f}")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
