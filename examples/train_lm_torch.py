"""Train a small LM end to end on the port: data pipeline -> train step
(fp32 masters, bf16 compute) -> AdamW -> checkpoint/restart. The torch
twin of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] \
        [--d-model 256] [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ModelConfig, ShapeSpec  # noqa: E402
from repro_torch.train import optimizer as opt_mod  # noqa: E402
from repro_torch.train.train_loop import TrainConfig, Trainer  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = ModelConfig(
        name="demo-lm", family="dense", num_layers=args.layers,
        d_model=args.d_model, num_heads=args.d_model // 64 or 2,
        num_kv_heads=args.d_model // 64 or 2, d_ff=args.d_model * 3,
        vocab_size=4096, max_seq_len=args.seq)
    print(f"model: {cfg.param_count() / 1e6:.1f}M params")
    shape = ShapeSpec("demo", "train", args.seq, args.batch)
    ckpt_dir = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    tcfg = TrainConfig(steps=args.steps, ckpt_every=50, ckpt_dir=ckpt_dir,
                       log_every=20,
                       adamw=opt_mod.AdamWConfig(lr=1e-3, warmup_steps=20,
                                                 total_steps=args.steps))
    tr = Trainer(cfg, None, shape, tcfg, device=args.device)
    if args.resume and tr.resume():
        print(f"resumed from step {tr.step}")
    hist = tr.run()
    print(f"loss: {hist[0]['loss']:.3f} -> {hist[-1]['loss']:.3f} over "
          f"{len(hist)} steps; checkpoints in {ckpt_dir}")


if __name__ == "__main__":
    main()
