"""Fault-tolerant training driver: the port of the JAX package's
``train/train_loop.py``.

- checkpoint/restart: periodic async checkpoints; ``resume()`` restores
  the latest durable step after a crash or preemption;
- the step: ``models.steps.build_train_step`` over a trainable ``Model``
  (fp32 masters, compute-dtype forward, AdamW in place), on the card
  unless the caller asks for the CPU;
- data: the synthetic ``TokenStream``, stateless by step, so a restart
  resumes mid-stream with nothing lost or repeated.

The elastic remesh (``reshard_for_mesh``) comes with the multi-device
steps (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data.tokens import DataConfig, TokenStream
from repro_torch.kernels import resolve_device
from repro_torch.models.steps import build_train_step
from repro_torch.models.transformer import Model
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.checkpoint import CheckpointManager


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    log_every: int = 10
    seed: int = 0
    adamw: opt_mod.AdamWConfig = dataclasses.field(
        default_factory=opt_mod.AdamWConfig)


class Trainer:
    """``mesh`` must be None (one device). ``device``: "cuda" (the default;
    raises without a GPU) or "cpu"."""

    def __init__(self, cfg: ModelConfig, mesh, shape: ShapeSpec,
                 tcfg: TrainConfig = TrainConfig(),
                 log_fn: Callable[[str], None] = print, *, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "the port trains on one device: a mesh comes with ROADMAP "
                "queue 1 item 14")
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg
        self.log = log_fn
        self.device = resolve_device(device)
        self.data = TokenStream(DataConfig(cfg.vocab_size, shape.seq_len,
                                           shape.global_batch, seed=tcfg.seed))
        self.ckpt = CheckpointManager(tcfg.ckpt_dir)
        self.step = 0
        self.model: Optional[Model] = None
        self.built = None
        self.params = None
        self.opt_state = None
        self.history: list[dict] = []

    # ------------------------------------------------------------ lifecycle
    def init_state(self, params: dict | None = None):
        """The model's fp32 masters drawn from ``tcfg.seed`` (the port's
        init), or ``params`` (a flat dict, e.g. ``params_from_numpy`` of a
        JAX ``Model.init`` tree), and a fresh optimizer state."""
        self.model = Model(self.cfg, params, device=self.device,
                           seed=self.tcfg.seed, trainable=True)
        self.built = build_train_step(self.cfg, None, self.shape,
                                      adamw=self.tcfg.adamw, model=self.model)
        self.params = self.model.params
        self.opt_state = opt_mod.init_state(self.params, self.tcfg.adamw)

    def resume(self) -> bool:
        """Restore the latest checkpoint; True if one was found."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        if self.model is None:
            self.init_state()
        params, self.opt_state, manifest = self.ckpt.restore(
            latest, self.params, self.opt_state)
        with torch.no_grad():
            for k, t in params.items():
                self.params[k].copy_(t)
        self.step = manifest["step"]
        self.log(f"[trainer] resumed at step {self.step}")
        return True

    # ------------------------------------------------------------------ run
    def run(self, steps: Optional[int] = None) -> list[dict]:
        steps = steps or self.tcfg.steps
        if self.model is None:
            self.init_state()
        while self.step < steps:
            tokens, labels = self.data.batch_at(self.step)
            t0 = time.time()
            metrics = self.built.fn(self.opt_state, tokens, labels)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            self.step += 1
            rec = {"step": self.step, "loss": loss, "sec": dt,
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"])}
            self.history.append(rec)
            if self.step % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {self.step} loss {loss:.4f} "
                         f"({dt:.2f}s)")
            if self.step % self.tcfg.ckpt_every == 0:
                self.ckpt.save_async(self.step, self.params, self.opt_state)
        self.ckpt.wait()
        return self.history
