"""Deterministic synthetic token pipeline for LM training.

Production-shaped: sharded by data-parallel rank, stateless given
(seed, step) — a restart resumes mid-epoch with no data loss or repeat
(the checkpoint only needs the step counter). The generator produces a
structured Zipf-ish token stream with local n-gram correlations so models
have learnable signal (loss decreases measurably in a few hundred steps).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class TokenStream:
    """Stateless ``batch_at(step, rank, world)``: every rank materializes
    only its shard of the global batch."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed "grammar": each token has a preferred successor table
        self._succ = rng.integers(0, v, size=(v, 4))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self._p = p / p.sum()

    def batch_at(self, step: int, rank: int = 0, world: int = 1):
        cfg = self.cfg
        assert cfg.global_batch % world == 0
        local = cfg.global_batch // world
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, rank]))
        toks = np.empty((local, cfg.seq_len + 1), np.int32)
        start = rng.choice(cfg.vocab_size, size=local, p=self._p)
        toks[:, 0] = start
        follow = rng.random((local, cfg.seq_len)) < 0.7
        branch = rng.integers(0, 4, size=(local, cfg.seq_len))
        fresh = rng.choice(cfg.vocab_size, size=(local, cfg.seq_len),
                           p=self._p)
        for t in range(cfg.seq_len):
            nxt = self._succ[toks[:, t], branch[:, t]]
            toks[:, t + 1] = np.where(follow[:, t], nxt, fresh[:, t])
        return toks[:, :-1], toks[:, 1:]                  # tokens, labels
