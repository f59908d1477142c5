"""The training step as one captured program: a CUDA graph of
:func:`~repro_torch.models.steps.build_train_step`'s step, on one device
or on each rank of a mesh, captured at the trainer's second step and
replayed on every later one.

This is the counterpart of the reference's ``jax.jit(train_step, ...,
donate_argnums=(0, 1))`` (``repro.models.steps.build_train_step``; on a
mesh under its ``in_shardings`` and ``out_shardings``), the step its
``Trainer.run`` compiles once and calls every step. The port's step is
eager: at qwen2-1.5b's full depth it launches ~90k kernels (the forward,
the backward with its recomputed layers and loss chunks, AdamW over
every leaf). Replayed as a graph, the host makes one launch a step and
one copy of the batch. The graph holds exactly the kernels the eager
step launches, in the same order, on the same shapes and addresses, so
its results are the eager step's bit for bit.

- Inputs: one int64 ``(2, B, S)`` device buffer, the tokens and the
  labels, filled before each step by one copy from a pinned host buffer.
  On a mesh it is whole on every rank, as the eager step's inputs are:
  the step places each microbatch on "act_batch" inside the captured
  body.
- Outputs: the captured step's fp32 scalars ``loss``, ``grad_norm`` and
  ``lr`` (whole on every rank), which every replay overwrites:
  :meth:`TrainGraph.step` returns clones.
- State: the graph reads and writes the tensors it was captured on, the
  model's fp32 masters and the optimizer state's moments and count, all
  updated in place by ``apply_updates``; on a mesh, the masters' and
  moments' local pieces (a DTensor is a wrapper whose own address is not
  its storage's). A caller that restores a state copies into those
  tensors (``Trainer.resume``); a step on tensors other than the bound
  ones is refused.
- Steps: the first runs eagerly on the capture stream, on the same
  buffers (the warm-up: autograd's and cuBLAS's lazy set-up, and on a
  mesh DTensor's sharding caches, must not fall inside a capture); it is
  a real step. The second is captured, which runs nothing, and then
  replayed once. Every later step is a replay. A failure inside the
  capture raises; nothing falls back to the eager step.
- A mesh: each rank captures its own graph of the DTensor step.
  DTensor's dispatch and sharding propagation run on the host while the
  step is recorded, and never again. The backward runs on autograd's
  device thread, on the capture stream (each backward op on its forward
  op's stream), drawing from the capture's pool; the step's collectives
  (the grads reduced onto their masters' placements, the grad norm's
  sums) are recorded by NCCL into the graph. The capture is
  thread-local, so NCCL's watchdog thread cannot break it.

On the CPU nothing is captured: the same buffers are filled and bound,
and the step runs eagerly on them, so the tests on the CPU go through the
buffer reuse, the binding and the clones that the card relies on.
"""
from __future__ import annotations

import time

import torch

from repro_torch.serving.decode_graph import (CaptureSite, counted_capture,
                                              credit_launches, tensor_key)


class TrainGraph:
    """``step(opt_state, tokens, labels)``: the step ``fn`` of a
    ``BuiltStep`` over ``model`` (on one device or a mesh) on persistent
    buffers, for batches of ``B`` rows of ``S`` tokens; captured at its
    second call on the card."""

    def __init__(self, fn, model, batch: int, seq_len: int):
        self.fn = fn
        self.model = model
        self.device = model.device
        self.capture = self.device.type == "cuda"
        self.error_mode = "global" if model.mesh is None else "thread_local"
        self.batch = torch.zeros((2, batch, seq_len), dtype=torch.long,
                                 device=self.device)
        self._host = torch.zeros((2, batch, seq_len), dtype=torch.long,
                                 pin_memory=self.capture)
        self._copied = None     # event: the last upload has read _host
        self.site = CaptureSite()
        self.graph = None
        self.out: dict | None = None    # the captured step's outputs
        self.launches: dict = {}        # kernel launches one replay makes
        self._bound: tuple | None = None
        self.uses = 0
        self.capture_s = 0.0
        self.replays = 0

    def pool_bytes(self) -> int | None:
        return self.site.pool_bytes()

    def step(self, opt_state: dict, tokens, labels) -> dict:
        """One step on the batch ``tokens`` and ``labels`` ((B, S) ids,
        numpy or CPU tensors). Returns ``{"loss", "grad_norm", "lr"}``,
        fresh fp32 scalars that no later step overwrites."""
        self._bind(opt_state)
        self._fill(tokens, labels)
        if not self.capture:
            out = self.fn(opt_state, *self.batch)
        elif self.graph is not None:
            out = self._replay()
        else:
            out = self._on_side_stream(opt_state)
        self.uses += 1
        return {k: v.clone() for k, v in out.items()}

    def _replay(self) -> dict:
        self.graph.replay()
        self.replays += 1
        credit_launches(self.launches)
        return self.out

    def _bind(self, opt_state: dict) -> None:
        """Bind the masters and ``opt_state``'s tensors (their local
        pieces on a mesh) at the first step; refuse a later step on
        others (a graph would go on reading the bound ones)."""
        leaves = [*self.model.params.values(), *opt_state["m"].values(),
                  *opt_state["v"].values(), opt_state["count"]]
        with torch.no_grad():
            keys = tuple(tensor_key(t) for t in leaves)
        if self._bound is None:
            self._bound = keys
        elif keys != self._bound:
            raise ValueError(
                "the training step's graph is bound to the tensors of its "
                "first step: copy a restored state into them "
                "(Trainer.resume), or rebuild the step")

    def _fill(self, tokens, labels) -> None:
        """One host-to-device copy of the batch; on the card from pinned
        memory, not waiting for the stream (but for the last upload to
        have read the pinned buffer before it is overwritten)."""
        want = tuple(self.batch.shape[1:])
        for name, x in (("tokens", tokens), ("labels", labels)):
            if tuple(x.shape) != want:
                raise ValueError(f"{name} {tuple(x.shape)}: the step's "
                                 f"buffers take {want}")
        if self._copied is not None:
            self._copied.synchronize()
        self._host[0].copy_(torch.as_tensor(tokens))
        self._host[1].copy_(torch.as_tensor(labels))
        self.batch.copy_(self._host, non_blocking=self.capture)
        if self.capture:
            self._copied = torch.cuda.Event()
            self._copied.record()

    def _on_side_stream(self, opt_state: dict) -> dict:
        """The warm-up (first use: an eager step) or the capture (second
        use: recorded, then replayed once for this step's result), on the
        capture stream."""
        pool, side = self.site.open(self.device)
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            if not self.uses:
                out = self.fn(opt_state, *self.batch)
            else:
                t0 = time.perf_counter()
                # the warm-up's cached blocks are no pool's the capture
                # may draw on: full-depth qwen2-1.5b's capture ran out of
                # an 80 GB card's memory beside them (34 GB cached)
                torch.cuda.empty_cache()
                graph = torch.cuda.CUDAGraph()
                outs = {}
                self.launches = counted_capture(
                    graph, pool, lambda: outs.update(
                        self.fn(opt_state, *self.batch)), self.error_mode)
                self.graph, self.out = graph, outs
                self.capture_s += time.perf_counter() - t0
        main.wait_stream(side)
        return out if self.graph is None else self._replay()
