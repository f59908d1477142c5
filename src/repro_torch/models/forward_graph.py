"""``Model.forward``'s decode step as one captured program: a CUDA graph of
:func:`~repro_torch.models.steps.build_decode_step`'s step, on one device
or on each rank of a mesh, per bucket, captured at the bucket's second
use and replayed on every later one.

This is the counterpart of the reference's ``jax.jit(decode_step, ...,
donate_argnums=(1,))`` (``repro.models.steps.build_decode_step``; on a
mesh under its ``in_shardings``), whose ``cache_len`` is a ``(B,)``
int32 array: the offsets never leave the device. It serves every family
``Model.forward`` runs, the ones the paged runtime does not page
included (gemma2's local/global pairs with
their rings, zamba2's hybrid stack, RWKV6). The port's step is a Python
loop over the layers that launches ~5400 kernels at gemma2-9b's depth;
replayed as a graph, the host makes one launch a step and one upload of
the inputs. The graph holds exactly the kernels the eager step on the
same device inputs launches, in the same order, on the same shapes and
addresses, so its results are that step's bit for bit.

- Inputs: a bucket owns one int32 device buffer ``ints (2, B)``, the
  tokens (row 0, read as ``(B, 1)``, the reference's int32 ids) and the
  offsets ``cache_len`` (row 1). What comes from the host (a host int
  offset becomes the ``(B,)`` array there) is uploaded by one copy from
  pinned memory; what is already on the device (the last step's next
  tokens) is copied there on the device. ``Model.forward`` so always
  gets a device ``cache_len`` and takes its tensor branches: positions,
  cache writes (gemma2's ring slot, which moves every step, included)
  and masks worked out on the device.
- Outputs: the next tokens ``(B,)`` int32 and the fp32 logits ``(B, 1,
  V)``, the captured step's own tensors, which every replay overwrites:
  :meth:`ForwardGraph.step` returns clones. Both are always computed, so
  the ``logits`` flag needs no bucket of its own. The cache is written in
  place and returned.
- Caches: a graph reads and writes the cache tensors it was captured on.
  So a bucket is keyed on ``B`` and the cache's leaves (their addresses,
  shapes, strides and dtypes; of a DTensor leaf, its local piece's: a
  DTensor is a wrapper whose own address is not its storage's): another
  cache gets its own bucket and capture, never a replay that writes into
  the first (a new cache laid out at the addresses of a freed one is the
  same memory, and replays correctly). A step keeps the ``MAX_BUCKETS``
  it used last.
- Steps: a bucket's first use runs eagerly on the capture stream, on its
  buffers (the warm-up: cuBLAS's lazy set-up must not fall inside a
  capture); it is a real step. The second is captured, which runs
  nothing, and then replayed once; every later use is a replay. The
  step is not idempotent (RWKV6's and Mamba2's states advance in place),
  so nothing runs it twice. A failure inside the capture raises; nothing
  falls back to the eager step.
- A mesh: each rank captures its own graph of the DTensor step. The
  buffers are whole on every rank, as the eager step's inputs are, and
  the step places the tokens on "act_batch" inside the captured body.
  DTensor's dispatch and sharding propagation run on the host while the
  step is recorded, and never again: a replay runs the local kernels
  they chose, and the step's collectives (the vocab-parallel argmax's
  all-gather, the all-reduces of a cache split on its sequence), which
  NCCL records into the graph. The warm-up fills DTensor's caches; the
  capture is thread-local, so NCCL's watchdog thread cannot break it.

On the CPU nothing is captured: the same buckets and buffers are filled
and the step runs eagerly on them, so the tests on the CPU go through
the buffer reuse and the clones that the card relies on.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.serving.decode_graph import (CaptureSite, counted_capture,
                                              credit_launches, tensor_key)


#: buckets a step keeps; the least recently used is dropped first (a
#: caller that makes a fresh cache per request would else hold a graph
#: for every cache it ever used)
MAX_BUCKETS = 8


@dataclasses.dataclass
class Bucket:
    """One ``(B, cache)`` key: its buffers, and on the card its graph, the
    captured step's outputs and the kernel launches one replay makes
    (counted at capture)."""
    ints: torch.Tensor          # (2, B) int32: tokens, cache_len
    graph: object = None        # torch.cuda.CUDAGraph once captured
    out: tuple | None = None    # the captured (nxt, logits)
    launches: dict = dataclasses.field(default_factory=dict)
    uses: int = 0

    @property
    def tokens(self) -> torch.Tensor:
        return self.ints[0].view(-1, 1)

    @property
    def cache_len(self) -> torch.Tensor:
        return self.ints[1]


def _cache_key(cache: dict) -> tuple:
    """The identity of a cache's leaves (a DTensor's by its local piece):
    what a graph captured on them reads and writes."""
    return tuple((k, *tensor_key(v)) for k, v in sorted(cache.items()))


class ForwardGraph:
    """``step(cache, tokens, cache_len, logits=False)``: the decode step
    ``fn`` of a ``BuiltStep`` over ``model`` (on one device or a mesh) on
    a bucket's buffers; each bucket captured at its second use on the
    card. ``place(cache)``: the cache on the step's placements (a copy
    where it has others), made before the bucket is chosen, so that the
    graph keys on, writes and returns the cache the step writes."""

    def __init__(self, fn, model, place=None):
        self.fn = fn
        self.place = place or (lambda cache: cache)
        self.device = model.device
        self.capture = self.device.type == "cuda"
        self.error_mode = "global" if model.mesh is None else "thread_local"
        self.site = CaptureSite()
        self._buckets: dict[tuple, Bucket] = {}
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def buckets(self) -> dict:
        return dict(self._buckets)

    def pool_bytes(self) -> int | None:
        return self.site.pool_bytes()

    def step(self, cache: dict, tokens, cache_len, logits: bool = False):
        """One decode step: ``tokens`` (B, 1) ids (a device tensor, or
        host ids), ``cache_len`` the offsets (a host int, (B,) host
        values, or a device tensor). Returns ``(nxt (B,) int32, cache)``
        and with ``logits`` the fp32 logits (B, 1, V) too, fresh tensors
        that no later step overwrites."""
        B = tokens.shape[0] if hasattr(tokens, "shape") else len(tokens)
        cache = self.place(cache)
        key = (B, _cache_key(cache))
        b = self._buckets.pop(key, None)
        if b is None:
            b = Bucket(torch.zeros((2, B), dtype=torch.int32,
                                   device=self.device))
            while len(self._buckets) >= MAX_BUCKETS:   # the least recent
                self._buckets.pop(next(iter(self._buckets)))
        self._buckets[key] = b
        self._fill(b, tokens, cache_len)
        if not self.capture:
            out = self._eager(cache, b)
        elif b.graph is not None:
            out = self._replay(b)
        else:
            out = self._on_side_stream(cache, b)
        b.uses += 1
        nxt, lg = out
        return (nxt.clone(), cache, lg.clone()) if logits \
            else (nxt.clone(), cache)

    def _eager(self, cache: dict, b: Bucket) -> tuple:
        nxt, _, lg = self.fn(cache, b.tokens, b.cache_len, logits=True)
        return nxt, lg

    def _replay(self, b: Bucket) -> tuple:
        b.graph.replay()
        self.replays += 1
        credit_launches(b.launches)
        return b.out

    def _fill(self, b: Bucket, tokens, cache_len) -> None:
        """The step's inputs into ``b.ints``: device values by a copy on
        the device (never read back), host values by one upload."""
        B = b.ints.shape[1]
        host = {}
        for row, x in enumerate((tokens, cache_len)):
            if self.capture and isinstance(x, torch.Tensor) and \
                    x.device.type != "cpu":
                b.ints[row].copy_(x.reshape(-1).expand(B))
                continue
            arr = np.asarray(x, dtype=np.int64).reshape(-1)
            if arr.size not in (1, B):
                raise ValueError(f"{arr.size} values for a batch of {B}")
            host[row] = np.broadcast_to(arr, (B,)).astype(np.int32)
        if len(host) == 2:
            self._upload(b.ints, np.stack([host[0], host[1]]))
        elif host:
            ((row, arr),) = host.items()
            self._upload(b.ints[row], arr)

    def _upload(self, dst: torch.Tensor, arr: np.ndarray) -> None:
        """One host-to-device copy; on the card from pinned memory, not
        waiting for the stream."""
        t = torch.from_numpy(arr)
        if self.capture:
            t = t.pin_memory()
        dst.copy_(t, non_blocking=self.capture)

    def _on_side_stream(self, cache: dict, b: Bucket) -> tuple:
        """The warm-up (first use: an eager step) or the capture (second
        use: recorded, then replayed once for this step's result), on the
        capture stream."""
        pool, side = self.site.open(self.device)
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            if not b.uses:
                out = self._eager(cache, b)
            else:
                t0 = time.perf_counter()
                graph = torch.cuda.CUDAGraph()
                outs = []
                b.launches = counted_capture(
                    graph, pool, lambda: outs.append(self._eager(cache, b)),
                    self.error_mode)
                b.graph, b.out = graph, outs[0]
                self.captures += 1
                self.capture_s += time.perf_counter() - t0
        main.wait_stream(side)
        return out if b.graph is None else self._replay(b)
