"""The paged runtime's prefill and extend chunk as one captured program: a
CUDA graph per ``(model, mode, Sp, T)`` bucket, captured at the bucket's
second use and replayed on every later one.

This is the counterpart of the reference's scanned forward (its layer
stack one ``jax.lax.scan`` in the compiled ``Model.forward``, called from
``repro.serving.paged_runtime.PagedKVRuntime.prefill``), compiled once
per chunk shape: the engine's backend pads a chunk to a power of two
(``Sp``) to bound the recompilations, and the port keys its buckets on
the same lengths. ``mode`` is ``prefill`` (a chunk at position 0: flash
attention over the chunk) or ``extend`` (a chunk after ``start`` cached
tokens: attention over the scratch cache); ``T`` is the scratch cache's
capacity, ``Sp`` in prefill and ``start + Sp`` rounded up to
:data:`CAPACITY_STEP` tokens in extend (:func:`capacity`), so a bucket
serves every start below its capacity.

A bucket owns persistent device buffers: one packed int32 array, filled
by one host-to-device copy (:func:`pack_chunk`: the chunk's tokens, its
start, its last real row ``S - 1``, the scratch row and the flat pool
row of each of the ``Sp`` rows the chunk scatters, and in extend the
flat pool row each of the ``T`` scratch rows gathers), views of one
scratch cache ``(L, 1, T, KV, Dh)`` shared by the runtime's buckets, and
the outputs (the last real row's fp32 logits ``(V,)`` and its argmax).
The step (``PagedKVRuntime._prefill_step``) reads only these and writes
the outputs, the scratch and the chunk's page slots; it reads no device
value on the host. :meth:`PrefillGraphs.step` returns clones.

A bucket is captured at its second use, not its first: chunk shapes vary
more than decode shapes (a recompute after a lost copy runs one long
chunk once), and a bucket used once would pay a capture for nothing. Its
first use runs the same step eagerly on the same buffers. The graphs
share the decode graphs' memory pool and side stream
(:class:`~repro_torch.serving.decode_graph.CaptureSite`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.common import torch_dtype
from repro_torch.serving.decode_graph import StepGraphs

#: an extend bucket's scratch capacity is a multiple of this many tokens:
#: at most 8 capacities up to 4096 tokens, and none padded at the serve
#: path's 512-token chunk on a 2048-token context (2560)
CAPACITY_STEP = 512
#: the scratch's first size in tokens (the engine backend's default
#: ``max_len``); it grows at least twofold. A regrowth drops every bucket
#: (their graphs hold the old addresses), so it should be rare.
SCRATCH_ROWS = 4096


def capacity(start: int, Sp: int, step: int = CAPACITY_STEP) -> int:
    """The scratch capacity T of a chunk of ``Sp`` (padded) rows at
    ``start``: ``Sp`` for a prefill (start 0), else ``start + Sp`` rounded
    up to a multiple of ``step``."""
    if start == 0:
        return Sp
    return -(-(start + Sp) // step) * step


def pack_chunk(tokens: np.ndarray, start: int, S: int, Sp: int, T: int,
               pages: list[int], page_size: int) -> np.ndarray:
    """The chunk's int32 inputs as one host array: ``tokens`` (S real
    ids, zeros when the ids come on the device) padded to ``Sp``;
    ``start``; ``S - 1``; ``src (Sp,)``, the scratch row each scattered
    row reads (``start + i``, the padded rows repeating the last real
    one); ``dst (Sp,)``, its flat pool row ``page * page_size + offset``
    (a padded row writes the last real row's slot again, with the same
    value: no padded row lands anywhere else); and for an extend
    ``gather (T,)``, the flat pool row of each scratch row below
    ``start`` (0 above it: read, then zeroed)."""
    ps = page_size
    table = np.asarray(pages, np.int64)
    toks = np.zeros(Sp, np.int64)
    toks[:len(tokens)] = tokens
    src = start + np.minimum(np.arange(Sp), S - 1)
    dst = table[src // ps] * ps + src % ps
    parts = [toks, [start, S - 1], src, dst]
    if start:
        rows = np.arange(start)
        gather = np.zeros(T, np.int64)
        gather[:start] = table[rows // ps] * ps + rows % ps
        parts.append(gather)
    return np.concatenate(parts).astype(np.int32)


@dataclasses.dataclass
class PrefillBucket:
    """One ``(model, mode, Sp, T)`` shape: its buffers (views of ``ints``
    and of the shared scratch), and on the card its graph and the kernel
    launches one replay makes (counted at capture)."""
    ints: torch.Tensor          # pack_chunk's array on the device
    toks: torch.Tensor          # (Sp,) int32 views of ints ...
    start: torch.Tensor         # (1,)
    last: torch.Tensor          # (1,): S - 1
    src: torch.Tensor           # (Sp,)
    dst: torch.Tensor           # (Sp,)
    gather: torch.Tensor        # (T,) in extend, (0,) in prefill
    k: torch.Tensor             # (L, 1, T, KV, Dh) view of the scratch
    v: torch.Tensor
    logits: torch.Tensor        # (V,) fp32: the last real row's
    nxt: torch.Tensor           # () int64: its argmax
    graph: object = None        # torch.cuda.CUDAGraph once captured
    launches: dict = dataclasses.field(default_factory=dict)
    uses: int = 0               # uses run before the capture

    def inputs(self) -> tuple:
        return (self.toks, self.start, self.last, self.gather, self.src,
                self.dst, self.k, self.v)


class PrefillGraphs(StepGraphs):
    """The prefill buckets of one runtime, keyed ``(mode, Sp, T)``. A
    bucket's first use, eager, warms it up; its capture at the second
    use is replayed for that use's result.

    The step is idempotent for fixed input buffers: it reads pool rows
    below ``start`` and writes only rows ``start .. start + S - 1`` (the
    padded rows rewrite the last real row with its own value), and it
    rewrites every scratch row it reads before reading it."""

    what = "prefill chunk"
    capture_at = 2

    def __init__(self, runtime, site=None):
        super().__init__(runtime, site)
        self._scratch = None        # {"k", "v"}: (L, 1, T_max, KV, Dh)

    def _scratch_views(self, model, T: int) -> tuple:
        """``(k, v)``: the first T rows of the runtime's scratch cache,
        grown when T does not fit, and every bucket dropped with the old
        scratch, whose addresses their graphs hold."""
        sc = self._scratch
        old = 0 if sc is None else sc["k"].shape[2]
        shapes = model.cache_shapes(1, max(T, SCRATCH_ROWS, 2 * old))
        dtype = torch_dtype(shapes["k"][1])
        if old < T or sc["k"].dtype != dtype:
            self._buckets.clear()
            sc = self._scratch = {
                n: torch.zeros(shapes[n][0], dtype=dtype,
                               device=self.rt.device) for n in ("k", "v")}
        return sc["k"][:, :, :T], sc["v"][:, :, :T]

    def _bucket(self, model, mode: str, Sp: int, T: int,
                graphs: bool) -> PrefillBucket:
        self._per_model(model, graphs)  # refusals; pools moved: all dropped
        k, v = self._scratch_views(model, T)
        per = self._buckets.setdefault(model, {})
        b = per.get((mode, Sp, T))
        if b is None:
            dev = self.rt.device
            n_gather = T if mode == "extend" else 0
            ints = torch.zeros(3 * Sp + 2 + n_gather, dtype=torch.int32,
                               device=dev)
            toks, start, last, src, dst, gather = torch.tensor_split(
                ints, np.cumsum([Sp, 1, 1, Sp, Sp]).tolist())
            b = per[(mode, Sp, T)] = PrefillBucket(
                ints=ints, toks=toks, start=start, last=last, src=src,
                dst=dst, gather=gather, k=k, v=v,
                logits=torch.zeros(model.head().shape[-1],
                                   dtype=torch.float32, device=dev),
                nxt=torch.zeros((), dtype=torch.long, device=dev))
        return b

    def step(self, model, mode: str, Sp: int, T: int, host: np.ndarray,
             tokens: torch.Tensor | None, graphs: bool = True):
        """One chunk: ``host`` the :func:`pack_chunk` array (checked by
        the caller), ``tokens`` the chunk's real ids when they are already
        on the device (they overwrite the zeros ``host`` holds for them).
        ``graphs`` False runs the step eagerly on the bucket's buffers.
        Returns ``(logits (V,), nxt ())``, fresh tensors that no later
        chunk overwrites."""
        b = self._bucket(model, mode, Sp, T, graphs)
        self._fill(b.ints, host)
        if tokens is not None:
            b.toks[:tokens.shape[0]].copy_(tokens)
        self._run(b, lambda: self.rt._prefill_step(
            model, mode, *b.inputs(), out=(b.logits, b.nxt)), graphs)
        return b.logits.clone(), b.nxt.clone()

