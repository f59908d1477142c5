"""The paged runtime's batched decode step as one captured program: a CUDA
graph per ``(model, B, n_tab)`` bucket, captured on the bucket's first
step and replayed on every later one.

This is the counterpart of the reference's ``jax.jit(self._decode_step_
impl)`` (``repro.serving.paged_runtime``), which compiles the step once
per ``(B, n_tab)`` shape (the table width a power of two, so it retraces
rarely). The port's step is a Python loop over the layers that launches
~80-100 kernels a layer; replayed as a graph, the host makes one launch
a step. The graph holds exactly the kernels the eager step launches, in
the same order, on the same shapes and addresses, so its results are the
eager step's bit for bit.

A bucket owns persistent device buffers: the inputs (``toks (B,)``,
``tables (B, n_tab)``, ``lens``, ``app_pages`` and ``app_offs (B,)``, the
four int32 arrays one packed buffer, filled by one host-to-device copy)
and the outputs (``logits (B, V)``, ``nxt (B,)``). The step reads only the
input buffers and writes the output buffers, which every replay
overwrites: :meth:`DecodeGraphs.step` returns clones. The token append
reads its slots from ``app_pages`` / ``app_offs`` on the device
(``append_tokens_indexed``); the by-value launch would keep the slots of
the captured step.

On a CPU runtime nothing is captured: the same buckets and buffers are
filled and the step runs eagerly on them, so the tests on the CPU go
through the buffer reuse and the clones that the card relies on.
"""
from __future__ import annotations

import dataclasses
import time
import weakref

import numpy as np
import torch


@dataclasses.dataclass
class Bucket:
    """One ``(model, B, n_tab)`` shape: its buffers, and on the card its
    graph and the kernel launches one replay makes (counted at
    capture)."""
    toks: torch.Tensor          # (B,) int64: each row's last token
    ints: torch.Tensor          # tables, lens, app_pages, app_offs packed
    tables: torch.Tensor        # (B, n_tab) int32, a view of ints
    lens: torch.Tensor          # (B,) int32
    app_pages: torch.Tensor     # (B,) int32
    app_offs: torch.Tensor      # (B,) int32
    logits: torch.Tensor        # (B, V) in the compute dtype
    nxt: torch.Tensor           # (B,) int64
    graph: object = None        # torch.cuda.CUDAGraph once captured
    launches: dict = dataclasses.field(default_factory=dict)

    def inputs(self) -> tuple:
        return (self.toks, self.tables, self.lens, self.app_pages,
                self.app_offs)


def pack_inputs(tables: np.ndarray, lens: np.ndarray, app_pages: np.ndarray,
                app_offs: np.ndarray) -> np.ndarray:
    """The step's int32 inputs as one host array, for one upload."""
    return np.concatenate([tables.reshape(-1), lens, app_pages,
                           app_offs]).astype(np.int32)


def unpack_inputs(ints: torch.Tensor, B: int, n_tab: int) -> tuple:
    """``(tables (B, n_tab), lens, app_pages, app_offs (B,))``: views of
    a :func:`pack_inputs` array on the device."""
    cut = B * n_tab
    return (ints[:cut].view(B, n_tab), ints[cut:cut + B],
            ints[cut + B:cut + 2 * B], ints[cut + 2 * B:])


def credit_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` to the wrappers' launch counts. A replay calls no
    wrapper, so the graph's launches are credited here, one replay's
    worth a replay; ``launch_counts()`` then counts what ran."""
    from repro_torch.kernels import kernel_wrappers
    wrappers = kernel_wrappers()
    for name, n in counts.items():
        wrappers[name].launches += n


class DecodeGraphs:
    """The buckets of one :class:`~repro_torch.serving.paged_runtime.
    PagedKVRuntime`. ``step`` fills a bucket's input buffers and runs the
    step: on the card it captures the bucket's graph on first use and
    replays it after; on the CPU it runs the step eagerly on the buffers.

    All buckets capture into one memory pool
    (``torch.cuda.graph_pool_handle()``): each graph's intermediates are
    dead when its replay ends and the graphs replay one at a time on one
    stream, so they may share it. A capture failure (an op that syncs, a
    launch error) raises; nothing falls back to the eager step."""

    def __init__(self, runtime):
        self.rt = runtime
        self.capture = runtime.device.type == "cuda"
        # model -> {(B, n_tab): Bucket}; a graph holds the model's weight
        # addresses, so each model has its own buckets, dropped with it
        self._buckets: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self._pool_ptrs = None
        self._mem_pool = None
        self._stream = None
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def clear(self) -> None:
        """Drop every bucket and graph: the pools were reassigned, and a
        graph would read and write the old ones."""
        self._buckets = weakref.WeakKeyDictionary()
        self._pool_ptrs = None

    def buckets(self) -> dict:
        """(B, n_tab) -> Bucket over every model (for logging and
        tests)."""
        return {key: b for per in self._buckets.values()
                for key, b in per.items()}

    def pool_bytes(self) -> int | None:
        """Bytes the caching allocator holds for the graphs' memory pool
        (its segments in ``torch.cuda.memory_snapshot()``); None before
        the first capture or on the CPU."""
        if self._mem_pool is None:
            return None
        pool = tuple(self._mem_pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def _bucket(self, model, B: int, n_tab: int) -> Bucket:
        if getattr(model, "trainable", False) or \
                getattr(model, "mesh", None) is not None:
            raise ValueError(
                "the captured decode step serves a plain serving Model: a "
                "trainable model rebuilds its weight views every forward "
                "and a meshed one runs DTensor; pass cuda_graphs=False")
        ptrs = (self.rt.k_pages.data_ptr(), self.rt.v_pages.data_ptr())
        if ptrs != self._pool_ptrs:
            self.clear()
            self._pool_ptrs = ptrs
        per = self._buckets.setdefault(model, {})
        b = per.get((B, n_tab))
        if b is None:
            dev = self.rt.device
            head = model.head()
            ints = torch.zeros(B * n_tab + 3 * B, dtype=torch.int32,
                               device=dev)
            tables, lens, app_pages, app_offs = unpack_inputs(ints, B, n_tab)
            b = per[(B, n_tab)] = Bucket(
                toks=torch.zeros(B, dtype=torch.long, device=dev), ints=ints,
                tables=tables, lens=lens, app_pages=app_pages,
                app_offs=app_offs,
                logits=torch.zeros((B, head.shape[-1]), dtype=head.dtype,
                                   device=dev),
                nxt=torch.zeros(B, dtype=torch.long, device=dev))
        return b

    def step(self, model, last: list, tables: np.ndarray, lens: np.ndarray,
             app_pages: np.ndarray, app_offs: np.ndarray):
        """One decode step of the batch: ``last`` the rows' last tokens
        (0-d int64 tensors on the device), the rest host arrays checked by
        the caller (``tables (B, n_tab)``, the others ``(B,)``). Returns
        ``(logits (B, V), nxt (B,))``, fresh tensors that no later step
        overwrites."""
        B, n_tab = tables.shape
        b = self._bucket(model, B, n_tab)
        torch.stack(last, out=b.toks)
        host = torch.from_numpy(pack_inputs(tables, lens, app_pages,
                                            app_offs))
        if self.capture:
            host = host.pin_memory()
        b.ints.copy_(host, non_blocking=self.capture)
        if not self.capture:
            self.rt._decode_step(model, *b.inputs(), out=(b.logits, b.nxt))
        elif b.graph is None:
            self._capture(model, b)
        else:
            b.graph.replay()
            self.replays += 1
            credit_launches(b.launches)
        return b.logits.clone(), b.nxt.clone()

    def _capture(self, model, b: Bucket) -> None:
        """The bucket's first step: run it eagerly on the capture stream
        (that run is this step's result), then capture the same step into
        the bucket's graph without running it.

        Capturing after the eager run relies on the step being idempotent
        for fixed input buffers: it reads a row's pages only below
        ``lens[b]`` (the decode kernel reads live slots only, and the new
        token's own k/v is merged from registers, not from its page) and
        writes only slot ``lens[b]`` of each append page, with the same
        values. A replay on the same inputs would therefore leave the pools
        and the outputs as the eager run did; the graph's first replay
        comes with the bucket's next step's inputs."""
        from repro_torch.kernels import kernel_wrappers, launch_counts
        t0 = time.perf_counter()
        dev = self.rt.device
        if self._mem_pool is None:
            self._mem_pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
        main = torch.cuda.current_stream(dev)
        side = self._stream
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.rt._decode_step(model, *b.inputs(), out=(b.logits, b.nxt))
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._mem_pool, stream=side):
                self.rt._decode_step(model, *b.inputs(),
                                     out=(b.logits, b.nxt))
        finally:
            # capturing records launches without running them
            after = launch_counts()
            wrappers = kernel_wrappers()
            for name, n in before.items():
                wrappers[name].launches = n
        main.wait_stream(side)
        b.graph = graph
        b.launches = {name: after[name] - before[name] for name in after
                      if after[name] != before[name]}
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
