"""The paged runtime's batched decode step as one captured program: a CUDA
graph per ``(model, B, n_tab)`` bucket, captured on the bucket's first
step and replayed on every later one; and the machinery it shares with
the prefill chunk's graphs (:mod:`.prefill_graph`).

This is the counterpart of the reference's ``jax.jit(self._decode_step_
impl)`` (``repro.serving.paged_runtime``), which compiles the step once
per ``(B, n_tab)`` shape (the table width a power of two, so it retraces
rarely). The port's step is a Python loop over the layers that launches
~15 kernels a layer (~85 with ``fused=False``); replayed as a graph, the
host makes one launch a step. The graph holds exactly the kernels the
eager step launches, in the same order, on the same shapes and
addresses, so its results are the eager step's bit for bit.

A bucket owns persistent device buffers: the inputs (``toks (B,)``,
``tables (B, n_tab)``, ``lens``, ``app_pages`` and ``app_offs (B,)``, the
four int32 arrays one packed buffer, filled by one host-to-device copy)
and the outputs (``logits (B, V)``, ``nxt (B,)``). The step reads only the
input buffers and writes the output buffers, which every replay
overwrites: :meth:`DecodeGraphs.step` returns clones. The token append
reads its slots from ``app_pages`` / ``app_offs`` on the device
(``append_tokens_indexed``); the by-value launch would keep the slots of
the captured step.

Every graph of a runtime, decode and prefill, is captured on one side
stream into one memory pool (:class:`CaptureSite`), through
``CUDAGraph.capture_begin`` / ``capture_end`` (:func:`capture`), without
what ``torch.cuda.graph`` adds around them.

On a CPU runtime nothing is captured: the same buckets and buffers are
filled and the step runs eagerly on them, so the tests on the CPU go
through the buffer reuse and the clones that the card relies on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import weakref

import numpy as np
import torch

from repro_torch.dist.sharding import local


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
    uses: int = 0               # steps run before the capture

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


def capture(graph, pool, step, error_mode: str = "global") -> None:
    """Record ``step()`` into ``graph`` on the current stream, its
    allocations drawn from ``pool``. ``torch.cuda.graph`` wraps the same
    two calls in a device synchronize, ``gc.collect()``,
    ``torch.cuda.empty_cache()`` and the release of the cached pinned
    host blocks (which the next stage-out then allocates again); the
    capture needs none of them, so none is done. A failure inside the
    capture ends it and raises. ``error_mode`` "thread_local": only this
    thread's unsafe CUDA calls break the capture (a step on a mesh:
    NCCL's watchdog thread keeps querying its events meanwhile). Python's
    cycle collector is off while the step is recorded: a collection
    there may destroy an unreachable graph (a dropped runtime's), whose
    teardown is not permitted while a stream captures and breaks this
    capture."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        graph.capture_begin(pool=pool, capture_error_mode=error_mode)
        try:
            step()
        except BaseException:
            with contextlib.suppress(RuntimeError):    # already invalidated
                graph.capture_end()
            raise
        graph.capture_end()
    finally:
        if collecting:
            gc.enable()


def counted_capture(graph, pool, step,
                    error_mode: str = "global") -> dict[str, int]:
    """:func:`capture`, returning the wrappers' launches it recorded: one
    replay's worth, for :func:`credit_launches`. Recording runs nothing,
    so the wrappers' counts are put back as they were."""
    from repro_torch.kernels import kernel_wrappers, launch_counts
    before = launch_counts()
    try:
        capture(graph, pool, step, error_mode)
    finally:
        after = launch_counts()
        wrappers = kernel_wrappers()
        for name, n in before.items():
            wrappers[name].launches = n
    return {name: after[name] - before[name] for name in after
            if after[name] != before[name]}


def tensor_key(t: torch.Tensor) -> tuple:
    """What a graph captured on ``t`` reads and writes: the address,
    shape, strides and dtype of its storage (of a DTensor, its local
    piece's)."""
    t = local(t)
    return t.data_ptr(), tuple(t.shape), t.stride(), t.dtype


class CaptureSite:
    """The memory pool and the side stream that every graph of one
    runtime is captured into and on, made at the first capture. The
    graphs' intermediates are dead when a replay ends and the graphs
    replay one at a time on one stream, so they may share the pool."""

    def __init__(self):
        self.pool = None
        self.stream = None

    def open(self, device) -> tuple:
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)
        return self.pool, self.stream

    def pool_bytes(self) -> int | None:
        """Bytes the caching allocator holds for the pool (its segments in
        ``torch.cuda.memory_snapshot()``); None before the first capture
        or on the CPU."""
        if self.pool is None:
            return None
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class StepGraphs:
    """The buckets of one family of captured steps of a :class:`~repro_
    torch.serving.paged_runtime.PagedKVRuntime`, per model. A bucket
    runs its first ``capture_at - 1`` uses eagerly on its buffers, is
    captured at use ``capture_at`` and replayed after; on the CPU every
    use runs eagerly on the buffers.

    A capture failure (an op that syncs, a launch error) raises; nothing
    falls back to the eager step."""

    what = "step"
    capture_at = 1

    def __init__(self, runtime, site: CaptureSite | None = None):
        self.rt = runtime
        self.site = site if site is not None else CaptureSite()
        self.capture = runtime.device.type == "cuda"
        # model -> {key: bucket}; a graph holds the model's weight
        # addresses, so each model has its own buckets, dropped with it
        self._buckets: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
        self._bound_to = None           # what the graphs hold: _binding()
        self.captures = 0
        self.capture_s = 0.0
        self.replays = 0

    def clear(self) -> None:
        """Drop every bucket and graph: what they hold of the runtime
        (``_binding``) changed, and a graph would read and write the old
        pools or run the other spelling. If a graph went, later captures
        open a fresh memory pool: the dropped graphs may have been their
        pool's last holders, and the caching allocator refuses a capture
        into a pool that no live graph holds."""
        if any(b.graph is not None for b in self.buckets().values()):
            self.site.pool = None
        self._buckets = weakref.WeakKeyDictionary()
        self._bound_to = None

    def buckets(self) -> dict:
        """key -> bucket over every model (for logging and tests)."""
        return {key: b for per in self._buckets.values()
                for key, b in per.items()}

    def pool_bytes(self) -> int | None:
        return self.site.pool_bytes()

    def refuse(self, model) -> None:
        """Raise ``ValueError`` for a model no graph may capture."""
        if getattr(model, "trainable", False) or \
                getattr(model, "mesh", None) is not None:
            raise ValueError(
                f"the captured {self.what} serves a plain serving Model: a "
                f"trainable model rebuilds its weight views every forward "
                f"and a meshed one runs DTensor; pass cuda_graphs=False")

    def _binding(self) -> tuple:
        """What a captured step holds of the runtime: the pools'
        addresses, and its ``fused`` (a graph holds the step's kernels,
        the fusions and the extend launch, or the plain chains)."""
        return (self.rt.k_pages.data_ptr(), self.rt.v_pages.data_ptr(),
                self.rt.fused)

    def _per_model(self, model, graphs: bool = True) -> dict:
        """``model``'s buckets (refused unless it may be captured, when
        ``graphs``), all dropped first if ``_binding()`` changed."""
        if graphs:
            self.refuse(model)
        binding = self._binding()
        if binding != self._bound_to:
            self.clear()
            self._bound_to = binding
        return self._buckets.setdefault(model, {})

    def _fill(self, ints: torch.Tensor, host: np.ndarray) -> None:
        """One host-to-device copy of ``host`` into ``ints``; on the card
        from pinned memory, not waiting for the stream."""
        t = torch.from_numpy(host)
        if self.capture:
            t = t.pin_memory()
        ints.copy_(t, non_blocking=self.capture)

    def _run(self, b, step, graphs: bool = True) -> None:
        """``step()`` for bucket ``b``: eagerly (the CPU, ``graphs``
        False, or a use before ``capture_at``), captured, or replayed."""
        if not (self.capture and graphs):
            step()
        elif b.graph is not None:
            b.graph.replay()
            self.replays += 1
            credit_launches(b.launches)
        elif b.uses + 1 < self.capture_at:
            b.uses += 1
            step()
        else:
            self._capture(b, step)

    def _capture(self, b, step) -> None:
        """Capture ``step`` into the bucket's graph on the capture stream.

        A bucket's first use is its warm-up (the lazy set-up of libraries
        and handles must not fall inside a capture): it runs the step
        eagerly on the capture stream first, and that run is this use's
        result; the capture after it relies on the step being idempotent
        for fixed input buffers (each step's docstring says why), as the
        graph's first replay comes with the next use's inputs. A bucket
        that ran eagerly before is warm: it is captured at once, and its
        first replay is this use's result."""
        t0 = time.perf_counter()
        dev = self.rt.device
        pool, side = self.site.open(dev)
        main = torch.cuda.current_stream(dev)
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            if not b.uses:
                step()
            launches = counted_capture(graph, pool, step)
        main.wait_stream(side)
        b.graph = graph
        b.launches = launches
        if b.uses:
            graph.replay()
            credit_launches(b.launches)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0


class DecodeGraphs(StepGraphs):
    """The decode buckets of one runtime, keyed ``(B, n_tab)``. ``step``
    fills a bucket's input buffers and runs the step: on the card it
    captures the bucket's graph on first use and replays it after; on
    the CPU it runs the step eagerly on the buffers.

    Capturing after the first eager run is safe: the step reads a row's
    pages only below ``lens[b]`` (the decode kernel reads live slots
    only, and the new token's own k/v is merged from registers, not from
    its page) and writes only slot ``lens[b]`` of each append page, with
    the same values."""

    what = "decode step"

    def _bucket(self, model, B: int, n_tab: int) -> Bucket:
        per = self._per_model(model)
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
        self._fill(b.ints, pack_inputs(tables, lens, app_pages, app_offs))
        self._run(b, lambda: self.rt._decode_step(
            model, *b.inputs(), out=(b.logits, b.nxt)))
        return b.logits.clone(), b.nxt.clone()
