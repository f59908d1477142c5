"""Paged KV runtime: physical page pools + block tables, decoded through
the CUDA paged-attention kernel.

This is the layer where Continuum's mechanism is visible at the memory
system level: a program's KV lives in scattered physical pages; *pinning*
keeps the pages allocated and the block table alive across the tool-call
gap, so the next turn decodes against the same physical pages (zero
recompute, zero copy); *eviction* derefs the pages back toward the free
list.

Pages are *refcounted*: a radix-index prefix hit maps a new program's
block table onto the same physical page ids another program already
filled (``adopt_prefix``), and the first divergent write to a shared page
triggers a copy-on-write split through the ``page_copy`` kernels — the
prefix is shared in device memory for real, not just in accounting.
``stage_out``/``restore`` batch-gather scattered pages into contiguous
staging buffers (one bulk copy) for tier moves.

The PyTorch port of ``repro.serving.paged_runtime``: same public surface,
same allocation order (``free.pop()``), so an identical sequence of
operations gives identical page ids and refcounts. The pools live on
``device`` and are updated in place (the JAX runtime rebinds new
arrays). On a CUDA device every page copy, append and decode attention
launches a hand-written kernel; ``device="cpu"`` runs their plain
versions. It serves the reference's ``PAGED_FAMILIES``: dense (not
gemma2's local/global layers), MoE (no leading dense layers, ROADMAP R4),
audio and VLM.

The batched decode step is captured as a CUDA graph per ``(model, B,
n_tab)`` bucket and replayed (:mod:`.decode_graph`), as the reference
jits it per ``(B, n_tab)``; so is a prefill or extend chunk per ``(model,
mode, Sp, T)`` bucket (:mod:`.prefill_graph`), as the reference compiles
its scanned forward per padded chunk length. ``cuda_graphs=False`` runs
both eagerly, one launch at a time. Inside the decode step, the
elementwise chains that XLA fuses in the reference's scan (the RMS norms
and residual adds, the qkv bias and RoPE, the new token's merge, the
gated activation) are hand-written kernels on the card
(:mod:`repro_torch.kernels.fusions`); so are a chunk's norms and gated
activation, and an extend chunk's attention over the cache is the flash
kernels' extend launch (``Model.forward(..., fused=True)``).
``fused=False`` runs their plain spelling there, one torch op at a time,
to compare the two.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import fusions, resolve_device, to_device
from repro_torch.kernels.page_copy import (append_tokens_indexed,
                                           copy_pages, gather_pages,
                                           scatter_pages)
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import (rope_tables, sinusoidal_emb,
                                       torch_dtype)
from repro_torch.models.transformer import ffn_apply, first_k_dense
from repro_torch.serving.decode_graph import (CaptureSite, DecodeGraphs,
                                              pack_inputs, unpack_inputs)
from repro_torch.serving.prefill_graph import (CAPACITY_STEP, PrefillGraphs,
                                               capacity, pack_chunk)

#: families whose per-token KV lives in uniform pages (the runtime's, and
#: therefore TorchModelBackend's, supported set), as in the reference
PAGED_FAMILIES = ("dense", "moe", "audio", "vlm")


def require_paged(cfg: ModelConfig) -> None:
    """Raise for what the runtime does not serve, before any pool is
    allocated. As the reference's engine backend (``JaxModelBackend``
    requires a uniform-attention family), it refuses RWKV6 (``ssm``) and
    zamba2 (``hybrid``), which are not in ``PAGED_FAMILIES``, and gemma2,
    whose local layers keep a sliding-window ring (``local_global_
    alternating``): each runs through ``Model.forward`` only. It also
    refuses a MoE model with leading dense layers, whose ``dense_layers``
    and ``k0``/``v0`` cache the reference runtime never reads (ROADMAP
    R4)."""
    if cfg.family not in PAGED_FAMILIES or cfg.local_global_alternating:
        what = ("local/global layers" if cfg.local_global_alternating
                else f"the {cfg.family!r} family")
        raise NotImplementedError(
            f"{cfg.name} ({what}) runs through Model.forward only; the "
            f"paged runtime serves the uniform-attention families "
            f"{PAGED_FAMILIES} (the reference's engine backend refuses the "
            f"others: use SimBackend for SSM and hybrid models)")
    if first_k_dense(cfg):
        raise ValueError(
            f"{cfg.name}: {first_k_dense(cfg)} leading dense layer(s) "
            f"(first_k_dense): the reference runtime pages only the "
            f"uniform blocks and ignores dense_layers and the k0/v0 cache "
            f"(ROADMAP R4), so the port serves no such model either")


@dataclasses.dataclass
class ProgramEntry:
    pages: list[int]
    length: int
    pinned: bool = False


class PagedKVRuntime:
    """``cuda_graphs`` (default on): the batched decode step goes through
    :class:`~repro_torch.serving.decode_graph.DecodeGraphs` and a prefill
    chunk through :class:`~repro_torch.serving.prefill_graph.
    PrefillGraphs`, captured and replayed on the card, on persistent
    buffers on the CPU; False runs both eagerly (the chunk on the same
    buffers). The flag is read at every step.

    ``fused`` (default on): the decode step's elementwise chains, and a
    prefill chunk's norms and gated activation, run as the fused kernels
    of :mod:`repro_torch.kernels.fusions` on the card (their plain
    versions on the CPU), and an extend chunk's attention as the flash
    kernels' extend launch; False runs the plain spelling on any device,
    for comparisons on the card. Read at every step; a change drops the
    captured graphs."""

    def __init__(self, cfg: ModelConfig, n_pages: int = 64,
                 page_size: int = 16, device="cuda",
                 cuda_graphs: bool = True, fused: bool = True):
        require_paged(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cuda_graphs = cuda_graphs
        self.fused = fused
        # an extend chunk's scratch capacity is a multiple of this many
        # tokens (prefill_graph.capacity): each capacity is a bucket
        self.capacity_step = CAPACITY_STEP
        site = CaptureSite()
        self.graphs = DecodeGraphs(self, site)
        self.prefill_graphs = PrefillGraphs(self, site)
        self.page_size = page_size
        self.n_pages = n_pages
        L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        dt = torch_dtype(cfg.kv_cache_dtype or cfg.compute_dtype)
        shape = (L, n_pages, page_size, KV, Dh)
        self.k_pages = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dt, device=self.device)
        self.free: list[int] = list(range(n_pages))
        self.refs: dict[int, int] = {}             # page id -> holders
        self.programs: dict[str, ProgramEntry] = {}
        # last token per program: a 0-d int64 tensor on the device, so a
        # decode step feeds the previous step's argmax without a host sync
        self._last: dict[str, torch.Tensor] = {}
        self.cow_splits = 0
        # called with a page deficit when the free list runs dry — the
        # owner (an engine backend) LRU-evicts unreferenced radix-held
        # pages before the allocation is retried (page-pool pressure)
        self.on_pressure = None  # type: Optional[callable]
        # differential-harness hooks: when set, every COW split is
        # verified bit-exact (copied page == source page) and recorded
        self.verify_copies = False
        self.copy_checks: list[bool] = []
        # telemetry (repro_torch.obs): COW splits / stage-out / restore
        # land on the owning replica's lane; obs_clock supplies the
        # virtual time (the runtime itself is clockless)
        self.obs = None
        self.obs_replica = ""
        self.obs_clock = None  # type: Optional[callable]

    def _obs_event(self, name: str, program_id: str, args: dict) -> None:
        if self.obs is not None:
            now = self.obs_clock() if self.obs_clock is not None else 0.0
            self.obs.tier_event(self.obs_replica, name, program_id, now,
                                args)

    # ------------------------------------------------------------- alloc
    def _alloc_page(self) -> int:
        if not self.free and self.on_pressure is not None:
            self.on_pressure(1)
        if not self.free:
            raise MemoryError("out of KV pages")
        pi = self.free.pop()
        self.refs[pi] = 1
        return pi

    def _deref(self, pi: int) -> None:
        self.refs[pi] -= 1
        assert self.refs[pi] >= 0, (pi, self.refs[pi])
        if self.refs[pi] == 0:
            del self.refs[pi]
            self.free.append(pi)

    def _ensure_capacity(self, e: ProgramEntry, new_len: int) -> None:
        need = math.ceil(new_len / self.page_size)
        while len(e.pages) < need:
            e.pages.append(self._alloc_page())

    def grow(self, n_pages_total: int) -> None:
        """Grow the physical pools to ``n_pages_total`` pages (no-op if
        already at least that big). The engine calls this at wiring time
        so the page pool covers its accounting block pool 1:1 — the
        BlockManager's admission control then guarantees the runtime
        never OOMs before accounting does."""
        extra = n_pages_total - self.n_pages
        if extra <= 0:
            return
        pad = (self.k_pages.shape[0], extra) + tuple(self.k_pages.shape[2:])
        self.k_pages = torch.cat(
            [self.k_pages, self.k_pages.new_zeros(pad)], dim=1)
        self.v_pages = torch.cat(
            [self.v_pages, self.v_pages.new_zeros(pad)], dim=1)
        self.graphs.clear()          # the graphs hold the old pools
        self.prefill_graphs.clear()
        self.free.extend(range(self.n_pages, n_pages_total))
        self.n_pages = n_pages_total

    def _writable_page(self, e: ProgramEntry, idx: int) -> int:
        """The physical page for e's logical block `idx`, made exclusive:
        a shared page (refs > 1) is COW-split through the page_copy
        kernels before the first write lands on it."""
        pi = e.pages[idx]
        if self.refs.get(pi, 1) == 1:
            return pi
        new = self._alloc_page()
        copy_pages(self.k_pages, [pi], [new])
        copy_pages(self.v_pages, [pi], [new])
        if self.verify_copies:          # differential harness: bit-exact?
            ok = torch.equal(self.k_pages[:, new], self.k_pages[:, pi]) and \
                torch.equal(self.v_pages[:, new], self.v_pages[:, pi])
            self.copy_checks.append(ok)
        self.refs[pi] -= 1
        e.pages[idx] = new
        self.cow_splits += 1
        if self.obs is not None:
            self.obs.cow_splits.inc(1.0, (self.obs_replica,))
            self._obs_event("cow_split", "", {"src_page": int(pi),
                                              "dst_page": int(new)})
        return new

    def evict(self, program_id: str, force: bool = False) -> bool:
        """Deref the program's pages. A *pinned* program (TTL retention in
        flight) refuses eviction unless ``force=True`` — returning False
        instead of silently freeing pages the next turn depends on."""
        e = self.programs.get(program_id)
        if e is None:
            return True
        if e.pinned and not force:
            return False
        del self.programs[program_id]
        for pi in e.pages:
            self._deref(pi)
        self._last.pop(program_id, None)
        return True

    def pin(self, program_id: str) -> None:
        self.programs[program_id].pinned = True

    def unpin(self, program_id: str) -> None:
        self.programs[program_id].pinned = False

    def pages_of(self, program_id: str) -> list[int]:
        return list(self.programs[program_id].pages)

    def page_ref(self, pi: int) -> int:
        return self.refs.get(pi, 0)

    # ----------------------------------------------- physical prefix sharing
    def attach_index(self, index) -> None:
        """Wire a :class:`~repro_torch.serving.prefix.RadixPrefixIndex` to
        this runtime: LRU eviction of a page-stamped node derefs its
        physical pages here (freeing them once no program references
        them)."""
        def _on_evict(node):
            for pi in (node.page_ids or []):
                self._deref(pi)
        index.on_evict_node = _on_evict

    def adopt_prefix(self, index, program_id: str,
                     hashes: tuple[int, ...], now: float = 0.0,
                     max_tokens: Optional[int] = None) -> int:
        """Radix hit → shared physical pages: match `hashes` against the
        page-stamped index and create `program_id`'s entry referencing
        the SAME page ids (refcount bump, zero copy). Returns the shared
        token count (0 = miss). The first divergent write COW-splits.

        ``max_tokens`` caps the adopted length below the block boundary
        (the scheduler charges at most ``prompt_len - 1`` cached tokens,
        so the last prompt token is recomputed *into the shared page* —
        the append that exercises the COW split)."""
        blocks, node = index.acquire(hashes, now)
        if node is None:
            return 0
        ids = index.path_page_ids(node)
        index.release(node)      # physical safety lives in self.refs now
        if ids is None or len(ids) < blocks:
            return 0
        tokens = blocks * self.page_size
        if max_tokens is not None and max_tokens < tokens:
            tokens = max_tokens
        blocks = math.ceil(tokens / self.page_size)
        if blocks == 0:
            return 0
        ids = ids[:blocks]
        for pi in ids:
            self.refs[pi] += 1
        self.programs[program_id] = ProgramEntry(list(ids), tokens)
        return tokens

    def publish_prefix(self, index, program_id: str,
                       hashes: tuple[int, ...], now: float = 0.0) -> int:
        """Publish this program's full pages into a page-stamped radix
        index. Newly inserted blocks hand the tree its own reference;
        blocks already present dedup: the program's duplicate pages are
        swapped for the tree's canonical ones and its copies deref'd.
        Returns the number of deduplicated pages."""
        e = self.programs[program_id]
        full = min(len(hashes), e.length // self.page_size)
        if full == 0:
            return 0
        hs = tuple(hashes[:full])
        new, dup, node = index.insert(hs, None, 0, now,
                                      page_ids=e.pages[:full])
        if node is None:
            return 0
        if new:                  # the tree holds a ref on every new page
            for pi in e.pages[full - new:full]:
                self.refs[pi] += 1
        canonical = index.path_page_ids(node)
        index.release(node)      # tree retention is LRU, not a lock
        if canonical is None:    # mixed page-stamped/accounting-only path
            return 0
        deduped = 0
        shared = full - new      # leading blocks already in the tree
        for i in range(shared):
            mine, theirs = e.pages[i], canonical[i]
            if mine != theirs:
                self.refs[theirs] += 1
                self._deref(mine)
                e.pages[i] = theirs
                deduped += 1
        return deduped

    # ------------------------------------------------------- tier staging
    def stage_out(self, program_id: str):
        """Batch-gather the program's scattered pages into contiguous
        (L, n, page, KV, Dh) staging buffers on the device — the unit a
        tier move copies to host memory in one transfer. Returns
        ``(k_staging, v_staging, length)``."""
        e = self.programs[program_id]
        self._obs_event("stage_out", program_id, {"pages": len(e.pages),
                                                  "length": e.length})
        return (gather_pages(self.k_pages, e.pages),
                gather_pages(self.v_pages, e.pages), e.length)

    def restore(self, program_id: str, k_staging, v_staging,
                length: int) -> list[int]:
        """Scatter reloaded contiguous staging buffers (host or device
        tensors) into freshly allocated physical pages (the H2D leg of a
        promotion). Returns the new page ids."""
        stale = self.programs.pop(program_id, None)
        if stale is not None:           # defensive: never leak pages
            for pi in stale.pages:
                self._deref(pi)
        n = k_staging.shape[1]
        pages: list[int] = []
        try:
            for _ in range(n):
                pages.append(self._alloc_page())
        except MemoryError:             # roll back the partial allocation
            for pi in pages:
                self._deref(pi)
            raise
        k_dev = k_staging.to(self.device, non_blocking=True).contiguous()
        v_dev = v_staging.to(self.device, non_blocking=True).contiguous()
        scatter_pages(self.k_pages, k_dev, pages)
        scatter_pages(self.v_pages, v_dev, pages)
        self.programs[program_id] = ProgramEntry(pages, length)
        self._obs_event("restore", program_id, {"pages": len(pages),
                                                "length": length})
        return pages

    # ----------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, model, program_id: str, tokens: torch.Tensor,
                pad_to: Optional[int] = None) -> torch.Tensor:
        """Run ``model``'s prefill and scatter the contiguous per-layer KV
        into this program's (scattered) physical pages. Returns the final
        *real* position's logits and seeds the program's greedy
        continuation (so a chunked prefill's last chunk leaves decode
        ready to run).

        ``pad_to`` pads the forward pass to a bucketed length (causal
        attention makes the trailing junk tokens invisible to the real
        ones, and only the real KV is scattered into pages). The host
        work here (capacity, the COW split of every page the chunk
        writes, the indices) runs before the step; the step is
        :meth:`_prefill_step` on a bucket's buffers
        (:mod:`.prefill_graph`), captured and replayed as a CUDA graph
        unless ``cuda_graphs`` is off, eager and bit-equal then."""
        tokens = torch.as_tensor(tokens).reshape(-1)
        S = tokens.shape[0]
        if S == 0:
            raise ValueError("an empty prefill chunk")
        if self.cuda_graphs:            # before any page is touched
            self.prefill_graphs.refuse(model)
        Sp = max(pad_to, S) if pad_to is not None else S
        e = self.programs.setdefault(program_id, ProgramEntry([], 0))
        start = e.length
        self._ensure_capacity(e, start + S)       # pages for REAL tokens only
        ps = self.page_size
        # every page the chunk writes exclusive before the indices are
        # built (a shared page COW-split, as decode_batch does)
        for idx in range(start // ps, (start + S - 1) // ps + 1):
            self._writable_page(e, idx)
        T = capacity(start, Sp, self.capacity_step)
        on_host = tokens.device.type == "cpu"
        host = pack_chunk(tokens.numpy() if on_host else (), start, S, Sp,
                          T, e.pages, ps)
        logits, nxt = self.prefill_graphs.step(
            model, "extend" if start else "prefill", Sp, T, host,
            None if on_host else tokens, graphs=self.cuda_graphs)
        e.length = start + S
        self._last[program_id] = nxt
        return logits

    @torch.no_grad()
    def _prefill_step(self, model, mode, toks, start, last, gather, src,
                      dst, k, v, out):
        """One prefill or extend chunk of ``Sp = toks.shape[0]`` rows
        (:func:`~repro_torch.serving.prefill_graph.pack_chunk`'s views):
        the program's first ``start`` cached tokens gathered into the
        scratch ``k``/``v`` (extend), the forward over the chunk with
        ``start`` and the last real row ``last`` as device tensors (the
        final norm and the head on that row alone), the chunk's real rows
        scattered into their page slots. The last row's fp32 logits (V,)
        and argmax are written into ``out``. Nothing here reads a device
        value on the host, so the step can be captured."""
        if mode == "extend":
            self._gather_into(k, v, gather, start,
                              zero=not attn_mod.takes_extend_launch(
                                  k.is_cuda, toks.shape[0], not self.fused,
                                  False))
        logits, _ = model.forward(toks[None], cache={"k": k, "v": v},
                                  cache_len=start, mode=mode, rows=last,
                                  fused=self.fused)
        self._scatter_from(k, v, src, dst)
        out[0].copy_(logits[0, 0])
        out[1].copy_(out[0].argmax())

    def _pool_rows(self, pool: torch.Tensor) -> torch.Tensor:
        """(L, P * page, KV, Dh): a pool's slots as rows, in place."""
        return pool.view(pool.shape[0], -1, *pool.shape[3:])

    def _scatter_from(self, k, v, src, dst) -> None:
        """Scratch rows ``src`` of every layer into the pools' flat rows
        ``dst`` (one gather and one indexed copy a pool)."""
        for scratch, pool in ((k, self.k_pages), (v, self.v_pages)):
            self._pool_rows(pool)[:, dst] = scratch[:, 0].index_select(1, src)

    def _gather_into(self, k, v, gather, start, zero: bool = True) -> None:
        """The pools' flat rows ``gather`` into scratch rows 0..T-1 of
        every layer, and with ``zero`` every row at or past ``start``
        zeroed: the chunk rewrites its own rows, and the plain attention
        reads the rest masked, where a dead page slot's NaN would survive
        its zero weight. The flash extend launch reads no slot past a
        row's last query (``attention.takes_extend_launch``), so the fused
        chunk's gather leaves them as gathered."""
        live = (torch.arange(k.shape[2], device=k.device) < start)[
            :, None, None] if zero else None
        for scratch, pool in ((k, self.k_pages), (v, self.v_pages)):
            rows = self._pool_rows(pool).index_select(1, gather)
            scratch[:, 0] = torch.where(live, rows, 0) if zero else rows

    # ------------------------------------------------------------ decode
    @torch.no_grad()
    def _decode_step(self, model, toks, tables, lens, app_pages, app_offs,
                     out=None):
        """One decode step for a whole batch: toks (B,) last tokens on the
        device; tables (B, n_tab) sentinel-0-padded ragged block tables and
        lens (B,) CURRENT lengths, int32 on the device (the kernel attends
        over the old pages; the new token's own k/v is merged exactly);
        app_pages/app_offs (B,) int32 on the device: where each new k/v
        lands, read by the indexed append on the device (so a captured
        graph replays it with each step's slots). A Python loop over
        layers, one ``paged_decode_attention`` per layer for ALL B
        programs, and ONE append for all B x L new k/v rows — the pools
        are read in their native layout, never sliced or cast. Returns
        (logits (B, V) in the compute dtype, argmax (B,)), copied into
        ``out`` when given. Nothing here reads a device value on the host,
        so the step can be captured.

        The chains between the products are the ops of
        :mod:`repro_torch.kernels.fusions` (``plain`` when ``fused`` is
        off): a layer's ln1 (after the first layer, with the previous
        FFN's residual add, whose rounded sum it reads), the qkv products
        with their bias, qk norm and RoPE (one launch at up to 16 bf16
        rows) writing k/v straight into the append's (L, B, KV, Dh)
        buffers, decode attention with the new token merged in its
        own launch, ln2 with the attention's residual add (the fp32 sum),
        the dense FFN's gate and up products with their activation (one
        launch at up to 16 bf16 rows), and the last residual add with the
        final norm."""
        cfg = self.cfg
        plain = not self.fused
        B = toks.shape[0]
        L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        eps = cfg.norm_eps
        scale = 1.0 / math.sqrt(Dh)
        positions = lens.long()[:, None]   # (B, 1): new token at `length`
        x = model.params["embed"][toks][:, None]
        if cfg.pos_emb == "sinusoidal":
            # as Model.forward adds it; the reference runtime omits it
            # (ROADMAP R3)
            x = x + sinusoidal_emb(positions, cfg.d_model).to(x.dtype)
        if cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        rope = rope_tables(positions, Dh, cfg.rope_theta,
                           cfg.rope_fraction) \
            if cfg.pos_emb == "rope" else None
        # every layer's new-token k/v, appended to the pages in ONE launch
        ks = x.new_empty((L, B, KV, Dh))
        vs = x.new_empty((L, B, KV, Dh))
        delta = None                       # the previous layer's FFN output

        def qkv_proj(h, wq, wk, wv, *, li, **kw):  # k/v: the append's rows
            return fusions.qkv_proj(h, wq, wk, wv, k_out=ks[li],
                                    v_out=vs[li], plain=plain, **kw)

        def gate_up(h, w1, w3):
            return fusions.gate_up_act(h, w1, w3, cfg.activation,
                                       plain=plain)

        for li, p in enumerate(model.layers):
            if delta is None:
                h = fusions.rms_norm(x, p["ln1"], eps, plain=plain)
            else:
                x, h = fusions.rms_norm(x, p["ln1"], eps, delta, plain=plain)
            a = p["attn"]
            qd = attn_mod.qkv_project(a, h, cfg, None, rope=rope,
                                      project=functools.partial(qkv_proj,
                                                                li=li))
            o = fusions.attend_merged(qd, self.k_pages, self.v_pages, tables,
                                      lens, ks[li], vs[li], layer=li,
                                      scale=scale, plain=plain)
            x, h2 = fusions.rms_norm(x, p["ln2"], eps,
                                     attn_mod.out_project(a, o[:, None]),
                                     fp32_sum=True, plain=plain)
            delta = ffn_apply(p["mlp"], h2, cfg, gate_up=gate_up)
        append_tokens_indexed(self.k_pages, self.v_pages, ks, vs, app_pages,
                              app_offs)
        x, h = fusions.rms_norm(x, model.params["final_norm"], eps, delta,
                                plain=plain)
        logits = (h @ model.head())[:, 0]
        nxt = logits.argmax(-1)
        if out is None:
            return logits, nxt
        out[0].copy_(logits)
        out[1].copy_(nxt)
        return out

    def decode_batch(self, model, program_ids: list[str]) -> list:
        """One decode step for the WHOLE batch through one decode-attention
        call a layer. Returns each program's next-token logits, in
        ``program_ids`` order.

        Per-row results are independent of batch composition and of the
        table padding width (dead table slots never reach the compute or
        the accumulators), so ``decode_batch(ids)`` is bit-identical to
        ``[decode(pid) for pid in ids]`` in any order. The host work here
        (capacity, COW splits, tables) is the same with and without
        ``cuda_graphs``; only the step differs, and its results do not."""
        if not program_ids:
            return []
        assert len(set(program_ids)) == len(program_ids), \
            "duplicate program ids in one decode batch"
        entries = [self.programs[pid] for pid in program_ids]
        ps = self.page_size
        for e in entries:
            self._ensure_capacity(e, e.length + 1)
            # every append page must be exclusive BEFORE the tables are
            # built: a COW split mid-batch would leave some row's table
            # pointing at the stale shared page
            self._writable_page(e, e.length // ps)
        B = len(entries)
        # ragged tables, padded to a pow2 width with the valid sentinel
        # page 0 (the kernel reads live slots only; the padding keeps the
        # plain version's gathers in bounds); pow2 widths keep the graph
        # buckets few, as they bound the reference's retraces
        max_pages = max(len(e.pages) for e in entries)
        n_tab = 1 << max(0, max_pages - 1).bit_length()
        tables = np.zeros((B, n_tab), np.int32)
        for i, e in enumerate(entries):
            tables[i, :len(e.pages)] = e.pages
        lens = np.asarray([e.length for e in entries], np.int32)
        app_pages = np.asarray([e.pages[e.length // ps] for e in entries],
                               np.int32)
        app_offs = np.asarray([e.length % ps for e in entries], np.int32)
        assert len(set(app_pages.tolist())) == B, \
            "append pages must be pairwise distinct (COW resolved above)"
        # the append reads these slots on the device unchecked: check here
        if app_pages.min() < 0 or app_pages.max() >= self.n_pages:
            raise ValueError(f"append pages outside [0, {self.n_pages})")
        last = [self._last[pid] for pid in program_ids]
        if self.cuda_graphs:
            # fresh tensors: the bucket's buffers are overwritten next step
            logits, nxt = self.graphs.step(model, last, tables, lens,
                                           app_pages, app_offs)
        else:
            ints = to_device(pack_inputs(tables, lens, app_pages, app_offs),
                             self.device)
            logits, nxt = self._decode_step(model, torch.stack(last),
                                            *unpack_inputs(ints, B, n_tab))
        for i, pid in enumerate(program_ids):
            self.programs[pid].length += 1
            self._last[pid] = nxt[i]
        return [logits[i] for i in range(B)]

    def decode(self, model, program_id: str) -> torch.Tensor:
        """One decode step for the program's last token, attention served
        by the paged kernel against the (possibly pinned) pages. Delegates
        to :meth:`decode_batch` — sequential and batched decode share one
        code path, so they are bit-identical by construction."""
        return self.decode_batch(model, [program_id])[0]

    def seed_token(self, program_id: str, tok: int) -> None:
        self._last[program_id] = torch.tensor(int(tok), dtype=torch.long,
                                              device=self.device)

    # ---------------------------------------------------------- invariants
    def check(self, index=None) -> None:
        """Assert page-refcount conservation (tests / debugging): every
        page's refcount equals the number of program block-table slots
        plus radix-tree stamps referencing it; free pages carry no refs;
        free + referenced partitions the pool exactly."""
        held: dict[int, int] = {}
        for e in self.programs.values():
            for pi in e.pages:
                held[pi] = held.get(pi, 0) + 1
        if index is not None:
            stack = [index.root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                for pi in (n.page_ids or []):
                    held[pi] = held.get(pi, 0) + 1
        assert held == self.refs, \
            {"expected": held, "refs": self.refs}
        free = set(self.free)
        assert len(free) == len(self.free), "free list has duplicates"
        assert free.isdisjoint(self.refs), free & set(self.refs)
        assert len(free) + len(self.refs) == self.n_pages, \
            (len(free), len(self.refs), self.n_pages)
