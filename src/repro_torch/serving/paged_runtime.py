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
versions. Dense family only (ROADMAP queue 1 item 9 adds the rest).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import resolve_device, to_device
from repro_torch.kernels.decode_attention import paged_decode_attention
from repro_torch.kernels.page_copy import (append_tokens, copy_pages,
                                           gather_pages, scatter_pages)
from repro_torch.models import attention as attn_mod
from repro_torch.models.common import add_rms_norm, rms_norm, torch_dtype
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.transformer import require_dense


@dataclasses.dataclass
class ProgramEntry:
    pages: list[int]
    length: int
    pinned: bool = False


class PagedKVRuntime:
    def __init__(self, cfg: ModelConfig, n_pages: int = 64,
                 page_size: int = 16, device="cuda"):
        require_dense(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
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
        # telemetry hooks of the JAX runtime, kept inert: the port has no
        # telemetry plane yet
        self.obs = None
        self.obs_replica = ""
        self.obs_clock = None  # type: Optional[callable]

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
        ones, and only the real KV is scattered into pages)."""
        tokens = torch.as_tensor(tokens).to(self.device).reshape(-1)
        S = tokens.shape[-1]
        Sp = max(pad_to, S) if pad_to is not None else S
        if Sp > S:
            tokens = torch.cat([tokens, tokens.new_zeros(Sp - S)])
        e = self.programs.setdefault(program_id, ProgramEntry([], 0))
        start = e.length
        self._ensure_capacity(e, start + S)       # pages for REAL tokens only
        cap = len(e.pages) * self.page_size
        cache = model.init_cache(1, max(cap, start + Sp))
        if start:
            # re-materialize existing pages into the contiguous scratch
            self._gather_into(cache, e)
        # keep logits from the last real position onward (Sp - S + 1 rows)
        logits, cache = model.forward(
            tokens.reshape(1, Sp), cache=cache, cache_len=start,
            mode="extend" if start else "prefill", logits_slice=Sp - S + 1)
        self._scatter_from(cache, e, start, S)
        e.length = start + S
        self._last[program_id] = logits[0, 0].argmax()
        return logits[0, 0]

    def _scatter_from(self, cache, e: ProgramEntry, start: int, count: int):
        """Copy cache[k/v][:, 0, start:start+count] into physical pages."""
        ps = self.page_size
        k = cache["k"][:, 0]                       # (L, cap, KV, Dh)
        v = cache["v"][:, 0]
        pos = start
        while pos < start + count:
            off = pos % ps                 # mid-page when adoption was capped
            n = min(ps - off, start + count - pos)
            pi = self._writable_page(e, pos // ps)  # COW-split if shared
            self.k_pages[:, pi, off:off + n] = k[:, pos:pos + n]
            self.v_pages[:, pi, off:off + n] = v[:, pos:pos + n]
            pos += n

    def _gather_into(self, cache, e: ProgramEntry) -> None:
        ps = self.page_size
        for i, pi in enumerate(e.pages):
            n = min(ps, e.length - i * ps)
            if n <= 0:
                break
            cache["k"][:, 0, i * ps:i * ps + n] = self.k_pages[:, pi, :n]
            cache["v"][:, 0, i * ps:i * ps + n] = self.v_pages[:, pi, :n]

    # ------------------------------------------------------------ decode
    @torch.no_grad()
    def _decode_step(self, model, toks, tables, lens, app_pages, app_offs):
        """One decode step for a whole batch: toks (B,) last tokens on the
        device; tables (B, n_tab) sentinel-0-padded ragged block tables and
        lens (B,) CURRENT lengths, int32 on the device (the kernel attends
        over the old pages; the new token's own k/v is merged exactly);
        app_pages/app_offs (B,) host arrays: where each new k/v lands. A
        Python loop over layers, one ``paged_decode_attention`` per layer
        for ALL B programs, and ONE ``append_tokens`` for all B x L new k/v
        rows — the pools are read in their native layout, never sliced or
        cast. Returns (logits (B, V) in the compute dtype, argmax (B,))."""
        cfg = self.cfg
        B = toks.shape[0]
        KV, Dh, H = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
        G = H // KV
        scale = 1.0 / math.sqrt(Dh)
        x = model.params["embed"][toks][:, None]
        if cfg.scale_embeddings:
            x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
        positions = lens.long()[:, None]   # (B, 1): new token at `length`
        ks, vs = [], []
        for li, p in enumerate(model.layers):
            h = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = attn_mod.qkv_project(p["attn"], h, cfg, positions)
            qd = q[:, 0].contiguous()                  # (B, H, Dh)
            k_new, v_new = k[:, 0], v[:, 0]            # (B, KV, Dh)
            acc, m, l = paged_decode_attention(
                qd, self.k_pages, self.v_pages, tables, lens, layer=li,
                scale=scale, return_residuals=True)
            # merge the new token's own (k, v) — not yet in any page —
            # into the kernel's online-softmax state, exactly
            qg = qd.reshape(B, KV, G, Dh).float()
            kf, vf = k_new.float(), v_new.float()
            s_self = (qg * kf[:, :, None, :]).sum(-1) * scale
            m2 = torch.maximum(m, s_self)
            alpha = torch.exp(m - m2)
            p_self = torch.exp(s_self - m2)
            acc2 = acc * alpha[..., None] + p_self[..., None] * vf[:, :, None]
            l2 = l * alpha + p_self
            o = (acc2 / l2.clamp_min(1e-30)[..., None]).reshape(B, H, Dh)
            a = attn_mod.out_project(p["attn"], o.to(x.dtype)[:, None])
            x, h2 = add_rms_norm(x, a, p["ln2"], cfg.norm_eps)
            x = x + mlp_apply(p["mlp"], h2, cfg.activation)
            ks.append(k_new)
            vs.append(v_new)
        # every layer's new-token k/v (L, B, KV, Dh) into the (exclusive)
        # append pages in ONE launch
        append_tokens(self.k_pages, self.v_pages, torch.stack(ks),
                      torch.stack(vs), app_pages, app_offs)
        x = rms_norm(x, model.params["final_norm"], cfg.norm_eps)
        logits = (x @ model.head())[:, 0]
        return logits, logits.argmax(-1)

    def decode_batch(self, model, program_ids: list[str]) -> list:
        """One decode step for the WHOLE batch through one kernel launch
        per layer. Returns each program's next-token logits, in
        ``program_ids`` order.

        Per-row results are independent of batch composition and of the
        table padding width (dead table slots never reach the compute or
        the accumulators), so ``decode_batch(ids)`` is bit-identical to
        ``[decode(pid) for pid in ids]`` in any order."""
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
        # plain version's gathers in bounds)
        max_pages = max(len(e.pages) for e in entries)
        n_tab = 1 << max(0, max_pages - 1).bit_length()
        tables = np.zeros((B, n_tab), np.int32)
        for i, e in enumerate(entries):
            tables[i, :len(e.pages)] = e.pages
        lens = np.asarray([e.length for e in entries], np.int32)
        app_pages = np.asarray([e.pages[e.length // ps] for e in entries],
                               np.int64)
        app_offs = np.asarray([e.length % ps for e in entries], np.int64)
        assert len(set(app_pages.tolist())) == B, \
            "append pages must be pairwise distinct (COW resolved above)"
        toks = torch.stack([self._last[pid] for pid in program_ids])
        logits, nxt = self._decode_step(
            model, toks, to_device(tables, self.device),
            to_device(lens, self.device), app_pages, app_offs)
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
