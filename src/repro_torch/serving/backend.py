"""Execution backend for the engine: REAL model execution over a
:class:`~repro_torch.serving.paged_runtime.PagedKVRuntime`, the PyTorch
port of ``repro.serving.backend.JaxModelBackend``.

Every prefill chunk and decode token runs through the model with the
program's KV in refcounted physical pages; a step's duration is measured
wall time, taken after the device has finished the step. On a GPU this is
the production path (hand-written CUDA kernels for decode attention and
every page move); ``device="cpu"`` runs the kernels' plain versions. The
scheduler/TTL logic is the unchanged control plane, as under ``SimBackend``.

Physical staging: the engine's demote/reload hooks land here as
``offload_program``/``restore_program``. A demotion batch-gathers the
program's scattered pages into contiguous staging buffers
(``PagedKVRuntime.stage_out``) and moves them to pinned host memory in one
bulk copy per pool; a reload scatters them back (``restore``). Prompt
token ids are drawn per (stream, absolute position) — programs sharing a
preamble share the exact token ids, so radix prefix hits are physically
bit-identical pages, not just accounting entries.
"""
from __future__ import annotations

import math
import time
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import resolve_device
from repro_torch.kernels.page_copy import gather_pages
from repro_torch.models.transformer import Model
from repro_torch.serving.paged_runtime import PagedKVRuntime
from repro_torch.serving.prefix import (PrefixConfig, RadixPrefixIndex,
                                        request_block_hashes)


class TorchModelBackend:
    """Real generation; per-program KV in a PagedKVRuntime's physical
    pages (so a TTL hit genuinely reuses the computed cache, an eviction
    genuinely loses it, and a demotion genuinely stages it out through
    the page-copy kernels)."""

    def __init__(self, cfg: ModelConfig, model: Model | None = None,
                 seed: int = 0, max_len: int = 4096,
                 runtime: PagedKVRuntime | None = None,
                 n_pages: Optional[int] = None, page_size: int = 16,
                 device="cuda"):
        self.device = resolve_device(device)
        if runtime is None:           # raises for the families not ported
            runtime = PagedKVRuntime(
                cfg, n_pages=n_pages or max(64, 2 * max_len // page_size),
                page_size=page_size, device=self.device)
        self.cfg = cfg
        self.runtime = runtime
        self.model = model if model is not None else \
            Model(cfg, device=self.device, seed=seed)
        self.max_len = max_len
        self.seed = seed
        self._streams: dict[str, torch.Tensor] = {}   # stream -> token ids
        # staged-out host copies: program_id -> (k, v, tokens); the
        # buffers are CPU tensors (pinned when the device is a GPU) in the
        # page-copy staging layout (L, pages, page, KV, Dh)
        self.host_caches: dict[str, tuple] = {}
        # page-stamped radix mirror of the scheduler's accounting index
        # (enable_prefix_sharing); None = no cross-program sharing
        self.prefix_index: Optional[RadixPrefixIndex] = None
        self._step = 0                  # logical clock for radix LRU
        self.prefill_tokens_computed = 0  # TTL savings show up here
        self.decode_tokens_computed = 0
        self.demotions = 0
        self.restores = 0
        self.shortfall_tokens = 0       # defensive recompute (cache lost)
        # differential harness: verify every restore round-trips bit-exact
        self.verify_staging = False
        self.staging_checks: list[tuple[str, bool]] = []

    # --------------------------------------------------- physical sharing
    def enable_prefix_sharing(self) -> RadixPrefixIndex:
        """Attach a page-stamped radix index to the runtime: admissions
        the scheduler serves from its (accounting) radix index are
        realized as shared physical pages here, and page-pool pressure
        LRU-evicts unreferenced shared paths."""
        if self.prefix_index is None:
            self.prefix_index = RadixPrefixIndex(
                PrefixConfig(block_size=self.runtime.page_size))
            self.runtime.attach_index(self.prefix_index)
            self.runtime.on_pressure = self._relieve_pressure
        return self.prefix_index

    def _relieve_pressure(self, need: int) -> None:
        """Page-pool pressure: LRU-evict unreferenced shared radix paths
        until `need` pages are actually free."""
        rt = self.runtime
        while len(rt.free) < need and self.prefix_index is not None:
            if self.prefix_index.evict(max(need, 4)) <= 0:
                return

    def drop_prefix_chain(self, hashes: tuple, keep_blocks: int) -> int:
        """Scheduler accounting-index eviction propagated to the
        page-stamped mirror: drop the same hash chain (beyond
        ``keep_blocks``) so the two radix trees cannot drift apart. The
        mirror's ``on_evict_node`` derefs the dropped nodes' pages."""
        if self.prefix_index is None:
            return 0
        return self.prefix_index.evict_chain(hashes, keep_blocks)

    # ------------------------------------------------------ token streams
    def _stream(self, name: str) -> torch.Tensor:
        """Deterministic token ids for a content stream, one id per
        absolute position (stable across turns and across programs that
        share the stream), drawn from a numpy generator seeded by
        (seed, crc32(name))."""
        s = self._streams.get(name)
        if s is None:
            rng = np.random.default_rng(
                [self.seed, zlib.crc32(name.encode()) & 0x7FFFFFFF])
            s = torch.from_numpy(rng.integers(0, self.cfg.vocab_size,
                                              self.max_len))
            self._streams[name] = s
        return s

    def prompt_tokens(self, req, start: int, end: int) -> torch.Tensor:
        """Prompt ids for positions [start, end): positions inside the
        shared preamble draw from the shared stream — the physical basis
        for COW sharing — the rest from the program's own stream."""
        assert 0 <= start < end <= self.max_len, (start, end, self.max_len)
        shared = min(req.shared_prefix_len, req.prompt_len) \
            if req.shared_prefix_id else 0
        parts = []
        if start < shared:
            parts.append(self._stream(req.shared_prefix_id)
                         [start:min(end, shared)])
        if end > shared:
            parts.append(self._stream(req.program_id)[max(start, shared):end])
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    # --------------------------------------------------- engine KV hooks
    def drop_program(self, program_id: str) -> None:
        """Called on eviction/unpin: the cache is genuinely gone."""
        if program_id in self.runtime.programs:
            self.runtime.evict(program_id, force=True)
        self.host_caches.pop(program_id, None)

    def drop_host_copy(self, program_id: str) -> None:
        """Tier-store eviction (LRU pressure victim): only the host copy
        dies; any live device cache stays untouched."""
        self.host_caches.pop(program_id, None)

    def _to_host(self, staging: torch.Tensor) -> torch.Tensor:
        host = torch.empty(staging.shape, dtype=staging.dtype,
                           pin_memory=staging.is_cuda)
        host.copy_(staging)
        return host

    def offload_program(self, program_id: str) -> None:
        """Demotion (TTL expiry or preemption): batch-gather the
        program's scattered pages into contiguous staging buffers (the
        gather kernel), copy each pool's buffer to host memory in one bulk
        copy, free the device pages. The context is NOT lost — paired
        with the TieredKVStore entry the scheduler created."""
        rt = self.runtime
        e = rt.programs.get(program_id)
        if e is None or e.length == 0:
            return
        k, v, n = rt.stage_out(program_id)
        self.host_caches[program_id] = (self._to_host(k), self._to_host(v), n)
        rt.evict(program_id, force=True)
        self.demotions += 1

    def restore_program(self, program_id: str,
                        tokens: Optional[int] = None) -> None:
        """Offload-tier reload: scatter the staged host copy back into
        freshly allocated physical pages. ``tokens`` (the store entry's
        usable prefix) truncates the restore; the engine recomputes the
        rest."""
        entry = self.host_caches.pop(program_id, None)
        if entry is None:
            return                       # lost copy: engine recomputes
        k, v, n = entry
        if tokens is not None:
            n = min(n, int(tokens))
        if n <= 0:
            return
        pages = math.ceil(n / self.runtime.page_size)
        k, v = k[:, :pages], v[:, :pages]
        ids = self.runtime.restore(program_id, k, v, n)
        if self.verify_staging:          # differential harness: bit-exact?
            back_k = gather_pages(self.runtime.k_pages, ids).cpu()
            back_v = gather_pages(self.runtime.v_pages, ids).cpu()
            ok = torch.equal(back_k, k) and torch.equal(back_v, v)
            self.staging_checks.append((program_id, ok))
        self.restores += 1

    # ------------------------------------------------------------ execute
    def _req_hashes(self, req):
        return request_block_hashes(req, self.runtime.page_size)

    @staticmethod
    def _bucket(n: int) -> int:
        """Pad chunk lengths to powers of two (the JAX package's bound on
        recompilation; kept so both backends run the same shapes)."""
        b = 16
        while b < n:
            b *= 2
        return b

    def _materialize(self, req, target: int, expected: int) -> None:
        """Ensure the program's pages cover [0, target) — recompute any
        gap from the deterministic streams (a lost host copy or a
        truncated restore self-heals here), counting a recompute below
        ``expected`` (what the engine believes is materialized) as a
        shortfall."""
        rt = self.runtime
        e = rt.programs.get(req.program_id)
        start = e.length if e is not None else 0
        if start < target:
            toks = self.prompt_tokens(req, start, target)
            rt.prefill(self.model, req.program_id, toks,
                       pad_to=self._bucket(target - start))
            self.prefill_tokens_computed += target - start
            if start < min(target, expected):
                self.shortfall_tokens += min(target, expected) - start

    def execute(self, prefill, decode) -> float:
        t0 = time.perf_counter()
        rt = self.runtime
        self._step += 1
        now = float(self._step)
        for work in prefill:
            req = work.req
            pid = req.program_id
            if work.context == 0 and pid in rt.programs:
                # full recompute: the engine decided the old cache is
                # unusable (preemption / expiry without a tier copy)
                rt.evict(pid, force=True)
            if pid not in rt.programs and work.context > 0 \
                    and req.served_from_shared \
                    and self.prefix_index is not None:
                # radix admission -> shared physical pages (COW adoption)
                rt.adopt_prefix(self.prefix_index, pid, self._req_hashes(req),
                                now=now, max_tokens=work.context)
            self._materialize(req, work.context + work.chunk,
                              expected=work.context)
            if work.context + work.chunk >= req.prompt_len \
                    and self.prefix_index is not None:
                # prompt complete: publish / dedup into the shared index
                rt.publish_prefix(self.prefix_index, pid,
                                  self._req_hashes(req), now=now)
        decode_pids = []
        for req in decode:
            pid = req.program_id
            # pages must cover every position a decode step attends to:
            # prompt + already-generated tokens (minus the pending one)
            target = req.prompt_len + max(req.generated - 1, 0)
            self._materialize(req, target, expected=target)
            decode_pids.append(pid)
        if decode_pids:
            # the whole decode batch through ONE kernel launch per layer
            rt.decode_batch(self.model, decode_pids)
            self.decode_tokens_computed += len(decode_pids)
        if self.device.type == "cuda":
            # the launches above are asynchronous: the step ends when the
            # device has finished it, not when the host has queued it
            torch.cuda.synchronize(self.device)
        return max(time.perf_counter() - t0, 1e-6)
