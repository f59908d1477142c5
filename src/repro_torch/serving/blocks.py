"""Paged KV block allocator with TTL pinning (vLLM-style, device-agnostic).

Blocks are the accounting unit for HBM KV memory. Pinning (the paper's core
mechanism) keeps a finished request's blocks allocated, owned by its
program, so the program's next turn can *adopt* them and skip prefill.

SSM archs have near-constant per-request state; they use ``state_blocks``
per request instead of per-token blocks — the same pin/adopt machinery
applies (see DESIGN.md §4).

Besides per-request allocations and per-program pins, the pool has a third
owner: the *shared pool* — blocks whose content is deduplicated across
requests/programs by the radix prefix index
(:mod:`repro_torch.serving.prefix`). A shared block may back many requests at
once; the index refcounts them and calls :meth:`BlockManager.shared_free`
only when eviction reclaims a refcount-zero path. The global invariant is

    used == sum(alloc) + sum(pinned) + shared
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class BlockConfig:
    total_blocks: int
    block_size: int = 16                  # tokens per block
    state_blocks: int = 0                 # fixed blocks per request (SSM/hybrid)
    watermark: float = 0.01               # reserve fraction (vLLM-style)


class BlockManager:
    def __init__(self, cfg: BlockConfig):
        self.cfg = cfg
        self.total = cfg.total_blocks
        self.used = 0
        self.alloc: dict[int, int] = {}            # request_id -> blocks
        self.pinned: dict[str, int] = {}           # program_id -> blocks
        self.shared = 0                            # blocks owned by the
        self.peak_used = 0                         # shared-prefix pool

    # ----------------------------------------------------------- accounting
    def blocks_for_tokens(self, tokens: int) -> int:
        per_token = math.ceil(max(tokens, 0) / self.cfg.block_size)
        return per_token + self.cfg.state_blocks

    @property
    def free(self) -> int:
        return self.total - self.used

    @property
    def watermark_blocks(self) -> int:
        return int(self.total * self.cfg.watermark)

    def can_allocate(self, n: int) -> bool:
        return n <= self.free - self.watermark_blocks

    def pinned_total(self) -> int:
        return sum(self.pinned.values())

    # ----------------------------------------------------------- lifecycle
    def allocate(self, request_id: int, n: int) -> None:
        assert n <= self.free, (n, self.free)
        self.alloc[request_id] = self.alloc.get(request_id, 0) + n
        self.used += n
        self.peak_used = max(self.peak_used, self.used)

    def extend(self, request_id: int, n: int = 1) -> bool:
        """Grow a running request (decode); False if OOM."""
        if n > self.free:
            return False
        self.alloc[request_id] += n
        self.used += n
        self.peak_used = max(self.peak_used, self.used)
        return True

    def free_request(self, request_id: int) -> int:
        n = self.alloc.pop(request_id, 0)
        self.used -= n
        return n

    # ------------------------------------------------------------- pinning
    def pin(self, request_id: int, program_id: str) -> int:
        """Convert a finished request's allocation into a program pin."""
        n = self.alloc.pop(request_id, 0)
        if n:
            self.pinned[program_id] = self.pinned.get(program_id, 0) + n
        return n

    def unpin_free(self, program_id: str) -> int:
        """Release a pin entirely (TTL expiry / deadlock victim)."""
        n = self.pinned.pop(program_id, 0)
        self.used -= n
        return n

    def adopt_pin(self, program_id: str, request_id: int) -> int:
        """TTL hit: transfer the program's pinned blocks to its new request.
        Returns the number of blocks adopted (0 = miss)."""
        n = self.pinned.pop(program_id, 0)
        if n:
            self.alloc[request_id] = self.alloc.get(request_id, 0) + n
        return n

    # -------------------------------------------------- shared-prefix pool
    def to_shared(self, request_id: int, n: int) -> int:
        """Transfer up to `n` blocks from a request's allocation into the
        shared pool (prompt blocks entering the radix index). `used` is
        unchanged — ownership moves, memory doesn't."""
        moved = min(n, self.alloc.get(request_id, 0))
        if moved:
            self.alloc[request_id] -= moved
            self.shared += moved
        return moved

    def free_duplicates(self, request_id: int, n: int) -> int:
        """Free up to `n` of a request's blocks whose content turned out to
        already be in the shared pool (another request inserted the same
        prefix first)."""
        freed = min(n, self.alloc.get(request_id, 0))
        if freed:
            self.alloc[request_id] -= freed
            self.used -= freed
        return freed

    def shared_free(self, n: int) -> None:
        """Radix eviction reclaimed `n` refcount-zero shared blocks."""
        assert n <= self.shared, (n, self.shared)
        self.shared -= n
        self.used -= n

    def check(self) -> None:
        """Assert the ownership invariant (tests / debugging)."""
        owned = sum(self.alloc.values()) + sum(self.pinned.values()) \
            + self.shared
        assert owned == self.used, (owned, self.used)
        assert self.shared >= 0 and self.used >= 0

    def utilization(self) -> float:
        return self.used / max(self.total, 1)
