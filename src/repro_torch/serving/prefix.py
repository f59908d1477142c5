"""Cross-program shared-prefix KV cache: radix index + refcounted blocks.

Continuum's TTL pinning retains KV *per program*; agent fleets additionally
share large prompt *prefixes across programs* (system prompts, tool schemas,
few-shot preambles — KVFlow/CacheWise observe reuse ratios of 50–90% on
SWE-Bench/BFCL-style workloads). This module adds the missing layer:

- :func:`request_block_hashes` maps a request's prompt onto a chain of
  block-granular content hashes. The workload layer marks the first
  ``shared_prefix_len`` tokens of a program as coming from a named shared
  stream (``shared_prefix_id``); the rest is program-unique. Chained
  hashing gives the prefix property: two prompts share a hash prefix iff
  they share a token prefix (at block granularity).

- :class:`RadixPrefixIndex` is a path-compressed radix tree over those
  hashes, per engine. Each node covers a run of KV blocks that live in the
  engine's :class:`~repro_torch.serving.blocks.BlockManager` *shared pool* and
  carries a reference count. Holders (running requests and TTL pin
  entries) lock the deepest node they use; the lock propagates to the
  root, so an ancestor's refcount is always >= any descendant holder's.
  Eviction is LRU over refcount-zero *leaves* — interior nodes and any
  node on a locked path are untouchable, which is exactly the "TTL-pinned
  programs' nodes are pin-protected" invariant.

Lifecycle (wired in :class:`~repro_torch.core.scheduler.Scheduler` and
``engine.step``):

1. ``admit``: the scheduler probes the index; if the radix match beats the
   program's own pin (and any offload entry), the request acquires the
   matched path and is charged blocks only for the uncovered suffix.
2. prefill completion: ``engine.step`` inserts the finished prompt into the
   index. Newly created nodes take ownership of the request's prompt
   blocks (moved into the shared pool); blocks another program inserted
   first are freed as duplicates (the dedup win).
3. finish: a TTL pin inherits the request's lock (pin-protected nodes);
   otherwise the lock is released and the path becomes evictable — but
   stays cached until memory pressure actually reclaims it.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.core.types import Request
    from repro_torch.serving.blocks import BlockManager

_HASH_SEED = 0x5EED


@dataclasses.dataclass
class PrefixConfig:
    enabled: bool = True
    block_size: int = 16          # tokens per block; engine forces its own
    min_match_blocks: int = 1     # ignore matches smaller than this


@dataclasses.dataclass
class PrefixStats:
    hits: int = 0                 # admissions served from the index
    hit_tokens: int = 0           # prompt tokens covered by radix matches
    inserted_blocks: int = 0      # blocks transferred into the shared pool
    dup_blocks_freed: int = 0     # duplicate blocks freed at insert (dedup)
    evicted_blocks: int = 0       # blocks reclaimed by LRU eviction


def request_block_hashes(req: "Request", block_size: int) -> tuple[int, ...]:
    """Chained content hashes for `req`'s prompt, one per *full* block.

    Token block i draws from the shared stream while it lies entirely
    inside the shared prefix, else from the program's unique stream; block
    indices are absolute so successive turns of one program extend (never
    rewrite) the chain. The trailing partial block is excluded — it is
    still growing and stays request-owned. Cached on the request.
    """
    n = req.prompt_len // block_size
    if req.block_hashes is not None and len(req.block_hashes) == n:
        return req.block_hashes
    shared_len = min(req.shared_prefix_len, req.prompt_len)
    shared_id = req.shared_prefix_id
    out = []
    h = _HASH_SEED
    for i in range(n):
        if shared_id is not None and (i + 1) * block_size <= shared_len:
            key = (shared_id, i)
        else:
            key = (req.program_id, i)
        h = hash((h, key))
        out.append(h)
    req.block_hashes = tuple(out)
    return req.block_hashes


class RadixNode:
    __slots__ = ("edge", "children", "parent", "refs", "last_access",
                 "page_ids")

    def __init__(self, edge: list[int], parent: Optional["RadixNode"],
                 refs: int = 0, last_access: float = 0.0,
                 page_ids: Optional[list[int]] = None):
        self.edge = edge                          # block hashes on this edge
        self.children: dict[int, RadixNode] = {}  # first edge hash -> child
        self.parent = parent
        self.refs = refs
        self.last_access = last_access
        # physical HBM page ids backing this edge (1:1 with `edge`), when
        # the index is attached to a PagedKVRuntime — radix hits then map
        # straight to shared physical pages (COW sharing); None when the
        # index is accounting-only (scheduler-level use)
        self.page_ids = page_ids

    @property
    def n_blocks(self) -> int:
        return len(self.edge)

    def depth_blocks(self) -> int:
        """Blocks covered from the root down to (and including) this node."""
        n, node = 0, self
        while node.parent is not None:
            n += len(node.edge)
            node = node.parent
        return n

    def path_hashes(self) -> tuple:
        """The full block-hash chain root→this node (its identity across
        trees: the same prompt produces the same chain in the scheduler's
        accounting index and the backend's page-stamped mirror, even when
        the two trees split their edges differently)."""
        out: list = []
        node = self
        while node.parent is not None:
            out = list(node.edge) + out
            node = node.parent
        return tuple(out)


class RadixPrefixIndex:
    """Per-engine radix tree over prompt block hashes, backed by the
    BlockManager's shared pool (1:1 with the engine's block pool)."""

    def __init__(self, cfg: PrefixConfig,
                 blocks: Optional["BlockManager"] = None):
        self.cfg = cfg
        # None = accounting-free index (attached to a PagedKVRuntime whose
        # refcounted physical pages are the ground truth instead)
        self.blocks = blocks
        self.root = RadixNode([], None, refs=1)   # sentinel, never evicted
        self.stats = PrefixStats()
        # called with each node reclaimed by evict() — the physical-page
        # owner (PagedKVRuntime) uses it to deref the node's page_ids
        self.on_evict_node = None  # type: Optional[callable]

    # ------------------------------------------------------------- internals
    def _walk(self, hashes: tuple[int, ...], split: bool) -> tuple[RadixNode, int]:
        """Longest-prefix walk; with ``split`` a partial edge match splits
        the node so the returned node ends exactly at the match point."""
        node, i = self.root, 0
        while i < len(hashes):
            child = node.children.get(hashes[i])
            if child is None:
                break
            edge = child.edge
            j, lim = 0, min(len(edge), len(hashes) - i)
            while j < lim and edge[j] == hashes[i + j]:
                j += 1
            if j == 0:
                break
            if j < len(edge):
                if split:
                    child = self._split(child, j)
                node, i = child, i + j
                break
            node, i = child, i + j
        return node, i

    def _split(self, child: RadixNode, j: int) -> RadixNode:
        """Split `child` after its j-th edge block; returns the upper half.
        Both halves keep the refcount: every holder whose path runs through
        `child` runs through both halves."""
        upper = RadixNode(child.edge[:j], child.parent, refs=child.refs,
                          last_access=child.last_access)
        if child.page_ids is not None:            # split the physical map too
            upper.page_ids = child.page_ids[:j]
            child.page_ids = child.page_ids[j:]
        child.parent.children[child.edge[0]] = upper
        child.edge = child.edge[j:]
        child.parent = upper
        upper.children[child.edge[0]] = child
        return upper

    def _lock(self, node: RadixNode) -> None:
        while node.parent is not None:
            node.refs += 1
            node = node.parent

    def _touch(self, node: RadixNode, now: float) -> None:
        while node.parent is not None:
            node.last_access = max(node.last_access, now)
            node = node.parent

    # ------------------------------------------------------------ public API
    def match_blocks(self, hashes: tuple[int, ...]) -> int:
        """Read-only probe: blocks of `hashes` present in the tree (used by
        admission sizing and the router's prefix-affinity score)."""
        _, i = self._walk(hashes, split=False)
        return i if i >= self.cfg.min_match_blocks else 0

    def acquire(self, hashes: tuple[int, ...], now: float
                ) -> tuple[int, Optional[RadixNode]]:
        """Lock the longest cached prefix of `hashes` for a new holder.
        Returns (blocks matched, deepest node) — release with release()."""
        node, i = self._walk(hashes, split=True)
        if i < self.cfg.min_match_blocks:
            return 0, None
        self._lock(node)
        self._touch(node, now)
        self.stats.hits += 1
        self.stats.hit_tokens += i * self.cfg.block_size
        return i, node

    def release(self, node: Optional[RadixNode]) -> None:
        """Drop a holder's lock; the path becomes evictable at refcount 0."""
        while node is not None and node.parent is not None:
            node.refs -= 1
            if node.refs < 0:
                raise AssertionError("radix refcount went negative "
                                     "(double release)")
            node = node.parent

    def insert(self, hashes: tuple[int, ...], held: Optional[RadixNode],
               held_blocks: int, now: float,
               page_ids: Optional[list[int]] = None
               ) -> tuple[int, int, Optional[RadixNode]]:
        """Insert a finished prompt; the caller holds `held` (covering
        `held_blocks` blocks, 0 if none). Returns
        ``(new_blocks, dup_blocks, deepest)``:

        - new_blocks entered the tree and must be *transferred* from the
          request's allocation into the shared pool;
        - dup_blocks were concurrently inserted by someone else and the
          caller's copies must be *freed*;
        - deepest replaces `held` as the caller's lock (the old lock is
          released here).

        With `page_ids` (1:1 with `hashes`), the newly created leaf is
        stamped with the physical pages backing its blocks — the caller
        (a PagedKVRuntime bridge) owns the refcount bump for them.
        """
        node, j = self._walk(hashes, split=True)
        dup = max(0, j - held_blocks)
        new = 0
        if j < len(hashes):
            leaf = RadixNode(list(hashes[j:]), node, last_access=now,
                             page_ids=list(page_ids[j:])
                             if page_ids is not None else None)
            node.children[hashes[j]] = leaf
            node = leaf
            new = leaf.n_blocks
        if node is self.root:
            return 0, 0, None
        self._lock(node)
        self.release(held)
        self._touch(node, now)
        self.stats.inserted_blocks += new
        self.stats.dup_blocks_freed += dup
        return new, dup, node

    def _unlink(self, n: RadixNode) -> int:
        """Detach a refcount-zero leaf, free its blocks through the shared
        pool and notify ``on_evict_node`` (while the node is still
        attached, so the callback can walk ``path_hashes``)."""
        if self.on_evict_node is not None:         # deref physical pages /
            self.on_evict_node(n)                  # mirror-index sync
        if self.blocks is not None:
            self.blocks.shared_free(n.n_blocks)
        del n.parent.children[n.edge[0]]
        n.parent = None
        return n.n_blocks

    def evict(self, need_blocks: int) -> int:
        """LRU-evict refcount-zero leaves until `need_blocks` are freed (or
        nothing evictable remains). Frees via the BlockManager shared pool.
        Locked paths — running requests and TTL pins — are untouchable."""
        if need_blocks <= 0:
            return 0
        heap: list[tuple[float, int, RadixNode]] = []
        seq = 0
        stack = [self.root]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            if n is not self.root and not n.children and n.refs == 0:
                heap.append((n.last_access, seq, n))
                seq += 1
        heapq.heapify(heap)
        freed = 0
        while heap and freed < need_blocks:
            _, _, n = heapq.heappop(heap)
            if n.refs != 0 or n.children:          # stale entry
                continue
            parent = n.parent
            freed += self._unlink(n)
            if parent is not self.root and not parent.children \
                    and parent.refs == 0:
                seq += 1
                heapq.heappush(heap, (parent.last_access, seq, parent))
        self.stats.evicted_blocks += freed
        return freed

    def evict_chain(self, hashes: tuple, keep_blocks: int = 0) -> int:
        """Evict the cached blocks of one specific hash chain beyond its
        first ``keep_blocks`` blocks — the cross-tree propagation hook: when
        the scheduler's *accounting* index LRU-evicts a path, the backend's
        page-stamped mirror drops the same chain so the two trees cannot
        drift (the drift shows up as ``shortfall_tokens`` defensive
        recomputes, or as mirror pages pinned long after accounting freed
        them). Best-effort and refcount-safe: nodes that still have
        holders, or children (another prompt diverges below them), are left
        alone — and blocks *off* the chain (an edge that diverges from or
        extends beyond it, i.e. a longer prompt this tree still caches) are
        never touched. Returns blocks freed."""
        # descend collecting only full-edge matches; a node whose edge
        # diverges from or runs past the chain's end stops the walk — its
        # blocks back a longer/other prompt this tree still caches, so
        # nothing at or below it is evictable here
        node, i = self.root, 0
        while i < len(hashes):
            child = node.children.get(hashes[i])
            if child is None:
                break
            lim = min(len(child.edge), len(hashes) - i)
            j = 0
            while j < lim and child.edge[j] == hashes[i + j]:
                j += 1
            if j < len(child.edge):
                break
            node, i = child, i + j
        freed = 0
        while node is not None and node.parent is not None:
            if node.refs != 0 or node.children:
                break
            start = node.depth_blocks() - node.n_blocks
            parent = node.parent
            if start >= keep_blocks:
                freed += self._unlink(node)        # whole node goes
                node = parent
            elif node.depth_blocks() > keep_blocks:
                # edge straddles the keep boundary: split (node becomes the
                # tail half under the new upper node) and evict the tail
                self._split(node, keep_blocks - start)
                freed += self._unlink(node)
                break
            else:
                break
        self.stats.evicted_blocks += freed
        return freed

    def path_page_ids(self, node: Optional[RadixNode]
                      ) -> Optional[list[int]]:
        """Physical HBM pages backing the root→`node` path, prefix order;
        None unless every edge on the path is page-stamped."""
        ids: list[int] = []
        while node is not None and node.parent is not None:
            if node.page_ids is None:
                return None
            ids = list(node.page_ids) + ids
            node = node.parent
        return ids

    # -------------------------------------------------------------- insight
    def n_nodes(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += 1
            stack.extend(node.children.values())
        return n - 1                                # exclude sentinel root

    def cached_blocks(self) -> int:
        n, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            n += node.n_blocks
            stack.extend(node.children.values())
        return n
