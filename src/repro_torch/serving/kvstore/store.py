"""Block-granular tiered KV store: host DRAM + SSD residency below HBM.

One :class:`KVEntry` per program, holding a *prefix* of its KV context
as a run of blocks laid out ``[DRAM prefix][SSD suffix]`` — demotion
moves blocks from the DRAM tail to SSD, promotion moves the SSD head
back, so the resident run is always contiguous from token 0 (only a
contiguous prefix is adoptable by the next turn).

Lifecycle (the TTL demotion pipeline):

1. ``put`` — TTL expiry / preemption demotes HBM KV here. The write is
   an *async* D2H transfer on the :class:`~.transfer.TransferEngine`;
   it never blocks compute, but the entry is not reloadable before the
   write lands (``ready`` times). DRAM pressure first demotes LRU
   entries' DRAM blocks to SSD; entries that fit nowhere are dropped.
2. ``get``/``lookup`` — LRU-touched residency probe for admission.
3. ``reload_seconds`` — queue-aware ETA until the prefix is back in
   HBM: one H2D hop for the DRAM portion, serial SSD→DRAM→HBM for the
   SSD portion, both priced against in-flight transfer state.
4. ``begin_reload`` — commit the reload transfers and consume the
   entry (the KV now lives in HBM blocks owned by the new request).
5. ``demote``/``promote`` — explicit block-granular tier moves.
6. ``pin``/``unpin`` — protect an entry from demotion/eviction (e.g.
   while a reload decision is pending).

Invariant (``check()``, mirroring ``BlockManager.check``): per-tier
``used`` block counters equal the sum over resident entries, never
negative, never above capacity.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Optional

from repro_torch.serving.kvstore.transfer import TransferEngine, resolve_bandwidth


@dataclasses.dataclass
class KVStoreConfig:
    dram_bytes: float = 100e9          # paper: 100 GB (A100) / 200 GB (H100)
    ssd_bytes: float = 0.0             # 0 = tier disabled
    h2d_bw: float = 25e9               # DRAM -> HBM, bytes/s
    d2h_bw: float = 25e9               # HBM -> DRAM (demotion writes)
    ssd_read_bw: float = 3e9           # SSD -> DRAM
    ssd_write_bw: float = 1.5e9        # DRAM -> SSD
    link_latency_s: float = 0.0        # fixed per-transfer latency
    block_bytes: float = 1.0           # bytes per accounting block
    enabled: bool = True
    # measured (message_size, bandwidth) calibration points per channel
    # (BandwidthCurve.from_points); None = constant *_bw above
    h2d_curve: Optional[tuple] = None
    d2h_curve: Optional[tuple] = None
    ssd_read_curve: Optional[tuple] = None
    ssd_write_curve: Optional[tuple] = None

    @property
    def dram_blocks(self) -> int:
        return int(self.dram_bytes / self.block_bytes)

    @property
    def ssd_blocks(self) -> int:
        return int(self.ssd_bytes / self.block_bytes)


@dataclasses.dataclass
class Span:
    """A run of blocks resident in one tier (with its write-completion
    time: the data is reloadable only once the inbound copy landed)."""
    tier: str                          # "dram" | "ssd"
    blocks: int
    ready_at: float = 0.0


@dataclasses.dataclass
class StoreStats:
    puts: int = 0
    drops: int = 0                     # entries evicted outright
    dropped_blocks: int = 0
    demotions: int = 0                 # DRAM -> SSD moves
    demoted_blocks: int = 0
    promoted_blocks: int = 0           # SSD -> DRAM moves
    reloads: int = 0                   # begin_reload commits
    reload_seconds: float = 0.0
    lookup_hits: int = 0
    lookup_misses: int = 0


class KVEntry:
    """One program's offloaded KV prefix: ``[DRAM prefix][SSD suffix]``."""

    __slots__ = ("program_id", "tokens_total", "nbytes_total", "blocks_total",
                 "dram_blocks", "ssd_blocks", "dram_ready", "ssd_ready",
                 "pinned")

    def __init__(self, program_id: str, tokens: int, nbytes: float,
                 blocks: int):
        self.program_id = program_id
        self.tokens_total = tokens
        self.nbytes_total = nbytes
        self.blocks_total = max(blocks, 1)
        self.dram_blocks = 0
        self.ssd_blocks = 0
        self.dram_ready = 0.0
        self.ssd_ready = 0.0
        self.pinned = False

    # ------------------------------------------------------------ derived
    @property
    def blocks(self) -> int:
        return self.dram_blocks + self.ssd_blocks

    @property
    def tokens(self) -> int:
        """Usable prefix tokens (shrinks if suffix blocks were dropped)."""
        return self.tokens_total * self.blocks // self.blocks_total

    @property
    def nbytes(self) -> float:
        return self.nbytes_total * self.blocks / self.blocks_total

    @property
    def dram_bytes(self) -> float:
        return self.nbytes_total * self.dram_blocks / self.blocks_total

    @property
    def ssd_bytes(self) -> float:
        return self.nbytes_total * self.ssd_blocks / self.blocks_total

    @property
    def tier(self) -> str:
        if self.ssd_blocks == 0:
            return "dram"
        return "ssd" if self.dram_blocks == 0 else "mixed"


class TieredKVStore:
    """Capacity-tracked DRAM+SSD store keyed by program_id, block
    accounting, LRU across entries, transfers priced by the
    :class:`TransferEngine`."""

    def __init__(self, cfg: KVStoreConfig,
                 transfer: Optional[TransferEngine] = None):
        self.cfg = cfg
        self.transfer = transfer or TransferEngine(
            resolve_bandwidth(cfg.h2d_curve, cfg.h2d_bw),
            resolve_bandwidth(cfg.d2h_curve, cfg.d2h_bw),
            resolve_bandwidth(cfg.ssd_read_curve, cfg.ssd_read_bw),
            resolve_bandwidth(cfg.ssd_write_curve, cfg.ssd_write_bw),
            cfg.link_latency_s)
        self.entries: "OrderedDict[str, KVEntry]" = OrderedDict()
        self.dram_used_blocks = 0
        self.ssd_used_blocks = 0
        self.stats = StoreStats()
        # called with the program_id of every *genuinely evicted* entry
        # (pressure victims included) — execution backends use it to free
        # the host copy they kept for the demotion; reload consumption
        # and same-program replacement do NOT fire it
        self.on_drop = None  # type: Optional[callable]
        # telemetry: tier moves (put/demote/promote/drop) emit instants
        # on the replica lane; obs_clock timestamps paths with no `now`
        self.obs = None
        self.obs_replica = ""
        self.obs_clock = None  # type: Optional[callable]

    # -------------------------------------------------------------- sizing
    def _blocks_for(self, nbytes: float) -> int:
        return max(int(math.ceil(nbytes / self.cfg.block_bytes)), 1) \
            if nbytes > 0 else 0

    @property
    def dram_used(self) -> float:
        return sum(e.dram_bytes for e in self.entries.values())

    @property
    def ssd_used(self) -> float:
        return sum(e.ssd_bytes for e in self.entries.values())

    def dram_free_blocks(self) -> int:
        return self.cfg.dram_blocks - self.dram_used_blocks

    def ssd_free_blocks(self) -> int:
        return self.cfg.ssd_blocks - self.ssd_used_blocks

    # ----------------------------------------------------------------- put
    def put(self, program_id: str, tokens: int, nbytes: float,
            now: float = 0.0, from_hbm: bool = True,
            ready_at: float = 0.0) -> Optional[KVEntry]:
        """Admit a program's KV prefix (TTL-expiry/preemption demotion).
        Async write: the entry exists immediately but is reloadable only
        after the D2H copy completes. Returns the entry, or None if it
        fit in no tier (dropped).

        ``ready_at`` is when the source bytes exist in host DRAM for a
        non-HBM put (a cross-replica migration still on the wire): the
        DRAM entry is reloadable no earlier, and an SSD spill write
        cannot occupy its channel before then."""
        if not self.cfg.enabled or nbytes <= 0:
            return None
        self._remove(program_id)       # replacement, not an eviction
        blocks = self._blocks_for(nbytes)
        while self.dram_free_blocks() < blocks and self._demote_lru(now):
            pass
        entry = KVEntry(program_id, tokens, nbytes, blocks)
        if self.dram_free_blocks() >= blocks:
            entry.dram_blocks = blocks
            self.dram_used_blocks += blocks
            entry.dram_ready = self.transfer.write_dram(nbytes, now).end \
                if from_hbm else ready_at
            self.entries[program_id] = entry
            self.stats.puts += 1
            self._obs_tier("tier_put", program_id, now,
                           {"tier": "dram", "blocks": blocks,
                            "ready": round(entry.dram_ready, 9)})
            return entry
        if self.cfg.ssd_blocks and self.ssd_free_blocks() >= blocks:
            entry.ssd_blocks = blocks
            self.ssd_used_blocks += blocks
            staged = self.transfer.write_dram(nbytes, now).end if from_hbm \
                else max(now, ready_at)
            entry.ssd_ready = self.transfer.write_ssd(nbytes, now,
                                                      earliest=staged).end
            self.entries[program_id] = entry
            self.stats.puts += 1
            self._obs_tier("tier_put", program_id, now,
                           {"tier": "ssd", "blocks": blocks,
                            "ready": round(entry.ssd_ready, 9)})
            return entry
        self.stats.drops += 1
        self.stats.dropped_blocks += blocks
        self._obs_tier("tier_full_drop", program_id, now,
                       {"blocks": blocks})
        return None

    def _obs_tier(self, name: str, program_id: str, now: Optional[float],
                  args: dict) -> None:
        if self.obs is not None:
            if now is None:
                now = self.obs_clock() if self.obs_clock is not None else 0.0
            self.obs.tier_event(self.obs_replica, name, program_id, now,
                                args)

    # ------------------------------------------------------------ demotion
    def _demote_lru(self, now: float = 0.0) -> bool:
        """DRAM pressure: move the LRU unpinned entry's DRAM blocks to
        SSD. When SSD can't take the whole run, the entry sheds its own
        *suffix* blocks (SSD tail first, then DRAM tail) until the
        surviving contiguous prefix fits — a shrunk entry still covers
        the next turn's leading tokens, which beats dropping it outright
        (only if nothing survives is the entry dropped). True if any
        DRAM blocks were freed."""
        for pid, e in self.entries.items():
            if e.dram_blocks == 0 or e.pinned:
                continue
            n = e.dram_blocks
            free = self.ssd_free_blocks() if self.cfg.ssd_blocks else 0
            if free < n and e.ssd_blocks:
                # shed the entry's SSD tail: the DRAM run is the prefix
                # head, the most adoptable part of the entry
                k = min(n - free, e.ssd_blocks)
                self._drop_suffix_blocks(e, ssd=k)
                free += k
            if free < n:
                # still short: shed the DRAM tail too; keep the longest
                # prefix SSD can hold
                self._drop_suffix_blocks(e, dram=n - free)
                n = free
            if n <= 0:
                self.drop(pid)          # nothing survived
            else:
                self._move_to_ssd(e, n, now)
            return True
        return False

    def _drop_suffix_blocks(self, e: KVEntry, dram: int = 0,
                            ssd: int = 0) -> None:
        """Shrink an entry from its tail (partial drop: ``e.tokens`` — the
        usable contiguous prefix — shrinks proportionally)."""
        e.dram_blocks -= dram
        e.ssd_blocks -= ssd
        self.dram_used_blocks -= dram
        self.ssd_used_blocks -= ssd
        self.stats.dropped_blocks += dram + ssd

    def _move_to_ssd(self, e: KVEntry, n: int, now: float) -> None:
        nbytes = e.nbytes_total * n / e.blocks_total
        e.dram_blocks -= n
        e.ssd_blocks += n
        self.dram_used_blocks -= n
        self.ssd_used_blocks += n
        # the SSD write can't start before the data is DRAM-resident
        t = self.transfer.write_ssd(nbytes, now, earliest=e.dram_ready)
        e.ssd_ready = max(e.ssd_ready, t.end)
        self.stats.demotions += 1
        self.stats.demoted_blocks += n
        self._obs_tier("tier_demote", e.program_id, now,
                       {"blocks": n, "from": "dram", "to": "ssd"})

    def demote(self, program_id: str, blocks: Optional[int] = None,
               now: float = 0.0) -> int:
        """Block-granular DRAM→SSD demotion of `program_id`'s DRAM tail.
        Moves up to `blocks` (default: all); returns blocks moved."""
        e = self.entries.get(program_id)
        if e is None or e.dram_blocks == 0:
            return 0
        want = e.dram_blocks if blocks is None else min(blocks, e.dram_blocks)
        n = min(want, self.ssd_free_blocks()) if self.cfg.ssd_blocks else 0
        if n > 0:
            self._move_to_ssd(e, n, now)
        return n

    def promote(self, program_id: str, blocks: Optional[int] = None,
                now: float = 0.0) -> int:
        """SSD→DRAM promotion of the entry's SSD head blocks (prefetch
        ahead of an expected reload); returns blocks moved."""
        e = self.entries.get(program_id)
        if e is None or e.ssd_blocks == 0:
            return 0
        want = e.ssd_blocks if blocks is None else min(blocks, e.ssd_blocks)
        n = min(want, self.dram_free_blocks())
        if n <= 0:
            return 0
        nbytes = e.nbytes_total * n / e.blocks_total
        e.ssd_blocks -= n
        e.dram_blocks += n
        self.ssd_used_blocks -= n
        self.dram_used_blocks += n
        t = self.transfer.read_ssd(nbytes, now, earliest=e.ssd_ready)
        e.dram_ready = max(e.dram_ready, t.end)
        self.stats.promoted_blocks += n
        self._obs_tier("tier_promote", program_id, now,
                       {"blocks": n, "from": "ssd", "to": "dram"})
        return n

    # ------------------------------------------------------------- lookups
    def get(self, program_id: str, now: float = 0.0) -> Optional[KVEntry]:
        """LRU-touched residency probe."""
        e = self.entries.get(program_id)
        if e is not None:
            self.entries.move_to_end(program_id)
            self.stats.lookup_hits += 1
        else:
            self.stats.lookup_misses += 1
        return e

    lookup = get

    def pin(self, program_id: str) -> bool:
        e = self.entries.get(program_id)
        if e is None:
            return False
        e.pinned = True
        return True

    def unpin(self, program_id: str) -> None:
        e = self.entries.get(program_id)
        if e is not None:
            e.pinned = False

    # -------------------------------------------------------------- reload
    def reload_seconds(self, program_id: str,
                       now: float = 0.0) -> Optional[float]:
        """Queue-aware ETA until the entry's prefix is HBM-resident;
        None if absent. LRU-touches the entry (a reload probe is a use,
        exactly like ``lookup``)."""
        e = self.entries.get(program_id)
        if e is None:
            return None
        self.entries.move_to_end(program_id)
        return self.transfer.reload_eta(
            e.dram_bytes, e.ssd_bytes, now,
            dram_ready=e.dram_ready, ssd_ready=e.ssd_ready)

    def begin_reload(self, program_id: str,
                     now: float = 0.0) -> Optional[float]:
        """Commit the reload transfers and consume the entry (its KV now
        lives in HBM blocks owned by the admitting request). Returns the
        reload seconds, or None if absent."""
        e = self.entries.get(program_id)
        if e is None:
            return None
        secs = self.transfer.reload_eta(
            e.dram_bytes, e.ssd_bytes, now,
            dram_ready=e.dram_ready, ssd_ready=e.ssd_ready, commit=True)
        self.stats.reloads += 1
        self.stats.reload_seconds += secs
        self._remove(program_id)
        return secs

    # ------------------------------------------------------- cluster moves
    def extract(self, program_id: str) -> Optional[KVEntry]:
        """Remove and return ``program_id``'s entry because its KV is
        *departing* this replica on a peer link — neither an eviction
        (``on_drop`` does not fire; the host copy travels with it) nor a
        reload (no channel time is charged here: the cluster layer prices
        the SSD read-up / interconnect hops explicitly)."""
        return self._remove(program_id)

    def admit_migrated(self, program_id: str, tokens: int, nbytes: float,
                       now: float, ready_at: float) -> Optional[KVEntry]:
        """Land a cross-replica migration in this replica's tiers: a
        ``put`` that arrives over the interconnect (never from this
        replica's HBM) and is reloadable only once the inbound transfer
        lands (``ready_at``, the peer-link arrival time — an SSD spill
        write also queues no earlier than that). Returns the entry, or
        None if no tier could take it (the caller must capacity-check
        first — a dropped migration is lost KV)."""
        return self.put(program_id, tokens, nbytes, now=now,
                        from_hbm=False, ready_at=ready_at)

    # ---------------------------------------------------------------- drop
    def _remove(self, program_id: str) -> Optional[KVEntry]:
        e = self.entries.pop(program_id, None)
        if e is not None:
            self.dram_used_blocks -= e.dram_blocks
            self.ssd_used_blocks -= e.ssd_blocks
        return e

    def drop(self, program_id: str) -> None:
        e = self._remove(program_id)
        if e is not None:
            self.stats.drops += 1
            self.stats.dropped_blocks += e.blocks
            self._obs_tier("tier_drop", program_id, None,
                           {"blocks": e.blocks})
            if self.on_drop is not None:
                self.on_drop(program_id)

    # ------------------------------------------------------------- insight
    def usage(self) -> dict:
        return {
            "dram": {"used_blocks": self.dram_used_blocks,
                     "capacity_blocks": self.cfg.dram_blocks,
                     "used_bytes": self.dram_used},
            "ssd": {"used_blocks": self.ssd_used_blocks,
                    "capacity_blocks": self.cfg.ssd_blocks,
                    "used_bytes": self.ssd_used},
            "entries": len(self.entries),
            "transfer": self.transfer.usage(),
        }

    def check(self) -> None:
        """Assert the cross-tier invariant (tests / debugging): per-tier
        used equals the sum over resident entries; nothing negative;
        nothing above capacity."""
        dram = sum(e.dram_blocks for e in self.entries.values())
        ssd = sum(e.ssd_blocks for e in self.entries.values())
        assert dram == self.dram_used_blocks, (dram, self.dram_used_blocks)
        assert ssd == self.ssd_used_blocks, (ssd, self.ssd_used_blocks)
        assert 0 <= self.dram_used_blocks <= self.cfg.dram_blocks, \
            (self.dram_used_blocks, self.cfg.dram_blocks)
        assert 0 <= self.ssd_used_blocks <= self.cfg.ssd_blocks, \
            (self.ssd_used_blocks, self.cfg.ssd_blocks)
        for e in self.entries.values():
            assert e.dram_blocks >= 0 and e.ssd_blocks >= 0, e.program_id
            assert e.blocks <= e.blocks_total, e.program_id
