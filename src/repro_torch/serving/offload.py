"""Host-DRAM / SSD KV offload — compatibility shim over the tiered store.

Historically this module *was* the offload tier: a capacity-tracked
two-tier accounting model keyed by whole programs. The real
implementation now lives in :mod:`repro_torch.serving.kvstore`
(:class:`TieredKVStore` + :class:`TransferEngine`): block-granular
residency, async demotion writes, and queue-aware reload pricing.
:class:`OffloadManager` survives as a thin shim that preserves the old
call surface (``offload``/``lookup``/``reload_seconds``/``drop``/
``_demote_lru``, byte-valued ``dram_used``/``ssd_used``) while
delegating everything to the store — existing schedulers, benchmarks
and tests keep working, and gain the corrected physics:

- an SSD entry reloads in two *serial* hops (SSD→DRAM at ``ssd_bw``,
  then DRAM→HBM at ``h2d_bw``), not one hop at ``min(ssd_bw, h2d_bw)``;
- ``reload_seconds`` LRU-touches the entry like ``lookup`` does;
- reloads queue behind in-flight transfers (pass ``now``; omitting it
  prices against whatever is already on the channels at t=0).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.serving.kvstore import KVEntry, KVStoreConfig, TieredKVStore


@dataclasses.dataclass
class OffloadConfig:
    dram_bytes: float = 100e9            # paper: 100 GB (A100) / 200 GB (H100/B200)
    ssd_bytes: float = 0.0               # 0 = disabled
    h2d_bw: float = 25e9                 # host->device link, bytes/s
    ssd_bw: float = 3e9                  # SSD read, bytes/s
    enabled: bool = True
    d2h_bw: float = 0.0                  # 0 = symmetric with h2d_bw
    ssd_write_bw: float = 0.0            # 0 = half of ssd_bw
    link_latency_s: float = 0.0
    block_bytes: float = 1.0             # store accounting granularity
    # measured (message_size, bw) calibration points per channel — turned
    # into message-size-dependent BandwidthCurves (constant when None)
    h2d_curve: Optional[tuple] = None
    d2h_curve: Optional[tuple] = None
    ssd_read_curve: Optional[tuple] = None
    ssd_write_curve: Optional[tuple] = None

    def store_config(self) -> KVStoreConfig:
        return KVStoreConfig(
            dram_bytes=self.dram_bytes, ssd_bytes=self.ssd_bytes,
            h2d_bw=self.h2d_bw, d2h_bw=self.d2h_bw or self.h2d_bw,
            ssd_read_bw=self.ssd_bw,
            ssd_write_bw=self.ssd_write_bw or self.ssd_bw / 2,
            link_latency_s=self.link_latency_s,
            block_bytes=self.block_bytes, enabled=self.enabled,
            h2d_curve=self.h2d_curve, d2h_curve=self.d2h_curve,
            ssd_read_curve=self.ssd_read_curve,
            ssd_write_curve=self.ssd_write_curve)


class OffloadManager:
    """Legacy facade: capacity-tracked tier store keyed by program_id."""

    def __init__(self, cfg: OffloadConfig):
        self.cfg = cfg
        self.store = TieredKVStore(cfg.store_config())

    # ------------------------------------------------------ legacy surface
    @property
    def entries(self):
        return self.store.entries

    @property
    def dram_used(self) -> float:
        return self.store.dram_used

    @property
    def ssd_used(self) -> float:
        return self.store.ssd_used

    def offload(self, program_id: str, tokens: int, nbytes: float,
                now: float = 0.0) -> Optional[KVEntry]:
        """Admit into the tier store; returns the entry, or None if it
        was dropped (fit nowhere) — i.e. whether demotion succeeded."""
        return self.store.put(program_id, tokens, nbytes, now=now)

    def _demote_lru(self, now: float = 0.0) -> bool:
        """Move the least-recently-used DRAM entry to SSD (or drop it)."""
        return self.store._demote_lru(now)

    def lookup(self, program_id: str, now: float = 0.0) -> Optional[KVEntry]:
        return self.store.get(program_id, now)

    def reload_seconds(self, program_id: str,
                       now: float = 0.0) -> Optional[float]:
        """Time to bring the program's KV back to HBM; None if absent.
        Two serial hops for the SSD portion, queue- and readiness-aware."""
        return self.store.reload_seconds(program_id, now)

    def begin_reload(self, program_id: str,
                     now: float = 0.0) -> Optional[float]:
        """Commit the reload transfers and consume the entry."""
        return self.store.begin_reload(program_id, now)

    def drop(self, program_id: str) -> None:
        self.store.drop(program_id)
