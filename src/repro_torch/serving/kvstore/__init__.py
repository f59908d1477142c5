"""Tiered physical KV store: HBM pages + host DRAM + SSD behind one
block-granular API.

- :mod:`repro_torch.serving.kvstore.transfer` — event-timeline model of the
  copy channels (H2D/D2H/SSD read/write): per-direction queues,
  bandwidth + latency, overlap with compute. Reload seconds come from
  in-flight transfer state, not a static ``nbytes / bw`` formula.
- :mod:`repro_torch.serving.kvstore.store` — :class:`TieredKVStore`, the
  block-granular DRAM/SSD residency tracker with async TTL demotion
  (HBM→DRAM on expiry, DRAM→SSD under pressure, suffix trimming when
  full) and queue-aware reload pricing.

HBM itself stays owned by :class:`~repro_torch.serving.blocks.BlockManager`
(accounting) and :class:`~repro_torch.serving.paged_runtime.PagedKVRuntime`
(physical pages, COW prefix sharing); the store owns everything below
the HBM line and the transfers across it.
"""
from repro_torch.serving.kvstore.store import (KVEntry, KVStoreConfig, Span,
                                         StoreStats, TieredKVStore)
from repro_torch.serving.kvstore.transfer import (BandwidthCurve, Channel, Transfer,
                                            TransferEngine, resolve_bandwidth)

__all__ = [
    "BandwidthCurve", "Channel", "KVEntry", "KVStoreConfig", "Span",
    "StoreStats", "TieredKVStore", "Transfer", "TransferEngine",
    "resolve_bandwidth",
]
