"""The backend cases of ``tests/test_mirror_sync.py`` on the port's
``TorchModelBackend`` (CPU): accounting-index radix evictions propagate
to the backend's page-stamped mirror.

The scheduler's accounting radix index and the physical backend's
page-stamped mirror are built from the same insert stream but evict
independently: accounting under block pressure, the mirror only under
physical page pressure. The engine wires ``on_evict_node`` of the
accounting index to ``TorchModelBackend.drop_prefix_chain``, so an
accounting eviction frees the same pages from the mirror. Same config,
page size, budget and request stream as the JAX package's cases."""
import torch

from repro_torch.configs import get_config
from repro_torch.core.ttl import TTLConfig
from repro_torch.core.types import Request
from repro_torch.serving.backend import TorchModelBackend
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.prefix import PrefixConfig
from repro_torch.serving.profiler import HardwareProfile

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)


def _build():
    cfg = get_config("qwen2-1.5b", smoke=True)
    backend = TorchModelBackend(cfg, seed=0, max_len=256, page_size=16,
                                device="cpu")
    ecfg = EngineConfig(max_batch=4, chunk_size=128, block_size=16,
                        kv_budget_bytes=96 * 16 *
                        backend.runtime.cfg.kv_bytes_per_token(2),
                        prefix=PrefixConfig(), ttl=TTLConfig(max_ttl=0.0))
    eng = Engine(cfg, ecfg, HardwareProfile(), backend=backend)
    return eng, backend


def _serve_one(eng) -> None:
    """One 96-token program of two output tokens, run to its end."""
    eng.submit(Request("prog", 0, 96, 2, 0.0, 0.0), 0.0)
    now = 0.0
    for _ in range(50):
        ev = eng.step(now)
        if ev.idle:
            break
        now += max(ev.duration, 1e-3)


def test_accounting_evict_frees_mirror_pages():
    eng, backend = _build()
    rt = backend.runtime
    free0 = len(rt.free)
    _serve_one(eng)
    # program finished without retention: its prompt chain is cached,
    # unreferenced, in BOTH trees (accounting + page-stamped mirror)
    acct_blocks = eng.prefix_index.cached_blocks()
    assert acct_blocks > 0
    assert backend.prefix_index.cached_blocks() >= acct_blocks
    held_pages = rt.n_pages - len(rt.free)
    assert held_pages >= acct_blocks    # mirror pins physical pages
    # accounting eviction (the admit/decode reclaim path)
    freed = eng.scheduler.prefix_reclaim(acct_blocks)
    assert freed == acct_blocks
    # ...must free the mirror's pages too, not wait for page pressure
    assert backend.prefix_index.cached_blocks() == 0
    assert len(rt.free) == free0        # every page back on the list
    rt.check(backend.prefix_index)


def test_drift_without_wiring():
    """The red half: severing the wiring reproduces the old drift —
    accounting evicts, the mirror keeps holding pages."""
    eng, backend = _build()
    eng.prefix_index.on_evict_node = None      # pre-fix behavior
    rt = backend.runtime
    free0 = len(rt.free)
    _serve_one(eng)
    acct_blocks = eng.prefix_index.cached_blocks()
    eng.scheduler.prefix_reclaim(acct_blocks)
    assert backend.prefix_index.cached_blocks() > 0   # the drift
    assert len(rt.free) < free0
