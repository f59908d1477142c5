"""The MoE, VLM and audio families on the port's paged serving path.

- qwen3-moe and pixtral smoke: the port's ``PagedKVRuntime`` against the
  JAX package's, op for op (ragged prefill, a padded prefill bucket,
  ragged decode batches): same page ids, refcounts and free lists, and
  logits within the fp32 bound of ``tests/test_torch_runtime.py`` (rtol
  2e-5 / atol 5e-4 on logits of magnitude ~4). These two families agree
  with their own ``Model.forward`` in the reference (ROADMAP R5).
- musicgen smoke: paged decode against the port's ``Model.forward`` (R3:
  the reference runtime omits the sinusoidal position of the decoded
  token; a test below records that).
- moonshot smoke: the runtime refuses leading dense layers (R4) before it
  allocates a pool.
- The differential replay on qwen3-moe smoke: the port's physical decision
  stream equals the JAX package's logical leg on seeds 0-2 and
  ``decode-heavy``, with every restore and COW split bit-exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.serving.paged_runtime import PagedKVRuntime as JaxRuntime
from repro.sim import replay as jax_replay
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.common import params_from_numpy
from repro_torch.serving.backend import TorchModelBackend
from repro_torch.serving.paged_runtime import PAGED_FAMILIES, PagedKVRuntime
from repro_torch.sim import replay

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

FP32 = dict(rtol=2e-5, atol=5e-4)


def close(a, b):
    np.testing.assert_allclose(np.asarray(b, np.float32),
                               np.asarray(a, np.float32), **FP32)


def _pair(arch: str):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               compute_dtype="float32")
    jp = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype="float32")
    tm = Model(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp)),
               device="cpu")
    return jcfg, jp, tcfg, tm


def same_state(rj, rt, pids):
    assert rj.refs == rt.refs
    assert rj.free == rt.free
    for pid in pids:
        assert rj.pages_of(pid) == rt.pages_of(pid), pid
        assert rj.programs[pid].length == rt.programs[pid].length


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "pixtral-12b"])
def test_paged_decode_matches_jax_runtime(arch):
    jcfg, jp, tcfg, tm = _pair(arch)
    rng = np.random.default_rng(0)
    toks = {p: rng.integers(0, jcfg.vocab_size, n)
            for p, n in (("A", 20), ("B", 13), ("C", 9))}
    rj = JaxRuntime(jcfg, n_pages=24, page_size=8)
    rt = PagedKVRuntime(tcfg, n_pages=24, page_size=8, device="cpu")
    for p in ("A", "B"):                        # prefill: ragged programs
        close(rj.prefill(jp, p, jnp.asarray(toks[p])),
              rt.prefill(tm, p, torch.from_numpy(toks[p])))
    # a padded bucket: 9 real tokens in a 16-token forward pass, the junk
    # routed with the rest (MoE capacity of the padded length)
    close(rj.prefill(jp, "C", jnp.asarray(toks["C"]), pad_to=16),
          rt.prefill(tm, "C", torch.from_numpy(toks["C"]), pad_to=16))
    same_state(rj, rt, ["A", "B", "C"])
    for pids in (["A", "B", "C"], ["B"], ["C", "A"]):    # ragged batches
        for a, b in zip(rj.decode_batch(jp, pids), rt.decode_batch(tm, pids)):
            close(a, b.float())
        same_state(rj, rt, ["A", "B", "C"])
    rj.check()
    rt.check()


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "pixtral-12b",
                                  "musicgen-large"])
def test_paged_decode_matches_model_forward(arch):
    """Paged decode against the contiguous-cache ``Model.forward`` of the
    port itself (fp32): for musicgen the decoded token's sinusoidal
    position is added on both paths (R3)."""
    _, _, tcfg, tm = _pair(arch)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, 24))
    cache = tm.init_cache(1, 40)
    logits, cache = tm.forward(toks[None], cache=cache, mode="prefill",
                               logits_slice=1)
    rt = PagedKVRuntime(tcfg, n_pages=16, page_size=8, device="cpu")
    close(rt.prefill(tm, "p", toks), logits[0, -1])
    tok, cl = logits[0, -1].argmax(), 24
    for _ in range(4):
        ref, cache = tm.forward(tok.reshape(1, 1), cache=cache,
                                cache_len=torch.full((1,), cl),
                                mode="decode")
        out = rt.decode(tm, "p")
        close(ref[0, -1], out)
        assert int(out.argmax()) == int(ref[0, -1].argmax())
        tok, cl = ref[0, -1].argmax(), cl + 1


def test_reference_runtime_omits_audio_positions():
    """R3, recorded: the reference runtime's musicgen decode differs from
    its own ``Model.forward`` (it never adds the decoded token's
    sinusoidal position), by far more than the fp32 bound, while the
    prefill agrees."""
    jcfg, jp, _, _ = _pair("musicgen-large")
    jm = JaxModel(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, 24)
    rj = JaxRuntime(jcfg, n_pages=16, page_size=8)
    first = np.asarray(rj.prefill(jp, "p", jnp.asarray(toks)))
    full, _ = jm.forward(jp, tokens=jnp.asarray(toks)[None],
                         cache=jm.init_cache(1, 40), mode="prefill")
    close(np.asarray(full)[0, -1], first)
    nxt = int(first.argmax())
    paged = np.asarray(rj.decode(jp, "p"))
    seq = np.concatenate([toks, [nxt]])
    ref, _ = jm.forward(jp, tokens=jnp.asarray(seq)[None],
                        cache=jm.init_cache(1, 40), mode="prefill")
    assert np.abs(np.asarray(ref)[0, -1] - paged).max() > 0.1


def test_first_k_dense_refused_before_any_pool(monkeypatch):
    """R4: moonshot's leading dense layer is refused with a ValueError
    that names R4, before a pool is allocated, by the runtime and by the
    engine backend that would build one."""
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    assert cfg.family in PAGED_FAMILIES

    def no_alloc(*_a, **_kw):
        raise AssertionError("a pool was allocated")
    monkeypatch.setattr(torch, "zeros", no_alloc)
    with pytest.raises(ValueError, match="R4"):
        PagedKVRuntime(cfg, device="cpu")
    with pytest.raises(ValueError, match="R4"):
        TorchModelBackend(cfg, device="cpu")


# ------------------------------------------------ differential replay
ARCH = "qwen3-moe-235b-a22b"
RUNS = [(0, "smoke"), (1, "smoke"), (2, "smoke"), (0, "decode-heavy")]


@pytest.fixture(scope="module")
def replays():
    """Each run's JAX logical log, the port's physical log and engine."""
    out = {}
    for seed, workload in RUNS:
        log_l, _ = jax_replay.run_engine(
            jax_replay.seeded_programs(
                seed, spec=jax_replay.WORKLOAD_SPECS[workload]),
            jax_replay.ReplayConfig(arch=ARCH), physical=False)
        log_p, eng = replay.run_engine(
            replay.seeded_programs(seed, spec=replay.WORKLOAD_SPECS[workload]),
            replay.ReplayConfig(arch=ARCH), device="cpu")
        out[seed, workload] = (log_l, log_p, eng)
    return out


@pytest.mark.parametrize("seed,workload", RUNS)
def test_moe_decision_stream_matches_logical_leg(replays, seed, workload):
    log_l, log_p, eng = replays[seed, workload]
    assert replay._first_divergence(log_l, log_p) is None
    assert len(log_l) == len(log_p) > 0
    backend = eng.backend.inner
    assert backend.cfg.family == "moe"
    assert backend.staging_checks
    assert all(ok for _, ok in backend.staging_checks)
    assert all(backend.runtime.copy_checks)
    st = eng.scheduler.stats
    assert st.demotions > 0 and st.offload_reloads > 0 and st.prefix_hits > 0
    assert all(p.finish_time >= 0 for p in eng.programs.values())
    backend.runtime.check(backend.prefix_index)
    if workload == "smoke":
        assert backend.shortfall_tokens == 0
        assert st.ttl_hits > 0


def test_moe_replays_split_shared_pages(replays):
    """The four runs exercise the COW split, each split bit-exact."""
    checks = [ok for *_, eng in replays.values()
              for ok in eng.backend.inner.runtime.copy_checks]
    assert checks and all(checks)
