"""The torch leg of the differential replay against the JAX package's
logical leg: the same seeded trace through the port's physical stack
(``TorchModelBackend`` + ``PagedKVRuntime``, CPU, shadow clock) and
through ``repro.sim.replay.run_engine(physical=False)`` must make the
identical scheduling decisions step by step, with every restore and COW
split bit-exact. Both legs run in one interpreter: block hashing uses
Python's ``hash``.

``shortfall_tokens`` (defensive recomputes after a truncated restore) is
a property of the trace and the control plane: 0 on the smoke seeds, and
on the decode-heavy trace the 23 tokens the JAX package's physical leg
records in ``experiments/replay/verdict_seed0_decode-heavy.json``.
"""
import json
import pathlib
import random

import pytest
import torch

from repro.core import types as jax_types
from repro.sim import replay as jax_replay
from repro_torch.core import types
from repro_torch.sim import replay

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

VERDICTS = pathlib.Path(__file__).resolve().parents[1] / "experiments" / \
    "replay"


@pytest.mark.parametrize("seed,workload", [(0, "smoke"), (1, "smoke"),
                                           (2, "smoke"), (0, "decode-heavy")])
def test_decision_stream_matches_logical_leg(seed, workload):
    log_l, eng_l = jax_replay.run_engine(
        jax_replay.seeded_programs(seed,
                                   spec=jax_replay.WORKLOAD_SPECS[workload]),
        jax_replay.ReplayConfig(), physical=False)
    log_p, eng_p = replay.run_engine(
        replay.seeded_programs(seed, spec=replay.WORKLOAD_SPECS[workload]),
        replay.ReplayConfig(), device="cpu")
    assert replay._first_divergence(log_l, log_p) is None
    assert len(log_l) == len(log_p) > 0

    backend = eng_p.backend.inner
    staging_failures = sum(not ok for _, ok in backend.staging_checks)
    cow_failures = sum(not ok for ok in backend.runtime.copy_checks)
    assert staging_failures == 0 and cow_failures == 0
    assert backend.staging_checks and backend.runtime.copy_checks
    st = eng_p.scheduler.stats
    assert st.demotions > 0 and st.offload_reloads > 0
    assert st.prefix_hits > 0 and backend.runtime.cow_splits > 0
    assert all(p.finish_time >= 0 for p in eng_p.programs.values())
    backend.runtime.check(backend.prefix_index)

    tag = "" if workload == "smoke" else f"_{workload}"
    verdict = json.loads(
        (VERDICTS / f"verdict_seed{seed}{tag}.json").read_text())["stats"]
    assert backend.shortfall_tokens == verdict["shortfall_tokens"]
    assert backend.restores == verdict["restores"]
    assert backend.runtime.cow_splits == verdict["cow_splits"]
    assert backend.demotions == verdict["demotions_physical"]
    if workload == "smoke":
        assert backend.shortfall_tokens == 0
        assert st.ttl_hits > 0


def random_programs(rng: random.Random, mod, max_len: int = 448):
    """The workload of ``tests/test_backend_staging.py``, built from the
    ``Program``/``Turn`` types of ``mod`` (either package)."""
    n = rng.randint(4, 6)
    groups = [f"tmpl-{g}" for g in range(2)]
    programs, t = [], 0.0
    for i in range(n):
        t += rng.uniform(0.05, 1.2)
        shared = rng.choice([0, 48, 96])
        budget = max_len - 32
        turns, ctx = [], 0
        n_turns = rng.randint(2, 4)
        for k in range(n_turns):
            last = k == n_turns - 1
            new = rng.randint(24, 120) + (shared if k == 0 else 0)
            out = rng.randint(2, 5)
            if ctx + new + out > budget:
                new = max(1, budget - ctx - out)
            ctx += new + out
            turns.append(mod.Turn(
                new_tokens=new, output_tokens=out,
                tool=None if last else rng.choice(["ls", "pytest", "web"]),
                tool_duration=0.0 if last else rng.uniform(0.05, 1.5)))
            if ctx >= budget:
                turns[-1].tool = None
                break
        turns[-1].tool = None
        programs.append(mod.Program(
            f"fuzz-{i}", t, turns, shared_prefix_tokens=shared,
            shared_prefix_id=rng.choice(groups) if shared else None))
    return programs


TIGHT = dict(total_blocks=64, dram_blocks=24, ssd_blocks=10)


def _physical_leg_with_invariants(programs):
    """The port's physical leg on a tight pool, checking after every
    engine step that block ownership, tier accounting and page refcounts
    hold and that no host copy outlives its tier entry."""
    checked = {"steps": 0}

    def invariants(eng, ev, now):
        checked["steps"] += 1
        eng.blocks.check()
        eng.kvstore.check()
        backend = eng.backend.inner
        backend.runtime.check(backend.prefix_index)
        assert set(backend.host_caches) <= set(eng.kvstore.entries)

    log, eng = replay.run_engine(programs, replay.ReplayConfig(**TIGHT),
                                 device="cpu", on_step=invariants)
    assert checked["steps"] > 0
    assert not eng.running and not eng.scheduler.waiting
    backend = eng.backend.inner
    assert all(ok for _, ok in backend.staging_checks)
    assert all(backend.runtime.copy_checks)
    return log, eng


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_staging_fuzz_matches_logical_leg(seed):
    """``tests/test_backend_staging.py`` on the port: random agent
    programs on a tight pool (pressure demotion through
    ``TorchModelBackend``), with per-step invariants, and the decision
    stream still equal to the JAX package's logical leg."""
    log_l, _ = jax_replay.run_engine(
        random_programs(random.Random(seed), jax_types),
        jax_replay.ReplayConfig(**TIGHT), physical=False)
    log_p, eng = _physical_leg_with_invariants(
        random_programs(random.Random(seed), types))
    assert replay._first_divergence(log_l, log_p) is None
    assert eng.scheduler.stats.demotions > 0
    assert eng.backend.inner.demotions > 0


def test_preemption_matches_logical_leg():
    """Eight decode-heavy programs at 6/s on the tight pool: decode growth
    preempts running programs, whose pages the backend stages out (or
    drops) mid-turn; per-step invariants hold and the decisions equal the
    JAX package's logical leg."""
    kw = dict(n=8, rate_jps=6.0)
    log_l, _ = jax_replay.run_engine(
        jax_replay.seeded_programs(0, spec=jax_replay.SMOKE_DECODE_SPEC,
                                   **kw),
        jax_replay.ReplayConfig(**TIGHT), physical=False)
    log_p, eng = _physical_leg_with_invariants(
        replay.seeded_programs(0, spec=replay.SMOKE_DECODE_SPEC, **kw))
    assert replay._first_divergence(log_l, log_p) is None
    assert eng.scheduler.stats.preemptions > 0
