"""The port's roofline cost source (``CostModel.from_roofline``: the steps
of ``models/steps.py`` counted by ``dist/roofline.py``) against the
analytic profile, the reference's oracle for it here (its HLO analyzer
does not run on this host), as the reference's ``tests/test_dist_cost.py``
holds its own; and the port's prefill and decode steps against the
reference's."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JaxShape
from repro.configs.base import get_config as jax_config
from repro.launch.mesh import make_host_mesh
from repro.models import steps as jax_steps
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.ttl import TTLModel
from repro_torch.dist.roofline import Cost, count_step
from repro_torch.models import Model
from repro_torch.models.common import params_from_numpy
from repro_torch.models.steps import (build_decode_step, build_prefill_step,
                                      build_step, input_specs)
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.serving.profiler import (CostModel, HardwareProfile,
                                          build_profile,
                                          make_prefill_reload_fn)
from repro_torch.sim.runner import run_workload
from repro_torch.sim.workload import SWE_BENCH, generate_programs

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

ARCHS = ("qwen2-1.5b", "glm4-9b")


def _models(arch):
    cfg = get_config(arch, smoke=True)
    analytic = CostModel(build_profile(cfg))
    roofline = CostModel.from_roofline(cfg)
    return analytic, roofline


@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_agrees_with_analytic_within_2x(arch):
    """The reference's bound (measured at writing, roofline / analytic:
    qwen2 prefill 0.998, decode 1.064; glm4 0.919, 1.006)."""
    analytic, roof = _models(arch)
    for label, seconds in (
            ("prefill", lambda m: m.prefill_seconds(1024, 0)),
            ("decode", lambda m: m.decode_step_seconds(8, 512))):
        a, r = seconds(analytic), seconds(roof)
        assert a > 0 and r > 0
        assert 0.5 < r / a < 2.0, (arch, label, a, r)


def _req(prompt_len, generated=0):
    return types.SimpleNamespace(prompt_len=prompt_len, generated=generated)


@pytest.mark.parametrize("arch", ARCHS)
def test_ttl_ranking_stable_under_both_cost_sources(arch):
    """tau* ordering (big-context programs deserve longer pins) and the
    pin-vs-evict call must not flip when the cost source changes."""
    decisions = {}
    for name, cost in zip(("analytic", "roofline"), _models(arch)):
        coef = cost.fit_prefill_quadratic(32768)
        reload_fn = make_prefill_reload_fn(cost, coef)   # recompute-only
        ttl = TTLModel()
        # past the cold-start threshold with a bimodal tool profile
        for i in range(150):
            ttl.observe_tool("search", 1.0 if i % 2 else 8.0)
        ttl.observe_queueing_delay(2.0)
        small = ttl.solve("search", reload_fn(_req(256)))
        big = ttl.solve("search", reload_fn(_req(16384, generated=2048)))
        decisions[name] = (small, big)
        assert big.prefill_reload > small.prefill_reload
        assert big.ttl >= small.ttl

    a_small, a_big = decisions["analytic"]
    r_small, r_big = decisions["roofline"]
    # the pin/evict call (ttl > 0) agrees between cost sources
    assert (a_small.ttl > 0) == (r_small.ttl > 0)
    assert (a_big.ttl > 0) == (r_big.ttl > 0)
    # and the gain ranking is preserved
    assert (a_big.gain >= a_small.gain) == (r_big.gain >= r_small.gain)


def test_engine_runs_with_roofline_cost_source():
    """EngineConfig(cost_source="roofline"): counted seconds feed
    TTLModel.solve through the engine's PrefillReload closure, end to end
    under the virtual-clock sim, on full qwen2-1.5b (counted on the meta
    device: no weights are drawn)."""
    cfg = get_config("qwen2-1.5b")
    programs = generate_programs(SWE_BENCH, n=12, rate_jps=0.2, seed=0)
    eng = Engine(cfg, EngineConfig(policy="continuum", chips=4,
                                   kv_budget_bytes=10e9,
                                   cost_source="roofline"),
                 HardwareProfile())
    assert eng.cost.prof.flops_per_token > 0      # counted from the steps
    summary = run_workload(programs, [eng], max_seconds=1e6)
    assert summary.n_programs == 12
    assert eng.scheduler.stats.pins > 0           # TTL decisions were made


FAMILY_ARCHS = ["qwen2-1.5b", "glm4-9b", "qwen3-moe-235b-a22b", "gemma2-9b",
                "zamba2-2.7b", "rwkv6-3b", "pixtral-12b", "musicgen-large"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_count_equals_cpu_count(arch):
    """The counter on the meta device (shapes only) gives what it gives
    over the same steps run on the CPU, FLOPs and bytes exactly, for
    every family's prefill and decode step; the decode bytes hold the
    KV-cache read."""
    cfg = get_config(arch, smoke=True)
    for shape in (ShapeSpec("p", "prefill", 64, 1),
                  ShapeSpec("d", "decode", 128, 4)):
        meta = count_step(build_step(cfg, None, shape, device="meta"))
        cpu = count_step(build_step(cfg, None, shape, device="cpu"))
        assert meta == cpu and meta.flops > 0 and meta.bytes > 0, shape
    if cfg.family not in ("ssm", "hybrid"):
        kv_read = 4 * 128 * cfg.kv_bytes_per_token(4)     # fp32 smoke cache
        assert cpu.bytes > kv_read


def test_count_is_the_analyzers_byte_model():
    """A bare product: 2 M N K FLOPs and its operand and output bytes;
    an elementwise op adds neither."""
    a, b = torch.zeros(8, 16, device="meta"), torch.zeros(16, 4,
                                                          device="meta")
    step = types.SimpleNamespace(fn=lambda a, b: (a @ b).exp() + 1,
                                 make_inputs=lambda: (a, b))
    assert count_step(step) == Cost(2 * 8 * 16 * 4, 4 * (8 * 16 + 16 * 4 +
                                                         8 * 4))


def test_steps_match_the_references_steps():
    """The prefill and decode steps of qwen2-1.5b smoke in fp32, the
    port's from the reference's params: the same greedy tokens, caches
    within 1e-5; the step builders refuse the reference's JAX mesh (they
    take a torch ``DeviceMesh``)."""
    jcfg = dataclasses.replace(jax_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              compute_dtype="float32")
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    model = Model(cfg, params_from_numpy(jax.tree.map(np.asarray, params)),
                  device="cpu")
    B, S = 2, 24
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)) \
        .astype(np.int32)
    mesh = make_host_mesh()
    with mesh:
        jp = jax_steps.build_prefill_step(jcfg, mesh,
                                          JaxShape("p", "prefill", S, B))
        jd = jax_steps.build_decode_step(jcfg, mesh,
                                         JaxShape("d", "decode", S, B))
        jtok, jcache = jp.fn(params, JaxModel(jcfg).init_cache(B, S),
                             jnp.asarray(toks[:, :S - 1]))
        jnext, jcache = jd.fn(params, jcache, jtok[:, None],
                              jnp.full((B,), S - 1, jnp.int32))
    prefill = build_prefill_step(cfg, None, ShapeSpec("p", "prefill", S, B),
                                 model=model)
    decode = build_decode_step(cfg, None, ShapeSpec("d", "decode", S, B),
                               model=model)
    tok, cache = prefill.fn(model.init_cache(B, S),
                            torch.tensor(toks[:, :S - 1]))
    nxt, cache = decode.fn(cache, tok[:, None],
                           torch.full((B,), S - 1, dtype=torch.int32))
    assert np.array_equal(tok.numpy(), np.asarray(jtok))
    assert np.array_equal(nxt.numpy(), np.asarray(jnext))
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   rtol=1e-5, atol=1e-5)
    assert input_specs(cfg, ShapeSpec("d", "decode", S, B)) == {
        "tokens": ((B, 1), "int32"), "cache_len": ((B,), "int32")}
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_prefill_step(cfg, mesh, ShapeSpec("p", "prefill", S, B),
                           model=model)
