"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's ``repro.models.moe`` on the same numpy inputs, on qwen3-moe smoke
(8 experts, top 2) and moonshot smoke (8 experts, top 2, 2 shared experts).

Tolerances: the dispatch plan and the capacity are integers and must be
equal. ``moe_apply`` is held to the reference jitted, as its model runs it
(XLA then keeps the weighted rows in fp32 for the sum over k): in bf16 the
two agree to one bf16 ulp (rtol 2^-7), with at least 99.9% of the outputs
equal bit for bit (the shared experts' add rounds differently where XLA
fuses it); in fp32 they differ only in matmul summation order, atol 1e-5
on outputs of magnitude ~3. Drops are asserted, not assumed: the inputs
share a common direction, so the router sends most tokens to a few
experts and the capacity cuts them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as jax_moe
from repro.models.common import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.models.common import params_from_numpy

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

ARCHS = ["qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b"]
FP32_ATOL = 1e-5


def assert_bf16_close(yt: np.ndarray, yj: np.ndarray) -> None:
    np.testing.assert_allclose(yt, yj, rtol=2.0 ** -7, atol=0)
    assert (yt == yj).mean() >= 0.999


def _cfgs(arch: str, dtype: str):
    return (dataclasses.replace(jax_config(arch, smoke=True),
                                compute_dtype=dtype),
            dataclasses.replace(get_config(arch, smoke=True),
                                compute_dtype=dtype))


def _nested(flat: dict) -> dict:
    out: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return out


def _layer_params(jcfg, dtype: str, seed: int = 1):
    """One MoE layer's params as the JAX model holds them after its cast
    (the router too, ROADMAP R6), on both sides."""
    jp = jax_init_params(jax_moe.moe_specs(jcfg, "float32"),
                         jax.random.PRNGKey(seed))
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    tp = _nested(params_from_numpy(jax.tree.map(np.asarray, jp)))
    return jp, tp


def _skewed_tokens(T: int, D: int, seed: int) -> np.ndarray:
    """(1, T, D) rows that share one direction: most copies go to the
    experts that direction prefers."""
    rng = np.random.default_rng(seed)
    common = 2.0 * rng.standard_normal(D)
    return (rng.standard_normal((1, T, D)) + common).astype(np.float32)


def _both(arch: str, dtype: str, x: np.ndarray):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp, tp = _layer_params(jcfg, dtype)
    yj = jax.jit(lambda p, v: jax_moe.moe_apply(p, v, jcfg))(
        jp, jnp.asarray(x).astype(dtype))
    yt = moe.moe_apply(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                       tcfg)
    assert yt.dtype == getattr(torch, dtype) and yt.shape == x.shape
    drops = _drops(tp, torch.from_numpy(x).to(getattr(torch, dtype)), tcfg)
    return np.asarray(yj.astype(jnp.float32)), yt.float().numpy(), drops


def _drops(tp, x: torch.Tensor, cfg) -> int:
    """Copies the capacity drops when ``x`` is dispatched as one group."""
    T = x.shape[0] * x.shape[1]
    _, ids = moe.route(tp, x.reshape(T, -1), cfg)
    E = cfg.moe.num_experts
    C = moe._capacity(T, cfg)
    return int((moe._dispatch_plan(ids.reshape(-1), E, C)[1] == E * C).sum())


# ------------------------------------------------------------- the plan
@pytest.mark.parametrize("E,C,N,skew", [
    (8, 8, 16, None), (8, 8, 64, None), (8, 24, 128, None),
    (128, 40, 4096, None), (8, 8, 40, "one"), (8, 16, 32, "two"),
    (4, 8, 1, None)])
def test_dispatch_plan_equals_jax(E, C, N, skew):
    """``src``/``dest`` integer-equal to the reference's on the same ids,
    uniform, overfull (drops) and all-to-one-expert."""
    ids = np.random.default_rng(N + E).integers(0, E, N)
    if skew == "one":
        ids[:] = 3
    elif skew == "two":
        ids = np.where(np.arange(N) % 3 == 0, 0, E - 1)
    src_j, dest_j = jax_moe._dispatch_plan(jnp.asarray(ids, jnp.int32), E, C)
    src_t, dest_t = moe._dispatch_plan(torch.from_numpy(ids), E, C)
    np.testing.assert_array_equal(src_t.numpy(), np.asarray(src_j))
    np.testing.assert_array_equal(dest_t.numpy(), np.asarray(dest_j))
    if skew == "one":     # expert 3 keeps its first C copies, in order
        assert (dest_t.numpy() == E * C).sum() == N - C
        assert dest_t[:C].tolist() == list(range(3 * C, 4 * C))


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-moe-235b-a22b-full"])
def test_capacity_equals_jax(arch):
    full = arch.endswith("-full")
    name = arch.removesuffix("-full")
    jcfg = jax_config(name, smoke=not full)
    tcfg = get_config(name, smoke=not full)
    got = [moe._capacity(T, tcfg) for T in range(1, 1025)]
    assert got == [jax_moe._capacity(T, jcfg) for T in range(1, 1025)]
    if full:        # the serving chunk and a decode step at full width
        assert moe._capacity(512, tcfg) == 40
        assert moe._capacity(8, tcfg) == 8


# ------------------------------------------------------------ the layer
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T", [64, 200])
def test_moe_apply_matches_jax_with_drops(arch, T):
    x = _skewed_tokens(T, get_config(arch, smoke=True).d_model, seed=T)
    yj, yt, drops = _both(arch, "float32", x)
    assert drops > 0
    np.testing.assert_allclose(yt, yj, rtol=0, atol=FP32_ATOL)
    yj, yt, drops = _both(arch, "bfloat16", x)
    assert drops > 0
    assert_bf16_close(yt, yj)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_batch_drops_nothing(arch):
    """A decode step's group (B <= 8 tokens) has capacity 8 and each token
    picks distinct experts, so no copy is dropped, however skewed."""
    x = _skewed_tokens(4, get_config(arch, smoke=True).d_model, seed=4)
    yj, yt, drops = _both(arch, "float32", x)
    assert drops == 0
    np.testing.assert_allclose(yt, yj, rtol=0, atol=FP32_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sub_chunk_path(arch, monkeypatch):
    """A group over ``MAX_GROUP_TOKENS`` tokens goes in sub-chunks, each
    with its own capacity: 96 tokens under a limit of 20 split into 8
    chunks of 12 (both modules patched the same)."""
    monkeypatch.setattr(jax_moe, "MAX_GROUP_TOKENS", 20)
    monkeypatch.setattr(moe, "MAX_GROUP_TOKENS", 20)
    x = _skewed_tokens(96, get_config(arch, smoke=True).d_model, seed=9)
    yj, y32, _ = _both(arch, "float32", x)
    np.testing.assert_allclose(y32, yj, rtol=0, atol=FP32_ATOL)
    yj, yt, _ = _both(arch, "bfloat16", x)
    assert_bf16_close(yt, yj)
    # the sub-chunks are not one group: the whole-group result differs
    monkeypatch.setattr(moe, "MAX_GROUP_TOKENS", 8192)
    jcfg, tcfg = _cfgs(arch, "float32")
    _, tp = _layer_params(jcfg, "float32")
    whole = moe.moe_apply(tp, torch.from_numpy(x), tcfg).numpy()
    assert np.abs(whole - y32).max() > FP32_ATOL


def test_route_takes_top_k_of_fp32_logits():
    """Route: fp32 product, the k largest in descending order, a softmax
    over those k alone; equal to the reference's on the same inputs."""
    jcfg, tcfg = _cfgs("qwen3-moe-235b-a22b", "float32")
    jp, tp = _layer_params(jcfg, "float32")
    x = np.random.default_rng(0).standard_normal((32, jcfg.d_model),
                                                 ).astype(np.float32)
    pj, ij = jax_moe.route(jp, jnp.asarray(x), jcfg)
    pt, it = moe.route(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(pt.sum(-1).numpy(), 1.0, rtol=1e-6)
