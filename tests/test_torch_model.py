"""The port's dense ``Model`` against the JAX package's ``Model.forward``:
one JAX ``Model.init`` tree is carried over with ``params_from_numpy``,
and the same token ids go through prefill, extend and decode.

Tolerances: under the fp32 override the two differ only in matmul
summation order, so logits (magnitude up to ~25 on qwen2 smoke) agree to
rtol 2e-5 / atol 5e-4. In bf16 the bound is argmax agreement and
max |dlogit| <= 0.25 (two bf16 ulps at the smoke models' logit scale; the
JAX package's own bf16 paths differ by 0.143, ROADMAP R2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.common import (init_params, params_from_numpy,
                                       torch_dtype)
from repro_torch.models.transformer import model_specs
from repro_torch.serving.backend import TorchModelBackend
from repro_torch.serving.paged_runtime import PagedKVRuntime

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

ARCHS = ["qwen2-1.5b", "glm4-9b", "stablelm-3b"]


def _pair(arch: str, dtype: str):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               compute_dtype=dtype)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=dtype)
    tm = Model(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp)),
               device="cpu")
    return jm, jp, tm


def _three_modes(jm, jp, tm, seed: int):
    """Logits of prefill(12) -> extend(7) -> decode(1) on both sides."""
    toks = np.random.default_rng(seed).integers(
        0, jm.cfg.vocab_size, size=(1, 20))
    jc, tc = jm.init_cache(1, 32), tm.init_cache(1, 32)
    out = []
    for lo, hi, mode in ((0, 12, "prefill"), (12, 19, "extend"),
                         (19, 20, "decode")):
        cl_j = jnp.full((1,), lo, jnp.int32) if mode == "decode" else lo
        cl_t = torch.full((1,), lo) if mode == "decode" else lo
        lj, jc = jm.forward(jp, tokens=jnp.asarray(toks[:, lo:hi]), cache=jc,
                            cache_len=cl_j, mode=mode)
        lt, tc = tm.forward(torch.from_numpy(toks[:, lo:hi]), cache=tc,
                            cache_len=cl_t, mode=mode)
        assert lt.dtype == torch.float32 and lt.shape == (1, hi - lo,
                                                          jm.cfg.vocab_size)
        out.append((np.asarray(lj), lt.numpy(), mode))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_fp32(arch):
    jm, jp, tm = _pair(arch, "float32")
    for lj, lt, mode in _three_modes(jm, jp, tm, seed=0):
        np.testing.assert_allclose(lt, lj, rtol=2e-5, atol=5e-4,
                                   err_msg=f"{arch} {mode}")


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_bf16(arch):
    jm, jp, tm = _pair(arch, "bfloat16")
    for seed in (0, 1):
        for lj, lt, mode in _three_modes(jm, jp, tm, seed=seed):
            assert np.array_equal(lj.argmax(-1), lt.argmax(-1)), (arch, mode)
            assert np.abs(lj - lt).max() <= 0.25, (arch, mode)


def test_cache_shapes_match_jax():
    for arch in ARCHS:
        jm = JaxModel(jax_config(arch, smoke=True))
        tm = Model(get_config(arch, smoke=True), device="cpu")
        shapes = tm.cache_shapes(2, 48)
        assert shapes == {k: jm.cache_shapes(2, 48)[k] for k in ("k", "v")}
        cache = tm.init_cache(2, 48)
        assert tuple(cache["k"].shape) == shapes["k"][0]
        assert cache["k"].dtype == torch_dtype(shapes["k"][1])


def test_params_tree_mirrors_jax_specs():
    """Same dotted names, shapes and the compute-dtype cast at load."""
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        jm = JaxModel(jax_config(arch, smoke=True))
        jax_shapes = {k: tuple(v.shape) for k, v in params_from_numpy(
            jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))).items()}
        assert {k: s.shape for k, s in model_specs(cfg).items()} == jax_shapes
        tm = Model(cfg, device="cpu")
        assert {k: tuple(v.shape) for k, v in tm.params.items()} == jax_shapes
        assert all(v.dtype == torch.bfloat16 for v in tm.params.values())
        assert dict(tm.named_parameters()).keys() == jax_shapes.keys()


def test_init_params_is_seeded():
    cfg = get_config("qwen2-1.5b", smoke=True)
    a = init_params(cfg, torch.Generator().manual_seed(3))
    b = init_params(cfg, torch.Generator().manual_seed(3))
    c = init_params(cfg, torch.Generator().manual_seed(4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert a["embed"].dtype == torch.float32
    assert torch.count_nonzero(a["blocks.ln1"]) == 0        # zeros init
    # N(0, 1/fan_in) with fan_in the stacked shape's second-to-last dim
    w = a["blocks.mlp.w1"]                 # 13824 draws: std known to ~1%
    assert abs(w.std().item() * np.sqrt(w.shape[-2]) - 1.0) < 0.05


@pytest.mark.parametrize("arch,what", [
    ("gemma2-9b", "local/global layers"), ("rwkv6-3b", "'ssm' family"),
    ("zamba2-2.7b", "'hybrid' family")])
def test_unported_families_raise(arch, what, monkeypatch):
    """``Model`` builds every family; what the port refuses, as the
    reference's engine backend does, is serving gemma2, RWKV6 and zamba2
    through the paged runtime and ``TorchModelBackend``, before any pool
    or weight is allocated."""
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu")
    assert len(model.layers) == cfg.num_layers

    def allocated(*_args, **_kw):
        raise AssertionError("allocated before refusing")

    monkeypatch.setattr(torch, "zeros", allocated)
    for build in (PagedKVRuntime, TorchModelBackend):
        with pytest.raises(NotImplementedError,
                           match=f"{what}.*Model.forward only"):
            build(cfg, device="cpu")
