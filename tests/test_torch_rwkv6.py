"""The port's RWKV6 family against the JAX package, on the CPU.

The WKV scan's two plain versions (the sequential recurrence and the
chunked form the CUDA kernel is held against on the card) against the JAX
package's Pallas ``rwkv6_scan`` run in interpret mode and its
``rwkv6_scan_ref``, on the same numpy inputs: the sweep and the
state-continuity case of the JAX package's kernel tests. Then the port's
``Model`` on ``rwkv6-3b`` smoke against the JAX ``Model.forward``, with
one JAX ``Model.init`` tree carried over by ``params_from_numpy``.

Tolerances: the scan 1e-4 (the JAX package's own bound: the chunked form
reassociates fp32 sums over up to 64-token chunks with exponents up to
38). The model under the fp32 override differs only in summation order:
logits (magnitude ~5) and states to rtol 1e-4 / atol 2e-4. In bf16 the
bound is argmax agreement and max |dlogit| <= 0.25, the dense family's
bf16 bound (``tests/test_torch_model.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.rwkv6_scan import rwkv6_scan as jax_scan
from repro.kernels.rwkv6_scan import rwkv6_scan_ref as jax_scan_ref
from repro.models import Model as JaxModel
from repro.models.rwkv6 import _wkv_chunked as jax_wkv_chunked
from repro_torch.configs import get_config
from repro_torch.kernels import _build, kernel_wrappers, launch_counts
from repro_torch.kernels.rwkv6_scan import (rwkv6_chunked_ref, rwkv6_scan,
                                            rwkv6_scan_kernel, rwkv6_scan_ref,
                                            wkv_chunked)
from repro_torch.models import Model
from repro_torch.models.common import params_from_numpy
from repro_torch.models.rwkv6 import _wkv_chunked
from repro_torch.models.transformer import model_specs
from repro_torch.serving.paged_runtime import PagedKVRuntime

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
MODEL_TOL = dict(rtol=1e-4, atol=2e-4)


def scan_inputs(B, T, H, K, seed=0, decay_shift=2.0):
    """r, k, v, w (decay in (0, 1)), u, s0 as float32 numpy arrays; with
    decay_shift=2 the per-chunk log-decay stays far inside the +-38 clip."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    w = np.exp(-np.exp(n(B, T, H, K) - decay_shift)).astype(np.float32)
    return (n(B, T, H, K) * 0.5, n(B, T, H, K) * 0.5, n(B, T, H, K) * 0.5,
            w, n(H, K) * 0.3, n(B, H, K, K) * 0.1)


def to_torch(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def to_jax(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("B,T,H,K,chunk", [
    (2, 128, 2, 32, 32), (1, 256, 4, 64, 64), (2, 96, 2, 16, 32),
])
def test_scan_sweep(B, T, H, K, chunk):
    arrs = scan_inputs(B, T, H, K)
    o, sf = rwkv6_scan(*to_torch(*arrs), chunk=chunk)
    oj, sj = jax_scan(*to_jax(*arrs), chunk=chunk, interpret=True)
    oref, sref = jax_scan_ref(*to_jax(*arrs))
    for got, want in ((o, oj), (sf, sj), (o, oref), (sf, sref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


@pytest.mark.parametrize("B,T,H,K", [(2, 40, 2, 8), (1, 96, 3, 16)])
def test_sequential_ref_matches_jax(B, T, H, K):
    arrs = scan_inputs(B, T, H, K, seed=1)
    o, sf = rwkv6_scan_ref(*to_torch(*arrs))
    oj, sj = jax_scan_ref(*to_jax(*arrs))
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sj), rtol=1e-5,
                               atol=1e-5)


def test_state_continuity_across_calls():
    """Chunked serving: two calls with carried state == one call."""
    B, T, H, K = 1, 64, 2, 16
    r, k, v, w, u, _ = to_torch(*scan_inputs(B, T, H, K, seed=2))
    o_full, s_full = rwkv6_scan(r, k, v, w, u, chunk=32)
    o1, s1 = rwkv6_scan(r[:, :32], k[:, :32], v[:, :32], w[:, :32], u,
                        chunk=32)
    o2, s2 = rwkv6_scan(r[:, 32:], k[:, 32:], v[:, 32:], w[:, 32:], u, s1,
                        chunk=32)
    np.testing.assert_allclose(torch.cat([o1, o2], 1).numpy(),
                               o_full.numpy(), **SCAN_TOL)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), **SCAN_TOL)
    oj, sj = jax_scan(*to_jax(*(t.numpy() for t in (r, k, v, w, u))),
                      chunk=32, interpret=True)
    np.testing.assert_allclose(o_full.numpy(), np.asarray(oj), **SCAN_TOL)
    np.testing.assert_allclose(s_full.numpy(), np.asarray(sj), **SCAN_TOL)


@pytest.mark.parametrize("T,chunk", [(40, 16), (7, 16), (64, 64)])
def test_model_wkv_pads_like_the_reference(T, chunk):
    """The model's chunked WKV pads T to a chunk multiple (k = 0, logw = 0)
    exactly as the JAX package's ``_wkv_chunked`` does."""
    B, H, K = 2, 2, 8
    r, k, v, w, u, s0 = scan_inputs(B, T, H, K, seed=3)
    logw = np.log(w)
    o, sf = _wkv_chunked(*to_torch(r, k, v, logw, u, s0), chunk)
    oj, sj = jax_wkv_chunked(*to_jax(r, k, v, logw, u, s0), chunk=chunk)
    assert o.shape == (B, T, H, K)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), **SCAN_TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sj), **SCAN_TOL)


def test_clipped_decay_matches_the_pallas_kernel():
    """Steep decays (chunk totals of log-decay down to ~-140), where the
    +-38 exponent clip binds inside a chunk: the chunked form then departs
    from the exact recurrence, by design, and the port's chunked plain
    version departs exactly as the Pallas kernel does."""
    arrs = scan_inputs(1, 128, 2, 16, seed=4, decay_shift=0.0)
    o, sf = rwkv6_scan(*to_torch(*arrs), chunk=64)
    oj, sj = jax_scan(*to_jax(*arrs), chunk=64, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), **SCAN_TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(sj), **SCAN_TOL)
    oref, _ = jax_scan_ref(*to_jax(*arrs))
    assert np.abs(o.numpy() - np.asarray(oref)).max() > 1e-2   # it binds


def test_cpu_tensors_take_the_plain_version():
    r, k, v, w, u, s0 = to_torch(*scan_inputs(1, 32, 2, 8, seed=5))
    logw = torch.log(w)
    got = wkv_chunked(r, k, v, logw, u, s0, chunk=16)
    want = rwkv6_chunked_ref(r, k, v, logw, u, s0, chunk=16)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        rwkv6_scan_kernel(r, k, v, logw, u, s0, chunk=16)
    assert launch_counts() == {name: 0 for name in kernel_wrappers()}
    assert not _build._libs


# ------------------------------------------------------------------ model
def _pair(dtype: str):
    jcfg = dataclasses.replace(jax_config("rwkv6-3b", smoke=True),
                               compute_dtype=dtype)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("rwkv6-3b", smoke=True),
                               compute_dtype=dtype)
    tm = Model(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp)),
               device="cpu")
    return jm, jp, tm


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair("float32")


def _tokens(jm, B, S, seed):
    return np.random.default_rng(seed).integers(0, jm.cfg.vocab_size,
                                                size=(B, S))


def _compare_caches(jc, tc, **tol):
    for key in ("shift1", "wkv", "shift2"):
        np.testing.assert_allclose(tc[key].float().numpy(),
                                   np.asarray(jc[key], np.float32),
                                   err_msg=key, **tol)


def test_prefill_matches_jax_fp32(fp32_pair):
    jm, jp, tm = fp32_pair
    toks = _tokens(jm, 2, 40, seed=0)
    lj, jc = jm.forward(jp, tokens=jnp.asarray(toks),
                        cache=jm.init_cache(2, 64), mode="prefill")
    lt, tc = tm.forward(torch.from_numpy(toks), cache=tm.init_cache(2, 64),
                        mode="prefill")
    assert lt.dtype == torch.float32 and lt.shape == (2, 40, 256)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **MODEL_TOL)
    _compare_caches(jc, tc, **MODEL_TOL)
    # without a cache: same logits, no state
    lt2, none = tm.forward(torch.from_numpy(toks))
    assert none is None and torch.equal(lt2, lt)


def test_decode_steps_match_jax_fp32(fp32_pair):
    """Prefill 24 tokens, then 8 one-token decode steps (the plain
    recurrence) on both sides."""
    jm, jp, tm = fp32_pair
    toks = _tokens(jm, 2, 32, seed=1)
    _, jc = jm.forward(jp, tokens=jnp.asarray(toks[:, :24]),
                       cache=jm.init_cache(2, 64), mode="prefill")
    _, tc = tm.forward(torch.from_numpy(toks[:, :24]),
                       cache=tm.init_cache(2, 64), mode="prefill")
    for t in range(24, 32):
        lj, jc = jm.forward(jp, tokens=jnp.asarray(toks[:, t:t + 1]),
                            cache=jc, cache_len=jnp.full((2,), t),
                            mode="decode")
        lt, tc = tm.forward(torch.from_numpy(toks[:, t:t + 1]), cache=tc,
                            cache_len=torch.full((2,), t), mode="decode")
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **MODEL_TOL)
    _compare_caches(jc, tc, **MODEL_TOL)


def test_two_prefill_calls_equal_one(fp32_pair):
    """A prompt prefilled in two calls with the state carried in the cache
    equals one call (the chunk boundary falls mid-chunk), and the JAX
    package's two-call prefill."""
    jm, jp, tm = fp32_pair
    toks = _tokens(jm, 2, 50, seed=2)
    l_one, c_one = tm.forward(torch.from_numpy(toks),
                              cache=tm.init_cache(2, 64), mode="prefill")
    _, c_two = tm.forward(torch.from_numpy(toks[:, :21]),
                          cache=tm.init_cache(2, 64), mode="prefill")
    l_two, c_two = tm.forward(torch.from_numpy(toks[:, 21:]), cache=c_two,
                              mode="prefill")
    np.testing.assert_allclose(l_two.numpy(), l_one[:, 21:].numpy(),
                               **MODEL_TOL)
    for key in c_one:
        np.testing.assert_allclose(c_two[key].numpy(), c_one[key].numpy(),
                                   err_msg=key, **MODEL_TOL)
    _, jc = jm.forward(jp, tokens=jnp.asarray(toks[:, :21]),
                       cache=jm.init_cache(2, 64), mode="prefill")
    lj, jc = jm.forward(jp, tokens=jnp.asarray(toks[:, 21:]), cache=jc,
                        mode="prefill")
    np.testing.assert_allclose(l_two.numpy(), np.asarray(lj), **MODEL_TOL)
    _compare_caches(jc, c_two, **MODEL_TOL)


def test_logits_match_bf16():
    jm, jp, tm = _pair("bfloat16")
    toks = _tokens(jm, 2, 40, seed=3)
    jc, tc = jm.init_cache(2, 64), tm.init_cache(2, 64)
    for lo, hi, mode in ((0, 32, "prefill"), (32, 33, "decode"),
                         (33, 40, "extend")):
        lj, jc = jm.forward(jp, tokens=jnp.asarray(toks[:, lo:hi]), cache=jc,
                            mode=mode)
        lt, tc = tm.forward(torch.from_numpy(toks[:, lo:hi]), cache=tc,
                            mode=mode)
        lj = np.asarray(lj)
        assert np.array_equal(lj.argmax(-1), lt.numpy().argmax(-1)), mode
        assert np.abs(lj - lt.numpy()).max() <= 0.25, mode


def test_params_tree_and_dtypes_mirror_jax():
    """Same dotted names and shapes as the JAX spec tree; the bf16 model
    keeps the decay base ``w0`` and the bonus ``u`` in fp32, as the JAX
    ``cast_params`` does; ``small`` leaves draw N(0, 0.1^2 / fan_in)."""
    cfg = get_config("rwkv6-3b", smoke=True)
    jm = JaxModel(jax_config("rwkv6-3b", smoke=True))
    jax_shapes = {k: tuple(v.shape) for k, v in params_from_numpy(
        jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))).items()}
    assert {k: s.shape for k, s in model_specs(cfg).items()} == jax_shapes
    tm = Model(cfg, device="cpu", seed=3)
    fp32 = {k for k, v in tm.params.items() if v.dtype == torch.float32}
    assert fp32 == {"blocks.tmix.w0", "blocks.tmix.u"}
    w = tm.params["blocks.tmix.mix_w1"].float()     # (L, D, 5, 32)
    assert abs(w.std().item() * np.sqrt(w.shape[-2]) / 0.1 - 1.0) < 0.1
    shapes = tm.cache_shapes(3, 99)
    assert shapes == jm.cache_shapes(3, 99)


def test_paged_runtime_refuses_rwkv():
    """RWKV6 runs through ``Model.forward`` only: like the JAX package's
    engine backend, the paged runtime does not take an SSM family."""
    with pytest.raises(NotImplementedError, match="Model.forward only"):
        PagedKVRuntime(get_config("rwkv6-3b", smoke=True), device="cpu")
