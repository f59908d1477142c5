"""Mamba2 (``models/mamba2.py``) and zamba2's hybrid ``Model`` of the port
against the JAX package at smoke size: the causal conv, the chunked SSD
(jitted, as the reference's model runs it) with a sequence that is not a
whole number of chunks and a nonzero initial state, ``mamba_apply`` in
prefill, extend and decode, and zamba2 (Mamba2 layers in groups of 2, each
led by one of 2 shared attention blocks over concat(x, embeddings))
through prefill, extend and decode with the same param tree
(``params_from_numpy`` of the nested hybrid tree).

Tolerances: fp32 within rtol 2e-5 / atol 5e-4 as the other family tests
(measured: SSD outputs and states within 5e-7, logits within 3e-5, conv
states within 7e-5 at magnitude ~25). bf16: argmax equal and max |dlogit|
<= 1e-2, about one bf16 ulp at zamba2's logit rms of ~1.02 (measured
within 5e-7: the conv rounded op by op and the gate's product read
unrounded by the norm, as XLA computes the reference); the caches within
the same bound; the conv bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.models import mamba2 as jax_mamba
from repro.models.common import cast_params, take_layer
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import mamba2
from repro_torch.models.common import flatten_tree, params_from_numpy

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
FP32 = dict(rtol=2e-5, atol=5e-4)
BF16_MAX_ABS = 1e-2      # logits of rms ~1: about one bf16 ulp there


def _t(a) -> torch.Tensor:
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    return torch.from_numpy(a.copy())


@pytest.fixture(scope="module")
def jit_ssd():
    return jax.jit(jax_mamba.ssd_chunked, static_argnames="chunk")


@pytest.fixture(scope="module")
def layer():
    """One Mamba2 layer of the smoke config (fp32): its JAX params, the
    port's view of the same values and the jitted reference apply."""
    cfg = dataclasses.replace(jax_config(ARCH, smoke=True),
                              compute_dtype="float32")
    jm = JaxModel(cfg)
    jp = cast_params(jm.init(jax.random.PRNGKey(0)), jm.specs(), "float32")
    # A_log and dt_bias away from zero, as trained weights are
    rng = np.random.default_rng(5)
    p = dict(take_layer(take_layer(jp["blocks"], 1)["mamba"], 0))
    p["A_log"] = jnp.asarray(rng.normal(0.5, 0.5, p["A_log"].shape),
                             jnp.float32)
    p["dt_bias"] = jnp.asarray(rng.normal(-1, 0.5, p["dt_bias"].shape),
                               jnp.float32)
    tp = {k: _t(v) for k, v in p.items()}
    apply = jax.jit(lambda p, x, st, mode: jax_mamba.mamba_apply(
        p, x, cfg, st, mode), static_argnames="mode")
    return cfg, p, tp, apply


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(with_state, dtype):
    """Depthwise causal conv with and without a carried state, and its
    new state; bf16 bit for bit."""
    rng = np.random.default_rng(int(with_state))
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32) * 0.3
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) \
        if with_state else None
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    fn = jax.jit(jax_mamba._causal_conv)
    jy, js = fn(*(jnp.asarray(a, jdt) for a in (x, w, b)),
                None if st is None else jnp.asarray(st, jdt))
    ty, ts = mamba2._causal_conv(
        *(torch.from_numpy(a).to(tdt) for a in (x, w, b)),
        None if st is None else torch.from_numpy(st).to(tdt))
    assert ty.dtype == tdt and ts.shape == (2, 3, 12)
    if dtype == "float32":
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                                   atol=1e-6)
    else:
        assert np.array_equal(ty.float().numpy(), _t(jy).numpy())
    assert np.array_equal(ts.float().numpy(), _t(js).numpy())


@pytest.mark.parametrize("S,chunk,G", [(37, 16, 1), (16, 16, 1),
                                       (5, 16, 1), (45, 8, 2)])
def test_ssd_chunked_matches_jax(jit_ssd, S, chunk, G):
    """The SSD against the reference's (jitted): S not a whole number of
    chunks (dt = 0 padding), one chunk, shorter than a chunk, two B/C
    groups; a nonzero initial state; the outputs and the final state."""
    rng = np.random.default_rng(S)
    H, P, N = 4, 8, 6
    xh = rng.standard_normal((2, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((2, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(0, 0.5, H)).astype(np.float32)
    Bm = rng.standard_normal((2, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((2, S, G, N)).astype(np.float32)
    s0 = rng.standard_normal((2, H, P, N)).astype(np.float32)
    jy, js = jit_ssd(xh, dt, A, Bm, Cm, s0, chunk=chunk)
    ty, ts = mamba2.ssd_chunked(*(torch.from_numpy(a) for a in
                                  (xh, dt, A, Bm, Cm, s0)), chunk)
    assert ty.shape == (2, S, H, P) and ts.shape == (2, H, P, N)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-5)


def test_ssd_chunked_equals_the_recurrence():
    """The chunked form against the plain per-token recurrence
    S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T, y_t = S_t C_t."""
    rng = np.random.default_rng(9)
    S, H, P, N = 23, 2, 4, 3
    xh = torch.from_numpy(rng.standard_normal((1, S, H, P))).float()
    dt = torch.from_numpy(rng.uniform(0.1, 1.0, (1, S, H))).float()
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, H)).float()
    Bm = torch.from_numpy(rng.standard_normal((1, S, 1, N))).float()
    Cm = torch.from_numpy(rng.standard_normal((1, S, 1, N))).float()
    st = torch.from_numpy(rng.standard_normal((1, H, P, N))).float()
    y, final = mamba2.ssd_chunked(xh, dt, A, Bm, Cm, st, chunk=8)
    ys = []
    for t in range(S):
        st = torch.exp(dt[:, t] * A)[..., None, None] * st + \
            (xh[:, t] * dt[:, t, :, None])[..., None] * Bm[:, t, 0][:, None,
                                                                  None]
        ys.append(torch.einsum("bhpn,bn->bhp", st, Cm[:, t, 0]))
    torch.testing.assert_close(y, torch.stack(ys, 1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(final, st, rtol=1e-5, atol=1e-5)


def test_mamba_apply_matches_jax_in_three_modes(layer):
    """One layer: prefill (19 tokens, a chunk and a part), extend (6
    tokens from the carried conv and SSM states) and a decode step (the
    recurrence), outputs and states against the reference's."""
    cfg, p, tp, apply = layer
    x = np.random.default_rng(2).standard_normal((2, 26, cfg.d_model)) \
        .astype(np.float32)
    jst, tst = None, None
    for lo, hi, mode in ((0, 19, "prefill"), (19, 25, "extend"),
                         (25, 26, "decode")):
        jo, jst = apply(p, jnp.asarray(x[:, lo:hi]), jst, mode)
        to, tst = mamba2.mamba_apply(tp, torch.from_numpy(x[:, lo:hi]), cfg,
                                     tst, mode)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), err_msg=mode,
                                   **FP32)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       err_msg=f"{mode} {k}", **FP32)


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    dtype = request.param
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True),
                               compute_dtype=dtype)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               compute_dtype=dtype)
    tm = Model(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp)),
               device="cpu")
    return dtype, jm, jp, tm


def test_logits_and_caches_match(pair):
    """prefill(37) -> extend(6) -> decode(1) -> decode(1): the prompt not
    a whole number of 16-token chunks; logits, the Mamba2 conv and SSM
    states of every layer and the shared blocks' K/V."""
    dtype, jm, jp, tm = pair
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab_size, (1, 45))
    jc, tc = jm.init_cache(1, 64), tm.init_cache(1, 64)
    for lo, hi, mode in ((0, 37, "prefill"), (37, 43, "extend"),
                         (43, 44, "decode"), (44, 45, "decode")):
        cl_j = jnp.full((1,), lo, jnp.int32) if mode == "decode" else lo
        cl_t = torch.full((1,), lo) if mode == "decode" else lo
        lj, jc = jm.forward(jp, tokens=jnp.asarray(toks[:, lo:hi]), cache=jc,
                            cache_len=cl_j, mode=mode)
        lt, tc = tm.forward(torch.from_numpy(toks[:, lo:hi]), cache=tc,
                            cache_len=cl_t, mode=mode)
        lj, lt = np.asarray(lj), lt.numpy()
        assert lt.shape == (1, hi - lo, jm.cfg.vocab_size)
        if dtype == "float32":
            np.testing.assert_allclose(lt, lj, err_msg=mode, **FP32)
        else:
            assert np.array_equal(lj.argmax(-1), lt.argmax(-1)), mode
            assert np.abs(lj - lt).max() <= BF16_MAX_ABS, mode
    assert set(tc) == set(jc) == {"conv", "ssm", "shared_k", "shared_v"}
    assert tc["ssm"].dtype == torch.float32
    for key in jc:
        got = tc[key].float().numpy()
        want = np.asarray(jc[key]).astype(np.float32)
        if key.startswith("shared"):
            got, want = got[:, :, :45], want[:, :, :45]
        if dtype == "float32":
            np.testing.assert_allclose(got, want, err_msg=key, **FP32)
        else:
            assert np.abs(got - want).max() <= BF16_MAX_ABS, key


def test_nested_hybrid_tree_carries_over():
    """``params_from_numpy`` flattens the hybrid tree (``blocks.mamba.*``
    stacked over (groups, E), ``shared.attn.*`` / ``shared.mlp.*`` over
    the shared blocks) into the port's names, values and dtypes kept, and
    the model's per-layer views index it group by group."""
    jm = JaxModel(jax_config(ARCH, smoke=True))
    jp = jm.init(jax.random.PRNGKey(3))
    flat = params_from_numpy(jax.tree.map(np.asarray, jp))
    assert set(flat) == set(flatten_tree(jp))
    assert flat["blocks.mamba.wz"].shape == (2, 2, 64, 8, 16)
    assert flat["shared.attn.wq"].shape == (2, 64, 4, 16)
    assert flat["shared.mlp.w1"].shape == (2, 64, 192)
    assert np.array_equal(flat["blocks.mamba.conv_w"].numpy(),
                          np.asarray(jp["blocks"]["mamba"]["conv_w"]))
    assert torch.equal(flat["blocks.mamba.D"], torch.ones(2, 2, 8))
    tm = Model(get_config(ARCH, smoke=True), flat, device="cpu")
    assert len(tm.layers) == 4 and len(tm.shared_blocks) == 2
    assert torch.equal(tm.layers[3]["wx"],
                       tm.params["blocks.mamba.wx"][1, 1])
    assert torch.equal(tm.shared_blocks[1]["attn"]["wo"],
                       tm.params["shared.attn.wo"][1])
    # A_log, D and dt_bias follow the stacked tree: cast with the rest
    # (ROADMAP R6)
    assert tm.params["blocks.mamba.A_log"].dtype == torch.bfloat16
