"""Decode attention's dense launch off the card, and path E's steps with
``fused`` on.

The launch (``dense_decode_attention_kernel``) is ``Model.forward``'s
one-token attention over a layer's dense cache: the reference's
``attend_decode`` at C == 1 (``src/repro/models/attention.py:272``, which
XLA fuses). Its plain version (``dense_decode_ref``) is held here against
the JAX ``attend_decode`` on the same numpy inputs: plain caches and
rings, a ring wrapped past its slots and one not yet full, rows at other
offsets, the softcap on and off, and against the port's own dense
arithmetic (``attend_decode(..., plain=True)``) bit for bit. The window
argument (a one-token query needs no window mask on a ring or on a plain
cache shorter than the window) is shown on the masks. The model's route
to the launch is checked with a stand-in; the launch itself runs on the
card only (``chip_smoke.py`` phase 2).

Then ``build_prefill_step`` / ``build_decode_step`` with ``fused=True``
(on the CPU: the plain versions, the dense launch's among them) against
``fused=False`` bit for bit, and against the JAX package's jitted steps
at gemma2 and zamba2 smoke; zamba2's shared block's norms and MLP through
``fusions`` against the old spelling, bit for bit; ``fused=True`` on a
mesh refused.

Tolerances: fp32 1e-5 (the same masked softmax summed in other orders).
bf16: one bf16 ulp of the largest output (both spell the same roundings:
the scores and P rounded to bf16; XLA's fusion may round an intermediate
in another place); the steps against the JAX package's as
``tests/test_torch_forward_graph.py`` holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JaxShape
from repro.configs.base import get_config as jax_config
from repro.dist.sharding import axis_rules
from repro.launch.mesh import make_host_mesh
from repro.models import attention as jax_attn
from repro.models import steps as jax_steps
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.kernels import fusions, launch_counts
from repro_torch.kernels.decode_attention import dense_decode_ref
from repro_torch.models import Model
from repro_torch.models import attention
from repro_torch.models import steps
from repro_torch.models.common import (add_rms_norm, params_from_numpy,
                                       rms_norm, rope_tables)
from repro_torch.models.mlp import mlp_apply

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
#: (B, T, KV, G, D, window, softcap, offsets): a plain cache, a ring not
#: yet full, a ring wrapped (offsets past T), a plain local cache shorter
#: than its window, rows at other offsets (one at the first token, one at
#: the last slot), gemma2's heads (G 2, D 256) and zamba2's (G 1, D 80)
CASES = {
    "plain": (2, 48, 2, 3, 32, 0, 0.0, (5, 30)),
    "plain softcap": (2, 48, 2, 3, 32, 0, 50.0, (47, 0)),
    "ring not full": (2, 32, 2, 2, 32, 32, 50.0, (10, 3)),
    "ring wrapped": (3, 32, 2, 2, 32, 32, 50.0, (40, 77, 31)),
    "local under window": (2, 24, 2, 2, 16, 32, 0.0, (20, 5)),
    "gemma2 heads": (1, 64, 2, 2, 256, 64, 50.0, (100,)),
    "zamba2 heads": (2, 40, 4, 1, 80, 0, 0.0, (39, 12)),
}
FP32 = dict(rtol=1e-5, atol=1e-5)


def _inputs(case, dtype: str, seed: int = 0):
    B, T, KV, G, D, window, cap, offs = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV * G, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KV, D)).astype(np.float32)
    return q, k, v, np.asarray(offs, np.int32), window, cap


def _torch(a, dtype: str):
    return torch.from_numpy(a).to(DTYPES[dtype][1])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_matches_jax_attend_decode(name, dtype):
    """``dense_decode_ref`` against the JAX ``attend_decode`` at C == 1 on
    the same numpy inputs: fp32 within 1e-5, bf16 within one ulp of the
    largest output."""
    q, k, v, offs, window, cap = _inputs(CASES[name], dtype)
    D = q.shape[-1]
    scale = 1.0 / np.sqrt(D)
    jdt = DTYPES[dtype][0]
    want = np.asarray(jax_attn.attend_decode(
        jnp.asarray(q, jdt)[:, None], jnp.asarray(k, jdt),
        jnp.asarray(v, jdt), jnp.asarray(offs), scale=scale, cap=cap,
        window=window)[:, 0]).astype(np.float32)
    got = dense_decode_ref(_torch(q, dtype), _torch(k, dtype),
                           _torch(v, dtype), torch.from_numpy(offs),
                           scale=scale, softcap=cap,
                           window=window).float().numpy()
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        assert np.abs(got - want).max() <= ulp, (name, ulp)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_is_the_ports_dense_arithmetic(name, dtype):
    """``dense_decode_ref`` gives ``attend_decode(..., plain=True)``'s bits
    (the port's ``decode_stats``), with offsets as a tensor and as a host
    int: so ``fused=True`` on the CPU, which takes it, is ``fused=False``
    bit for bit."""
    q, k, v, offs, window, cap = _inputs(CASES[name], dtype, seed=1)
    qt, kt, vt = (_torch(a, dtype) for a in (q, k, v))
    scale = 1.0 / np.sqrt(q.shape[-1])
    for off in (torch.from_numpy(offs), int(offs[0])):
        want = attention.attend_decode(qt[:, None], kt, vt, off, scale=scale,
                                       cap=cap, window=window,
                                       plain=True)[:, 0]
        got = dense_decode_ref(qt, kt, vt, off, scale=scale, softcap=cap,
                               window=window)
        assert torch.equal(got, want), name


@pytest.mark.parametrize("name", ["ring not full", "ring wrapped",
                                  "local under window", "gemma2 heads"])
def test_window_adds_nothing_at_one_query(name):
    """At C == 1 the reference's window mask keeps every slot its length
    mask keeps: a full ring's slots hold positions (q - window, q], a ring
    not yet full positions 0 .. q, a plain cache shorter than the window
    positions 0 .. T - 1, all inside the window. So the mask is the first
    min(offset + 1, T) slots, which the launch reads, and the plain
    version gives the same bits with the window and without it."""
    q, k, v, offs, window, cap = _inputs(CASES[name], "float32", seed=2)
    B, T = k.shape[:2]
    slot = np.arange(T)[None, :]
    total = offs.astype(np.int64) + 1
    if T == window:          # the reference's ring mask
        n_wrap = (total[:, None] - 1 - slot) // T
        pos = slot + np.maximum(n_wrap, 0) * T
        mask = (pos < total[:, None]) & \
            (pos >= np.maximum(total - window, 0)[:, None]) & \
            (pos <= offs[:, None]) & (pos > offs[:, None] - window)
    else:                    # a plain cache, the window applied
        mask = (slot <= offs[:, None]) & (slot < total[:, None]) & \
            (slot > offs[:, None] - window)
    assert np.array_equal(mask, slot < np.minimum(total, T)[:, None])
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    off = torch.from_numpy(offs)
    scale = 1.0 / np.sqrt(q.shape[-1])
    assert torch.equal(
        dense_decode_ref(qt, kt, vt, off, scale=scale, softcap=cap,
                         window=window),
        dense_decode_ref(qt, kt, vt, off, scale=scale, softcap=cap))


def test_one_token_routes_to_the_dense_launch(monkeypatch):
    """``attend_decode`` sends one query a row (not ``plain``) to the dense
    launch with the rows' int32 device offsets, a ring and a plain cache
    alike; ``plain``, a chunk, a one-row extend chunk and a cache longer
    than its window keep the dense arithmetic."""
    calls = []

    def launch(q, k, v, offsets, *, scale, softcap, window):
        calls.append((tuple(q.shape), offsets.dtype, tuple(offsets.shape),
                      softcap, window))
        return dense_decode_ref(q, k, v, offsets, scale=scale,
                                softcap=softcap, window=window)

    monkeypatch.setattr(attention, "dense_decode_attention", launch)
    q, k, v, offs, window, cap = _inputs(CASES["ring wrapped"], "float32")
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(scale=0.1, cap=cap, window=window)
    with attention.forward_scope():
        attention.attend_decode(qt[:, None], kt, vt, 40, **kw)
    assert calls == [((3, 4, 32), torch.int32, (3,), cap, window)]
    calls.clear()
    attention.attend_decode(qt[:, None], kt, vt, 40, plain=True, **kw)
    attention.attend_decode(qt[:, None].expand(3, 2, 4, 32), kt, vt, 3,
                            **kw)
    attention.attend_decode(qt[:, None], kt, vt, 40, scale=0.1, cap=cap,
                            window=16)
    attention.attend_decode(qt[:, None], kt, vt, 40, mode="extend", **kw)
    assert calls == []
    assert attention.takes_decode_launch(1, False, 4096, 4096)
    assert attention.takes_decode_launch(1, False, 4672, 0)
    assert not attention.takes_decode_launch(1, False, 4672, 4096)
    assert not attention.takes_decode_launch(2, False, 4672, 0)
    assert not attention.takes_decode_launch(1, True, 4672, 0)
    assert not attention.takes_decode_launch(1, False, 4672, 0, "extend")


#: path E's families at smoke width: gemma2's prompt runs past its
#: 32-token window (its rings wrap in the prefill), zamba2's shared
#: blocks read their caches at every group
STEP_CASES = {"gemma2-9b": (40, 8, 64), "zamba2-2.7b": (24, 6, 32)}


def _steps(model, cfg, toks, prompt: int, S: int, fused):
    """A prefill and the decode steps through the built steps; every
    logit and the final cache."""
    B = toks.shape[0]
    pf = steps.build_prefill_step(cfg, None, ShapeSpec("p", "prefill", S, B),
                                  model=model, fused=fused)
    dc = steps.build_decode_step(cfg, None, ShapeSpec("d", "decode", S, B),
                                 model=model, fused=fused)
    nxt, cache, lg = pf.fn(model.init_cache(B, S),
                           torch.from_numpy(toks[:, :prompt]), logits=True)
    out = [lg]
    for t in range(prompt, toks.shape[1]):
        nxt, cache, lg = dc.fn(cache, torch.from_numpy(toks[:, t:t + 1]),
                               torch.full((B,), t, dtype=torch.int32),
                               logits=True)
        out.append(lg)
    return out, cache


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", list(STEP_CASES))
def test_fused_steps_equal_the_plain_steps(arch, dtype):
    """``fused=True`` against ``fused=False`` through the built prefill and
    decode steps (the decode step's bucket): every logit and the final
    caches bit-equal on the CPU, no kernel launched; the default is off
    here (a model on the CPU)."""
    prompt, n, S = STEP_CASES[arch]
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=dtype)
    model = Model(cfg, device="cpu", seed=0)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, prompt + n)).astype(np.int32)
    before = launch_counts()
    plain, pc = _steps(model, cfg, toks, prompt, S, False)
    fused, fc = _steps(model, cfg, toks, prompt, S, True)
    assert all(torch.equal(a, b) for a, b in zip(plain, fused))
    assert all(torch.equal(pc[k], fc[k]) for k in pc)
    assert launch_counts() == before
    assert steps._fused(None, model, None) is False


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", list(STEP_CASES))
def test_fused_steps_match_the_references_jitted_steps(arch, dtype):
    """The fused steps against the JAX package's jitted prefill and decode
    steps from one JAX ``init`` tree: next tokens equal, logits within
    ``tests/test_torch_forward_graph.py``'s tolerances (fp32 rtol 2e-5 /
    atol 5e-4; bf16 0.25)."""
    prompt, n, S = STEP_CASES[arch]
    B = 2
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               compute_dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=dtype)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = Model(cfg, params_from_numpy(jax.tree.map(np.asarray, params)),
                  device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, prompt + n)).astype(np.int32)
    got, _ = _steps(model, cfg, toks, prompt, S, True)
    mesh = make_host_mesh()
    with mesh:
        jp = jax_steps.build_prefill_step(jcfg, mesh,
                                          JaxShape("p", "prefill", S, B))
        jd = jax_steps.build_decode_step(jcfg, mesh,
                                         JaxShape("d", "decode", S, B))

        @jax.jit
        def jlogits(p, cache, tokens, cache_len):
            with axis_rules(jd.rules):
                return jm.forward(p, tokens=tokens, cache=cache,
                                  cache_len=cache_len, mode="decode",
                                  logits_slice=1)[0]

        _, jcache = jp.fn(params, jm.init_cache(B, S),
                          jnp.asarray(toks[:, :prompt]))
        for i, t in enumerate(range(prompt, prompt + n)):
            tok, cl = jnp.asarray(toks[:, t:t + 1]), jnp.full((B,), t,
                                                               jnp.int32)
            want = np.asarray(jlogits(params, jcache, tok, cl))
            _, jcache = jd.fn(params, jcache, tok, cl)
            lg = got[i + 1].numpy()
            assert np.array_equal(lg.argmax(-1), want.argmax(-1)), t
            if dtype == "float32":
                np.testing.assert_allclose(lg, want, rtol=2e-5, atol=5e-4)
            else:
                assert np.abs(lg - want).max() <= 0.25, t


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_shared_block_plain_spelling_is_the_old_one(dtype):
    """zamba2's shared block through ``fusions`` (``fused=False``: the
    plain versions; ``fused=True`` on the CPU: the same) against its old
    spelling, ``rms_norm``, ``add_rms_norm`` and ``mlp_apply``, bit for
    bit, in prefill and at a decode step."""
    cfg = dataclasses.replace(get_config("zamba2-2.7b", smoke=True),
                              compute_dtype=dtype)
    model = Model(cfg, device="cpu", seed=3)
    p = model.shared_blocks[1]
    gen = torch.Generator().manual_seed(4)
    x, x0 = (torch.randn(2, 5, cfg.d_model, generator=gen)
             .to(DTYPES[dtype][1]) for _ in range(2))
    eps = cfg.norm_eps

    def rope(cache_len, n):
        return rope_tables(cache_len + torch.arange(n), cfg.head_dim,
                           cfg.rope_theta, cfg.rope_fraction)

    def old(x, x0, kv, mode, cache_len):
        h = torch.cat([x, x0], dim=-1) @ p["win"]
        a = model._attn_apply(p["attn"], rms_norm(h, p["ln1"], eps), kv,
                              cache_len, rope(cache_len, x.shape[1]), mode)
        h, h2 = add_rms_norm(h, a, p["ln2"], eps)
        return x + (h + mlp_apply(p["mlp"], h2, cfg.activation))

    def new(fused):
        return lambda x, x0, kv, mode, cl: model._shared_block(
            p, x, x0, kv, cl, rope(cl, x.shape[1]), mode, fused=fused)

    for mode, cache_len, n in (("prefill", 0, 5), ("decode", 5, 1)):
        outs = []
        for fn in (old, new(False), new(True)):
            cache = model.init_cache(2, 8)
            kv = (cache["shared_k"][0], cache["shared_v"][0])
            if mode == "decode":
                fn(x, x0, kv, "prefill", 0)
            outs.append((fn(x[:, :n], x0[:, :n], kv, mode, cache_len),
                         kv[0].clone()))
        for got, cache in outs[1:]:
            assert torch.equal(got, outs[0][0]), mode
            assert torch.equal(cache, outs[0][1]), mode
    assert fusions.rms_norm(x, p["ln1"], eps, plain=True).equal(
        rms_norm(x, p["ln1"], eps))


def test_fused_on_a_mesh_is_refused():
    """``fused=True`` with a mesh raises, in the step builders (before any
    step is built) and in ``Model.forward``; the default there is off."""
    cfg = get_config("gemma2-9b", smoke=True)
    model = Model(cfg, device="cpu", seed=0)
    mesh = object()
    with pytest.raises(ValueError, match="mesh"):
        steps._fused(True, model, mesh)
    assert steps._fused(None, model, mesh) is False
    assert steps._fused(False, model, mesh) is False
    model.mesh = mesh
    with pytest.raises(ValueError, match="mesh"):
        model.forward(torch.zeros(1, 4, dtype=torch.int64), fused=True)
