"""``build_decode_step``'s step on one device, the bucket step of
``models/forward_graph.py`` (a replayed CUDA graph on the card; on the
CPU the same buffers, run eagerly), at smoke size.

(a) Against the reference's own compiled step: its jitted
``build_decode_step`` on a one-device host mesh, from one JAX ``init``
tree carried over by ``params_from_numpy``, ``cache_len`` a (B,) int32
array, the same token ids fed to both sides. The logits are the jitted
reference forward's in decode mode, the step's own body. Tolerances,
those of ``tests/test_torch_gemma2.py``: fp32 logits and caches within
rtol 2e-5 / atol 5e-4; bf16 argmax equal and max |dlogit| <= 0.25, and
each cache leaf within 0.25, or within 1% of its largest magnitude for
the fp32 recurrent states a bf16 model carries (rwkv6's WKV state
reaches ~143). Largest gaps measured, logits / caches, fp32 then bf16:
qwen2 7.3e-5 / 2.0e-5, 0 / 0; gemma2, across the ring's wrap, 1.5e-5 /
1.4e-5, 0.094 / 0.0625; zamba2 9.4e-6 / 3.3e-5, 0 / 1.2e-4; rwkv6 4.8e-6
/ 3.8e-5, 0.031 / 0.31 (the WKV state, 0.22% of its largest value).

(b) Against the eager step: the bucket step equals ``Model.forward`` at
an int ``cache_len`` (the host branch) bit for bit, in bf16, over steps
whose offsets move, across gemma2's ring wrap, for every family.

(c) Outputs are clones; two caches used in turn each get their own
bucket. (d) No value is read on the host inside the step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from host_reads import no_host_reads
from repro.configs.base import ShapeSpec as JaxShape
from repro.configs.base import get_config as jax_config
from repro.dist.sharding import axis_rules
from repro.launch.mesh import make_host_mesh
from repro.models import steps as jax_steps
from repro.models.transformer import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import Model
from repro_torch.models import forward_graph
from repro_torch.models.common import params_from_numpy
from repro_torch.models.steps import build_decode_step, build_prefill_step

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

FP32 = dict(rtol=2e-5, atol=5e-4)
BF16_MAX_ABS = 0.25
STATE_SHARE = 0.01
#: (arch, prompt, decode steps, max_len): gemma2's prompt runs past its
#: 32-token window, so the ring wraps in the prefill and every decode
#: step overwrites its oldest slot
CASES = {"qwen2-1.5b": (24, 6, 32), "gemma2-9b": (40, 10, 64),
         "zamba2-2.7b": (24, 6, 32), "rwkv6-3b": (24, 6, 32)}
FAMILIES = ["qwen2-1.5b", "gemma2-9b", "zamba2-2.7b", "rwkv6-3b",
            "qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b", "pixtral-12b",
            "musicgen-large"]


def _close(dtype, got, want, what, state: bool = False):
    """The stated tolerances; ``state``: an fp32 recurrent state of a
    bf16 model, held within 1% of its largest magnitude."""
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **FP32)
    else:
        bound = max(BF16_MAX_ABS, STATE_SHARE * np.abs(want).max()) \
            if state else BF16_MAX_ABS
        assert np.abs(got - want).max() <= bound, what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", list(CASES))
def test_against_the_references_jitted_step(arch, dtype):
    """(a) A prefill, then the decode steps through the port's built step
    (its bucket) and the reference's jitted ``decode_step``: next tokens
    equal, logits and caches within the stated tolerances."""
    prompt, steps, S = CASES[arch]
    B = 2
    jcfg = dataclasses.replace(jax_config(arch, smoke=True),
                               compute_dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=dtype)
    jm = JaxModel(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = Model(cfg, params_from_numpy(jax.tree.map(np.asarray, params)),
                  device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, prompt + steps)).astype(np.int32)
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
        pf = build_prefill_step(cfg, None, ShapeSpec("p", "prefill", S, B),
                                model=model)
        dc = build_decode_step(cfg, None, ShapeSpec("d", "decode", S, B),
                               model=model)
        assert dc.graph is not None
        _, cache = pf.fn(model.init_cache(B, S),
                         torch.from_numpy(toks[:, :prompt]))
        for t in range(prompt, prompt + steps):
            tok = toks[:, t:t + 1]
            cl = np.full((B,), t, np.int32)
            want = np.asarray(jlogits(params, jcache, jnp.asarray(tok),
                                      jnp.asarray(cl)))
            jnext, jcache = jd.fn(params, jcache, jnp.asarray(tok),
                                  jnp.asarray(cl))
            nxt, cache, lg = dc.fn(cache, torch.from_numpy(tok),
                                   torch.from_numpy(cl), logits=True)
            assert nxt.dtype == torch.int32 and lg.shape == want.shape
            assert np.array_equal(nxt.numpy(), np.asarray(jnext)), t
            _close(dtype, lg.numpy(), want, f"step {t}")
    assert len(dc.graph.buckets()) == 1
    for k in cache:
        _close(dtype, cache[k].float().numpy(),
               np.asarray(jcache[k]).astype(np.float32), k,
               state=cache[k].dtype == torch.float32)


def _prefilled(arch, B=2, prompt=40, S=64, seed=0):
    cfg = get_config(arch, smoke=True)
    model = Model(cfg, device="cpu", seed=seed)
    toks = torch.randint(0, cfg.vocab_size, (B, prompt + 12),
                         generator=torch.Generator().manual_seed(seed))
    cache = model.init_cache(B, S)
    model.forward(toks[:, :prompt], cache=cache)
    step = build_decode_step(cfg, None, ShapeSpec("d", "decode", S, B),
                             model=model, device="cpu")
    return model, step, toks, cache


def _eager(model, cache, tok, t):
    lg, _ = model.forward(tok, cache=cache, cache_len=t, mode="decode")
    return lg[:, -1:], lg[:, -1].argmax(-1).to(torch.int32)


@pytest.mark.parametrize("arch", FAMILIES)
def test_bucket_step_equals_the_eager_step(arch):
    """(b) bf16: the built step (device offsets, through the bucket's
    buffers) and eager ``Model.forward`` at a host int offset, bit for
    bit, logits, next tokens and every cache leaf, over 12 steps from a
    40-token prompt (past gemma2's 32-slot ring)."""
    model, step, toks, cache = _prefilled(arch)
    assert model.cfg.compute_dtype == "bfloat16"
    twin = {k: v.clone() for k, v in cache.items()}
    for t in range(40, 52):
        tok = toks[:, t:t + 1]
        want, want_nxt = _eager(model, twin, tok, t)
        nxt, got_cache, lg = step.fn(cache, tok, t, logits=True)
        assert got_cache is cache
        assert torch.equal(lg, want) and torch.equal(nxt, want_nxt), t
    assert all(torch.equal(cache[k], twin[k]) for k in cache)
    (b,) = step.graph.buckets().values()
    assert b.uses == 12 and b.graph is None          # nothing captured here


def test_outputs_are_clones_and_caches_get_their_own_buckets():
    """(c) A step's outputs are not changed by the next step; two caches
    used in turn each match an eager twin (no step writes into the other
    cache) and each has its own bucket."""
    model, step, toks, cache = _prefilled("gemma2-9b")
    other = {k: v.clone() for k, v in cache.items()}
    twins = [{k: v.clone() for k, v in cache.items()} for _ in range(2)]
    kept = []
    for t in range(40, 46):
        for i, c in enumerate((cache, other)):
            tok = toks[:, t:t + 1].roll(i, 0)
            nxt, _, lg = step.fn(c, tok, t, logits=True)
            want, want_nxt = _eager(model, twins[i], tok, t)
            assert torch.equal(lg, want) and torch.equal(nxt, want_nxt)
            kept.append((nxt, lg, nxt.clone(), lg.clone()))
    assert all(torch.equal(a, c) and torch.equal(b, d)
               for a, b, c, d in kept)
    for c, twin in zip((cache, other), twins):
        assert all(torch.equal(c[k], twin[k]) for k in c)
    assert len(step.graph.buckets()) == 2


def test_buckets_are_bounded(monkeypatch):
    """The least recently used bucket goes once ``MAX_BUCKETS`` are
    held."""
    monkeypatch.setattr(forward_graph, "MAX_BUCKETS", 2)
    model, step, toks, cache = _prefilled("qwen2-1.5b")
    caches = [cache] + [{k: v.clone() for k, v in cache.items()}
                        for _ in range(2)]
    for c in caches:
        step.fn(c, toks[:, 40:41], 40)
    keys = list(step.graph.buckets())
    assert len(keys) == 2
    assert keys[-1][1] == forward_graph._cache_key(caches[-1])


def test_tokens_and_offsets_in_every_form():
    """Host ids (numpy, a CPU tensor) and offsets as an int, a (B,) array
    or a tensor fill the same buffers; a wrong batch is refused."""
    model, step, toks, cache = _prefilled("qwen2-1.5b")
    tok = toks[:, 40:41]
    runs = [(tok, 40), (tok.numpy(), np.full(2, 40)),
            (tok.int(), torch.full((2,), 40, dtype=torch.int32)),
            (tok[:, 0].tolist(), torch.tensor(40))]
    outs = []
    for tokens, cl in runs:
        c = {k: v.clone() for k, v in cache.items()}
        outs.append(step.fn(c, tokens, cl, logits=True))
    assert all(torch.equal(o[2], outs[0][2]) for o in outs)
    with pytest.raises(ValueError, match="batch of 2"):
        step.fn(cache, tok, [40, 41, 42])


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-2.7b", "rwkv6-3b",
                                  "qwen3-moe-235b-a22b", "musicgen-large"])
def test_no_value_is_read_on_the_host(arch):
    """(d) The step reads nothing back: its offsets come from the bucket's
    device buffer, the last step's next tokens are fed back as a
    tensor."""
    model, step, toks, cache = _prefilled(arch)
    nxt = toks[:, 40]
    for t in range(40, 44):
        offsets = np.full(2, t, np.int32)
        with no_host_reads():
            nxt, _ = step.fn(cache, nxt[:, None], offsets)
    assert nxt.shape == (2,) and nxt.dtype == torch.int32


def test_eager_when_asked_and_on_meta():
    """``cuda_graphs=False`` keeps the eager step; the meta device (the
    roofline counter's) never takes the bucket; ``make_inputs`` puts the
    offsets on the model's device."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    shape = ShapeSpec("d", "decode", 16, 2)
    eager = build_decode_step(cfg, None, shape, device="cpu",
                              cuda_graphs=False)
    assert eager.graph is None and eager.fn.__name__ == "decode_step"
    meta = build_decode_step(cfg, None, shape, device="meta")
    assert meta.graph is None
    cache, tokens, cache_len = meta.make_inputs()
    assert cache_len.device.type == "meta" and cache_len.dtype == \
        torch.int32
    graphed = build_decode_step(cfg, None, shape, device="cpu")
    assert graphed.fn == graphed.graph.step
    nxt, _ = graphed.fn(*graphed.make_inputs())
    assert nxt.shape == (2,)
