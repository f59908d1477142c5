"""gemma2 (local/global layers) of the port's ``Model`` against the JAX
package's ``Model.forward`` at smoke size: a sliding window of 32 on the
local layers, attention and final softcaps, sandwich norms, tied and
scaled embeddings, tanh GELU. One JAX ``Model.init`` tree is carried over
with ``params_from_numpy``; the same token ids go through prefill, extend
and decode, and past the window through the ring cache's wrap.

Tolerances (those of ``tests/test_torch_families.py``): fp32 logits
(magnitude up to ~30) within rtol 2e-5 / atol 5e-4, measured within
3e-5; caches likewise. bf16: argmax equal and max |dlogit| <= 0.25,
measured at most 0.146 (the JAX-spelled GELU and the local layer's
residual read unrounded by the global layer's first norm, as XLA fuses
the reference's pair body).

ROADMAP R7: the reference's extend of C > 1 tokens past the ring
(``cache_len + C > window``) overwrites keys the chunk's earlier queries
still need; the port refuses that case, and a test here shows the JAX
answer differs from its own full forward there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.models import attention as jax_attn
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models import attention
from repro_torch.models.common import params_from_numpy

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

ARCH = "gemma2-9b"
FP32 = dict(rtol=2e-5, atol=5e-4)
BF16_MAX_ABS = 0.25
WINDOW = 32          # the smoke config's sliding window


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


def _close(dtype, lt, lj, what):
    if dtype == "float32":
        np.testing.assert_allclose(lt, lj, err_msg=what, **FP32)
    else:
        assert np.array_equal(lj.argmax(-1), lt.argmax(-1)), what
        assert np.abs(lj - lt).max() <= BF16_MAX_ABS, what


def _run(jm, jp, tm, toks, steps, max_len):
    """Both models through ``steps`` [(lo, hi, mode)]; yields each step's
    logits and returns the caches."""
    jc, tc = jm.init_cache(1, max_len), tm.init_cache(1, max_len)
    out = []
    for lo, hi, mode in steps:
        cl_j = jnp.full((1,), lo, jnp.int32) if mode == "decode" else lo
        cl_t = torch.full((1,), lo) if mode == "decode" else lo
        lj, jc = jm.forward(jp, tokens=jnp.asarray(toks[:, lo:hi]), cache=jc,
                            cache_len=cl_j, mode=mode)
        lt, tc = tm.forward(torch.from_numpy(toks[:, lo:hi]), cache=tc,
                            cache_len=cl_t, mode=mode)
        assert lt.dtype == torch.float32 and lt.shape == (1, hi - lo,
                                                          jm.cfg.vocab_size)
        out.append((np.asarray(lj), lt.numpy(), f"{mode} {lo}:{hi}"))
    return out, jc, tc


def _check_caches(dtype, jc, tc, n: int):
    """Every cache leaf; the global caches' first ``n`` positions (the
    rest are zeros on both sides)."""
    assert set(jc) == set(tc) == {"k_local", "v_local", "k_global",
                                  "v_global"}
    for key in jc:
        got = tc[key].float().numpy()
        want = np.asarray(jc[key]).astype(np.float32)
        if "global" in key:
            got, want = got[:, :, :n], want[:, :, :n]
        if dtype == "float32":
            np.testing.assert_allclose(got, want, err_msg=key, **FP32)
        else:
            assert np.abs(got - want).max() <= BF16_MAX_ABS, key


def test_three_modes_inside_the_window(pair):
    """prefill(12) -> extend(7) -> decode(1), every position inside the
    local layers' 32-slot ring."""
    dtype, jm, jp, tm = pair
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab_size, (1, 20))
    steps = [(0, 12, "prefill"), (12, 19, "extend"), (19, 20, "decode")]
    out, jc, tc = _run(jm, jp, tm, toks, steps, max_len=64)
    for lj, lt, what in out:
        _close(dtype, lt, lj, what)
    _check_caches(dtype, jc, tc, 20)


def test_prefill_past_the_window_then_decode_across_the_wrap(pair):
    """prefill(40) past the 32-token window (the ring wraps inside the
    prefill write), then 10 one-token decode steps, each overwriting the
    ring's oldest slot."""
    dtype, jm, jp, tm = pair
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (1, 50))
    steps = [(0, 40, "prefill")] + [(t, t + 1, "decode")
                                    for t in range(40, 50)]
    out, jc, tc = _run(jm, jp, tm, toks, steps, max_len=64)
    for lj, lt, what in out:
        _close(dtype, lt, lj, what)
    _check_caches(dtype, jc, tc, 50)


def test_window_without_a_ring():
    """A cache shorter than the window (max_len 24 < 32) is not a ring:
    it is written and masked like a global layer's, as the reference's."""
    jm = JaxModel(dataclasses.replace(jax_config(ARCH, smoke=True),
                                      compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(1))
    tm = Model(dataclasses.replace(get_config(ARCH, smoke=True),
                                   compute_dtype="float32"),
               params_from_numpy(jax.tree.map(np.asarray, jp)), device="cpu")
    assert tm.cache_shapes(1, 24)["k_local"][0][2] == 24
    assert not attention.is_ring(tm.init_cache(1, 24)["k_local"][0], WINDOW)
    toks = np.random.default_rng(2).integers(0, jm.cfg.vocab_size, (1, 24))
    steps = [(0, 16, "prefill"), (16, 21, "extend")] + \
        [(t, t + 1, "decode") for t in range(21, 24)]
    out, _, _ = _run(jm, jp, tm, toks, steps, max_len=24)
    for lj, lt, what in out:
        np.testing.assert_allclose(lt, lj, err_msg=what, **FP32)


@pytest.mark.parametrize("S", [20, 40, 77])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_windowed_matches_jax(S, dtype):
    """The CPU path against the reference's ``attend_windowed`` (S <=
    window: causal blocks; past it: q chunks against spans of window +
    q_chunk keys), GQA 4 over 2 heads with a softcap; bf16 bit for bit."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32) * 2
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32) * 2
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    fn = jax.jit(lambda q, k, v: jax_attn.attend_windowed(
        q, k, v, scale=0.25, window=WINDOW, cap=50.0, q_chunk=24))
    want = np.asarray(fn(*(jnp.asarray(a, jdt) for a in (q, k, v)))
                      .astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = attention.attend_windowed(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), scale=0.25,
        window=WINDOW, cap=50.0, q_chunk=24).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        assert np.array_equal(got, want)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card."""

    @property
    def is_cuda(self):
        return True


def test_attend_windowed_launches_flash_on_the_card(monkeypatch):
    """On a CUDA tensor ``attend_windowed`` is one flash launch with the
    window and softcap, fed (B, H, S, D) views of the model's layout; it
    never takes the plain path."""
    calls = []

    def flash(q, k, v, **kw):
        calls.append((q.shape, k.shape, q.stride(), kw))
        return q

    monkeypatch.setattr(attention, "flash_attention_kernel", flash)
    x = torch.Tensor._make_subclass(_OnCard, torch.zeros(1, 70, 4, 16))
    kv = torch.Tensor._make_subclass(_OnCard, torch.zeros(1, 70, 2, 16))
    out = attention.attend_windowed(x, kv, kv, scale=0.25, window=WINDOW,
                                    cap=50.0)
    assert out.shape == (1, 70, 4, 16)
    (qs, ks, stride, kw), = calls
    assert qs == (1, 4, 70, 16) and ks == (1, 2, 70, 16)
    assert stride == (70 * 64, 16, 64, 1)
    assert kw == dict(scale=0.25, causal=True, window=WINDOW, softcap=50.0)


@pytest.mark.parametrize("start,C", [(0, 20), (30, 5), (10, 70), (64, 1)])
def test_ring_write_matches_jax(start, C):
    """Position p lands in slot p mod W; of a chunk longer than the ring
    only its last W tokens are written (the reference's "later writes
    win")."""
    rng = np.random.default_rng(C)
    ck = rng.standard_normal((2, WINDOW, 2, 4)).astype(np.float32)
    kn = rng.standard_normal((2, C, 2, 4)).astype(np.float32)
    jk, jv = jax_attn.write_cache(jnp.asarray(ck), jnp.asarray(ck),
                                  jnp.asarray(kn), jnp.asarray(kn), start,
                                  ring=True)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(ck.copy())
    attention.write_cache(tk, tv, torch.from_numpy(kn), torch.from_numpy(kn),
                          start, ring=True)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("T", [WINDOW, 48])
def test_attend_decode_window_masks_match_jax(T):
    """The reference's two masks: a ring of W slots (T == window), and a
    plain cache of T slots with the window, for per-row offsets across
    the wrap."""
    rng = np.random.default_rng(T)
    q = rng.standard_normal((3, 1, 4, 8)).astype(np.float32)
    ck = rng.standard_normal((3, T, 2, 8)).astype(np.float32)
    cv = rng.standard_normal((3, T, 2, 8)).astype(np.float32)
    lens = np.array([5, 31, 40]) if T == WINDOW else np.array([5, 33, 47])
    want = jax_attn.attend_decode(jnp.asarray(q), jnp.asarray(ck),
                                  jnp.asarray(cv), jnp.asarray(lens),
                                  scale=0.3, cap=50.0, window=WINDOW)
    got = attention.attend_decode(torch.from_numpy(q), torch.from_numpy(ck),
                                  torch.from_numpy(cv), torch.from_numpy(lens),
                                  scale=0.3, cap=50.0, window=WINDOW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_extend_past_the_ring_is_refused_r7():
    """ROADMAP R7: extend(7) after prefill(40) runs past the 32-slot ring.
    The reference's answer differs from its own full forward there (its
    ring write lands before its queries read); the port raises before it
    writes anything. Inside the ring (prefill 20, extend 7) both are
    exact, and a one-token extend past the ring is allowed. A decode call
    given the same 7 tokens reads the ring the same way and is refused
    too."""
    jm = JaxModel(dataclasses.replace(jax_config(ARCH, smoke=True),
                                      compute_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = Model(dataclasses.replace(get_config(ARCH, smoke=True),
                                   compute_dtype="float32"),
               params_from_numpy(jax.tree.map(np.asarray, jp)), device="cpu")
    toks = np.random.default_rng(3).integers(0, jm.cfg.vocab_size, (1, 47))
    full, _ = jm.forward(jp, tokens=jnp.asarray(toks),
                         cache=jm.init_cache(1, 64), mode="prefill")
    full = np.asarray(full)
    _, jc = jm.forward(jp, tokens=jnp.asarray(toks[:, :40]),
                       cache=jm.init_cache(1, 64), mode="prefill")
    ext, _ = jm.forward(jp, tokens=jnp.asarray(toks[:, 40:]), cache=jc,
                        cache_len=40, mode="extend")
    assert np.abs(np.asarray(ext) - full[:, 40:]).max() > 0.1

    tc = tm.init_cache(1, 64)
    tm.forward(torch.from_numpy(toks[:, :40]), cache=tc)
    before = {k: v.clone() for k, v in tc.items()}
    with pytest.raises(ValueError, match="R7"):
        tm.forward(torch.from_numpy(toks[:, 40:]), cache=tc, cache_len=40,
                   mode="extend")
    with pytest.raises(ValueError, match="R7"):
        tm.forward(torch.from_numpy(toks[:, 40:]), cache=tc,
                   cache_len=torch.full((1,), 40), mode="decode")
    assert all(torch.equal(tc[k], before[k]) for k in tc)
    one, _ = tm.forward(torch.from_numpy(toks[:, 40:41]), cache=tc,
                        cache_len=40, mode="extend")
    np.testing.assert_allclose(one.numpy(), full[:, 40:41], **FP32)

    tc = tm.init_cache(1, 64)
    tm.forward(torch.from_numpy(toks[:, :20]), cache=tc)
    ext, _ = tm.forward(torch.from_numpy(toks[:, 20:27]), cache=tc,
                        cache_len=20, mode="extend")
    np.testing.assert_allclose(ext.numpy(), full[:, 20:27], **FP32)
