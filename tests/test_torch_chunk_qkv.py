"""The prefill / extend chunk's qkv launch off the card: the bias, qk norm
and RoPE of a chunk's projections at a position a row, with k and v
written into the layer's cache at offsets read on the device, as one
launch of the fusion kernel (``fusions.qkv_rope_chunk``), and the rotary
tables built once a forward.

On the CPU the launch's plain version (``qkv_finish`` over the chunk's
rows, then ``write_cache`` at the offsets) is held against the JAX
package's ``qkv_project`` chain followed by its ``write_cache`` on the
same numpy inputs: per-row offsets that differ, one clamped at T - C,
for qwen2 (bias), qwen3-moe (qk norm), stablelm (partial rotary) and
musicgen (no RoPE). The projections are exact on both sides (selection
matrices of zeros and ones), and the JAX chain is handed the port's
tables (the two libraries' cos and sin differ in the last ulp), so what
is compared is the chain itself. bf16 (the JAX chain jitted, as XLA
fuses it): bit-equal, the caches too. fp32 (op by op): bit-equal but for
the qk norm, whose mean and rsqrt the two libraries compute in other
orders: within NORM_FP32_TOL (1e-6, as ``test_torch_fusions``).

The model's routing is checked with a stand-in for the card (a CPU tensor
that says it is on CUDA), the wrapper's refusals with CPU tensors, and
phase 2's check in ``chip_smoke.py`` with the plain versions standing in
for the kernels. The kernel itself runs on the card only
(``chip_smoke.py`` phase 2 holds it bit for bit against the plain
version).
"""
import dataclasses
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.models import attention as jax_attn
from repro.serving.paged_runtime import PagedKVRuntime as JaxRuntime
from repro_torch.configs import get_config
from repro_torch.kernels import _build, fusions, kernel_wrappers, \
    launch_counts
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.fusions import kernel as fusion_kernel
from repro_torch.models import Model, attention, transformer
from repro_torch.models.common import params_from_numpy, rope_tables
from repro_torch.serving.paged_runtime import PagedKVRuntime

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float32": (torch.float32, jnp.float32)}
#: fp32 qk norm: the mean's summation order and rsqrt differ between the
#: two libraries (``test_torch_fusions``' bound: measured 4.8e-7)
NORM_FP32_TOL = 1e-6
#: the four family kinds of the chain: bias, qk norm, partial rotary, none
ARCHS = ("qwen2-1.5b", "qwen3-moe-235b-a22b", "stablelm-3b",
         "musicgen-large")
#: (nb, C, T, offsets): offsets that differ, the second clamped to T - C
CHUNK = (3, 5, 24, (0, 30, 7))


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def chain_inputs(cfg, dtype: str, seed: int = 0) -> dict:
    """The chunk's rows as one (nb, C, (H + 2 KV) Dh) input whose
    selection-matrix projections give q, k and v exactly; the biases and
    norm scales; the positions; the caches (random, every slot)."""
    nb, C, T, offs = CHUNK
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    D = (H + 2 * KV) * Dh
    rng = np.random.default_rng(seed)
    eye = np.eye(D, dtype=np.float32)
    w = {"wq": eye[:, :H * Dh].reshape(D, H, Dh),
         "wk": eye[:, H * Dh:(H + KV) * Dh].reshape(D, KV, Dh),
         "wv": eye[:, (H + KV) * Dh:].reshape(D, KV, Dh)}
    if cfg.qkv_bias:
        w.update({n: rng.standard_normal(s).astype(np.float32) * 0.5
                  for n, s in (("bq", (H, Dh)), ("bk", (KV, Dh)),
                               ("bv", (KV, Dh)))})
    if cfg.qk_norm:
        w.update({n: rng.standard_normal(Dh).astype(np.float32) * 0.1
                  for n in ("q_norm", "k_norm")})
    off = np.asarray(offs, np.int32)
    return dict(
        w=w, x=rng.standard_normal((nb, C, D)).astype(np.float32),
        cache=[rng.standard_normal((nb, T, KV, Dh)).astype(np.float32)
               for _ in range(2)],
        off=off, pos=off[:, None] + np.arange(C, dtype=np.int32))


def to_torch(a: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(a).to(DTYPES[dtype][0])


def port_chunk(cfg, t: dict, dtype: str, rows: bool = False):
    """The launch's plain version on t's rows: q (nb, C, H, Dh) and the
    caches after the write (and the k / v rows with ``rows``)."""
    nb, C, _, _ = CHUNK
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {n: to_torch(a, dtype) for n, a in t["w"].items()}
    x = to_torch(t["x"], dtype)
    q, k, v = (x[..., a:b].reshape(nb * C, n, Dh) for a, b, n in (
        (0, H * Dh, H), (H * Dh, (H + KV) * Dh, KV),
        ((H + KV) * Dh, (H + 2 * KV) * Dh, KV)))
    ck, cv = (to_torch(c, dtype) for c in t["cache"])
    kr, vr = (torch.empty_like(k) for _ in range(2)) if rows else (None,
                                                                   None)
    rope = rope_tables(torch.from_numpy(t["pos"]).long(), Dh,
                       cfg.rope_theta, cfg.rope_fraction) \
        if cfg.pos_emb == "rope" else None
    qo = fusions.qkv_rope_chunk(
        q.contiguous(), k.contiguous(), v.contiguous(), cache_k=ck,
        cache_v=cv, offsets=torch.from_numpy(t["off"]), k_rows=kr,
        v_rows=vr, bias=(p["bq"], p["bk"], p["bv"]) if cfg.qkv_bias
        else None, norm=(p["q_norm"], p["k_norm"]) if cfg.qk_norm else None,
        eps=cfg.norm_eps, rope=rope)
    return qo.view(nb, C, H, Dh), ck, cv, kr, vr, rope


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_plain_version_matches_jax_chain(arch, dtype, monkeypatch):
    """The launch's plain version against the reference's ``qkv_project``
    and ``write_cache`` at per-row offsets (one clamped at T - C): q and
    the whole caches (the chunk's slots, and every other slot untouched);
    bf16 against the jitted chain bit for bit, fp32 op by op bit for bit
    but for the qk norm (NORM_FP32_TOL)."""
    cfg = get_config(arch, smoke=True)
    jcfg = jax_config(arch, smoke=True)
    t = chain_inputs(cfg, dtype)
    q, ck, cv, _, _, rope = port_chunk(cfg, t, dtype)
    if rope is not None:
        monkeypatch.setattr(jax_attn, "rope_tables", lambda *a, **k: tuple(
            jnp.asarray(x.numpy()) for x in rope))
    jd = DTYPES[dtype][1]

    def chain(p, x, pos, ck, cv, off):
        qj, kj, vj = jax_attn.qkv_project(p, x, jcfg, pos)
        return (qj, *jax_attn.write_cache(ck, cv, kj, vj, off))

    fn = jax.jit(chain) if dtype == "bfloat16" else chain
    want = fn({n: jnp.asarray(a).astype(jd) for n, a in t["w"].items()},
              jnp.asarray(t["x"]).astype(jd), jnp.asarray(t["pos"]),
              *(jnp.asarray(c).astype(jd) for c in t["cache"]),
              jnp.asarray(t["off"]))
    got = (q, ck, cv)
    for a, b in zip(got, want):
        a, b = as_np(a), as_np(b)
        if dtype == "float32" and cfg.qk_norm:
            np.testing.assert_allclose(a, b, rtol=NORM_FP32_TOL,
                                       atol=NORM_FP32_TOL)
        else:
            assert np.array_equal(a, b)
    nb, C, T, offs = CHUNK
    for s, o in enumerate(offs):            # slots outside the chunk's
        start = max(0, min(o, T - C))
        keep = np.ones(T, bool)
        keep[start:start + C] = False
        assert np.array_equal(as_np(ck[s])[keep],
                              as_np(to_torch(t["cache"][0], dtype))[s][keep])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rows_and_shared_tables(dtype):
    """The rows a prefill's attention reads are the ones written into the
    cache; tables shared by the sequences (C rows) give the bits that a
    row each gives at the same positions."""
    cfg = get_config("stablelm-3b", smoke=True)
    t = chain_inputs(cfg, dtype, seed=1)
    nb, C, _, _ = CHUNK
    t["pos"] = np.broadcast_to(np.arange(C, dtype=np.int32), (nb, C)).copy()
    q, ck, cv, kr, vr, _ = port_chunk(cfg, t, dtype, rows=True)
    for s, o in enumerate(CHUNK[3]):
        start = max(0, min(o, CHUNK[2] - C))
        assert torch.equal(ck[s, start:start + C], kr.view(nb, C, -1,
                                                           kr.shape[-1])[s])
        assert torch.equal(cv[s, start:start + C], vr.view(nb, C, -1,
                                                           vr.shape[-1])[s])
    shared = rope_tables(torch.arange(C), cfg.head_dim, cfg.rope_theta,
                         cfg.rope_fraction)
    p = {n: to_torch(a, dtype) for n, a in t["w"].items()}
    x = to_torch(t["x"], dtype)
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    caches = [to_torch(c, dtype) for c in t["cache"]]
    q2 = fusions.qkv_rope_chunk(
        x[..., :H * Dh].reshape(nb * C, H, Dh).contiguous(),
        x[..., H * Dh:(H + KV) * Dh].reshape(nb * C, KV, Dh).contiguous(),
        x[..., (H + KV) * Dh:].reshape(nb * C, KV, Dh).contiguous(),
        cache_k=caches[0], cache_v=caches[1],
        offsets=torch.from_numpy(t["off"]), rope=shared, eps=cfg.norm_eps,
        bias=(p["bq"], p["bk"], p["bv"]) if cfg.qkv_bias else None)
    assert torch.equal(q2.view(q.shape), q)
    assert torch.equal(caches[0], ck) and torch.equal(caches[1], cv)


# ------------------------------------------------ the tables once a forward
@pytest.mark.parametrize("mode,cache_len", [
    ("prefill", 0), ("extend", 9), ("extend", "tensor"), ("decode", 30)])
def test_tables_once_a_forward_equal_the_per_layer_ones(monkeypatch, mode,
                                                        cache_len):
    """``Model.forward`` builds the rotary tables once (one
    ``rope_tables`` call), hands the same tables to every layer's
    ``qkv_project``, and they equal the tables each layer built from its
    positions before, bit for bit; the logits are those of per-layer
    tables."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    model = Model(cfg, device="cpu", seed=2)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 31)))
    S = 1 if mode == "decode" else 22 if mode == "extend" else 31
    cache = model.init_cache(2, 64)
    start = 0
    if mode != "prefill":
        start = 30 if mode == "decode" else 9
        model.forward(toks[:, :start], cache=cache)
    cl = torch.tensor([start, start], dtype=torch.int32) \
        if cache_len == "tensor" else start
    chunk = toks[:, start:start + S]
    built, seen = [], []
    real_tables, real_project = transformer.rope_tables, \
        attention.qkv_project

    def tables(*args, **kw):
        built.append(args[0].clone())
        return real_tables(*args, **kw)

    def project(p, x, cfg_, positions=None, *, rope=None, finish=None):
        seen.append(rope)
        return real_project(p, x, cfg_, positions, rope=rope, finish=finish)

    monkeypatch.setattr(transformer, "rope_tables", tables)
    monkeypatch.setattr(attention, "qkv_project", project)
    fresh = {k: v.clone() for k, v in cache.items()}
    logits, _ = model.forward(chunk, cache=cache, cache_len=cl, mode=mode)
    assert len(built) == 1 and len(seen) == cfg.num_layers
    assert all(r is seen[0] for r in seen)
    pos = torch.arange(S) + start
    for got, want in zip(seen[0], real_tables(
            pos if cache_len != "tensor" else cl[:, None] + torch.arange(S),
            cfg.head_dim, cfg.rope_theta, cfg.rope_fraction)):
        assert torch.equal(got, want)

    def per_layer(p, x, cfg_, positions=None, *, rope=None, finish=None):
        return real_project(p, x, cfg_, positions=built[0], finish=finish)

    monkeypatch.setattr(attention, "qkv_project", per_layer)
    again, _ = model.forward(chunk, cache=fresh, cache_len=cl, mode=mode)
    assert torch.equal(logits, again)


# ------------------------------------------------------------ the routing
class FakeCuda(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` yes: the model takes its CUDA
    branches, into stand-ins for the launches."""

    @property
    def is_cuda(self):
        return True


def _base(x):
    return x.as_subclass(torch.Tensor) if isinstance(x, FakeCuda) else x


@pytest.fixture
def recorded(monkeypatch):
    """The chunk's qkv launch, the extend launch and the flash prefill
    replaced by their plain versions; the qkv launch's calls recorded."""
    calls = []

    def qkv(q, k, v, **kw):
        calls.append({n: _base(x) for n, x in kw.items()})
        assert kw["offsets"].dtype == torch.int32
        assert kw["offsets"].is_contiguous()
        kw = {n: tuple(map(_base, x)) if isinstance(x, tuple) else _base(x)
              for n, x in kw.items()}
        return fusions.qkv_rope_chunk_ref(_base(q), _base(k), _base(v), **kw)

    def extend(q, k, v, q_offset, *, scale, window, softcap):
        return flash_attention_ref(*map(_base, (q, k, v)), scale=scale,
                                   window=window, softcap=softcap,
                                   q_offset=q_offset)

    def prefill(q, k, v, *, scale, causal, window, softcap):
        return flash_attention_ref(*map(_base, (q, k, v)), scale=scale,
                                   causal=causal, window=window,
                                   softcap=softcap)

    monkeypatch.setattr(fusions, "qkv_rope_chunk", qkv)
    monkeypatch.setattr(attention, "flash_extend_kernel", extend)
    monkeypatch.setattr(attention, "flash_attention_kernel", prefill)
    return calls


def _layer_inputs(arch: str, T: int = 40, seed: int = 3):
    cfg = get_config(arch, smoke=True)
    model = Model(dataclasses.replace(cfg, compute_dtype="float32"),
                  device="cpu", seed=seed)
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((2, 6, cfg.d_model)).astype(
        np.float32))
    cache = model.init_cache(2, T)
    kv = (cache["k"][0], cache["v"][0])
    kv[0].normal_(generator=torch.Generator().manual_seed(seed))
    kv[1].normal_(generator=torch.Generator().manual_seed(seed + 1))
    p = model.layers[0]["attn"]
    return model, p, h, kv


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-235b-a22b",
                                  "stablelm-3b", "musicgen-large"])
@pytest.mark.parametrize("mode,cache_len", [
    ("extend", torch.tensor([11, 30], dtype=torch.int32)),
    ("extend", 17), ("prefill", 0)])
def test_attn_apply_routes_chunks_to_the_launch(recorded, arch, mode,
                                                cache_len):
    """On CUDA tensors, ``fused``, a prefill or extend chunk over a plain
    cache takes the one launch (the forward's int32 offsets; the rows
    kept in prefill, where the attention reads them), and gives what the
    plain spelling gives: the sublayer's output and the caches (fp32,
    2e-5; the stand-ins compute in fp32 on both sides)."""
    model, p, h, kv = _layer_inputs(arch)
    S = h.shape[1]
    positions = torch.as_tensor(cache_len)[..., None] + torch.arange(S) \
        if isinstance(cache_len, torch.Tensor) else torch.arange(S) + \
        cache_len
    cfg = model.cfg
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                       cfg.rope_fraction) if cfg.pos_emb == "rope" else None
    plain_kv = tuple(c.clone() for c in kv)
    with attention.forward_scope():
        got = model._attn_apply(p, h.as_subclass(FakeCuda), kv, cache_len,
                                rope, mode, fused=True)
    assert len(recorded) == 1
    call = recorded[0]
    assert call["offsets"].tolist() == \
        np.broadcast_to(np.asarray(cache_len), (2,)).tolist()
    assert (call["k_rows"] is not None) == (mode == "prefill")
    assert call["cache_k"] is kv[0] and call["cache_v"] is kv[1]
    want = model._attn_apply(p, h, plain_kv, cache_len, rope, mode)
    np.testing.assert_allclose(_base(got).numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)
    for a, b in zip(kv, plain_kv):
        assert torch.equal(a, b)


def test_other_routes_keep_the_plain_chain(recorded):
    """``fused=False``, CPU tensors, a ring (T == window), one-token
    decode, and no cache (training) keep ``qkv_finish`` and
    ``write_cache``."""
    model, p, h, kv = _layer_inputs("qwen2-1.5b")
    cfg = model.cfg
    rope = rope_tables(torch.arange(6) + 4, cfg.head_dim, cfg.rope_theta)
    fake = h.as_subclass(FakeCuda)
    for x, cache, mode, window, fused in (
            (fake, kv, "extend", 0, False),
            (h, kv, "extend", 0, True),
            (fake, kv, "extend", kv[0].shape[1], True),
            (fake[:, :1], kv, "decode", 0, True),
            (h, None, "train", 0, True)):
        model._attn_apply(p, x, cache, 4, tuple(t[:x.shape[1]]
                                                for t in rope), mode,
                          window, fused)
    assert not recorded


def test_forward_spellings_are_one_with_the_launch_route(monkeypatch):
    """``Model.forward(fused=True)`` in bf16 with the launch's route taken
    on the CPU (its plain version) gives ``fused=False``'s logits and
    caches bit for bit, in prefill and extend, at host and device
    offsets."""
    monkeypatch.setattr(transformer, "_takes_qkv_launch",
                        lambda fused, h, kv, mode, window: fused and
                        kv is not None and mode in ("prefill", "extend"))
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    model = Model(cfg, device="cpu", seed=4)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)))
    outs = []
    for fused in (False, True):
        cache = model.init_cache(2, 40)
        model.forward(toks[:, :10], cache=cache, fused=fused)
        logits, _ = model.forward(
            toks[:, 10:], cache=cache, fused=fused, mode="extend",
            cache_len=torch.tensor([10, 10], dtype=torch.int32))
        outs.append((logits, cache["k"].clone(), cache["v"].clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the runtime
FP32_LOGITS = dict(rtol=2e-5, atol=5e-4)
#: (program, tokens, pad_to): a 40-token prompt in 16-token chunks (the
#: last padded), a second program's 20 tokens, extends of 5 and 16
RUNTIME_OPS = (("A", 16, 16), ("A", 16, 16), ("A", 8, 16), ("B", 20, 32),
               ("A", 5, 8), ("B", 16, 16), ("B", 5, 8), ("A", 16, 16))


def test_runtime_chunks_through_the_launch_route_match_jax(monkeypatch):
    """``PagedKVRuntime(fused=True)``'s chunked prefill, padded chunks and
    extends with the launch's route taken on the CPU (its plain version
    writing the scratch cache at the runtime's device offsets) against
    the JAX runtime (fp32, the runtime tests' bound), bit-equal to
    ``fused=False``; no kernel launched."""
    taken = []

    def route(fused, h, kv, mode, window):
        ok = fused and kv is not None and mode in ("prefill", "extend")
        taken.append(ok)
        return ok

    monkeypatch.setattr(transformer, "_takes_qkv_launch", route)
    jcfg = dataclasses.replace(jax_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    jp = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    tm = Model(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp)),
               device="cpu")
    rj = JaxRuntime(jcfg, n_pages=32, page_size=8)
    legs = {f: PagedKVRuntime(tcfg, n_pages=32, page_size=8, device="cpu",
                              fused=f) for f in (True, False)}
    rng = np.random.default_rng(3)
    ops = [(pid, rng.integers(0, 100, n), pad) for pid, n, pad in
           RUNTIME_OPS]
    want = [rj.prefill(jp, pid, jnp.asarray(t), pad_to=pad)
            for pid, t, pad in ops]
    got = {f: [rt.prefill(tm, pid, torch.from_numpy(t), pad_to=pad)
               for pid, t, pad in ops] for f, rt in legs.items()}
    assert any(taken) and not all(taken)
    for a, b in zip(want, got[True]):
        np.testing.assert_allclose(as_np(b), as_np(a), **FP32_LOGITS)
    assert all(torch.equal(a, b) for a, b in zip(got[True], got[False]))
    assert torch.equal(legs[True].k_pages, legs[False].k_pages)
    assert launch_counts() == {name: 0 for name in kernel_wrappers()}


def test_gather_zeroes_only_off_the_launch_route():
    """The scratch gather zeroes rows past the start wherever the plain
    attention reads them, and leaves them as gathered where the chunk's
    attention is the extend launch."""
    take = attention.takes_extend_launch
    assert take(True, 512, False, False)
    for args in ((False, 512, False, False), (True, 1, False, False),
                 (True, 512, True, False), (True, 512, False, True)):
        assert not take(*args)
    cfg = get_config("qwen2-1.5b", smoke=True)
    rt = PagedKVRuntime(cfg, n_pages=4, page_size=8, device="cpu")
    rt.k_pages.fill_(3.0)
    rt.v_pages.fill_(3.0)
    L, KV, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    k, v = (torch.full((L, 1, 8, KV, Dh), -1.0, dtype=rt.k_pages.dtype)
            for _ in range(2))
    gather = torch.zeros(8, dtype=torch.int32)
    for zero in (True, False):
        rt._gather_into(k, v, gather, torch.tensor([5]), zero=zero)
        assert (k[:, 0, :5] == 3).all() and (v[:, 0, :5] == 3).all()
        assert (k[:, 0, 5:] == (0 if zero else 3)).all()


# ------------------------------------------------------------ the wrapper
def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _args(**edit) -> dict:
    """A well-formed chunk (nb 2, C 4, T 16, H 6, KV 2, Dh 16) of CPU
    tensors, edited."""
    a = dict(q=_bf16(8, 6, 16), k=_bf16(8, 2, 16), v=_bf16(8, 2, 16),
             cache_k=_bf16(2, 16, 2, 16), cache_v=_bf16(2, 16, 2, 16),
             offsets=torch.zeros(2, dtype=torch.int32),
             rope=(torch.zeros(8, 1, 4), torch.zeros(8, 1, 4)))
    a.update(edit)
    return a


@pytest.mark.parametrize("edit,match", [
    (dict(), "CUDA"),                                    # all shapes right
    (dict(rope=(torch.zeros(4, 4), torch.zeros(4, 4))), "CUDA"),  # C rows
    (dict(offsets=torch.zeros(2, dtype=torch.int64)), "offsets"),
    (dict(offsets=torch.zeros(3, dtype=torch.int32)), "offsets"),
    (dict(offsets=torch.zeros(2, 2, dtype=torch.int32)[:, 0]), "offsets"),
    (dict(offsets=(0, 0)), "offsets"),
    (dict(cache_k=_bf16(2, 16, 2, 8)), "caches"),
    (dict(cache_k=_bf16(3, 16, 2, 16), cache_v=_bf16(3, 16, 2, 16)),
     "sequences"),
    (dict(cache_k=_bf16(2, 3, 2, 16), cache_v=_bf16(2, 3, 2, 16)),
     "sequences"),
    (dict(cache_k=_bf16(2, 16, 2, 32)[..., :16],
          cache_v=_bf16(2, 16, 2, 32)[..., :16]), "contiguous"),
    (dict(cache_k=_bf16(2, 16, 2, 16).float(),
          cache_v=_bf16(2, 16, 2, 16).float()), "every tensor"),
    (dict(rope=(torch.zeros(3, 4), torch.zeros(3, 4))), "rope tables"),
    (dict(rope=(torch.zeros(8, 12), torch.zeros(8, 12))), "rope tables"),
    (dict(k_rows=_bf16(8, 2, 16)), "k_rows"),
    (dict(q=_bf16(8, 6, 512), k=_bf16(8, 2, 512), v=_bf16(8, 2, 512),
          cache_k=_bf16(2, 16, 2, 512), cache_v=_bf16(2, 16, 2, 512),
          rope=None), "at most 256"),
    (dict(q=_bf16(8, 6, 12), k=_bf16(8, 2, 12), v=_bf16(8, 2, 12),
          cache_k=_bf16(2, 16, 2, 12), cache_v=_bf16(2, 16, 2, 12),
          rope=None, norm=(_bf16(12), _bf16(12))), "16 bytes"),
])
def test_wrapper_refuses_before_any_launch(edit, match):
    """The launch's wrapper checks shapes, dtypes, layouts, offsets and
    the device before it builds or launches anything."""
    a = _args(**edit)
    with pytest.raises(ValueError, match=match):
        fusion_kernel.qkv_rope_chunk_kernel(
            a.pop("q"), a.pop("k"), a.pop("v"), **a)
    assert launch_counts() == {name: 0 for name in kernel_wrappers()}
    assert not _build._libs


def test_entry_point_takes_the_bound_arguments():
    """The C entry point's parameter list matches the ctypes declaration
    the wrapper binds, and the launch is counted apart from the decode
    step's."""
    src = (ROOT / "src" / "repro_torch" / "csrc" / "fusions.cu").read_text()
    sig = re.search(r"int qkv_rope_cache_launch\(([^)]*)\)", src).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == len(fusion_kernel._CACHE_ARGS)
    assert params[15] == "const void* off"
    assert params[-5:-2] == ["int slots", "long long cache_stride",
                             "float eps"]
    wrappers = kernel_wrappers()
    assert wrappers["qkv_rope_chunk"] is fusion_kernel.qkv_rope_chunk_kernel
    assert wrappers["qkv_rope"] is not wrappers["qkv_rope_chunk"]


# ----------------------------------------------------- chip_smoke's checks
def _plain(broken: bool = False):
    from repro_torch.kernels.fusions import rms_norm_ref
    ref = fusions.qkv_rope_chunk_ref

    def off(*args, **kw):
        out = ref(*args, **kw)
        kw["cache_k"].view(-1)[0] += 1.0       # one cache slot moved
        return out

    return off if broken else ref, ref, rms_norm_ref


@pytest.fixture
def small_chunk_checks(monkeypatch):
    """Phase 2's chunk checks cut for the CPU: a 64-row chunk, two widths
    (qwen2's bias, qwen3-moe's qk norm)."""
    monkeypatch.setattr(chip_smoke, "CHUNK_QKV_MAIN", dict(
        chip_smoke.CHUNK_QKV_MAIN, C=64, T=320))
    monkeypatch.setattr(chip_smoke, "CHUNK_QKV_OFFSETS", (0, 256, 37))
    monkeypatch.setattr(chip_smoke, "CHUNK_QKV_CASES", (
        dict(arch="qwen2-1.5b", nb=3, C=8, T=40, offs=(0, 17, 39)),
        dict(arch="qwen3-moe-235b-a22b", nb=2, C=8, T=24, offs=(5, 16),
             shared=True)))


@pytest.mark.parametrize("broken", [False, True])
def test_chunk_checks_on_cpu(small_chunk_checks, capsys, broken):
    """Phase 2's checks of the chunk's launch run end to end with the
    plain version standing in for the kernel; one moved cache slot fails
    them."""
    gen = torch.Generator().manual_seed(0)
    if broken:
        with pytest.raises(AssertionError):
            chip_smoke.check_chunk_qkvs(gen, None, "cpu", _plain(True))
        return
    rec = chip_smoke.check_chunk_qkvs(gen, None, "cpu", _plain())
    assert rec == dict(max_abs_err=0.0)
    out = capsys.readouterr().out
    assert "phase2 qkv_rope_chunk: bit-equal" in out
    assert "qwen3-moe-235b-a22b bfloat16" in out


def test_path_a_chunk_work():
    """Path A's chunk (512 rows of 12 + 2 x 2 heads of 128 in bf16): the
    bytes the launch must move, bound by bytes on the H100."""
    t = chip_smoke.chunk_qkv_case(chip_smoke.CHUNK_QKV_MAIN, torch.bfloat16,
                                  torch.Generator().manual_seed(0), "cpu")
    nbytes, ops = chip_smoke.chunk_qkv_work(t, rows=False)
    N, H, KV, Dh = 512, 12, 2, 128
    assert nbytes == 2 * (2 * N * (H + 2 * KV) * Dh + (H + 2 * KV) * Dh) \
        + 2 * N * 64 * 4 + 4
    assert ops == 8.0 * N * (H + KV) * Dh
    sheet = chip_smoke.card_datasheet("NVIDIA H100 80GB HBM3")
    ms, by = chip_smoke.bound_ms(nbytes, ops, sheet, "fp32")
    assert by == "bytes" and ms == pytest.approx(nbytes / 3.35e9)


def _chunk_check(layers: int, **edit) -> dict:
    """A chunk record as the card's checks give it at the published init
    (max |logit| 3.5, largest raw score 40)."""
    zero = {k: 0 for k in kernel_wrappers()}
    gap = dict(argmax_equal=True, argmax_gap=0.0, max_abs_diff=0.0,
               rms_logit=0.8, max_abs_logit=3.5)
    fused = dict(zero, rms_norm=5 * layers, gated_act=2 * layers,
                 flash_extend=2 * layers, qkv_rope_chunk=2 * layers)
    check = dict(gap, max_abs_diff=0.05, chunks=2, fusions=dict(gap),
                 qkv=dict(gap), score_max=40.0, scale=128 ** -0.5,
                 layers=layers, init="published", qk_norm=False,
                 launches_fused=fused,
                 launches_qkv_plain=dict(fused, qkv_rope_chunk=0),
                 launches_fusions=dict(fused, flash_extend=0),
                 launches_plain=dict(zero))
    for key, value in edit.items():
        if isinstance(value, dict):
            check[key] = dict(check[key], **value)
        else:
            check[key] = value
    return check


@pytest.mark.parametrize("layers,edit,ok", [
    (2, {}, True),
    (28, dict(fusions=dict(max_abs_diff=0.0996)), True),   # past two ulps
    (2, dict(fusions=dict(max_abs_diff=0.0996)), False),
    (28, dict(fusions=dict(max_abs_diff=2.5)), False),     # past the bound
    (28, dict(max_abs_diff=2.5), False),
    (2, dict(chunk_fusions=["rms_norm"], launches_fused=dict(gated_act=0),
             launches_fusions=dict(gated_act=0)), True),     # a MoE FFN
    (2, dict(launches_fused=dict(gated_act=0),
             launches_fusions=dict(gated_act=0)), False),
])
def test_full_depth_fusions_take_the_chunk_bound(layers, edit, ok):
    """At CHECK_DEPTH layers the fusions alone keep the decode step's two
    ulps; past it (the published init's full depth) the chunk's bound."""
    check = _chunk_check(layers, **edit)
    if ok:
        chip_smoke.assert_chunk_fused_vs_plain(check, "bfloat16", cuda=True)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.assert_chunk_fused_vs_plain(check, "bfloat16",
                                                   cuda=True)


@pytest.mark.parametrize("edit,ok", [
    ({}, True),
    (dict(qkv=dict(max_abs_diff=2.0 ** -6)), False),       # one ulp apart
    (dict(qkv=dict(max_abs_diff=2.0 ** -6), qk_norm=True), True),
    (dict(qkv=dict(max_abs_diff=0.07), qk_norm=True), False),
    (dict(launches_fused=dict(qkv_rope_chunk=3)), False),
    (dict(launches_qkv_plain=dict(qkv_rope_chunk=1)), False),
    (dict(launches_plain=dict(qkv_rope_chunk=1)), False),
])
def test_qkv_leg_gate(edit, ok):
    """The fused chunk against its qkv-plain spelling: bit-equal without
    a qk norm, within two ulps of the largest logit with one; the launch
    once a layer and chunk in the fused legs, never in the others."""
    check = _chunk_check(2, **edit)
    if ok:
        chip_smoke.assert_chunk_qkv(check, "bfloat16", cuda=True)
    else:
        with pytest.raises(AssertionError):
            chip_smoke.assert_chunk_qkv(check, "bfloat16", cuda=True)
