"""The Mamba2 kernels' plain versions (``kernels/mamba2/ref.py``) against
the JAX package, their routing in the model, their planner and refusals,
off the card.

``mamba2_step_ref`` (reached through ``mamba_apply(fused=True)`` with
the kernels' route opened to CPU tensors, :func:`kernel_route`) against the reference's ``mamba_apply`` in decode mode, and
``ssd_chunk_ref`` against the reference's ``ssd_chunked`` plus its
epilogue (the D skip, the gate, the norm), at smoke widths and at
zamba2-2.7b's full head geometry (H 80, P 64, N 64: d_model 64 with an
expand of 80, so the in-products stay small), from nonzero states, at S 1,
37 and 150 (none a whole number of 64-token chunks). Tolerances: fp32
within rtol 2e-5 / atol 5e-4 (``tests/test_torch_mamba2.py``'s; measured
within 1e-5); bf16 outputs within 1e-2 of the normed y (about a bf16 ulp
at its magnitude of ~1-4), the conv state bit-equal, the new SSM state of
a decode step bit-equal (every op elementwise and rounded as the
reference rounds it) and a prompt's within fp32's tolerance (its sums in
another order). zamba2 smoke's ``Model.forward(fused=True)`` on the CPU
against the JAX model and against ``fused=False``: through the route,
and bit-equal without it (the route takes CUDA tensors only); the planner
(``takes_mamba2_launch``) at every config; the wrappers' refusals before
any launch; a row alone against the same row in a batch.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import SSMConfig as JaxSSM
from repro.models import Model as JaxModel
from repro.models import mamba2 as jax_mamba
from repro.models.common import rms_norm as jax_rms_norm
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels import _build, kernel_wrappers, launch_counts
from repro_torch.kernels import mamba2 as mk
from repro_torch.kernels.mamba2 import kernel as mkernel
from repro_torch.models import Model, mamba2
from repro_torch.models.common import params_from_numpy

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
ROOT = Path(__file__).resolve().parents[1]
FP32 = dict(rtol=2e-5, atol=5e-4)
BF16_Y = 1e-2
#: zamba2-2.7b's Mamba2 head geometry at a small d_model: H = 80 x 64 / 64
FULL_HEADS = dict(d_model=64, ssm=dict(d_state=64, d_conv=4, expand=80,
                                       head_dim=64, n_groups=1, chunk=64))
GEOMETRIES = {"smoke": {}, "full_heads": FULL_HEADS}


def _cfgs(geometry: str, dtype: str):
    """(JAX config, port config) of one Mamba2 layer's widths."""
    jcfg = dataclasses.replace(jax_config(ARCH, smoke=True),
                               compute_dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True),
                               compute_dtype=dtype)
    geo = GEOMETRIES[geometry]
    if geo:
        jcfg = dataclasses.replace(jcfg, d_model=geo["d_model"],
                                   ssm=JaxSSM(**geo["ssm"]))
        tcfg = dataclasses.replace(tcfg, d_model=geo["d_model"],
                                   ssm=SSMConfig(**geo["ssm"]))
    return jcfg, tcfg


def _layer(tcfg, dtype: str, seed: int = 0):
    """One Mamba2 layer's parameters drawn with numpy (trained-like
    A_log, dt_bias, D and norm), as numpy fp32 arrays."""
    rng = np.random.default_rng(seed)
    specs = mamba2.mamba_specs(tcfg, dtype)
    out = {}
    for name, spec in specs.items():
        std = {"conv_w": 0.3, "conv_b": 0.1, "norm": 0.1}.get(
            name, 1.0 / np.sqrt(tcfg.d_model))
        mean = {"A_log": 0.5, "dt_bias": -1.0, "D": 1.0}.get(name, 0.0)
        if name in ("A_log", "dt_bias", "D"):
            std = 0.5
        out[name] = (rng.standard_normal(spec.shape) * std + mean).astype(
            np.float32)
    return out


def _state(tcfg, B: int, dtype: str, seed: int = 1):
    shapes = mamba2.mamba_state_shapes(tcfg, B)
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k, (shape, _) in shapes.items()}


@pytest.fixture
def kernel_route(monkeypatch):
    """``mamba_apply``'s kernels' route opened to CPU tensors: the model
    then calls ``ops.mamba2_step`` / ``ops.ssd_chunk`` as on the card,
    and they send the CPU tensors to the plain versions."""
    monkeypatch.setattr(mamba2, "_KERNEL_DEVICE", "cpu")


def _j(a, dtype):
    return jnp.asarray(a, jnp.dtype(dtype))


def _t(a, dtype=None):
    t = torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32))
                         .copy())
    return t if dtype is None else t.to(getattr(torch, dtype))


# ------------------------------------------------ the decode step vs JAX
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_step_ref_matches_jax_decode(geometry, dtype, kernel_route):
    """One decode step of a layer from nonzero conv and SSM states:
    ``mamba_apply(fused=True)`` through the route (``mamba2_step_ref``) against
    the reference's ``mamba_apply(mode="decode")``; the states updated
    in place in the given tensors."""
    jcfg, tcfg = _cfgs(geometry, dtype)
    p = _layer(tcfg, dtype)
    st = _state(tcfg, 2, dtype)
    x = np.random.default_rng(2).standard_normal((2, 1, tcfg.d_model)) \
        .astype(np.float32)
    jo, jst = jax.jit(lambda p, x, s: jax_mamba.mamba_apply(
        p, x, jcfg, s, "decode"))(
        {k: _j(v, dtype) for k, v in p.items()}, _j(x, dtype),
        {"conv": _j(st["conv"], dtype), "ssm": _j(st["ssm"], "float32")})
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtype))
          for k, v in p.items()}
    jax.block_until_ready((jo, jst))
    # copies: the kernels' route updates the states in place
    tst = {"conv": torch.from_numpy(st["conv"].copy()).to(
        getattr(torch, dtype)), "ssm": torch.from_numpy(st["ssm"].copy())}
    keep = dict(tst)
    to, new = mamba2.mamba_apply(tp, torch.from_numpy(x).to(
        getattr(torch, dtype)), tcfg, tst, "decode", fused=True)
    assert new["conv"] is keep["conv"] and new["ssm"] is keep["ssm"]
    if dtype == "float32":
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **FP32)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(new[k].numpy(), np.asarray(jst[k]),
                                       err_msg=k, **FP32)
    else:
        assert torch.equal(new["conv"].float(), _t(jst["conv"]))
        # XLA's CPU exp and torch's part in the last bit: the new SSM state
        # is held bit-equal to the plain spelling's, within fp32's
        # tolerance of the reference's
        plain = {"conv": torch.from_numpy(st["conv"].copy()).to(
            torch.bfloat16), "ssm": torch.from_numpy(st["ssm"].copy())}
        _, plain = mamba2.mamba_apply(tp, torch.from_numpy(x).to(
            torch.bfloat16), tcfg, plain, "decode")
        assert torch.equal(new["ssm"], plain["ssm"])
        np.testing.assert_allclose(new["ssm"].numpy(), np.asarray(jst["ssm"]),
                                   **FP32)
        assert np.abs(to.float().numpy() - _t(jo).numpy()).max() <= \
            BF16_Y * max(1.0, float(np.abs(np.asarray(
                jo.astype(jnp.float32))).max()))


# ------------------------------------------------ the prompt's SSD vs JAX
def _jax_ssd_epilogue(jcfg, dtype):
    """The reference's ``ssd_chunked`` and the epilogue of its
    ``mamba_apply`` (``:198-200``), jitted as XLA fuses them."""
    def run(xr, dt, A, Bm, Cm, s0, z, D, norm):
        y, st = jax_mamba.ssd_chunked(xr, dt, A, Bm, Cm, s0,
                                      jcfg.ssm.chunk)
        y = y + xr.astype(jnp.float32) * D[None, None, :, None]
        y = y.astype(jnp.dtype(dtype)) * jax.nn.silu(z)
        return jax_rms_norm(y, norm, jcfg.norm_eps), st
    return jax.jit(run)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [1, 37, 150])
def test_ssd_chunk_ref_matches_jax_at_full_heads(S, dtype):
    """``ssd_chunk_ref`` at zamba2-2.7b's head geometry from a nonzero
    state against the reference's ``ssd_chunked`` plus its epilogue: the
    normed y and the final state (overwritten in place)."""
    jcfg, tcfg = _cfgs("full_heads", dtype)
    _check_ssd(jcfg, tcfg, dtype, B=2, S=S, G=1, seed=S)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunk_ref_matches_jax_with_two_groups(dtype):
    """Two B / C groups read in place (heads 0-3 group 0, 4-7 group 1),
    smoke widths, 45 tokens in chunks of 16."""
    jcfg, tcfg = _cfgs("smoke", dtype)
    _check_ssd(jcfg, tcfg, dtype, B=3, S=45, G=2, seed=5)


def _check_ssd(jcfg, tcfg, dtype, B, S, G, seed):
    s = tcfg.ssm
    H, P, N = s.expand * tcfg.d_model // s.head_dim, s.head_dim, s.d_state
    rng = np.random.default_rng(seed)
    silu = lambda a: a / (1 + np.exp(-a))                    # noqa: E731
    xr = silu(rng.standard_normal((B, S, H, P))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1)) \
        .astype(np.float32)
    A_log = rng.normal(0.5, 0.5, H).astype(np.float32)
    Bm = silu(rng.standard_normal((B, S, G, N))).astype(np.float32)
    Cm = silu(rng.standard_normal((B, S, G, N))).astype(np.float32)
    s0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    z = rng.standard_normal((B, S, H, P)).astype(np.float32)
    D = rng.normal(1.0, 0.3, H).astype(np.float32)
    norm = rng.normal(0.0, 0.1, (H, P)).astype(np.float32)
    td = getattr(torch, dtype)
    # the model's A: -exp of the compute dtype's A_log
    A = -np.exp(torch.from_numpy(A_log).to(td).float().numpy())
    jy, js = _jax_ssd_epilogue(jcfg, dtype)(
        _j(xr, dtype), jnp.asarray(dt), jnp.asarray(A), _j(Bm, dtype),
        _j(Cm, dtype), jnp.asarray(s0), _j(z, dtype), _j(D, dtype),
        _j(norm, dtype))
    state = torch.from_numpy(s0.copy())
    ty, ts = mk.ssd_chunk_ref(
        torch.from_numpy(xr).to(td), torch.from_numpy(dt),
        torch.from_numpy(A_log).to(td), torch.from_numpy(Bm).to(td),
        torch.from_numpy(Cm).to(td), torch.from_numpy(z).to(td),
        torch.from_numpy(D).to(td), torch.from_numpy(norm).to(td), state,
        chunk=s.chunk, eps=tcfg.norm_eps)
    assert ts is state and ty.dtype == td and ty.shape == (B, S, H, P)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **FP32)
    if dtype == "float32":
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FP32)
    else:
        want = _t(jy).numpy()
        assert np.abs(ty.float().numpy() - want).max() <= \
            BF16_Y * max(1.0, float(np.abs(want).max()))


def test_ssd_ref_in_float64_bounds_the_fp32_ssd():
    """``ssd_ref(acc=float64)``: the same function in float64 (the
    tolerance's magnitudes come from it), within fp32's roundoff of the
    fp32 spelling."""
    rng = np.random.default_rng(4)
    B, S, H, P, N = 1, 50, 4, 16, 16
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, S, H, P), (B, S, H), (H,), (B, S, 1, N),
                      (B, S, 1, N), (B, H, P, N))]
    args[1] = torch.nn.functional.softplus(args[1])
    y32, s32 = mk.ssd_ref(*args, chunk=16)
    y64, s64 = mk.ssd_ref(*args, chunk=16, acc=torch.float64)
    assert y64.dtype == torch.float64 and y32.dtype == torch.float32
    torch.testing.assert_close(y32.double(), y64, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s32.double(), s64, rtol=1e-5, atol=1e-5)


def test_lane_sum_is_the_kernels_order():
    """``lane_sum``: lanes of consecutive values each summed from its
    first, then adjacent lanes added pairwise, zeros past the values."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    got = mk.lane_sum(v, 4)[:, 0]
    pad = torch.nn.functional.pad(v, (0, 14))
    for r in range(3):
        lanes = []
        for q in range(4):
            acc = pad[r, 16 * q]
            for i in range(1, 16):
                acc = acc + pad[r, 16 * q + i]
            lanes.append(acc)
        want = (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])
        assert torch.equal(got[r], want)
    assert mk.lane_sum(v, 16).shape == (3, 1)


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


STAGES = ((0, 37, "prefill"), (37, 43, "extend"), (43, 44, "decode"),
          (44, 45, "decode"))


def _forward(tm, toks, fused: bool):
    cache, out = tm.init_cache(1, 64), []
    for lo, hi, mode in STAGES:
        cl = torch.full((1,), lo) if mode == "decode" else lo
        lg, cache = tm.forward(torch.from_numpy(toks[:, lo:hi]), cache=cache,
                               cache_len=cl, mode=mode, fused=fused)
        out.append(lg)
    return out, cache


def test_fused_model_matches_jax_and_plain(pair, kernel_route):
    """zamba2 smoke through prefill (37 tokens, not a whole number of
    16-token chunks), extend (6) and two decode steps with
    ``fused=True`` through the route (the Mamba2 kernels' plain versions,
    no launch): against the JAX model as ``tests/test_torch_mamba2.py``
    holds the plain spelling (fp32 rtol 2e-5 / atol 5e-4; bf16 argmax
    equal, within 1e-2), and against ``fused=False``: bf16 logits and
    conv states bit-equal, the fp32 SSM states within fp32's tolerance
    (the SSD summed in the kernels' order)."""
    dtype, jm, jp, tm = pair
    toks = np.random.default_rng(0).integers(0, jm.cfg.vocab_size, (1, 45))
    before = launch_counts()
    fused, fc = _forward(tm, toks, True)
    plain, pc = _forward(tm, toks, False)
    assert launch_counts() == before
    jc = jm.init_cache(1, 64)
    for (lo, hi, mode), lf, lp in zip(STAGES, fused, plain):
        cl = jnp.full((1,), lo, jnp.int32) if mode == "decode" else lo
        lj, jc = jm.forward(jp, tokens=jnp.asarray(toks[:, lo:hi]),
                            cache=jc, cache_len=cl, mode=mode)
        lj = np.asarray(lj)
        if dtype == "float32":
            np.testing.assert_allclose(lf.numpy(), lj, err_msg=mode, **FP32)
            np.testing.assert_allclose(lf.numpy(), lp.numpy(), err_msg=mode,
                                       **FP32)
        else:
            assert np.array_equal(lj.argmax(-1), lf.numpy().argmax(-1))
            assert np.abs(lj - lf.numpy()).max() <= 1e-2, mode
            assert torch.equal(lf, lp), mode
    np.testing.assert_allclose(fc["ssm"].numpy(), pc["ssm"].numpy(), **FP32)
    if dtype == "float32":
        np.testing.assert_allclose(fc["ssm"].numpy(), np.asarray(jc["ssm"]),
                                   **FP32)
    else:
        assert np.abs(fc["ssm"].numpy() - np.asarray(jc["ssm"])).max() \
            <= 1e-2
        assert torch.equal(fc["conv"], pc["conv"])


def test_fused_on_the_cpu_keeps_the_plain_bits(pair):
    """CPU tensors never take the kernels' route: zamba2 smoke's
    ``fused=True`` through prefill, extend and two decode steps gives
    ``fused=False``'s logits and caches bit for bit, no launch."""
    dtype, jm, _, tm = pair
    toks = np.random.default_rng(1).integers(0, jm.cfg.vocab_size, (1, 45))
    before = launch_counts()
    fused, fc = _forward(tm, toks, True)
    plain, pc = _forward(tm, toks, False)
    assert launch_counts() == before
    assert all(torch.equal(a, b) for a, b in zip(fused, plain))
    assert all(torch.equal(fc[k], pc[k]) for k in pc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_fused_decode_step_states_equal_the_plain_steps(geometry, dtype,
                                                       kernel_route):
    """One layer's decode step from one conv and SSM state through
    ``mamba_apply`` with ``fused=True`` and with ``fused=False``: every
    op of the new states is elementwise, so both are bit-equal; the
    outputs within fp32's tolerance (the readout and the norm in the
    kernels' orders), in bf16 within 1e-2 of the normed y's size."""
    _, tcfg = _cfgs(geometry, dtype)
    td = getattr(torch, dtype)
    p = {k: torch.from_numpy(v).to(td)
         for k, v in _layer(tcfg, dtype, seed=3).items()}
    st = _state(tcfg, 3, dtype, seed=4)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 1, tcfg.d_model)).astype(np.float32)).to(td)
    out = {}
    for fused in (False, True):
        state = {"conv": torch.from_numpy(st["conv"].copy()).to(td),
                 "ssm": torch.from_numpy(st["ssm"].copy())}
        out[fused] = mamba2.mamba_apply(p, x, tcfg, state, "decode",
                                        fused=fused)
    for k in ("conv", "ssm"):
        assert torch.equal(out[True][1][k], out[False][1][k]), k
    a, b = out[True][0].float(), out[False][0].float()
    if dtype == "float32":
        torch.testing.assert_close(a, b, **FP32)
    else:
        assert (a - b).abs().max() <= BF16_Y * max(1.0, b.abs().max())


def test_mamba_apply_routes_by_mode_and_switch(monkeypatch):
    """``mamba_apply``: ``fused`` sends a one-token decode step to
    ``mamba2_step`` and every other serving call to ``ssd_chunk`` once
    the route takes the tensors' device; ``fused=False``, training and
    CPU tensors (before the route is opened to them) never reach
    them."""
    calls = []
    for name in ("mamba2_step", "ssd_chunk"):
        inner = getattr(mk, name)
        monkeypatch.setattr(mk, name, lambda *a, _n=name, _f=inner, **k: (
            calls.append(_n), _f(*a, **k))[1])
    cfg = get_config(ARCH, smoke=True)
    tcfg = dataclasses.replace(cfg, compute_dtype="float32")
    p = {k: torch.from_numpy(v) for k, v in _layer(tcfg, "float32").items()}
    st = {k: torch.from_numpy(v) for k, v in _state(tcfg, 2,
                                                     "float32").items()}
    x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    for mode in ("decode", "prefill"):
        mamba2.mamba_apply(p, x, tcfg, {k: v.clone() for k, v in st.items()},
                           mode, fused=True)
    assert calls == []
    monkeypatch.setattr(mamba2, "_KERNEL_DEVICE", "cpu")
    for mode, S, fused, want in (("decode", 1, True, ["mamba2_step"]),
                                 ("decode", 3, True, ["ssd_chunk"]),
                                 ("extend", 1, True, ["ssd_chunk"]),
                                 ("prefill", 3, True, ["ssd_chunk"]),
                                 ("decode", 1, False, []),
                                 ("prefill", 3, False, []),
                                 ("train", 3, True, [])):
        calls.clear()
        mamba2.mamba_apply(p, x.expand(2, S, -1).contiguous(), tcfg,
                           {k: v.clone() for k, v in st.items()}, mode,
                           fused=fused)
        assert calls == want, (mode, S, fused)
    calls.clear()
    mamba2.mamba_apply(p, x, tcfg, None, "prefill", fused=True)
    assert calls == ["ssd_chunk"]


def test_hybrid_copies_no_state_the_kernels_updated(monkeypatch,
                                                    kernel_route):
    """``Model._hybrid`` writes back only a state the layer returned anew:
    with ``fused=True`` the decode step's conv and SSM states and the
    prompt's SSM state are the cache's own slices, left uncopied."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True),
                              compute_dtype="float32")
    tm = Model(cfg, device="cpu", seed=0)
    seen = []
    inner = mamba2.mamba_apply

    def spy(p, x, cfg_, state, mode, fused=False):
        out, new = inner(p, x, cfg_, state, mode, fused=fused)
        seen.append({k: new[k] is state[k] for k in new})
        return out, new

    monkeypatch.setattr(mamba2, "mamba_apply", spy)
    cache = tm.init_cache(1, 24)
    toks = torch.arange(20).reshape(1, 20) % cfg.vocab_size
    tm.forward(toks, cache=cache, fused=True)
    assert seen and all(s == {"conv": False, "ssm": True} for s in seen)
    seen.clear()
    tm.forward(toks[:, :1], cache=cache, cache_len=torch.full((1,), 20),
               mode="decode", fused=True)
    assert seen and all(s == {"conv": True, "ssm": True} for s in seen)


# ------------------------------------------------- a row alone, in a batch
@pytest.mark.parametrize("kernel", ["step", "chunk"])
def test_row_alone_equals_the_row_in_a_batch(kernel):
    """bf16, smoke widths: row 1 of a B = 3 call and the same row alone
    give the same bits (y and states)."""
    w = dict(H=8, P=16, N=16, G=1, K=4, chunk=16)
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=gen).to(torch.bfloat16)  # noqa
    C = 128 + 32
    prm = dict(conv_w=rnd(4, C) * 0.3, conv_b=rnd(C), dt_bias=rnd(8) - 1,
               A_log=rnd(8), D=rnd(8) + 1, norm=rnd(8, 16) * 0.1)
    if kernel == "step":
        batch = dict(z=rnd(3, 8, 16), x=rnd(3, 128), bm=rnd(3, 16),
                     cm=rnd(3, 16), dt=rnd(3, 8))
        cs, ss = rnd(3, 3, C), torch.randn(3, 8, 16, 16, generator=gen)
        y = mk.mamba2_step_ref(**batch, **prm, conv_state=cs.clone(),
                               ssm_state=(s3 := ss.clone()), eps=1e-5)
        one = {k: v[1:2].clone() for k, v in batch.items()}
        y1 = mk.mamba2_step_ref(**one, **prm, conv_state=cs[1:2].clone(),
                                ssm_state=(s1 := ss[1:2].clone()), eps=1e-5)
        assert torch.equal(y1[0], y[1]) and torch.equal(s1[0], s3[1])
    else:
        S = 37
        xr, z = rnd(3, S, 8, 16), rnd(3, S, 8, 16)
        Bm, Cm = rnd(3, S, 1, 16), rnd(3, S, 1, 16)
        dt = torch.nn.functional.softplus(torch.randn(3, S, 8,
                                                      generator=gen))
        s0 = torch.randn(3, 8, 16, 16, generator=gen)
        args = (prm["A_log"],)
        y, st = mk.ssd_chunk_ref(xr, dt, *args, Bm, Cm, z, prm["D"],
                                 prm["norm"], s0.clone(), chunk=16,
                                 eps=1e-5)
        y1, s1 = mk.ssd_chunk_ref(xr[1:2].clone(), dt[1:2].clone(), *args,
                                  Bm[1:2].clone(), Cm[1:2].clone(),
                                  z[1:2].clone(), prm["D"], prm["norm"],
                                  s0[1:2].clone(), chunk=16, eps=1e-5)
        assert torch.equal(y1[0], y[1]) and torch.equal(s1[0], st[1])


# --------------------------------------------------------- the planner
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_planner_decides_from_the_config_alone(arch):
    """``takes_mamba2_launch`` at every config: zamba2's Mamba2 layers in
    bf16 and fp32 (at full width and at smoke width), nothing else, and
    never an fp16 activation."""
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        want = cfg.family == "hybrid"
        assert mk.takes_mamba2_launch(cfg, torch.bfloat16) is want
        assert mk.takes_mamba2_launch(cfg, torch.float32) is want
        assert mk.takes_mamba2_launch(cfg, torch.float16) is False


def test_route_takes_the_kernels_device_alone(monkeypatch):
    """``_takes_kernels``: ``fused``, a serving mode, widths the kernels
    take and a tensor on the kernels' device (CUDA); a CPU or meta
    tensor keeps the plain spelling, and so does training."""
    cfg = get_config(ARCH, smoke=True)
    cpu = torch.zeros(2, 1, cfg.d_model, dtype=torch.bfloat16)
    meta = cpu.to("meta")
    for x in (cpu, meta):
        assert not mamba2._takes_kernels(True, x, cfg, "decode")
    monkeypatch.setattr(mamba2, "_KERNEL_DEVICE", "meta")
    assert mamba2._takes_kernels(True, meta, cfg, "decode")
    assert mamba2._takes_kernels(True, meta, cfg, "prefill")
    assert not mamba2._takes_kernels(False, meta, cfg, "decode")
    assert not mamba2._takes_kernels(True, meta, cfg, "train")
    assert not mamba2._takes_kernels(True, cpu, cfg, "decode")
    assert not mamba2._takes_kernels(True, meta.half(), cfg, "decode")


@pytest.mark.parametrize("widths,why", [
    (dict(P=65), "head dim"), (dict(P=0), "head dim"),
    (dict(N=24), "state N"), (dict(N=80), "state N"),
    (dict(G=3), "groups"), (dict(d_conv=1), "d_conv"),
    (dict(d_conv=9), "d_conv"), (dict(chunk=0), "chunk"),
    (dict(chunk=65), "chunk"), (dict(dtype=torch.float16), "bfloat16"),
    (dict(G=0), "groups"), (dict(H=4, G=8), "groups")])
def test_refusals_name_their_reason(widths, why):
    """``mamba2_refusal``: every width outside the domain refused with its
    reason."""
    args = dict(H=8, P=16, N=16, G=1, d_conv=4, chunk=16,
                dtype=torch.bfloat16)
    assert mk.mamba2_refusal(**args) is None
    assert why in mk.mamba2_refusal(**dict(args, **widths))


def _step_args(B=2, H=8, P=16, N=16, G=1, K=4, dtype=torch.bfloat16):
    C = H * P + 2 * G * N
    t = lambda *s: torch.zeros(s, dtype=dtype)                # noqa: E731
    return dict(z=t(B, H, P), x=t(B, H * P), bm=t(B, G * N),
                cm=t(B, G * N), dt=t(B, H), conv_w=t(K, C), conv_b=t(C),
                dt_bias=t(H), A_log=t(H), D=t(H), norm=t(H, P),
                conv_state=t(B, K - 1, C),
                ssm_state=torch.zeros(B, H, P, N), eps=1e-5)


def _chunk_args(B=2, S=20, H=8, P=16, N=16, G=1, dtype=torch.bfloat16):
    t = lambda *s: torch.zeros(s, dtype=dtype)                # noqa: E731
    conv = t(B, S, H * P + 2 * G * N)
    return dict(xr=conv[..., :H * P].unflatten(-1, (H, P)),
                dt=torch.zeros(B, S, H), A_log=t(H),
                Bm=conv[..., H * P:H * P + G * N].unflatten(-1, (G, N)),
                Cm=conv[..., H * P + G * N:].unflatten(-1, (G, N)),
                z=t(B, S, H, P), D=t(H), norm=t(H, P),
                state=torch.zeros(B, H, P, N), chunk=16, eps=1e-5)


@pytest.mark.parametrize("kernel,edit", [
    ("step", lambda a: a.update(z=a["z"][:, :, :8])),
    ("step", lambda a: a.update(x=a["x"][:, :64])),
    ("step", lambda a: a.update(ssm_state=a["ssm_state"].double())),
    ("step", lambda a: a.update(conv_state=a["conv_state"].float())),
    ("step", lambda a: a.update(conv_w=a["conv_w"][:3])),
    ("step", lambda a: a.update(conv_state=a["conv_state"].transpose(
        1, 2).contiguous().transpose(1, 2))),
    ("step", lambda a: a.update(_step_args(P=80))),
    ("step", lambda a: a.update(_step_args(dtype=torch.float16))),
    ("step", lambda a: a.update(_step_args(K=9))),
    ("chunk", lambda a: a.update(xr=a["xr"].transpose(2, 3))),
    ("chunk", lambda a: a.update(dt=a["dt"].to(torch.bfloat16))),
    ("chunk", lambda a: a.update(z=a["z"][:, :5])),
    ("chunk", lambda a: a.update(state=a["state"][:, :4])),
    ("chunk", lambda a: a.update(chunk=65)),
    ("chunk", lambda a: a.update(_chunk_args(S=0))),
    ("chunk", lambda a: a.update(_chunk_args(N=8))),
    ("chunk", lambda a: a.update(_chunk_args(G=3))),
    ("step", lambda a: None), ("chunk", lambda a: None)])
def test_wrappers_refuse_before_any_launch(monkeypatch, kernel, edit):
    """Each wrapper raises ``ValueError`` on shapes, dtypes, layouts and
    widths the kernel does not take, before it builds or launches
    anything; well-formed CPU tensors are refused too (a CUDA tensor
    only), also before any launch."""
    def no_build(*a, **k):
        raise AssertionError("built or launched")

    monkeypatch.setattr(_build, "function", no_build)
    args = _step_args() if kernel == "step" else _chunk_args()
    edit(args)
    fn = mk.mamba2_step_kernel if kernel == "step" else mk.ssd_chunk_kernel
    before = launch_counts()
    if kernel == "chunk":
        pos = [args.pop(k) for k in ("xr", "dt", "A_log", "Bm", "Cm", "z",
                                     "D", "norm", "state")]
    with pytest.raises(ValueError):
        if kernel == "step":
            fn(**args)
        else:
            fn(*pos, **args)
    assert launch_counts() == before


def test_ops_send_cpu_tensors_to_the_plain_versions():
    """``ops``: a CPU tensor takes the plain version (the same bits),
    another device raises."""
    args = _step_args(dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    for k, v in args.items():
        if isinstance(v, torch.Tensor):
            v.copy_(torch.randn(v.shape, generator=gen))
    a, b = ({k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in args.items()} for _ in range(2))
    assert torch.equal(mk.mamba2_step(**a), mk.mamba2_step_ref(**b))
    assert torch.equal(a["ssm_state"], b["ssm_state"])
    with pytest.raises(ValueError, match="unsupported device"):
        mk.ops._plain(type("T", (), {"device": torch.device("mps")})(), "x")


# ------------------------------------------------ the source and binding
def test_source_constants_match_the_host():
    """kernel.py's constants are csrc/mamba2.cu's, and each ctypes list
    has its C entry point's parameter count."""
    src = (ROOT / "src/repro_torch/csrc/mamba2.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = ([0-9]+);",
                             src).group(1))

    assert const("kDim") == mkernel.MAX_DIM
    assert const("kMaxConv") == mkernel.MAX_CONV
    assert const("kDim") // const("kRowLanes") == mkernel.STATE_LANE
    assert "kLd = kDim + 4" in src and mkernel.TILE_LD == 68
    assert "kChunkSmem = (6 * kDim * kLd + 4 * kDim) * 4" in src
    # the decode step: one head a CTA, its state row in static shared
    # memory
    assert "dim3(prm.H / prm.G, prm.G, B), kThreads, 0, stream" in src
    assert "float st[kDim * kDim];" in src
    for entry, args in (("mamba2_step_launch", mkernel._STEP_ARGS),
                        ("ssd_chunk_launch", mkernel._CHUNK_ARGS)):
        sig = re.search(rf"int {entry}\((.*?)\) {{", src, re.S).group(1)
        assert len(sig.split(",")) == len(args), entry


def test_wrappers_and_build_name_both_kernels():
    """Both wrappers count launches among the port's kernels, and the
    build compiles ``csrc/mamba2.cu`` with the others."""
    wrappers = kernel_wrappers()
    assert wrappers["mamba2_step"] is mk.mamba2_step_kernel
    assert wrappers["ssd_chunk"] is mk.ssd_chunk_kernel
    assert "mamba2" in _build.SOURCES
    assert (_build.CSRC / "mamba2.cu").exists()


def test_work_counts_at_path_es_shapes():
    """The bounds' counts: the decode step at B 2 moves its fp32 state
    twice (5.24 MB of ~5.3 MB); the prompt's SSD at B 2 x 2000 tokens
    does the causal products of 31 whole chunks and a 16-token tail."""
    nbytes, flops = mkernel.step_work(2, 80, 64, 64, 1, 4, 2)
    assert 2 * 2 * 80 * 64 * 64 * 4 < nbytes < 5.6e6
    assert flops > 5 * 2 * 80 * 64 * 64
    nbytes, flops = mkernel.chunk_work(2, 2000, 80, 64, 64, 1, 64, 2)
    per = 31 * (64 * 65 * 128 + 4 * 64 * 4096) + 16 * 17 * 128 \
        + 4 * 16 * 4096
    assert flops == 2 * 80 * per
    assert nbytes == 2 * 2000 * (3 * 80 * 64 + 2 * 64) * 2 + \
        4 * 2 * 2000 * 80 + 8 * 2 * 80 * 64 * 64


def test_profile_step_splits_out_the_mixer():
    """``profile_step.device_parts``: the two kernels are "ssm" by name;
    an op launched inside ``mamba_apply`` is "ssm" unless its name gives
    it another part (the mixer's products stay products); attention's
    marks take any op."""
    from repro_torch.launch import profile_step as ps
    events = [(0, "void (anonymous namespace)::mamba2_step_kernel<bf16>",
               1000), (1, "nvjet_tst_gemm", 2000),
              (2, "vectorized_elementwise_kernel exp", 3000),
              (3, "vectorized_elementwise_kernel add", 500),
              (4, "void ssd_chunk_kernel<float>", 700),
              (5, "nvjet_tst_gemm", 400)]
    marks = [(name, mark) for (_, name, _), mark in zip(
        events, (None, "ssm", "ssm", None, "ssm", "attention"))]
    parts, walk = ps.device_parts(events, 1, marks)
    assert parts["ssm"] == pytest.approx((1000 + 3000 + 700) / 1e6)
    assert parts["products"] == pytest.approx(2000 / 1e6)
    assert parts["attention"] == pytest.approx(400 / 1e6)
    assert parts["other"] == pytest.approx(500 / 1e6)
    assert walk["eager_marked"] == 4 and walk["aligned_ops"] == 6
    assert ("ssm", "mamba2", ("mamba_apply",)) in ps.MARKED
