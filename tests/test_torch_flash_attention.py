"""The port's flash attention on CPU tensors (its plain PyTorch version)
against the JAX package's Pallas ``flash_attention`` run in interpret mode
and its ``flash_attention_ref``, on the same numpy inputs: the sweep of
the JAX package's own kernel tests (D=80 included), sliding window and
softcap, and lengths that are not a multiple of any tile. The model's
prefill dispatch point, ``attend_causal``, keeps its CPU arithmetic: in
bf16 it agrees with the JAX package's to two bf16 ulps, on at most one
element in a thousand (the two frameworks' bf16 matmuls round a few sums
differently, and the bf16 accumulator of the online merge is rounded
again before the final division).

Tolerances: fp32 2e-5 (both sides are an fp32 softmax over the same
scores; they differ only in summation order), bf16 2e-2 (one bf16
rounding of the output), the bounds of the JAX package's kernel tests.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention import flash_attention_ref as jax_ref
from repro.models.attention import attend_causal as jax_attend_causal
from repro_torch.kernels import _build, kernel_wrappers, launch_counts
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_kernel,
                                                 flash_attention_ref)
from repro_torch.models.attention import attend_causal

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol_for(dtype: str) -> dict:
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def both(x: np.ndarray, dtype: str = "float32"):
    """The same numpy values as a JAX array and a CPU torch tensor in
    ``dtype`` (both round to nearest-even, so bf16 bits agree)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(np.array(x)).to(td)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def qkv(B, H, KV, S, D, dtype="float32", seed=7):
    rng = np.random.default_rng(seed)
    return [both(rng.standard_normal(shape).astype(np.float32), dtype)
            for shape in ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))]


@pytest.mark.parametrize("B,H,KV,S,D", [
    (2, 4, 2, 256, 64), (1, 8, 8, 128, 128), (2, 2, 1, 512, 64),
    (1, 4, 4, 256, 80),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_sweep(B, H, KV, S, D, dtype):
    (qj, qt), (kj, kt), (vj, vt) = qkv(B, H, KV, S, D, dtype)
    out = flash_attention(qt, kt, vt)
    assert out.dtype == DTYPES[dtype][1] and out.shape == (B, H, S, D)
    pallas = jax_flash(qj, kj, vj, block_q=128, block_k=128, interpret=True)
    np.testing.assert_allclose(as_np(out), as_np(pallas), **tol_for(dtype))
    np.testing.assert_allclose(as_np(out), as_np(jax_ref(qj, kj, vj)),
                               **tol_for(dtype))


@pytest.mark.parametrize("window,softcap", [(64, 0.0), (0, 30.0),
                                            (128, 50.0)])
def test_window_and_softcap(window, softcap):
    (qj, qt), (kj, kt), (vj, vt) = qkv(1, 4, 2, 256, 64)
    out = flash_attention(qt, kt, vt, window=window, softcap=softcap)
    pallas = jax_flash(qj, kj, vj, window=window, softcap=softcap,
                       block_q=64, block_k=64, interpret=True)
    ref = jax_ref(qj, kj, vj, window=window, softcap=softcap)
    np.testing.assert_allclose(as_np(out), as_np(pallas), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(as_np(out), as_np(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S,D,window,softcap", [
    (1, 64, 0, 0.0), (37, 80, 0, 0.0), (200, 80, 0, 0.0),
    (130, 256, 48, 50.0), (77, 8, 0, 0.0)])
def test_ragged_lengths_match_reference(S, D, window, softcap):
    """Lengths the TPU kernel's tiling refuses (S % block != 0): the CUDA
    kernel masks its ragged tiles, and its plain version takes any S."""
    (qj, qt), (kj, kt), (vj, vt) = qkv(2, 4, 2, S, D)
    out = flash_attention(qt, kt, vt, window=window, softcap=softcap)
    ref = jax_ref(qj, kj, vj, window=window, softcap=softcap)
    np.testing.assert_allclose(as_np(out), as_np(ref), rtol=2e-5, atol=2e-5)


def test_non_causal_and_scale():
    (qj, qt), (kj, kt), (vj, vt) = qkv(1, 4, 2, 96, 64)
    out = flash_attention(qt, kt, vt, causal=False, scale=0.3)
    ref = jax_ref(qj, kj, vj, causal=False, scale=0.3)
    np.testing.assert_allclose(as_np(out), as_np(ref), rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    (_, qt), (_, kt), (_, vt) = qkv(1, 4, 2, 64, 16)
    assert torch.equal(flash_attention(qt, kt, vt),
                       flash_attention_ref(qt, kt, vt))
    with pytest.raises(ValueError):
        flash_attention_kernel(qt, kt, vt)
    assert launch_counts() == {name: 0 for name in kernel_wrappers()}
    assert not _build._libs


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("S,cap,chunk", [(96, 0.0, 64), (300, 0.0, 64),
                                         (64, 30.0, 64), (300, 0.0, 1024)])
def test_attend_causal_cpu_matches_jax_bf16(S, cap, chunk):
    """The CPU blocked path of the model's dispatch point is unchanged:
    bf16 in, the JAX package's bf16 out to within two ulps, with at most
    one element in a thousand differing at all."""
    rng = np.random.default_rng(S)
    B, H, KV, Dh = 2, 6, 2, 16
    arrs = [rng.standard_normal((B, S, n, Dh)).astype(np.float32)
            for n in (H, KV, KV)]
    (qj, qt), (kj, kt), (vj, vt) = (both(a, "bfloat16") for a in arrs)
    out = attend_causal(qt, kt, vt, scale=0.25, cap=cap, q_chunk=chunk,
                        kv_chunk=chunk)
    ref = jax_attend_causal(qj, kj, vj, scale=0.25, cap=cap, q_chunk=chunk,
                            kv_chunk=chunk)
    assert out.dtype == torch.bfloat16
    a, b = as_np(out), as_np(ref)
    diff = np.abs(a - b)
    assert (diff <= 2 * bf16_ulp(np.maximum(np.abs(a), np.abs(b)))).all()
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("S,cap", [(80, 0.0), (200, 30.0)])
def test_attend_causal_is_the_flash_function(S, cap):
    """What the kernel replaces on the card: in fp32 the model's blocked
    attention (model layout (B,S,H,Dh)) and the flash plain version (JAX
    layout (B,H,S,Dh)) compute one function, within 2e-5."""
    rng = np.random.default_rng(S)
    B, H, KV, Dh = 2, 6, 3, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, n, Dh))
                                .astype(np.float32)) for n in (H, KV, KV))
    out = attend_causal(q, k, v, scale=0.2, cap=cap, q_chunk=64,
                        kv_chunk=64)
    ref = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), scale=0.2, softcap=cap)
    np.testing.assert_allclose(out.numpy(), ref.transpose(1, 2).numpy(),
                               rtol=2e-5, atol=2e-5)


def attention_p_bf16(q, k, v, *, window=0, softcap=0.0):
    """Plain attention with the one rounding the tensor-core kernel adds:
    the unnormalised probabilities P are rounded to bf16 before P.V (the
    wgmma A operand), while the row sums l stay fp32 and unrounded. q
    (B, H, S, D), k/v (B, KV, S, D), bf16 -> bf16."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    qg = q.float().reshape(B, KV, H // KV, S, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / D ** 0.5
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(S)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bkgst,bktd->bkgsd", p.bfloat16().float(), v.float())
    return (o / p.sum(-1, keepdim=True)).reshape(B, H, S, D).bfloat16()


@pytest.mark.parametrize("D,window,softcap", [
    (80, 0, 0.0), (128, 0, 0.0), (256, 0, 0.0), (256, 96, 50.0),
    (128, 64, 30.0)])
def test_bf16_probabilities_stay_within_the_chip_tolerance(D, window,
                                                           softcap):
    """The tensor-core kernel's numerics, P rounded to bf16, against the
    JAX package's Pallas kernel (P in fp32) in interpret mode: within
    1e-2, the tolerance ``chip_smoke.py`` phase 2 holds the kernel to."""
    (qj, qt), (kj, kt), (vj, vt) = qkv(1, 4, 2, 256, D, "bfloat16", seed=D)
    out = attention_p_bf16(qt, kt, vt, window=window, softcap=softcap)
    pallas = jax_flash(qj, kj, vj, window=window, softcap=softcap,
                       block_q=128, block_k=128, interpret=True)
    err = np.abs(as_np(out) - as_np(pallas)).max()
    print(f"D={D} window={window} softcap={softcap}: max |P-in-bf16 - "
          f"Pallas| = {err:.3g}")
    np.testing.assert_allclose(as_np(out), as_np(pallas), rtol=1e-2,
                               atol=1e-2)
