"""The port's kernel functions on CPU tensors (their plain PyTorch
versions) against the JAX package's kernels run in Pallas interpret mode,
on the same numpy inputs: the decode-attention sweep, TTL-hit page reuse,
ragged tables with garbage padding, padding-width invariance, residuals,
the layer-stacked pool, and the page gather / scatter / copy / append.

Tolerances: page moves are bit-exact. Decode attention differs from the
Pallas kernel only in fp32 summation order (one dense softmax per row vs
an online softmax over pages): 2e-5 on fp32 inputs, and on bf16 inputs
2e-2, one bf16 rounding of the output (the bound the JAX package's own
kernel tests use).
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import (
    paged_decode_attention as jax_decode,
    sanitize_block_tables as jax_sanitize)
from repro.kernels.page_copy import (append_tokens as jax_append,
                                     copy_pages as jax_copy,
                                     gather_pages as jax_gather,
                                     scatter_pages as jax_scatter)
from repro_torch.kernels import launch_counts
from repro_torch.kernels.decode_attention import (paged_decode_attention,
                                                  sanitize_block_tables)
from repro_torch.kernels.flash_attention.kernel import (MAX_STAGES,
                                                        SMEM_PER_BLOCK,
                                                        STATIC_SMEM,
                                                        plan_bf16,
                                                        tma_strides)
from repro_torch.kernels.page_copy import (append_tokens, copy_pages,
                                           gather_pages, scatter_pages)

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


class TestPagedDecode:
    @pytest.mark.parametrize("B,H,KV,D,page,npages", [
        (2, 8, 2, 64, 16, 8), (3, 4, 4, 128, 32, 4), (1, 16, 1, 64, 64, 2),
        (4, 6, 2, 8, 8, 3), (2, 12, 2, 128, 16, 4),
    ])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_sweep(self, B, H, KV, D, page, npages, dtype):
        rng = np.random.default_rng(B * 1000 + D + page)
        P = npages * B + 8
        qj, qt = both(rng.normal(size=(B, H, D)), dtype)
        kj, kt = both(rng.normal(size=(P, page, KV, D)), dtype)
        vj, vt = both(rng.normal(size=(P, page, KV, D)), dtype)
        tabs = np.stack([rng.permutation(P)[:npages] for _ in range(B)]
                        ).astype(np.int32)
        lens = rng.integers(1, npages * page + 1, size=B).astype(np.int32)
        out_j = jax_decode(qj, kj, vj, jnp.asarray(tabs), jnp.asarray(lens))
        out_t = paged_decode_attention(qt, kt, vt, torch.from_numpy(tabs),
                                       torch.from_numpy(lens))
        assert out_t.dtype == qt.dtype and out_t.shape == qt.shape
        np.testing.assert_allclose(as_np(out_t), as_np(out_j),
                                   **tol_for(dtype))

    def test_ttl_hit_reuses_physical_pages(self):
        """A returning turn whose pages were pinned passes the same
        scattered physical ids: attention equals the contiguous layout of
        the same logical KV, and the JAX kernel's result."""
        rng = np.random.default_rng(1)
        B, H, KV, D, page, P = 1, 4, 2, 64, 16, 16
        q = torch.from_numpy(rng.normal(size=(B, H, D)).astype(np.float32))
        kp = torch.from_numpy(rng.normal(size=(P, page, KV, D)).astype(
            np.float32))
        vp = torch.from_numpy(rng.normal(size=(P, page, KV, D)).astype(
            np.float32))
        scattered = torch.tensor([[7, 3, 11, 0]], dtype=torch.int32)
        lens = torch.tensor([64], dtype=torch.int32)
        out_pinned = paged_decode_attention(q, kp, vp, scattered, lens)
        kp2 = torch.cat([kp[scattered[0].long()], kp[4:]])
        vp2 = torch.cat([vp[scattered[0].long()], vp[4:]])
        out_fresh = paged_decode_attention(
            q, kp2, vp2, torch.tensor([[0, 1, 2, 3]], dtype=torch.int32),
            lens)
        np.testing.assert_allclose(out_pinned.numpy(), out_fresh.numpy(),
                                   atol=1e-6)
        out_j = jax_decode(jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()),
                           jnp.asarray(vp.numpy()),
                           jnp.asarray(scattered.numpy()),
                           jnp.asarray(lens.numpy()))
        np.testing.assert_allclose(out_pinned.numpy(), as_np(out_j),
                                   rtol=2e-5, atol=2e-5)


class TestRaggedBlockTables:
    """Dead table slots may hold anything: the kernel reads live slots
    only, and the plain version sanitizes dead ones to page 0."""

    def _inputs(self, B=3, H=4, KV=2, D=32, page=8, P=12):
        rng = np.random.default_rng(42)
        q = rng.normal(size=(B, H, D)).astype(np.float32)
        kp = rng.normal(size=(P, page, KV, D)).astype(np.float32)
        vp = rng.normal(size=(P, page, KV, D)).astype(np.float32)
        lens = np.asarray([5, 0, 25], np.int32)     # 1 / 0 / 4 live pages
        clean = np.asarray([[1, 0, 0, 0],
                            [0, 0, 0, 0],
                            [2, 3, 4, 5]], np.int32)
        return q, kp, vp, clean, lens, page, P

    def test_sanitizer_matches_jax(self):
        _, _, _, clean, lens, page, _ = self._inputs()
        garbage = clean.copy()
        garbage[0, 1:] = [999, -7, 2 ** 30]
        garbage[1, :] = -1
        out_t = sanitize_block_tables(torch.from_numpy(garbage),
                                      torch.from_numpy(lens), page)
        out_j = jax_sanitize(jnp.asarray(garbage), jnp.asarray(lens), page)
        assert np.array_equal(out_t.numpy(), clean)
        assert np.array_equal(out_t.numpy(), np.asarray(out_j))

    def test_garbage_padding_is_harmless(self):
        """Garbage in dead slots gives bit-identical output to the clean
        sentinel-padded table, and matches the JAX kernel."""
        q, kp, vp, clean, lens, page, P = self._inputs()
        garbage = clean.copy()
        garbage[0, 1:] = [P + 5, 2 ** 28, -3]
        garbage[1, :] = [-1, P, P + 1, 2 ** 30]
        args = [torch.from_numpy(a) for a in (q, kp, vp)]
        out_clean = paged_decode_attention(*args, torch.from_numpy(clean),
                                           torch.from_numpy(lens))
        out_garbage = paged_decode_attention(*args, torch.from_numpy(garbage),
                                             torch.from_numpy(lens))
        assert torch.equal(out_clean, out_garbage)
        out_j = jax_decode(*[jnp.asarray(a) for a in (q, kp, vp, garbage,
                                                     lens)])
        np.testing.assert_allclose(out_clean.numpy(), as_np(out_j),
                                   rtol=2e-5, atol=2e-5)

    def test_padding_width_invariance(self):
        """Extra dead sentinel slots change no row bitwise."""
        q, kp, vp, clean, lens, page, _ = self._inputs()
        wide = np.concatenate([clean, np.zeros((3, 4), np.int32)], axis=1)
        args = [torch.from_numpy(a) for a in (q, kp, vp)]
        out_narrow = paged_decode_attention(*args, torch.from_numpy(clean),
                                            torch.from_numpy(lens))
        out_wide = paged_decode_attention(*args, torch.from_numpy(wide),
                                          torch.from_numpy(lens))
        assert torch.equal(out_narrow, out_wide)

    def test_residuals_match_jax(self):
        """return_residuals: the unnormalized (acc, m, l) agree with the
        Pallas kernel's, and a zero-length row is exactly m=-2e38, l=0,
        acc=0."""
        q, kp, vp, clean, lens, page, _ = self._inputs()
        acc, m, l = paged_decode_attention(
            *[torch.from_numpy(a) for a in (q, kp, vp, clean, lens)],
            return_residuals=True)
        assert acc.dtype == m.dtype == l.dtype == torch.float32
        assert (m[1] == -2.0e38).all() and (l[1] == 0).all() \
            and (acc[1] == 0).all()
        acc_j, m_j, l_j = jax_decode(
            *[jnp.asarray(a) for a in (q, kp, vp, clean, lens)],
            return_residuals=True)
        np.testing.assert_allclose(m.numpy(), as_np(m_j), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(l.numpy(), as_np(l_j), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(acc.numpy(), as_np(acc_j), rtol=2e-5,
                                   atol=2e-5)

    def test_layer_stacked_pool_matches_slice(self):
        q, kp, vp, clean, lens, page, _ = self._inputs()
        kp5 = np.stack([kp, kp * 0.5, kp + 1.0])
        vp5 = np.stack([vp, vp * 0.5, vp + 1.0])
        qt, tt, lt = (torch.from_numpy(a) for a in (q, clean, lens))
        for li in range(3):
            out5 = paged_decode_attention(qt, torch.from_numpy(kp5),
                                          torch.from_numpy(vp5), tt, lt,
                                          layer=li)
            out4 = paged_decode_attention(qt, torch.from_numpy(kp5[li]),
                                          torch.from_numpy(vp5[li]), tt, lt)
            assert torch.equal(out5, out4)
            out_j = jax_decode(jnp.asarray(q), jnp.asarray(kp5),
                               jnp.asarray(vp5), jnp.asarray(clean),
                               jnp.asarray(lens),
                               layer=jnp.asarray(li, jnp.int32))
            np.testing.assert_allclose(out5.numpy(), as_np(out_j),
                                       rtol=2e-5, atol=2e-5)


class TestPageCopy:
    """Gather / scatter / copy / append: bit-exact against the JAX
    kernels; the port's pools are updated in place."""

    def _pool(self, dtype="float32", L=2, P=12, page=8, KV=2, Dh=16):
        return both(np.random.default_rng(7).normal(
            size=(L, P, page, KV, Dh)).astype(np.float32), dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("ids", [[3], [7, 0, 5], [1, 1, 4, 9, 2]])
    def test_gather_matches_jax(self, dtype, ids):
        pj, pt = self._pool(dtype)
        out_t = gather_pages(pt, ids)
        out_j = jax_gather(pj, jnp.asarray(ids, jnp.int32))
        assert out_t.shape == (2, len(ids), 8, 2, 16)
        assert np.array_equal(as_np(out_t), as_np(out_j))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_scatter_in_place_matches_jax(self, dtype):
        pj, pt = self._pool(dtype)
        before = pt.clone()
        ids = [2, 9, 4]
        sj, st = both(np.random.default_rng(11).normal(
            size=(2, 3, 8, 2, 16)).astype(np.float32), dtype)
        out_t = scatter_pages(pt, st, ids)
        assert out_t is pt                             # updated in place
        out_j = jax_scatter(pj, sj, jnp.asarray(ids, jnp.int32))
        assert np.array_equal(as_np(pt), as_np(out_j))
        untouched = [i for i in range(12) if i not in ids]
        assert torch.equal(pt[:, untouched], before[:, untouched])

    def test_copy_pages_is_cow_split(self):
        pj, pt = self._pool()
        before = pt.clone()
        copy_pages(pt, [5, 1], [10, 11])
        out_j = jax_copy(pj, jnp.asarray([5, 1], jnp.int32),
                         jnp.asarray([10, 11], jnp.int32))
        assert np.array_equal(pt.numpy(), as_np(out_j))
        assert torch.equal(pt[:, 10], before[:, 5])

    def test_gather_then_scatter_roundtrips(self):
        _, pt = self._pool()
        ids = [6, 2, 8]
        staging = gather_pages(pt, ids)
        blank = torch.zeros_like(pt)
        scatter_pages(blank, staging, ids)
        assert torch.equal(blank[:, ids], pt[:, ids])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_append_tokens_matches_jax(self, dtype):
        rng = np.random.default_rng(3)
        L, P, page, KV, Dh, B = 2, 9, 8, 2, 16, 4
        kj, kt = both(rng.normal(size=(L, P, page, KV, Dh)), dtype)
        vj, vt = both(rng.normal(size=(L, P, page, KV, Dh)), dtype)
        ktj, ktt = both(rng.normal(size=(L, B, KV, Dh)), dtype)
        vtj, vtt = both(rng.normal(size=(L, B, KV, Dh)), dtype)
        page_ids, offsets = [3, 0, 7, 5], [0, 7, 3, 3]
        k0, v0 = kt.clone(), vt.clone()
        append_tokens(kt, vt, ktt, vtt, page_ids, offsets)
        k2, v2 = jax_append(kj, vj, ktj, vtj, jnp.asarray(page_ids),
                            jnp.asarray(offsets))
        assert np.array_equal(as_np(kt), as_np(k2))
        assert np.array_equal(as_np(vt), as_np(v2))
        untouched = [i for i in range(P) if i not in page_ids]
        assert torch.equal(kt[:, untouched], k0[:, untouched])
        assert torch.equal(vt[:, untouched], v0[:, untouched])

    def test_cpu_calls_launch_no_kernel(self):
        """Everything above ran on CPU tensors: no CUDA kernel launched."""
        assert launch_counts() == {"paged_decode_attention": 0,
                                   "dense_decode_attention": 0,
                                   "page_gather": 0, "page_scatter": 0,
                                   "token_append": 0,
                                   "token_append_indexed": 0,
                                   "flash_attention": 0,
                                   "flash_extend": 0, "rwkv6_scan": 0,
                                   "rms_norm": 0, "qkv_rope": 0,
                                   "qkv_rope_chunk": 0,
                                   "gated_act": 0, "gate_up_act": 0,
                                   "qkv_proj": 0, "mamba2_step": 0,
                                   "ssd_chunk": 0}


class TestFlashPlan:
    """The host side of the bf16 flash launch, as pure functions: the
    tile plan (padded D, ring depth, shared memory, grid) and the strides
    the tensor maps take, with the ValueError TMA's alignment rules call
    for. The kernel itself runs on the card only (``chip_smoke.py``)."""

    @pytest.mark.parametrize("q_tile", [None, 64, 128])
    def test_every_head_dim_fits_shared_memory(self, q_tile):
        for D in range(1, 257):
            if D % 8:
                with pytest.raises(ValueError, match="multiple of 8"):
                    plan_bf16(1, 12, 512, D, q_tile)
                continue
            plan = plan_bf16(1, 12, 512, D, q_tile)
            assert plan.head_pad % 64 == 0 and 0 <= plan.head_pad - D < 64
            assert 2 <= plan.stages <= MAX_STAGES
            assert plan.smem_bytes + STATIC_SMEM <= SMEM_PER_BLOCK == 232_448
            assert plan.block_k in (64, 128) and plan.q_tile in (64, 128)
            assert plan.threads == 2 * plan.q_tile
            # a warpgroup's registers: O (head_pad / 2), the scores
            # (block_k / 2) and P (block_k / 4), at most 224 a thread
            # with room for addressing and the softmax state
            assert plan.head_pad / 2 + plan.block_k * 3 / 4 <= 224

    @pytest.mark.parametrize("B,H,S,D,q_tile,grid", [
        (1, 12, 512, 128, None, (8, 12, 1)),    # serving bucket: 96 CTAs
        (1, 12, 2048, 128, None, (16, 12, 1)),  # qwen2-1.5b's prefill
        (1, 16, 8192, 256, None, (64, 16, 1)),  # the gemma2-like layer
        (2, 8, 1000, 80, 128, (8, 8, 2)), (2, 8, 1000, 80, 64, (16, 8, 2))])
    def test_grid(self, B, H, S, D, q_tile, grid):
        assert plan_bf16(B, H, S, D, q_tile).grid == grid

    def test_head_dims_of_the_repo(self):
        """No head dim of a repo config is refused: 8, 16, 80, 128, 256."""
        for D, pad in ((8, 64), (16, 64), (80, 128), (128, 128), (256, 256)):
            assert plan_bf16(1, 4, 256, D).head_pad == pad

    def test_ring_depth_matches_the_source(self):
        src = (pathlib.Path(__file__).resolve().parents[1] / "src" /
               "repro_torch" / "csrc" / "flash_attention.cu").read_text()
        assert f"constexpr int kMaxStages = {MAX_STAGES};" in src

    def test_model_layout_strides(self):
        """(B, S, H, D) activations seen as (B, H, S, D): the strides pass
        through, and a size-1 batch gets an aligned stride."""
        x = torch.zeros((1, 300, 12, 128), dtype=torch.bfloat16)
        v = x.transpose(1, 2)
        st = tma_strides("q", v.shape, v.stride(), 4096)
        assert st[1:] == (128, 12 * 128)
        assert (st[0] * 2) % 16 == 0 and st[0] >= v.numel()
        x = torch.zeros((3, 8, 40, 80), dtype=torch.bfloat16)
        assert tma_strides("k", x.shape, x.stride(), 0) == x.stride()[:3]

    def test_misaligned_operands_raise(self):
        x = torch.zeros((2, 4, 64, 129), dtype=torch.bfloat16)[..., :128]
        with pytest.raises(ValueError, match="position stride 129"):
            tma_strides("q", x.shape, x.stride(), 4096)
        y = torch.zeros((2, 4, 64, 128), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="base address"):
            tma_strides("v", y.shape, y.stride(), 4096 + 2)
        with pytest.raises(ValueError, match="q_tile"):
            plan_bf16(1, 4, 64, 128, q_tile=96)
        with pytest.raises(ValueError, match="multiple of 8"):
            plan_bf16(1, 4, 64, 100)


def test_variant_builds_get_their_own_library():
    """A measurement build (extra nvcc flags, ``_build.load_variant``)
    lands in a library of its own, never over the default build."""
    from repro_torch.kernels import _build
    plain = _build.library_path("flash_attention")
    probed = _build.library_path("flash_attention", ("-DREPRO_FLASH_PHASES",))
    assert plain != probed and plain.parent == probed.parent
    assert plain == _build.library_path("flash_attention", ())
