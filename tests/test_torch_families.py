"""The MoE, VLM and audio families of the port's ``Model`` against the JAX
package's ``Model.forward``: qwen3-moe (MoE, QK-norm), moonshot (MoE with
shared experts and a leading dense layer: ``dense_layers``, ``k0``/``v0``),
pixtral (VLM: tokens and the ``embeds`` input) and musicgen (audio:
sinusoidal positions, gelu), all at smoke size. One JAX ``Model.init``
tree is carried over with ``params_from_numpy``; the same token ids go
through prefill, extend and decode.

Tolerances (those of ``tests/test_torch_model.py``): under the fp32
override the two differ only in summation order, logits (magnitude up to
~4) within rtol 2e-5 / atol 5e-4. In bf16: argmax agreement and max
|dlogit| <= 0.0625, two bf16 ulps at this logit scale (logits up to 4.4,
where an ulp is 0.03125). Measured: qwen3-moe and musicgen bit-equal
(musicgen since its GELU is spelled as ``jax.nn.gelu``'s), moonshot
within 1.5e-5, pixtral within 0.015625 (one ulp of a logit in [2, 4); its
``embeds`` path within 3.8e-6).

Also here: the streaming init (bit-equal to drawing the fp32 tree and
casting it), and the CUDA kernels' domains for each new family's head
shape (ROADMAP P7), checked on the host before any launch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.models.common import sinusoidal_emb as jax_sinusoidal_emb
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.models import Model
from repro_torch.models.common import (cast_params, flatten_tree,
                                       init_params, params_from_numpy,
                                       sinusoidal_emb)
from repro_torch.models.transformer import model_specs

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

ARCHS = ["qwen3-moe-235b-a22b", "moonshot-v1-16b-a3b", "pixtral-12b",
         "musicgen-large"]
FP32 = dict(rtol=2e-5, atol=5e-4)
BF16_MAX_ABS = 0.0625


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
    """Logits of prefill(12) -> extend(7) -> decode(1) on both sides, and
    the caches after them."""
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
    return out, jc, tc


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_fp32(arch):
    jm, jp, tm = _pair(arch, "float32")
    modes, jc, tc = _three_modes(jm, jp, tm, seed=0)
    for lj, lt, mode in modes:
        np.testing.assert_allclose(lt, lj, err_msg=f"{arch} {mode}", **FP32)
    assert set(jc) == set(tc)
    for key in jc:              # k/v and, for moonshot, k0/v0: 20 tokens
        np.testing.assert_allclose(tc[key][:, :, :20].numpy(),
                                   np.asarray(jc[key])[:, :, :20],
                                   err_msg=key, **FP32)


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_bf16(arch):
    jm, jp, tm = _pair(arch, "bfloat16")
    for seed in (0, 1):
        modes, _, _ = _three_modes(jm, jp, tm, seed=seed)
        for lj, lt, mode in modes:
            assert np.array_equal(lj.argmax(-1), lt.argmax(-1)), (arch, mode)
            assert np.abs(lj - lt).max() <= BF16_MAX_ABS, (arch, mode)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pixtral_embeds_input(dtype):
    """The VLM family's ``embeds`` input: against the JAX ``embeds`` path,
    and equal bit for bit to the token path fed the same embedding rows
    (pixtral adds no position embedding; RoPE is in attention)."""
    jm, jp, tm = _pair("pixtral-12b", dtype)
    toks = np.random.default_rng(2).integers(0, jm.cfg.vocab_size, (2, 14))
    rows = tm.params["embed"][torch.from_numpy(toks)]
    by_tokens, _ = tm.forward(torch.from_numpy(toks),
                              cache=tm.init_cache(2, 16))
    by_embeds, _ = tm.forward(embeds=rows, cache=tm.init_cache(2, 16))
    assert torch.equal(by_tokens, by_embeds)
    lj, _ = jm.forward(jp, embeds=jnp.asarray(rows.float().numpy()),
                       cache=jm.init_cache(2, 16), mode="prefill")
    if dtype == "float32":
        np.testing.assert_allclose(by_embeds.numpy(), np.asarray(lj), **FP32)
    else:
        assert np.array_equal(np.asarray(lj).argmax(-1),
                              by_embeds.numpy().argmax(-1))
        assert np.abs(np.asarray(lj) - by_embeds.numpy()).max() <= \
            BF16_MAX_ABS
    with pytest.raises(ValueError, match="tokens or embeds"):
        tm.forward(torch.from_numpy(toks), embeds=rows)


def test_sinusoidal_emb_matches_jax():
    """Same angles in fp32, sin then cos; the two libraries' sin and cos
    of angles up to 4096 rad differ in the last bits (atol 2e-5)."""
    pos = np.array([[0, 1, 7, 300], [5, 4096, 2, 9]])
    got = sinusoidal_emb(torch.from_numpy(pos), 64)
    want = np.asarray(jax_sinusoidal_emb(jnp.asarray(pos), 64))
    assert got.dtype == torch.float32 and got.shape == (2, 4, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    assert torch.equal(got[0, 0, :32], torch.zeros(32))      # sin(0)
    assert torch.equal(got[0, 0, 32:], torch.ones(32))       # cos(0)


@pytest.mark.parametrize("arch", ARCHS + ["gemma2-9b", "zamba2-2.7b"])
def test_specs_and_cache_shapes_mirror_jax(arch):
    """``model_specs`` equals the flattened ``Model.specs()`` (shape, init,
    scale, dtype, keep_dtype), and the cache shapes are equal (k0/v0 for
    the leading dense layers; gemma2's local rings and global caches over
    its pairs; zamba2's conv / SSM states over (groups, E) and its shared
    blocks' K/V)."""
    cfg = get_config(arch, smoke=True)
    jm = JaxModel(jax_config(arch, smoke=True))
    want = {k: (s.shape, s.init, s.scale, s.dtype, s.keep_dtype)
            for k, s in flatten_tree(jm.specs()).items()}
    got = {k: (s.shape, s.init, s.scale, s.dtype, s.keep_dtype)
           for k, s in model_specs(cfg).items()}
    assert got == want
    tm = Model(cfg, device="cpu")
    assert tm.cache_shapes(2, 48) == jm.cache_shapes(2, 48)
    cache = tm.init_cache(2, 48)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: s for k, (s, _) in jm.cache_shapes(2, 48).items()}
    assert len(tm.first_layers) + len(tm.layers) == cfg.num_layers


# --------------------------------------------------------- streaming init
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-235b-a22b",
                                  "rwkv6-3b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_streaming_init_equals_cast_of_the_fp32_tree(arch, dtype):
    """Each leaf cast as it is drawn gives the values of drawing the whole
    fp32 tree and casting it, bit for bit, and ``Model`` builds from it
    (``keep_dtype`` leaves stay fp32)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=dtype)
    specs = model_specs(cfg)
    streamed = init_params(cfg, torch.Generator().manual_seed(3), dtype)
    tree = cast_params(init_params(cfg, torch.Generator().manual_seed(3)),
                       specs, dtype)
    assert streamed.keys() == tree.keys()
    for name in tree:
        assert streamed[name].dtype == tree[name].dtype, name
        assert torch.equal(streamed[name], tree[name]), name
    model = Model(cfg, device="cpu", seed=3)
    for name, t in model.params.items():
        assert torch.equal(t, tree[name]), name


# ------------------------------------------------- kernel domains (P7)
#: (arch, G = H / KV, head_dim) at published width; gemma2's prefill
#: runs flash with its window and softcap, zamba2's shared blocks MHA
DOMAINS = [("qwen3-moe-235b-a22b", 16, 128), ("moonshot-v1-16b-a3b", 1, 128),
           ("pixtral-12b", 4, 128), ("musicgen-large", 1, 64),
           ("gemma2-9b", 2, 256), ("zamba2-2.7b", 1, 80)]


@pytest.mark.parametrize("arch,G,D", DOMAINS)
def test_kernel_plans_take_each_new_family(arch, G, D):
    cfg = get_config(arch)
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.head_dim) == (G, D)
    if arch == "gemma2-9b":
        assert (cfg.sliding_window, cfg.attn_softcap) == (4096, 50.0)
    for esz in (2, 4):       # bf16 pools (serving) and fp32 (checks)
        plan = decode_kernel.plan_decode(8, cfg.num_kv_heads, G, D, esz, 16,
                                         256)
        assert plan.smem_bytes <= decode_kernel.SMEM_PER_BLOCK
        assert plan.tensor_cores == (esz == 2)
    plan = flash_kernel.plan_bf16(1, cfg.num_heads, 512, D)
    assert plan.head_pad % 64 == 0 and plan.grid[1] == cfg.num_heads
    # the model's prefill layout: (B, H, S, D) views of (B, S, H, D)
    q = torch.zeros(1, 512, cfg.num_heads, D, dtype=torch.bfloat16)
    k = torch.zeros(1, 512, cfg.num_kv_heads, D, dtype=torch.bfloat16)
    for name, t in (("q", q), ("k", k)):
        v = t.transpose(1, 2)
        assert flash_kernel.tma_strides(name, v.shape, v.stride(), 4096) \
            == v.stride()[:3]


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card: it walks a wrapper's host
    checks up to the launch, which no test here may reach."""

    @property
    def is_cuda(self):
        return True


def _on_card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_OnCard, t)


@pytest.fixture
def no_launch(monkeypatch):
    def launched(*_args, **_kw):
        raise AssertionError("a kernel was looked up for a launch")
    monkeypatch.setattr(_build, "function", launched)
    monkeypatch.setattr(flash_kernel, "_num_sms", lambda index: 132)


@pytest.mark.parametrize("H,KV,D,dtype", [
    (68, 4, 128, torch.bfloat16),    # G 17
    (32, 2, 256, torch.bfloat16),    # G 16 above head_dim 128
    (8, 2, 12, torch.bfloat16),      # head_dim not a multiple of 8
    (8, 2, 264, torch.float32)])     # head_dim over 256
def test_decode_refuses_outside_its_domain_before_launch(no_launch, H, KV, D,
                                                         dtype):
    q = _on_card(torch.zeros(2, H, D, dtype=dtype))
    pool = _on_card(torch.zeros(1, 4, 16, KV, D, dtype=dtype))
    tables = _on_card(torch.zeros(2, 2, dtype=torch.int32))
    lens = _on_card(torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        decode_kernel.paged_decode_attention_kernel(q, pool, pool, tables,
                                                    lens)


@pytest.mark.parametrize("D,stride_pad", [(12, 0), (128, 4)])
def test_flash_refuses_outside_its_domain_before_launch(no_launch, D,
                                                        stride_pad):
    """bf16 flash: a head_dim not a multiple of 8, and a position stride
    that is not a whole number of 16 bytes."""
    base = torch.zeros(1, 64, 4, D + stride_pad, dtype=torch.bfloat16)
    x = _on_card(base[..., :D]).transpose(1, 2)
    with pytest.raises(ValueError):
        flash_kernel.flash_attention_kernel(x, x, x)


#: every family the paged runtime serves (path A and phase 6)
PAGED_ARCHS = ("qwen2-1.5b", "stablelm-3b", "glm4-9b", "qwen3-moe-235b-a22b",
               "pixtral-12b", "musicgen-large")


@pytest.mark.parametrize("arch", PAGED_ARCHS)
def test_chunk_launches_take_each_paged_family(no_launch, arch):
    """Path A's extend chunk at each paged family's width (512 rows on
    2048 cached, the runtime's scratch of 4096 rows cut to T = 2560, bf16):
    the extend launch's (B, KV, T, Dh) views of the layer's scratch cache
    pass ``tma_strides`` and ``operand_shapes`` with the device offsets,
    and both the extend launch and the chunk's qkv launch pass every
    host check and stop at the launch's lookup: nothing launched."""
    from repro_torch.kernels.fusions import kernel as fusion_kernel
    cfg = get_config(arch)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    C, T = 512, 2560
    scratch = torch.zeros(1, 4096, KV, D, dtype=torch.bfloat16)[:, :T]
    q = torch.zeros(1, C, H, D, dtype=torch.bfloat16)
    off = torch.full((1,), 2048, dtype=torch.int32)
    qv, kv = q.transpose(1, 2), scratch.transpose(1, 2)
    assert flash_kernel.operand_shapes(qv, kv, kv, "extend", off) == \
        (1, H, KV, C, T, D)
    for name, t in (("q", qv), ("k", kv)):
        assert flash_kernel.tma_strides(name, t.shape, t.stride(),
                                        4096)[1:] == t.stride()[1:3]
    plan = flash_kernel.plan_extend(1, H, KV, C, T, D)
    assert plan.key_tiles * plan.block_k >= T
    assert plan.threads == 256 and plan.pair == ((H // KV) % 2 == 0)
    assert plan.smem_bytes <= flash_kernel.SMEM_PER_BLOCK
    assert plan.partial_bytes <= plan.smem_bytes - flash_kernel.ALIGN_SLACK
    with pytest.raises(AssertionError, match="looked up"):
        flash_kernel.flash_extend_kernel(*map(_on_card, (qv, kv, kv, off)))
    rows = torch.zeros(C, H, D, dtype=torch.bfloat16)
    kvr = torch.zeros(C, KV, D, dtype=torch.bfloat16)
    rope = None
    if cfg.pos_emb == "rope":
        rot = int(D * cfg.rope_fraction) // 2
        rope = (torch.zeros(1, C, rot), torch.zeros(1, C, rot))
    bias = (torch.zeros(H, D, dtype=torch.bfloat16),
            torch.zeros(KV, D, dtype=torch.bfloat16),
            torch.zeros(KV, D, dtype=torch.bfloat16)) if cfg.qkv_bias \
        else None
    norm = (torch.zeros(D, dtype=torch.bfloat16),) * 2 if cfg.qk_norm \
        else None
    with pytest.raises(AssertionError, match="looked up"):
        fusion_kernel.qkv_rope_chunk_kernel(
            _on_card(rows), _on_card(kvr), _on_card(kvr),
            cache_k=_on_card(scratch), cache_v=_on_card(scratch),
            offsets=_on_card(off), bias=bias, norm=norm, eps=cfg.norm_eps,
            rope=rope)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_norm_takes_each_config_width(no_launch, arch):
    """The norm kernel's geometry at every config's d_model (and a
    qk-normed family's head dim), published and smoke widths, in bf16
    and fp32: whole warps a row, every chunk a thread's, and the
    wrapper's host checks pass, stopping at the launch's lookup."""
    from repro_torch.kernels.fusions import kernel as fusion_kernel
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        widths = {cfg.d_model} | ({cfg.head_dim} if cfg.qk_norm else set())
        for D in widths:
            for dtype in (torch.bfloat16, torch.float32):
                esz = torch.empty((), dtype=dtype).element_size()
                geo = fusion_kernel.norm_geometry(D, esz)
                chunks = D * esz // 16
                assert geo.row_threads % 32 == 0
                assert geo.threads <= fusion_kernel.NORM_MAX_THREADS
                assert geo.chunks_per_thread * geo.row_threads >= chunks
                x = _on_card(torch.zeros(4, D, dtype=dtype))
                with pytest.raises(AssertionError, match="looked up"):
                    fusion_kernel.rms_norm_kernel(
                        x, _on_card(torch.zeros(D, dtype=dtype)), 1e-6)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_gate_up_plan_takes_each_config_width(no_launch, arch):
    """The decode step's gate/up product at every config's (d_model, d_ff)
    (and a MoE's leading dense layers' d_ff), published and smoke widths,
    for 1 to 16 tokens: one CTA a 64-column tile streaming all of K (a
    token's sums run in one order at every batch), every column in
    exactly one tile, one wave of 132 SMs at three CTAs an SM, whose
    shared memory holds them; the wrapper's host checks pass, stopping at
    the launch's lookup, and 17 tokens or a row of K that is not whole 16
    bytes are refused there first."""
    from repro_torch.kernels.fusions import kernel as fk
    assert fk.GATE_UP_CTAS_PER_SM * fk.GATE_UP_SMEM <= fk.SMEM_PER_BLOCK
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        D = cfg.d_model
        widths = {cfg.d_ff}
        if cfg.moe is not None and cfg.moe.dense_d_ff:
            widths.add(cfg.moe.dense_d_ff)
        for F in widths:
            for rows in range(1, fk.GATE_UP_MAX_ROWS + 1):
                plan = fk.plan_gate_up(rows, D, F)
                assert (plan.tiles - 1) * fk.GATE_UP_BOX < F \
                    <= plan.tiles * fk.GATE_UP_BOX
                assert (plan.k_tiles - 1) * fk.GATE_UP_K < D \
                    <= plan.k_tiles * fk.GATE_UP_K
                assert plan.token_tiles * 8 >= rows > \
                    (plan.token_tiles - 1) * 8
                assert plan.waves == 1     # one wave of 132 x 3 CTAs
            w = _on_card(torch.empty(D, F, dtype=torch.bfloat16))
            for rows in (1, 16):
                x = _on_card(torch.zeros(rows, 1, D, dtype=torch.bfloat16))
                with pytest.raises(AssertionError, match="looked up"):
                    fk.gate_up_act_kernel(x, w, w, "silu")
            x = _on_card(torch.zeros(17, 1, D, dtype=torch.bfloat16))
            with pytest.raises(ValueError, match="1 to 16"):
                fk.gate_up_act_kernel(x, w, w, "gelu")
    with pytest.raises(ValueError, match="multiples of 8"):
        fk.plan_gate_up(4, 1540, 8960)


def _rot_half(cfg) -> int:
    return int(cfg.head_dim * cfg.rope_fraction) // 2 \
        if cfg.pos_emb == "rope" else 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_qkv_plan_takes_each_config_width(no_launch, arch):
    """The decode step's qkv launch at every config's (d_model, H, KV, Dh),
    published and smoke widths, for 1 to 16 tokens: a head dim of whole
    64-column boxes and a rotation of whole 8-channel chunks is planned
    (clusters of 1-8 CTAs a head row, at most one CTA an SM, at least
    QKV_MIN_TILES K tiles a rank, the split the same at every row count;
    qwen2-1.5b: 4) and passes the
    wrapper's host checks, stopping at the launch's lookup; any other is
    refused with ``ValueError`` before anything is looked up, and the
    decode step keeps the products and the row pass (stablelm-3b's Dh
    80, the smoke widths' Dh 8 and 16)."""
    from repro_torch.kernels.fusions import kernel as fk
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        D, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        rot = _rot_half(cfg)
        takes = Dh in (64, 128, 256) and rot % 8 == 0 and D % 8 == 0
        splits = set()
        for rows in range(1, fk.QKV_MAX_ROWS + 1):
            if not takes:
                with pytest.raises(ValueError):
                    fk.plan_qkv(rows, D, H, KV, Dh, rot_half=rot)
                continue
            plan = fk.plan_qkv(rows, D, H, KV, Dh, rot_half=rot)
            assert plan.split in fk.QKV_SPLITS
            assert plan.split == 1 or \
                plan.split * fk.QKV_MIN_TILES <= plan.k_tiles
            assert plan.ctas == (H + 2 * KV) * plan.split
            assert plan.ctas <= fk.H100_SMS or plan.split == 1
            assert plan.boxes * fk.QKV_BOX == Dh
            assert plan.token_tiles * 8 >= rows > (plan.token_tiles - 1) * 8
            splits.add(plan.split)
        assert len(splits) <= 1
        x = _on_card(torch.zeros(4, 1, D, dtype=torch.bfloat16))
        w = [_on_card(torch.zeros(D, n, Dh, dtype=torch.bfloat16))
             for n in (H, KV, KV)]
        outs = [_on_card(torch.zeros(4, KV, Dh, dtype=torch.bfloat16))
                for _ in range(2)]
        rope = (_on_card(torch.zeros(4, 1, rot)),) * 2 if rot else None
        bias = (_on_card(torch.zeros(H, Dh, dtype=torch.bfloat16)),
                *(_on_card(torch.zeros(KV, Dh, dtype=torch.bfloat16))
                  for _ in range(2))) if cfg.qkv_bias else None
        norm = (_on_card(torch.zeros(Dh, dtype=torch.bfloat16)),) * 2 \
            if cfg.qk_norm else None
        assert fk.takes_qkv_proj(x, w[0], w[1], rope) is takes
        with pytest.raises(AssertionError if takes else ValueError,
                           match="looked up" if takes else None):
            fk.qkv_proj_kernel(x, *w, k_out=outs[0], v_out=outs[1],
                               bias=bias, norm=norm, eps=cfg.norm_eps,
                               rope=rope)
    assert fk.plan_qkv(4, 1536, 12, 2, 128, rot_half=64).split == 4
    with pytest.raises(ValueError, match="1 to 16"):
        fk.plan_qkv(17, 1536, 12, 2, 128, rot_half=64)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_row_pass_partner_follows_the_shape(arch):
    """The qkv row pass's layout at every config's (Dh, rot/2), published
    and smoke widths, bf16 and fp32: a head row's 16-byte chunks on the
    power-of-two lanes at or above their count within one warp; RoPE's
    partner from another lane where rot/2 is a whole number of chunks
    (qwen2, glm4, pixtral, qwen3-moe: 64), from a copy of the row in
    shared memory where it is not (stablelm-3b: 10); a row longer than
    one warp takes (fp32 at Dh 256: gemma2-9b) refused."""
    from repro_torch.kernels.fusions import kernel as fk
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        Dh, rot = cfg.head_dim, _rot_half(cfg)
        for esz in (2, 4):
            chunks = Dh * esz // 16
            if chunks > fk.ROPE_MAX_LANES:
                with pytest.raises(ValueError, match="one warp"):
                    fk.rope_geometry(Dh, rot, esz)
                continue
            geo = fk.rope_geometry(Dh, rot, esz)
            lanes = geo.row_threads
            assert lanes & (lanes - 1) == 0 and chunks <= lanes < 2 * chunks
            assert lanes <= fk.ROPE_MAX_LANES
            assert geo.partner == ("lanes" if (rot * esz) % 16 == 0
                                   else "shared")
    assert fk.rope_geometry(128, 64, 2).partner == "lanes"
    assert fk.rope_geometry(80, 10, 2).partner == "shared"
    assert fk.rope_geometry(80, 10, 4).partner == "shared"


#: path E's one-token attention: (arch, B, T, window of the cache): gemma2
#: -9b's global layers (a plain 4672-slot cache) and local rings (4096
#: slots), zamba2-2.7b's shared blocks (2048 slots)
DENSE_PATH_E = [("gemma2-9b", 1, 4672, 0), ("gemma2-9b", 1, 4096, 4096),
                ("zamba2-2.7b", 2, 2048, 0)]


@pytest.mark.parametrize("arch,B,T,window", DENSE_PATH_E)
def test_dense_launch_takes_path_e(no_launch, arch, B, T, window):
    """Decode attention's dense launch at path E's shapes: its plan (the
    bf16 dense kernel of ``csrc/dense_decode.cu``: gemma2-9b a KV head a
    CTA and 14 splits a cluster, 8 x 14 = 112 CTAs at B 1; zamba2-2.7b 4
    KV heads a CTA and 8 splits, 2 x 8 x 8 = 128 CTAs at B 2; splits of
    whole 16-token stages covering T, a function of T alone, not of B)
    and every host check of the wrapper over a view of the model's
    stacked cache (heads D apart, the layer's row stride) with int32
    device offsets and gemma2's softcap, stopping at the launch's lookup:
    nothing launched. The qkv launch's plan takes gemma2's one-row step
    (Dh 256) and refuses zamba2's Dh 80 before any launch (its step takes
    the products and the row pass)."""
    from repro_torch.kernels.fusions import plan_qkv
    cfg = get_config(arch)
    KV, G, D = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim
    plan = decode_kernel.plan_dense_decode(B, T, KV, G, D, 2)
    split = plan.split
    assert plan.route == "cluster"
    assert (split.heads, split.cluster) == ((1, 14) if arch == "gemma2-9b"
                                            else (4, 8))
    assert plan.grid == (split.cluster, KV // split.heads, B)
    assert plan.grid[0] * plan.grid[1] * B <= 128     # one wave of 132
    assert split.split % 16 == 0 and \
        (split.cluster - 1) * split.split < T <= split.cluster * split.split
    assert split.smem_bytes <= decode_kernel.SMEM_PER_BLOCK
    for b in (1, 8):       # a row's splits do not move with the batch
        assert decode_kernel.plan_dense_decode(
            b, T, KV, G, D, 2).split == split
    cache = torch.zeros(2, B, T, KV, D, dtype=torch.bfloat16)
    q = torch.zeros(B, KV * G, D, dtype=torch.bfloat16)
    offs = torch.full((B,), T - 1, dtype=torch.int32)
    assert decode_kernel.check_dense_operands(
        *map(_on_card, (q, cache[1], cache[1], offs)), window,
        cfg.attn_softcap) == (B, T, KV, G, D, T * KV * D, KV * D)
    with pytest.raises(AssertionError, match="looked up"):
        decode_kernel.dense_decode_attention_kernel(
            *map(_on_card, (q, cache[1], cache[1], offs)),
            softcap=cfg.attn_softcap, window=window)
    rot = int(D * cfg.rope_fraction) // 2
    if arch == "gemma2-9b":
        assert plan_qkv(B, cfg.d_model, cfg.num_heads, KV, D,
                        rot_half=rot).split >= 1
    else:
        with pytest.raises(ValueError):
            plan_qkv(B, cfg.d_model, cfg.num_heads, KV, D, rot_half=rot)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dense_plan_takes_each_family(arch):
    """Every family with attention, published and smoke widths: its (KV,
    G, Dh) against the dense launch's plan in bf16 and fp32 at a 4096-slot
    cache (no config crosses the decode kernels' domain, ROADMAP P7):
    bf16 at the dense kernel's head dims its clusters, the rest the paged
    split kernels' 128-token splits."""
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        if cfg.family == "ssm":
            continue
        KV = cfg.num_kv_heads
        for esz in (2, 4):
            plan = decode_kernel.plan_dense_decode(
                2, 4096, KV, cfg.num_heads // KV, cfg.head_dim, esz)
            assert plan.split.smem_bytes <= decode_kernel.SMEM_PER_BLOCK
            if esz == 2 and cfg.head_dim in decode_kernel.DENSE_HEAD_DIMS:
                assert plan.route == "cluster"
                assert plan.grid[1] == KV // plan.split.heads
                assert plan.split.cluster * plan.split.split >= 4096
            else:
                assert plan.route == "split"
                assert plan.split.max_splits == 32 and plan.grid[1] == KV
                assert plan.split.tensor_cores == (
                    esz == 2 and cfg.head_dim in decode_kernel.TC_HEAD_DIMS)
