"""The two-pass WKV scan's arithmetic and host side, on the CPU.

The CUDA scan is two launches: a chunk pass (each chunk's intra-chunk
output and state summary) and a carry pass over slices of the state's
columns. Their plain twins, ``wkv_chunk_pass`` and ``wkv_carry_pass``,
compose the chunked plain version, which is held here against the JAX
package's Pallas kernel in interpret mode on the same numpy inputs;
``plan_scan`` (grids, slice width, shared memory, workspace) against the
source's constants. The kernel itself is held against the plain version
on the card by ``chip_smoke.py`` phase 2.

Tolerances: 1e-4 against the Pallas kernel, the JAX package's own bound
(``tests/test_torch_rwkv6.py``). The carry taken slice by slice is exact:
each column of the state is carried elementwise, and the readout's
products see the same reduction over K at every slice that divides K.
"""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import rwkv6_scan as jax_scan
from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.rwkv6_scan import kernel as scan_kernel
from repro_torch.kernels.rwkv6_scan import rwkv6_chunked_ref, rwkv6_scan_kernel
from repro_torch.kernels.rwkv6_scan.kernel import (MAX_DIM, SLICE, SLICES,
                                                   SMEM_PER_BLOCK, plan_scan,
                                                   tile_ld)
from repro_torch.kernels.rwkv6_scan.ref import wkv_carry_pass, wkv_chunk_pass
from repro_torch.launch import scan_probes

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

SOURCE = (pathlib.Path(__file__).resolve().parents[1] / "src" /
          "repro_torch" / "csrc" / "rwkv6_scan.cu").read_text()
SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
SM_SHARED = 233_472           # bytes of shared memory an SM holds
BLOCK_RESERVED = 1024         # bytes the card reserves a resident block


def source_constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


def scan_case(B, T, H, K, seed=0, shift=2.0, init=True):
    """r, k, v, log-decay, u and init state as float32 numpy arrays; the
    log-decay -exp(N(0, 1) - shift) clamped at -e a token, the model's
    floor (``models/rwkv6.py``: the exponent is clamped at 1)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lw = -np.exp(np.minimum(n(B, T, H, K) - shift, 1.0))
    return (n(B, T, H, K) * 0.5, n(B, T, H, K) * 0.5, n(B, T, H, K) * 0.5,
            lw.astype(np.float32), n(H, K) * 0.3,
            n(B, H, K, K) * 0.1 if init else None)


def to_torch(*arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


# ---------------------------------------------------------------- the plan
@pytest.mark.parametrize("name,value", [
    ("kThreads", scan_kernel.THREADS), ("kParts", scan_kernel.PARTS),
    ("kSlice", SLICE), ("kMax", MAX_DIM), ("kStages", scan_kernel.STAGES)])
def test_constants_match_the_kernel_source(name, value):
    assert source_constant(name) == value


def test_slices_match_the_source_dispatch():
    built = sorted(int(s) for s in re.findall(r"launch_carry<(\d+)>\(",
                                              SOURCE))
    assert tuple(built) == SLICES and SLICE in SLICES
    assert "return (n + 3) / 4 * 4 + 4;" in SOURCE
    assert [tile_ld(K) for K in (1, 4, 10, 16, 63, 64)] == \
        [8, 8, 16, 20, 68, 68]



@pytest.mark.parametrize("slice_cols", SLICES)
def test_every_shape_fits_shared_memory(slice_cols):
    for K in range(1, MAX_DIM + 1):
        for L in range(1, MAX_DIM + 1):
            plan = plan_scan(1, 4 * L, 2, K, L, slice_cols)
            assert plan.chunk_smem <= SMEM_PER_BLOCK
            assert plan.carry_smem <= SMEM_PER_BLOCK


def test_shared_memory_at_the_model_shape():
    """K = L = 64. The chunk pass holds no state, and reuses its tiles
    phase by phase (four 64 x 68 regions): three of its blocks fit an SM
    (the source's __launch_bounds__(kThreads, 3)). The carry pass: three
    stages of r_in (64 x 68), the U and o slices and the decay, and the
    state slice twice: 80 blocks at B = 1 and the default 32 columns, one
    an SM; at 16 columns two share an SM (160 blocks)."""
    plan = plan_scan(1, 2048, 40, 64, 64)
    assert plan.chunk_smem == 4 * (4 * 64 * 68 + 64 + 64 + 4 * 64) == 71_168
    assert 3 * (plan.chunk_smem + BLOCK_RESERVED) <= SM_SHARED
    assert "__launch_bounds__(kThreads, 3) wkv_chunk_kernel" in SOURCE
    assert plan.slice_cols == 32
    assert plan.carry_smem == 4 * (3 * (64 * 68 + 2 * 64 * 32 + 68)
                                   + 2 * 64 * 32) == 118_576
    narrow = plan_scan(1, 2048, 40, 64, 64, 16)
    assert narrow.carry_smem == 4 * (3 * (64 * 68 + 2 * 64 * 16 + 68)
                                     + 2 * 64 * 16) == 85_808
    assert 2 * (narrow.carry_smem + BLOCK_RESERVED) <= SM_SHARED


@pytest.mark.parametrize("B,T,H,K,L,slice_cols,carry_blocks", [
    (1, 2048, 40, 64, 64, 32, 2), (2, 2048, 40, 64, 64, 16, 4),
    (1, 2048, 40, 64, 64, 8, 8), (1, 2048, 40, 64, 64, 32, 2),
    (2, 256, 4, 16, 16, 16, 1), (3, 96, 2, 10, 32, 8, 2),
    (1, 64, 2, 64, 32, 16, 4)])
def test_grids_and_workspace(B, T, H, K, L, slice_cols, carry_blocks):
    plan = plan_scan(B, T, H, K, L, slice_cols)
    nc = T // L
    assert plan.chunk_grid == (nc, H, B)
    assert plan.carry_grid == (carry_blocks, H, B)
    assert plan.slice_cols == slice_cols and plan.launches == 2
    assert plan.workspace_floats == B * H * nc * (K * K + L * K + K)


def test_model_shapes_fill_the_card():
    """rwkv6-3b's prefill at B = 1: 1280 chunk blocks and, at the default
    slice, 80 carry blocks, one an SM (the first design had 40 blocks on
    the card's 132 SMs); the workspace is twice an input and a little more
    (42 MB)."""
    plan = plan_scan(1, 2048, 40, 64, 64)
    assert np.prod(plan.chunk_grid) == 1280
    assert np.prod(plan.carry_grid) == 80
    assert plan.workspace_floats == 2 * 2048 * 40 * 64 + 1280 * 64


def test_launches_counted_per_kernel():
    assert plan_scan(2, 0, 4, 16, 1).launches == 1      # carry alone
    assert plan_scan(0, 64, 4, 16, 16).launches == 0
    assert plan_scan(2, 64, 0, 16, 16).launches == 0


@pytest.mark.parametrize("args", [
    (1, 64, 2, 0, 16), (1, 64, 2, 65, 16), (1, 64, 2, 16, 0),
    (1, 130, 2, 16, 65), (1, 100, 2, 16, 64), (65536, 64, 2, 16, 16),
    (1, 64, 65536, 16, 16), (1, 64, 2, 16, 16, 12), (1, 64, 2, 16, 16, 64)])
def test_plan_refuses_what_the_kernels_do_not_take(args):
    with pytest.raises(ValueError):
        plan_scan(*args)


@pytest.mark.parametrize("shape,chunk,kw", [
    ((1, 64, 2, 72), 64, {}),              # K beyond 64
    ((1, 100, 2, 16), 64, {}),             # T not a chunk multiple
    ((1, 64, 2, 16), 16, {"_slice": 12}),  # no such slice
])
def test_wrapper_refuses_before_any_launch(shape, chunk, kw):
    r = torch.zeros(shape)
    u = torch.zeros(shape[2:])
    before = launch_counts()
    with pytest.raises(ValueError):
        rwkv6_scan_kernel(r, r, r, r, u, chunk=chunk, **kw)
    assert launch_counts() == before
    assert not _build._libs


def test_cpu_tensors_are_refused_without_a_launch():
    r, k, v, lw, u, s0 = to_torch(*scan_case(1, 32, 2, 8))
    before = rwkv6_scan_kernel.launches
    for state in (None, s0):
        with pytest.raises(ValueError, match="CUDA"):
            rwkv6_scan_kernel(r, k, v, lw, u, state, chunk=16)
    assert rwkv6_scan_kernel.launches == before
    assert not _build._libs


@pytest.mark.parametrize("name", sorted(scan_probes.CUTS))
def test_probe_cuts_apply_to_the_source(name):
    """``launch/scan_probes.py`` cuts parts out of the source by exact
    text: each cut must still find its text once, and change it."""
    text = scan_probes.cut_source(name)
    assert (text == SOURCE) == (name == "as_is")


# ------------------------------------------------------- the plain passes
@pytest.mark.parametrize("B,T,H,K,L", [(2, 128, 2, 32, 32),
                                       (1, 256, 3, 64, 64),
                                       (2, 96, 2, 16, 32)])
@pytest.mark.parametrize("slice_cols", SLICES)
@pytest.mark.parametrize("init", [True, False])
def test_carry_slice_by_slice_equals_the_whole_carry(B, T, H, K, L,
                                                     slice_cols, init):
    r, k, v, lw, u, s0 = to_torch(*scan_case(B, T, H, K, seed=K + L,
                                             shift=0.0, init=init))
    handed = wkv_chunk_pass(r, k, v, lw, u, chunk=L)
    o_all, s_all = wkv_carry_pass(*handed, s0)
    parts = [wkv_carry_pass(*handed, s0, slice(x0, x0 + slice_cols))
             for x0 in range(0, K, slice_cols)]
    assert torch.equal(torch.cat([p[0] for p in parts], -1), o_all)
    assert torch.equal(torch.cat([p[1] for p in parts], -1), s_all)


def test_state_slice_is_exact_at_a_ragged_width():
    """K = 10 in slices of 8: the last slice is 2 columns wide; the state
    is carried elementwise, so it is still exact."""
    r, k, v, lw, u, s0 = to_torch(*scan_case(2, 64, 2, 10, seed=7))
    handed = wkv_chunk_pass(r, k, v, lw, u, chunk=16)
    _, s_all = wkv_carry_pass(*handed, s0)
    parts = [wkv_carry_pass(*handed, s0, slice(x0, x0 + 8))[1]
             for x0 in (0, 8)]
    assert parts[1].shape == (2, 2, 10, 2)
    assert torch.equal(torch.cat(parts, -1), s_all)


def test_one_chunk_from_zero_state_leaves_its_summary():
    """T = L and no initial state: the final state is the chunk's summary
    and the output the intra-chunk part alone, bit for bit."""
    r, k, v, lw, u, _ = to_torch(*scan_case(2, 32, 2, 16, seed=8, init=False))
    o_intra, summaries, _, _ = wkv_chunk_pass(r, k, v, lw, u, chunk=32)
    o, s = rwkv6_chunked_ref(r, k, v, lw, u, chunk=32)
    assert torch.equal(s, summaries[:, 0])
    assert torch.equal(o, o_intra.reshape(o.shape))


@pytest.mark.parametrize("B,T,H,K,L,shift", [(1, 256, 2, 64, 64, 2.0),
                                             (2, 128, 2, 64, 64, 0.0),
                                             (1, 128, 2, 64, 32, 2.0)])
def test_composed_passes_match_the_pallas_kernel(B, T, H, K, L, shift):
    """The chunk pass then the carry pass against the JAX package's Pallas
    kernel in interpret mode, at the model's head size, with steep decays
    (chunk totals past the +-38 clip) in the second case."""
    arrs = scan_case(B, T, H, K, seed=9, shift=shift)
    r, k, v, lw, u, s0 = to_torch(*arrs)
    o, s = wkv_carry_pass(*wkv_chunk_pass(r, k, v, lw, u, chunk=L), s0)
    w = np.exp(arrs[3])
    oj, sj = jax_scan(*(jnp.asarray(a) for a in arrs[:3]), jnp.asarray(w),
                      jnp.asarray(arrs[4]), jnp.asarray(arrs[5]), chunk=L,
                      interpret=True)
    np.testing.assert_allclose(o.reshape(B, T, H, K).numpy(), np.asarray(oj),
                               **SCAN_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), **SCAN_TOL)
