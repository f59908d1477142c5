"""The host side of the port's page gather, on the CPU: its page ids
travel by value in the launch (``pack_ids`` without the distinctness
check: a gather may read a page twice, as the JAX kernel does), validated
as plain integers and cut into launches of at most ``K_MAX_GATHER``
pages; a CPU pool takes the plain version, bit for bit the JAX package's
gather. The CUDA kernel is held against its plain version bit for bit by
``chip_smoke.py`` phase 2 (128 pages at qwen2-1.5b width, the smoke
shapes, and 700 pages with repeats in two launches)."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.page_copy.ops import copy_pages as jax_copy
from repro.kernels.page_copy.ops import gather_pages as jax_gather
from repro_torch.kernels import launch_counts
from repro_torch.kernels.page_copy import (copy_pages, gather_pages,
                                           page_gather_ref)
from repro_torch.kernels.page_copy.kernel import (K_MAX_GATHER,
                                                  K_MAX_SCATTER, pack_ids,
                                                  page_gather_kernel)

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / \
    "repro_torch" / "csrc" / "page_copy.cu"
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _gather_slices(ids, P=10):
    return pack_ids(ids, P, what="gather", capacity=K_MAX_GATHER,
                    distinct=False)


def test_capacity_matches_the_kernel_source():
    """The slice size is the capacity of the gather's parameter struct."""
    src = CSRC.read_text()
    m = re.search(r"constexpr int kMaxGather = (\d+);", src)
    assert m and int(m.group(1)) == K_MAX_GATHER == 512
    # 512 int32 in the parameter block, beside the launch's other
    # arguments: inside the 4 KB limit
    assert 4 * K_MAX_GATHER <= 4096 - 256
    assert "struct GatherIds" in src and "const int* __restrict__ ids" \
        not in src


@pytest.mark.parametrize("ids", [[3, 3], [0, 0, 0], [1, 1, 4, 9, 2, 4],
                                 np.array([9, 9, 2], np.int64), [5], []])
def test_gather_packing_takes_repeated_ids(ids):
    slices = _gather_slices(ids)
    assert [i for s in slices for i in s.page_ids] == list(map(int, ids))
    assert all(s.offsets is None for s in slices)


@pytest.mark.parametrize("ids", [[3, -1], [3, 10], [10, 10], [-5]])
def test_gather_packing_refuses_out_of_range_ids(ids):
    with pytest.raises(ValueError, match="page ids outside"):
        _gather_slices(ids)


def test_distinctness_is_still_checked_for_writes():
    """Scatter and append keep the check: their writes would race."""
    with pytest.raises(ValueError, match="pairwise distinct"):
        pack_ids([3, 3], 10, what="scatter", capacity=K_MAX_SCATTER)


@pytest.mark.parametrize("n,sizes", [(1, [1]), (511, [511]), (512, [512]),
                                     (513, [512, 1]), (700, [512, 188]),
                                     (1100, [512, 512, 76])])
def test_slices_cover_the_range_exactly(n, sizes):
    """Slices tile [0, n) in order, at and past the capacity, repeats
    and all."""
    ids = np.random.default_rng(n).integers(0, 300, size=n)
    slices = _gather_slices(ids, P=300)
    assert [len(s.page_ids) for s in slices] == sizes
    assert [s.start for s in slices] == [K_MAX_GATHER * i
                                         for i in range(len(sizes))]
    covered = [s.start + k for s in slices for k in range(len(s.page_ids))]
    assert covered == list(range(n))
    assert [i for s in slices for i in s.page_ids] == ids.tolist()


def _pools(dtype, L=2, P=40, page=8, KV=2, Dh=16, seed=3):
    x = np.random.default_rng(seed).normal(
        size=(L, P, page, KV, Dh)).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.bfloat16
                      else torch.int32).numpy()
    arr = np.asarray(x)
    return arr.view(np.int16 if arr.dtype.itemsize == 2 else np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ids", [[7, 7, 7], [3, 0, 3, 39, 0, 12],
                                 list(range(40)) + [5, 5, 38]])
def test_cpu_gather_with_repeats_matches_jax(dtype, ids):
    """Bit for bit against the JAX package's gather (its Pallas kernel
    in interpret mode) on the same numpy-seeded pool; no kernel launch."""
    pj, pt = _pools(dtype)
    got = gather_pages(pt, ids)
    want = jax_gather(pj, jnp.asarray(ids, jnp.int32))
    assert tuple(got.shape) == (2, len(ids), 8, 2, 16)
    assert np.array_equal(_bits(got), _bits(want))
    assert torch.equal(got, page_gather_ref(pt, ids))
    assert launch_counts()["page_gather"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cow_copy_matches_the_jax_composition(dtype):
    """``copy_pages`` (the COW split: gather, then scatter) equals the
    JAX package's ``copy_pages`` on the same pool, bit for bit."""
    pj, pt = _pools(dtype, seed=4)
    src, dst = [5, 1, 30], [10, 11, 20]
    copy_pages(pt, src, dst)
    want = jax_copy(pj, jnp.asarray(src, jnp.int32),
                    jnp.asarray(dst, jnp.int32))
    assert np.array_equal(_bits(pt), _bits(want))
    assert launch_counts()["page_gather"] == 0


def test_kernel_refuses_cpu_pools():
    _, pool = _pools("float32")
    with pytest.raises(ValueError, match="CUDA"):
        page_gather_kernel(pool, [0, 0])
    assert page_gather_kernel.launches == 0
