"""The host side of the port's page scatter, on the CPU: its page ids
travel by value in the launch (``pack_ids``, the packer token append
shares), validated as plain integers and cut into launches of at most
``K_MAX_SCATTER`` pages. The CUDA kernel is held against its plain
version bit for bit by ``chip_smoke.py`` phase 2 (128 pages at
qwen2-1.5b width, the smoke shapes, and 600 pages in two launches)."""
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.page_copy import scatter_pages as jax_scatter
from repro_torch.kernels import launch_counts
from repro_torch.kernels.page_copy import (copy_pages, page_scatter_ref,
                                           scatter_pages)
from repro_torch.kernels.page_copy.kernel import (K_MAX_SCATTER, pack_ids,
                                                  page_scatter_kernel)

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / \
    "repro_torch" / "csrc" / "page_copy.cu"


def test_capacity_matches_the_kernel_source():
    """The slice size is the capacity of the scatter's parameter struct."""
    m = re.search(r"constexpr int kMaxScatter = (\d+);", CSRC.read_text())
    assert m and int(m.group(1)) == K_MAX_SCATTER == 512
    # 512 int32 in the parameter block: inside the 4 KB limit
    assert 4 * K_MAX_SCATTER <= 4096 - 256


@pytest.mark.parametrize("ids", [[3, 0, 7, 5], [0], [], np.arange(9)[::-1],
                                 np.array([9, 2], np.int64)])
def test_pack_round_trips(ids):
    slices = pack_ids(ids, 10, what="scatter", capacity=K_MAX_SCATTER)
    assert [i for s in slices for i in s.page_ids] == list(map(int, ids))
    assert all(s.offsets is None for s in slices)
    assert [s.start for s in slices] == ([0] if len(ids) else [])


@pytest.mark.parametrize("ids,what", [
    ([3, -1], "page ids outside"), ([3, 10], "page ids outside"),
    ([3, 4, 3], "pairwise distinct"), ([0, 0], "pairwise distinct")])
def test_pack_rejects_bad_ids(ids, what):
    with pytest.raises(ValueError, match=what):
        pack_ids(ids, 10, what="scatter", capacity=K_MAX_SCATTER)


@pytest.mark.parametrize("n,sizes", [(512, [512]), (513, [512, 1]),
                                     (600, [512, 88]),
                                     (1100, [512, 512, 76])])
def test_pack_slices_at_capacity(n, sizes):
    rng = np.random.default_rng(n)
    ids = rng.permutation(2000)[:n]
    slices = pack_ids(ids, 2000, what="scatter", capacity=K_MAX_SCATTER)
    assert [len(s.page_ids) for s in slices] == sizes
    assert [s.start for s in slices] == [512 * i for i in range(len(sizes))]
    assert [i for s in slices for i in s.page_ids] == ids.tolist()


def _pool(L=2, P=700, page=8, KV=2, Dh=8, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(L, P, page, KV, Dh))).float()


@pytest.mark.parametrize("n", [3, 600])
def test_scatter_on_the_cpu_takes_the_plain_version(n):
    """Past one launch's capacity too: every page written, the rest
    untouched, as the JAX kernel does; no kernel is launched."""
    pool = _pool()
    rng = np.random.default_rng(n)
    ids = rng.permutation(pool.shape[1])[:n]
    staging = torch.from_numpy(rng.normal(size=(2, n) + tuple(
        pool.shape[2:]))).float()
    want = jax_scatter(jnp.asarray(pool.numpy()), jnp.asarray(
        staging.numpy()), jnp.asarray(ids.astype(np.int32)))
    got = scatter_pages(pool.clone(), staging, ids)
    assert np.array_equal(got.numpy(), np.asarray(want))
    ref = page_scatter_ref(pool.clone(), staging, ids)
    assert torch.equal(got, ref)
    assert launch_counts()["page_scatter"] == 0


def test_cow_copy_goes_through_scatter_on_the_cpu():
    pool = _pool(seed=1)
    before = pool.clone()
    copy_pages(pool, [4, 9], [100, 200])
    assert torch.equal(pool[:, [100, 200]], before[:, [4, 9]])
    assert launch_counts()["page_scatter"] == 0


def test_kernel_refuses_cpu_pools():
    pool = _pool()
    with pytest.raises(ValueError, match="CUDA"):
        page_scatter_kernel(pool, pool[:, :1].contiguous(), [0])
    assert page_scatter_kernel.launches == 0
