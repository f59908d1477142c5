"""The host side of the port's token append, on the CPU: the page ids and
offsets travel by value in the launch (``pack_append_args``), validated as
plain integers and cut into launches of at most ``K_MAX_APPEND`` rows.
The CUDA kernel itself is held against its plain version bit for bit by
``chip_smoke.py`` phase 2 (B=8 at qwen2-1.5b width, the smoke shapes, and
300 rows)."""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.page_copy import append_tokens, append_tokens_ref
from repro_torch.kernels.page_copy.kernel import (K_MAX_APPEND,
                                                  pack_append_args,
                                                  token_append_kernel)

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / \
    "repro_torch" / "csrc" / "page_copy.cu"


def test_capacity_matches_the_kernel_source():
    """The slice size is the capacity of the kernel's parameter struct."""
    m = re.search(r"constexpr int kMaxAppend = (\d+);", CSRC.read_text())
    assert m and int(m.group(1)) == K_MAX_APPEND == 256
    # 2 x 256 int32 in the parameter block: inside the 4 KB limit
    assert 2 * 4 * K_MAX_APPEND <= 4096 - 256


@pytest.mark.parametrize("ids,offs", [
    ([3, 0, 7, 5], [0, 7, 3, 3]), ([0], [0]), ([], []),
    (np.array([9, 2], np.int64), np.array([1, 6], np.int64))])
def test_pack_round_trips(ids, offs):
    slices = pack_append_args(ids, offs, P=10, page=8)
    got_ids = [i for s in slices for i in s.page_ids]
    got_offs = [o for s in slices for o in s.offsets]
    assert got_ids == list(map(int, ids)) and got_offs == list(map(int, offs))
    assert [s.start for s in slices] == ([0] if len(ids) else [])


@pytest.mark.parametrize("ids,offs,what", [
    ([3, -1], [0, 0], "page ids outside"),
    ([3, 10], [0, 0], "page ids outside"),
    ([3, 4], [0, -1], "offsets outside"),
    ([3, 4], [8, 0], "offsets outside"),
    ([3, 4, 3], [0, 1, 2], "pairwise distinct"),
    ([3, 4], [0], "offsets")])
def test_pack_rejects_bad_rows(ids, offs, what):
    with pytest.raises(ValueError, match=what):
        pack_append_args(ids, offs, P=10, page=8)


def test_pack_splits_a_large_batch():
    """300 rows: one launch of 256 and one of 44, every row once."""
    rng = np.random.default_rng(0)
    ids = rng.permutation(400)[:300]
    offs = rng.integers(0, 16, size=300)
    slices = pack_append_args(ids, offs, P=400, page=16)
    assert [(s.start, len(s.page_ids)) for s in slices] == [(0, 256),
                                                           (256, 44)]
    rows = [s.start + i for s in slices for i in range(len(s.page_ids))]
    assert rows == list(range(300))
    assert [i for s in slices for i in s.page_ids] == ids.tolist()
    assert [o for s in slices for o in s.offsets] == offs.tolist()


def test_large_batch_on_the_cpu_takes_the_plain_version():
    """The dispatcher at 300 rows: the CPU pool takes the plain version,
    which writes every row; no kernel is launched."""
    rng = np.random.default_rng(1)
    L, P, page, KV, Dh, B = 2, 320, 8, 2, 8, 300
    kp = torch.from_numpy(rng.normal(size=(L, P, page, KV, Dh))).float()
    vp = kp.clone()
    kt = torch.from_numpy(rng.normal(size=(L, B, KV, Dh))).float()
    vt = kt + 1
    ids, offs = rng.permutation(P)[:B], rng.integers(0, page, size=B)
    k2, v2 = kp.clone(), vp.clone()
    append_tokens(kp, vp, kt, vt, ids, offs)
    append_tokens_ref(k2, v2, kt, vt, ids, offs)
    assert torch.equal(kp, k2) and torch.equal(vp, v2)
    assert torch.equal(kp[:, ids, offs], kt) and torch.equal(vp[:, ids, offs],
                                                             vt)
    assert token_append_kernel.launches == 0


def test_kernel_refuses_cpu_pools():
    pool = torch.zeros((1, 4, 2, 1, 8))
    tok = torch.zeros((1, 1, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        token_append_kernel(pool, pool, tok, tok, [0], [0])
