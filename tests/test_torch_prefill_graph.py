"""The paged runtime's prefill and extend chunk on persistent buffers
(``PrefillGraphs``), and the device branch of ``write_cache``, on the CPU.

On the card a chunk is a CUDA graph per ``(model, mode, Sp, T)`` bucket;
on the CPU the same buckets and buffers are filled and the step runs
eagerly on them, so these tests go through the buffer reuse, the shared
scratch, the device-indexed gather and scatter and the clones that the
graphs rely on. The capture itself is held bitwise against the eager
chunk by ``chip_smoke.py`` (phases 3d and 6a).

Against the JAX package's ``PagedKVRuntime.prefill`` (its forward on the
CPU as its own tests run it), on the same params, tokens and page
layout: glm4 smoke in fp32 at ``tests/test_torch_runtime.py``'s
tolerance (rtol 2e-5, atol 5e-4: summation order only); in bf16,
argmax agreement and max |dlogit| <= 0.0625, the bound of
``tests/test_torch_families.py`` (two bf16 ulps at this logit scale).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.serving.paged_runtime import PagedKVRuntime as JaxRuntime
from repro.serving.paged_runtime import ProgramEntry as JaxEntry
from repro.serving.prefix import PrefixConfig as JaxPrefixConfig
from repro.serving.prefix import RadixPrefixIndex as JaxIndex
from repro_torch.configs import get_config
from repro_torch.kernels import kernel_wrappers, launch_counts
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models.common import params_from_numpy
from repro_torch.serving.decode_graph import StepGraphs
from repro_torch.serving.paged_runtime import PagedKVRuntime, ProgramEntry
from repro_torch.serving.prefill_graph import (SCRATCH_ROWS, PrefillBucket,
                                               PrefillGraphs, capacity,
                                               pack_chunk)
from repro_torch.serving.prefix import PrefixConfig, RadixPrefixIndex

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

FP32 = dict(rtol=2e-5, atol=5e-4)
BF16_MAX_ABS = 0.0625
PAGE = 8
# Each case: ops on fresh runtimes, ("prefill", pid, n tokens, pad_to),
# ("publish", pid), ("adopt", pid, max_tokens) or ("twin", pid, of). Every
# chunk's logits and the final pages, refcounts and pools are compared.
CASES = {
    # a fresh prompt padded 20 -> 32 (prefill mode, flash on the card)
    "fresh": [("prefill", "a", 20, 32)],
    # S = 1 in the smallest bucket, at a mid-page start
    "extend_s1": [("prefill", "a", 20, 32), ("prefill", "a", 1, 16)],
    # S = Sp: the chunk fills its bucket, crossing two page boundaries
    "extend_full": [("prefill", "a", 20, 32), ("prefill", "a", 16, 16)],
    # Sp buckets 16, 32, 64 in turn; the last crosses a capacity step
    "extend_buckets": [("prefill", "a", 13, 16), ("prefill", "a", 9, 16),
                       ("prefill", "a", 30, 32), ("prefill", "a", 37, 64)],
    # a chunk that starts on a page boundary and one that crosses one
    "page_boundary": [("prefill", "a", 16, 16), ("prefill", "a", 8, 16),
                      ("prefill", "a", 5, 16)],
    # capped adoption: d shares a's two pages at 15 tokens and recomputes
    # from mid-page into the shared page (a COW split), across a boundary
    "mid_page_adopt": [("prefill", "a", 20, 32), ("publish", "a"),
                       ("adopt", "d", 15), ("prefill", "d", 5, 16)],
    # b's last page shared with its twin c: b's extend COW-splits it
    "cow_last_page": [("prefill", "b", 13, 16), ("twin", "c", "b"),
                      ("prefill", "b", 4, 16), ("prefill", "c", 2, 16)],
}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def pair(request):
    jcfg = dataclasses.replace(jax_config("glm4-9b", smoke=True),
                               compute_dtype=request.param)
    jp = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("glm4-9b", smoke=True),
                               compute_dtype=request.param)
    tm = Model(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp)),
               device="cpu")
    return jcfg, jp, tm


def run_ops(rt, model, ops, as_input, index, vocab, seed=0):
    """``ops`` on ``rt`` (either package's runtime): each chunk's logits
    as fp32 numpy, tokens drawn per (seed, op) so both sides see the
    same ids."""
    out = []
    for i, op in enumerate(ops):
        if op[0] == "prefill":
            _, pid, n, pad = op
            toks = np.random.default_rng([seed, i]).integers(0, vocab, n)
            out.append(np.asarray(rt.prefill(model, pid, as_input(toks),
                                              pad_to=pad), np.float32))
        elif op[0] == "publish":
            rt.publish_prefix(index, op[1], (101, 202, 303))
        elif op[0] == "adopt":
            assert rt.adopt_prefix(index, op[1], (101, 202),
                                   max_tokens=op[2]) == op[2]
        else:
            _, twin, src = op
            e = rt.programs[src]
            for pi in e.pages:
                rt.refs[pi] += 1
            entry = JaxEntry if isinstance(rt, JaxRuntime) else ProgramEntry
            rt.programs[twin] = entry(list(e.pages), e.length)
    return out


def both(pair, ops):
    jcfg, jp, tm = pair
    rj = JaxRuntime(jcfg, n_pages=24, page_size=PAGE)
    rt = PagedKVRuntime(tm.cfg, n_pages=24, page_size=PAGE, device="cpu")
    ij, it = JaxIndex(JaxPrefixConfig()), RadixPrefixIndex(PrefixConfig())
    rj.attach_index(ij)
    rt.attach_index(it)
    lj = run_ops(rj, jp, ops, jnp.asarray, ij, jcfg.vocab_size)
    lt = run_ops(rt, tm, ops, torch.from_numpy, it, jcfg.vocab_size)
    rj.check(ij)
    rt.check(it)
    return rj, rt, lj, lt


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunks_match_jax_runtime(pair, case):
    """Each chunk's last-row logits, the pages, refcounts and free lists,
    and both pools, against the reference runtime on the same ops."""
    rj, rt, lj, lt = both(pair, CASES[case])
    bf16 = pair[2].cfg.compute_dtype == "bfloat16"
    for a, b in zip(lj, lt):
        if bf16:
            assert a.argmax() == b.argmax(), case
            assert np.abs(a - b).max() <= BF16_MAX_ABS, case
        else:
            np.testing.assert_allclose(b, a, err_msg=case, **FP32)
    assert rj.refs == rt.refs and rj.free == rt.free
    assert rj.cow_splits == rt.cow_splits
    for pid, e in rt.programs.items():
        assert rj.programs[pid].pages == e.pages
        assert rj.programs[pid].length == e.length
    for pj, pt in ((rj.k_pages, rt.k_pages), (rj.v_pages, rt.v_pages)):
        pj, pt = np.asarray(pj, np.float32), pt.float().numpy()
        if bf16:
            assert np.abs(pj - pt).max() <= BF16_MAX_ABS, case
        else:
            np.testing.assert_allclose(pt, pj, err_msg=case, **FP32)
    if case in ("mid_page_adopt", "cow_last_page"):
        assert rt.cow_splits >= 1


def smoke_model(dtype="float32", arch="qwen2-1.5b"):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=dtype)
    return Model(cfg, device="cpu", seed=0)


def tokens(n, seed, vocab):
    return torch.from_numpy(np.random.default_rng(seed).integers(0, vocab, n))


def chunks(rt, model, pid, sizes, pad, seed=0):
    return [rt.prefill(model, pid, tokens(n, [seed, i], model.cfg.vocab_size),
                       pad_to=pad) for i, n in enumerate(sizes)]


def test_two_programs_in_one_bucket_equal_fresh_runtimes():
    """Two programs through the same buckets of one runtime give, bit for
    bit, the logits, next tokens and KV of each on a fresh runtime of its
    own (other page ids, the scratch reused)."""
    model = smoke_model()
    shared = PagedKVRuntime(model.cfg, n_pages=32, page_size=PAGE,
                            device="cpu")
    got = {pid: chunks(shared, model, pid, (20, 5, 7), 32, seed=s)
           for s, pid in enumerate(("x", "y"))}
    assert len(shared.prefill_graphs.buckets()) == 2  # prefill, extend
    for s, pid in enumerate(("x", "y")):
        fresh = PagedKVRuntime(model.cfg, n_pages=32, page_size=PAGE,
                               device="cpu")
        want = chunks(fresh, model, pid, (20, 5, 7), 32, seed=s)
        assert all(torch.equal(a, b) for a, b in zip(got[pid], want))
        assert torch.equal(shared._last[pid], fresh._last[pid])
        for pool in ("k_pages", "v_pages"):
            a = getattr(shared, pool)[:, shared.pages_of(pid)]
            b = getattr(fresh, pool)[:, fresh.pages_of(pid)]
            n = shared.programs[pid].length
            assert torch.equal(a.flatten(1, 2)[:, :n], b.flatten(1, 2)[:, :n])
    assert shared.pages_of("y") != fresh.pages_of("y")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_in_dead_slots_and_scratch(dtype):
    """Every pool slot and the scratch filled with NaN before each chunk:
    the dead slots (page tails past a program's length, free pages, the
    scratch past the chunk) reach no logit: finite, and equal bit for bit
    to a runtime on zeroed pools."""
    model = smoke_model(dtype)
    clean = PagedKVRuntime(model.cfg, n_pages=16, page_size=PAGE,
                           device="cpu")
    dirty = PagedKVRuntime(model.cfg, n_pages=16, page_size=PAGE,
                           device="cpu")
    dirty.k_pages.fill_(float("nan"))
    dirty.v_pages.fill_(float("nan"))
    sizes = (13, 6, 1, 11, 30)           # 13 mid-page, then across pages
    for i, n in enumerate(sizes):
        toks = tokens(n, [7, i], model.cfg.vocab_size)
        pad = 16 if n <= 16 else 32
        a = clean.prefill(model, "p", toks, pad_to=pad)
        sc = dirty.prefill_graphs._scratch
        if sc is not None:
            for t in sc.values():
                t.fill_(float("nan"))
        b = dirty.prefill(model, "p", toks, pad_to=pad)
        assert torch.isfinite(b).all() and torch.equal(a, b), i
    n = clean.programs["p"].length
    for pool in ("k_pages", "v_pages"):
        a = getattr(clean, pool)[:, clean.pages_of("p")].flatten(1, 2)[:, :n]
        b = getattr(dirty, pool)[:, dirty.pages_of("p")].flatten(1, 2)[:, :n]
        assert torch.equal(a, b)


@pytest.mark.parametrize("start,S,pad", [(0, 5, 16), (13, 2, 16),
                                         (13, 16, 16), (20, 9, 32)])
def test_padded_rows_write_no_page(start, S, pad):
    """Only the chunk's S real slots change: no padded row lands in any
    page, page 0 (free here, and the decode tables' padding sentinel)
    included."""
    model = smoke_model()
    rt = PagedKVRuntime(model.cfg, n_pages=8, page_size=PAGE, device="cpu")
    if start:
        rt.prefill(model, "p", tokens(start, 1, model.cfg.vocab_size))
    for pool in (rt.k_pages, rt.v_pages):
        pool.fill_(7.0)
    before = [rt.k_pages.clone(), rt.v_pages.clone()]
    rt.prefill(model, "p", tokens(S, 2, model.cfg.vocab_size), pad_to=pad)
    pages = rt.pages_of("p")
    assert 0 not in pages
    for old, new in zip(before, (rt.k_pages, rt.v_pages)):
        changed = (old != new).any(-1).any(-1).any(0)        # (P, page)
        want = torch.zeros_like(changed)
        for pos in range(start, start + S):
            want[pages[pos // PAGE], pos % PAGE] = True
        assert torch.equal(changed, want)


@pytest.mark.parametrize("ring,offsets,C", [
    (ring, offsets, C) for ring in (False, True) for offsets, C in (
        ((0, 3), 4), ((9, 2), 4),     # row 0 clamped to W - C = 8
        ((12, 0), 1), ((5, 7), 12))   # 12 > W - C: clamped; a ring wraps
] + [(True, (4, 11), 14)])            # a ring keeps the chunk's last 12
def test_write_cache_device_branch_equals_host(ring, offsets, C):
    """Offsets as a tensor write what int offsets write, bit for bit: the
    plain cache's start clamped to W - C, a ring's slots mod W, and a
    chunk longer than the ring keeping its last W tokens; the host
    branch is not reached."""
    W = 12
    rng = np.random.default_rng(3)
    caches = [torch.from_numpy(rng.normal(size=(2, W, 2, 4))).float()
              for _ in range(2)]
    new = [torch.from_numpy(rng.normal(size=(2, C, 2, 4))).float()
           for _ in range(2)]
    host = [c.clone() for c in caches]
    for b, s in enumerate(offsets):          # int offsets, row by row
        attn.write_cache(host[0][b:b + 1], host[1][b:b + 1],
                         new[0][b:b + 1], new[1][b:b + 1], int(s), ring=ring)
    dev = [c.clone() for c in caches]
    with no_host_reads():
        attn.write_cache(dev[0], dev[1], *new, torch.tensor(offsets),
                         ring=ring)
    assert torch.equal(host[0], dev[0]) and torch.equal(host[1], dev[1])


class no_host_reads(torch.overrides.TorchFunctionMode):
    """Within the block, reading a tensor's value on the host raises (on
    the card each would be a stream sync, which a capture refuses), and
    so does ``attention._offsets``, the host branch's reader."""
    READS = (torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__int__,
             torch.Tensor.__bool__, torch.Tensor.__index__,
             torch.Tensor.__float__)

    def __enter__(self):
        self._offsets = attn._offsets
        attn._offsets = self._refuse
        return super().__enter__()

    def __exit__(self, *exc):
        attn._offsets = self._offsets
        return super().__exit__(*exc)

    @staticmethod
    def _refuse(*args):
        raise AssertionError("the host branch of write_cache was reached")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise AssertionError(f"a device value read on the host: {func}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-235b-a22b",
                                  "musicgen-large"])
def test_step_reads_no_device_value_on_the_host(arch):
    """The chunk step of both modes reads no tensor value on the host and
    never reaches the host branch of ``write_cache`` (``_offsets``):
    the dense, MoE and audio (sinusoidal positions) families."""
    model = smoke_model("bfloat16", arch)
    rt = PagedKVRuntime(model.cfg, n_pages=16, page_size=PAGE, device="cpu")
    first = tokens(20, 0, model.cfg.vocab_size)
    rest = tokens(6, 1, model.cfg.vocab_size)
    ref = PagedKVRuntime(model.cfg, n_pages=16, page_size=PAGE, device="cpu")
    want = [ref.prefill(model, "p", t, pad_to=32) for t in (first, rest)]
    got = []
    for t in (first, rest):
        with no_host_reads():
            got.append(rt.prefill(model, "p", t, pad_to=32))
    assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_outputs_do_not_alias_the_buffers():
    """The logits and next token of a chunk are unchanged by the next
    chunk of the same bucket, and share no storage with its buffers."""
    model = smoke_model()
    rt = PagedKVRuntime(model.cfg, n_pages=16, page_size=PAGE, device="cpu")
    rt.prefill(model, "p", tokens(20, 0, model.cfg.vocab_size), pad_to=32)
    first = rt.prefill(model, "p", tokens(3, 1, model.cfg.vocab_size),
                       pad_to=16)
    kept, nxt = first.clone(), rt._last["p"]
    nxt_kept = nxt.clone()
    (bucket,) = [b for key, b in rt.prefill_graphs.buckets().items()
                 if key[0] == "extend"]
    second = rt.prefill(model, "p", tokens(4, 2, model.cfg.vocab_size),
                        pad_to=16)
    assert [b for key, b in rt.prefill_graphs.buckets().items()
            if key[0] == "extend"] == [bucket]                # reused
    assert torch.equal(first, kept) and torch.equal(nxt, nxt_kept)
    assert not torch.equal(first, second)
    bufs = {bucket.logits.untyped_storage().data_ptr(),
            bucket.nxt.untyped_storage().data_ptr()}
    for t in (first, second, nxt, rt._last["p"]):
        assert t.untyped_storage().data_ptr() not in bufs
    assert torch.equal(bucket.logits, second)
    assert bucket.logits.dtype == torch.float32 and bucket.nxt.dim() == 0


def test_grow_new_pools_and_a_larger_scratch_drop_the_buckets():
    """``grow`` replaces the pools, which the graphs address: it drops
    every bucket; pools reassigned otherwise are noticed at the next
    chunk; a capacity past the scratch (first made at ``SCRATCH_ROWS``)
    grows it at least twofold and drops the buckets viewing the old
    one."""
    model = smoke_model()
    rt = PagedKVRuntime(model.cfg, n_pages=64, page_size=PAGE, device="cpu")
    chunks(rt, model, "p", (20, 4), 32)
    assert rt.prefill_graphs.buckets()
    rt.grow(rt.n_pages + 8)
    assert not rt.prefill_graphs.buckets() and not rt.graphs.buckets()
    chunks(rt, model, "p", (4,), 16)
    (old,) = rt.prefill_graphs.buckets().values()
    rt.k_pages = rt.k_pages.clone()
    chunks(rt, model, "p", (4,), 16)
    (new,) = rt.prefill_graphs.buckets().values()
    assert new is not old
    g = rt.prefill_graphs
    scratch = g._scratch["k"]
    assert scratch.shape[2] == SCRATCH_ROWS     # no regrowth below it
    k, v = g._scratch_views(model, SCRATCH_ROWS + 1)
    assert not g.buckets()
    grown = g._scratch["k"]
    assert grown.shape[2] == 2 * SCRATCH_ROWS
    assert k.data_ptr() == grown.data_ptr() and k.shape[2] == \
        SCRATCH_ROWS + 1
    chunks(rt, model, "p", (4,), 16)
    (b,) = g.buckets().values()
    assert b.k.data_ptr() == grown.data_ptr() and b.k.shape[2] == 512


def test_buckets_per_model_and_refusals():
    """A graph holds weight addresses: another model object gets its own
    buckets; with graphs on, a trainable or meshed model is refused
    before any page is allocated or written (the eager chunk runs a
    trainable one)."""
    model = smoke_model()
    twin = Model(model.cfg, dict(model.params), device="cpu")
    rt = PagedKVRuntime(model.cfg, n_pages=16, page_size=PAGE, device="cpu")
    rt.prefill(model, "a", tokens(5, 0, model.cfg.vocab_size), pad_to=16)
    rt.prefill(twin, "b", tokens(5, 0, model.cfg.vocab_size), pad_to=16)
    assert len(rt.prefill_graphs._buckets) == 2
    assert torch.equal(rt._last["a"], rt._last["b"])
    trainable = Model(model.cfg, device="cpu", seed=0, trainable=True)
    free = list(rt.free)
    with pytest.raises(ValueError, match="trainable"):
        rt.prefill(trainable, "c", tokens(5, 0, model.cfg.vocab_size))
    meshed = smoke_model()
    meshed.mesh = object()                   # what a DeviceMesh would be
    with pytest.raises(ValueError, match="meshed"):
        rt.prefill(meshed, "a", tokens(5, 0, model.cfg.vocab_size))
    with pytest.raises(ValueError, match="empty"):
        rt.prefill(model, "a", torch.zeros(0, dtype=torch.long))
    assert "c" not in rt.programs and rt.free == free
    assert rt.programs["a"].length == 5
    rt.cuda_graphs = False          # the eager chunk takes a trainable one
    rt.prefill(trainable, "c", tokens(5, 0, model.cfg.vocab_size))
    assert torch.equal(rt._last["c"], rt._last["a"])


@pytest.mark.parametrize("start,Sp,want", [
    (0, 16, 16), (0, 2040, 2040), (1, 16, 512), (496, 16, 512),
    (497, 16, 1024), (2048, 512, 2560), (2040, 16, 2560),
    (2100, 512, 3072)])
def test_capacity(start, Sp, want):
    assert capacity(start, Sp) == want
    if start:
        assert capacity(start, Sp, step=16) == -(-(start + Sp) // 16) * 16


def test_pack_chunk_layout():
    """Tokens padded with zeros; start; S - 1; the scatter's scratch rows
    and flat pool rows, padded rows repeating the last real one; the
    gather's flat pool rows below start, 0 above."""
    pages = [5, 2, 7]
    host = pack_chunk(np.array([11, 12, 13]), 6, 3, 4, 16, pages, 4)
    toks, head, src, dst, gather = np.split(host, [4, 6, 10, 14])
    assert host.dtype == np.int32
    assert toks.tolist() == [11, 12, 13, 0] and head.tolist() == [6, 2]
    assert src.tolist() == [6, 7, 8, 8]
    assert dst.tolist() == [2 * 4 + 2, 2 * 4 + 3, 7 * 4 + 0, 7 * 4 + 0]
    assert gather.tolist() == [20, 21, 22, 23, 8, 9] + [0] * 10
    fresh = pack_chunk(np.array([1, 2]), 0, 2, 2, 2, [3], 4)
    assert fresh.tolist() == [1, 2, 0, 1, 0, 1, 12, 13]


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("family,capture_at", [(PrefillGraphs, 2),
                                               (StepGraphs, 1)])
def test_capture_use_and_replay_accounting(family, capture_at, monkeypatch):
    """Uses before ``capture_at`` run the step eagerly; use ``capture_at``
    captures; every later use replays, counts a replay and credits the
    launches counted at capture, and runs no step. ``graphs=False``
    always runs the step."""
    assert family.capture_at == capture_at
    rt = PagedKVRuntime(get_config("qwen2-1.5b", smoke=True), n_pages=4,
                        device="cpu")
    g = family(rt)
    g.capture = True                     # as on the card
    runs, captured_at = [], []

    def fake_capture(b, step):
        captured_at.append(b.uses + 1)
        b.graph, b.launches = FakeGraph(), {"flash_attention": 28}

    monkeypatch.setattr(g, "_capture", fake_capture)
    b = PrefillBucket(*(None,) * 11)
    before = launch_counts()
    for _ in range(capture_at + 3):
        g._run(b, lambda: runs.append(1))
    g._run(b, lambda: runs.append(1), graphs=False)
    assert len(runs) == capture_at and captured_at == [capture_at]
    assert g.replays == b.graph.replays == 3
    after = launch_counts()
    assert after["flash_attention"] - before["flash_attention"] == 84
    for name, fn in kernel_wrappers().items():
        fn.launches = before[name]
