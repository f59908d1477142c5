"""The paged runtime's decode step on persistent buffers (``DecodeGraphs``)
and the device-indexed token append, on the CPU.

On the card the step is a CUDA graph per ``(model, B, n_tab)`` bucket; on
the CPU the same buckets and buffers are filled and the step runs eagerly
on them, so these tests go through the buffer reuse, the clones and the
cache invalidation the graphs rely on. The capture itself, and the CUDA
kernel of the indexed append, are held bitwise against the eager step and
the plain version by ``chip_smoke.py`` (phases 2, 3c and 6a).
"""
import dataclasses
import gc
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import Model as JaxModel
from repro.serving.paged_runtime import PagedKVRuntime as JaxRuntime
from repro_torch.configs import get_config
from repro_torch.kernels import _build, kernel_wrappers, launch_counts
from repro_torch.kernels.page_copy import (append_tokens_indexed,
                                           append_tokens_ref,
                                           token_append_indexed_kernel)
from repro_torch.models import Model
from repro_torch.models.common import params_from_numpy
from repro_torch.serving.decode_graph import credit_launches
from repro_torch.serving.paged_runtime import PagedKVRuntime, ProgramEntry

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / \
    "repro_torch" / "csrc" / "page_copy.cu"
PAGE = 16
# p0 (28 tokens, two pages) appends at offsets 12..15, then at offset 0
# of a third page in step 4, where the tables widen from 2 to 4 pages;
# p3 is p1's twin on shared pages, so p1's first append COW-splits its
# last page in the middle of the batch; rows change and reorder
PROMPTS = (28, 20, 9)
SCHEDULE = ((4, (0, 1, 2)), (4, (0, 1, 2, 3)), (6, (2, 0, 3)))


def smoke_model(arch: str, dtype: str) -> Model:
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=dtype)
    return Model(cfg, device="cpu", seed=0)


def serving(model, cuda_graphs: bool) -> PagedKVRuntime:
    """PROMPTS prefilled from numpy-seeded tokens, and p1's twin."""
    rt = PagedKVRuntime(model.cfg, n_pages=16, page_size=PAGE, device="cpu",
                        cuda_graphs=cuda_graphs)
    rng = np.random.default_rng(0)
    for i, n in enumerate(PROMPTS):
        rt.prefill(model, f"p{i}", torch.from_numpy(
            rng.integers(0, model.cfg.vocab_size, n)))
    src = rt.programs["p1"]
    for pi in src.pages:
        rt.refs[pi] += 1
    rt.programs["p3"] = ProgramEntry(list(src.pages), src.length)
    rt.seed_token("p3", 5)
    return rt


def steps(rt, model):
    """Run SCHEDULE; yield (rows, offsets, n_tab, logits, next tokens)."""
    for count, rows in SCHEDULE:
        pids = [f"p{i}" for i in rows]
        for _ in range(count):
            offs = [rt.programs[p].length % PAGE for p in pids]
            pages = max(-(-(rt.programs[p].length + 1) // PAGE)
                        for p in pids)
            logits = torch.stack(rt.decode_batch(model, pids))
            nxt = torch.stack([rt._last[p] for p in pids])
            yield pids, offs, 1 << (pages - 1).bit_length(), logits, nxt


@pytest.mark.parametrize("arch,dtype", [
    ("qwen2-1.5b", "bfloat16"), ("qwen2-1.5b", "float32"),
    ("qwen3-moe-235b-a22b", "bfloat16")])
def test_static_buffer_step_matches_eager_bitwise(arch, dtype):
    """14 steps through the bucket buffers equal the eager step bit for
    bit in logits, next tokens and both pools, across a change of batch
    rows, a table-width bucket (2 -> 4 pages), a page boundary (offset 15
    -> 0) and a COW split in the middle of a batch."""
    model = smoke_model(arch, dtype)
    eager, graphs = serving(model, False), serving(model, True)
    seen_offs, widths = [], set()
    for (pe, oe, we, le, ne), (pg, og, wg, lg, ng) in zip(
            steps(eager, model), steps(graphs, model)):
        assert (pe, oe, we) == (pg, og, wg)
        assert torch.equal(le, lg) and torch.equal(ne, ng)
        seen_offs.append(oe[pe.index("p0")])
        widths.add(we)
    assert len(seen_offs) == 14
    assert [15, 0] == seen_offs[3:5] and widths == {2, 4}
    assert torch.equal(eager.k_pages, graphs.k_pages)
    assert torch.equal(eager.v_pages, graphs.v_pages)
    assert eager.cow_splits == graphs.cow_splits == 1
    assert eager.refs == graphs.refs and eager.free == graphs.free
    assert sorted(graphs.graphs.buckets()) == [(3, 2), (3, 4), (4, 4)]
    assert not eager.graphs.buckets()
    assert graphs.graphs.captures == 0 == graphs.graphs.replays
    graphs.check()
    assert launch_counts() == {name: 0 for name in kernel_wrappers()}


def test_outputs_do_not_alias_the_buffers():
    """Logits and next tokens of step t are unchanged by step t + 1 of the
    same bucket, and share no storage with the bucket's buffers."""
    model = smoke_model("qwen2-1.5b", "float32")
    rt = serving(model, True)
    pids = ["p1", "p2"]
    first = rt.decode_batch(model, pids)
    kept = [x.clone() for x in first]
    last = {p: rt._last[p].clone() for p in pids}
    (bucket,) = rt.graphs.buckets().values()
    second = rt.decode_batch(model, pids)
    assert list(rt.graphs.buckets().values()) == [bucket]   # reused
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    assert not any(torch.equal(a, b) for a, b in zip(first, second))
    bufs = {bucket.logits.untyped_storage().data_ptr(),
            bucket.nxt.untyped_storage().data_ptr()}
    for t in first + second + [rt._last[p] for p in pids]:
        assert t.untyped_storage().data_ptr() not in bufs
    assert torch.equal(bucket.logits, torch.stack(second))
    # the first step's next tokens fed the second
    assert not all(torch.equal(rt._last[p], last[p]) for p in pids)


def test_grow_and_new_pools_drop_the_cache():
    """``grow`` replaces the pools, and the graphs hold their addresses:
    it empties the cache; pools reassigned any other way are noticed at
    the next step."""
    model = smoke_model("qwen2-1.5b", "float32")
    rt = serving(model, True)
    rt.decode_batch(model, ["p0"])
    assert rt.graphs.buckets()
    rt.grow(rt.n_pages + 8)
    assert not rt.graphs.buckets()
    rt.decode_batch(model, ["p0"])
    (old,) = rt.graphs.buckets().values()
    rt.k_pages = rt.k_pages.clone()
    rt.decode_batch(model, ["p0"])
    (new,) = rt.graphs.buckets().values()
    assert new is not old


def test_each_model_has_its_own_buckets():
    """A graph captures weight addresses: another model object gets its
    own buckets (same shapes), dropped when that model is freed."""
    model = smoke_model("qwen2-1.5b", "float32")
    twin = Model(model.cfg, dict(model.params), device="cpu")
    rt = serving(model, True)
    rt.decode_batch(model, ["p2"])
    assert len(rt.graphs._buckets) == 1
    rt.decode_batch(twin, ["p2"])            # the same (B, n_tab)
    assert len(rt.graphs._buckets) == 2 and len(rt.graphs.buckets()) == 1
    del twin
    gc.collect()
    assert len(rt.graphs._buckets) == 1


def test_graph_path_refuses_trainable_and_meshed_models():
    cfg = get_config("qwen2-1.5b", smoke=True)
    trainable = Model(cfg, device="cpu", seed=0, trainable=True)
    rt = PagedKVRuntime(cfg, n_pages=8, page_size=PAGE, device="cpu")
    rt.programs["a"] = ProgramEntry([rt._alloc_page()], 3)
    rt.seed_token("a", 1)
    with pytest.raises(ValueError, match="trainable"):
        rt.decode_batch(trainable, ["a"])
    meshed = smoke_model("qwen2-1.5b", "float32")
    meshed.mesh = object()                   # what a DeviceMesh would be
    with pytest.raises(ValueError, match="meshed"):
        rt.decode_batch(meshed, ["a"])
    assert rt.programs["a"].length == 3      # no step was taken
    assert PagedKVRuntime(cfg, device="cpu").cuda_graphs is True


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_indexed_append_plain_path_equals_by_value(dtype):
    """The device-indexed append's plain path (a CPU pool) writes what the
    by-value plain version writes, bit for bit, and nothing else."""
    rng = np.random.default_rng(2)
    L, P, page, KV, Dh, B = 3, 20, 8, 2, 16, 5
    pools = [torch.from_numpy(rng.normal(size=(L, P, page, KV, Dh))).to(
        dtype) for _ in range(2)]
    toks = [torch.from_numpy(rng.normal(size=(L, B, KV, Dh))).to(dtype)
            for _ in range(2)]
    ids, offs = rng.permutation(P)[:B], rng.integers(0, page, size=B)
    by_value = [x.clone() for x in pools]
    append_tokens_indexed(*pools, *toks, torch.from_numpy(ids.astype(
        np.int32)), torch.from_numpy(offs.astype(np.int32)))
    append_tokens_ref(*by_value, *toks, ids, offs)
    assert all(torch.equal(a, b) for a, b in zip(pools, by_value))
    assert torch.equal(pools[0][:, ids, offs], toks[0])
    assert launch_counts()["token_append_indexed"] == 0


def _slots(B=2):
    return (torch.tensor([3, 1][:B], dtype=torch.int32),
            torch.tensor([0, 5][:B], dtype=torch.int32))


@pytest.mark.parametrize("bad,what", [
    (lambda i, o: (i.long(), o), "page_ids must be a contiguous 1-D int32"),
    (lambda i, o: (i, o.long()), "offsets must be a contiguous 1-D int32"),
    (lambda i, o: (i[:, None], o), "page_ids must be"),
    (lambda i, o: (torch.stack([i, i], 1)[:, 0], o), "page_ids must be"),
    (lambda i, o: (i, o[:1]), "2 page ids but 1 offsets"),
    (lambda i, o: (i.tolist(), o), "page_ids must be"),
    (lambda i, o: (i[:1], o[:1]), "token rows"),
    (lambda i, o: (i, o), "CUDA"),
])
def test_indexed_wrapper_refuses_before_any_launch(bad, what):
    """Wrong dtypes, shapes and layouts of the slots, token rows that do
    not fit, and (last) a CPU pool: ``ValueError`` before anything is
    built or launched."""
    pool = torch.zeros(2, 6, 8, 2, 16)
    tok = torch.zeros(2, 2, 2, 16)
    ids, offs = bad(*_slots())
    with pytest.raises(ValueError, match=what):
        token_append_indexed_kernel(pool, pool.clone(), tok, tok.clone(),
                                    ids, offs)
    assert token_append_indexed_kernel.launches == 0
    assert not _build._libs


def test_indexed_launch_signature_matches_the_source():
    """The C entry point takes the 12 arguments the wrapper binds: six
    pointers, four ints, the row bytes and the stream."""
    m = re.search(r"int token_append_indexed_launch\(([^)]*)\)",
                  CSRC.read_text())
    args = [a.split()[-1].lstrip("*") for a in m.group(1).split(",")]
    assert args == ["k_pool", "v_pool", "k_tok", "v_tok", "page_ids",
                    "offsets", "B", "L", "P", "page", "tok_bytes", "stream"]
    assert "append_indexed_kernel<<<dim3(B, L)" in CSRC.read_text()


@pytest.mark.parametrize("captured,replays,want", [
    ({"paged_decode_attention": 56, "token_append_indexed": 1}, 3,
     {"paged_decode_attention": 168, "token_append_indexed": 3}),
    ({"paged_decode_attention": 4}, 0, {"paged_decode_attention": 0}),
    ({}, 7, {})])
def test_replay_launch_accounting(captured, replays, want):
    """A replay calls no wrapper: its launches are the capture's counts,
    once a replay, credited to the wrappers."""
    before = launch_counts()
    for _ in range(replays):
        credit_launches(captured)
    after = launch_counts()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {k: v for k, v in want.items()
                                          if v}
    for name, fn in kernel_wrappers().items():
        fn.launches = before[name]


def test_decode_steps_match_jax_runtime():
    """The reference's ``PagedKVRuntime.decode_batch`` (its Pallas kernels
    in interpret mode, as its own tests run them) against the port's
    step on the bucket buffers, on the same params, tokens and tables:
    glm4 smoke in fp32, four ragged steps across a page boundary, the
    tolerance of ``tests/test_torch_runtime.py::
    test_op_sequence_matches_jax_runtime`` (rtol 2e-5, atol 5e-4: the two
    differ only in summation order)."""
    jcfg = dataclasses.replace(jax_config("glm4-9b", smoke=True),
                               compute_dtype="float32")
    jp = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("glm4-9b", smoke=True),
                               compute_dtype="float32")
    tm = Model(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp)),
               device="cpu")
    rj = JaxRuntime(jcfg, n_pages=12, page_size=8)
    rt = PagedKVRuntime(tcfg, n_pages=12, page_size=8, device="cpu")
    assert rt.cuda_graphs
    rng = np.random.default_rng(3)
    for pid, n in (("a", 14), ("b", 5)):
        toks = rng.integers(0, jcfg.vocab_size, n)
        rj.prefill(jp, pid, jnp.asarray(toks))
        rt.prefill(tm, pid, torch.from_numpy(toks))
    for _ in range(4):                      # a: 14 -> 18 crosses 16
        for a, b in zip(rj.decode_batch(jp, ["a", "b"]),
                        rt.decode_batch(tm, ["a", "b"])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a, np.float32),
                                       rtol=2e-5, atol=5e-4)
        assert rj.pages_of("a") == rt.pages_of("a")
    assert rt.programs["a"].length == 18 and rt.graphs.buckets()


class _Recorder:
    """A stand-in for ``torch.cuda.CUDAGraph``'s capture calls."""

    def __init__(self):
        self.calls = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.calls.append("begin")

    def capture_end(self):
        self.calls.append("end")


@pytest.mark.parametrize("fails", [False, True])
def test_capture_keeps_the_cycle_collector_out(fails):
    """No collection runs while a step is recorded (one may destroy an
    unreachable graph, which breaks the capture), and the collector is
    back as it was afterwards, also when the step raises."""
    from repro_torch.serving import decode_graph
    seen = []

    def step():
        seen.append(gc.isenabled())
        if fails:
            raise RuntimeError("step failed")

    graph = _Recorder()
    assert gc.isenabled()
    if fails:
        with pytest.raises(RuntimeError, match="step failed"):
            decode_graph.capture(graph, None, step)
    else:
        decode_graph.capture(graph, None, step)
    assert seen == [False] and gc.isenabled()
    assert graph.calls == ["begin", "end"]
    gc.disable()
    try:
        decode_graph.capture(_Recorder(), None, lambda: None)
        assert not gc.isenabled()
    finally:
        gc.enable()
