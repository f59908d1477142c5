"""The port's ``PagedKVRuntime`` against the JAX package's, op for op, and
the batched-decode properties of ``tests/test_decode_batch.py`` on the
port.

The same op sequence (prefill, ragged ``decode_batch``, pin/evict, a radix
``adopt_prefix`` with a mid-page COW split, ``stage_out``/``restore``)
must leave both runtimes with identical page ids, refcounts and free
lists (allocation is ``free.pop()`` on both sides), and logits within the
fp32 bound: the glm4 smoke model under the fp32 override, where the two
differ only in summation order (the Pallas kernel's online softmax over
pages against one softmax per row), rtol 2e-5 / atol 5e-4 on logits of
magnitude ~4. The decode-batch properties run in bf16, where they are
bit-exact by construction.
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
from repro.serving.prefix import PrefixConfig as JaxPrefixConfig
from repro.serving.prefix import RadixPrefixIndex as JaxIndex
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.common import params_from_numpy
from repro_torch.serving.paged_runtime import PagedKVRuntime, ProgramEntry
from repro_torch.serving.prefix import PrefixConfig, RadixPrefixIndex

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

FP32 = dict(rtol=2e-5, atol=5e-4)


def close(a, b):
    np.testing.assert_allclose(np.asarray(b, np.float32),
                               np.asarray(a, np.float32), **FP32)


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_config("glm4-9b", smoke=True),
                               compute_dtype="float32")
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(get_config("glm4-9b", smoke=True),
                               compute_dtype="float32")
    tm = Model(tcfg, params_from_numpy(jax.tree.map(np.asarray, jp)),
               device="cpu")
    return jcfg, jm, jp, tcfg, tm


def same_state(rj, rt, pids):
    assert rj.refs == rt.refs
    assert rj.free == rt.free
    for pid in pids:
        assert rj.pages_of(pid) == rt.pages_of(pid), pid
        assert rj.programs[pid].length == rt.programs[pid].length


def test_op_sequence_matches_jax_runtime(pair):
    jcfg, jm, jp, tcfg, tm = pair
    rng = np.random.default_rng(0)
    toks = {p: rng.integers(0, jcfg.vocab_size, n)
            for p, n in (("A", 20), ("B", 13), ("C", 24))}
    rj = JaxRuntime(jcfg, n_pages=24, page_size=8)
    rt = PagedKVRuntime(tcfg, n_pages=24, page_size=8, device="cpu")

    for p in ("A", "B"):                        # prefill: ragged programs
        close(rj.prefill(jp, p, jnp.asarray(toks[p])),
              rt.prefill(tm, p, torch.from_numpy(toks[p])))
    same_state(rj, rt, ["A", "B"])

    for a, b in zip(rj.decode_batch(jp, ["A", "B"]),       # ragged batch
                    rt.decode_batch(tm, ["A", "B"])):
        close(a, b.float())
    same_state(rj, rt, ["A", "B"])

    for r, m, c in ((rj, jp, jnp.asarray(toks["C"])),       # pin / churn
                    (rt, tm, torch.from_numpy(toks["C"]))):
        r.pin("A")
        r.prefill(m, "C", c)
        assert r.evict("C") is True
        assert r.evict("A") is False                # pinned: refused
    same_state(rj, rt, ["A", "B"])

    # radix publish of A's two full pages, then D adopts 15 of its tokens
    # and recomputes the 16th into the shared page: a mid-page COW split
    ij, it = JaxIndex(JaxPrefixConfig()), RadixPrefixIndex(PrefixConfig())
    rj.attach_index(ij)
    rt.attach_index(it)
    assert rj.publish_prefix(ij, "A", (101, 202)) == \
        rt.publish_prefix(it, "A", (101, 202)) == 0
    assert rj.adopt_prefix(ij, "D", (101, 202), max_tokens=15) == \
        rt.adopt_prefix(it, "D", (101, 202), max_tokens=15) == 15
    same_state(rj, rt, ["A", "B", "D"])
    close(rj.prefill(jp, "D", jnp.asarray(toks["A"][15:16])),
          rt.prefill(tm, "D", torch.from_numpy(toks["A"][15:16])))
    assert rj.cow_splits == rt.cow_splits == 1
    same_state(rj, rt, ["A", "B", "D"])

    # tier move: stage B out, free it, restore into fresh pages
    kj, vj, nj = rj.stage_out("B")
    kt, vt, nt = rt.stage_out("B")
    assert nj == nt and tuple(kj.shape) == tuple(kt.shape)
    close(kj, kt)
    close(vj, vt)
    rj.evict("B", force=True)
    rt.evict("B", force=True)
    assert rj.restore("B", kj, vj, nj) == rt.restore("B", kt.clone(),
                                                     vt.clone(), nt)
    same_state(rj, rt, ["A", "B", "D"])
    rj.seed_token("B", 17)              # eviction dropped B's last token
    rt.seed_token("B", 17)

    for a, b in zip(rj.decode_batch(jp, ["A", "B", "D"]),
                    rt.decode_batch(tm, ["A", "B", "D"])):
        close(a, b.float())
    same_state(rj, rt, ["A", "B", "D"])
    rj.check(ij)
    rt.check(it)


def test_paged_decode_matches_dense_model(pair):
    """Paged decode against the contiguous-cache ``Model.forward`` oracle
    of the port itself (fp32)."""
    _, _, _, tcfg, tm = pair
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, 24))
    cache = tm.init_cache(1, 40)
    logits, cache = tm.forward(toks[None], cache=cache, mode="prefill",
                               logits_slice=1)
    rt = PagedKVRuntime(tcfg, n_pages=16, page_size=8, device="cpu")
    close(rt.prefill(tm, "p", toks), logits[0, -1])
    tok, cl = logits[0, -1].argmax(), 24
    for _ in range(3):
        ref, cache = tm.forward(tok.reshape(1, 1), cache=cache,
                                cache_len=torch.full((1,), cl),
                                mode="decode")
        out = rt.decode(tm, "p")
        close(ref[0, -1], out)
        assert int(out.argmax()) == int(ref[0, -1].argmax())
        tok, cl = ref[0, -1].argmax(), cl + 1


def test_pinned_evict_and_oom():
    cfg = get_config("glm4-9b", smoke=True)
    rt = PagedKVRuntime(cfg, n_pages=8, page_size=8, device="cpu")
    rt.programs["p"] = ProgramEntry([rt._alloc_page()], 8)
    rt.pin("p")
    assert rt.evict("p") is False and len(rt.free) == 7
    rt.unpin("p")
    assert rt.evict("p") is True and len(rt.free) == 8
    small = PagedKVRuntime(cfg, n_pages=2, page_size=8, device="cpu")
    with pytest.raises(MemoryError):
        small.prefill(Model(cfg, device="cpu"), "p", torch.arange(40))


# ---------------------------------------------------- tests/test_decode_batch
@pytest.fixture(scope="module")
def model():
    return Model(get_config("glm4-9b", smoke=True), device="cpu")


def make_runtime(model, lengths, n_pages=64, seed_base=100):
    """Fresh runtime with one prefilled program per entry of ``lengths``."""
    rt = PagedKVRuntime(model.cfg, n_pages=n_pages, page_size=8,
                        device="cpu")
    pids = []
    for i, n in enumerate(lengths):
        toks = np.random.default_rng(seed_base + i).integers(
            0, model.cfg.vocab_size, n)
        rt.prefill(model, f"p{i}", torch.from_numpy(toks))
        pids.append(f"p{i}")
    return rt, pids


class TestDecodeBatchBitExact:
    def test_batched_equals_sequential(self, model):
        lengths = [5, 24, 13, 8]
        rt_a, pids = make_runtime(model, lengths)
        rt_b, _ = make_runtime(model, lengths)
        batched = rt_a.decode_batch(model, pids)
        seq = [rt_b.decode(model, pid) for pid in pids]
        for b, s in zip(batched, seq):
            assert torch.equal(b, s)
        assert torch.equal(rt_a.k_pages, rt_b.k_pages)
        assert torch.equal(rt_a.v_pages, rt_b.v_pages)

    def test_shuffled_batch_order(self, model):
        rt_a, pids = make_runtime(model, [5, 24, 13, 8])
        rt_b, _ = make_runtime(model, [5, 24, 13, 8])
        perm = [2, 0, 3, 1]
        out_a = rt_a.decode_batch(model, pids)
        out_b = rt_b.decode_batch(model, [pids[i] for i in perm])
        for j, i in enumerate(perm):
            assert torch.equal(out_a[i], out_b[j])

    def test_padding_width_invariance(self, model):
        rt_a, _ = make_runtime(model, [5, 60])        # table width 8
        rt_b, _ = make_runtime(model, [5, 60])
        wide = rt_a.decode_batch(model, ["p0", "p1"])[0]
        narrow = rt_b.decode_batch(model, ["p0"])[0]
        assert torch.equal(wide, narrow)

    def test_multi_step_continuation(self, model):
        rt_a, pids = make_runtime(model, [5, 13])
        rt_b, _ = make_runtime(model, [5, 13])
        for _ in range(3):
            batched = rt_a.decode_batch(model, pids)
            seq = [rt_b.decode(model, pid) for pid in pids]
            for b, s in zip(batched, seq):
                assert torch.equal(b, s)

    def test_cow_split_mid_batch(self, model):
        def build():
            rt = PagedKVRuntime(model.cfg, n_pages=64, page_size=8,
                                device="cpu")
            toks = np.random.default_rng(7).integers(0, model.cfg.vocab_size,
                                                     12)
            rt.prefill(model, "a", torch.from_numpy(toks))
            ea = rt.programs["a"]
            for pi in ea.pages:              # b adopts a's pages, last one
                rt.refs[pi] += 1             # partially filled -> shared
            rt.programs["b"] = ProgramEntry(list(ea.pages), ea.length)
            rt.seed_token("b", 11)
            return rt

        rt_a, rt_b = build(), build()
        out = rt_a.decode_batch(model, ["a", "b"])
        assert rt_a.cow_splits == 1
        rt_a.check()
        seq = [rt_b.decode(model, "a"), rt_b.decode(model, "b")]
        for b, s in zip(out, seq):
            assert torch.equal(b, s)

    def test_zero_length_program_in_batch(self, model):
        def build():
            rt, pids = make_runtime(model, [24])
            rt.programs["z"] = ProgramEntry([rt._alloc_page()], 0)
            rt.seed_token("z", 5)
            return rt, pids

        rt_a, pids = build()
        rt_b, _ = build()
        out = rt_a.decode_batch(model, pids + ["z"])
        assert torch.isfinite(out[-1].float()).all()
        seq = [rt_b.decode(model, pid) for pid in pids + ["z"]]
        for b, s in zip(out, seq):
            assert torch.equal(b, s)
        assert rt_a.programs["z"].length == 1

    def test_empty_and_duplicate_batches(self, model):
        rt, pids = make_runtime(model, [5])
        assert rt.decode_batch(model, []) == []
        with pytest.raises(AssertionError):
            rt.decode_batch(model, [pids[0], pids[0]])


def test_refcount_conservation_fuzz(model):
    """Random decode batches: refcounts equal the holders after every
    batch, and every append lands in an exclusively owned page."""
    rng = np.random.default_rng(0)
    rt, pids = make_runtime(model, [5, 9, 17, 24])
    for _ in range(4):
        k = int(rng.integers(1, len(pids) + 1))
        rt.decode_batch(model, list(rng.choice(pids, size=k, replace=False)))
        rt.check()
        for pid in pids:
            e = rt.programs[pid]
            assert rt.refs[e.pages[(e.length - 1) // rt.page_size]] == 1
