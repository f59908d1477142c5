"""The trainer's step on the graph's persistent buffers (``TrainGraph``),
on the CPU at smoke size.

On the card the step is a CUDA graph captured at the trainer's second
step and replayed after; on the CPU the same buffers are filled and bound
and the step runs eagerly on them, so these tests go through the buffer
reuse, the binding to the state's tensors and the clones that the graph
relies on. The capture itself is held bit for bit against two eager legs
by ``chip_smoke.py`` (phase 8b) and timed against the eager step in 8a;
on a one-rank NCCL mesh against the eager sharded step in 9e.

On a (1, 1) gloo mesh (the masters and moments DTensors) the trainer
takes the same graph path: its step on the buffers equals the eager
sharded step bit for bit, reads nothing on the host, and is bound to
the DTensors' local pieces.
"""
import dataclasses

import numpy as np
import pytest
import torch
from host_reads import no_host_reads
from test_torch_train import SHAPE, rel, twin_histories
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.dist.sharding import local
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.train_graph import TrainGraph
from repro_torch.train.train_loop import TrainConfig, Trainer

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)


def trainer(path, cuda_graphs=True, microbatches=1, steps=12, ckpt_every=4,
            mesh=None, logs=None):
    """qwen2-1.5b smoke in fp32 on the reference's test shape (B 4 x 64)
    from the port's seeded init."""
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              compute_dtype="float32",
                              train_microbatches=microbatches)
    tcfg = TrainConfig(steps=steps, ckpt_every=ckpt_every,
                       ckpt_dir=str(path), log_every=1000,
                       adamw=opt_mod.AdamWConfig(lr=1e-3, warmup_steps=5,
                                                 total_steps=steps))
    return Trainer(cfg, mesh, ShapeSpec(*SHAPE), tcfg,
                   log_fn=(logs.append if logs is not None else
                           lambda s: None),
                   device="cpu", cuda_graphs=cuda_graphs)


def state(tr) -> dict:
    """Masters, moments and count, flat."""
    st = tr.opt_state
    return {**{f"p.{k}": t for k, t in tr.params.items()},
            **{f"{m}.{k}": t for m in ("m", "v") for k, t in st[m].items()},
            "count": st["count"]}


def assert_same(a: Trainer, b: Trainer, hist_a, hist_b) -> None:
    """Histories and states equal bit for bit."""
    keys = ("step", "loss", "grad_norm", "lr")
    assert [[h[k] for k in keys] for h in hist_a] == \
        [[h[k] for k in keys] for h in hist_b]
    sa, sb = state(a), state(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


# ---------------------------------------------------------------- (a)
@pytest.mark.parametrize("microbatches", [1, 2])
def test_graph_path_equals_eager_bitwise(tmp_path, microbatches):
    """Three steps on the graph's buffers equal the eager trainer's bit for
    bit: every loss, grad norm and lr, every master and moment, the
    count. The graph path runs the built step on its int64 buffers (the
    batch uploaded once), and the buffers are reused every step."""
    g = trainer(tmp_path / "g", microbatches=microbatches, steps=3)
    e = trainer(tmp_path / "e", cuda_graphs=False,
                microbatches=microbatches, steps=3)
    hg, he = g.run(), e.run()
    assert_same(g, e, hg, he)
    assert e.graph is None and g.graph.uses == 3
    assert g.graph.capture is False and g.graph.graph is None
    buf = g.graph.batch
    tokens, labels = g.data.batch_at(2)
    assert buf.dtype == torch.long and buf.shape == (2,) + tokens.shape
    assert np.array_equal(buf[0].numpy(), tokens)
    assert np.array_equal(buf[1].numpy(), labels)


def test_step_returns_clones_of_fresh_outputs(tmp_path):
    """The step's metrics are fp32 scalars no later step overwrites."""
    tr = trainer(tmp_path, steps=2)
    tr.init_state()
    first = tr.graph.step(tr.opt_state, *tr.data.batch_at(0))
    kept = {k: v.clone() for k, v in first.items()}
    second = tr.graph.step(tr.opt_state, *tr.data.batch_at(1))
    assert set(first) == {"loss", "grad_norm", "lr"}
    for k in first:
        assert first[k].dtype == torch.float32 and first[k].ndim == 0
        assert torch.equal(first[k], kept[k])
        assert first[k].data_ptr() != second[k].data_ptr()
    assert float(first["lr"]) < float(second["lr"])      # warming up


# ---------------------------------------------------------------- (b)
def test_graph_trainer_matches_jax(tmp_path, monkeypatch):
    """The graph path's trainer against the reference's ``Trainer`` from
    the same params on the same batches, fp32 compute, with the bounds of
    ``test_trainer_matches_jax``: step 1's loss and grad norm within 1e-5
    relative, ten steps' losses within 1e-3; every step went through
    ``TrainGraph.step``."""
    calls = []
    step = TrainGraph.step

    def counted(self, *args):
        calls.append(self)
        return step(self, *args)

    monkeypatch.setattr(TrainGraph, "step", counted)
    hj, ht = twin_histories(tmp_path, "qwen2-1.5b", 10, cuda_graphs=True)
    assert len(calls) == 10
    assert rel(ht[0]["loss"], hj[0]["loss"]) <= 1e-5
    assert rel(ht[0]["grad_norm"], hj[0]["grad_norm"]) <= 1e-5
    for a, b in zip(hj, ht):
        assert rel(b["loss"], a["loss"]) <= 1e-3, (a, b)
        assert b["lr"] == pytest.approx(a["lr"], rel=1e-6)


# ---------------------------------------------------------------- (c)
def test_resume_into_itself_continues_exactly(tmp_path):
    """A graph-path trainer runs past its last checkpoint (8 -> 10),
    resumes into itself (back to step 8) and goes on to 12: steps 9-12
    and the final state equal an uninterrupted run's bit for bit. The
    restore copies into the tensors the step is bound to; a restore that
    rebinds them is refused at the next step."""
    u = trainer(tmp_path / "u")
    hu = u.run()
    tr = trainer(tmp_path / "r")
    tr.run(steps=10)
    bound = [t.data_ptr() for t in state(tr).values()]
    assert tr.resume() and tr.step == 8
    assert [t.data_ptr() for t in state(tr).values()] == bound
    h = tr.run()
    assert_same(tr, u, h[-4:], hu[-4:])


def test_step_refuses_unbound_state_and_wrong_shapes(tmp_path):
    """The step is bound to the masters and the state of its first call:
    a fresh optimizer state (new tensors) is refused, as is a batch of
    another shape than the buffers'."""
    tr = trainer(tmp_path, steps=2)
    tr.run(steps=1)
    tokens, labels = tr.data.batch_at(1)
    fresh = opt_mod.init_state(tr.params, tr.tcfg.adamw)
    with pytest.raises(ValueError, match="bound"):
        tr.graph.step(fresh, tokens, labels)
    with pytest.raises(ValueError, match="buffers take"):
        tr.graph.step(tr.opt_state, tokens[:, :32], labels[:, :32])
    assert tr.graph.uses == 1


# ---------------------------------------------------------------- (d)
def test_eager_option_runs_the_built_step(tmp_path):
    """``cuda_graphs=False`` gives today's step: no graph, every step
    through the built step's own function on the host batch."""
    tr = trainer(tmp_path, cuda_graphs=False, steps=2)
    tr.init_state()
    seen = []
    fn = tr.built.fn

    def spy(opt_state, tokens, labels):
        seen.append(type(tokens))
        return fn(opt_state, tokens, labels)

    tr.built.fn = spy
    hist = tr.run()
    assert tr.graph is None and len(hist) == 2
    assert seen == [np.ndarray, np.ndarray]


# ---------------------------------------------------------------- (e)
@pytest.fixture
def mesh():
    """A (1, 1) mesh over a one-rank gloo group in this process."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def count_steps(monkeypatch) -> list:
    """The graphs whose ``TrainGraph.step`` ran, one entry a step."""
    calls = []
    step = TrainGraph.step

    def counted(self, *args):
        calls.append(self)
        return step(self, *args)

    monkeypatch.setattr(TrainGraph, "step", counted)
    return calls


def test_mesh_trainer_runs_the_graph_path(tmp_path, mesh, monkeypatch):
    """On a (1, 1) gloo mesh ``cuda_graphs=True`` builds a ``TrainGraph``
    over the sharded model, and every step goes through
    ``TrainGraph.step``; ``reshard_for_mesh(mesh)`` and
    ``reshard_for_mesh(None)`` each build a fresh graph, whose first step
    is its warm-up; nothing says the step runs eagerly."""
    calls = count_steps(monkeypatch)
    logs = []
    tr = trainer(tmp_path, steps=4, mesh=mesh, logs=logs)
    tr.run(steps=1)
    first = tr.graph
    assert first is not None and first.model.mesh is mesh
    assert isinstance(tr.params["embed"], DTensor)
    tr.reshard_for_mesh(mesh)
    second = tr.graph
    assert second is not None and second is not first
    assert second.uses == 0 and second.model.mesh is mesh
    tr.run(steps=3)
    tr.reshard_for_mesh(None)
    third = tr.graph
    assert third not in (None, second) and third.model.mesh is None
    tr.run(steps=4)
    assert calls == [first, second, second, third]
    assert (first.uses, second.uses, third.uses) == (1, 2, 1)
    assert not any("eagerly" in s for s in logs), logs
    assert any("resharded" in s for s in logs), logs


@pytest.mark.parametrize("microbatches", [1, 2])
def test_mesh_graph_path_equals_eager_bitwise(tmp_path, mesh,
                                              microbatches):
    """On the (1, 1) mesh the graph path's trainer equals the eager
    sharded trainer (``cuda_graphs=False``) bit for bit: every loss,
    grad norm and lr, every master and moment, the count; its step reads
    no device value on the host (a capture would refuse it). It runs
    past its checkpoint (4 -> 6), resumes into itself, copying into the
    DTensors' local pieces the graph is bound to, and goes on to equal
    the eager trainer again. A step on another state (fresh DTensors,
    whose wrappers' ``data_ptr()`` is 0 like the bound ones') is refused:
    the binding keys on the local pieces."""
    g = trainer(tmp_path / "g", microbatches=microbatches, steps=6,
                mesh=mesh)
    e = trainer(tmp_path / "e", cuda_graphs=False,
                microbatches=microbatches, steps=6, mesh=mesh)
    g.init_state()
    step = g.graph.step

    def guarded(*args):
        with no_host_reads():
            return step(*args)

    g.graph.step = guarded
    hg, he = g.run(), e.run()
    assert_same(g, e, hg, he)
    assert g.graph.uses == 6 and e.graph is None
    bound = [local(t).data_ptr() for t in state(g).values()]
    assert g.resume() and g.step == 4
    assert [local(t).data_ptr() for t in state(g).values()] == bound
    h = g.run()
    assert g.step == 6 and g.graph.uses == 8
    assert_same(g, e, h[-2:], he[-2:])
    fresh = opt_mod.init_state(g.params, g.tcfg.adamw)
    assert fresh["m"]["embed"].data_ptr() == \
        g.opt_state["m"]["embed"].data_ptr()
    with pytest.raises(ValueError, match="bound"):
        g.graph.step(fresh, *g.data.batch_at(6))
    assert g.graph.uses == 8


def test_mesh_graph_trainer_matches_jax(tmp_path, mesh, monkeypatch):
    """The graph path's trainer on the (1, 1) mesh against the
    reference's ``Trainer`` (on ``make_host_mesh()``, as the reference
    always trains) from the same params on the same batches, fp32
    compute, with ``twin_histories``' bounds: step 1's loss and grad norm
    within 1e-5 relative, ten losses within 1e-3; every step went
    through ``TrainGraph.step`` over the sharded model."""
    calls = count_steps(monkeypatch)
    hj, ht = twin_histories(tmp_path, "qwen2-1.5b", 10, cuda_graphs=True,
                            mesh=mesh)
    assert len(calls) == 10 and calls[0].model.mesh is mesh
    assert rel(ht[0]["loss"], hj[0]["loss"]) <= 1e-5
    assert rel(ht[0]["grad_norm"], hj[0]["grad_norm"]) <= 1e-5
    for a, b in zip(hj, ht):
        assert rel(b["loss"], a["loss"]) <= 1e-3, (a, b)
        assert b["lr"] == pytest.approx(a["lr"], rel=1e-6)
