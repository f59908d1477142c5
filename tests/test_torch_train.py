"""The port's training path against the JAX package's: AdamW and its
schedules, int8 error-feedback compression, the MoE load-balance loss,
the train step (fp32 masters, the compute-dtype forward, grad
accumulation) and the Trainer with checkpoint/restart, on the same
numpy-seeded inputs and the same JAX-initialized params, on the CPU at
smoke size. Each tolerance is stated with the gap measured at writing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ShapeSpec as JaxShape
from repro.configs.base import get_config as jax_config
from repro.launch.mesh import make_host_mesh
from repro.models import moe as jax_moe
from repro.models.common import init_params as jax_init_params
from repro.models.steps import build_train_step as jax_train_step
from repro.models.transformer import Model as JaxModel
from repro.train import optimizer as jax_opt
from repro.train.compression import CompressionConfig as JaxCompression
from repro.train.compression import compress_grads as jax_compress
from repro.train.compression import init_error_state as jax_error_state
from repro.train.train_loop import TrainConfig as JaxTrainConfig
from repro.train.train_loop import Trainer as JaxTrainer
from repro_torch.configs.base import ShapeSpec, get_config
from repro_torch.models import moe
from repro_torch.models.common import params_from_numpy
from repro_torch.models.steps import build_train_step
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.compression import (CompressionConfig,
                                           compress_grads, init_error_state)
from repro_torch.train.train_loop import TrainConfig, Trainer

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

SHAPE = ("t", "train", 64, 4)       # the reference's tests/test_train.py


def rel(a, b) -> float:
    return abs(a - b) / abs(b)


def numpy_params(tree) -> dict:
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def make_trainer(tmp_path, arch="qwen2-1.5b", steps=30, ckpt_every=10,
                 compute_dtype=None, cuda_graphs=True, mesh=None):
    """The reference's ``make_trainer`` on the port (CPU; on ``mesh``, a
    ``DeviceMesh``, if given); ``cuda_graphs`` False: the eager step, not
    the step on the graph's buffers."""
    cfg = get_config(arch, smoke=True)
    if compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    tcfg = TrainConfig(steps=steps, ckpt_every=ckpt_every,
                       ckpt_dir=str(tmp_path / "ckpt"), log_every=1000,
                       adamw=opt_mod.AdamWConfig(lr=1e-3, warmup_steps=5,
                                                 total_steps=steps))
    return Trainer(cfg, mesh, ShapeSpec(*SHAPE), tcfg,
                   log_fn=lambda s: None, device="cpu",
                   cuda_graphs=cuda_graphs)


def jax_trainer(tmp_path, arch, steps, compute_dtype):
    cfg = dataclasses.replace(jax_config(arch, smoke=True),
                              compute_dtype=compute_dtype)
    tcfg = JaxTrainConfig(steps=steps, ckpt_every=1000,
                          ckpt_dir=str(tmp_path / "jax_ckpt"),
                          log_every=1000,
                          adamw=jax_opt.AdamWConfig(lr=1e-3, warmup_steps=5,
                                                    total_steps=steps))
    tr = JaxTrainer(cfg, make_host_mesh(), JaxShape(*SHAPE), tcfg,
                    log_fn=lambda s: None)
    tr.init_state()
    return tr


def twin_histories(tmp_path, arch, steps, compute_dtype="float32",
                   cuda_graphs=True, mesh=None):
    """``steps`` steps of JAX's Trainer and of the port's (on ``mesh``, if
    given) from JAX's initial params, on the same TokenStream batches."""
    jt = jax_trainer(tmp_path, arch, steps, compute_dtype)
    tr = make_trainer(tmp_path, arch, steps, ckpt_every=1000,
                      compute_dtype=compute_dtype, cuda_graphs=cuda_graphs,
                      mesh=mesh)
    tr.init_state(numpy_params(jt.params))
    return jt.run(), tr.run()


# ------------------------------------------------------------- optimizer
class TestOptimizer:
    """The reference's three cases, on the port."""

    def test_adamw_converges_quadratic(self):
        cfg = opt_mod.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                                  grad_clip=0.0, schedule="constant")
        params = {"w": torch.tensor([5.0, -3.0])}
        state = opt_mod.init_state(params, cfg)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}             # d/dw ||w||^2
            params, state, _ = opt_mod.apply_updates(params, grads, state,
                                                     cfg)
        assert float(params["w"].abs().max()) < 0.1

    def test_grad_clip(self):
        cfg = opt_mod.AdamWConfig(grad_clip=1.0)
        g = {"w": torch.full((4,), 100.0)}
        state = opt_mod.init_state(g, cfg)
        _, _, m = opt_mod.apply_updates({"w": torch.zeros(4)}, g, state, cfg)
        assert float(m["grad_norm"]) == pytest.approx(200.0)

    def test_schedule_shapes(self):
        cfg = opt_mod.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
        lrs = [float(opt_mod.schedule_lr(cfg, s)) for s in [0, 5, 10, 55, 100]]
        assert lrs[0] == 0.0 and lrs[1] == pytest.approx(0.5)
        assert lrs[2] == pytest.approx(1.0)
        assert lrs[3] < lrs[2] and lrs[4] == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(state_dtype):
    """20 AdamW steps (warmup, cosine decay, clipping on some steps,
    weight decay on the 2-D and 3-D leaves) on a random tree: params
    within 1e-6 of the leaf's scale (measured: 5.2e-8 with fp32 moments,
    1.3e-8 with bf16), moments within 1e-6 too (3.2e-7 / 0), grad norms
    and learning rates equal up to fp32 rounding."""
    rng = np.random.default_rng(0)
    shapes = {"w": (8, 16), "b": (16,), "s": (3, 4, 5)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    kw = dict(lr=1e-2, warmup_steps=5, total_steps=20,
              state_dtype=state_dtype)
    jcfg, tcfg = jax_opt.AdamWConfig(**kw), opt_mod.AdamWConfig(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = jax_opt.init_state(jp, jcfg)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = opt_mod.init_state(tp, tcfg)
    for i in range(20):
        g = {k: (rng.normal(size=s) * (3.0 if i % 3 else 0.1))
             .astype(np.float32) for k, s in shapes.items()}
        jp, js, jm = jax_opt.apply_updates(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jcfg)
        tp, ts, tm = opt_mod.apply_updates(
            tp, {k: torch.tensor(v) for k, v in g.items()}, ts, tcfg)
        for k in shapes:
            for want, got in ((jp[k], tp[k]), (js["m"][k], ts["m"][k]),
                              (js["v"][k], ts["v"][k])):
                want = np.asarray(want.astype(jnp.float32))
                got = got.float().numpy()
                assert np.abs(got - want).max() <= \
                    1e-6 * np.abs(want).max(), (i, k)
        assert int(ts["count"]) == int(js["count"]) == i + 1
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == float(jm["lr"])


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_jax(schedule):
    """Warmup, linear and constant schedules are bit-equal to the
    reference's at every step. The cosine is bit-equal where XLA's fp32
    cos is correctly rounded (the port rounds an fp64 cos once): over
    ~1e6 steps of 27 configs 0.19% of the cosine steps differed
    (measured at writing), by at most one fp32 rounding of the cosine,
    which the bound ``lr * 2**-22`` covers."""
    for warm, total in ((0, 20), (5, 20), (5, 40), (10, 100), (100, 10000)):
        for lr in (1.0, 3e-4):
            kw = dict(lr=lr, warmup_steps=warm, total_steps=total,
                      schedule=schedule)
            steps = np.arange(total + 5)
            want = np.asarray(jax_opt.schedule_lr(
                jax_opt.AdamWConfig(**kw), jnp.asarray(steps)))
            got = opt_mod.schedule_lr(opt_mod.AdamWConfig(**kw),
                                      torch.tensor(steps)).numpy()
            assert got.dtype == want.dtype == np.float32
            if schedule == "cosine":
                assert np.array_equal(got[:warm + 1], want[:warm + 1])
                assert np.abs(got - want).max() <= lr * 2.0 ** -22
            else:
                assert np.array_equal(got, want)


# ----------------------------------------------------------- compression
class TestCompression:
    """The reference's two cases, on the port."""

    def test_error_feedback_unbiased(self):
        """Sum of compressed grads converges to sum of true grads."""
        rng = np.random.default_rng(0)
        g_true = torch.tensor(rng.normal(size=(512,)).astype(np.float32))
        err = init_error_state({"g": g_true})
        acc = torch.zeros_like(g_true)
        for _ in range(50):
            cg, err = compress_grads({"g": g_true}, err,
                                     CompressionConfig(block=64))
            acc = acc + cg["g"]
        np.testing.assert_allclose(acc.numpy() / 50, g_true.numpy(),
                                   atol=0.02)

    def test_quantization_error_small(self):
        rng = np.random.default_rng(1)
        g = {"g": torch.tensor(rng.normal(size=(1000,)).astype(np.float32))}
        cg, err = compress_grads(g, init_error_state(g))
        rel_err = float(torch.linalg.norm(cg["g"] - g["g"]) /
                        torch.linalg.norm(g["g"]))
        assert rel_err < 0.02                           # int8 ~ 0.5% typical


def test_compress_grads_bitwise_equal_to_jax():
    """Five steps with the error carried: compressed grads and error state
    equal the reference's bit for bit (round half to even on both sides),
    with a ragged last block and large values."""
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(1000,)).astype(np.float32),
         "b": (rng.normal(size=(7, 9)) * 100).astype(np.float32)}
    je = jax_error_state({k: jnp.asarray(v) for k, v in g.items()})
    te = init_error_state({k: torch.tensor(v) for k, v in g.items()})
    for _ in range(5):
        jg, je = jax_compress({k: jnp.asarray(v) for k, v in g.items()}, je,
                              JaxCompression(block=64))
        tg, te = compress_grads({k: torch.tensor(v) for k, v in g.items()},
                                te, CompressionConfig(block=64))
        for k in g:
            assert np.array_equal(np.asarray(jg[k]), tg[k].numpy())
            assert np.array_equal(np.asarray(je[k]), te[k].numpy())


def test_aux_load_balance_loss_matches_jax():
    """qwen3-moe smoke's router on random activations: within 1e-6
    relative (measured at writing: 0 to 1.2e-7)."""
    cfg = get_config("qwen3-moe-235b-a22b", smoke=True)
    jcfg = jax_config("qwen3-moe-235b-a22b", smoke=True)
    specs = jax_moe.moe_specs(jcfg, "float32")
    p = numpy_params(jax_init_params(specs, jax.random.PRNGKey(4)))
    p = {k: v for k, v in p.items() if k == "router"}
    x = np.random.default_rng(5).normal(size=(2, 24, cfg.d_model)) \
        .astype(np.float32)
    want = float(jax_moe.aux_load_balance_loss(
        {"router": jnp.asarray(p["router"].numpy())}, jnp.asarray(x), jcfg))
    got = float(moe.aux_load_balance_loss(p, torch.tensor(x), cfg))
    assert got == pytest.approx(want, rel=1e-6)
    assert got >= 1.0 - 1e-6                      # E * sum(frac * mean p)


# ------------------------------------------------------- train step / loop
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-235b-a22b"])
def test_trainer_matches_jax(tmp_path, arch):
    """JAX's Trainer and the port's from the same params on the same
    batches, fp32 compute: step 1's loss and grad norm within 1e-5
    relative, ten steps' losses within 1e-3 (measured at writing: qwen2
    1.9e-7 / 1.8e-6 at step 1, losses within 3.8e-7; qwen3-moe, whose
    dispatch runs under autograd, 7.8e-8 / 3.3e-7, within 2.4e-7)."""
    hj, ht = twin_histories(tmp_path, arch, 10)
    assert rel(ht[0]["loss"], hj[0]["loss"]) <= 1e-5
    assert rel(ht[0]["grad_norm"], hj[0]["grad_norm"]) <= 1e-5
    for a, b in zip(hj, ht):
        assert rel(b["loss"], a["loss"]) <= 1e-3, (a, b)
        assert b["lr"] == pytest.approx(a["lr"], rel=1e-6)


def test_trainer_bf16_compute_step1(tmp_path):
    """bf16 compute over fp32 masters: step 1's loss within 1e-2 relative
    of JAX's (measured at writing: 1.3e-4; grad norm 5.4e-3)."""
    hj, ht = twin_histories(tmp_path, "qwen2-1.5b", 1, "bfloat16")
    assert rel(ht[0]["loss"], hj[0]["loss"]) <= 1e-2


#: every other family of PORTED_FAMILIES at smoke size
FAMILIES = ["gemma2-9b", "zamba2-2.7b", "rwkv6-3b", "musicgen-large",
            "pixtral-12b", "glm4-9b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step1_matches_jax_across_families(tmp_path, arch):
    """The port's Trainer's first step against the reference's loss and
    gradient (``jax.value_and_grad(Model.loss)``, jitted, and
    ``global_norm``) on the first TokenStream batch, fp32, from the same
    params: loss and grad norm within 1e-4 relative (measured at
    writing: at most 2.4e-7 / 6.1e-6)."""
    cfg = dataclasses.replace(jax_config(arch, smoke=True),
                              compute_dtype="float32")
    jm = JaxModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    tr = make_trainer(tmp_path, arch, steps=1, ckpt_every=1000,
                      compute_dtype="float32")
    tokens, labels = tr.data.batch_at(0)
    loss, grads = jax.jit(jax.value_and_grad(jm.loss))(
        params, jnp.asarray(tokens), jnp.asarray(labels))
    tr.init_state(numpy_params(params))
    (rec,) = tr.run()
    assert rel(rec["loss"], float(loss)) <= 1e-4
    assert rel(rec["grad_norm"], float(jax_opt.global_norm(grads))) <= 1e-4


def test_train_step_accumulates_microbatches_like_jax():
    """``train_microbatches`` = 2: the port's step accumulates the two
    halves' fp32 grads as the reference's scan does. Two steps, each's
    loss and grad norm within 1e-5 relative of the reference's (the
    second read after the first's AdamW update of every leaf); the
    reference's JAX mesh is refused (the port takes a torch
    ``DeviceMesh``)."""
    jcfg = dataclasses.replace(jax_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True),
                              compute_dtype="float32")
    adamw = dict(lr=1e-3, warmup_steps=0)
    mesh = make_host_mesh()
    with mesh:
        jstep = jax_train_step(jcfg, mesh, JaxShape(*SHAPE),
                               adamw=jax_opt.AdamWConfig(**adamw),
                               microbatches=2)
    params = JaxModel(jcfg).init(jax.random.PRNGKey(1))
    tp = numpy_params(params)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    from repro_torch.models import Model
    model = Model(cfg, tp, device="cpu", trainable=True)
    step = build_train_step(cfg, None, ShapeSpec(*SHAPE),
                            adamw=opt_mod.AdamWConfig(**adamw),
                            microbatches=2, model=model)
    jstate = jax_opt.init_state(params, jax_opt.AdamWConfig(**adamw))
    state = opt_mod.init_state(model.params, opt_mod.AdamWConfig(**adamw))
    for _ in range(2):
        with mesh:
            params, jstate, jmet = jstep.fn(params, jstate, tokens, labels)
        met = step.fn(state, tokens, labels)
        assert rel(float(met["loss"]), float(jmet["loss"])) <= 1e-5
        assert rel(float(met["grad_norm"]),
                   float(jmet["grad_norm"])) <= 1e-5
    with pytest.raises(TypeError, match="DeviceMesh"):
        build_train_step(cfg, mesh, ShapeSpec(*SHAPE), model=model)


class TestTraining:
    """The reference's ``TestTraining`` cases, on the port (its elastic
    remesh case needs a process group: ``tests/test_torch_dist.py``)."""

    def test_loss_decreases(self, tmp_path):
        tr = make_trainer(tmp_path, steps=40)
        hist = tr.run()
        first = np.mean([h["loss"] for h in hist[:5]])
        last = np.mean([h["loss"] for h in hist[-5:]])
        assert last < first - 0.1, (first, last)

    def test_checkpoint_restart_resumes_identically(self, tmp_path):
        """Fault tolerance: kill after step 20, resume, match
        uninterrupted."""
        tr1 = make_trainer(tmp_path / "a", steps=30, ckpt_every=10)
        h1 = tr1.run()

        tr2 = make_trainer(tmp_path / "b", steps=30, ckpt_every=10)
        tr2.run(steps=20)          # "crash" after 20
        tr2.ckpt.wait()
        tr3 = make_trainer(tmp_path / "b", steps=30, ckpt_every=10)
        assert tr3.resume() and tr3.step == 20
        h3 = tr3.run()
        # data is stateless-by-step, params restored exactly -> same losses
        np.testing.assert_allclose(h1[-1]["loss"], h3[-1]["loss"], rtol=1e-4)


def test_checkpoint_round_trips_bf16_moments_and_retains(tmp_path):
    """A bf16-moment state survives save and restore bit for bit (stored
    as fp32), the manifest lists every name, only the newest ``keep``
    checkpoints stay and a leftover ``.tmp`` is never the latest."""
    from repro_torch.train.checkpoint import CheckpointManager
    gen = torch.Generator().manual_seed(0)
    params = {"a.w": torch.randn(3, 4, generator=gen),
              "b": torch.randn(5, generator=gen)}
    cfg = opt_mod.AdamWConfig(state_dtype="bfloat16")
    state = opt_mod.init_state(params, cfg)
    for k, p in params.items():
        state["m"][k].copy_(p * 3)
        state["v"][k].copy_(p.square())
    mgr = CheckpointManager(tmp_path, keep=2)
    for step in (1, 2, 3):
        state["count"].fill_(step)
        mgr.save_async(step, params, state, {"arch": "t"})
    mgr.wait()
    (tmp_path / "step_0000000009.tmp").mkdir()
    assert mgr.latest_step() == 3
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_0000000002", "step_0000000003", "step_0000000009.tmp"]
    like_p = {k: torch.zeros_like(v) for k, v in params.items()}
    like_s = opt_mod.init_state(like_p, cfg)
    got_p, got_s, manifest = mgr.restore(3, like_p, like_s)
    assert manifest["arch"] == "t" and manifest["step"] == 3
    assert manifest["opt"] == sorted(["count", "m.a.w", "m.b", "v.a.w",
                                      "v.b"])
    for k in params:
        assert torch.equal(got_p[k], params[k])
        assert got_s["m"][k].dtype == torch.bfloat16
        assert torch.equal(got_s["m"][k], state["m"][k])
        assert torch.equal(got_s["v"][k], state["v"][k])
    assert int(got_s["count"]) == 3 and got_s["count"].dtype == torch.int32


def test_trainer_defaults_to_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-1.5b", smoke=True)
    tcfg = TrainConfig(ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, None, ShapeSpec(*SHAPE), tcfg)
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(cfg, object(), ShapeSpec(*SHAPE), tcfg, device="cpu")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma2-9b"])
def test_remat_changes_no_value(arch):
    """Recomputing in backward changes no number: ``remat="none"`` (each
    attention block recomputed instead, gemma2's windowed blocks past its
    32-token window) and the configs' ``"full"`` (each layer) give the
    same loss and grads bit for bit, with three loss chunks of 16 tokens
    recomputed in both."""
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype="float32")
    from repro_torch.models import Model
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 48)))
    params = dict(Model(cfg, device="cpu", trainable=True).params)
    out = []
    for remat in ("full", "none"):
        model = Model(dataclasses.replace(cfg, remat=remat),
                      {k: v.detach() for k, v in params.items()},
                      device="cpu", trainable=True)
        loss = model.loss(tokens, tokens.roll(-1, 1), loss_chunk=16)
        out.append((loss, torch.autograd.grad(
            loss, list(model.params.values()))))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    assert all(torch.equal(a, b) for a, b in zip(ga, gb))
