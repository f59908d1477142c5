"""The port's sharded steps across processes: four gloo ranks on the CPU,
meshes (2, 2) and (1, 4), smoke configs in fp32, against the JAX
package's unsharded ``Model.forward`` on the same params and against the
port's own meshless steps.

Each mesh is one spawned run (four processes, no JAX in them): the
parent computes the reference's numbers with JAX and hands them over by
``np.savez``; each rank writes its measured gaps as JSON, and the parent
asserts. (1, 4) pads qwen2's 6 query heads to 8 (ROADMAP R8) and shards
its cache on the sequence; (2, 2) shards heads, KV heads and the batch,
and gives the MoE layer two dispatch groups, held against the
reference's grouped layer on four forced host devices."""
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.dist.sharding import axis_rules as jax_axis_rules
from repro.models.common import init_params as jax_init_params
from repro.models.moe import moe_specs as jax_moe_specs
from repro.models.transformer import Model as JaxModel
from repro_torch.models.common import flatten_tree

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, S, T, N_DEC = 4, 12, 16, 3        # batch, prompt, cache, decode steps
#: sharded vs unsharded logits, fp32, as a share of the logits' rms
#: (measured <= 1.7e-5 at writing, qwen2, rwkv6 and zamba2)
LOGIT_RTOL = 1e-4
#: sharded vs meshless loss and grad norm (measured <= 1.2e-6, the
#: remeshed and resumed runs included)
TRAIN_RTOL = 1e-5
#: the MoE layer (G = 2) against the reference's (measured 8.6e-8 abs)
MOE_ATOL = 1e-5
SPAWN_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn(script: str, world: int, data: pathlib.Path,
          timeout: float = SPAWN_TIMEOUT_S) -> list[dict]:
    """``script`` in ``world`` processes (rank, world, a free port and
    ``data`` as argv); each writes ``data/rank{r}.json``. Every process
    is waited for or killed; a rank that fails reports its error (with
    its Python stack on a fatal signal)."""
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(str(ROOT / d)
                                         for d in ("src", "tests")),
           "JAX_PLATFORMS": "cpu", "PYTHONFAULTHANDLER": "1"}
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(port),
         str(data)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        errs = [p.communicate(timeout=timeout)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r}: {err[-3000:]}" for r, (p, err) in
              enumerate(zip(procs, errs)) if p.returncode]
    assert not failed, "\n".join(failed)
    return [json.loads((data / f"rank{r}.json").read_text())
            for r in range(world)]


HEADER = textwrap.dedent("""
    import dataclasses, json, pathlib, sys, warnings
    warnings.filterwarnings("ignore")
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank, world, port = (int(a) for a in sys.argv[1:4])
    data = pathlib.Path(sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    def mesh_of(shape):
        return init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
    def rel(a, b):
        return abs(a - b) / abs(b)
""")

WORKER = HEADER + textwrap.dedent("""
    import contextlib
    from host_reads import no_host_reads
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.dist.sharding import (axis_rules, default_rules,
                                           distribute, distribute_params,
                                           placements_of)
    from repro_torch.models import Model
    from repro_torch.models.steps import (build_decode_step,
                                          build_prefill_step,
                                          build_train_step)
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import TrainConfig, Trainer
    shape = tuple(int(x) for x in sys.argv[5].split("x"))
    mesh = mesh_of(shape)
    ref = np.load(data / "ref.npz")
    out = {}

    def fp32(arch):
        return dataclasses.replace(get_config(arch, smoke=True),
                                   compute_dtype="float32")

    def serve(cfg, model, m, toks, dec, graphs=True):
        # graphs: the bucketed decode step (run eagerly on its buffers on
        # the CPU), with no value read on the host during its steps
        pf = build_prefill_step(cfg, m, ShapeSpec("p", "prefill", 16, 4),
                                model=model, device="cpu")
        dc = build_decode_step(cfg, m, ShapeSpec("d", "decode", 16, 4),
                               model=pf.model, device="cpu",
                               cuda_graphs=graphs)
        assert (dc.graph is not None) == graphs
        cache = pf.model.init_cache(4, 16, pf.rules)
        nxt, cache, lg = pf.fn(cache, toks, logits=True)
        logits, tokens = [lg], [nxt]
        for i in range(dec.shape[1]):
            cl = torch.full((4,), toks.shape[1] + i, dtype=torch.int32)
            with no_host_reads() if graphs else contextlib.nullcontext():
                nxt, cache, lg = dc.fn(cache, dec[:, i:i + 1], cl,
                                       logits=True)
            logits.append(lg)
            tokens.append(nxt)
        if graphs:
            (b,) = dc.graph.buckets().values()
            assert b.uses == dec.shape[1]
        full = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
                for k, v in cache.items()}
        return logits, full, tokens

    # --- qwen2 smoke: prefill + decode against the reference's forward
    cfg = fp32("qwen2-1.5b")
    params = {k[2:]: torch.from_numpy(v) for k, v in ref.items()
              if k.startswith("p.")}
    toks, dec = (torch.from_numpy(ref[k]).long() for k in ("toks", "dec"))
    qwen2 = Model(cfg, params, device="cpu")
    logits, cache, tokens = serve(cfg, qwen2, mesh, toks, dec)
    # the bucketed step against the eager one, bit for bit
    e_logits, e_cache, e_tokens = serve(cfg, qwen2, mesh, toks, dec,
                                        graphs=False)
    out["qwen2_graph_equals_eager"] = all(
        torch.equal(a, b) for a, b in zip(logits + tokens,
                                          e_logits + e_tokens)) and all(
        torch.equal(cache[k], e_cache[k]) for k in cache)
    rms = float(np.sqrt(np.mean(ref["logits"] ** 2)))
    want = [ref["logits"][:, S - 1:S]] + [ref[f"dec{i}"] for i in
                                          range(dec.shape[1])]
    out["qwen2_logit_gaps"] = [float(np.abs(l.numpy() - w).max()) / rms
                               for l, w in zip(logits, want)]
    # the next tokens (a vocab-parallel argmax) are the reference's argmax
    out["qwen2_tokens_equal"] = all(
        np.array_equal(t.numpy(), w[:, -1].argmax(-1))
        for t, w in zip(tokens, want))
    out["qwen2_cache_gap"] = max(
        float(np.abs(cache[k].numpy() - ref[f"cache_{k}"]).max()
              / np.abs(ref[f"cache_{k}"]).max()) for k in ("k", "v"))

    # --- a train step: sharded against meshless, loss and grad norm
    adamw = opt_mod.AdamWConfig(lr=1e-3, warmup_steps=0)
    tshape = ShapeSpec("t", "train", 32, 4)
    g = torch.Generator().manual_seed(2)
    tt = torch.randint(0, cfg.vocab_size, (4, 32), generator=g)
    tl = torch.roll(tt, -1, 1)
    steps = [build_train_step(cfg, m, tshape, adamw=adamw, device="cpu",
                              model=Model(cfg, params, device="cpu",
                                          trainable=True))
             for m in (None, mesh)]
    states = [s.make_inputs()[0] for s in steps]
    gaps = []
    for _ in range(2):
        a, b = (s.fn(st, tt, tl) for s, st in zip(steps, states))
        gaps += [rel(float(b[k]), float(a[k])) for k in ("loss",
                                                         "grad_norm")]
    out["train_gaps"] = gaps

    # --- the trainer's graph path (its step on the graph's buffers, the
    # CPU's stand-in for each rank's captured step) against the eager
    # sharded step, bit for bit: two steps here, two after a remesh
    from repro_torch.dist.sharding import local
    other = mesh_of((2, 2) if shape == (1, 4) else (1, 4))
    legs = []
    for graphs in (True, False):
        tr = Trainer(cfg, mesh, tshape, TrainConfig(
            steps=4, ckpt_every=10 ** 9, ckpt_dir=str(data / "graph"),
            log_every=10 ** 9, adamw=opt_mod.AdamWConfig(
                lr=1e-3, warmup_steps=1, total_steps=4)),
            log_fn=lambda s: None, device="cpu", cuda_graphs=graphs)
        tr.init_state(params)
        tr.run(steps=2)
        tr.reshard_for_mesh(other)
        hist = tr.run(steps=4)
        assert (tr.graph is not None) == graphs
        st = tr.opt_state
        legs.append(([[h[k] for k in ("loss", "grad_norm", "lr")]
                      for h in hist],
                     [local(t) for t in (*tr.params.values(),
                                         *st["m"].values(),
                                         *st["v"].values(), st["count"])]))
    (hg, sg), (he, se) = legs
    out["train_graph_equals_eager"] = hg == he and all(
        torch.equal(a, b) for a, b in zip(sg, se))


    # --- rwkv6 and zamba2 smoke: sharded against meshless
    for arch in ("rwkv6-3b", "zamba2-2.7b"):
        c = fp32(arch)
        base = Model(c, device="cpu", seed=0)
        a = serve(c, base, None, toks % c.vocab_size, dec % c.vocab_size)[0]
        b = serve(c, base, mesh, toks % c.vocab_size, dec % c.vocab_size)[0]
        r = float(torch.cat(a).square().mean().sqrt())
        out[f"{arch}_gaps"] = [float((x - y).abs().max()) / r
                               for x, y in zip(a, b)]

    if shape == (2, 2):
        # --- the roofline cost model counted on the mesh (per device)
        from repro_torch.serving.profiler import CostModel
        prof = CostModel.from_roofline(cfg, mesh=mesh).prof
        out["roofline"] = [prof.flops_per_token, prof.active_param_bytes]
        # --- the MoE layer with two dispatch groups (the data shards)
        from repro_torch.models.moe import moe_apply, moe_specs
        mcfg = fp32("qwen3-moe-235b-a22b")
        specs = moe_specs(mcfg, "float32")
        flat = {k[2:]: torch.from_numpy(v) for k, v in ref.items()
                if k.startswith("m.")}
        rules = default_rules(mcfg, mesh, "prefill")
        x = torch.from_numpy(ref["moe_x"])
        with axis_rules(rules):
            xd = distribute(x, mesh, placements_of(
                ("act_batch", None, None), rules, x.shape))
            got = moe_apply(distribute_params(flat, specs, mesh, rules),
                            xd, mcfg).full_tensor()
        out["moe_gap"] = float((got - torch.from_numpy(ref["moe_out"]))
                               .abs().max())
    else:
        # --- the elastic remesh (1, 4) -> (2, 2) and a checkpoint saved
        # under a mesh resumed with none, against one unsharded run
        def trainer(m, sub):
            tcfg = TrainConfig(steps=6, ckpt_every=2,
                               ckpt_dir=str(data / sub), log_every=10 ** 9,
                               adamw=opt_mod.AdamWConfig(
                                   lr=1e-3, warmup_steps=1, total_steps=6))
            tr = Trainer(cfg, m, tshape, tcfg, log_fn=lambda s: None,
                         device="cpu")
            tr.init_state(params)
            return tr
        plain = [h["loss"] for h in trainer(None, "plain").run(steps=6)]
        tr = trainer(mesh, "sharded")
        tr.run(steps=2)
        tr.reshard_for_mesh(mesh_of((2, 2)))
        sharded = [h["loss"] for h in tr.run(steps=4)]
        again = trainer(None, "sharded")
        assert again.resume() and again.step == 4
        resumed = [h["loss"] for h in again.run(steps=6)]
        out["remesh_gaps"] = [rel(a, b) for a, b in
                              zip(sharded + resumed, plain)]
    (data / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
""")

#: the reference's grouped MoE layer under a (2, 2) mesh's rules, on four
#: forced host devices (the device count is fixed at JAX's first use)
MOE_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses
    import jax
    import numpy as np
    from repro.configs import get_config
    from repro.dist.sharding import axis_rules, default_rules
    from repro.launch.mesh import _make_mesh
    from repro.models.moe import moe_apply
    d = np.load(sys.argv[1])
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b", smoke=True),
                              compute_dtype="float32")
    params = {k[2:]: d[k] for k in d.files if k.startswith("m.")}
    nested = {k: v for k, v in params.items() if "." not in k}
    shared = {k.split(".", 1)[1]: v for k, v in params.items() if "." in k}
    if shared:
        nested["shared"] = shared
    mesh = _make_mesh((2, 2), ("data", "model"))
    rules = default_rules(cfg, mesh, step_kind="prefill")
    with mesh, axis_rules(rules):
        out = jax.jit(lambda p, x: moe_apply(p, x, cfg))(nested, d["moe_x"])
    np.save(sys.argv[2], np.asarray(out, np.float32))
""")


def _jax_forward(jcfg, params, toks, dec, rules=None):
    """The reference's unsharded prefill and decode steps (fp32 logits of
    every prompt position, each decode step's, the final cache)."""
    model = JaxModel(jcfg)
    with jax_axis_rules(rules or {}):
        logits, cache = model.forward(params, tokens=jnp.asarray(toks),
                                      cache=model.init_cache(B, T),
                                      cache_len=0, mode="prefill")
        steps = []
        for i in range(dec.shape[1]):
            lg, cache = model.forward(
                params, tokens=jnp.asarray(dec[:, i:i + 1]), cache=cache,
                cache_len=jnp.full((B,), S + i, jnp.int32), mode="decode")
            steps.append(np.asarray(lg))
    return np.asarray(logits), steps, cache


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's numbers and the arrays the ranks load; the R8 gap:
    the reference's forward with its TP head padding of 4 (no mesh, so
    every constraint is the identity) against its unpadded forward."""
    data = tmp_path_factory.mktemp("dist")
    jcfg = dataclasses.replace(jax_config("qwen2-1.5b", smoke=True),
                               compute_dtype="float32")
    params = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    dec = rng.integers(0, jcfg.vocab_size, (B, N_DEC)).astype(np.int32)
    logits, steps, cache = _jax_forward(jcfg, params, toks, dec)
    padded, _, _ = _jax_forward(jcfg, params, toks, dec,
                                {"__attn_head_pad__": 4})
    mcfg = dataclasses.replace(jax_config("qwen3-moe-235b-a22b", smoke=True),
                               compute_dtype="float32")
    mparams = jax_init_params(jax_moe_specs(mcfg, "float32"),
                              jax.random.PRNGKey(3))
    arrays = {"toks": toks, "dec": dec, "logits": logits,
              "cache_k": np.asarray(cache["k"]),
              "cache_v": np.asarray(cache["v"]),
              "moe_x": (rng.standard_normal((4, 16, mcfg.d_model)) * 0.5)
              .astype(np.float32),
              **{f"dec{i}": s for i, s in enumerate(steps)},
              **{f"p.{k}": np.asarray(v) for k, v in
                 flatten_tree(params).items()},
              **{f"m.{k}": np.asarray(v) for k, v in
                 flatten_tree(mparams).items()}}
    np.savez(data / "inputs.npz", **arrays)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", MOE_REFERENCE,
                           str(data / "inputs.npz"), str(data / "moe.npy")],
                          env=env, capture_output=True, text=True,
                          timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    arrays["moe_out"] = np.load(data / "moe.npy")
    return arrays, float(np.abs(padded - logits).max()), \
        float(np.sqrt(np.mean(logits ** 2)))


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_sharded_steps_on_four_gloo_ranks(reference, shape, tmp_path):
    """On each rank: qwen2 smoke's sharded prefill and three decode steps
    against the reference's unsharded forward (1e-4 of the logits' rms,
    the next tokens its argmax, the cache within 1e-5 of its largest
    value), the decode steps through the bucketed step (no value read on
    the host during them) and bit-equal, logits, tokens and cache, to
    the eager step (``cuda_graphs=False``); a sharded train step
    against the meshless one (1e-5 relative, two steps); the sharded
    trainer's graph path bit-equal to its eager step (``cuda_graphs=
    False``), history, masters, moments and count, over two steps and
    two more after a remesh to the other mesh; rwkv6's and
    zamba2's sharded steps against their meshless ones; on (2, 2)
    ``CostModel.from_roofline`` counted on the mesh and the MoE layer's
    two dispatch groups against the reference's; on (1, 4) the remesh to (2, 2) and a
    meshless resume from the checkpoints saved under a mesh, every loss
    against an unsharded run of the same steps."""
    arrays, _, _ = reference
    np.savez(tmp_path / "ref.npz", **arrays)
    script = WORKER.replace("shape = tuple(int(x) for x in sys.argv[5]",
                            f"shape = tuple(int(x) for x in {shape!r}")
    script = script.replace("S - 1:S", f"{S - 1}:{S}")
    results = spawn(script, 4, tmp_path)
    for rank, out in enumerate(results):
        assert max(out["qwen2_logit_gaps"]) <= LOGIT_RTOL, (rank, out)
        assert out["qwen2_graph_equals_eager"], (rank, out)
        assert out["qwen2_cache_gap"] <= 1e-5, (rank, out)
        assert out["qwen2_tokens_equal"], (rank, out)
        assert max(out["train_gaps"]) <= TRAIN_RTOL, (rank, out)
        assert out["train_graph_equals_eager"], (rank, out)
        for arch in ("rwkv6-3b", "zamba2-2.7b"):
            assert max(out[f"{arch}_gaps"]) <= LOGIT_RTOL, (rank, out)
        if shape == "2x2":
            assert out["moe_gap"] <= MOE_ATOL, (rank, out)
            assert all(0 < x < float("inf") for x in out["roofline"]), out
        else:
            assert len(out["remesh_gaps"]) == 6
            assert max(out["remesh_gaps"]) <= TRAIN_RTOL, (rank, out)


def test_reference_head_padding_regroups_heads(reference):
    """ROADMAP R8: the reference pads H = 6 to 8 as a whole (its rules'
    ``__attn_head_pad__`` of a 4-wide model axis) and reads the GQA group
    size from the padded H, so real heads move to another KV head: its
    logits leave the unpadded forward's by more than 1 (29.8 against an
    rms of 6.85 on this prompt at writing). The port pads within each group, and its
    (1, 4) run above equals the unpadded forward."""
    _, gap, rms = reference
    assert gap > 1.0, (gap, rms)
