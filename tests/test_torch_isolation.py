"""The port stands alone: it imports nothing of JAX or the JAX package,
runs on the CPU only when asked to, dispatches every kernel by device, and
its copies of the control plane stay in sync with the originals."""
import ast
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import _build, kernel_wrappers, launch_counts
from repro_torch.kernels.decode_attention import (
    paged_decode_attention_kernel)
from repro_torch.kernels.flash_attention import flash_attention_kernel
from repro_torch.kernels.page_copy import (page_gather_kernel,
                                           page_scatter_kernel,
                                           token_append_kernel)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_kernel
from repro_torch.models import Model
from repro_torch.serving.backend import TorchModelBackend
from repro_torch.serving.paged_runtime import PagedKVRuntime

# the suite runs in several worker processes at once: one intra-op
# thread each keeps torch's CPU thread pools from oversubscribing
# the cores (tiny eager ops then spend their time spinning)
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
ORIG = ROOT / "src" / "repro"

#: modules carried verbatim from the JAX package (``repro.`` read as
#: ``repro_torch.``); serving/profiler.py differs only in from_roofline,
#: which counts the port's steps in place of the reference's HLO.
#: dist/sharding.py is not a copy (the reference's imports jax.sharding):
#: tests/test_torch_sharding.py holds its rules, specs and axes equal to
#: the reference's instead
COPIES = [
    "configs/__init__.py", "configs/base.py", "configs/gemma2_9b.py",
    "configs/glm4_9b.py", "configs/moonshot_v1_16b_a3b.py",
    "configs/musicgen_large.py", "configs/pixtral_12b.py",
    "configs/qwen2_1_5b.py", "configs/qwen3_moe_235b_a22b.py",
    "configs/rwkv6_3b.py", "configs/stablelm_3b.py", "configs/zamba2_2_7b.py",
    "core/__init__.py", "core/types.py", "core/ttl.py",
    "core/tool_handler.py", "core/policies.py", "core/scheduler.py",
    "serving/blocks.py", "serving/prefix.py", "serving/offload.py",
    "serving/metrics.py", "serving/router.py", "serving/engine.py",
    "serving/kvstore/__init__.py", "serving/kvstore/store.py",
    "serving/kvstore/transfer.py", "sim/workload.py", "sim/runner.py",
    "obs/trace.py", "obs/registry.py", "obs/audit.py", "obs/drift.py",
    "obs/slo.py", "obs/attribution.py", "obs/export.py", "obs/regret.py",
    "obs/server.py", "obs/__init__.py", "obs/trace_schema.json",
    "serving/cluster/clock.py", "serving/cluster/peer.py",
    "serving/cluster/router.py", "serving/cluster/scaling.py",
    "serving/cluster/cluster.py", "serving/cluster/__init__.py",
    "data/tokens.py",
]


def _imported_modules(path: pathlib.Path) -> set[str]:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return mods


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_no_file_imports_jax_or_repro():
    examples = sorted((ROOT / "examples").glob("*_torch.py"))
    assert examples
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + examples
    assert len(files) > 30
    for package in ("obs", "serving/cluster"):
        assert PORT / package / "__init__.py" in files
    bad = {str(f.relative_to(ROOT)): sorted(filter(_forbidden,
                                                   _imported_modules(f)))
           for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_port_runs_with_jax_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import torch
        from repro_torch.configs import get_config
        from repro_torch.models import Model
        from repro_torch.serving.paged_runtime import PagedKVRuntime
        import repro_torch.serving.backend, repro_torch.sim.replay
        import repro_torch.obs, repro_torch.obs.server
        import repro_torch.serving.cluster
        import repro_torch.dist.sharding, repro_torch.launch.mesh
        import repro_torch.launch.dryrun, repro_torch.models.moe_a2a
        cfg = get_config("qwen2-1.5b", smoke=True)
        model = Model(cfg, device="cpu")
        rt = PagedKVRuntime(cfg, n_pages=8, page_size=8, device="cpu")
        first = rt.prefill(model, "p", torch.arange(10))
        out = rt.decode(model, "p")
        assert torch.isfinite(first).all() and torch.isfinite(out.float()).all()
        assert rt.programs["p"].length == 11
        from repro_torch.kernels.flash_attention import flash_attention
        from repro_torch.kernels.rwkv6_scan import rwkv6_scan
        q = torch.randn(1, 4, 9, 16)
        assert flash_attention(q, q[:, :2], q[:, :2]).shape == q.shape
        x = torch.rand(1, 8, 2, 4)
        o, s = rwkv6_scan(x, x, x, x, torch.zeros(2, 4), chunk=4)
        assert o.shape == x.shape and s.shape == (1, 2, 4, 4)
        rwkv = Model(get_config("rwkv6-3b", smoke=True), device="cpu")
        cache = rwkv.init_cache(1, 16)
        logits, cache = rwkv.forward(torch.arange(10)[None], cache=cache)
        logits, cache = rwkv.forward(torch.tensor([[3]]), cache=cache,
                                     mode="decode")
        assert torch.isfinite(logits).all()
        assert torch.isfinite(cache["wkv"]).all()
        loaded = [m for m, v in sys.modules.items() if v is not None
                  and m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not loaded, loaded
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-1.5b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchModelBackend(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedKVRuntime(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Model(cfg)
    from repro_torch.sim import replay
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        replay.run_engine(replay.seeded_programs(0, n=1, twins=False),
                          replay.ReplayConfig())


def test_cpu_tensors_take_the_plain_versions():
    """A whole CPU serving cycle — prefill, decode, COW split, stage-out,
    restore — and an RWKV6 prefill and decode launch no kernel and build
    nothing."""
    cfg = get_config("qwen2-1.5b", smoke=True)
    backend = TorchModelBackend(cfg, max_len=64, page_size=8, n_pages=16,
                                device="cpu")
    rt, model = backend.runtime, backend.model
    rt.prefill(model, "a", torch.arange(12))
    rt.decode_batch(model, ["a"])
    for pi in rt.programs["a"].pages:              # b shares a's pages
        rt.refs[pi] += 1
    rt.programs["b"] = type(rt.programs["a"])(list(rt.programs["a"].pages),
                                              rt.programs["a"].length)
    rt.seed_token("b", 3)
    rt.decode_batch(model, ["a", "b"])             # COW split
    backend.verify_staging = True
    backend.offload_program("a")
    backend.restore_program("a")
    assert rt.cow_splits == 1 and backend.restores == 1
    assert backend.staging_checks == [("a", True)]
    rwkv = Model(get_config("rwkv6-3b", smoke=True), device="cpu")
    _, cache = rwkv.forward(torch.arange(20)[None],
                            cache=rwkv.init_cache(1, 0))
    rwkv.forward(torch.tensor([[5]]), cache=cache, mode="decode")
    assert launch_counts() == {name: 0 for name in kernel_wrappers()}
    assert not _build._libs


@pytest.mark.parametrize("call", [
    lambda t: page_gather_kernel(t, np.array([0])),
    lambda t: page_scatter_kernel(t, t[:, :1].clone(), np.array([0])),
    lambda t: token_append_kernel(t, t.clone(), t[:, 0, 0].clone()[:, None],
                                  t[:, 0, 0].clone()[:, None], np.array([0]),
                                  np.array([0])),
    lambda t: paged_decode_attention_kernel(
        torch.zeros(1, 4, 16), t, t, torch.zeros(1, 1, dtype=torch.int32),
        torch.ones(1, dtype=torch.int32)),
    lambda t: flash_attention_kernel(t[0, :1, :4].transpose(1, 2),
                                     t[0, :1], t[0, :1]),
    lambda t: rwkv6_scan_kernel(t[0], t[0], t[0], t[0], t[0, 0, 0],
                                chunk=8),
])
def test_kernel_wrappers_refuse_cpu_tensors(call):
    """The CUDA wrappers check before they build or launch: a CPU tensor
    is refused, never silently computed some other way."""
    pool = torch.zeros(2, 4, 8, 2, 16)
    with pytest.raises(ValueError):
        call(pool)
    assert launch_counts() == {name: 0 for name in kernel_wrappers()}
    assert not _build._libs


def _without_from_roofline(path: pathlib.Path) -> str:
    """The module's text with CostModel.from_roofline cut out."""
    text = path.read_text()
    tree = ast.parse(text)
    cls = next(n for n in tree.body
               if isinstance(n, ast.ClassDef) and n.name == "CostModel")
    fn = next(n for n in cls.body if getattr(n, "name", "") == "from_roofline")
    lines = text.splitlines(keepends=True)
    start = min([fn.lineno] + [d.lineno for d in fn.decorator_list]) - 1
    return "".join(lines[:start] + lines[fn.end_lineno:])


def _as_port(text: str) -> str:
    return re.sub(r"\brepro\.", "repro_torch.", text)


@pytest.mark.parametrize("rel", COPIES)
def test_control_plane_copy_in_sync(rel):
    assert (PORT / rel).read_text() == _as_port((ORIG / rel).read_text())


def test_profiler_copy_differs_only_in_from_roofline():
    rel = "serving/profiler.py"
    assert _without_from_roofline(PORT / rel) == \
        _as_port(_without_from_roofline(ORIG / rel))
    from repro_torch.serving.profiler import CostModel
    cost = CostModel.from_roofline(get_config("qwen2-1.5b", smoke=True))
    assert cost.prof.flops_per_token > 0 and cost.prof.active_param_bytes > 1
    with pytest.raises(TypeError, match="DeviceMesh"):
        CostModel.from_roofline(get_config("qwen2-1.5b", smoke=True),
                                mesh=object())
