"""How the two qkv passes compare across their launch settings on the
card: the decode step's qkv launch (``qkv_proj_kernel``) by cluster split
and ring depth, and the row pass (``qkv_rope_chunk_kernel``) by block
size.

Builds ``csrc/fusions.cu`` as it is and as edited copies (compiled by
``nvcc`` into ``build/repro_torch_kernels/probes/``): other ring depths
(``kQpStages``) and other row-pass blocks (``kRowThreads``). For the qkv
launch it binds each build in turn and calls the launch's C entry point
with each cluster split of ``plan_qkv``'s choices (``QKV_SPLITS``, those
that give every rank a K tile), at qwen2-1.5b's widths (d_model 1536, 12
query heads, 2 KV heads, Dh 128, the qkv bias, full RoPE) for 4 and 16
tokens, and at qwen3-moe-235b-a22b's (d_model 4096, 64 / 4 heads, the qk
norm) for 4, rotating over enough weight copies that every call finds
its weights cold in the 50 MB L2, as a decode step's layer loop does.
Each split's output is the same bits in every build, and within
``ref.qkv_proj_bound`` of the plain version. For the row pass it times
path A's 512-row chunk (qwen2-1.5b's heads, offset 2048 on 2560 slots)
in each block build, its bits the default build's. All by CUDA-graph
replay in interleaved rounds, the qkv launch beside the three cuBLAS
products and the row pass (the route it replaces). Run from the root of
a checkout, on the card::

    PYTHONPATH=src python3 -m repro_torch.launch.qkv_probes

Prints one JSON object: the card's name and power limit, the plan's
choice, and each build's and split's device ms in each round.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import re
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fusions import kernel as fk
from repro_torch.kernels.fusions import ref as fref
from repro_torch.models.common import rope_tables

ROUNDS = 3
#: the ring depths and row-pass blocks to build (the source's own is
#: ``as_is``)
STAGES = (2, 3, 6)
ROW_THREADS = (128, 512)
#: (name, d_model, H, KV, Dh, bias, qk norm, rows)
CASES = (("qwen2_b4", 1536, 12, 2, 128, True, False, 4),
         ("qwen2_b16", 1536, 12, 2, 128, True, False, 16),
         ("qwen3moe_b4", 4096, 64, 4, 128, False, True, 4))
L2_BYTES = 50e6


def edited_source(name: str) -> str:
    """The source for probe ``name`` (``as_is``, ``stages<n>`` or
    ``rows<n>``); raises if the source no longer holds the edited text
    exactly once."""
    text = (_build.CSRC / "fusions.cu").read_text()
    if name == "as_is":
        return text
    const, value = ("kQpStages", name[6:]) if name.startswith("stages") \
        else ("kRowThreads", name[4:])
    old = re.search(rf"constexpr int {const} = \d+;", text)
    if old is None or text.count(old.group(0)) != 1:
        raise RuntimeError(f"probe: the source no longer holds {const} once")
    return text.replace(old.group(0), f"constexpr int {const} = {value};")


def build_probes(names) -> dict[str, str]:
    """name -> library path, all builds compiled in parallel."""
    out_dir = _build.BUILD_DIR / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = out_dir / f"fusions_{name}.cu"
        src.write_text(edited_source(name))
        lib = out_dir / f"libfusions_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for probe {name}:\n{log}")
        libs[name] = str(lib)
    return libs


def bind(path: str) -> None:
    """Use the library at ``path`` for the fusions' next launches (the
    tensor maps are re-encoded: a map is made by the bound library)."""
    _build._libs["fusions"] = ctypes.CDLL(path)
    for key in [k for k in _build._funcs if k[0] == "fusions"]:
        del _build._funcs[key]
    fk._QKV_MAPS.clear()


def graph_ms(fn, iters: int = 24, warmup: int = 3, reps: int = 5) -> float:
    """Device ms a call: ``iters`` calls in one CUDA graph, ``reps``
    replays timed with CUDA events (as ``chip_smoke.graph_ms``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def case_inputs(case, gen) -> dict:
    """A case's token rows, bias / qk norm, tables at positions up to
    32k, output rows, and weight copies past the L2's size."""
    _, D, H, KV, Dh, bias, norm, rows = case

    def r(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") *
                std).to(torch.bfloat16)

    sets = int(L2_BYTES // (2 * D * (H + 2 * KV) * Dh)) + 2
    pos = torch.randint(0, 32768, (rows, 1), generator=gen, device="cuda")
    return dict(
        x=r(rows, 1, D),
        ws=[(r(D, H, Dh, std=D ** -0.5), r(D, KV, Dh, std=D ** -0.5),
             r(D, KV, Dh, std=D ** -0.5)) for _ in range(sets)],
        chain=dict(bias=(r(H, Dh, std=0.5), r(KV, Dh, std=0.5),
                         r(KV, Dh, std=0.5)) if bias else None,
                   norm=(r(Dh, std=0.1), r(Dh, std=0.1)) if norm else None,
                   eps=1e-6, rope=rope_tables(pos, Dh, 1e6, 1.0)),
        k_out=r(rows, KV, Dh), v_out=r(rows, KV, Dh))


def launch_split(t: dict, ws, split: int):
    """One launch through the C entry point with the cluster split
    forced (the wrapper takes the plan's)."""
    x, (wq, wk, wv) = t["x"], ws
    D, H, Dh = wq.shape
    KV, rows = wk.shape[1], x.shape[0]
    q = x.new_empty((rows, H, Dh))
    maps = fk._qkv_maps(wq, wk, wv)
    bq, bk, bv, qn, kn, cos, sin = fk._rope_ptrs(t["chain"]["bias"],
                                                 t["chain"]["norm"],
                                                 t["chain"]["rope"])
    fn = _build.function("fusions", "qkv_proj_launch", fk._QP_ARGS)
    err = fn(ctypes.addressof(maps), x.data_ptr(), bq, bk, bv, qn, kn, cos,
             sin, q.data_ptr(), t["k_out"].data_ptr(),
             t["v_out"].data_ptr(), rows, D, H, KV, Dh,
             t["chain"]["rope"][0].shape[-1], rows, split, 1e-6,
             torch.cuda.current_stream().cuda_stream)
    _build.check("fusions", err, "qkv_probes")
    return q


def chunk_case(gen) -> dict:
    """Path A's chunk: 512 rows of qwen2-1.5b's heads at offset 2048 of a
    2560-slot cache, bias and RoPE, bf16."""
    H, KV, Dh, C, T = 12, 2, 128, 512, 2560

    def r(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") *
                std).to(torch.bfloat16)

    off = torch.full((1,), T - C, dtype=torch.int32, device="cuda")
    pos = off.long()[:, None] + torch.arange(C, device="cuda")
    return dict(q=r(C, H, Dh), k=r(C, KV, Dh), v=r(C, KV, Dh),
                kw=dict(cache_k=r(1, T, KV, Dh), cache_v=r(1, T, KV, Dh),
                        offsets=off, bias=(r(H, Dh, std=0.5),
                                           r(KV, Dh, std=0.5),
                                           r(KV, Dh, std=0.5)),
                        rope=rope_tables(pos, Dh, 1e6, 1.0)))


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("qkv_probes: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    stages = ["as_is", *(f"stages{s}" for s in STAGES)]
    blocks = ["as_is", *(f"rows{n}" for n in ROW_THREADS)]
    libs = build_probes(sorted(set(stages + blocks)))
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {c[0]: case_inputs(c, gen) for c in CASES}
    chunk = chunk_case(gen)
    out = {"card": smi, "plan": {}, "route_ms": {}, "ms": {}, "chunk_ms": {}}
    for case in CASES:
        name, D, H, KV, Dh, _, _, rows = case
        plan = fk.plan_qkv(rows, D, H, KV, Dh, rot_half=Dh // 2)
        out["plan"][name] = plan.split
        t = inputs[name]
        bounds = fref.qkv_proj_bound(t["x"], *t["ws"][0], **t["chain"])
        plain = fref.qkv_proj_ref(t["x"], *t["ws"][0],
                                  k_out=torch.empty_like(t["k_out"]),
                                  v_out=torch.empty_like(t["v_out"]),
                                  **t["chain"])
        for s in (s for s in fk.QKV_SPLITS if s <= plan.k_tiles):
            bind(libs["as_is"])
            want = launch_split(t, t["ws"][0], s)
            if not ((want.double() - plain.double()).abs()
                    <= bounds[0]).all():
                raise AssertionError(f"{name} split {s}: q off the plain "
                                     f"version past its bound")
            for lib in stages[1:]:
                bind(libs[lib])
                if not torch.equal(launch_split(t, t["ws"][0], s), want):
                    raise AssertionError(f"{name} {lib} split {s} differs")
    bind(libs["as_is"])
    want = fk.qkv_rope_chunk_kernel(chunk["q"], chunk["k"], chunk["v"],
                                    **chunk["kw"])
    for lib in blocks[1:]:
        bind(libs[lib])
        if not torch.equal(fk.qkv_rope_chunk_kernel(
                chunk["q"], chunk["k"], chunk["v"], **chunk["kw"]), want):
            raise AssertionError(f"chunk {lib} differs")
    try:
        for _ in range(ROUNDS):
            for case in CASES:
                name = case[0]
                t = inputs[name]
                turn = itertools.cycle(t["ws"])

                def route():
                    q, k, v = fref.qkv_products(t["x"], *next(turn))
                    return fk.qkv_rope_kernel(q, k, v, k_out=t["k_out"],
                                              v_out=t["v_out"],
                                              **t["chain"])

                bind(libs["as_is"])
                out["route_ms"].setdefault(name, []).append(graph_ms(route))
                for lib in stages:
                    bind(libs[lib])
                    for s in fk.QKV_SPLITS:
                        if s > fk.plan_qkv(case[7], *case[1:5]).k_tiles:
                            continue
                        out["ms"].setdefault(f"{name} {lib} split{s}",
                                             []).append(graph_ms(
                            lambda: launch_split(t, next(turn), s)))
            for lib in blocks:
                bind(libs[lib])
                out["chunk_ms"].setdefault(lib, []).append(graph_ms(
                    lambda: fk.qkv_rope_chunk_kernel(
                        chunk["q"], chunk["k"], chunk["v"], **chunk["kw"])))
    finally:
        _build._libs.pop("fusions", None)
        for key in [k for k in _build._funcs if k[0] == "fusions"]:
            del _build._funcs[key]
        fk._QKV_MAPS.clear()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
