"""How the page gather's device paths compare on the card.

Builds ``csrc/page_copy.cu`` as it is and as edited copies (compiled by
``nvcc`` into ``build/repro_torch_kernels/probes/``): the bulk-copy path
at other ring depths, piece sizes and blocks an SM, and the row kernel
taking every row (``rows``: one block a (page, layer), 16-byte loads a
thread, as the gather was before its bulk path). Binds each build in
place of the default one in turn and times the gather's wrapper
(``torch.profiler``'s device time, as ``kernel_pair.py`` takes it) at
the stage-out shape (qwen2-1.5b width: 128 pages x 28 layers of 8 KB
bf16 rows out of a 1024-page pool, each call taking the next of 4 id
sets, as ``chip_smoke.py`` times the page moves), beside a contiguous
device copy of the same bytes (the card's copy ceiling), in interleaved
rounds. Each build is checked bit-exact first. Run from the root of a
checkout, on the card::

    PYTHONPATH=src python3 -m repro_torch.launch.gather_probes

Prints one JSON object: the card's name and power limit, then each
build's device ms in each round.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import re
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.page_copy import page_gather_kernel, page_gather_ref
from repro_torch.launch.kernel_pair import device_ms

LAYERS, POOL, PAGES, SETS, ROUNDS = 28, 1024, 128, 4, 3
RING = ("kBulkSlots", "kBulkChunk", "kBulkBlocksPerSM")
# name -> the ring constants (slots, piece bytes, blocks an SM) to build
# with; the source's own values are ``as_is``
RINGS = {"s4_c8192_b4": (4, 8192, 4), "s5_c8192_b4": (5, 8192, 4),
         "s4_c8192_b6": (4, 8192, 6), "s2_c16384_b4": (2, 16384, 4)}
ROWS = ("  if ((a & 15) == 0) {\n    int dev = 0, sms = 0;",
        "  if (false) {\n    int dev = 0, sms = 0;")


def edited_source(name: str) -> str:
    """The source for probe ``name``; raises if the source no longer holds
    an edited text exactly once."""
    text = (_build.CSRC / "page_copy.cu").read_text()
    if name == "as_is":
        return text
    edits = [ROWS] if name == "rows" else [
        (re.search(rf"constexpr int {const} = \d+;", text).group(0),
         f"constexpr int {const} = {value};")
        for const, value in zip(RING, RINGS[name])]
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"probe {name}: the source no longer holds "
                               f"{old.strip()!r} once")
        text = text.replace(old, new)
    return text


def build_probes(names) -> dict[str, str]:
    """name -> library path, all builds compiled in parallel."""
    out_dir = _build.BUILD_DIR / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = out_dir / f"page_copy_{name}.cu"
        src.write_text(edited_source(name))
        lib = out_dir / f"libpage_copy_{name}.so"
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
    """Use the library at ``path`` for the page moves' next launches."""
    _build._libs["page_copy"] = ctypes.CDLL(path)
    for key in [k for k in _build._funcs if k[0] == "page_copy"]:
        del _build._funcs[key]


def bind_default() -> None:
    bind(str(_build.build_all()["page_copy"]))


def gather_ms(pages: torch.Tensor, sets) -> float:
    """The bound build's gather: bit-exact on every id set, then its
    device ms a call, rotating over the sets."""
    for ids in sets:
        got = page_gather_kernel(pages, ids)
        torch.cuda.synchronize()
        if not torch.equal(got, page_gather_ref(pages, ids)):
            raise AssertionError("gather differs from its plain version")
    turn = itertools.cycle(range(len(sets)))
    return device_ms(lambda: page_gather_kernel(pages, sets[next(turn)]))


def stage_out_case(gen):
    """A 1024-page bf16 pool at qwen2-1.5b width and SETS id sets of
    PAGES pages."""
    pool = torch.randn((LAYERS, POOL, 16, 2, 128), generator=gen,
                       device="cuda").to(torch.bfloat16)
    rng = np.random.default_rng(9)
    return pool, [rng.permutation(POOL)[:PAGES] for _ in range(SETS)]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gather_probes: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    libs = build_probes(["as_is", *RINGS, "rows"])
    pool, sets = stage_out_case(torch.Generator(device="cuda").manual_seed(0))
    src = torch.empty((LAYERS, PAGES, 16, 2, 128), dtype=pool.dtype,
                      device="cuda")
    dst = torch.empty_like(src)
    out = {"card": smi, **{name: [] for name in libs},
           "contiguous_copy": []}
    try:
        for _ in range(ROUNDS):
            for name, path in libs.items():
                bind(path)
                out[name].append(gather_ms(pool, sets))
            out["contiguous_copy"].append(device_ms(lambda: dst.copy_(src)))
    finally:
        bind_default()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
