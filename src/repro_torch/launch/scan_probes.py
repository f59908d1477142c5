"""Where the RWKV6 WKV scan's two launches spend their time on the card.

Builds ``csrc/rwkv6_scan.cu`` as it is and with parts of it cut out
(edited copies compiled by ``nvcc`` into ``build/repro_torch_kernels/
probes/``), binds each build in place of the default one in turn, and
times each pass with ``torch.profiler`` at rwkv6-3b's prefill shape
(fp32, T 2048, H 40, K = L = 64, with an initial state, the decays
``chip_smoke.check_scan`` times) at B 1 and 2, the carry pass at each slice
width. A cut build computes wrong values: only its times mean anything.
The difference between two builds is what the cut part costs where it
does not overlap the rest. Run from the root of a checkout, on the card::

    PYTHONPATH=src python3 -m repro_torch.launch.scan_probes

Prints one JSON object: the card's name and power limit, then for each
build, shape and slice width the device ms of each pass.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.kernel import SLICES, rwkv6_scan_kernel
from repro_torch.launch.kernel_pair import device_profile

SHAPES = {"B1": dict(B=1, T=2048, H=40, K=64, L=64),
          "B2": dict(B=2, T=2048, H=40, K=64, L=64)}
# the chunk pass's three products, its loads and its stores; the carry
# pass's readout and its memory traffic
SCORES = ("      for (int c = 0; c < K; ++c)\n"
          "        fma_tile(s, lds4(f_t", "      for (int c = 0; c < 0; ++c)\n"
          "        fma_tile(s, lds4(f_t")
O_PRODUCT = ("    const int jmax = min(L, 4 * tr + 3);",
             "    const int jmax = 0;")
U_PRODUCT = ("    for (int j = 0; j < L; ++j)\n      fma_tile(acc, lds4(k_s",
             "    for (int j = 0; j < 0; ++j)\n      fma_tile(acc, lds4(k_s")
CHUNK_LOADS = ("  stage_tile(r_s, ld, r + base, row, L, K, vec);",
               "  if (vec < 0) stage_tile(r_s, ld, r + base, row, L, K, vec);")
CHUNK_LOADS_REST = [(f"  stage_tile({t}_s, ld, {g} + base, row, L, K, vec);",
                     f"  if (vec < 0) stage_tile({t}_s, ld, {g} + base, row, "
                     f"L, K, vec);") for t, g in (("k", "k"), ("v", "v"),
                                                   ("w", "lw"))]
CHUNK_STORES = [
    ("      store_row(o + base + (long long)i * row + 4 * tc, y, nx, vec);",
     "      if (vec < 0) store_row(o + base + (long long)i * row + 4 * tc, "
     "y, nx, vec);"),
    ("        store_row(out.u + (4 * tr + a) * K + 4 * tc, acc[a], nx, vec);",
     "        if (vec < 0) store_row(out.u + (4 * tr + a) * K + 4 * tc, "
     "acc[a], nx, vec);"),
    ("                 out.r_in[t * K + c] = rv * expf(excl);",
     "                 if (vec < 0) out.r_in[t * K + c] = rv * expf(excl);")]
READOUT = ("      for (int q = sp; q < kq; q += kSplit) {",
           "      for (int q = sp; q < 0; q += kSplit) {")
CARRY_MEMORY = [
    ("      stage_tile(st, ld, in.r_in, K, L, K, vec);", ""),
    ("      stage_tile(st + L * ld, VS, in.u + x0, K, K, nv, vec);", ""),
    ("      stage_tile(st + L * ld + K * VS, VS,",
     "      if (vec < 0) stage_tile(st + L * ld + K * VS, VS,"),
    ("      stage_tile(st + L * ld + K * VS + L * VS, ld, in.dec, 0, 1, K, "
     "vec);", ""),
    ("      store_row(o + base + ((long long)n * L + t) * row + x0 + 4 * tx,"
     " y,", "      if (vec < 0) store_row(o + base + ((long long)n * L + t)"
     " * row + x0 + 4 * tx, y,")]
CUTS = {
    "as_is": [],
    "chunk_no_scores": [SCORES],
    "chunk_no_products": [SCORES, O_PRODUCT, U_PRODUCT],
    "chunk_no_loads": [CHUNK_LOADS, *CHUNK_LOADS_REST],
    "chunk_compute_only": [CHUNK_LOADS, *CHUNK_LOADS_REST, *CHUNK_STORES],
    "carry_no_readout": [READOUT],
    "carry_no_readout_no_memory": [READOUT, *CARRY_MEMORY],
}


def cut_source(name: str) -> str:
    """The scan's source with the cuts of probe ``name`` made; raises if
    the source no longer holds a cut's text exactly once."""
    text = (_build.CSRC / "rwkv6_scan.cu").read_text()
    for old, new in CUTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"probe {name}: the source no longer holds "
                               f"{old.strip()!r} once")
        text = text.replace(old, new)
    return text


def build_probes() -> dict[str, str]:
    """name -> library path, all builds compiled in parallel."""
    out_dir = _build.BUILD_DIR / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in CUTS:
        src = out_dir / f"rwkv6_scan_{name}.cu"
        src.write_text(cut_source(name))
        lib = out_dir / f"librwkv6_scan_{name}.so"
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
    """Use the library at ``path`` for the scan's next launches."""
    _build._libs["rwkv6_scan"] = ctypes.CDLL(path)
    for key in [k for k in _build._funcs if k[0] == "rwkv6_scan"]:
        del _build._funcs[key]


def pass_times(case: tuple, L: int, slice_cols: int) -> dict:
    """Device ms a call of each launch, by kernel."""
    by_name = device_profile(lambda: rwkv6_scan_kernel(
        *case, chunk=L, _slice=slice_cols), iters=20)
    return {("chunk" if "chunk" in k else "carry" if "carry" in k else k):
            round(v, 5) for k, v in by_name.items()}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("scan_probes: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    libs = build_probes()
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for name, sh in SHAPES.items():
        B, T, H, K = sh["B"], sh["T"], sh["H"], sh["K"]
        n = lambda *d: torch.randn(d, generator=gen, device="cuda")  # noqa
        cases[name] = (n(B, T, H, K) * 0.5, n(B, T, H, K) * 0.5,
                       n(B, T, H, K) * 0.5, -torch.exp(0.1 * n(B, T, H, K)),
                       n(H, K) * 0.3, n(B, H, K, K) * 0.1)
    out = {"card": smi}
    for probe, path in libs.items():
        bind(path)
        out[probe] = {f"{shape}_vs{vs}": pass_times(cases[shape],
                                                    SHAPES[shape]["L"], vs)
                      for shape in SHAPES for vs in SLICES}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
