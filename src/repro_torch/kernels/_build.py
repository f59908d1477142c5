"""Build and bind the port's CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` exports a plain C interface and is
compiled by ``nvcc`` for Hopper (``sm_90a``) into its own shared library
under ``build/repro_torch_kernels/`` at the root of the checkout, keyed by
a hash of the source and the flags, then loaded with :mod:`ctypes`. All
sources build in parallel, one ``nvcc`` each, on the first launch of any
kernel (or an explicit :func:`build_all`). Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
SOURCES = ("page_copy", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[tuple[str, str], object] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are compiled "
                           "with the CUDA toolkit (set CUDA_HOME)")
    return found


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_log(name: str) -> str:
    """What ``nvcc`` (with ``-Xptxas=-v``: registers, shared memory,
    spills) printed when the library was built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all() -> dict[str, pathlib.Path]:
    """Compile every source whose library is missing, all in parallel.
    Returns name -> library path; raises with the compiler's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name in SOURCES:
            lib = library_path(name)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            with open(lib.with_suffix(".log"), "w") as log:
                proc = subprocess.Popen(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cu")],
                    stdout=log, stderr=subprocess.STDOUT)
            procs.append((name, proc, tmp, lib))
        failed = []
        for name, proc, tmp, lib in procs:
            if proc.wait() != 0:
                failed.append(f"{name}:\n{build_log(name)}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    finally:
        for _, proc, tmp, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return {name: library_path(name) for name in SOURCES}


def function(lib: str, name: str, argtypes: list, restype=ctypes.c_int):
    """The C entry point ``name`` of library ``lib`` with its argument
    and result types declared; the library is built and loaded on first
    use."""
    key = (lib, name)
    with _lock:
        fn = _funcs.get(key)
        if fn is None:
            if lib not in _libs:
                paths = build_all()
                _libs[lib] = ctypes.CDLL(str(paths[lib]))
            fn = getattr(_libs[lib], name)
            fn.argtypes = argtypes
            fn.restype = restype
            _funcs[key] = fn
        return fn


def check(lib: str, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (every entry point
    returns its launch's ``cudaGetLastError``)."""
    if err != 0:
        text = function(lib, "repro_error_string", [ctypes.c_int],
                         ctypes.c_char_p)(err)
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({text.decode() if text else '?'})")
