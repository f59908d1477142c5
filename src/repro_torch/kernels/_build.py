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
SOURCES = ("page_copy", "decode_attention", "dense_decode",
           "flash_attention", "rwkv6_scan", "fusions", "mamba2")
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


def library_path(name: str, flags: tuple = ()) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        NVCC_FLAGS + tuple(flags)).encode()).hexdigest()
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


def load_variant(lib: str, flags: tuple) -> ctypes.CDLL:
    """Build source ``lib`` with the extra ``nvcc`` ``flags`` (for
    example a ``-D`` that compiles in measurement probes) into a library
    of its own and bind it in place of the default build for the rest of
    the process: entry points looked up after this call come from the
    variant. Returns the loaded library."""
    path = library_path(lib, flags)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc(), *NVCC_FLAGS, *flags, "-o", str(tmp),
                               str(CSRC / f"{lib}.cu")],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {lib} {flags}:\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    with _lock:
        _libs[lib] = ctypes.CDLL(str(path))
        for key in [k for k in _funcs if k[0] == lib]:
            del _funcs[key]
        return _libs[lib]


def function(lib: str, name: str, argtypes: list, restype=ctypes.c_int):
    """The C entry point ``name`` of library ``lib`` with its argument
    and result types declared; the library is built and loaded on first
    use. A resolved entry point is returned without taking the lock."""
    key = (lib, name)
    fn = _funcs.get(key)
    if fn is not None:
        return fn
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
