"""Shared kernel-package plumbing: device dispatch, index upload, launch
counts.

The port has no ``interpret`` flag (the JAX package's
``resolve_interpret``). The device of the tensor a wrapper is given
decides: a CPU tensor takes the kernel's plain PyTorch version (``ref.py``),
a CUDA tensor launches the hand-written CUDA kernel or raises. Nothing
falls back from one to the other. Importing this package builds nothing;
the CUDA sources are compiled on the first launch (:mod:`._build`).
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (every entry point's
    default) raises when no GPU is visible: the CPU is used only when the
    caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def host_index(ids) -> np.ndarray:
    """A 1-D int64 host array from a sequence, an array or a tensor of
    indices (validated on the host before any pointer reaches a kernel)."""
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    arr = np.asarray(ids)
    if arr.ndim != 1 or not (arr.size == 0
                             or np.issubdtype(arr.dtype, np.integer)):
        raise ValueError(f"expected a 1-D integer index, got {arr.dtype} "
                         f"{arr.shape}")
    return arr.astype(np.int64)


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """An int32 tensor on ``device`` from a host array. On the GPU the copy
    goes through pinned memory and does not wait for the stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def kernel_wrappers() -> dict:
    """name -> CUDA wrapper, for every kernel of the port. Each wrapper
    carries ``launches``: the number of kernel launches it has made."""
    from repro_torch.kernels.decode_attention.kernel import \
        paged_decode_attention_kernel
    from repro_torch.kernels.page_copy.kernel import (page_gather_kernel,
                                                      page_scatter_kernel,
                                                      token_append_kernel)
    return {"paged_decode_attention": paged_decode_attention_kernel,
            "page_gather": page_gather_kernel,
            "page_scatter": page_scatter_kernel,
            "token_append": token_append_kernel}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


__all__ = ["host_index", "kernel_wrappers", "launch_counts",
           "reset_launch_counts", "resolve_device", "to_device"]
