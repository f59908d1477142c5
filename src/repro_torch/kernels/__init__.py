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

import contextlib

import numpy as np
import torch


def resolve_device(device, allow_meta: bool = False) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (every entry point's
    default) raises when no GPU is visible: the CPU is used only when the
    caller asks for it. ``meta`` (shapes without storage) only where
    ``allow_meta``: the model, which the step counter builds there, never
    a serving or training entry point."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu") + (("meta",) if allow_meta else ()):
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


def device_guard(device: torch.device):
    """``torch.cuda.device(device)``, or no guard when ``device`` is
    already the current one (the usual case, and ~2 us cheaper a call)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_handle(device: torch.device) -> int:
    """The raw handle of the current stream on ``device``: what
    ``torch.cuda.current_stream(device).cuda_stream`` returns, without
    building a ``Stream`` object (~4 us a call on the card's host)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def kernel_wrappers() -> dict:
    """name -> CUDA wrapper, for every kernel of the port. Each wrapper
    carries ``launches``: the number of kernel launches it has made.
    ``flash_extend`` is the flash kernels' extend launch, apart from the
    prefill's ``flash_attention``; ``qkv_rope_chunk`` the qkv pass's chunk
    launch, apart from the decode step's ``qkv_rope``; ``qkv_proj`` the
    bf16 decode step's qkv products with that pass, one launch;
    ``gate_up_act``
    the decode step's gate / up products with their activation, apart
    from ``gated_act`` (the activation alone); ``dense_decode_attention``
    decode attention's launch over ``Model.forward``'s dense cache (a
    one-token step), apart from the paged ``paged_decode_attention``;
    ``mamba2_step`` a Mamba2 layer's one-token decode step and
    ``ssd_chunk`` a prompt's chunked SSD with its gate and norm."""
    from repro_torch.kernels.decode_attention.kernel import (
        dense_decode_attention_kernel, paged_decode_attention_kernel)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_kernel, flash_extend_kernel)
    from repro_torch.kernels.fusions.kernel import (gate_up_act_kernel,
                                                    gated_act_kernel,
                                                    qkv_proj_kernel,
                                                    qkv_rope_chunk_kernel,
                                                    qkv_rope_kernel,
                                                    rms_norm_kernel)
    from repro_torch.kernels.mamba2.kernel import (mamba2_step_kernel,
                                                   ssd_chunk_kernel)
    from repro_torch.kernels.page_copy.kernel import (
        page_gather_kernel, page_scatter_kernel, token_append_indexed_kernel,
        token_append_kernel)
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_kernel
    return {"paged_decode_attention": paged_decode_attention_kernel,
            "dense_decode_attention": dense_decode_attention_kernel,
            "page_gather": page_gather_kernel,
            "page_scatter": page_scatter_kernel,
            "token_append": token_append_kernel,
            "token_append_indexed": token_append_indexed_kernel,
            "flash_attention": flash_attention_kernel,
            "flash_extend": flash_extend_kernel,
            "rwkv6_scan": rwkv6_scan_kernel,
            "rms_norm": rms_norm_kernel,
            "qkv_rope": qkv_rope_kernel,
            "qkv_rope_chunk": qkv_rope_chunk_kernel,
            "qkv_proj": qkv_proj_kernel,
            "gated_act": gated_act_kernel,
            "gate_up_act": gate_up_act_kernel,
            "mamba2_step": mamba2_step_kernel,
            "ssd_chunk": ssd_chunk_kernel}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


__all__ = ["device_guard", "host_index", "kernel_wrappers", "launch_counts",
           "reset_launch_counts", "resolve_device", "stream_handle",
           "to_device"]
