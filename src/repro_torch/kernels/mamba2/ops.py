"""The Mamba2 kernels, dispatched by device: a CUDA tensor launches the
hand-written kernel (:mod:`.kernel`), a CPU tensor takes the plain
version (:mod:`.ref`), and so does a ``meta`` tensor (shapes only: the
step counter counts the plain arithmetic); any other device raises."""
from __future__ import annotations

from repro_torch.kernels.mamba2.kernel import (mamba2_step_kernel,
                                               ssd_chunk_kernel)
from repro_torch.kernels.mamba2.ref import mamba2_step_ref, ssd_chunk_ref


def _plain(t, what: str) -> bool:
    if t.device.type in ("cpu", "meta"):
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")


def mamba2_step(z, x, bm, cm, dt, conv_w, conv_b, dt_bias, A_log, D, norm,
                *, conv_state, ssm_state, eps: float):
    """A Mamba2 layer's one-token decode step from its in-products (z (B,
    H, P), x (B, H P), bm / cm (B, G N), the raw dt (B, H)): the conv,
    the recurrence, the D skip, the gate and the norm; ``conv_state``
    and ``ssm_state`` updated in place. Returns y (B, H, P)."""
    fn = mamba2_step_ref if _plain(z, "mamba2_step") else mamba2_step_kernel
    return fn(z, x, bm, cm, dt, conv_w, conv_b, dt_bias, A_log, D, norm,
              conv_state=conv_state, ssm_state=ssm_state, eps=eps)


def ssd_chunk(xr, dt, A_log, Bm, Cm, z, D, norm, state=None, *,
              chunk: int, eps: float):
    """A prompt's chunked SSD from ``state`` (overwritten with the final
    state; None: zeros) with the D skip, the gate and the norm. Returns
    (y (B, S, H, P), final state)."""
    fn = ssd_chunk_ref if _plain(xr, "ssd_chunk") else ssd_chunk_kernel
    return fn(xr, dt, A_log, Bm, Cm, z, D, norm, state, chunk=chunk,
              eps=eps)
