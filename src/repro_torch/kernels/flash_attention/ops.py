"""Flash attention, dispatched by device: a CUDA tensor launches the
hand-written kernel (:mod:`.kernel`), a CPU tensor takes the plain version
(:mod:`.ref`)."""
from __future__ import annotations

from repro_torch.kernels.flash_attention.kernel import flash_attention_kernel
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, scale=None, causal=True, window=0,
                    softcap=0.0):
    """q (B, H, S, D); k/v (B, KV, S, D) -> (B, H, S, D) in q's dtype."""
    if q.device.type == "cuda":
        return flash_attention_kernel(q, k, v, scale=scale, causal=causal,
                                      window=window, softcap=softcap)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                   window=window, softcap=softcap)
    raise ValueError(f"flash_attention: unsupported device {q.device}")
