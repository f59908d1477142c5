from repro_torch.kernels.decode_attention.kernel import \
    paged_decode_attention_kernel
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_ref, sanitize_block_tables)

__all__ = ["paged_decode_attention", "paged_decode_attention_kernel",
           "paged_decode_attention_ref", "sanitize_block_tables"]
