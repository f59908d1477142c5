from repro_torch.kernels.decode_attention.kernel import \
    paged_decode_attention_kernel
from repro_torch.kernels.decode_attention.ops import paged_decode_attention
from repro_torch.kernels.decode_attention.ref import (
    merge_new_token_ref, paged_decode_attention_ref, sanitize_block_tables)

__all__ = ["merge_new_token_ref", "paged_decode_attention",
           "paged_decode_attention_kernel", "paged_decode_attention_ref",
           "sanitize_block_tables"]
