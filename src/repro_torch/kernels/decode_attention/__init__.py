from repro_torch.kernels.decode_attention.kernel import (
    dense_decode_attention_kernel, paged_decode_attention_kernel)
from repro_torch.kernels.decode_attention.ops import (dense_decode_attention,
                                                      paged_decode_attention)
from repro_torch.kernels.decode_attention.ref import (
    dense_decode_ref, merge_new_token_ref, paged_decode_attention_ref,
    sanitize_block_tables)

__all__ = ["dense_decode_attention", "dense_decode_attention_kernel",
           "dense_decode_ref", "merge_new_token_ref",
           "paged_decode_attention", "paged_decode_attention_kernel",
           "paged_decode_attention_ref", "sanitize_block_tables"]
