from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_kernel, flash_extend_kernel)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_kernel", "flash_attention_ref",
           "flash_extend_kernel"]
