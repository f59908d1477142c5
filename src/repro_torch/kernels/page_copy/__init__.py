from repro_torch.kernels.page_copy.kernel import (page_gather_kernel,
                                                  page_scatter_kernel,
                                                  token_append_kernel)
from repro_torch.kernels.page_copy.ops import (append_tokens, copy_pages,
                                               gather_pages, scatter_pages)
from repro_torch.kernels.page_copy.ref import (append_tokens_ref,
                                               copy_pages_ref,
                                               page_gather_ref,
                                               page_scatter_ref)

__all__ = ["append_tokens", "copy_pages", "gather_pages", "scatter_pages",
           "append_tokens_ref", "copy_pages_ref", "page_gather_ref",
           "page_scatter_ref", "page_gather_kernel", "page_scatter_kernel",
           "token_append_kernel"]
