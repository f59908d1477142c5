from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan_kernel
from repro_torch.kernels.rwkv6_scan.ops import rwkv6_scan, wkv_chunked
from repro_torch.kernels.rwkv6_scan.ref import (rwkv6_chunked_ref,
                                                rwkv6_scan_ref)

__all__ = ["rwkv6_chunked_ref", "rwkv6_scan", "rwkv6_scan_kernel",
           "rwkv6_scan_ref", "wkv_chunked"]
