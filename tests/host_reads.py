"""``no_host_reads``: a guard for the port's tests of captured steps
(imported by ``test_torch_forward_graph.py``, ``test_torch_sharding.py``
and the gloo ranks of ``test_torch_dist.py``)."""
import torch

from repro_torch.models import attention as attn


class no_host_reads(torch.overrides.TorchFunctionMode):
    """Reading a tensor's value on the host raises inside the block (on
    the card it would be a stream sync, which a capture refuses), and so
    does ``attention._offsets``, the host branch's reader."""
    READS = (torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__int__,
             torch.Tensor.__bool__, torch.Tensor.__index__,
             torch.Tensor.__float__)

    def __enter__(self):
        self._offsets = attn._offsets
        attn._offsets = self._refuse
        return super().__enter__()

    def __exit__(self, *exc):
        attn._offsets = self._offsets
        return super().__exit__(*exc)

    @staticmethod
    def _refuse(*args):
        raise AssertionError("the host branch of write_cache was reached")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.READS:
            raise AssertionError(f"a device value read on the host: {func}")
        return func(*args, **(kwargs or {}))
