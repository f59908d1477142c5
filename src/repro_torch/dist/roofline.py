"""The port's step counter: FLOPs and HBM bytes of one run of a built step
(:mod:`repro_torch.models.steps`), in place of the JAX package's HLO
analyzer (``dist/roofline.py`` there parses XLA's compiled HLO text, which
the port never has).

- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the run (the
  matmul family: 2 x M x N x K a product, as the analyzer counts a dot);
- bytes: the analyzer's byte model. Operand and output bytes of the
  traffic-bearing ops only, the matmul-family aten ops here (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``convolution``); elementwise chains
  are taken as fused, at 0 bytes.

The port's CUDA kernels are ctypes calls that no dispatch mode sees, so
the count runs where the plain arithmetic runs: best on the ``meta``
device (a model built there draws and allocates nothing, like the
reference's ``ShapeDtypeStruct`` lowering), which gives the same count on
any machine and costs no weights at full width.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

#: the ops whose operand and output bytes hit HBM (the analyzer's dot,
#: convolution and custom-call; every kernel of the port is off this path)
TRAFFIC_OPS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
               torch.ops.aten.baddbmm, torch.ops.aten.convolution}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0           # HBM traffic (traffic-bearing ops only)


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class _ByteCounter(TorchDispatchMode):
    """Sums operand and output bytes of the traffic-bearing ops."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket in TRAFFIC_OPS:
            self.bytes += sum(map(_nbytes, tree_leaves((args, kwargs,
                                                        out))))
        return out


def count_step(step, inputs: tuple | None = None) -> Cost:
    """FLOPs and bytes of one run of ``step`` (a ``BuiltStep``) on
    ``inputs`` (default: its ``make_inputs()``)."""
    inputs = step.make_inputs() if inputs is None else inputs
    with FlopCounterMode(display=False) as flops, _ByteCounter() as nbytes:
        step.fn(*inputs)
    return Cost(float(flops.get_total_flops()), float(nbytes.bytes))
