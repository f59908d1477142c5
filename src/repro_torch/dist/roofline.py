"""The port's step counter: FLOPs, HBM bytes and collective bytes of one
run of a built step (:mod:`repro_torch.models.steps`), in place of the
JAX package's HLO analyzer (``dist/roofline.py`` there parses XLA's
compiled HLO text, which the port never has).

- FLOPs: ``torch.utils.flop_counter``'s per-op formulas (the matmul
  family: 2 x M x N x K a product, as the analyzer counts a dot);
- bytes: the analyzer's byte model. Operand and output bytes of the
  traffic-bearing ops only, the matmul-family aten ops here (``mm``,
  ``bmm``, ``addmm``, ``baddbmm``, ``convolution``); elementwise chains
  are taken as fused, at 0 bytes;
- collective bytes: the result bytes of each c10d functional collective
  (all-gather, reduce-scatter, all-reduce, all-to-all), the analyzer's
  third term.

A step on a mesh runs on DTensors. The counter lets DTensor run each op
first (it returns ``NotImplemented`` to a DTensor, as torch's
``CommDebugMode`` does) and counts what DTensor then runs: every op at
this rank's local shapes and every collective it issues. So the three
numbers are per device, like the reference's ``cost_analysis``; on one
device there are no collectives and the count is the plain one.
(``FlopCounterMode`` alone sees the DTensor op at its global shape.)

The port's CUDA kernels are ctypes calls that no dispatch mode sees, so
the count runs where the plain arithmetic runs: best on the ``meta``
device (a model built there draws and allocates nothing, like the
reference's ``ShapeDtypeStruct`` lowering), which gives the same count on
any machine and costs no weights at full width.
"""
from __future__ import annotations

import dataclasses

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

#: the ops whose operand and output bytes hit HBM (the analyzer's dot,
#: convolution and custom-call; every kernel of the port is off this path)
TRAFFIC_OPS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
               torch.ops.aten.baddbmm, torch.ops.aten.convolution}

_c10d = torch.ops._c10d_functional
_c10d_grad = torch.ops._c10d_functional_autograd
#: the collectives DTensor issues (and the port's own, functional ones;
#: the MoE all-to-all takes the autograd variant where torch has one)
COLLECTIVES = {_c10d.all_gather_into_tensor, _c10d.reduce_scatter_tensor,
               _c10d.all_reduce, _c10d.all_to_all_single,
               _c10d_grad.all_to_all_single}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0           # HBM traffic (traffic-bearing ops only)
    coll_bytes: float = 0.0      # collective result bytes


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class _Counter(TorchDispatchMode):
    """Sums each op's FLOPs, the traffic-bearing ops' operand and output
    bytes and the collectives' result bytes, at local shapes."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # count what DTensor runs
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor working out an output's shape, at the global shape
            return func(*args, **kwargs)
        packet = func.overloadpacket
        if packet not in flop_registry and \
                func is not torch.ops.prim.device.default:
            with self:                       # as FlopCounterMode does
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        if packet in flop_registry:
            self.cost.flops += flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        if packet in TRAFFIC_OPS:
            self.cost.bytes += sum(map(_nbytes, tree_leaves((args, kwargs,
                                                             out))))
        if packet in COLLECTIVES:
            self.cost.coll_bytes += _nbytes(out)
        return out


def count_step(step, inputs: tuple | None = None) -> Cost:
    """FLOPs, bytes and collective bytes of one run of ``step`` (a
    ``BuiltStep``) on ``inputs`` (default: its ``make_inputs()``), per
    device."""
    inputs = step.make_inputs() if inputs is None else inputs
    with _Counter() as counter:
        step.fn(*inputs)
    c = counter.cost
    return Cost(float(c.flops), float(c.bytes), float(c.coll_bytes))
