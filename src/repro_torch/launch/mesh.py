"""Device meshes: the port of the JAX package's ``launch/mesh.py``.

Functions, not module-level constants, so importing this module touches
no process group. Both build a ``DeviceMesh`` over the process group that
is already initialised (``torch.distributed.init_process_group``: NCCL
over the cards, gloo on the CPU, or the fake backend of the dry run), with
the reference's axis names.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    """The mesh's device type: the cards under NCCL, else the CPU."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_host_mesh(model: int = 1) -> DeviceMesh:
    """(world // model, model) over the process group's ranks, axes
    ("data", "model"): (1, 1) on one card."""
    n = dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(_device_type(), (n // model, model),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16 x 16 = 256 ranks ("data", "model"), or two pods of them, 2 x 16 x
    16 = 512 with a leading "pod" axis, over whatever group is
    initialised (the dry run's fake one of that size)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = 1
    for n in shape:
        need *= n
    if dist.get_world_size() != need:
        raise ValueError(f"a {shape} mesh needs {need} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)
