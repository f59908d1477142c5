"""zamba2's Mamba2 mixer as hand-written CUDA kernels (``csrc/mamba2.cu``):
a one-token decode step of a layer (its conv, recurrence, D skip, gate
and norm) in one launch, and a prompt's chunked SSD with its D skip,
gate and norm in one launch, on ``Model.forward(fused=True)``'s path. No
package under ``src/repro/kernels/`` is their counterpart: the reference
leaves its Mamba2 block (``src/repro/models/mamba2.py``) to XLA."""
from repro_torch.kernels.mamba2.kernel import (mamba2_refusal,
                                               mamba2_step_kernel,
                                               ssd_chunk_kernel,
                                               takes_mamba2_launch)
from repro_torch.kernels.mamba2.ops import mamba2_step, ssd_chunk
from repro_torch.kernels.mamba2.ref import (gate_norm_ref, lane_sum,
                                            mamba2_step_ref, ssd_chunk_ref,
                                            ssd_ref, step_core_ref)

__all__ = ["gate_norm_ref", "lane_sum", "mamba2_refusal", "mamba2_step",
           "mamba2_step_kernel", "mamba2_step_ref",
           "ssd_chunk", "ssd_chunk_kernel", "ssd_chunk_ref", "ssd_ref",
           "step_core_ref", "takes_mamba2_launch"]
