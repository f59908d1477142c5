"""The fusions XLA makes of the reference's jitted decode scan
(``jax.jit(PagedKVRuntime._decode_step_impl)``, ``src/repro/serving/
paged_runtime.py:69``), as hand-written CUDA kernels on the port's paged
decode step; the qkv pass also on the prefill / extend chunk of
``Model.forward(fused=True)``, and the dense FFN's gate and up products
with their activation as one launch on the decode step, and its qkv
products with their bias, qk norm and RoPE as another. No package under
``src/repro/kernels/`` is their counterpart: the reference leaves these
chains to XLA."""
from repro_torch.kernels.fusions.kernel import (gate_up_act_kernel,
                                                gated_act_kernel,
                                                plan_gate_up, plan_qkv,
                                                qkv_proj_kernel,
                                                qkv_rope_chunk_kernel,
                                                qkv_rope_kernel,
                                                rms_norm_kernel,
                                                takes_row_pass)
from repro_torch.kernels.fusions.ops import (attend_merged, gate_up_act,
                                             gated_act, qkv_proj,
                                             qkv_rope_chunk, rms_norm)
from repro_torch.kernels.fusions.ref import (attend_merged_ref,
                                             gate_up_act_ref, gated_act_ref,
                                             qkv_proj_ref,
                                             qkv_rope_chunk_ref,
                                             qkv_rope_ref, rms_norm_ref)

__all__ = ["attend_merged", "attend_merged_ref", "gate_up_act",
           "gate_up_act_kernel", "gate_up_act_ref", "gated_act",
           "gated_act_kernel", "gated_act_ref", "plan_gate_up", "plan_qkv",
           "qkv_proj", "qkv_proj_kernel", "qkv_proj_ref", "qkv_rope_chunk",
           "qkv_rope_chunk_kernel", "qkv_rope_chunk_ref", "qkv_rope_kernel",
           "qkv_rope_ref", "rms_norm", "rms_norm_kernel", "rms_norm_ref",
           "takes_row_pass"]
