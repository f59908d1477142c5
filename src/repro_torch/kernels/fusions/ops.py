"""The paged decode step's fused passes (and the prefill chunk's qkv
pass), dispatched by device: a CUDA tensor launches the hand-written
kernel (:mod:`.kernel`), a CPU tensor takes the plain version
(:mod:`.ref`), any other device raises. ``plain`` takes the plain
version on any device: the runtime's ``fused=False``, to compare the two
on the card."""
from __future__ import annotations

from repro_torch.kernels.decode_attention.kernel import \
    paged_decode_attention_kernel
from repro_torch.dist.sharding import matmul
from repro_torch.kernels.fusions.kernel import (gate_up_act_kernel,
                                                gated_act_kernel,
                                                qkv_proj_kernel,
                                                qkv_rope_chunk_kernel,
                                                qkv_rope_kernel,
                                                rms_norm_kernel,
                                                takes_gate_up,
                                                takes_qkv_proj)
from repro_torch.kernels.fusions.ref import (attend_merged_ref,
                                             gate_up_act_ref, gated_act_ref,
                                             qkv_products, qkv_proj_ref,
                                             qkv_rope_chunk_ref,
                                             rms_norm_ref)


def _takes_plain(x, plain: bool, what: str) -> bool:
    if plain or x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"{what}: unsupported device {x.device}")


def rms_norm(x, scale, eps: float, delta=None, *, fp32_sum: bool = False,
             plain: bool = False):
    """``rms_norm(x)``, or with ``delta`` ``(x + delta, norm)`` (the norm
    reads the fp32 sum with ``fp32_sum``, else the rounded one)."""
    fn = rms_norm_ref if _takes_plain(x, plain, "rms_norm") \
        else rms_norm_kernel
    return fn(x, scale, eps, delta, fp32_sum)


def qkv_proj(x, wq, wk, wv, *, k_out, v_out, bias=None, norm=None,
             eps: float = 0.0, rope=None, plain: bool = False):
    """The decode step's qkv pass from x (B, 1, d_model): the three
    products, then bias, qk norm and RoPE; k and v into ``k_out`` /
    ``v_out``; returns q (B, H, Dh). On the card one launch of
    :func:`qkv_proj_kernel` where :func:`takes_qkv_proj` (bf16, at most
    16 tokens, a head dim of whole boxes), else the three products and
    the row pass's kernel."""
    kw = dict(k_out=k_out, v_out=v_out, bias=bias, norm=norm, eps=eps,
              rope=rope)
    if _takes_plain(x, plain, "qkv_proj"):
        return qkv_proj_ref(x, wq, wk, wv, **kw)
    if takes_qkv_proj(x, wq, wk, rope):
        return qkv_proj_kernel(x, wq, wk, wv, **kw)
    return qkv_rope_kernel(*qkv_products(x, wq, wk, wv), **kw)


def qkv_rope_chunk(q, k, v, *, cache_k, cache_v, offsets, k_rows=None,
                   v_rows=None, bias=None, norm=None, eps: float = 0.0,
                   rope=None, plain: bool = False):
    """Bias, qk norm and RoPE of a prefill / extend chunk's projections
    (N = nb * C rows, a position a row); k and v into the caches at the
    device ``offsets`` (and ``k_rows`` / ``v_rows``); returns q (N, H,
    Dh)."""
    fn = qkv_rope_chunk_ref if _takes_plain(q, plain, "qkv_rope_chunk") \
        else qkv_rope_chunk_kernel
    return fn(q, k, v, cache_k=cache_k, cache_v=cache_v, offsets=offsets,
              k_rows=k_rows, v_rows=v_rows, bias=bias, norm=norm, eps=eps,
              rope=rope)


def attend_merged(q, k_pages, v_pages, tables, lens, k_new, v_new, *,
                  layer: int, scale: float, plain: bool = False):
    """Paged decode attention with the new token's (k, v) merged: (B, H,
    Dh) in q's dtype. On the card the merge runs in decode attention's own
    launch."""
    if _takes_plain(q, plain, "attend_merged"):
        return attend_merged_ref(q, k_pages, v_pages, tables, lens, k_new,
                                 v_new, layer=layer, scale=scale)
    return paged_decode_attention_kernel(q, k_pages, v_pages, tables, lens,
                                         layer=layer, scale=scale,
                                         new_kv=(k_new, v_new))


def gated_act(gate, up, activation: str, *, plain: bool = False):
    """``act(gate) * up``."""
    fn = gated_act_ref if _takes_plain(gate, plain, "gated_act") \
        else gated_act_kernel
    return fn(gate, up, activation)


def gate_up_act(x, w1, w3, activation: str, *, plain: bool = False):
    """``act(x @ w1) * (x @ w3)``: on the card one launch of
    :func:`gate_up_act_kernel` where :func:`takes_gate_up` (bf16, at most
    16 tokens), else the two products and the gated activation's
    kernel."""
    if _takes_plain(x, plain, "gate_up_act"):
        return gate_up_act_ref(x, w1, w3, activation)
    if takes_gate_up(x):
        return gate_up_act_kernel(x, w1, w3, activation)
    return gated_act_kernel(matmul(x, w1), matmul(x, w3), activation)
