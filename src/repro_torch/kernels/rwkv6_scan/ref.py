"""Plain PyTorch RWKV6 WKV: the sequential recurrence (the ground truth, a
port of the JAX package's ``rwkv6_scan_ref``) and the chunked form with the
kernel's exponent clipping (the version a CPU tensor takes and the one
``chip_smoke.py`` holds the CUDA kernel against; the math of the JAX
package's ``_wkv_chunked`` and Pallas ``rwkv6_scan_kernel``, with the
inter-chunk state carried by a Python loop over chunks). The chunked form
is written as the CUDA kernel's two launches: a chunk pass and a carry
pass over the state's columns."""
from __future__ import annotations

import torch

CLIP = 38.0  # exponent clip of the factorized intra-chunk decay (fp32-safe)


def rwkv6_scan_ref(r, k, v, w, u, init_state=None):
    """Sequential recurrence. r/k/v/w (B, T, H, K), w the decay in (0, 1);
    u (H, K) bonus; init_state (B, H, K, K) or None. Returns (o (B, T, H,
    K) in r's dtype, final_state (B, H, K, K) fp32)::

        o_t = r_t . (S_{t-1} + u * k_t v_t^T);  S_t = w_t * S_{t-1} + k_t v_t^T
    """
    B, T, H, K = r.shape
    S = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device) \
        if init_state is None else init_state.float()
    uf = u.float()[None, :, :, None]
    outs = []
    for t in range(T):
        rt, kt, vt, wt = (x[:, t].float() for x in (r, k, v, w))
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, S + uf * kv))
        S = wt[..., None] * S + kv
    o = torch.stack(outs, 1) if outs else r.float()
    return o.to(r.dtype), S


def _chunked(x, L: int):
    """(B, T, H, K) -> (B, T // L, L, H, K) fp32."""
    B, T, H, K = x.shape
    return x.float().reshape(B, T // L, L, H, K)


def _chunk_len(T: int, chunk: int) -> int:
    L = min(chunk, T)
    if L <= 0 or T % L:
        raise ValueError(f"T={T} is not a multiple of the chunk {L}")
    return L


def _cumulative(lwc):
    """Per chunk and channel: the inclusive and exclusive cumulative
    log-decay over the chunk's tokens and the chunk's total."""
    cum = lwc.cumsum(2)                                   # (B,nc,L,H,K)
    return cum, cum - lwc, cum[:, :, -1:]


def wkv_chunk_pass(r, k, v, logw, u, *, chunk: int = 64):
    """The chunk pass (the kernel's first launch): what each chunk computes
    without the carried state. r/k/v/logw (B, T, H, K), u (H, K) -> fp32
    (o_intra (B, nc, L, H, K): the strictly-lower scores times v plus the
    diagonal bonus; summaries (B, nc, H, K, K): the chunk's state update
    ``sum_l (k_l exp(total - cum_l)) v_l^T``; r_in (B, nc, L, H, K): r
    decayed from the chunk's start, ``r exp(excl)``; chunk_decay (B, nc,
    H, K): ``exp(total)``), the last three what the carry pass reads."""
    L = _chunk_len(r.shape[1], chunk)
    rc, kc, vc, lwc = (_chunked(x, L) for x in (r, k, v, logw))
    cum, excl, total = _cumulative(lwc)

    # intra-chunk scores (strictly lower triangular) + the diagonal bonus
    c_mid = total * 0.5
    r_f = rc * torch.exp((excl - c_mid).clamp(-CLIP, CLIP))
    k_f = kc * torch.exp((c_mid - cum).clamp(-CLIP, CLIP))
    scores = torch.einsum("bclhk,bcmhk->bchlm", r_f, k_f)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device),
                     diagonal=-1)
    scores = torch.where(tri, scores, torch.zeros_like(scores))
    diag = torch.einsum("bclhk,hk,bclhk->bclh", rc, u.float(), kc)
    o = torch.einsum("bchlm,bcmhv->bclhv", scores, vc) + diag[..., None] * vc

    # chunk summaries, and the decays the carry pass applies
    decay_out = torch.exp((total - cum).clamp(-CLIP, CLIP))
    summaries = torch.einsum("bclhk,bclhv->bchkv", kc * decay_out, vc)
    return o, summaries, rc * torch.exp(excl), torch.exp(total[:, :, 0])


def wkv_carry_pass(o_intra, summaries, r_in, chunk_decay, init_state=None,
                   cols: slice = slice(None)):
    """The carry pass (the kernel's second launch) over the state's columns
    ``cols``, from the chunk pass's outputs: the state carried chunk by
    chunk, ``S' = exp(total) S + U``, and each chunk's queries against the
    state carried into it, added to ``o_intra``. Column x of the state and
    of the output depends on column x of the summaries alone. Returns (o
    (B, nc, L, H, |cols|), final state (B, H, K, |cols|)), fp32."""
    B, nc, H, K, _ = summaries.shape
    width = len(range(K)[cols])
    S = torch.zeros((B, H, K, width), dtype=torch.float32,
                    device=summaries.device) \
        if init_state is None else init_state.float()[..., cols]
    prev = []
    for c in range(nc):
        prev.append(S)
        S = chunk_decay[:, c, ..., None] * S + summaries[:, c, ..., cols]
    prev = torch.stack(prev, 1)                           # (B,nc,H,K,V)

    # queries against the state carried into their chunk
    return o_intra[..., cols] + torch.einsum("bclhk,bchkv->bclhv", r_in,
                                             prev), S


def rwkv6_chunked_ref(r, k, v, logw, u, init_state=None, *,
                      chunk: int = 64):
    """Chunked WKV. r/k/v (B, T, H, K); logw (B, T, H, K) the log decay
    (<= 0); u (H, K); init_state (B, H, K, K) or None; T a multiple of
    ``L = min(chunk, T)``. Returns (o (B, T, H, K) in r's dtype,
    final_state (B, H, K, K) fp32): the chunk pass, then the carry pass
    over every column."""
    o, S = wkv_carry_pass(*wkv_chunk_pass(r, k, v, logw, u, chunk=chunk),
                          init_state)
    return o.reshape(r.shape).to(r.dtype), S
