"""Plain PyTorch RWKV6 WKV: the sequential recurrence (the ground truth, a
port of the JAX package's ``rwkv6_scan_ref``) and the chunked form with the
kernel's exponent clipping (the version a CPU tensor takes and the one
``chip_smoke.py`` holds the CUDA kernel against; the math of the JAX
package's ``_wkv_chunked`` and Pallas ``rwkv6_scan_kernel``, with the
inter-chunk state carried by a Python loop over chunks)."""
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


def rwkv6_chunked_ref(r, k, v, logw, u, init_state=None, *,
                      chunk: int = 64):
    """Chunked WKV. r/k/v (B, T, H, K); logw (B, T, H, K) the log decay
    (<= 0); u (H, K); init_state (B, H, K, K) or None; T a multiple of
    ``L = min(chunk, T)``. Returns (o (B, T, H, K) in r's dtype,
    final_state (B, H, K, K) fp32)."""
    B, T, H, K = r.shape
    L = min(chunk, T)
    if L == 0 or T % L:
        raise ValueError(f"T={T} is not a multiple of the chunk {L}")
    nc = T // L
    rc, kc, vc, lwc = (x.float().reshape(B, nc, L, H, K)
                       for x in (r, k, v, logw))
    cum = lwc.cumsum(2)                                   # (B,nc,L,H,K)
    excl = cum - lwc
    total = cum[:, :, -1:]                                # (B,nc,1,H,K)

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

    # chunk summaries, then the carried state chunk by chunk
    decay_out = torch.exp((total - cum).clamp(-CLIP, CLIP))
    states = torch.einsum("bclhk,bclhv->bchkv", kc * decay_out, vc)
    chunk_decay = torch.exp(total[:, :, 0])               # (B,nc,H,K)
    S = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device) \
        if init_state is None else init_state.float()
    prev = []
    for c in range(nc):
        prev.append(S)
        S = chunk_decay[:, c, ..., None] * S + states[:, c]
    prev = torch.stack(prev, 1)                           # (B,nc,H,K,V)

    # queries against the state carried into their chunk
    r_in = rc * torch.exp(excl)
    o = o + torch.einsum("bclhk,bchkv->bclhv", r_in, prev)
    return o.reshape(B, T, H, K).to(r.dtype), S
