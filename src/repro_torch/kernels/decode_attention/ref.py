"""Plain PyTorch paged decode attention: the version a CPU tensor takes and
the one ``chip_smoke.py`` holds the CUDA kernel against."""
from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38
# Tokens a split of the CUDA kernel (kSplitTokens in
# csrc/decode_attention.cu), rounded to whole pages.
SPLIT_TOKENS = 128


def split_pages(page: int) -> int:
    """Pages a split: a function of ``page`` alone, so a row's splits never
    depend on the batch, the table width or the other rows."""
    return max(1, SPLIT_TOKENS // page)


def split_plan(length: int, page: int) -> list[tuple[int, int]]:
    """The CUDA kernel's splits of a row of ``length`` live tokens: token
    ranges ``[start, end)`` of ``split_pages(page)`` whole pages, the last
    one cut at ``length``; none for an empty row."""
    step = split_pages(page) * page
    return [(s, min(s + step, length)) for s in range(0, max(0, length), step)]


def sanitize_block_tables(block_tables: torch.Tensor, seq_lens,
                          page: int) -> torch.Tensor:
    """Rewrite dead (b, ip) table slots (``ip * page >= seq_lens[b]``) to
    the valid sentinel page 0; live slots pass through untouched and must
    already be valid physical page ids (the caller contract). The CUDA
    kernel never reads a dead slot; this is the same contract made
    explicit for gathers that index every slot."""
    lens = torch.as_tensor(seq_lens, dtype=torch.int32,
                           device=block_tables.device)
    ip = torch.arange(block_tables.shape[1], dtype=torch.int32,
                      device=block_tables.device)
    live = ip[None, :] * page < lens[:, None]
    return torch.where(live, block_tables,
                       torch.zeros_like(block_tables)).to(torch.int32)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, seq_lens,
                               *, layer: int | None = None,
                               scale: float | None = None,
                               return_residuals: bool = False):
    """Same shapes and contract as the CUDA kernel: q (B, H, D); pools
    (P, page, KV, D) or (L, P, page, KV, D) with ``layer``; block_tables
    (B, n_tab); seq_lens (B,). Each row attends over exactly its own live
    tokens (dead slots are never gathered), so a row's result does not
    depend on the batch or the table width."""
    if k_pages.dim() == 5:
        li = 0 if layer is None else int(layer)
        k_pages, v_pages = k_pages[li], v_pages[li]
    B, H, D = q.shape
    _, page, KV, _ = k_pages.shape
    G = H // KV
    n_tab = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    tables = sanitize_block_tables(block_tables, seq_lens, page).long()
    lens = torch.as_tensor(seq_lens).tolist()
    acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, KV, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=q.device)
    for b, n in enumerate(lens):
        n = min(int(n), n_tab * page)
        if n <= 0:
            continue
        ids = tables[b, :math.ceil(n / page)]
        k = k_pages[ids].reshape(-1, KV, D)[:n].float()       # (T, KV, D)
        v = v_pages[ids].reshape(-1, KV, D)[:n].float()
        qg = q[b].reshape(KV, G, D).float()
        s = torch.einsum("kgd,tkd->kgt", qg, k) * scale
        m[b] = s.amax(-1)
        p = torch.exp(s - m[b][..., None])
        l[b] = p.sum(-1)
        acc[b] = torch.einsum("kgt,tkd->kgd", p, v)
    if return_residuals:
        return acc, m, l
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def merge_new_token_ref(q, k_new, v_new, acc, m, l, scale: float):
    """The decode step's exact merge of the new token's own ``(k_new,
    v_new)`` (B, KV, D), which no page holds yet, into the residuals
    ``(acc, m, l)`` of ``q`` (B, H, D) over the pages: the token is one
    more split with m = q . k_new * scale, l = 1, acc = v_new. Returns the
    normalized output (B, H, D) in q's dtype. The reference's jnp merge
    (``src/repro/serving/paged_runtime.py:411-421``), op for op; the
    CUDA combine runs it when given ``new_kv``."""
    B, H, D = q.shape
    KV = k_new.shape[1]
    qg = q.reshape(B, KV, H // KV, D).float()
    kf, vf = k_new.float(), v_new.float()
    s_self = (qg * kf[:, :, None, :]).sum(-1) * scale
    m2 = torch.maximum(m, s_self)
    alpha = torch.exp(m - m2)
    p_self = torch.exp(s_self - m2)
    acc2 = acc * alpha[..., None] + p_self[..., None] * vf[:, :, None]
    l2 = l * alpha + p_self
    o = (acc2 / l2.clamp_min(1e-30)[..., None]).reshape(B, H, D)
    return o.to(q.dtype)


def combine_splits(acc_s, m_s, l_s, bad_s):
    """Merge a row's split partials in split order, as the CUDA combine
    does: acc_s (S, KV, G, D), m_s and l_s (S, KV, G) fp32, bad_s (S,)
    poison flags. m = max m_s, l = sum l_s e^(m_s - m), acc likewise,
    summed split 0, 1, ... in turn. No split gives exactly m = -2e38,
    l = 0, acc = 0; a poisoned split makes every output NaN (a flag, not
    m: ``max`` would drop a NaN)."""
    m = torch.full(m_s.shape[1:], NEG_INF, dtype=torch.float32)
    for ms in m_s:
        m = torch.maximum(m, ms)
    acc = torch.zeros(acc_s.shape[1:], dtype=torch.float32)
    l = torch.zeros(m_s.shape[1:], dtype=torch.float32)
    for a, ms, ls in zip(acc_s, m_s, l_s):
        w = torch.exp(ms - m)
        l = l + ls * w
        acc = acc + a * w[..., None]
    if bool(torch.as_tensor(bad_s).any()):
        acc, m, l = (torch.full_like(x, float("nan")) for x in (acc, m, l))
    return acc, m, l


def paged_decode_split_ref(q, k_pages, v_pages, block_tables, seq_lens, *,
                           layer: int | None = None,
                           scale: float | None = None,
                           return_residuals: bool = False):
    """The CUDA kernel's arithmetic in plain PyTorch, for the tests: each
    row cut by :func:`split_plan`, one fp32 online-softmax partial a split
    (a live page id outside the pool poisons its split), merged by
    :func:`combine_splits`. Same shapes and results as
    :func:`paged_decode_attention_ref`, up to fp32 summation order."""
    if k_pages.dim() == 5:
        li = 0 if layer is None else int(layer)
        k_pages, v_pages = k_pages[li], v_pages[li]
    B, H, D = q.shape
    P, page, KV, _ = k_pages.shape
    G = H // KV
    n_tab = block_tables.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    tables = torch.as_tensor(block_tables).long()
    acc = torch.empty((B, KV, G, D), dtype=torch.float32)
    m = torch.empty((B, KV, G), dtype=torch.float32)
    l = torch.empty((B, KV, G), dtype=torch.float32)
    for b, n in enumerate(torch.as_tensor(seq_lens).tolist()):
        qg = q[b].reshape(KV, G, D).float()
        splits = split_plan(max(0, min(int(n), n_tab * page)), page)
        acc_s = torch.zeros((len(splits), KV, G, D))
        m_s = torch.zeros((len(splits), KV, G))
        l_s = torch.zeros((len(splits), KV, G))
        bad = torch.zeros(len(splits), dtype=torch.bool)
        for i, (t0, t1) in enumerate(splits):      # t0: a page boundary
            ids = tables[b, t0 // page:-(-t1 // page)]
            if bool(((ids < 0) | (ids >= P)).any()):
                bad[i] = True
                continue
            k = k_pages[ids].reshape(-1, KV, D)[:t1 - t0].float()
            v = v_pages[ids].reshape(-1, KV, D)[:t1 - t0].float()
            s = torch.einsum("kgd,tkd->kgt", qg, k) * scale
            m_s[i] = s.amax(-1)
            p = torch.exp(s - m_s[i][..., None])
            l_s[i] = p.sum(-1)
            acc_s[i] = torch.einsum("kgt,tkd->kgd", p, v)
        acc[b], m[b], l[b] = combine_splits(acc_s, m_s, l_s, bad)
    if return_residuals:
        return acc, m, l
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)


def dense_decode_ref(q, cache_k, cache_v, offsets, *, scale: float,
                     softcap: float = 0.0, window: int = 0):
    """The dense launch's plain version: the reference's ``attend_decode``
    at C == 1 (``src/repro/models/attention.py:272``: its masks, then
    ``_block_attn`` and the normalisation), op for op as the port's
    ``attention.decode_stats`` spells it, so the two agree bit for bit.
    q (B, H, D) one token a row at the positions ``offsets`` (B,) (or a
    scalar), the caches (B, T, KV, D) holding it already; ``window`` the
    sliding window (the cache a ring when T == window). Returns (B, H, D)
    in q's dtype. The scores are fp32 (float64 for float64 inputs: the
    exact arithmetic phase 2 of ``chip_smoke.py`` holds the launch to).

    At one query the window mask keeps every slot the length mask keeps:
    a full ring's T = window slots hold positions total - window ..
    total - 1, each > q - window for the query q = total - 1, and a plain
    cache shorter than the window holds positions 0 .. T - 1 > q -
    window. So the CUDA launch reads the first min(offset + 1, T) slots
    and applies no window."""
    B, H, D = q.shape
    T, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    if isinstance(offsets, int):
        kv_len = torch.full((B,), offsets, dtype=torch.int32,
                            device=q.device)
    else:
        kv_len = torch.as_tensor(offsets, dtype=torch.int32,
                                 device=q.device).reshape(-1).expand(B)
    slot = torch.arange(T, device=q.device)[None, :]           # (1, T)
    total = kv_len + 1
    q_pos = kv_len[:, None, None] + torch.arange(1, device=q.device)[
        None, :, None]                                          # (B, 1, 1)
    if window > 0 and T == window:
        n_wrap = torch.div(total[:, None] - 1 - slot, T,
                           rounding_mode="floor")
        pos = slot + n_wrap.clamp_min(0) * T                    # (B, T)
        valid = (pos < total[:, None]) & \
            (pos >= (total - window).clamp_min(0)[:, None])
        mask = valid[:, None, :] & (pos[:, None, :] <= q_pos) & \
            (pos[:, None, :] > q_pos - window)
    else:
        mask = (slot[:, None, :] <= q_pos) & \
            (slot[:, None, :] < total[:, None, None])           # (B, 1, T)
        if window > 0:
            mask = mask & (slot[:, None, :] > q_pos - window)
    k, v = cache_k, cache_v
    if k.dtype != q.dtype:
        k, v = k.to(q.dtype), v.to(q.dtype)
    qg = q[:, None].reshape(B, 1, KV, G, D)
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k).to(
        torch.promote_types(q.dtype, torch.float32)) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)                                              # (B,KV,G,1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bkgqt,btkd->bqkgd", p.to(v.dtype), v).reshape(
        B, 1, H, D)
    l = l.permute(0, 3, 1, 2).reshape(B, 1, H)[..., None]
    return (o / l.clamp_min(1e-30).to(o.dtype))[:, 0]


def _warp_partial(qg, k, v, idx, scale: float, softcap: float):
    """One consumer warp's partial over the tokens ``idx`` of a row: fp32
    scores of q (KV, G, D) against k (T, KV, D), scaled, softcapped as
    the kernel spells it (tanh(s / cap) * cap), m, l and acc; P enters P V
    as bf16 hi + lo parts over a bf16 V. No token: m = -2e38, l = acc = 0."""
    KV, G, D = qg.shape
    if not idx:
        return (torch.zeros((KV, G, D)), torch.full((KV, G), NEG_INF),
                torch.zeros((KV, G)))
    ids = torch.tensor(idx)
    s = torch.einsum("kgd,tkd->kgt", qg, k[ids].float()) * scale
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    vv = v[ids]
    if vv.dtype == torch.bfloat16:
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        acc = torch.einsum("kgt,tkd->kgd", hi, vv.float()) + \
            torch.einsum("kgt,tkd->kgd", lo, vv.float())
    else:
        acc = torch.einsum("kgt,tkd->kgd", p, vv.float())
    return acc, m, p.sum(-1)


def dense_split_partials(q, cache_k, cache_v, offsets, *, scale: float,
                         softcap: float = 0.0, plan=None) -> list:
    """The dense kernel's splits in plain PyTorch: for each row, each
    rank's partial ``(acc (KV, G, D), m (KV, G), l (KV, G))`` in fp32,
    rank 0 first. Rank r takes tokens [r split, (r + 1) split) of the
    row's min(offset + 1, T) live slots; its consumer warps of a head
    take the split's 16-token stages in turn (stage i to warp i mod
    warps a head), each an fp32 softmax partial (:func:`_warp_partial`),
    merged in warp order (:func:`combine_splits`). ``plan`` a
    ``DenseSplitPlan`` (``kernel.dense_geometry`` at the caches' shapes
    by default). Returns a list over rows of (acc_s, m_s, l_s) stacked
    over the ranks."""
    from repro_torch.kernels.decode_attention.kernel import (
        DENSE_STAGE_TOKENS, dense_geometry, dense_split_ranges)
    B, H, D = q.shape
    T, KV = cache_k.shape[1], cache_k.shape[2]
    G = H // KV
    plan = plan or dense_geometry(T, KV, G, D)
    wph = plan.warps_per_head
    offs = [int(offsets)] * B if isinstance(offsets, int) else \
        torch.as_tensor(offsets).reshape(-1).expand(B).tolist()
    rows = []
    for b in range(B):
        qg = q[b].reshape(KV, G, D).float()
        length = max(0, min(int(offs[b]) + 1, T))
        ranks = []
        for t0, t1 in dense_split_ranges(T, plan, length):
            stages = list(range(t0, t1, DENSE_STAGE_TOKENS))
            warps = [_warp_partial(
                qg, cache_k[b], cache_v[b],
                [t for s in stages[j::wph]
                 for t in range(s, min(s + DENSE_STAGE_TOKENS, t1))],
                scale, softcap) for j in range(wph)]
            ranks.append(combine_splits(*(torch.stack(x) for x in
                                          zip(*warps)),
                                        torch.zeros(wph, dtype=torch.bool)))
        rows.append(tuple(torch.stack(x) for x in zip(*ranks)))
    return rows


def dense_split_ref(q, cache_k, cache_v, offsets, *, scale: float,
                    softcap: float = 0.0, window: int = 0, plan=None):
    """The plain version of the dense kernel's schedule: the ranks'
    partials (:func:`dense_split_partials`) merged in rank order
    (:func:`combine_splits`), then acc / max(l, 1e-30) in q's dtype. Same
    shapes and contract as :func:`dense_decode_ref` with no window mask
    to apply (``window`` 0 or at least T, as the launch requires); its
    results agree with it up to fp32 summation order and, for bf16 V, P's
    hi + lo split."""
    B, H, D = q.shape
    T, KV = cache_k.shape[1], cache_k.shape[2]
    if window > 0 and T > window:
        raise ValueError(f"a {T}-slot cache under a {window}-token window "
                         f"needs the window mask")
    out = torch.empty((B, KV, H // KV, D))
    for b, (acc_s, m_s, l_s) in enumerate(dense_split_partials(
            q, cache_k, cache_v, offsets, scale=scale, softcap=softcap,
            plan=plan)):
        acc, _, l = combine_splits(acc_s, m_s, l_s,
                                   torch.zeros(len(m_s), dtype=torch.bool))
        out[b] = acc / l.clamp_min(1e-30)[..., None]
    return out.reshape(B, H, D).to(q.dtype)
