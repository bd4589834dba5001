"""Plain PyTorch versions of the attention kernels and RMSNorm (and its split
mode, for rows whose columns lie on several ranks).

Port of ``repro.kernels.ref``: dense O(S^2) formulations in float32, with the
same finite ``NEG_INF`` mask value. They are the CPU path of ``kernels.ops``
and the versions each CUDA kernel is held against on the card, by
``max_row_rel_err`` within ``ROW_REL_TOL``.
"""
from __future__ import annotations

import torch

NEG_INF = -2.3819763e38

# On-card limit of a kernel against its plain version, per query row: the
# error's norm over the plain row's norm. An element-wise limit would not do:
# a row that averages n keys has elements of about sqrt(e / n), 0.025 at 4k
# keys, so an atol of 2e-2 is the size of the output itself. Both sides round
# to the working type at the end, so bf16 rows differ by a few 1-ulp flips
# (up to 2.5e-3 on an H100); the planted faults chip_smoke.py reads at
# gemma2-2b's shapes (window ignored, last 128 keys dropped, cap ignored)
# read 0.2 and more, and must stay above the limit.
ROW_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-5}


def max_row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max over rows of the last axis of ||got - want|| / ||want||, in fp32."""
    g = got.float().reshape(-1, got.shape[-1])
    w = want.float().reshape(-1, want.shape[-1])
    num = torch.linalg.vector_norm(g - w, dim=-1)
    den = torch.linalg.vector_norm(w, dim=-1).clamp_min(torch.finfo(torch.float32).tiny)
    return (num / den).max().item()


def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window) -> torch.Tensor:
    """(Q, K) bool mask. ``window`` 0/None = full causal."""
    mask = k_pos[None, :] <= q_pos[:, None]
    if window and window > 0:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def flash_attention(q, k, v, *, window=None, logit_cap: float = 0.0, scale: float,
                    q_offset: int = 0):
    """Causal (optionally sliding-window / soft-capped) GQA attention.

    q: (B,S,H,D); k,v: (B,Sk,Hkv,D) -> (B,S,H,Dv). ``window`` 0/None = full.
    ``q_offset``: the global position of q's first row (a rank's shard of
    the sequence); the mask is taken at positions ``q_offset + i`` against
    the keys' ``0 .. Sk - 1``."""
    b, s, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qg = q.reshape(b, s, hkv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if logit_cap:
        scores = torch.tanh(scores / logit_cap) * logit_cap
    mask = causal_window_mask(q_offset + torch.arange(s, device=q.device),
                              torch.arange(sk, device=q.device), window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, s, h, v.shape[-1]).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos: int, *, window=None,
                     logit_cap: float = 0.0, scale: float):
    """One-token decode. q: (B,1,H,D); caches: (B,S,Hkv,D); ``pos`` is the
    index of the current token: keys at positions > pos are masked."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    group = h // hkv
    qg = q.reshape(b, 1, hkv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_cache.float()) * scale
    if logit_cap:
        scores = torch.tanh(scores / logit_cap) * logit_cap
    k_pos = torch.arange(s, device=q.device)
    m = k_pos <= pos
    if window and window > 0:
        m = m & (k_pos > pos - window)
    scores = torch.where(m, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_cache.float())
    return out.reshape(b, 1, h, v_cache.shape[-1]).to(q.dtype)


# The bf16 decode kernel's split of the key range (csrc/decode_attention.cu:
# TK, SPLITS_PER_SM, plan_nsplit): whole 64-key tiles, about SPLITS_PER_SM CTAs
# an SM over all (batch, kv head) pairs.
DECODE_TILE = 64
DECODE_SPLITS_PER_SM = 2


def split_ranges(lo: int, pos: int, nsplit: int):
    """Inclusive key ranges of ``nsplit`` runs of whole 64-key tiles over
    [lo, pos], as the kernel cuts them: split i takes tiles [i n / nsplit,
    (i + 1) n / nsplit) of the n tiles that meet the range; the first and last
    range are cut at lo and pos. ``nsplit`` is clamped to [1, n]."""
    t_begin = lo // DECODE_TILE
    n = pos // DECODE_TILE - t_begin + 1
    nsplit = max(1, min(n, nsplit))
    out = []
    for i in range(nsplit):
        t0, t1 = t_begin + i * n // nsplit, t_begin + (i + 1) * n // nsplit
        out.append((max(lo, t0 * DECODE_TILE), min(pos, t1 * DECODE_TILE - 1)))
    return out


def plan_splits(lo: int, pos: int, n_sm: int, batch: int, n_kv_heads: int):
    """The kernel's key ranges for one (batch, kv head) on a card of ``n_sm``
    SMs: nsplit = min(tiles, ceil(DECODE_SPLITS_PER_SM * n_sm / (B * Hkv)))."""
    pairs = batch * n_kv_heads
    return split_ranges(lo, pos, -(-DECODE_SPLITS_PER_SM * n_sm // pairs))


def decode_attention_split(q, k_cache, v_cache, pos: int, *, window=None,
                           logit_cap: float = 0.0, scale: float, ranges):
    """``decode_attention`` as the split kernel computes it: each inclusive key
    range of ``ranges`` gives a partial (max, sum, unnormalised output) of
    its keys with the window and causal mask applied, and the partials are
    merged in order. A range may hold only masked keys (its partial is then
    wiped by the merge), but the ranges together must hold a valid key."""
    b, _, h, d = q.shape
    hkv = k_cache.shape[2]
    group = h // hkv
    qg = q.reshape(b, hkv, group, d).float()
    lo = max(0, pos - window + 1) if window and window > 0 else 0
    parts = []
    for k0, k1 in ranges:
        ks, vs = k_cache[:, k0:k1 + 1].float(), v_cache[:, k0:k1 + 1].float()
        s = torch.einsum("bhgd,bkhd->bhgk", qg, ks) * scale
        if logit_cap:
            s = torch.tanh(s / logit_cap) * logit_cap
        keys = torch.arange(k0, k1 + 1, device=q.device)
        s = torch.where((keys >= lo) & (keys <= pos), s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((m, p.sum(dim=-1, keepdim=True), torch.einsum("bhgk,bkhd->bhgd", p, vs)))
    m_all = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:
        f = torch.exp(m - m_all)
        num, den = num + acc * f, den + l * f
    return (num / den).reshape(b, 1, h, d).to(q.dtype)


def decode_attention_shard(q, k_cache, v_cache, pos: int, *, k0: int = 0, window=None,
                           logit_cap: float = 0.0, scale: float):
    """One shard of ``decode_attention``'s keys, as a rank of a cache cut over
    its sequence holds them: the caches (B,S,Hkv,D) are the keys at global
    positions k0 .. k0 + S - 1, masked by those positions (valid: lo <= k0 + j
    <= pos, lo the window's first key), and ``pos`` may lie past the shard.
    Returns (out (B,1,H,Dv), normalised over the shard's valid keys; lse
    (B,H), the log-sum-exp of their scores), both float32, so that the
    merged output is rounded once: one split of ``decode_attention_split``'s
    partials, normalised. A shard with no valid
    key gives out 0 and lse ``NEG_INF``. ``merge_shards`` merges them."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    group = h // hkv
    lo = max(0, pos - window + 1) if window and window > 0 else 0
    if max(lo, k0) > min(pos, k0 + s - 1):
        return (torch.zeros(b, 1, h, dv, dtype=torch.float32, device=q.device),
                torch.full((b, h), NEG_INF, dtype=torch.float32, device=q.device))
    qg = q.reshape(b, hkv, group, d).float()
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) * scale
    if logit_cap:
        sc = torch.tanh(sc / logit_cap) * logit_cap
    keys = k0 + torch.arange(s, device=q.device)
    sc = torch.where((keys >= lo) & (keys <= pos), sc, NEG_INF)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float()) / l
    return out.reshape(b, 1, h, dv), (m + torch.log(l)).reshape(b, h)


def merge_shards(outs, lses):
    """The whole cache's decode output from its shards' (out (B,1,H,Dv),
    lse (B,H)): each shard's output weighted by exp(lse - max lse), summed,
    over the weights' sum, in float32 and in the order given; returns
    float32 (the caller rounds once). A shard with no valid key (lse
    ``NEG_INF``, out 0) weighs 0."""
    m = torch.stack([l.float() for l in lses]).amax(dim=0)
    num = torch.zeros(outs[0].shape, dtype=torch.float32, device=outs[0].device)
    den = torch.zeros_like(m)
    for o, l in zip(outs, lses):
        w = torch.exp(l.float() - m)
        num = num + o.float() * w[:, None, :, None]
        den = den + w
    return num / den[:, None, :, None]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm, ``(1 + scale)``, computed in float32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_sumsq(x: torch.Tensor) -> torch.Tensor:
    """The split mode's first half: each row's float32 sum of squares over
    the columns ``x`` holds, (...,) float32."""
    return x.float().square().sum(dim=-1)


def rmsnorm_scale(x: torch.Tensor, sumsq: torch.Tensor, scale: torch.Tensor, width: int,
                  eps: float = 1e-6) -> torch.Tensor:
    """The split mode's second half: ``x``'s columns scaled by
    rsqrt(sumsq / width + eps) * (1 + scale), ``sumsq`` (...,) the rows' sums
    of squares over all ``width`` columns (every shard's), in x's dtype."""
    r = torch.rsqrt(sumsq.float()[..., None] / width + eps)
    return (x.float() * r * (1.0 + scale.float())).to(x.dtype)


def rmsnorm_split(shards, scales, eps: float = 1e-6):
    """``rmsnorm`` of rows cut into column ``shards`` (scales the shards'
    scales), as the split mode computes it: the shards' sums of squares
    added, then each shard scaled. Returns the shards' outputs."""
    total = sum(rmsnorm_sumsq(x) for x in shards)
    width = sum(x.shape[-1] for x in shards)
    return [rmsnorm_scale(x, total, s, width, eps) for x, s in zip(shards, scales)]


RMSNORM_SPLIT_FAULT = "a shard normalised by its own columns only"


def rmsnorm_split_fault(shards, scales, eps: float = 1e-6):
    """The plain version of a split mode that skips the sum over shards:
    each shard normalised by its own columns (``RMSNORM_SPLIT_FAULT``)."""
    return [rmsnorm_scale(x, rmsnorm_sumsq(x), s, x.shape[-1], eps)
            for x, s in zip(shards, scales)]


RMSNORM_FAULTS = {
    "scale": "scale applied instead of 1 + scale",
    "layernorm": "row mean subtracted (a layer norm)",
    "tail4": "last 4 features left out of the mean",
}


def rmsnorm_fault(x: torch.Tensor, scale: torch.Tensor, eps: float, fault: str) -> torch.Tensor:
    """The plain version of a wrongly written RMSNorm kernel (``fault`` a key
    of ``RMSNORM_FAULTS``), which the parity limit must tell from a sound
    one. The layer-norm fault shows only on rows whose mean is far from 0."""
    xf = x.float()
    gain = 1.0 + scale.float()
    if fault == "scale":
        gain = scale.float()
    elif fault == "layernorm":
        xf = xf - xf.mean(dim=-1, keepdim=True)
    elif fault != "tail4":
        raise ValueError(fault)
    part = xf[..., :-4] if fault == "tail4" else xf
    var = part.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gain).to(x.dtype)
