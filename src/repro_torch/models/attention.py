"""GQA self attention (full / sliding-window / soft-capped) with a KV cache.

Port of the GQA part of ``repro.models.attention``: ``KVCache``,
``layer_window``, ``chunked_causal_attention`` and the GQA block in its
``train``, ``prefill`` and ``decode`` modes, with the optional per-head qk
norm. MLA and cross attention are not ported yet.

``use_kernel`` means "the hand-written kernel wherever this mode has one":
prefill goes through the flash kernel and decode through the decode kernel.
Training has no attention kernel (the flash kernel is forward only, in both
packages), so train mode always runs the plain ``chunked_causal_attention``,
as the JAX Trainer does.

The KV cache is updated in place (``cache.k[:, pos] = k``, a slice write at
prefill); the JAX package builds new arrays with ``dynamic_update_slice``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import NEG_INF, causal_window_mask
from repro_torch.models.layers import RMSNorm, apply_rope, softcap, truncated_normal


# ---------------------------------------------------------------------------
# The plain chunked attention
# ---------------------------------------------------------------------------

def _softmax_attend(q, k, v, mask, logit_cap: float, scale: float):
    """q:(B,Q,H,D) k:(B,K,Hkv,D) v:(B,K,Hkv,Dv) mask:(Q,K) -> (B,Q,H,Dv)."""
    b, qlen, h, d = q.shape
    hkv = k.shape[2]
    q = q.reshape(b, qlen, hkv, h // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    scores = softcap(scores, logit_cap)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, qlen, h, v.shape[-1])


def chunked_causal_attention(q, k, v, *, window=0, logit_cap: float = 0.0,
                             scale: float, q_chunk: int = 1024,
                             q_offset: int = 0) -> torch.Tensor:
    """Query-chunked attention; memory O(q_chunk * S) instead of O(S^2).

    q: (B, S, H, D); k/v: (B, Sk, Hkv, D*). ``q_offset`` is the absolute
    position of q[0]. Like the JAX version, it casts the probabilities to
    ``v.dtype`` before the PV product. When there is more than one chunk and
    autograd records, each chunk runs under a checkpoint, as the JAX scan
    body does: its (B, H, q_chunk, Sk) scores are recomputed in the backward
    pass instead of being kept."""
    s, sk = q.shape[1], k.shape[1]
    k_pos = torch.arange(sk, device=q.device)
    remat = s > q_chunk and torch.is_grad_enabled()

    def chunk(qc, k, v, start: int):
        q_pos = q_offset + start + torch.arange(qc.shape[1], device=qc.device)
        return _softmax_attend(qc, k, v, causal_window_mask(q_pos, k_pos, window),
                               logit_cap, scale)

    outs = []
    for start in range(0, s, q_chunk):
        qc = q[:, start:start + q_chunk]
        outs.append(checkpoint(chunk, qc, k, v, start, use_reentrant=False) if remat
                    else chunk(qc, k, v, start))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, Hkv, D)
    v: torch.Tensor  # (B, S_max, Hkv, Dv)


def layer_window(cfg: ModelConfig, layer_idx: int) -> int:
    """Per-layer sliding window (gemma2 alternates local / global); 0 = full."""
    if cfg.local_global_alternating:
        return cfg.sliding_window if layer_idx % 2 == 0 else 0
    return cfg.sliding_window


class GQAttention(nn.Module):
    """Weights in the JAX package's ``(in, out)`` orientation. With
    ``qk_norm``, q and k go through an RMSNorm over ``head_dim`` each
    (``q_norm``, ``k_norm``) after the projections and before RoPE."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = nn.Parameter(torch.empty(d, h * hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, hkv * hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, hkv * hd, **kw))
        self.wo = nn.Parameter(torch.empty(h * hd, d, **kw))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.norm_eps, dtype, device)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, dtype, device)

    def init_weights(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.copy_(truncated_normal(w.shape, w.shape[0] ** -0.5, w.dtype, w.device, generator))

    def _qkv(self, x, positions, use_kernel: bool):
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q = (x @ self.wq.to(x.dtype)).reshape(b, s, h, hd)
        k = (x @ self.wk.to(x.dtype)).reshape(b, s, hkv, hd)
        v = (x @ self.wv.to(x.dtype)).reshape(b, s, hkv, hd)
        if cfg.qk_norm:
            q = self.q_norm(q, use_kernel)
            k = self.k_norm(k, use_kernel)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v

    def forward_train(self, x, *, window: int, use_kernel: bool = True):
        """Full-sequence causal attention without a cache (JAX ``gqa_train``),
        through the plain chunked attention; ``use_kernel`` picks the qk
        norms' path. (``train`` is taken by ``nn.Module``.)"""
        b, s, _ = x.shape
        q, k, v = self._qkv(x, torch.arange(s, device=x.device)[None, :], use_kernel)
        out = chunked_causal_attention(q, k, v, window=window,
                                       logit_cap=self.cfg.attn_logit_softcap,
                                       scale=self.cfg.resolved_head_dim ** -0.5)
        return out.reshape(b, s, -1) @ self.wo.to(x.dtype)

    def prefill(self, x, cache: KVCache, *, window: int, use_kernel: bool = True):
        """Attend causally and write k/v into ``cache[:, :S]`` in place."""
        b, s, _ = x.shape
        q, k, v = self._qkv(x, torch.arange(s, device=x.device)[None, :], use_kernel)
        out = kops.flash_attention(
            q, k, v, window=window, logit_cap=self.cfg.attn_logit_softcap,
            scale=self.cfg.resolved_head_dim ** -0.5, use_kernel=use_kernel)
        cache.k[:, :s] = k.to(cache.k.dtype)
        cache.v[:, :s] = v.to(cache.v.dtype)
        return out.reshape(b, s, -1) @ self.wo.to(x.dtype)

    def decode(self, x, cache: KVCache, pos: int, *, window: int, use_kernel: bool = True):
        """One token at host position ``pos``. x: (B,1,D). Writes k/v into
        ``cache[:, pos]`` in place, then attends to the cache."""
        b = x.shape[0]
        q, k, v = self._qkv(x, torch.full((b, 1), pos, device=x.device), use_kernel)
        cache.k[:, pos] = k[:, 0].to(cache.k.dtype)
        cache.v[:, pos] = v[:, 0].to(cache.v.dtype)
        out = kops.decode_attention(
            q.to(cache.k.dtype), cache.k, cache.v, pos, window=window,
            logit_cap=self.cfg.attn_logit_softcap,
            scale=self.cfg.resolved_head_dim ** -0.5, use_kernel=use_kernel)
        return out.to(x.dtype).reshape(b, 1, -1) @ self.wo.to(x.dtype)
