"""Attention: GQA (full / sliding-window / soft-capped) and MLA with a cache,
and cross attention.

Port of ``repro.models.attention``: ``KVCache``, ``layer_window``,
``chunked_causal_attention``, the GQA block in its ``train``, ``prefill`` and
``decode`` modes with the optional per-head qk norm, DeepSeek-V2's MLA with
its compressed cache (``MLACache``), and llama-3.2-vision's tanh-gated cross
attention to the image embeddings (``CrossAttention``), which runs the plain
attention in every mode, as in the JAX package.

``use_kernel`` means "the hand-written kernel wherever this mode has one":
GQA prefill goes through the flash kernel and decode through the decode
kernel; MLA runs no attention kernel, and its norms go through the RMSNorm
kernel. Training has no attention kernel (the flash kernel is forward only, in both
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


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

class MLACache(NamedTuple):
    c_kv: torch.Tensor    # (B, S_max, kv_lora_rank)
    k_rope: torch.Tensor  # (B, S_max, rope_head_dim)


class MLAttention(nn.Module):
    """The parameters of ``init_mla``: the latent down-projection ``w_dkv``
    and its ``kv_norm``, the shared rotary key ``w_krope``, the up-projections
    ``w_uk`` / ``w_uv``, ``wo``, and the queries through ``w_dq``, ``q_norm``
    and ``w_uq`` (``q_lora_rank`` > 0) or ``w_q``. The cache holds the
    normalised latent and the rotated key, (kv_lora_rank + rope_head_dim) a
    token. Train and prefill run the naive form (per-head K and V from the
    latent, the plain chunked attention, causal); decode the absorbed form
    (``w_uk`` folded into the query, ``w_uv`` after the context, float32
    scores and context), as the JAX package does: MLA has no attention kernel
    in either package. ``use_kernel`` picks the norms' path."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        m = cfg.mla
        d, h = cfg.d_model, cfg.n_heads
        kw = dict(dtype=dtype, device=device)
        self.w_dkv = nn.Parameter(torch.empty(d, m.kv_lora_rank, **kw))
        self.w_krope = nn.Parameter(torch.empty(d, m.rope_head_dim, **kw))
        self.w_uk = nn.Parameter(torch.empty(m.kv_lora_rank, h * m.nope_head_dim, **kw))
        self.w_uv = nn.Parameter(torch.empty(m.kv_lora_rank, h * m.v_head_dim, **kw))
        self.wo = nn.Parameter(torch.empty(h * m.v_head_dim, d, **kw))
        self.kv_norm = RMSNorm(m.kv_lora_rank, cfg.norm_eps, dtype, device)
        qd = m.nope_head_dim + m.rope_head_dim
        if m.q_lora_rank:
            self.w_dq = nn.Parameter(torch.empty(d, m.q_lora_rank, **kw))
            self.w_uq = nn.Parameter(torch.empty(m.q_lora_rank, h * qd, **kw))
            self.q_norm = RMSNorm(m.q_lora_rank, cfg.norm_eps, dtype, device)
        else:
            self.w_q = nn.Parameter(torch.empty(d, h * qd, **kw))
        self.scale = qd ** -0.5

    def init_weights(self, generator: torch.Generator) -> None:
        """Every projection (in, out) with std in^-0.5, as ``init_mla``."""
        for w in self.parameters(recurse=False):
            w.copy_(truncated_normal(w.shape, w.shape[0] ** -0.5, w.dtype, w.device, generator))

    def _q(self, x, positions, use_kernel: bool):
        m, h = self.cfg.mla, self.cfg.n_heads
        b, s, _ = x.shape
        if m.q_lora_rank:
            cq = self.q_norm(x @ self.w_dq.to(x.dtype), use_kernel)
            q = cq @ self.w_uq.to(x.dtype)
        else:
            q = x @ self.w_q.to(x.dtype)
        q = q.reshape(b, s, h, m.nope_head_dim + m.rope_head_dim)
        q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
        return q_nope, apply_rope(q_rope, positions, self.cfg.rope_theta)

    def _ckv(self, x, positions, use_kernel: bool):
        c_kv = self.kv_norm(x @ self.w_dkv.to(x.dtype), use_kernel)
        k_rope = (x @ self.w_krope.to(x.dtype))[:, :, None, :]       # one shared head
        return c_kv, apply_rope(k_rope, positions, self.cfg.rope_theta)[:, :, 0]

    def _attend(self, q_nope, q_rope, c_kv, k_rope):
        """Naive MLA: per-head K and V materialised from the latent."""
        m, h = self.cfg.mla, self.cfg.n_heads
        b, sk = c_kv.shape[:2]
        k_nope = (c_kv @ self.w_uk.to(c_kv.dtype)).reshape(b, sk, h, m.nope_head_dim)
        v = (c_kv @ self.w_uv.to(c_kv.dtype)).reshape(b, sk, h, m.v_head_dim)
        k_rope = k_rope[:, :, None, :].expand(b, sk, h, m.rope_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope], dim=-1)
        return chunked_causal_attention(q, k, v, window=None, scale=self.scale)

    def forward_train(self, x, *, use_kernel: bool = True):
        """Full-sequence causal MLA without a cache (JAX ``mla_train``)."""
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        q_nope, q_rope = self._q(x, positions, use_kernel)
        c_kv, k_rope = self._ckv(x, positions, use_kernel)
        out = self._attend(q_nope, q_rope, c_kv, k_rope)
        return out.reshape(b, s, -1) @ self.wo.to(x.dtype)

    def prefill(self, x, cache: MLACache, *, use_kernel: bool = True):
        """``forward_train``'s attention; writes the latent and the rotated key
        into ``cache[:, :S]`` in place."""
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        q_nope, q_rope = self._q(x, positions, use_kernel)
        c_kv, k_rope = self._ckv(x, positions, use_kernel)
        out = self._attend(q_nope, q_rope, c_kv, k_rope)
        cache.c_kv[:, :s] = c_kv.to(cache.c_kv.dtype)
        cache.k_rope[:, :s] = k_rope.to(cache.k_rope.dtype)
        return out.reshape(b, s, -1) @ self.wo.to(x.dtype)

    def decode(self, x, cache: MLACache, pos: int, *, use_kernel: bool = True):
        """One token at host position ``pos`` against the whole cache (masked
        past ``pos``), absorbed: the cache stays (kv_lora + rope) wide."""
        m, h = self.cfg.mla, self.cfg.n_heads
        b = x.shape[0]
        positions = torch.full((b, 1), pos, device=x.device)
        q_nope, q_rope = self._q(x, positions, use_kernel)                # (B, 1, H, *)
        c_kv_t, k_rope_t = self._ckv(x, positions, use_kernel)
        cache.c_kv[:, pos] = c_kv_t[:, 0].to(cache.c_kv.dtype)
        cache.k_rope[:, pos] = k_rope_t[:, 0].to(cache.k_rope.dtype)
        c_kv = cache.c_kv.float()
        w_uk = self.w_uk.to(x.dtype).reshape(m.kv_lora_rank, h, m.nope_head_dim)
        q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, w_uk)
        scores = torch.einsum("bqhl,bkl->bhqk", q_lat.float(), c_kv)
        scores = scores + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), cache.k_rope.float())
        scores = scores * self.scale
        mask = torch.arange(c_kv.shape[1], device=x.device) <= pos
        probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
        ctx = torch.einsum("bhqk,bkl->bqhl", probs, c_kv).to(x.dtype)
        w_uv = self.w_uv.to(x.dtype).reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = torch.einsum("bqhl,lhd->bqhd", ctx, w_uv)
        return out.reshape(b, 1, h * m.v_head_dim) @ self.wo.to(x.dtype)


# ---------------------------------------------------------------------------
# Cross attention (llama-3.2-vision image layers)
# ---------------------------------------------------------------------------

def cross_attention(q, k, v, *, scale: float, q_chunk: int = 1024) -> torch.Tensor:
    """Unmasked attention of every query to every key. q: (B, S, H, D);
    k/v: (B, Sv, H, D), one head each per query head. Float32 scores and
    softmax, the probabilities cast to ``v.dtype`` before PV, as the JAX
    ``_softmax_attend``. The queries go in chunks of ``q_chunk``: at
    llama-3.2-vision's prompt the whole fp32 score tensor would be (2, 32,
    4352, 6404), 7.1 GB, and the probabilities as much again; each row's
    softmax is the same either way. Under autograd each chunk runs under a
    checkpoint, its scores recomputed in the backward pass."""
    s = q.shape[1]
    kf = k.float()
    remat = s > q_chunk and torch.is_grad_enabled()

    def chunk(qc, kf, v):
        scores = torch.einsum("bqhd,bkhd->bhqk", qc.float(), kf) * scale
        probs = torch.softmax(scores, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)

    outs = []
    for start in range(0, s, q_chunk):
        qc = q[:, start:start + q_chunk]
        outs.append(checkpoint(chunk, qc, kf, v, use_reentrant=False) if remat
                    else chunk(qc, kf, v))
    return torch.cat(outs, dim=1)


class CrossAttention(nn.Module):
    """``init_cross_attn``'s parameters: ``wq`` (d, H hd), ``wk``/``wv``
    (vision_d_model, Hkv hd), ``wo`` (H hd, d) and the scalar ``gate``, which
    starts at zero (the block is then the identity). K and V are repeated
    from the kv heads to every query head; no RoPE, no mask, scale hd^-0.5;
    the output is scaled by tanh(gate), the gate rounded to the activations'
    dtype first, as the JAX package does."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        dv = cfg.vision_d_model or d
        kw = dict(dtype=dtype, device=device)
        self.wq = nn.Parameter(torch.empty(d, h * hd, **kw))
        self.wk = nn.Parameter(torch.empty(dv, hkv * hd, **kw))
        self.wv = nn.Parameter(torch.empty(dv, hkv * hd, **kw))
        self.wo = nn.Parameter(torch.empty(h * hd, d, **kw))
        self.gate = nn.Parameter(torch.zeros((), **kw))

    def init_weights(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.copy_(truncated_normal(w.shape, w.shape[0] ** -0.5, w.dtype, w.device, generator))
        self.gate.zero_()

    def forward(self, x, vision_embed):
        """x: (B, S, d); vision_embed: (B, Sv, vision_d_model)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        sv = vision_embed.shape[1]
        ve = vision_embed.to(x.dtype)
        q = (x @ self.wq.to(x.dtype)).reshape(b, s, h, hd)
        k = (ve @ self.wk.to(x.dtype)).reshape(b, sv, hkv, hd).repeat_interleave(h // hkv, 2)
        v = (ve @ self.wv.to(x.dtype)).reshape(b, sv, hkv, hd).repeat_interleave(h // hkv, 2)
        out = cross_attention(q, k, v, scale=hd ** -0.5)
        out = out.reshape(b, s, h * hd) @ self.wo.to(x.dtype)
        return torch.tanh(self.gate.to(x.dtype)) * out
