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

On a mesh (a module's ``tp``, ``parallel.tensor``) every mode computes on
this rank's heads: q heads over ``model``, the kv heads too where they
divide, ``wo`` row-parallel with the outputs all-reduced over ``model``; each
class says what it computes where the heads do not divide. Serving on a mesh
keeps this rank's shard of the cache (``sharding.cache_spec``: the sequence
over ``model``): prefill writes its slice of the whole new keys, and decode
attends over its shard of the sequence, masked by global positions, and
merges the ranks' outputs by their log-sum-exp (``tp.merge_over_model``),
as GSPMD computes the JAX package's serve step under ``cache_specs``.
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
from repro_torch.parallel.tensor import all_gather, local_chunk, write_cache


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


def _same(x):
    return x


def kv_heads(tp, n_heads: int, n_kv: int):
    """The kv heads a rank's block of q heads reads where ``model`` does not
    split the kv heads: (first, stop, an index that gives each local q head
    its kv head among them, or None where they keep ``n_heads / n_kv`` to a
    group)."""
    h_l, group = n_heads // tp.size, n_heads // n_kv
    heads = [(tp.rank * h_l + i) // group for i in range(h_l)]
    k0, k1 = heads[0], heads[-1] + 1
    per = h_l // (k1 - k0)
    if h_l % (k1 - k0) == 0 and all(hh - k0 == i // per for i, hh in enumerate(heads)):
        return k0, k1, None
    return k0, k1, [hh - k0 for hh in heads]


def kv_plan(tp, n_heads: int, n_kv: int, hd: int, wk, wv):
    """The kv weights a rank's block of q heads reads, on a mesh whose
    ``model`` axis splits the q heads: (wk, wv, their heads, an index that
    gives each local q head its kv head, or None where the heads keep
    ``n_heads / n_kv`` to a group). Where ``model`` splits the kv heads too,
    each rank takes its own block; else each gathers the kv weights whole and
    keeps the heads its q heads read (each rank's gradient is then a part,
    summed over ``model``)."""
    if n_kv % tp.size == 0 and tp.split_on((wk, 1), (wv, 1)):
        return tp.gather_batch(wk), tp.gather_batch(wv), n_kv // tp.size, None
    k0, k1, index = kv_heads(tp, n_heads, n_kv)
    wk_l = tp.whole(wk, partial=True)[:, k0 * hd:k1 * hd]
    wv_l = tp.whole(wv, partial=True)[:, k0 * hd:k1 * hd]
    return wk_l, wv_l, k1 - k0, None if index is None else torch.tensor(index, device=wk.device)


class GQAttention(nn.Module):
    """Weights in the JAX package's ``(in, out)`` orientation. With
    ``qk_norm``, q and k go through an RMSNorm over ``head_dim`` each
    (``q_norm``, ``k_norm``) after the projections and before RoPE.

    On a mesh (``tp``), ``forward_train`` splits the heads over ``model``
    where ``n_heads`` divides by its size: each rank projects its q heads
    (and, where ``n_kv_heads`` divides too, its kv heads, else the kv heads
    its q heads read: ``kv_plan``), normalises them with the shared qk-norm
    scales, attends, and multiplies by its rows of ``wo``; the outputs are
    all-reduced over ``model``. Where ``n_heads`` does not divide (the JAX
    package's ``attn_zero_sharding`` "auto" case: at 16, gemma2-2b's 8 heads,
    smollm-135m's 9, musicgen-medium's 24, yi-34b's and arctic-480b's 56), the
    layer gathers its weights whole and every ``model`` rank computes the
    whole attention.

    ``sp_attn`` "batch" is the JAX package's ``attn_activation_sharding``
    "batch" mode (``_sp_shard``: q, k and v constrained to the batch over
    pod x data x model in ``gqa_train`` and ``gqa_prefill``). On a mesh where
    this rank's rows split over ``model`` (``tp.rows_over_model``), each
    ``model`` rank attends its ``1/model`` of the rows over every head, and
    the outputs come back to every ``model`` rank; elsewhere (one device,
    rows that do not divide, decode) the mode changes nothing, as
    ``_maybe_shard`` drops the constraint. Where the heads do not divide,
    the rows are cut before the projections and the output's rows gathered
    after ``wo`` (the whole weights' gradients summed over ``model``); where
    they divide, the projections stay on this rank's heads and all rows, and
    an all-to-all over ``model`` moves q (and k and v where the kv heads
    divide; else they are projected on this rank's rows with the kv weights
    gathered whole) to (this rank's rows, every head) and the attention's
    output back, before ``wo`` row-parallel.

    ``sp_attn`` "sequence" is the mode's other value (``_sp_shard``: q's
    sequence constrained to ``model``, k and v whole over it). On a mesh
    whose ``model`` size divides the sequence (``tp.seq_over_model``), each
    ``model`` rank attends its ``1/model`` of the query positions, from
    global position ``tp.seq_start`` on, against every key, the window and
    the causal mask at global positions, and the outputs come back to every
    ``model`` rank; elsewhere (one device, a sequence that does not divide,
    decode) the mode changes nothing. Where the heads do not divide, q is
    projected from this rank's positions at their global RoPE positions and
    k and v from every position with the weights whole (their gradients, and
    x's through k and v, summed over ``model``), and the output's positions
    gathered after ``wo``; where they divide, q moves from (every position,
    this rank's heads) to (this rank's positions, every head) by an
    all-to-all (``tp.seq_to_heads``), k and v are made on every position and
    every kv head (gathered over ``model`` where it splits them, else from
    the kv weights whole), and the output moves back before ``wo``
    row-parallel. Train attends through the plain chunked attention with
    ``q_offset`` over all keys (masked, not cut to the causal range, as XLA
    counts it); prefill through the flash kernel with ``q_offset``."""

    tp = None

    def __init__(self, cfg: ModelConfig, dtype, device, sp_attn: str = ""):
        super().__init__()
        self.cfg = cfg
        self.sp_attn = sp_attn
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

    def _own(self):
        w = {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}
        if self.cfg.qk_norm:
            w["q_norm"], w["k_norm"] = self.q_norm.scale, self.k_norm.scale
        return w

    def _q(self, x, positions, use_kernel: bool, w, h=None):
        cfg = self.cfg
        b, s, _ = x.shape
        q = (x @ w["wq"].to(x.dtype)).reshape(b, s, cfg.n_heads if h is None else h, -1)
        if cfg.qk_norm:
            q = kops.rmsnorm(q, w["q_norm"], cfg.norm_eps, use_kernel)
        return apply_rope(q, positions, cfg.rope_theta)

    def _kv(self, x, positions, use_kernel: bool, w, hkv=None):
        cfg = self.cfg
        b, s, _ = x.shape
        hkv = cfg.n_kv_heads if hkv is None else hkv
        k = (x @ w["wk"].to(x.dtype)).reshape(b, s, hkv, -1)
        v = (x @ w["wv"].to(x.dtype)).reshape(b, s, hkv, -1)
        if cfg.qk_norm:
            k = kops.rmsnorm(k, w["k_norm"], cfg.norm_eps, use_kernel)
        return apply_rope(k, positions, cfg.rope_theta), v

    def _train(self, x, window: int, use_kernel: bool, w=None, h=None, hkv=None,
               kv_index=None):
        b, s, _ = x.shape
        w = self._own() if w is None else w
        positions = torch.arange(s, device=x.device)[None, :]
        q = self._q(x, positions, use_kernel, w, h)
        k, v = self._kv(x, positions, use_kernel, w, hkv)
        if kv_index is not None:
            k, v = k[:, :, kv_index], v[:, :, kv_index]
        out = chunked_causal_attention(q, k, v, window=window,
                                       logit_cap=self.cfg.attn_logit_softcap,
                                       scale=self.cfg.resolved_head_dim ** -0.5)
        return out.reshape(b, s, -1) @ w["wo"].to(x.dtype)

    def _seq_positions(self, s: int, device):
        """This rank's share of ``s`` positions under the "sequence" mode:
        (its first global position, their RoPE positions (1, s / model))."""
        start = self.tp.seq_start(s)
        return start, start + torch.arange(s // self.tp.size, device=device)[None, :]

    def heads_split(self) -> bool:
        tp = self.tp
        return self.cfg.n_heads % tp.size == 0 and tp.split_on((self.wq, 1), (self.wo, 0))

    def rows_split(self, rows: int) -> bool:
        """The "batch" mode applies to a layer of ``rows`` rows on this mesh."""
        return self.sp_attn == "batch" and self.tp is not None and self.tp.rows_over_model(rows)

    def seq_split(self, s: int) -> bool:
        """The "sequence" mode applies to a layer of ``s`` positions on this
        mesh."""
        return self.sp_attn == "sequence" and self.tp is not None and self.tp.seq_over_model(s)

    def forward_train(self, x, *, window: int, use_kernel: bool = True):
        """Full-sequence causal attention without a cache (JAX ``gqa_train``),
        through the plain chunked attention; ``use_kernel`` picks the qk
        norms' path. (``train`` is taken by ``nn.Module``.)"""
        tp = self.tp
        if tp is None:
            return self._train(x, window, use_kernel)
        rows, seq = self.rows_split(x.shape[0]), self.seq_split(x.shape[1])
        if not self.heads_split():
            # whole weights; under the modes this rank's rows or query
            # positions only, so each weight's gradient is a part, summed
            # over model
            whole = {k: tp.whole(v, partial=rows or seq) for k, v in self._own().items()}
            if rows:
                return tp.gather_model(self._train(tp.split_rows(x), window, use_kernel, whole),
                                       0)
            if seq:
                return tp.gather_model(self._train_seq_whole(x, window, use_kernel, whole), 1)
            return self._train(x, window, use_kernel, whole)
        if rows:
            return self._train_rows(x, window, use_kernel)
        if seq:
            return self._train_seq(x, window, use_kernel)
        cfg = self.cfg
        wk, wv, hkv, kv_index = kv_plan(tp, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                                      self.wk, self.wv)
        w = {"wq": tp.gather_batch(self.wq), "wk": wk, "wv": wv, "wo": tp.gather_batch(self.wo)}
        if cfg.qk_norm:     # shared by every head: each rank's gradient is a part
            w["q_norm"] = tp.copy_in(self.q_norm.scale)
            w["k_norm"] = tp.copy_in(self.k_norm.scale)
        out = self._train(tp.copy_in(x), window, use_kernel, w, cfg.n_heads // tp.size, hkv,
                          kv_index)
        return tp.reduce_out(out)

    def _train_rows(self, x, window: int, use_kernel: bool):
        """``forward_train`` under the "batch" mode where the heads split:
        q projected on this rank's heads and all rows, moved to this rank's
        rows and every head (``tp.rows_to_heads``), k and v likewise where
        ``model`` splits the kv heads, else projected on this rank's rows
        (``tp.split_rows``) with the kv weights whole; the attention's output
        moved back to this rank's heads and all rows, through its rows of
        ``wo``, all-reduced over ``model``."""
        tp, cfg = self.tp, self.cfg
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        heads = cfg.n_heads // tp.size
        xq = tp.copy_in(x)
        w = {"wq": tp.gather_batch(self.wq), "wo": tp.gather_batch(self.wo)}
        if cfg.qk_norm:     # shared by every head: each rank's gradient is a part
            w["q_norm"] = tp.copy_in(self.q_norm.scale)
            w["k_norm"] = tp.copy_in(self.k_norm.scale)
        q = tp.rows_to_heads(self._q(xq, positions, use_kernel, w, heads))
        if cfg.n_kv_heads % tp.size == 0 and tp.split_on((self.wk, 1), (self.wv, 1)):
            w["wk"], w["wv"] = tp.gather_batch(self.wk), tp.gather_batch(self.wv)
            k, v = self._kv(xq, positions, use_kernel, w, cfg.n_kv_heads // tp.size)
            k, v = tp.rows_to_heads(k), tp.rows_to_heads(v)
        else:
            w["wk"], w["wv"] = tp.whole(self.wk, partial=True), tp.whole(self.wv, partial=True)
            k, v = self._kv(tp.split_rows(x), positions, use_kernel, w)
        out = chunked_causal_attention(q, k, v, window=window,
                                       logit_cap=cfg.attn_logit_softcap,
                                       scale=cfg.resolved_head_dim ** -0.5)
        out = tp.heads_to_rows(out).reshape(b, s, -1) @ w["wo"].to(x.dtype)
        return tp.reduce_out(out)

    def _train_seq_whole(self, x, window: int, use_kernel: bool, w):
        """``forward_train`` under the "sequence" mode with the weights whole
        (``w``): q from this rank's positions at their global RoPE
        positions (``tp.split_seq``, whose backward gathers x's gradient),
        k and v from every position (``tp.copy_in``: x's gradient through
        them a part, summed over ``model``); this rank's positions of the
        output, through ``wo``."""
        tp, cfg = self.tp, self.cfg
        b, s, _ = x.shape
        start, qpos = self._seq_positions(s, x.device)
        q = self._q(tp.split_seq(x), qpos, use_kernel, w)
        k, v = self._kv(tp.copy_in(x), torch.arange(s, device=x.device)[None, :], use_kernel, w)
        out = chunked_causal_attention(q, k, v, window=window, logit_cap=cfg.attn_logit_softcap,
                                       scale=cfg.resolved_head_dim ** -0.5, q_offset=start)
        return out.reshape(b, s // tp.size, -1) @ w["wo"].to(x.dtype)

    def _seq_kv(self, x, positions, use_kernel: bool, w, kv_split: bool):
        """k and v of every kv head at every position under the "sequence"
        mode where the q heads split: this rank's kv heads gathered over
        ``model`` where it splits them (each rank's gradient of the whole a
        part, summed onto its heads; contiguous for the flash kernel), else
        made whole from ``w``'s whole kv weights."""
        cfg, tp = self.cfg, self.tp
        if not kv_split:
            return self._kv(x, positions, use_kernel, w)
        k, v = self._kv(x, positions, use_kernel, w, cfg.n_kv_heads // tp.size)
        return tuple(tp.gather_model(t, 2, partial=True).contiguous() for t in (k, v))

    def _train_seq(self, x, window: int, use_kernel: bool):
        """``forward_train`` under the "sequence" mode where the heads split:
        q projected on this rank's heads and every position, moved to this
        rank's positions and every head (``tp.seq_to_heads``); k and v of
        every kv head at every position (``_seq_kv``); the attention of
        those positions at ``q_offset`` over every key, moved back to this
        rank's heads and every position, through its rows of ``wo``,
        all-reduced over ``model``."""
        tp, cfg = self.tp, self.cfg
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        xq = tp.copy_in(x)
        w = {"wq": tp.gather_batch(self.wq), "wo": tp.gather_batch(self.wo)}
        if cfg.qk_norm:     # shared by every head: each rank's gradient is a part
            w["q_norm"] = tp.copy_in(self.q_norm.scale)
            w["k_norm"] = tp.copy_in(self.k_norm.scale)
        kv_split = cfg.n_kv_heads % tp.size == 0 and tp.split_on((self.wk, 1), (self.wv, 1))
        if kv_split:
            w["wk"], w["wv"] = tp.gather_batch(self.wk), tp.gather_batch(self.wv)
        else:
            w["wk"], w["wv"] = tp.whole(self.wk, partial=True), tp.whole(self.wv, partial=True)
        q = tp.seq_to_heads(self._q(xq, positions, use_kernel, w, cfg.n_heads // tp.size))
        k, v = self._seq_kv(xq, positions, use_kernel, w, kv_split)
        out = chunked_causal_attention(q, k, v, window=window, logit_cap=cfg.attn_logit_softcap,
                                       scale=cfg.resolved_head_dim ** -0.5,
                                       q_offset=tp.seq_start(s))
        out = tp.heads_to_seq(out).reshape(b, s, -1) @ w["wo"].to(x.dtype)
        return tp.reduce_out(out)

    def _serve_weights(self):
        """What a serve step of this rank reads: (weights, q heads, kv heads,
        heads split, kv heads split). On one device its own weights. On a
        mesh where ``heads_split``, its q heads' ``wq`` and ``wo`` rows, and
        ``wk``/``wv`` its block of the kv heads where ``model`` splits them,
        else whole (the new keys are then computed whole on every rank, for
        the cache); otherwise everything whole (the layer computes whole on
        every ``model`` rank)."""
        tp, cfg = self.tp, self.cfg
        if tp is None:
            return self._own(), cfg.n_heads, cfg.n_kv_heads, False, False
        if not self.heads_split():
            w = {k: tp.whole(v) for k, v in self._own().items()}
            return w, cfg.n_heads, cfg.n_kv_heads, False, False
        kv_split = cfg.n_kv_heads % tp.size == 0 and tp.split_on((self.wk, 1), (self.wv, 1))
        kv = tp.gather_batch if kv_split else tp.whole
        w = {"wq": tp.gather_batch(self.wq), "wo": tp.gather_batch(self.wo),
             "wk": kv(self.wk), "wv": kv(self.wv)}
        if cfg.qk_norm:
            w["q_norm"], w["k_norm"] = self.q_norm.scale, self.k_norm.scale
        hkv = cfg.n_kv_heads // tp.size if kv_split else cfg.n_kv_heads
        return w, cfg.n_heads // tp.size, hkv, True, kv_split

    def prefill(self, x, cache: KVCache, *, window: int, use_kernel: bool = True):
        """Attend causally and write k/v into ``cache[:, :S]`` in place. On a
        mesh: this rank's q heads through the flash kernel against the kv
        heads they read, and the whole new k/v (gathered over ``model``
        where it splits the kv heads) written into this rank's shard of the
        cache; ``wo`` row-parallel. Where the heads do not split, whole.
        Under the "batch" mode (``rows_split``) the new k/v are made as
        before, for the cache, and the flash kernel runs on this rank's rows
        over every head (``_prefill_rows``)."""
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        kw = dict(window=window, logit_cap=self.cfg.attn_logit_softcap,
                  scale=self.cfg.resolved_head_dim ** -0.5, use_kernel=use_kernel)
        tp = self.tp
        w, h, hkv, split, kv_split = self._serve_weights()
        if self.rows_split(b):
            return self._prefill_rows(x, cache, positions, kw, w, h, hkv, split, kv_split)
        if self.seq_split(s):
            return self._prefill_seq(x, cache, positions, kw, w, h, split, kv_split)
        q = self._q(x, positions, use_kernel, w, h)
        k, v = self._kv(x, positions, use_kernel, w, hkv)
        ka, va = k, v
        if split and not kv_split:        # the kv heads this rank's q heads read
            k0, k1, index = kv_heads(tp, self.cfg.n_heads, self.cfg.n_kv_heads)
            sel = slice(k0, k1) if index is None else torch.tensor(
                [k0 + i for i in index], device=x.device)
            ka, va = k[:, :, sel].contiguous(), v[:, :, sel].contiguous()
        out = kops.flash_attention(q, ka, va, **kw)
        if kv_split:
            k, v = (all_gather(t, tp.model, 2) for t in (k, v))
        write_cache(tp, cache.k, k, 0)
        write_cache(tp, cache.v, v, 0)
        out = out.reshape(b, s, -1) @ w["wo"].to(x.dtype)
        return tp.reduce_out(out) if split else out

    def _prefill_rows(self, x, cache: KVCache, positions, kw, w, h, hkv, split, kv_split):
        """``prefill`` under the "batch" mode: the whole new k/v of every kv
        head (gathered over ``model`` where it splits them) written into this
        rank's cache shard and cut to this rank's rows; q of this rank's
        heads moved to its rows and every head (``rows_to_heads``), or, where
        the heads do not split, projected on its rows alone; the flash kernel
        on those rows; the output moved back and through ``wo`` row-parallel,
        or through the whole ``wo`` and its rows gathered over ``model``."""
        tp, use_kernel = self.tp, kw["use_kernel"]
        b, s, _ = x.shape
        k, v = self._kv(x, positions, use_kernel, w, hkv)
        if kv_split:
            k, v = (all_gather(t, tp.model, 2) for t in (k, v))
        write_cache(tp, cache.k, k, 0)
        write_cache(tp, cache.v, v, 0)
        # this rank's rows, contiguous (a gather over model leaves k and v
        # strided): the flash kernel takes them as they are
        k, v = (local_chunk(t, tp.model, 0).contiguous() for t in (k, v))
        if split:
            q = tp.rows_to_heads(self._q(x, positions, use_kernel, w, h))
            out = tp.heads_to_rows(kops.flash_attention(q, k, v, **kw))
            return tp.reduce_out(out.reshape(b, s, -1) @ w["wo"].to(x.dtype))
        xr = local_chunk(x, tp.model, 0)
        out = kops.flash_attention(self._q(xr, positions, use_kernel, w, h), k, v, **kw)
        out = out.reshape(xr.shape[0], s, -1) @ w["wo"].to(x.dtype)
        return all_gather(out, tp.model, 0)

    def _prefill_seq(self, x, cache: KVCache, positions, kw, w, h, split, kv_split):
        """``prefill`` under the "sequence" mode: the whole new k/v of every
        kv head (``_seq_kv``) written into this rank's cache shard; the flash
        kernel on this rank's query positions at ``q_offset`` against every
        key: q of this rank's heads moved to its positions and every head
        (``seq_to_heads``) and the output moved back and through ``wo``
        row-parallel, or, where the heads do not split, q projected from its
        positions alone at their global RoPE positions and the output's
        positions gathered over ``model`` after the whole ``wo``."""
        tp, use_kernel = self.tp, kw["use_kernel"]
        b, s, _ = x.shape
        k, v = self._seq_kv(x, positions, use_kernel, w, kv_split)
        write_cache(tp, cache.k, k, 0)
        write_cache(tp, cache.v, v, 0)
        start, qpos = self._seq_positions(s, x.device)
        if split:
            q = tp.seq_to_heads(self._q(x, positions, use_kernel, w, h)).contiguous()
            out = tp.heads_to_seq(kops.flash_attention(q, k, v, q_offset=start, **kw))
            return tp.reduce_out(out.reshape(b, s, -1) @ w["wo"].to(x.dtype))
        xs = x[:, start:start + s // tp.size]
        out = kops.flash_attention(self._q(xs, qpos, use_kernel, w, h), k, v, q_offset=start,
                                   **kw)
        out = out.reshape(b, xs.shape[1], -1) @ w["wo"].to(x.dtype)
        return all_gather(out, tp.model, 1)

    def decode(self, x, cache: KVCache, pos: int, *, window: int, use_kernel: bool = True):
        """One token at host position ``pos``. x: (B,1,D). Writes k/v into
        ``cache[:, pos]`` in place, then attends to the cache. On a mesh:
        the new k/v made whole over ``model`` and written by the rank that
        holds ``pos``; q gathered to every head; the decode kernel over this
        rank's shard of the sequence (its global offset and lse) and the
        ranks' outputs merged (``tp.merge_over_model``); this rank's heads
        then through its rows of ``wo``."""
        b = x.shape[0]
        positions = torch.full((b, 1), pos, device=x.device)
        kw = dict(window=window, logit_cap=self.cfg.attn_logit_softcap,
                  scale=self.cfg.resolved_head_dim ** -0.5, use_kernel=use_kernel)
        tp = self.tp
        w, h, hkv, split, kv_split = self._serve_weights()
        q = self._q(x, positions, use_kernel, w, h)
        k, v = self._kv(x, positions, use_kernel, w, hkv)
        if split:
            q = all_gather(q, tp.model, 2)
        if kv_split:
            k, v = (all_gather(t, tp.model, 2) for t in (k, v))
        write_cache(tp, cache.k, k, pos)
        write_cache(tp, cache.v, v, pos)
        q = q.to(cache.k.dtype).contiguous()
        if getattr(cache.k, "tp_dim", None) == 1:
            out, lse = kops.decode_attention(q, cache.k, cache.v, pos, k0=tp.seq_offset(cache.k),
                                             return_lse=True, **kw)
            out = tp.merge_over_model(out, lse)      # float32, rounded once below
        else:
            out = kops.decode_attention(q, cache.k, cache.v, pos, **kw)
        if split:
            out = out[:, :, tp.rank * h:(tp.rank + 1) * h]
        out = out.to(x.dtype).reshape(b, 1, -1) @ w["wo"].to(x.dtype)
        return tp.reduce_out(out) if split else out



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

    tp = None

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

    def _own(self):
        w = {n: p for n, p in self.named_parameters(recurse=False)}
        w["kv_norm"] = self.kv_norm.scale
        if self.cfg.mla.q_lora_rank:
            w["q_norm"] = self.q_norm.scale
        return w

    def _q(self, x, positions, use_kernel: bool, w=None, h=None, f=_same):
        """``f`` marks where the replicated latent meets the per-head
        up-projection (``tp.copy_in`` on a mesh)."""
        m, eps = self.cfg.mla, self.cfg.norm_eps
        w = self._own() if w is None else w
        h = self.cfg.n_heads if h is None else h
        b, s, _ = x.shape
        if m.q_lora_rank:
            cq = kops.rmsnorm(x @ w["w_dq"].to(x.dtype), w["q_norm"], eps, use_kernel)
            q = f(cq) @ w["w_uq"].to(x.dtype)
        else:
            q = f(x) @ w["w_q"].to(x.dtype)
        q = q.reshape(b, s, h, m.nope_head_dim + m.rope_head_dim)
        q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
        return q_nope, apply_rope(q_rope, positions, self.cfg.rope_theta)

    def _ckv(self, x, positions, use_kernel: bool, w=None):
        w = self._own() if w is None else w
        c_kv = kops.rmsnorm(x @ w["w_dkv"].to(x.dtype), w["kv_norm"], self.cfg.norm_eps,
                            use_kernel)
        k_rope = (x @ w["w_krope"].to(x.dtype))[:, :, None, :]       # one shared head
        return c_kv, apply_rope(k_rope, positions, self.cfg.rope_theta)[:, :, 0]

    def _attend(self, q_nope, q_rope, c_kv, k_rope, w=None, h=None, f=_same):
        """Naive MLA: per-head K and V materialised from the latent."""
        m = self.cfg.mla
        w = self._own() if w is None else w
        h = self.cfg.n_heads if h is None else h
        b, sk = c_kv.shape[:2]
        c_kv = f(c_kv)
        k_nope = (c_kv @ w["w_uk"].to(c_kv.dtype)).reshape(b, sk, h, m.nope_head_dim)
        v = (c_kv @ w["w_uv"].to(c_kv.dtype)).reshape(b, sk, h, m.v_head_dim)
        k_rope = f(k_rope)[:, :, None, :].expand(b, sk, h, m.rope_head_dim)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope], dim=-1)
        return chunked_causal_attention(q, k, v, window=None, scale=self.scale)

    def _train(self, x, use_kernel: bool, w=None, h=None, f=_same):
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        w = self._own() if w is None else w
        q_nope, q_rope = self._q(x, positions, use_kernel, w, h, f)
        c_kv, k_rope = self._ckv(x, positions, use_kernel, w)
        out = self._attend(q_nope, q_rope, c_kv, k_rope, w, h, f)
        return out.reshape(b, s, -1) @ w["wo"].to(x.dtype)

    def heads_split(self) -> bool:
        tp, m = self.tp, self.cfg.mla
        up = (self.w_uq, 1) if m.q_lora_rank else (self.wo, 0)
        return (self.cfg.n_heads % tp.size == 0
                and tp.split_on((self.w_uk, 1), (self.w_uv, 1), (self.wo, 0), up))

    def forward_train(self, x, *, use_kernel: bool = True):
        """Full-sequence causal MLA without a cache (JAX ``mla_train``). On a
        mesh whose ``model`` axis splits the heads, the latents (``w_dkv``,
        ``w_krope``, ``w_dq`` and their norms) are computed whole on every
        rank, and ``w_uq`` (or this rank's columns of ``w_q``), ``w_uk``,
        ``w_uv`` and ``wo`` on this rank's heads; the outputs are all-reduced
        over ``model``. Else every rank computes the whole layer."""
        tp = self.tp
        if tp is None:
            return self._train(x, use_kernel)
        own = self._own()
        if not self.heads_split():
            return self._train(x, use_kernel, {k: tp.whole(v) for k, v in own.items()})
        w, h = self._split_weights()
        return tp.reduce_out(self._train(x, use_kernel, w, h, tp.copy_in))

    def _split_weights(self):
        """On a mesh whose ``model`` axis splits the heads: the up-projections
        and ``wo`` of this rank's heads, the latents' weights whole, and its
        heads."""
        tp, m, h = self.tp, self.cfg.mla, self.cfg.n_heads // self.tp.size
        local = ("w_uq", "w_uk", "w_uv", "wo")
        w = {k: tp.gather_batch(v) if k in local else
             v if k.endswith("norm") else tp.whole(v) for k, v in self._own().items()
             if k != "w_q"}
        if not m.q_lora_rank:
            qd = m.nope_head_dim + m.rope_head_dim
            w["w_q"] = tp.whole(self.w_q, partial=True)[:, tp.rank * h * qd:
                                                         (tp.rank + 1) * h * qd]
        return w, h

    def _serve_weights(self):
        """(weights, heads, split): ``forward_train``'s split on a mesh whose
        ``model`` axis splits the heads, else everything whole."""
        if self.tp is None:
            return self._own(), self.cfg.n_heads, False
        if not self.heads_split():
            return {k: self.tp.whole(v) for k, v in self._own().items()}, self.cfg.n_heads, False
        return (*self._split_weights(), True)

    def prefill(self, x, cache: MLACache, *, use_kernel: bool = True):
        """``forward_train``'s attention; writes the latent and the rotated key
        into ``cache[:, :S]`` in place (on a mesh, this rank's shard of them:
        the latents are whole on every rank)."""
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        w, h, split = self._serve_weights()
        q_nope, q_rope = self._q(x, positions, use_kernel, w, h)
        c_kv, k_rope = self._ckv(x, positions, use_kernel, w)
        out = self._attend(q_nope, q_rope, c_kv, k_rope, w, h)
        write_cache(self.tp, cache.c_kv, c_kv, 0)
        write_cache(self.tp, cache.k_rope, k_rope, 0)
        out = out.reshape(b, s, -1) @ w["wo"].to(x.dtype)
        return self.tp.reduce_out(out) if split else out

    def decode(self, x, cache: MLACache, pos: int, *, use_kernel: bool = True):
        """One token at host position ``pos`` against the whole cache (masked
        past ``pos``), absorbed: the cache stays (kv_lora + rope) wide. On a
        mesh whose ``cache_spec`` cuts the sequence, each rank scores every
        head (the absorbed queries gathered over ``model``) against its shard
        of the keys, and the ranks' contexts are merged by their log-sum-exp
        (``tp.merge_over_model``) before this rank's heads go through
        ``w_uv`` and its rows of ``wo``."""
        m = self.cfg.mla
        b = x.shape[0]
        tp = self.tp
        w, h, split = self._serve_weights()
        positions = torch.full((b, 1), pos, device=x.device)
        q_nope, q_rope = self._q(x, positions, use_kernel, w, h)          # (B, 1, h, *)
        c_kv_t, k_rope_t = self._ckv(x, positions, use_kernel, w)
        write_cache(tp, cache.c_kv, c_kv_t, pos)
        write_cache(tp, cache.k_rope, k_rope_t, pos)
        c_kv = cache.c_kv.float()
        w_uk = w["w_uk"].to(x.dtype).reshape(m.kv_lora_rank, h, m.nope_head_dim)
        q_lat = torch.einsum("bqhd,lhd->bqhl", q_nope, w_uk)
        if split:                                   # every head, on every rank
            q_lat, q_rope = (all_gather(t, tp.model, 2) for t in (q_lat, q_rope))
        scores = torch.einsum("bqhl,bkl->bhqk", q_lat.float(), c_kv)
        scores = scores + torch.einsum("bqhd,bkd->bhqk", q_rope.float(), cache.k_rope.float())
        scores = scores * self.scale
        if getattr(cache.c_kv, "tp_dim", None) == 1:
            k0 = tp.seq_offset(cache.c_kv)
            n_valid = max(0, min(pos - k0 + 1, c_kv.shape[1]))
            if n_valid:
                mask = torch.arange(c_kv.shape[1], device=x.device) < n_valid
                scores = torch.where(mask, scores, NEG_INF)
                mx = scores.amax(dim=-1, keepdim=True)
                p = torch.exp(scores - mx)
                den = p.sum(dim=-1, keepdim=True)
                ctx = torch.einsum("bhqk,bkl->bqhl", p / den, c_kv)
                lse = (mx + torch.log(den))[:, :, 0, 0]
            else:                                   # a shard wholly past pos
                ctx = c_kv.new_zeros(b, 1, scores.shape[1], m.kv_lora_rank)
                lse = torch.full((b, scores.shape[1]), NEG_INF, device=x.device)
            ctx = tp.merge_over_model(ctx, lse)
        else:
            mask = torch.arange(c_kv.shape[1], device=x.device) <= pos
            probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
            ctx = torch.einsum("bhqk,bkl->bqhl", probs, c_kv)
        ctx = ctx.to(x.dtype)
        if split:
            ctx = ctx[:, :, tp.rank * h:(tp.rank + 1) * h]
        w_uv = w["w_uv"].to(x.dtype).reshape(m.kv_lora_rank, h, m.v_head_dim)
        out = torch.einsum("bqhl,lhd->bqhd", ctx, w_uv)
        out = out.reshape(b, 1, h * m.v_head_dim) @ w["wo"].to(x.dtype)
        return tp.reduce_out(out) if split else out


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

    tp = None

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

    def _attend(self, x, vision_embed, w, h: int, hkv: int, kv_index=None):
        hd = self.cfg.resolved_head_dim
        b, s, _ = x.shape
        sv = vision_embed.shape[1]
        ve = vision_embed.to(x.dtype)
        q = (x @ w["wq"].to(x.dtype)).reshape(b, s, h, hd)
        k = (ve @ w["wk"].to(x.dtype)).reshape(b, sv, hkv, hd)
        v = (ve @ w["wv"].to(x.dtype)).reshape(b, sv, hkv, hd)
        if kv_index is None:
            k, v = k.repeat_interleave(h // hkv, 2), v.repeat_interleave(h // hkv, 2)
        else:
            k, v = k[:, :, kv_index], v[:, :, kv_index]
        out = cross_attention(q, k, v, scale=hd ** -0.5)
        return out.reshape(b, s, h * hd) @ w["wo"].to(x.dtype)

    def forward(self, x, vision_embed):
        """x: (B, S, d); vision_embed: (B, Sv, vision_d_model). On a mesh whose
        ``model`` axis splits the heads, ``wq``/``wk``/``wv`` are
        column-parallel (the kv heads as ``kv_plan`` gives them), ``wo``
        row-parallel and the output all-reduced over ``model`` before the
        gate, which every rank applies whole; else every rank computes the
        whole layer."""
        cfg, tp = self.cfg, self.tp
        h, hkv = cfg.n_heads, cfg.n_kv_heads
        own = {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}
        if tp is None:
            out = self._attend(x, vision_embed, own, h, hkv)
        elif h % tp.size or not tp.split_on((self.wq, 1), (self.wo, 0)):
            whole = {k: tp.whole(v) for k, v in own.items()}
            out = self._attend(x, vision_embed, whole, h, hkv)
        else:
            wk, wv, hkv_l, kv_index = kv_plan(tp, h, hkv, cfg.resolved_head_dim,
                                              self.wk, self.wv)
            w = {"wq": tp.gather_batch(self.wq), "wk": wk, "wv": wv,
                 "wo": tp.gather_batch(self.wo)}
            out = tp.reduce_out(self._attend(tp.copy_in(x), vision_embed, w, h // tp.size,
                                             hkv_l, kv_index))
        return torch.tanh(self.gate.to(x.dtype)) * out
