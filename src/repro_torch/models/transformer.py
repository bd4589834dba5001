"""Decoder LM over a stack of dense blocks.

Port of the dense part of ``repro.models.transformer``. The JAX package stacks
the weights of a segment on a leading units axis and runs the stack with
``lax.scan``; here ``LM`` is an ``nn.Module`` holding a list of per-layer
blocks and runs them in a Python loop, so each layer's sliding window is a
host int. Modes: ``train`` (full sequence, no cache), ``prefill`` (full
sequence, writes the cache) and ``decode`` (one token against the cache).
MoE, MLA, recurrent and cross-attention blocks are not ported yet.

Every norm goes through ``kernels.ops.rmsnorm``: the CUDA kernel on the card
when ``use_kernel`` is set, in every mode. The parameters are trainable;
the serve steps (``train/steps.py``) run under ``torch.no_grad``.

Remat follows the JAX package: ``full`` recomputes each block in the backward
pass (a non-reentrant ``torch.utils.checkpoint`` around it, as
``jax.checkpoint`` with ``nothing_saveable``), ``none`` keeps every
activation. ``dots`` is not ported (ROADMAP.md, Queue 1 item 8).
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.common.config import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.attention import GQAttention, KVCache, layer_window
from repro_torch.models.layers import (embed, glu_mlp, logits_from_embedding, softcap,
                                       truncated_normal)

REMAT = ("none", "dots", "full")


class RMSNorm(nn.Module):
    """Gemma-style ``(1 + scale)``; the scale starts at zero."""

    def __init__(self, d: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x, use_kernel: bool = True):
        return kops.rmsnorm(x, self.scale, self.eps, use_kernel=use_kernel)


class GLUMLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str, dtype, device):
        super().__init__()
        self.act = act
        kw = dict(dtype=dtype, device=device)
        self.wi_gate = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.wi_up = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.wo = nn.Parameter(torch.empty(d_ff, d_model, **kw))

    def init_weights(self, generator: torch.Generator) -> None:
        for w in (self.wi_gate, self.wi_up, self.wo):
            w.copy_(truncated_normal(w.shape, w.shape[0] ** -0.5, w.dtype, w.device, generator))

    def forward(self, x):
        return glu_mlp(x, self.wi_gate, self.wi_up, self.wo, self.act)


class DenseBlock(nn.Module):
    """Attention + GLU MLP, pre-norm, with gemma2's optional sandwich norms."""

    def __init__(self, cfg: ModelConfig, layer_idx: int, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.window = layer_window(cfg, layer_idx)
        d, eps = cfg.d_model, cfg.norm_eps
        self.ln1 = RMSNorm(d, eps, dtype, device)
        self.attn = GQAttention(cfg, dtype, device)
        self.ln2 = RMSNorm(d, eps, dtype, device)
        self.mlp = GLUMLP(d, cfg.d_ff, cfg.act, dtype, device)
        if cfg.post_block_norm:
            self.pn1 = RMSNorm(d, eps, dtype, device)
            self.pn2 = RMSNorm(d, eps, dtype, device)

    def forward(self, x, *, mode: str, cache: Optional[KVCache] = None,
                pos: Optional[int] = None, use_kernel: bool = True):
        h = self.ln1(x, use_kernel)
        if mode == "train":
            a = self.attn.forward_train(h, window=self.window)
        elif mode == "prefill":
            a = self.attn.prefill(h, cache, window=self.window, use_kernel=use_kernel)
        elif mode == "decode":
            a = self.attn.decode(h, cache, pos, window=self.window, use_kernel=use_kernel)
        else:
            raise ValueError(f"mode {mode!r}: expected 'train', 'prefill' or 'decode'")
        if self.cfg.post_block_norm:
            a = self.pn1(a, use_kernel)
        x = x + a
        ff = self.mlp(self.ln2(x, use_kernel))
        if self.cfg.post_block_norm:
            ff = self.pn2(ff, use_kernel)
        return x + ff


def _check_ported(cfg: ModelConfig) -> None:
    unported = [name for name, on in (
        ("moe", cfg.moe is not None), ("mla", cfg.mla is not None),
        ("ssm", cfg.ssm is not None), ("block_pattern", bool(cfg.block_pattern)),
        ("cross_attn_every", bool(cfg.cross_attn_every)),
        ("family=audio", cfg.family == "audio"),
        ("untied embeddings", not cfg.tie_embeddings)) if on]
    if unported:
        raise ValueError(f"{cfg.name}: not ported yet: {', '.join(unported)}")


class LM(nn.Module):
    """Dense decoder LM with tied embeddings. ``device=None`` means ``cuda``.

    Parameter names mirror the JAX pytree: ``embed.table``,
    ``final_norm.scale`` and ``blocks.<layer>.<path>`` for the per-layer
    weights (see ``repro_torch.convert``)."""

    def __init__(self, cfg: ModelConfig, param_dtype=torch.bfloat16, device=None,
                 use_kernel: bool = True, remat: str = "none"):
        super().__init__()
        _check_ported(cfg)
        if remat not in REMAT:
            raise ValueError(f"remat {remat!r}: expected one of {REMAT}")
        dev = resolve_device(device)
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.use_kernel = use_kernel
        self.remat = remat
        self.embed = nn.Module()
        self.embed.table = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=param_dtype, device=dev))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, param_dtype, dev)
        self.blocks = nn.ModuleList(
            DenseBlock(cfg, i, param_dtype, dev) for i in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LM":
        """Random weights drawn from ``generator`` (on the model's device);
        norm scales start at zero, as in the JAX package."""
        t = self.embed.table
        t.copy_(truncated_normal(t.shape, self.cfg.d_model ** -0.5, t.dtype, t.device,
                                 generator))
        for blk in self.blocks:
            blk.attn.init_weights(generator)
            blk.mlp.init_weights(generator)
        return self

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> List[KVCache]:
        cfg = self.cfg
        shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return [KVCache(torch.zeros(shape, dtype=dtype, device=self.device),
                        torch.zeros(shape, dtype=dtype, device=self.device))
                for _ in self.blocks]

    def logits_fn(self, x):
        """Tied read-out for post-final-norm hidden states, in float32."""
        return softcap(logits_from_embedding(self.embed.table, x).float(),
                       self.cfg.final_logit_softcap)

    def forward(self, tokens: torch.Tensor, *, mode: str,
                cache: Optional[List[KVCache]] = None, pos: Optional[int] = None,
                head: str = "full"):
        """tokens: (B, S) ints. ``train`` takes no cache; ``prefill`` writes
        ``cache[:, :S]``; ``decode`` takes S = 1 at host position ``pos``.
        head: "full" -> logits for every position, "last" -> the final
        position only, "none" -> the post-final-norm hidden states (for the
        chunked loss). Returns (logits or hidden, cache); the cache is updated
        in place."""
        cfg = self.cfg
        if head not in ("full", "last", "none"):
            raise ValueError(f"head {head!r}")
        if (mode == "train") != (cache is None):
            raise ValueError(f"mode {mode!r}: 'train' takes no cache, "
                             "'prefill' and 'decode' need one")
        if mode == "train" and self.remat == "dots":
            raise NotImplementedError(
                "remat 'dots' is not ported (ROADMAP.md, Queue 1 item 8); use 'full' or 'none'")
        remat = mode == "train" and self.remat == "full" and torch.is_grad_enabled()
        x = embed(self.embed.table, tokens, scale_by_sqrt_dim=cfg.embed_scale)
        x = x.to(self.param_dtype)
        for i, blk in enumerate(self.blocks):
            kw = dict(mode=mode, cache=None if cache is None else cache[i], pos=pos,
                      use_kernel=self.use_kernel)
            x = checkpoint(blk, x, use_reentrant=False, **kw) if remat else blk(x, **kw)
        x = self.final_norm(x, self.use_kernel)
        if head == "none":
            return x, cache
        if head == "last":
            x = x[:, -1:]
        return self.logits_fn(x), cache
