"""Decoder LM over a stack of dense blocks.

Port of the dense part of ``repro.models.transformer``. The JAX package stacks
the weights of a segment on a leading units axis and runs the stack with
``lax.scan``; here ``LM`` is an ``nn.Module`` holding a list of per-layer
blocks and runs them in a Python loop, so each layer's sliding window is a
host int. Modes: ``prefill`` (full sequence, writes the cache) and ``decode``
(one token against the cache). Training, MoE, MLA, recurrent and
cross-attention blocks are not ported yet.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.common.config import ModelConfig
from repro_torch.models.attention import GQAttention, KVCache, layer_window
from repro_torch.models.layers import (embed, glu_mlp, logits_from_embedding, rmsnorm,
                                       softcap, truncated_normal)


class RMSNorm(nn.Module):
    """Gemma-style ``(1 + scale)``; the scale starts at zero."""

    def __init__(self, d: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                                  requires_grad=False)

    def forward(self, x):
        return rmsnorm(x, self.scale, self.eps)


class GLUMLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str, dtype, device):
        super().__init__()
        self.act = act
        kw = dict(dtype=dtype, device=device)
        self.wi_gate = nn.Parameter(torch.empty(d_model, d_ff, **kw), requires_grad=False)
        self.wi_up = nn.Parameter(torch.empty(d_model, d_ff, **kw), requires_grad=False)
        self.wo = nn.Parameter(torch.empty(d_ff, d_model, **kw), requires_grad=False)

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

    def forward(self, x, *, mode: str, cache: KVCache, pos: Optional[int] = None,
                use_kernel: bool = True):
        h = self.ln1(x)
        if mode == "prefill":
            a = self.attn.prefill(h, cache, window=self.window, use_kernel=use_kernel)
        elif mode == "decode":
            a = self.attn.decode(h, cache, pos, window=self.window, use_kernel=use_kernel)
        else:
            raise ValueError(f"mode {mode!r}: only 'prefill' and 'decode' are ported")
        if self.cfg.post_block_norm:
            a = self.pn1(a)
        x = x + a
        ff = self.mlp(self.ln2(x))
        if self.cfg.post_block_norm:
            ff = self.pn2(ff)
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
                 use_kernel: bool = True):
        super().__init__()
        _check_ported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.use_kernel = use_kernel
        self.embed = nn.Module()
        self.embed.table = nn.Parameter(
            torch.empty(cfg.vocab_size, cfg.d_model, dtype=param_dtype, device=dev),
            requires_grad=False)
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

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, mode: str, cache: List[KVCache],
                pos: Optional[int] = None, head: str = "full"):
        """tokens: (B, S) ints. ``prefill`` writes ``cache[:, :S]``; ``decode``
        takes S = 1 at host position ``pos``. head: "full" -> logits for every
        position, "last" -> the final position only. Returns (logits, cache);
        the cache is updated in place."""
        cfg = self.cfg
        if head not in ("full", "last"):
            raise ValueError(f"head {head!r}")
        x = embed(self.embed.table, tokens, scale_by_sqrt_dim=cfg.embed_scale)
        x = x.to(self.param_dtype)
        for blk, c in zip(self.blocks, cache):
            x = blk(x, mode=mode, cache=c, pos=pos, use_kernel=self.use_kernel)
        x = self.final_norm(x)
        if head == "last":
            x = x[:, -1:]
        return self.logits_fn(x), cache
