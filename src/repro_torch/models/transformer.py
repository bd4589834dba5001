"""Decoder LM over a stack of dense and MoE blocks.

Port of the attention-and-FFN part of ``repro.models.transformer``. The JAX
package stacks the weights of a segment on a leading units axis and runs the
stack with ``lax.scan``; here ``LM`` is an ``nn.Module`` holding a list of
per-layer blocks and runs them in a Python loop, so each layer's sliding
window is a host int. The layer plan is ``plan_segments``': every layer
dense, or with MoE every layer MoE but the first ``first_k_dense`` (a block
with ``MoE`` in place of the MLP). Attention is GQA, or MLA where the config
has it. Modes: ``train`` (full sequence, no cache), ``prefill`` (full
sequence, writes the cache) and ``decode`` (one token against the cache).
The input is token ids, or frame ``embeddings`` for the audio family (whose
front end is a stub in both packages); the read-out is the tied embedding
table or an untied ``head``. Recurrent and cross-attention blocks are not
ported yet.

Every norm goes through ``kernels.ops.rmsnorm``: the CUDA kernel on the card
when ``use_kernel`` is set, in every mode. The parameters are trainable;
the serve steps (``train/steps.py``) run under ``torch.no_grad``.

Remat follows the JAX package. ``full`` recomputes each block in the backward
pass (a non-reentrant ``torch.utils.checkpoint`` around it, as
``jax.checkpoint`` with ``nothing_saveable``). ``dots`` keeps the outputs of
the block's 2-D matmuls (``aten.mm``: the projections of attention, the MLP,
the router and the shared or residual MLPs, which have no batch dimension
once flattened) and recomputes the rest, the attention's score and PV
products and the experts' products (batched over E) included: a selective
checkpoint whose policy is JAX's ``dots_with_no_batch_dims_saveable``. The
RMSNorm kernel runs outside the dispatcher, so the policy never sees it and
it is recomputed, as it is under ``full``. ``none`` keeps every activation.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.common.config import BLOCK_DENSE, BLOCK_MOE, ModelConfig
from repro_torch.models.attention import (GQAttention, KVCache, MLACache, MLAttention,
                                          layer_window)
from repro_torch.models.layers import (GLUMLP, RMSNorm, embed, logits_from_embedding,
                                       logits_from_head, softcap, truncated_normal)
from repro_torch.models.moe import MoE

REMAT = ("none", "dots", "full")


def _dots_policy(ctx, func, *args, **kwargs):
    """Save the outputs of 2-D matmuls, recompute everything else."""
    if func is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_dots_context = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


Aux = Dict[str, torch.Tensor]
AUX_KEYS = ("moe_lb_loss", "moe_z_loss")


class DenseBlock(nn.Module):
    """Attention (GQA or MLA) + GLU MLP, pre-norm, with gemma2's optional
    sandwich norms. ``forward`` returns the block's output;
    ``forward_aux`` also the FFN's aux losses (none here)."""

    def __init__(self, cfg: ModelConfig, layer_idx: int, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.window = layer_window(cfg, layer_idx)
        d, eps = cfg.d_model, cfg.norm_eps
        self.ln1 = RMSNorm(d, eps, dtype, device)
        self.attn = (MLAttention if cfg.mla is not None else GQAttention)(cfg, dtype, device)
        self.ln2 = RMSNorm(d, eps, dtype, device)
        self._init_ffn(cfg, dtype, device)
        if cfg.post_block_norm:
            self.pn1 = RMSNorm(d, eps, dtype, device)
            self.pn2 = RMSNorm(d, eps, dtype, device)

    def _init_ffn(self, cfg: ModelConfig, dtype, device) -> None:
        self.mlp = GLUMLP(cfg.d_model, cfg.d_ff, cfg.act, dtype, device)

    def _ffn(self, h) -> Tuple[torch.Tensor, Aux]:
        return self.mlp(h), {}

    def init_weights(self, generator: torch.Generator) -> None:
        self.attn.init_weights(generator)
        (self.moe if hasattr(self, "moe") else self.mlp).init_weights(generator)

    def _attention(self, h, mode: str, cache, pos, use_kernel: bool):
        # MLA attends causally on every layer; a GQA layer takes its window
        kw = {} if self.cfg.mla is not None else {"window": self.window}
        if mode == "train":
            return self.attn.forward_train(h, use_kernel=use_kernel, **kw)
        if mode == "prefill":
            return self.attn.prefill(h, cache, use_kernel=use_kernel, **kw)
        if mode == "decode":
            return self.attn.decode(h, cache, pos, use_kernel=use_kernel, **kw)
        raise ValueError(f"mode {mode!r}: expected 'train', 'prefill' or 'decode'")

    def forward_aux(self, x, *, mode: str, cache: Optional[Union[KVCache, MLACache]] = None,
                    pos: Optional[int] = None, use_kernel: bool = True) -> Tuple[torch.Tensor, Aux]:
        a = self._attention(self.ln1(x, use_kernel), mode, cache, pos, use_kernel)
        if self.cfg.post_block_norm:
            a = self.pn1(a, use_kernel)
        x = x + a
        ff, aux = self._ffn(self.ln2(x, use_kernel))
        if self.cfg.post_block_norm:
            ff = self.pn2(ff, use_kernel)
        return x + ff, aux

    def forward(self, x, **kw):
        return self.forward_aux(x, **kw)[0]


class MoEBlock(DenseBlock):
    """The dense block with ``MoE`` (``moe``) in place of the MLP."""

    def _init_ffn(self, cfg: ModelConfig, dtype, device) -> None:
        self.moe = MoE(cfg, dtype, device)

    def _ffn(self, h) -> Tuple[torch.Tensor, Aux]:
        return self.moe(h)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Each layer's block, as ``plan_segments`` lays them out: with MoE, the
    first ``first_k_dense`` layers dense and the rest MoE; else all dense."""
    return [BLOCK_MOE if cfg.moe is not None and i >= cfg.first_k_dense else BLOCK_DENSE
            for i in range(cfg.n_layers)]


def _check_ported(cfg: ModelConfig) -> None:
    unported = [name for name, on in (
        ("ssm", cfg.ssm is not None), ("block_pattern", bool(cfg.block_pattern)),
        ("cross_attn_every", bool(cfg.cross_attn_every))) if on]
    if unported:
        raise ValueError(f"{cfg.name}: not ported yet: {', '.join(unported)}")


class LM(nn.Module):
    """Decoder LM of dense and MoE blocks. ``device=None`` means ``cuda``.

    Parameter names mirror the JAX pytree: ``embed.table`` (not for the
    audio family), ``head`` (d_model, vocab) where the read-out is untied
    (the audio family, or ``tie_embeddings`` off), ``final_norm.scale`` and
    ``blocks.<layer>.<path>`` for the per-layer weights (see
    ``repro_torch.convert``)."""

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
        if cfg.family != "audio":
            self.embed = nn.Module()
            self.embed.table = nn.Parameter(
                torch.empty(cfg.vocab_size, cfg.d_model, dtype=param_dtype, device=dev))
        if cfg.family == "audio" or not cfg.tie_embeddings:
            self.head = nn.Parameter(
                torch.empty(cfg.d_model, cfg.vocab_size, dtype=param_dtype, device=dev))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, param_dtype, dev)
        self.blocks = nn.ModuleList(
            (MoEBlock if kind == BLOCK_MOE else DenseBlock)(cfg, i, param_dtype, dev)
            for i, kind in enumerate(layer_kinds(cfg)))

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "LM":
        """Random weights drawn from ``generator`` (on the model's device);
        norm scales start at zero, as in the JAX package."""
        for t in (getattr(getattr(self, "embed", None), "table", None),
                  getattr(self, "head", None)):
            if t is not None:
                t.copy_(truncated_normal(t.shape, self.cfg.d_model ** -0.5, t.dtype, t.device,
                                         generator))
        for blk in self.blocks:
            blk.init_weights(generator)
        return self

    def init_cache(self, batch: int, max_len: int,
                   dtype=torch.bfloat16) -> List[Union[KVCache, MLACache]]:
        """A zero cache a layer: k and v (B, max_len, Hkv, head_dim) for GQA;
        for MLA the latent (B, max_len, kv_lora_rank) and the rotated key
        (B, max_len, rope_head_dim)."""
        cfg = self.cfg

        def zeros(*shape):
            return torch.zeros(shape, dtype=dtype, device=self.device)
        if cfg.mla is not None:
            m = cfg.mla
            return [MLACache(zeros(batch, max_len, m.kv_lora_rank),
                             zeros(batch, max_len, m.rope_head_dim)) for _ in self.blocks]
        shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
        return [KVCache(zeros(*shape), zeros(*shape)) for _ in self.blocks]

    def logits_fn(self, x):
        """Read-out for post-final-norm hidden states, in float32: the untied
        ``head`` where the model has one, else the tied embedding table."""
        if hasattr(self, "head"):
            logits = logits_from_head(self.head, x)
        else:
            logits = logits_from_embedding(self.embed.table, x)
        return softcap(logits.float(), self.cfg.final_logit_softcap)

    def forward(self, tokens: Optional[torch.Tensor] = None, *, mode: str,
                embeddings: Optional[torch.Tensor] = None,
                cache: Optional[list] = None, pos: Optional[int] = None,
                head: str = "full", with_aux: bool = False):
        """tokens: (B, S) ints, or embeddings: (B, S, d_model) (the audio
        family's frames; cast to ``param_dtype``), exactly one of the two.
        ``train`` takes no cache; ``prefill`` writes ``cache[:, :S]``;
        ``decode`` takes S = 1 at host position ``pos``. head: "full" ->
        logits for every position, "last" -> the final position only, "none"
        -> the post-final-norm hidden states (for the chunked loss). Returns
        (logits or hidden, cache); the cache is updated in place. With
        ``with_aux``, (logits or hidden, cache, aux): the MoE layers' aux
        losses summed in layer order from zero (float32), ``{}`` for a model
        without MoE, as the JAX ``forward`` returns them."""
        cfg = self.cfg
        if head not in ("full", "last", "none"):
            raise ValueError(f"head {head!r}")
        if (mode == "train") != (cache is None):
            raise ValueError(f"mode {mode!r}: 'train' takes no cache, "
                             "'prefill' and 'decode' need one")
        if (tokens is None) == (embeddings is None):
            raise ValueError("pass exactly one of tokens and embeddings")
        remat = self.remat if mode == "train" and torch.is_grad_enabled() else "none"
        if embeddings is not None:
            x = embeddings.to(self.param_dtype)
        else:
            x = embed(self.embed.table, tokens, scale_by_sqrt_dim=cfg.embed_scale)
            x = x.to(self.param_dtype)
        aux = ({k: torch.zeros((), dtype=torch.float32, device=x.device) for k in AUX_KEYS}
               if cfg.moe is not None else {})
        for i, blk in enumerate(self.blocks):
            kw = dict(mode=mode, cache=None if cache is None else cache[i], pos=pos,
                      use_kernel=self.use_kernel)
            if remat == "full":
                x, block_aux = checkpoint(blk.forward_aux, x, use_reentrant=False, **kw)
            elif remat == "dots":
                x, block_aux = checkpoint(blk.forward_aux, x, use_reentrant=False,
                                          context_fn=_dots_context, **kw)
            else:
                x, block_aux = blk.forward_aux(x, **kw)
            for k, v in block_aux.items():
                aux[k] = aux[k] + v
        x = self.final_norm(x, self.use_kernel)
        if head == "last":
            x = x[:, -1:]
        if head != "none":
            x = self.logits_fn(x)
        return (x, cache, aux) if with_aux else (x, cache)
