"""Decoder LM over a plan of dense, MoE, cross-attention and recurrent blocks.

Port of ``repro.models.transformer``. The JAX package stacks the weights of a
segment on a leading units axis and runs the stack with ``lax.scan``; here
``LM`` is an ``nn.Module`` holding a list of per-layer blocks and runs them in
a Python loop, so each layer's sliding window is a host int. The plan
(``layer_plan``) is ``plan_segments``' units laid end to end:

- dense, or with MoE every layer MoE but the first ``first_k_dense`` (a
  block with ``MoE`` in place of the MLP), attention GQA or MLA;
- llama-3.2-vision (``cross_attn_every``): units of ``every`` layers whose
  position ``every - 2`` is a ``CrossBlock`` (tanh-gated cross attention to
  the batch's ``vision_embed`` and a tanh-gated MLP; no cache: the vision K/V
  are recomputed every step, as in the JAX package);
- zamba2 (``shared_attn_every`` with ``ssm``): units of ``every`` Mamba2
  blocks and one application of the shared attention block, then a tail of
  the remaining Mamba2 blocks. The shared block is one module
  (``shared_attn``), applied once a unit with its own KV cache each time, full
  causal; its weights do not count toward ``n_layers`` and its gradients sum
  over the applications;
- ``block_pattern`` (xlstm: mLSTM x 3, sLSTM), repeated.

Recurrent blocks are the cell (``models/ssm.py``) behind a pre-norm with a
residual and no FFN. Modes: ``train`` (full sequence, no cache), ``prefill``
(full sequence, writes the cache; a recurrent block starts from the state in
its cache) and ``decode`` (one token against the cache). The input is token
ids, or frame ``embeddings`` for the audio family (whose front end is a stub
in both packages); the read-out is the tied embedding table or an untied
``head``.

Every norm goes through ``kernels.ops.rmsnorm``: the CUDA kernel on the card
when ``use_kernel`` is set, in every mode. The parameters are trainable;
the serve steps (``train/steps.py``) run under ``torch.no_grad``.

Remat follows the JAX package. ``full`` recomputes each block in the backward
pass (a non-reentrant ``torch.utils.checkpoint`` around it, as
``jax.checkpoint`` with ``nothing_saveable``). ``dots`` keeps the outputs of
the block's 2-D matmuls (``aten.mm``: the projections of attention, the MLP,
the router, the shared or residual MLPs and the recurrent cells, which have
no batch dimension once flattened) and recomputes the rest, the attention's
score and PV products, the experts' products (batched over E) and the cells'
scans included: a selective checkpoint whose policy is JAX's
``dots_with_no_batch_dims_saveable``. The RMSNorm kernel runs outside the
dispatcher, so the policy never sees it and it is recomputed, as it is under
``full``. ``none`` keeps every activation.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.common.config import (BLOCK_DENSE, BLOCK_MAMBA2, BLOCK_MLSTM, BLOCK_MOE,
                                       BLOCK_SLSTM, ModelConfig)
from repro_torch.models.attention import (CrossAttention, GQAttention, KVCache, MLACache,
                                          MLAttention, layer_window)
from repro_torch.models.layers import (GLUMLP, RMSNorm, embed, logits_from_embedding,
                                       logits_from_head, softcap, truncated_normal,
                                       vocab_embed)
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import MLSTM, SLSTM, Mamba2

BLOCK_CROSS = "cross"
BLOCK_SHARED_ATTN = "shared_attn"
REMAT = ("none", "dots", "full")
SP_ATTN = ("", "batch", "sequence")


def check_sp_attn(mode: str) -> None:
    """Refuse an attention activation mode the port does not run, by name."""
    if mode not in SP_ATTN:
        raise ValueError(f"attention activation mode {mode!r}: expected one of {SP_ATTN}")


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
    sandwich norms. ``layer_idx`` sets the layer's window; ``None`` is
    zamba2's shared block, full causal. ``sp_attn``: the GQA attention's
    activation mode (``GQAttention``; MLA takes none, as in the JAX
    package). ``forward`` returns the block's output; ``forward_aux`` also
    the FFN's aux losses (none here)."""

    def __init__(self, cfg: ModelConfig, layer_idx: Optional[int], dtype, device,
                 sp_attn: str = ""):
        super().__init__()
        self.cfg = cfg
        self.window = 0 if layer_idx is None else layer_window(cfg, layer_idx)
        d, eps = cfg.d_model, cfg.norm_eps
        self.ln1 = RMSNorm(d, eps, dtype, device)
        self.attn = (MLAttention(cfg, dtype, device) if cfg.mla is not None
                     else GQAttention(cfg, dtype, device, sp_attn=sp_attn))
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

    def init_cache(self, batch: int, max_len: int, dtype):
        """Zeros: k and v (B, max_len, Hkv, head_dim) for GQA; for MLA the
        latent (B, max_len, kv_lora_rank) and the rotated key (B, max_len,
        rope_head_dim). On a mesh, this rank's shard of each under
        ``sharding.cache_spec`` (``tp.cache_dim``: the sequence; a placement
        on another dim is refused)."""
        cfg = self.cfg
        kw = dict(dtype=dtype, device=self.ln1.scale.device)
        if cfg.mla is not None:
            m = cfg.mla
            shapes, kind = ((batch, max_len, m.kv_lora_rank),
                            (batch, max_len, m.rope_head_dim)), MLACache
        else:
            shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
            shapes, kind = (shape, shape), KVCache
        tp = self.attn.tp
        if tp is None:
            return kind(*(torch.zeros(sh, **kw) for sh in shapes))
        leaves = []
        for sh in shapes:
            dim = tp.cache_dim(sh, allowed=(1,))
            t = torch.zeros(sh if dim is None else
                            sh[:dim] + (sh[dim] // tp.size,) + sh[dim + 1:], **kw)
            t.tp_dim = dim
            leaves.append(t)
        return kind(*leaves)

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

    def forward_aux(self, x, *, mode: str, cache=None, pos: Optional[int] = None,
                    use_kernel: bool = True, vision_embed=None) -> Tuple[torch.Tensor, Aux]:
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


class CrossBlock(nn.Module):
    """llama-3.2-vision's image layer: ``ln1``, ``xattn`` (tanh-gated cross
    attention to ``vision_embed``), ``ln2``, ``mlp`` scaled by
    tanh(``ffn_gate``), both gates scalars that start at zero. No cache."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, eps = cfg.d_model, cfg.norm_eps
        self.ln1 = RMSNorm(d, eps, dtype, device)
        self.xattn = CrossAttention(cfg, dtype, device)
        self.ln2 = RMSNorm(d, eps, dtype, device)
        self.mlp = GLUMLP(d, cfg.d_ff, cfg.act, dtype, device)
        self.ffn_gate = nn.Parameter(torch.zeros((), dtype=dtype, device=device))

    def init_weights(self, generator: torch.Generator) -> None:
        self.xattn.init_weights(generator)
        self.mlp.init_weights(generator)
        self.ffn_gate.zero_()

    def init_cache(self, batch: int, max_len: int, dtype) -> None:
        return None

    def forward_aux(self, x, *, mode: str, cache=None, pos: Optional[int] = None,
                    use_kernel: bool = True, vision_embed=None) -> Tuple[torch.Tensor, Aux]:
        if vision_embed is None:
            raise ValueError("a cross-attention block needs the batch's vision_embed")
        x = x + self.xattn(self.ln1(x, use_kernel), vision_embed)
        ff = self.mlp(self.ln2(x, use_kernel))
        # the gate is rounded to the activations' dtype before tanh, as in JAX
        return x + torch.tanh(self.ffn_gate.to(x.dtype)) * ff, {}

    def forward(self, x, **kw):
        return self.forward_aux(x, **kw)[0]


class RecurrentBlock(nn.Module):
    """``ln1`` + a recurrent cell (``cell``) + the residual; no FFN. Prefill
    starts from the state in the cache and decode steps from it; both write
    the final state back into the cache in place.

    On a mesh whose ``model`` size divides the cell's heads, or is a
    multiple g·H of an xLSTM cell's H heads (xlstm-125m's 4 at 8 or 16: a
    head's 1/g a rank; ``cell.heads_split``), the cell computes on this
    rank's share from the shards the rules store (``models/ssm.py``), in
    every mode; serving keeps this rank's shard of each state tensor
    (``sharding.cache_spec``), moves it to the rank's heads (and Mamba2's
    conv channels), or its part of one, for a step and the new state back
    (``cell.state_to_heads``/``keep_state``: one all-to-all each way).
    Where neither placement applies, the cell's weights are gathered whole
    and every rank runs the whole cell, serving gathering the state whole
    over ``model`` for a step and keeping its shard of the new one."""

    cell_type = None
    tp = None

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype, device)
        self.cell = self.cell_type(cfg, dtype, device)

    def init_weights(self, generator: torch.Generator) -> None:
        self.cell.init_weights(generator)

    def init_cache(self, batch: int, max_len: int, dtype):
        """The cell's zero state (its conv inputs in ``dtype``, the rest
        float32); ``max_len`` does not matter. On a mesh, this rank's shard
        of each tensor."""
        state = self.cell.init_cache(batch, dtype)
        if self.tp is None:
            return state
        return type(state)(*(self.tp.local_cache(t) for t in state))

    def forward_aux(self, x, *, mode: str, cache=None, pos: Optional[int] = None,
                    use_kernel: bool = True, vision_embed=None) -> Tuple[torch.Tensor, Aux]:
        h = self.ln1(x, use_kernel)
        tp = self.tp
        on_heads = tp is not None and self.cell.heads_split()
        if mode == "train":
            if tp is None or on_heads:
                out, _ = self.cell(h, None, use_kernel)
            else:
                # the cell computes whole on every rank of a mesh, from its
                # weights gathered whole (see parallel.tensor)
                whole = {n: tp.whole(p) for n, p in self.cell.named_parameters()}
                out, _ = functional_call(self.cell, whole, (h, None, use_kernel))
            return x + out, {}
        if mode not in ("prefill", "decode"):
            raise ValueError(f"mode {mode!r}: expected 'train', 'prefill' or 'decode'")
        if tp is None or on_heads:
            step = self.cell if mode == "prefill" else self.cell.decode
            out, state = step(h, cache if tp is None else self.cell.state_to_heads(cache),
                              use_kernel)
            if tp is None:
                for dst, src in zip(cache, state):
                    dst.copy_(src)
            else:
                self.cell.keep_state(cache, state)
            return x + out, {}
        whole = {f"cell.{n}": tp.whole(p) for n, p in self.cell.named_parameters()}
        state = type(cache)(*(tp.gather_cache(t) for t in cache))
        out, state = functional_call(_CellStep(self.cell), whole,
                                     (h, state, use_kernel, mode == "decode"))
        for dst, src in zip(cache, state):
            tp.keep_cache(dst, src)
        return x + out, {}

    def forward(self, x, **kw):
        return self.forward_aux(x, **kw)[0]


class _CellStep(nn.Module):
    """A cell's prefill or one-token step as a module's forward, for
    ``functional_call`` with the cell's weights gathered whole."""

    def __init__(self, cell: nn.Module):
        super().__init__()
        self.cell = cell

    def forward(self, h, state, use_kernel: bool, decode: bool):
        return (self.cell.decode if decode else self.cell)(h, state, use_kernel)


class MambaBlock(RecurrentBlock):
    cell_type = Mamba2


class MLSTMBlock(RecurrentBlock):
    cell_type = MLSTM


class SLSTMBlock(RecurrentBlock):
    cell_type = SLSTM


RECURRENT_BLOCKS = {BLOCK_MAMBA2: MambaBlock, BLOCK_MLSTM: MLSTMBlock, BLOCK_SLSTM: SLSTMBlock}


def layer_plan(cfg: ModelConfig) -> List[str]:
    """Every block application's kind, in order: ``plan_segments``' units laid
    end to end. ``shared_attn`` entries (zamba2) are applications of the one
    shared block and do not count toward ``n_layers``."""
    n = cfg.n_layers
    if cfg.cross_attn_every:
        every = cfg.cross_attn_every
        if every < 2 or n % every:
            raise ValueError(f"{cfg.name}: cross_attn_every {every} must be at least 2 and "
                             f"divide n_layers {n}")
        return ([BLOCK_DENSE] * (every - 2) + [BLOCK_CROSS, BLOCK_DENSE]) * (n // every)
    if cfg.shared_attn_every and cfg.ssm is not None:
        k = cfg.shared_attn_every
        return ([BLOCK_MAMBA2] * k + [BLOCK_SHARED_ATTN]) * (n // k) + [BLOCK_MAMBA2] * (n % k)
    if cfg.block_pattern:
        pattern = list(cfg.block_pattern)
        if n % len(pattern):
            raise ValueError(f"{cfg.name}: block_pattern of {len(pattern)} does not divide "
                             f"n_layers {n}")
        unknown = set(pattern) - {BLOCK_DENSE, BLOCK_MOE, *RECURRENT_BLOCKS}
        if unknown:
            raise ValueError(f"{cfg.name}: block_pattern has unknown kinds {sorted(unknown)}")
        return pattern * (n // len(pattern))
    if cfg.moe is not None:
        return [BLOCK_DENSE if i < cfg.first_k_dense else BLOCK_MOE for i in range(n)]
    return [BLOCK_DENSE] * n


def stack_positions(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """Each layer's (segment, position in the unit) in the JAX package's
    ``plan_segments``: the layers of one pair are one stacked JAX leaf a
    weight (zamba2's shared block is not a layer)."""
    n = cfg.n_layers
    if cfg.cross_attn_every:
        return [(0, i % cfg.cross_attn_every) for i in range(n)]
    if cfg.shared_attn_every and cfg.ssm is not None:
        full = n // cfg.shared_attn_every * cfg.shared_attn_every
        return [(0, i % cfg.shared_attn_every) if i < full else (1, i - full) for i in range(n)]
    if cfg.block_pattern:
        return [(0, i % len(cfg.block_pattern)) for i in range(n)]
    if cfg.moe is not None and cfg.first_k_dense:
        return [(0 if i < cfg.first_k_dense else 1, 0) for i in range(n)]
    return [(0, 0)] * n


def stacked_leaves(cfg: ModelConfig, names) -> Dict[str, str]:
    """The stacked JAX leaf of each of ``names`` that the JAX package stacks:
    ``blocks.<layer>.<path>`` of every layer at one (segment, position)
    (``stack_positions``) share the leaf ``segment<s>.unit<p>.<path>``, whose
    rows are those layers in order. Other names (the embedding, the final
    norm, zamba2's shared block) are absent: their JAX leaf is their own."""
    where = stack_positions(cfg)
    out = {}
    for name in names:
        parts = name.split(".")
        if parts[0] == "blocks":
            seg, pos = where[int(parts[1])]
            out[name] = f"segment{seg}.unit{pos}." + ".".join(parts[2:])
    return out


def _make_block(cfg: ModelConfig, kind: str, layer_idx: int, dtype, device,
                sp_attn: str = "") -> nn.Module:
    if kind in RECURRENT_BLOCKS:
        if kind == BLOCK_MAMBA2 and cfg.ssm is None:
            raise ValueError(f"{cfg.name}: a mamba2 block needs cfg.ssm")
        return RECURRENT_BLOCKS[kind](cfg, dtype, device)
    if kind == BLOCK_CROSS:
        return CrossBlock(cfg, dtype, device)
    if kind == BLOCK_MOE and cfg.moe is None:
        raise ValueError(f"{cfg.name}: an MoE block needs cfg.moe")
    return (MoEBlock if kind == BLOCK_MOE else DenseBlock)(cfg, layer_idx, dtype, device,
                                                            sp_attn)


class LM(nn.Module):
    """Decoder LM over ``layer_plan(cfg)``. ``device=None`` means ``cuda``.

    Parameter names mirror the JAX pytree: ``embed.table`` (not for the
    audio family), ``head`` (d_model, vocab) where the read-out is untied
    (the audio family, or ``tie_embeddings`` off), ``final_norm.scale``,
    ``blocks.<layer>.<path>`` for the per-layer weights (``xattn.*`` and
    ``ffn_gate`` in a cross block, ``cell.*`` in a recurrent one) and
    ``shared_attn.<path>`` for zamba2's shared block (see
    ``repro_torch.convert``).

    ``tp`` is None on one device. On a mesh (``parallel.tensor.shard_model``
    or ``build_sharded``) every parameter is this rank's shard and every
    module computes its share of the train and serve steps (the module
    docstrings say what): the embedding and the read-out are vocab-parallel
    where ``model`` divides the vocab, each block gathers its weights over
    the batch axes when it runs, and under remat again in the recompute;
    ``init_cache`` gives this rank's shard of every cache
    (``sharding.cache_spec``).

    ``sp_attn``: "", "batch" or "sequence", the JAX ``LM``'s argument of
    that name (``models.model.attn_activation_mode`` resolves the config's
    knob), for every GQA attention, zamba2's shared block included (MLA and
    cross attention take none, as in the JAX package); any other name is
    refused (``check_sp_attn``)."""

    tp = None

    def __init__(self, cfg: ModelConfig, param_dtype=torch.bfloat16, device=None,
                 use_kernel: bool = True, remat: str = "none", sp_attn: str = ""):
        super().__init__()
        if remat not in REMAT:
            raise ValueError(f"remat {remat!r}: expected one of {REMAT}")
        check_sp_attn(sp_attn)
        kinds = layer_plan(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.use_kernel = use_kernel
        self.remat = remat
        self.kinds = tuple(kinds)
        if cfg.family != "audio":
            self.embed = nn.Module()
            self.embed.table = nn.Parameter(
                torch.empty(cfg.vocab_size, cfg.d_model, dtype=param_dtype, device=dev))
        if cfg.family == "audio" or not cfg.tie_embeddings:
            self.head = nn.Parameter(
                torch.empty(cfg.d_model, cfg.vocab_size, dtype=param_dtype, device=dev))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, param_dtype, dev)
        layers = [k for k in kinds if k != BLOCK_SHARED_ATTN]
        self.sp_attn = sp_attn
        self.blocks = nn.ModuleList(_make_block(cfg, kind, i, param_dtype, dev, sp_attn)
                                    for i, kind in enumerate(layers))
        if BLOCK_SHARED_ATTN in kinds:
            self.shared_attn = DenseBlock(cfg, None, param_dtype, dev, sp_attn)
        # the module of each application, in order (not registered twice)
        blocks = iter(self.blocks)
        self._apps = [self.shared_attn if k == BLOCK_SHARED_ATTN else next(blocks)
                      for k in kinds]

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator, cut=None) -> "LM":
        """Random weights drawn from ``generator`` (on the model's device);
        norm scales and the cross blocks' gates start at zero, as in the JAX
        package. ``cut``: the model was built on the meta device, and each
        part (the table, the head, a block, the final norm) is made on the
        generator's device just before it is drawn and ``cut()`` is called
        right after (``parallel.tensor.build_sharded`` cuts it to a rank's
        shards there); the draws are those of the one-device model."""
        make = (functools.partial(_materialize, device=generator.device) if cut is not None
                else lambda module, recurse=True: None)
        done = cut if cut is not None else lambda: None
        for owner, name in ((getattr(self, "embed", None), "table"), (self, "head")):
            if owner is None or name not in owner._parameters:
                continue
            make(owner, recurse=False)
            t = owner._parameters[name]
            t.copy_(truncated_normal(t.shape, self.cfg.d_model ** -0.5, t.dtype, t.device,
                                     generator))
            done()
        for blk in [*self.blocks, *([self.shared_attn] if hasattr(self, "shared_attn") else [])]:
            make(blk)
            blk.init_weights(generator)
            done()
        make(self.final_norm)
        done()
        return self

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16) -> list:
        """A zero cache an application of a block, in order: ``KVCache`` or
        ``MLACache`` (attention; one for each application of zamba2's shared
        block), ``MambaCache``, ``MLSTMCache``, ``SLSTMCache``, or ``None``
        for a cross block."""
        return [blk.init_cache(batch, max_len, dtype) for blk in self._apps]

    def readout_param(self) -> torch.Tensor:
        """The untied ``head`` (d_model, vocab) where the model has one, else
        the tied embedding table (vocab, d_model)."""
        return self.head if hasattr(self, "head") else self.embed.table

    def vocab_split(self) -> bool:
        """On a mesh of more than one ``model`` rank, the read-out's vocab is
        split over ``model`` (each rank's logits are its vocab columns)."""
        tp, w = self.tp, self.readout_param()
        return tp is not None and tp.size > 1 and tp.split_dim(w) == (
            1 if hasattr(self, "head") else 0)

    def readout_weight(self) -> torch.Tensor:
        """``readout_param`` as the read-out multiplies by it: on a mesh
        gathered over the batch axes (this rank's vocab shard where
        ``vocab_split``, else whole)."""
        w, tp = self.readout_param(), self.tp
        if tp is None:
            return w
        return tp.gather_batch(w) if self.vocab_split() else tp.whole(w)

    def logits_fn(self, x, w: Optional[torch.Tensor] = None):
        """Read-out for post-final-norm hidden states, in float32: the untied
        ``head`` where the model has one, else the tied embedding table; ``w``
        is ``readout_weight()`` where the caller has it. Where the vocab is
        split over a mesh's ``model`` axis, the logits of this rank's vocab
        shard (``x`` having been through ``tp.copy_in``)."""
        w = self.readout_weight() if w is None else w
        if hasattr(self, "head"):
            logits = logits_from_head(w, x)
        else:
            logits = logits_from_embedding(w, x)
        return softcap(logits.float(), self.cfg.final_logit_softcap)

    def forward(self, tokens: Optional[torch.Tensor] = None, *, mode: str,
                embeddings: Optional[torch.Tensor] = None,
                vision_embed: Optional[torch.Tensor] = None,
                cache: Optional[list] = None, pos: Optional[int] = None,
                head: str = "full", with_aux: bool = False):
        """tokens: (B, S) ints, or embeddings: (B, S, d_model) (the audio
        family's frames; cast to ``param_dtype``), exactly one of the two;
        vision_embed: (B, Sv, vision_d_model), required by a model with cross
        blocks, in every mode. ``train`` takes no cache; ``prefill`` writes
        ``cache[:, :S]`` (a recurrent block: its final state); ``decode``
        takes S = 1 at host position ``pos``. head: "full" -> logits for every
        position, "last" -> the final position only, "none" -> the
        post-final-norm hidden states (for the chunked loss). Returns (logits
        or hidden, cache); the cache is updated in place. With ``with_aux``,
        (logits or hidden, cache, aux): the MoE layers' aux losses summed in
        layer order from zero (float32), ``{}`` for a model without MoE, as
        the JAX ``forward`` returns them."""
        cfg = self.cfg
        if head not in ("full", "last", "none"):
            raise ValueError(f"head {head!r}")
        if (mode == "train") != (cache is None):
            raise ValueError(f"mode {mode!r}: 'train' takes no cache, "
                             "'prefill' and 'decode' need one")
        if cache is not None and len(cache) != len(self._apps):
            raise ValueError(f"a cache of {len(cache)} entries for {len(self._apps)} "
                             "block applications")
        if (tokens is None) == (embeddings is None):
            raise ValueError("pass exactly one of tokens and embeddings")
        if vision_embed is None and BLOCK_CROSS in self.kinds:
            raise ValueError(f"{cfg.name} has cross-attention blocks: pass vision_embed")
        remat = self.remat if mode == "train" and torch.is_grad_enabled() else "none"
        if embeddings is not None:
            x = embeddings.to(self.param_dtype)
        elif self.tp is not None:
            x = vocab_embed(self.tp, self.embed.table, tokens, cfg.embed_scale)
        else:
            x = embed(self.embed.table, tokens, scale_by_sqrt_dim=cfg.embed_scale)
        x = x.to(self.param_dtype)
        aux = ({k: torch.zeros((), dtype=torch.float32, device=x.device) for k in AUX_KEYS}
               if cfg.moe is not None else {})
        for i, blk in enumerate(self._apps):
            kw = dict(mode=mode, cache=None if cache is None else cache[i], pos=pos,
                      use_kernel=self.use_kernel, vision_embed=vision_embed)
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
        if head != "none" and self.vocab_split():
            # every rank's vocab shard, gathered: the whole logits on each rank
            x = self.tp.gather_model(self.logits_fn(self.tp.copy_in(x)), -1)
        elif head != "none":
            x = self.logits_fn(x)
        return (x, cache, aux) if with_aux else (x, cache)


def _materialize(module: nn.Module, device, recurse: bool = True) -> None:
    """Each parameter of ``module`` still on the meta device made as zeros
    on ``device`` (what the constructor gives a norm scale or a gate; the
    weights are drawn next)."""
    mods = module.modules() if recurse else [module]
    for m in mods:
        for name, p in list(m._parameters.items()):
            if p is not None and p.is_meta:
                m._parameters[name] = nn.Parameter(torch.zeros(p.shape, dtype=p.dtype,
                                                               device=device))
