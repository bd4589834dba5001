"""Model facade: build the LM, the loss, and the shapes and values of its inputs.

Port of ``repro.models.model`` (every family). ``count_params_analytic`` and
``input_specs`` build on the meta device (no weights, no storage), as the JAX
package uses ``jax.eval_shape`` and ``ShapeDtypeStruct``. ``synthetic_batch``
draws token ids, frame embeddings and image embeddings with numpy's
``default_rng`` exactly as the JAX package does, so a seed gives both packages
the same bytes.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.common.config import ModelConfig, RunConfig, ShapeSpec
from repro_torch.models.transformer import LM

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


ATTN_MODES = ("off", "batch", "sequence", "auto")
# the JAX package's literal in "auto" (``build_model``, ``lower_cell``): the
# production mesh's model size, not the mesh a model runs on
AUTO_KV_HEADS = 16


def attn_activation_mode(run: RunConfig) -> str:
    """``attn_activation_sharding`` resolved as the JAX package's
    ``build_model`` resolves it: "auto" is "batch" where the kv heads do not
    divide 16 and the model has no MLA, else "off"; "off", "batch" and
    "sequence" stay. Any other value is refused by name."""
    mode = run.parallel.attn_activation_sharding
    if mode == "auto":
        mode = ("batch" if run.model.n_kv_heads % AUTO_KV_HEADS != 0 and run.model.mla is None
                else "off")
    if mode not in ATTN_MODES[:-1]:
        raise ValueError(f"attn_activation_sharding {mode!r}: expected one of {ATTN_MODES}")
    return mode


def build_model(run: RunConfig, device=None, use_kernel: bool = True) -> LM:
    """An ``LM`` with uninitialised weights: call ``init_weights`` or load a
    state dict (``repro_torch.convert``). Its attention activation mode is
    the config's, resolved (``attn_activation_mode``)."""
    mode = attn_activation_mode(run)
    return LM(run.model, param_dtype=DTYPES[run.parallel.param_dtype], device=device,
              use_kernel=use_kernel, remat=run.parallel.remat,
              sp_attn="" if mode == "off" else mode)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

CE_CHUNK = 512


def _chunked_ce(model: LM, hidden, labels, chunk: int = CE_CHUNK):
    """Mean next-token cross entropy, computed in sequence chunks so that the
    (B, S, vocab) fp32 logits never exist at once (256k vocab x 4096 tokens
    is 4 GB a sequence). Each chunk's read-out and log-softmax run under a
    checkpoint, recomputed in the backward pass; the sequence is padded to a
    whole number of chunks and the padded positions are masked. The read-out
    weight is taken once for every chunk (on a mesh, gathered once over the
    batch axes). Where a mesh splits the vocab over ``model``, each chunk's
    loss is vocab-parallel: the soft-capped logits' max, their log-sum-exp
    and the label's logit are all-reduced over ``model``."""
    b, s, _ = hidden.shape
    c = min(chunk, s)
    n = -(-s // c)
    pad = n * c - s
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
    remat = torch.is_grad_enabled()
    tp = model.tp
    split = model.vocab_split()

    def nll_sum(h, lab, start: int, w):
        if split:
            nll = _vocab_parallel_nll(tp, model.logits_fn(tp.copy_in(h), w), lab)
        else:
            logp = torch.log_softmax(model.logits_fn(h, w), dim=-1)      # (B, c, V) fp32
            nll = -torch.gather(logp, -1, lab[..., None].long())[..., 0]
        posn = start + torch.arange(c, device=h.device)
        return torch.where(posn[None, :] < s, nll, 0.0).sum()

    w = model.readout_weight()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        args = (hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c], i * c, w)
        total = total + (checkpoint(nll_sum, *args, use_reentrant=False) if remat
                         else nll_sum(*args))
    return total / (b * s)


def _vocab_parallel_nll(tp, logits, labels):
    """-log softmax(logits)[label] where ``logits`` (B, c, V/tp) is this
    rank's vocab shard: the max (a constant of the backward) and the sum of
    exponentials are reduced over ``model``, and the label's logit is taken
    on the rank that holds it."""
    m = tp.max_over_model(logits.amax(dim=-1))
    sumexp = tp.reduce_out(torch.exp(logits - m[..., None]).sum(dim=-1))
    n = logits.shape[-1]
    local = labels.long() - tp.rank * n
    inside = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, torch.where(inside, local, 0)[..., None])[..., 0]
    label_logit = tp.reduce_out(torch.where(inside, picked, 0.0))
    return torch.log(sumexp) + m - label_logit


def model_inputs(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ``LM.forward`` keywords of a batch: its ``embeddings`` where it has
    them (the audio family), else its ``tokens``; and its ``vision_embed``
    where it has one (the vlm family)."""
    out = ({"embeddings": batch["embeddings"]} if "embeddings" in batch
           else {"tokens": batch["tokens"]})
    if "vision_embed" in batch:
        out["vision_embed"] = batch["vision_embed"]
    return out


def lm_loss(model: LM, batch: Dict[str, torch.Tensor]):
    """Next-token cross entropy (+ the MoE aux losses, each over n_layers);
    labels are the shifted tokens unless the batch has ``labels``. Returns
    (loss, metrics): ``ce_loss``, ``loss`` and each aux loss by name."""
    hidden, _, aux = model(mode="train", head="none", with_aux=True, **model_inputs(batch))
    if "labels" in batch:
        hidden_s, labels_s = hidden, batch["labels"]
    else:
        tokens = batch["tokens"]
        hidden_s, labels_s = hidden[:, :-1], tokens[:, 1:]
    loss = _chunked_ce(model, hidden_s, labels_s)
    metrics = {"ce_loss": loss}
    for k, v in aux.items():
        loss = loss + v / max(model.cfg.n_layers, 1)
        metrics[k] = v
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Parameter accounting
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _param_shapes(cfg: ModelConfig) -> Tuple[Tuple[str, Tuple[int, ...]], ...]:
    model = LM(cfg, device="meta")
    return tuple((name, tuple(p.shape)) for name, p in model.named_parameters())


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count of the model built on the meta device.
    ``active_only`` scales a tensor under ``moe`` named ``wi_gate``, ``wi_up``
    or ``wo`` (the shared experts' and the dense residual's too, as the JAX
    package does) to the activated expert fraction, top_k / num_experts."""
    total = 0
    for name, shape in _param_shapes(cfg):
        n = math.prod(shape)
        parts = name.split(".")
        if (active_only and cfg.moe is not None and "moe" in parts
                and any(k in ("wi_gate", "wi_up", "wo") for k in parts)):
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n
    return total


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def batch_shapes(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Shapes/dtypes for one step's inputs, as (shape, dtype) tuples, in the
    JAX package's order: token ids, or for the audio family frame
    ``embeddings`` (the stub front end's output) and, to train, codebook
    ``labels``; then, where the model has cross blocks, the image patch
    embeddings ``vision_embed`` (the stub vision tower's output, the same
    in every mode)."""
    b = shape.global_batch
    s_in = 1 if shape.kind == "decode" else shape.seq_len
    d: Dict[str, Any] = {}
    if cfg.family == "audio":
        d["embeddings"] = ((b, s_in, cfg.d_model), torch.bfloat16)
        if shape.kind == "train":
            d["labels"] = ((b, s_in), torch.int32)
    else:
        d["tokens"] = ((b, s_in), torch.int32)
    if cfg.cross_attn_every:
        d["vision_embed"] = ((b, cfg.vision_seq_len, cfg.vision_d_model), torch.bfloat16)
    return d


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, torch.Tensor]:
    """Every input of one step as a tensor on the meta device (shape and
    dtype, no storage): the counterpart of the JAX package's
    ``ShapeDtypeStruct`` stand-ins, used by the dry run."""
    return {k: torch.empty(s, dtype=dt, device="meta")
            for k, (s, dt) in batch_shapes(cfg, shape).items()}


def synthetic_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0, device=None):
    """Concrete random batch (for smoke tests / examples). Floats are drawn
    in float64 and rounded on the host, through float32, as the JAX
    package's ``jnp.asarray(..., bfloat16)`` rounds them."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dt) in batch_shapes(cfg, shape).items():
        if dt == torch.int32:
            vals = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=shp).astype(np.int32))
        else:
            vals = torch.from_numpy(rng.normal(0, 1, size=shp)).to(dt)
        out[k] = vals.to(dev)
    return out
