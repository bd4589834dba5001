"""Model facade: build the LM, the loss, and the shapes and values of its inputs.

Port of ``repro.models.model`` (token and audio models, dense and MoE; the
parameter accounting is ``LM.num_params``). ``synthetic_batch`` draws token ids and frame
embeddings with numpy's ``default_rng`` exactly as the JAX package does, so a
seed gives both packages the same bytes.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.common.config import ModelConfig, RunConfig, ShapeSpec
from repro_torch.models.transformer import LM

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(run: RunConfig, device=None, use_kernel: bool = True) -> LM:
    """An ``LM`` with uninitialised weights: call ``init_weights`` or load a
    state dict (``repro_torch.convert``)."""
    return LM(run.model, param_dtype=DTYPES[run.parallel.param_dtype], device=device,
              use_kernel=use_kernel, remat=run.parallel.remat)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

CE_CHUNK = 512


def _chunked_ce(model: LM, hidden, labels, chunk: int = CE_CHUNK):
    """Mean next-token cross entropy, computed in sequence chunks so that the
    (B, S, vocab) fp32 logits never exist at once (256k vocab x 4096 tokens
    is 4 GB a sequence). Each chunk's read-out and log-softmax run under a
    checkpoint, recomputed in the backward pass; the sequence is padded to a
    whole number of chunks and the padded positions are masked."""
    b, s, _ = hidden.shape
    c = min(chunk, s)
    n = -(-s // c)
    pad = n * c - s
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
    remat = torch.is_grad_enabled()

    def nll_sum(h, lab, start: int):
        logp = torch.log_softmax(model.logits_fn(h), dim=-1)       # (B, c, V) fp32
        nll = -torch.gather(logp, -1, lab[..., None].long())[..., 0]
        posn = start + torch.arange(c, device=h.device)
        return torch.where(posn[None, :] < s, nll, 0.0).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        args = (hidden[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c], i * c)
        total = total + (checkpoint(nll_sum, *args, use_reentrant=False) if remat
                         else nll_sum(*args))
    return total / (b * s)


def model_inputs(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ``LM.forward`` keyword of a batch: its ``embeddings`` where it has
    them (the audio family), else its ``tokens``."""
    if "embeddings" in batch:
        return {"embeddings": batch["embeddings"]}
    return {"tokens": batch["tokens"]}


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


def batch_shapes(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Shapes/dtypes for one step's inputs, as (shape, dtype) tuples: token
    ids, or for the audio family frame ``embeddings`` (the stub front end's
    output) and, to train, codebook ``labels``. The vision front end is not
    ported yet."""
    b = shape.global_batch
    s_in = 1 if shape.kind == "decode" else shape.seq_len
    if cfg.family == "audio":
        d = {"embeddings": ((b, s_in, cfg.d_model), torch.bfloat16)}
        if shape.kind == "train":
            d["labels"] = ((b, s_in), torch.int32)
        return d
    return {"tokens": ((b, s_in), torch.int32)}


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
