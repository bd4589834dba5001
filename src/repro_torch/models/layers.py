"""Shared building blocks: norms, rotary embeddings, MLPs, embeddings.

Port of ``repro.models.layers``. Weights keep the JAX package's ``(in, out)``
orientation, so a projection is ``x @ w`` here as there.

A module's ``tp`` is None on one device. On a mesh it is the model's
``parallel.tensor.TensorParallel`` and the parameters are this rank's shards:
``GLUMLP`` is column-parallel in ``wi_gate``/``wi_up`` and row-parallel in
``wo``, and the embedding is vocab-parallel (``vocab_embed``; the read-out is
``LM.readout_weight`` and the loss ``models.model._chunked_ce``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import rmsnorm  # noqa: F401  (JAX apply_rmsnorm; the model's
#                                                    norms go through kernels.ops.rmsnorm)


def truncated_normal(shape, std: float, dtype, device, generator: torch.Generator):
    """Normal truncated at +-2 standard deviations, drawn in float32."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """Gemma-style ``(1 + scale)`` over the last axis; the scale starts at
    zero. Goes through ``kernels.ops.rmsnorm``: the CUDA kernel on the card
    when ``use_kernel`` is set. ``split``: the model's ``TensorParallel``
    where ``x`` holds this rank's ``1/model`` chunk of each row's columns (a
    recurrent cell on this rank's heads): the kernel's split mode, the rows'
    sums of squares summed over ``model`` and the scale's chunk applied (its
    gradient gathered, so each rank's is the whole scale's)."""

    def __init__(self, d: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x, use_kernel: bool = True, split=None):
        if split is None:
            return kops.rmsnorm(x, self.scale, self.eps, use_kernel=use_kernel)
        return kops.rmsnorm(x, split.chunk(self.scale, 0), self.eps, use_kernel=use_kernel,
                            split=kops.Split(self.scale.shape[0], split.row_sum))


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S) broadcastable."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32, device=x.device)
    angles = positions[..., :, None, None].float() * freqs        # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def act_fn(name: str):
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def glu_mlp(x, wi_gate, wi_up, wo, act: str = "silu"):
    g = act_fn(act)(x @ wi_gate.to(x.dtype))
    u = x @ wi_up.to(x.dtype)
    return (g * u) @ wo.to(x.dtype)


class GLUMLP(nn.Module):
    """The GLU FFN. On a mesh whose ``model`` axis splits d_ff, each rank
    computes its columns of the hidden layer and its rows of ``wo``
    (``forward_partial``, a partial sum) and the sum is all-reduced over
    ``model``; where d_ff does not split, the weights are gathered whole and
    every rank computes the whole FFN."""

    tp = None

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

    def sharded(self) -> bool:
        return self.tp.split_on((self.wi_gate, 1), (self.wi_up, 1), (self.wo, 0))

    def forward_partial(self, x):
        """This rank's part of the FFN of ``x`` (which has been through
        ``tp.copy_in``): to be summed over ``model``."""
        g = self.tp.gather_batch
        return glu_mlp(x, g(self.wi_gate), g(self.wi_up), g(self.wo), self.act)

    def forward(self, x):
        tp = self.tp
        if tp is None:
            return glu_mlp(x, self.wi_gate, self.wi_up, self.wo, self.act)
        if self.sharded():
            return tp.reduce_out(self.forward_partial(tp.copy_in(x)))
        return glu_mlp(x, tp.whole(self.wi_gate), tp.whole(self.wi_up), tp.whole(self.wo),
                       self.act)


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor, scale_by_sqrt_dim: bool = False):
    return _scaled(table[tokens], scale_by_sqrt_dim)


def _scaled(x, scale_by_sqrt_dim: bool):
    if scale_by_sqrt_dim:
        # the factor is rounded to x.dtype first, as the JAX package does
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype, device=x.device)
    return x


def vocab_embed(tp, table: torch.Tensor, tokens: torch.Tensor, scale_by_sqrt_dim: bool = False):
    """``embed`` on a mesh. Where ``model`` splits the vocab, each rank looks
    up the tokens its rows of the table hold, zeros elsewhere, and the rows
    are all-reduced over ``model``; else the table is gathered whole."""
    if tp.split_dim(table) != 0 or tp.size == 1:
        return embed(tp.whole(table), tokens, scale_by_sqrt_dim)
    w = tp.gather_batch(table)
    local = tokens.long() - tp.rank * w.shape[0]
    inside = (local >= 0) & (local < w.shape[0])
    x = torch.where(inside[..., None], w[torch.where(inside, local, 0)], 0)
    return _scaled(tp.reduce_out(x), scale_by_sqrt_dim)


def logits_from_embedding(table: torch.Tensor, x: torch.Tensor):
    """Tied read-out."""
    return x @ table.to(x.dtype).T


def logits_from_head(head: torch.Tensor, x: torch.Tensor):
    """Untied read-out: ``head`` is (d_model, vocab), as in the JAX package."""
    return x @ head.to(x.dtype)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
