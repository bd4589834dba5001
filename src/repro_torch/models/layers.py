"""Shared building blocks: norms, rotary embeddings, MLPs, embeddings.

Port of ``repro.models.layers``. Weights keep the JAX package's ``(in, out)``
orientation, so a projection is ``x @ w`` here as there.
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
    when ``use_kernel`` is set."""

    def __init__(self, d: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.zeros(d, dtype=dtype, device=device))

    def forward(self, x, use_kernel: bool = True):
        return kops.rmsnorm(x, self.scale, self.eps, use_kernel=use_kernel)


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


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor, scale_by_sqrt_dim: bool = False):
    x = table[tokens]
    if scale_by_sqrt_dim:
        # the factor is rounded to x.dtype first, as the JAX package does
        x = x * torch.tensor(x.shape[-1] ** 0.5, dtype=x.dtype, device=x.device)
    return x


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
