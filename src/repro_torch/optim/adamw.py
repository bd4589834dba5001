"""Optimizers: AdamW, factored-second-moment AdamW, 8-bit-state AdamW.

Port of ``repro.optim.adamw``. Parameters, gradients and the per-parameter
state are dicts keyed by parameter name (``LM.named_parameters()``); the math
is fp32, step for step that of the JAX package:

  adamw           : 2 x f32 moments                              (8 bytes/param)
  adamw_factored  : f32 row + col second moment, bf16 first moment (~2 B/param)
  adamw_8bit      : int8 moments + per-block f32 scales            (~2 B/param)

``apply_updates`` writes the new values into the parameter tensors in place
(they are the model's own, and a copy of 2.6B parameters would not fit beside
the state); the state dict is returned anew. The JAX package stacks a
segment's layers on a leading axis and the port keeps one tensor per layer:
``adamw`` is elementwise and the same either way, while ``adamw_factored`` and
``adamw_8bit`` factor or quantise each layer's tensor on its own, where a
stacked JAX leaf mixes layers (a stacked (L, d) norm scale is factored over L
and d, and an 8-bit block may span two layers).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"              # adamw | adamw_factored | adamw_8bit
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    block: int = 256                 # 8-bit quantisation block


# ---------------------------------------------------------------------------
# Schedules & clipping
# ---------------------------------------------------------------------------

def warmup_cosine(step, *, base_lr: float, warmup: int, total: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up then cosine decay to ``min_ratio * base_lr``, in fp32.
    ``step`` 0 trains at ``base_lr / warmup``. A tensor ``step`` keeps the
    result on its device."""
    step = torch.as_tensor(step).to(torch.float32) + 1.0
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup, warm, cos)


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tree.values()])))


def clip_by_global_norm(tree: Dict[str, torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None):
    """Scale every leaf by min(1, max_norm / norm). Returns (tree, norm).
    ``norm`` defaults to ``global_norm(tree)``; a tree of shards passes the
    norm of the whole tree."""
    if norm is None:
        norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (x.float() * scale).to(x.dtype) for k, x in tree.items()}, norm


# ---------------------------------------------------------------------------
# 8-bit moment storage
# ---------------------------------------------------------------------------

def _q8_encode(x: torch.Tensor, block: int):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % block
    flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, block)
    scale = torch.clamp(flat.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    # torch.round rounds half to even, as jnp.round does
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _q8_decode(q: torch.Tensor, scale: torch.Tensor, shape, block: int):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(shape)].reshape(shape)


# ---------------------------------------------------------------------------
# State init
# ---------------------------------------------------------------------------

def _factored_dims(shape) -> Optional[Tuple[int, int]]:
    if len(shape) < 2:
        return None
    # factor the two trailing dims
    return len(shape) - 2, len(shape) - 1


def init_state(cfg: OptimizerConfig, params: Dict[str, torch.Tensor]):
    def leaf(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if cfg.kind == "adamw":
            return {"mu": torch.zeros(p.shape, **f32), "nu": torch.zeros(p.shape, **f32)}
        if cfg.kind == "adamw_factored":
            dims = _factored_dims(p.shape)
            if dims is None:
                return {"mu": torch.zeros(p.shape, **f32), "nu": torch.zeros(p.shape, **f32)}
            r, c = dims
            row_shape = tuple(d for i, d in enumerate(p.shape) if i != c)
            col_shape = tuple(d for i, d in enumerate(p.shape) if i != r)
            return {"mu": torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device),
                    "nu_row": torch.zeros(row_shape, **f32),
                    "nu_col": torch.zeros(col_shape, **f32)}
        if cfg.kind == "adamw_8bit":
            q, s = _q8_encode(torch.zeros(p.shape, **f32), cfg.block)
            return {"mu_q": q, "mu_s": s, "nu_q": q.clone(), "nu_s": s.clone()}
        raise ValueError(cfg.kind)

    device = next(iter(params.values())).device if params else None
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": {name: leaf(p) for name, p in params.items()}}


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------

def _adam_update(cfg: OptimizerConfig, p, g, st, lr, step):
    """Returns (new parameter value in p's dtype, new state of the leaf)."""
    g = g.to(torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    if "nu_row" in st:  # factored
        r, c = _factored_dims(p.shape)
        mu = b1 * st["mu"].to(torch.float32) + (1 - b1) * g
        g2 = torch.square(g) + 1e-30
        nu_row = b2 * st["nu_row"] + (1 - b2) * torch.mean(g2, dim=c)
        nu_col = b2 * st["nu_col"] + (1 - b2) * torch.mean(g2, dim=r)
        row_mean = torch.mean(nu_row, dim=-1, keepdim=True)
        nu = (nu_row.unsqueeze(c) * nu_col.unsqueeze(r)
              / torch.clamp(row_mean.unsqueeze(c), min=1e-30))
        new_st = {"mu": mu.to(torch.bfloat16), "nu_row": nu_row, "nu_col": nu_col}
    elif "mu_q" in st:  # 8-bit
        mu_prev = _q8_decode(st["mu_q"], st["mu_s"], p.shape, cfg.block)
        nu_prev = _q8_decode(st["nu_q"], st["nu_s"], p.shape, cfg.block)
        mu = b1 * mu_prev + (1 - b1) * g
        nu = b2 * nu_prev + (1 - b2) * torch.square(g)
        mq, ms = _q8_encode(mu, cfg.block)
        nq, ns = _q8_encode(nu, cfg.block)
        new_st = {"mu_q": mq, "mu_s": ms, "nu_q": nq, "nu_s": ns}
    else:
        mu = b1 * st["mu"] + (1 - b1) * g
        nu = b2 * st["nu"] + (1 - b2) * torch.square(g)
        new_st = {"mu": mu, "nu": nu}

    t = step.to(torch.float32) + 1.0
    mu_hat = mu / (1 - b1 ** t)
    nu_hat = nu / (1 - b2 ** t)
    upd = mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
    decay = cfg.weight_decay * p.to(torch.float32)
    new_p = (p.to(torch.float32) - lr * (upd + decay)).to(p.dtype)
    return new_p, new_st


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state, lr):
    """One AdamW step. Writes the new values into ``params`` in place and
    returns (params, new state); ``state["step"]`` counts the updates. A leaf
    of three or more dims with float moments (the MoE expert tensors) is
    updated a leading index at a time: its factored statistics are over the
    two trailing dims, so each index is independent, and the fp32
    temporaries of a whole deepseek expert tensor would be 5 GB each."""
    step = state["step"]
    new_m = {}
    for name, p in params.items():
        g, st = grads[name], state["m"][name]
        if p.dim() < 3 or "mu_q" in st:
            new_p, new_m[name] = _adam_update(cfg, p, g, st, lr, step)
            p.copy_(new_p)
            continue
        new_m[name] = {k: torch.empty_like(v) for k, v in st.items()}
        for i in range(p.shape[0]):
            new_p, new_st = _adam_update(cfg, p[i], g[i], {k: v[i] for k, v in st.items()},
                                         lr, step)
            p[i].copy_(new_p)
            for k, v in new_st.items():
                new_m[name][k][i] = v
    return params, {"step": step + 1, "m": new_m}


def state_bytes_per_param(kind: str) -> float:
    return {"adamw": 8.0, "adamw_factored": 2.1, "adamw_8bit": 2.1}[kind]
