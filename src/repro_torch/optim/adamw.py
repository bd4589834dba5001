"""Optimizers: AdamW, factored-second-moment AdamW, 8-bit-state AdamW.

Port of ``repro.optim.adamw``. Parameters, gradients and the per-parameter
state are dicts keyed by parameter name (``LM.named_parameters()``); the math
is fp32, step for step that of the JAX package:

  adamw           : 2 x f32 moments                              (8 bytes/param)
  adamw_factored  : f32 row + col second moment, bf16 first moment (~2 B/param)
  adamw_8bit      : int8 moments + per-block f32 scales            (~2 B/param)

``apply_updates`` writes the new values into the parameter tensors in place
(they are the model's own, and a copy of 2.6B parameters would not fit beside
the state); the state dict is returned anew. On a mesh the same body updates
a shard (``Shards``: the sharded step sums the factored statistics over the
mesh, and moves an 8-bit state between its placement and the shard's layout;
everything else is elementwise on the shard).

The JAX package stacks a segment's layers on a leading units axis, and the
port keeps one tensor a layer; ``leaves`` (``transformer.stacked_leaves``)
names each layer's stacked JAX leaf. ``adamw`` is elementwise and the same
either way, and so is a leaf of 2+ dims a layer, whose two trailing dims
both packages factor a layer at a time. Two stacked leaves mix their layers
(``stacks``): a (units, d) leaf of per-layer vectors, which
``adamw_factored`` factors over units and d, and a leaf whose layer's numel
the 8-bit block does not divide, whose blocks span two layers. Those are
updated as the JAX leaf (``update_stack``), and their state is the JAX
leaf's (``tree_layout``): each member holds its row of ``mu`` and its entry
of ``nu_row``, the first also ``nu_col``; or the first holds the blocks of
the layers laid end to end, the others nothing.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

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
    amax = flat.abs().amax(dim=1, keepdim=True)
    # a tensor, not a number: CUDA multiplies by a number's reciprocal, an ulp off
    scale = torch.clamp(amax / amax.new_tensor(127.0), min=1e-12)
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


def state_layout(cfg: OptimizerConfig, shape) -> Dict[str, Tuple[tuple, torch.dtype, float]]:
    """Each state tensor of a leaf of ``shape``: (shape, dtype, initial
    value). The 8-bit moments start as ``_q8_encode`` of zeros: int8 zeros
    and scales at the 1e-12 floor."""
    shape = tuple(shape)
    f32 = torch.float32
    if cfg.kind == "adamw" or (cfg.kind == "adamw_factored" and _factored_dims(shape) is None):
        return {"mu": (shape, f32, 0.0), "nu": (shape, f32, 0.0)}
    if cfg.kind == "adamw_factored":
        r, c = _factored_dims(shape)
        return {"mu": (shape, torch.bfloat16, 0.0),
                "nu_row": (shape[:c] + shape[c + 1:], f32, 0.0),
                "nu_col": (shape[:r] + shape[r + 1:], f32, 0.0)}
    if cfg.kind == "adamw_8bit":
        n = -(-math.prod(shape) // cfg.block)
        q, s = ((n, cfg.block), torch.int8, 0.0), ((n, 1), f32, 1e-12)
        return {"mu_q": q, "mu_s": s, "nu_q": q, "nu_s": s}
    raise ValueError(cfg.kind)


def _layer(name: str) -> int:
    return int(name.split(".")[1])


def stacks(cfg: OptimizerConfig, shapes: Dict[str, tuple],
           leaves: Dict[str, str]) -> Dict[str, List[str]]:
    """The stacked JAX leaves that ``cfg``'s optimizer updates as one:
    {JAX leaf: its members, in layer order}. ``shapes``: each parameter's
    whole shape; ``leaves``: the stacked JAX leaf of each parameter the JAX
    package stacks. ``adamw_factored`` takes the leaves of per-layer vectors
    ((units, d) in JAX, factored over both dims; a one-layer leaf too), and
    ``adamw_8bit`` the leaves whose layer's numel the block does not divide
    (a layer's blocks are otherwise a slice of the leaf's)."""
    if cfg.kind == "adamw_factored":
        def joint(shape):
            return len(shape) == 1
    elif cfg.kind == "adamw_8bit":
        def joint(shape):
            return math.prod(shape) % cfg.block != 0
    else:
        return {}
    out: Dict[str, List[str]] = {}
    for name, leaf in leaves.items():
        if joint(tuple(shapes[name])):
            out.setdefault(leaf, []).append(name)
    return {leaf: sorted(members, key=_layer) for leaf, members in out.items()}


def tree_layout(cfg: OptimizerConfig, shapes: Dict[str, tuple],
                leaves: Dict[str, str]) -> Dict[str, Dict[str, Tuple[tuple, torch.dtype, float]]]:
    """``state_layout`` of each parameter of whole ``shapes``, where the
    members of a stacked leaf updated as one (``stacks``) hold the JAX
    leaf's state: a factored member its bf16 row of ``mu`` and its float32
    entry of ``nu_row``, the first also the leaf's ``nu_col``; an 8-bit
    leaf's first member the blocks of its layers laid end to end, the
    others nothing."""
    out = {n: state_layout(cfg, s) for n, s in shapes.items()}
    for members in stacks(cfg, shapes, leaves).values():
        shape = tuple(shapes[members[0]])
        whole = state_layout(cfg, (len(members),) + shape)
        if cfg.kind == "adamw_factored":
            for n in members:
                out[n] = {"mu": (shape, whole["mu"][1], 0.0), "nu_row": ((), torch.float32, 0.0)}
            out[members[0]]["nu_col"] = whole["nu_col"]
        else:
            for n in members:
                out[n] = {}
            out[members[0]] = whole
    return out


def init_state(cfg: OptimizerConfig, params: Dict[str, torch.Tensor], leaves: Dict[str, str]):
    """The zero state of ``params`` (whole tensors) under ``tree_layout``."""
    layout = tree_layout(cfg, {n: tuple(p.shape) for n, p in params.items()}, leaves)
    device = next(iter(params.values())).device if params else None
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "m": {name: {k: torch.full(shape, fill, dtype=dt, device=params[name].device)
                         for k, (shape, dt, fill) in layout[name].items()}
                  for name in params}}


# ---------------------------------------------------------------------------
# Update
# ---------------------------------------------------------------------------

class Shards:
    """How a parameter tensor relates to the whole leaf whose factored
    statistics it updates: on one device it is the leaf, and this class is
    the identity. The sharded step (``train/steps.py``) passes one whose
    methods sum and gather over the mesh. ``shape`` is the whole leaf's."""

    def __init__(self, shape):
        self.shape = tuple(shape)

    def row_sums(self, part: torch.Tensor) -> torch.Tensor:
        """The shard's sums over its columns -> the whole leaf's row sums."""
        return part

    def col_sums(self, part: torch.Tensor) -> torch.Tensor:
        """The shard's sums over its rows -> the whole leaf's column sums."""
        return part

    def rows(self, whole: torch.Tensor) -> torch.Tensor:
        """A whole (..., rows) statistic -> the shard's part of it."""
        return whole

    def cols(self, whole: torch.Tensor) -> torch.Tensor:
        """A whole (..., cols) statistic -> the shard's part of it."""
        return whole

    def decode(self, q: torch.Tensor, scale: torch.Tensor, block: int) -> torch.Tensor:
        """An 8-bit moment as its state holds it (codes (n, block), scales
        (n, 1)) -> its values in this tensor's layout, fp32."""
        return _q8_decode(q, scale, self.shape, block)

    def encode(self, x: torch.Tensor, block: int):
        """A moment in this tensor's layout, fp32 -> its 8-bit state as it is
        held (codes, scales)."""
        return _q8_encode(x, block)


def _new_param(cfg: OptimizerConfig, p, mu, nu, lr, step):
    """Bias correction, the update and the decay: p's new value in its dtype."""
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32) + 1.0
    mu_hat = mu / (1 - b1 ** t)
    nu_hat = nu / (1 - b2 ** t)
    upd = mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
    decay = cfg.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * (upd + decay)).to(p.dtype)


def _rows_of(t: torch.Tensor):
    """The leading indices a leaf of 3+ dims is updated at, one at a time;
    a 2-D leaf is one piece."""
    return range(t.shape[0]) if t.dim() > 2 else [None]


def _at(t: torch.Tensor, i):
    return t if i is None else t[i]


def _factored_update(cfg: OptimizerConfig, p, g, st, lr, step, shards: Shards):
    """The factored update of ``p`` in place; returns its new state. The
    second moment's row and column means are of the whole leaf: ``shards``
    turns this tensor's partial sums into the whole leaf's, and the whole
    statistics into this tensor's rows and columns. A leaf of 3+ dims (the
    MoE experts) is factored over its two trailing dims, each leading index
    on its own, and updated an index at a time (the fp32 temporaries of a
    whole deepseek expert tensor would be 5 GB each)."""
    b1, b2 = cfg.b1, cfg.b2
    idx = _rows_of(p)
    row_part, col_part = [], []
    for i in idx:
        g2 = torch.square(_at(g, i).to(torch.float32)) + 1e-30
        row_part.append(torch.sum(g2, dim=-1))
        col_part.append(torch.sum(g2, dim=-2))
        del g2
    row_part = row_part[0] if idx == [None] else torch.stack(row_part)
    col_part = col_part[0] if idx == [None] else torch.stack(col_part)
    height, width = shards.shape[-2:]
    nu_row = b2 * st["nu_row"] + (1 - b2) * (shards.row_sums(row_part) / width)
    nu_col = b2 * st["nu_col"] + (1 - b2) * (shards.col_sums(col_part) / height)
    row_mean = torch.mean(nu_row, dim=-1, keepdim=True)
    rows, cols = shards.rows(nu_row), shards.cols(nu_col)
    means = shards.rows(row_mean.expand(nu_row.shape))[..., :1]
    new_mu = torch.empty_like(st["mu"])
    for i in idx:
        mu = b1 * _at(st["mu"], i).to(torch.float32) + (1 - b1) * _at(g, i).to(torch.float32)
        nu = (_at(rows, i).unsqueeze(-1) * _at(cols, i).unsqueeze(-2)
              / torch.clamp(_at(means, i).unsqueeze(-1), min=1e-30))
        _at(p, i).copy_(_new_param(cfg, _at(p, i), mu, nu, lr, step))
        _at(new_mu, i).copy_(mu)
    return {"mu": new_mu, "nu_row": nu_row, "nu_col": nu_col}


@torch.no_grad()
def update_leaf(cfg: OptimizerConfig, p, g, st, lr, step, shards: Optional[Shards] = None):
    """One leaf's step: writes ``p``'s new value in place and returns its
    new state; ``shards`` as ``apply_updates`` takes it (a factored or an
    8-bit leaf's; absent, the leaf is whole). The 8-bit
    branch pops the old moments out of ``st`` as it decodes them, so that a
    caller that hands over its only reference holds the old and the new
    int8 state no longer than it must."""
    shards = shards or Shards(p.shape)
    if "nu_row" in st:  # factored
        return _factored_update(cfg, p, g, st, lr, step, shards)
    b1, b2 = cfg.b1, cfg.b2
    if "mu_q" in st:  # 8-bit: a block spans the flattened leaf (``Shards.decode``)
        g = g.to(torch.float32)
        mu = b1 * shards.decode(st.pop("mu_q"), st.pop("mu_s"), cfg.block) + (1 - b1) * g
        nu = (b2 * shards.decode(st.pop("nu_q"), st.pop("nu_s"), cfg.block)
              + (1 - b2) * torch.square(g))
        mq, ms = shards.encode(mu, cfg.block)
        nq, ns = shards.encode(nu, cfg.block)
        p.copy_(_new_param(cfg, p, mu, nu, lr, step))
        return {"mu_q": mq, "mu_s": ms, "nu_q": nq, "nu_s": ns}
    new_st = {k: torch.empty_like(v) for k, v in st.items()}
    for i in _rows_of(p):   # elementwise: a leaf of 3+ dims an index at a time
        gi = _at(g, i).to(torch.float32)
        mu = b1 * _at(st["mu"], i) + (1 - b1) * gi
        nu = b2 * _at(st["nu"], i) + (1 - b2) * torch.square(gi)
        _at(p, i).copy_(_new_param(cfg, _at(p, i), mu, nu, lr, step))
        _at(new_st["mu"], i).copy_(mu)
        _at(new_st["nu"], i).copy_(nu)
    return new_st


@torch.no_grad()
def update_stack(cfg: OptimizerConfig, params, grads, states, lr, step,
                 shards: Optional[Shards] = None):
    """One stacked JAX leaf's step (``stacks``), its members' ``params``,
    ``grads`` and ``states`` in layer order: writes each member's new value
    in place and returns their new states. The factored update runs on the
    members stacked into the (units, d) leaf, ``shards`` as ``update_leaf``
    takes it for that stack; the 8-bit one on their values laid end to end,
    whole (a leaf of one member on its own flattened view). The 8-bit update
    pops the old moments out of ``states[0]`` as ``update_leaf`` does."""
    if cfg.kind == "adamw_factored":
        p, g = torch.stack(params), torch.stack(grads)
        st = {"mu": torch.stack([s["mu"] for s in states]),
              "nu_row": torch.stack([s["nu_row"] for s in states]),
              "nu_col": states[0]["nu_col"]}
        new = update_leaf(cfg, p, g, st, lr, step, shards)
        out = [{"mu": new["mu"][i].clone(), "nu_row": new["nu_row"][i].clone()}
               for i in range(len(params))]
        out[0]["nu_col"] = new["nu_col"]
        rows = p.unbind()
    else:
        def flat(ts):
            return ts[0].reshape(-1) if len(ts) == 1 else torch.cat([t.reshape(-1) for t in ts])
        p = flat(params)
        out = [{} for _ in params]
        out[0] = update_leaf(cfg, p, flat(grads), states[0], lr, step)
        rows = p.split([x.numel() for x in params])
    for x, row in zip(params, rows):
        if row.data_ptr() != x.data_ptr():     # not a view of the member itself
            x.copy_(row.view(x.shape))
    return out


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params: Dict[str, torch.Tensor],
                  grads: Dict[str, torch.Tensor], state, lr, leaves: Dict[str, str],
                  shards: Optional[Dict[str, Shards]] = None):
    """One AdamW step. Writes the new values into ``params`` in place and
    returns (params, new state); ``state["step"]`` counts the updates. A leaf
    of three or more dims with float moments (the MoE expert tensors) is
    updated a leading index at a time; the members of a stacked leaf that
    the optimizer updates as one (``stacks`` of ``leaves``) together
    (``update_stack``). ``shards``: on a mesh, each factored or 8-bit leaf's
    ``Shards``, by parameter name or, for a stack, by its JAX leaf
    (``params`` then hold shards); absent, every leaf is whole."""
    step = state["step"]
    shards = shards or {}
    new_m = {}
    groups = stacks(cfg, {n: tuple(p.shape) for n, p in params.items()}, leaves)
    for leaf, members in groups.items():
        new_m.update(zip(members, update_stack(
            cfg, [params[n] for n in members], [grads[n] for n in members],
            [dict(state["m"][n]) for n in members], lr, step, shards.get(leaf))))
    for name, p in params.items():
        if name not in new_m:
            new_m[name] = update_leaf(cfg, p, grads[name], dict(state["m"][name]), lr, step,
                                      shards.get(name))
    return params, {"step": step + 1, "m": {n: new_m[n] for n in params}}


def state_bytes_per_param(kind: str) -> float:
    return {"adamw": 8.0, "adamw_factored": 2.1, "adamw_8bit": 2.1}[kind]
