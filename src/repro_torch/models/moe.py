"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Port of ``repro.models.moe``. Tokens are routed in groups (the batch entries;
at decode, S == 1 and B > 1, the whole batch is one group), each token to its
top-k experts. Every expert takes at most ``capacity`` tokens of a group, in
the order of a stable sort of the (token, k-slot) assignments by expert; the
rest are dropped. The kept slots are gathered into an (E, C) buffer per group,
the experts run as batched products over E, and the outputs are gathered back
and weighted by the renormalised gates. deepseek's shared experts and
arctic's dense residual are GLU MLPs over every token, added to the result.

The routing bookkeeping is integer and exact, as in the JAX package:
``lax.top_k`` takes ties toward the lower index, so the top k here are the
first k of a stable descending sort; ``argsort(..., stable=True)`` is
``torch.argsort(stable=True)``. The router is float32 whatever the model's
parameter dtype, as ``init_moe`` draws it. Under data parallelism each rank
routes its own rows, and the load-balance loss, which multiplies two means
over the whole batch, takes them over the batch ranks through the module's
``batch_mean`` (set by the sharded train step, ``train/steps.py``, around its
forward and backward).

On a mesh (``tp``, ``parallel.tensor``) the experts are split over ``model``
(EP), as the JAX package's ``_maybe_shard`` pins them: routing, ties and
capacity are computed whole on every ``model`` rank; each rank runs its E/tp
experts on its rows of the dispatch buffer, its part of the combine (zero for
the other ranks' experts) is summed over ``model``, and the shared experts
and the dense residual are column/row-parallel inside the same sum. Where
``model`` does not divide E, every rank runs every expert.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common.config import ModelConfig, MoEConfig
from repro_torch.models.layers import GLUMLP, act_fn, truncated_normal


def _same(x):
    return x


def _capacity(tokens_per_group: int, m: MoEConfig) -> int:
    c = int(tokens_per_group * m.top_k * m.capacity_factor / m.num_experts)
    return max(8, (c + 7) // 8 * 8)  # a multiple of 8, as the JAX package rounds it


def route_topk(router_w: torch.Tensor, x: torch.Tensor, m: MoEConfig,
               batch_mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
    """x: (G, S, D) -> gates (G, S, k) float32, idx (G, S, k) int64, aux
    losses (the Switch load-balance loss and the router z-loss, scaled).
    ``batch_mean`` takes the load-balance loss's per-expert means ``me`` and
    ``ce`` over the ranks that split the batch (autograd-aware)."""
    logits = x.float() @ router_w                                     # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = top[..., :m.top_k], idx[..., :m.top_k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    me = probs.mean(dim=(0, 1))                                       # (E,)
    ce = F.one_hot(idx, m.num_experts).float().sum(dim=2).mean(dim=(0, 1))
    if batch_mean is not None:
        me, ce = batch_mean(me), batch_mean(ce)
    lb_loss = m.num_experts * torch.sum(me * ce) / m.top_k
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    aux = {"moe_lb_loss": lb_loss * m.load_balance_loss,
           "moe_z_loss": z_loss * m.router_z_loss}
    return gates, idx, aux


def _dispatch_indices(idx: torch.Tensor, num_experts: int, capacity: int):
    """idx: (G, S, k) expert assignments -> for each slot of the expert-sorted
    order: its destination in an (E * C)-slot buffer (E * C, the dump slot,
    where the expert is full), whether it is kept, its source token and its
    k-slot; and the sort order. All int64."""
    g, s, k = idx.shape
    flat_e = idx.reshape(g, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)                # (G, S*k)
    sorted_e = torch.gather(flat_e, -1, order)
    counts = torch.zeros(g, num_experts, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(1, flat_e, torch.ones_like(flat_e))
    offsets = torch.cumsum(counts, dim=-1) - counts                   # exclusive
    pos = (torch.arange(s * k, device=idx.device)[None, :]
           - torch.gather(offsets, -1, sorted_e))
    valid = pos < capacity
    dest = torch.where(valid, sorted_e * capacity + pos, num_experts * capacity)
    return dest, valid, order // k, order % k, order


def _rows(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """t[g, index[g, i]] for (G, N, D) ``t`` and (G, M) ``index``."""
    return torch.gather(t, 1, index[..., None].expand(-1, -1, t.shape[-1]))


def apply_moe(moe: "MoE", cfg: ModelConfig, x: torch.Tensor,
              capacity: Optional[int] = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (B, S, D), aux losses. Groups are the batch entries."""
    m = cfg.moe
    b, s, d = x.shape
    if s == 1 and b > 1:
        # decode: the batch is one routing group (a group a token would spend
        # a whole capacity buffer on each token)
        out, aux = apply_moe(moe, cfg, x.reshape(1, b, d), capacity)
        return out.reshape(b, s, d), aux
    cap = capacity if capacity is not None else _capacity(s, m)
    e = m.num_experts
    tp = moe.tp
    ep = tp is not None and moe.experts_split()
    e0, e1, f = 0, e, _same
    if tp is None:
        router, w_gate, w_up, w_out = moe.router, moe.wi_gate, moe.wi_up, moe.wo
    elif ep:
        router = tp.whole(moe.router)
        w_gate, w_up, w_out = (tp.gather_batch(w) for w in (moe.wi_gate, moe.wi_up, moe.wo))
        (e0, e1), f = tp.units(e), tp.copy_in
    else:
        router, w_gate, w_up, w_out = (tp.whole(w) for w in
                                       (moe.router, moe.wi_gate, moe.wi_up, moe.wo))
    el = e1 - e0

    gates, idx, aux = route_topk(router, x, m, batch_mean=moe.batch_mean)
    dest, valid, token, _, order = _dispatch_indices(idx, e, cap)

    # dispatch: every slot into its row of a (G, E*C + 1, D) buffer; the
    # dropped ones all land in the last row (the dump slot), which is cut away
    xs = f(x)
    buf = torch.zeros((b, e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_(1, dest[..., None].expand(-1, -1, d), _rows(xs, token))
    expert_in = (buf[:, e0 * cap:e1 * cap].reshape(b, el, cap, d).transpose(0, 1)
                 .reshape(el, b * cap, d))

    # this rank's experts (all of them off a mesh), batched over E
    h = act_fn(cfg.act)(torch.bmm(expert_in, w_gate.to(x.dtype)))
    h = h * torch.bmm(expert_in, w_up.to(x.dtype))
    expert_out = torch.bmm(h, w_out.to(x.dtype))                      # (El, G*C, D)

    # combine: each slot's output back (zero where dropped, or where another
    # rank's expert took it), into (token, k-slot) order, weighted by the gates
    flat_out = expert_out.reshape(el, b, cap, d).transpose(0, 1).reshape(b, el * cap, d)
    flat_out = F.pad(flat_out, (0, 0, e0 * cap, (e - e1) * cap + 1))
    slot_out = _rows(flat_out, dest.clamp_max(e * cap))
    slot_out = torch.where(valid[..., None], slot_out, 0)
    inv = torch.argsort(order, dim=-1)
    slot_out = _rows(slot_out, inv).reshape(b, s, m.top_k, d)
    out = torch.einsum("gskd,gsk->gsd", slot_out, f(gates).to(x.dtype))

    later = []
    for mlp in (getattr(moe, "shared", None), getattr(moe, "dense_residual", None)):
        if mlp is None:
            continue
        if ep and mlp.sharded():
            out = out + mlp.forward_partial(xs)
        elif ep:
            later.append(mlp)
        else:
            out = out + mlp(x)
    if ep:
        out = tp.reduce_out(out)
    for mlp in later:
        out = out + mlp(x)
    return out, aux


class MoE(nn.Module):
    """The parameters of ``init_moe``: ``router`` (d_model, E) float32,
    ``wi_gate`` / ``wi_up`` (E, d_model, d_ff_expert), ``wo`` (E,
    d_ff_expert, d_model), and the GLU MLPs ``shared`` (width d_ff_expert x
    num_shared_experts) and ``dense_residual`` where the config has them.
    ``forward(x)`` returns (out, aux losses). ``batch_mean``: see
    ``route_topk``; None on one rank."""

    tp = None

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        self.batch_mean: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        m = cfg.moe
        d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
        kw = dict(dtype=dtype, device=device)
        self.router = nn.Parameter(torch.empty(d, e, dtype=torch.float32, device=device))
        self.wi_gate = nn.Parameter(torch.empty(e, d, f, **kw))
        self.wi_up = nn.Parameter(torch.empty(e, d, f, **kw))
        self.wo = nn.Parameter(torch.empty(e, f, d, **kw))
        if m.num_shared_experts:
            self.shared = GLUMLP(d, f * m.num_shared_experts, cfg.act, dtype, device)
        if m.dense_residual_d_ff:
            self.dense_residual = GLUMLP(d, m.dense_residual_d_ff, cfg.act, dtype, device)

    def init_weights(self, generator: torch.Generator) -> None:
        """Std d^-0.5 for the router and ``wi_*``, d_ff_expert^-0.5 for
        ``wo``, as ``init_moe``. The expert tensors are drawn an expert at a
        time: the float32 draw of a whole arctic expert tensor is 17.8 GB."""
        d, f = self.cfg.d_model, self.cfg.moe.d_ff_expert
        self.router.copy_(truncated_normal(self.router.shape, d ** -0.5, torch.float32,
                                           self.router.device, generator))
        for w, std in ((self.wi_gate, d ** -0.5), (self.wi_up, d ** -0.5), (self.wo, f ** -0.5)):
            for one in w:
                one.copy_(truncated_normal(one.shape, std, w.dtype, w.device, generator))
        for mlp in (getattr(self, "shared", None), getattr(self, "dense_residual", None)):
            if mlp is not None:
                mlp.init_weights(generator)

    def experts_split(self) -> bool:
        tp = self.tp
        return (self.cfg.moe.num_experts % tp.size == 0
                and tp.split_on((self.wi_gate, 0), (self.wi_up, 0), (self.wo, 0)))

    def forward(self, x: torch.Tensor):
        return apply_moe(self, self.cfg, x)
