"""GPipe pipeline parallelism over one mesh axis.

Port of ``repro.parallel.pipeline``. Stage i is the rank at coordinate i of
``axis_name``; microbatches stream through the stages point to point, plain
GPipe: fill, steady state, drain, ``n_micro + n_stages - 1`` ticks. No train
path calls it; it is the building block for pipelining over the slow axis.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def _select(tree, i: int):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_select(t, i) for t in tree)
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    return tree[i]


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor], stacked_params,
                     microbatches: torch.Tensor, mesh, axis_name: str = "pod") -> torch.Tensor:
    """Run ``microbatches`` (n_micro, ...) through the stages of
    ``axis_name``. ``stacked_params``: a tree (tuples, lists, dicts) of
    tensors with a leading (n_stages, ...) dim; stage i applies
    ``stage_fn(its slice, x)``, which keeps x's shape and dtype. Stage 0
    takes microbatch t at tick t and zeros in the drain; each tick's output
    goes to the next stage. Returns the last stage's (n_micro, ...)
    outputs on every rank."""
    import torch.distributed as dist
    group = mesh.get_group(axis_name)
    n_stages = dist.get_world_size(group)
    idx = dist.get_rank(group)
    params = _select(stacked_params, idx)
    n_micro = microbatches.shape[0]
    outs = torch.zeros_like(microbatches)
    recv = torch.zeros_like(microbatches[0])
    nxt = dist.get_global_rank(group, idx + 1) if idx + 1 < n_stages else None
    prv = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    for t in range(n_micro + n_stages - 1):
        if idx == 0:
            inp = microbatches[t] if t < n_micro else torch.zeros_like(microbatches[0])
        else:
            inp = recv
        out = stage_fn(params, inp)
        if t >= n_stages - 1:
            outs[t - (n_stages - 1)] = out
        # stream the activations one stage forward
        ops = []
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, out.contiguous(), nxt, group))
        if prv is not None:
            recv = torch.empty_like(microbatches[0])
            ops.append(dist.P2POp(dist.irecv, recv, prv, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    # the last stage's outputs to every stage
    dist.broadcast(outs, src=dist.get_global_rank(group, n_stages - 1), group=group)
    return outs
