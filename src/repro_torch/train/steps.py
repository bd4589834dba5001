"""Train and serve steps.

Port of ``repro.train.steps``. ``make_train_step`` builds the BSP superstep:
microbatched gradient accumulation, the int8 lossy stage with error feedback
(``grad_compression="int8"``; the residual rides in the optimizer state as
``ef``), global-norm clipping, the schedule and the optimizer update.
``make_prefill_step`` / ``make_decode_step`` build the serving path; they run
under ``torch.no_grad`` and update the KV cache in place and return it, so the
call sites read like the JAX ones.

Given a ``DeviceMesh``, ``make_train_step`` builds the sharded step: data
parallelism with the JAX package's storage placements. Each parameter's
master copy, its AdamW moments and its ``ef`` residual are DTensors placed by
``parallel.sharding.param_specs`` (FSDP over ``data``, TP and EP over
``model``). Before the forward each master is gathered into the model's
ordinary parameter, so the model never sees a DTensor; each rank takes its
share of every global microbatch (``local_batch``); the gradients are
averaged over the batch axes onto the placements, and a dim over ``model`` is
sliced without a reduction, since ranks along ``model`` hold the same rows.
Plain ``adamw`` then updates each shard; ``adamw_factored`` and
``adamw_8bit`` take row and column means or blocks of the flattened leaf, so
they update the gathered leaf from replicated state and keep their shard.
Activations are not split over heads or experts: there is no TP or EP
compute. The metrics, the MoE load-balance statistics, the int8 ``amax`` and
the global norm are those of the whole batch and the whole leaf, as GSPMD
computes them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.common import torch_compat
from repro_torch.common.config import RunConfig
from repro_torch.models import moe
from repro_torch.models.model import DTYPES, lm_loss, model_inputs
from repro_torch.models.transformer import stack_positions
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.compression import ErrorFeedback, roundtrip_int8


def _split_microbatches(batch: Dict[str, torch.Tensor], k: int) -> List[Dict[str, torch.Tensor]]:
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"global batch {b} does not split into {k} microbatches")
    return [{name: v[i * (b // k):(i + 1) * (b // k)] for name, v in batch.items()}
            for i in range(k)]


def make_grad_fn(model, run: RunConfig):
    """Returns accumulate(params, batch) -> (loss, metrics, grads), the
    gradient half of the train step. ``params`` is
    ``dict(model.named_parameters())``. With k = ``microbatches`` > 1 the
    gradients of the k microbatches are summed in ``grad_accum_dtype`` and
    divided by k, and the loss is the mean; the metrics are the last
    microbatch's. With k = 1 the gradients keep the parameters' dtype."""
    k = max(run.parallel.microbatches, 1)
    acc_dtype = DTYPES[run.parallel.grad_accum_dtype]

    def grads_of(params, batch):
        for p in params.values():       # no gradient left by an earlier backward
            p.grad = None
        loss, metrics = lm_loss(model, batch)
        loss.backward()
        grads = {}
        for name, p in params.items():
            grads[name], p.grad = p.grad, None
        return loss.detach(), {m: v.detach() for m, v in metrics.items()}, grads

    def accumulate(params, batch):
        if k == 1:
            return grads_of(params, batch)
        acc = {n: torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
               for n, p in params.items()}
        loss_sum = 0.0
        for one in _split_microbatches(batch, k):
            loss, metrics, g = grads_of(params, one)
            for n, a in acc.items():
                a += g[n].to(acc_dtype)
            del g
            loss_sum = loss_sum + loss
        for a in acc.values():        # in place: the accumulator is the gradient
            a /= k
        return loss_sum / k, metrics, acc

    return accumulate


def int8_groups(model) -> Dict[str, str]:
    """The JAX leaf of each parameter: the JAX package quantises a leaf with
    one scale, and it stacks the layers of a segment's unit position on one
    leaf, so ``blocks.<layer>.<path>`` of every layer at one (segment,
    position) share a group; any other parameter is a group of its own."""
    where = stack_positions(model.cfg)
    groups = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            seg, pos = where[int(parts[1])]
            groups[name] = f"segment{seg}.unit{pos}." + ".".join(parts[2:])
        else:
            groups[name] = name
    return groups


def _group_max(amax: Dict[str, torch.Tensor], groups: Dict[str, str]) -> Dict[str, torch.Tensor]:
    members: Dict[str, List[str]] = {}
    for name in amax:
        members.setdefault(groups[name], []).append(name)
    top = {g: torch.stack([amax[n] for n in ns]).max() for g, ns in members.items()}
    return {name: top[groups[name]] for name in amax}


def _compress(grads, resid, groups, reduce_max=None):
    """The int8 stage: error feedback around the round trip, each leaf at
    the scale of its JAX leaf (``int8_groups``); ``reduce_max`` takes the
    per-leaf maxima over the shards of a mesh."""
    if resid is None:
        resid = ErrorFeedback.init(grads)
    amax = {name: (g.float() + resid[name]).abs().max() for name, g in grads.items()}
    if reduce_max is not None:
        amax = dict(zip(amax, reduce_max(list(amax.values())).unbind()))
    amax = _group_max(amax, groups)
    return ErrorFeedback.apply(grads, resid, lambda name, x: roundtrip_int8(x, amax[name]))


def make_train_step(model, run: RunConfig, opt_cfg: adamw.OptimizerConfig, mesh=None):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is ``dict(model.named_parameters())``: the step writes the
    update into those tensors in place and returns the same dict. The
    metrics are those of ``make_grad_fn`` (the last microbatch's, as in the
    JAX package) plus ``grad_norm`` (before clipping) and ``lr``. With int8
    compression ``opt_state`` carries the residual ``ef`` (started as zeros
    where it has none) and the gradients reach the clip and AdamW in fp32,
    whatever the parameters' dtype, as in the JAX package.

    With a ``mesh``, the sharded step (module docstring): ``params`` and
    ``opt_state`` are those of ``shard_train_state`` under
    ``param_placements`` of the model's parameters, and ``batch`` is the
    global batch, the same on every rank."""
    pcfg = run.parallel
    if pcfg.grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression {pcfg.grad_compression!r}")
    if mesh is not None:
        return _make_sharded_step(model, run, opt_cfg, mesh)
    tcfg = run.train
    accumulate = make_grad_fn(model, run)
    groups = int8_groups(model)

    def step(params, opt_state, batch):
        _, metrics, grads = accumulate(params, batch)
        opt_state = dict(opt_state)
        ef = opt_state.pop("ef", None)
        if pcfg.grad_compression == "int8":
            grads, ef = _compress(grads, ef, groups)
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip_norm)
        lr = adamw.warmup_cosine(opt_state["step"], base_lr=tcfg.learning_rate,
                                 warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads, opt_state, lr)
        if ef is not None:
            opt_state["ef"] = ef
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return step


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

def batch_coordinate(mesh) -> Tuple[int, int]:
    """(this rank's index among the batch shards, their number): the
    coordinate over the mesh's batch axes, ``pod`` major."""
    rank, n = 0, 1
    for name, c, size in zip(mesh.mesh_dim_names, mesh.get_coordinate(), mesh.mesh.shape):
        if name in shd.BATCH_AXES:
            rank, n = rank * size + c, n * size
    return rank, n


def local_batch(batch: Dict[str, torch.Tensor], k: int, rank: int, n: int):
    """This rank's share of each of the ``k`` global microbatches, in order:
    the JAX package splits the global batch into microbatches and GSPMD then
    shards each over the batch axes. A batch that k * n does not divide is
    replicated, as ``batch_specs`` leaves it."""
    b = next(iter(batch.values())).shape[0]
    if b % (k * n):
        return batch
    m = b // k
    share = m // n
    return {name: v.reshape((k, m) + v.shape[1:])[:, rank * share:(rank + 1) * share]
            .reshape((k * share,) + v.shape[1:]) for name, v in batch.items()}


def _elementwise(opt_cfg: adamw.OptimizerConfig) -> bool:
    return opt_cfg.kind == "adamw"


def shard_train_state(params: Dict[str, torch.Tensor], opt_state, opt_cfg: adamw.OptimizerConfig,
                      mesh, placements: Dict[str, list]):
    """Full parameters and optimizer state (every rank the same) -> the
    sharded step's (params, opt_state): each parameter, its ``adamw`` moments
    and its ``ef`` residual a DTensor under its placements; the factored and
    8-bit statistics stay whole on every rank."""
    masters = {n: shd.shard_tensor(p.detach(), mesh, placements[n]) for n, p in params.items()}
    state = dict(opt_state)
    if _elementwise(opt_cfg):
        state["m"] = {n: {k: shd.shard_tensor(v, mesh, placements[n]) for k, v in st.items()}
                      for n, st in opt_state["m"].items()}
    if "ef" in state:
        state["ef"] = {n: shd.shard_tensor(v, mesh, placements[n])
                       for n, v in opt_state["ef"].items()}
    return masters, state


def gather(tree):
    """A tree with each DTensor replaced by its full tensor (a collective:
    every rank calls it)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    return tree.full_tensor() if isinstance(tree, DTensor) else tree


def _make_sharded_step(model, run: RunConfig, opt_cfg: adamw.OptimizerConfig, mesh):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    pcfg, tcfg = run.parallel, run.train
    accumulate = make_grad_fn(model, run)
    model_params = dict(model.named_parameters())
    placements = shd.param_placements(model_params, mesh)
    moes = [m for m in model.modules() if isinstance(m, moe.MoE)]
    k = max(pcfg.microbatches, 1)
    rank, n_batch = batch_coordinate(mesh)
    world = dist.get_world_size()
    names = mesh.mesh_dim_names
    grad_pl = [Partial("avg") if a in shd.BATCH_AXES else Replicate() for a in names]
    sharded_on = [[isinstance(placements[n][i], Shard) for n in model_params]
                  for i in range(len(names))]
    groups = int8_groups(model)

    # ranks along ``model`` hold the same rows, so a mean over the world is
    # the mean over the batch axes
    def world_mean(t):
        return torch_compat.autograd_all_reduce(t) / world

    def reduce_stack(values: List[torch.Tensor], op) -> torch.Tensor:
        v = torch.stack(values)
        dist.all_reduce(v, op=op)
        return v

    def global_norm(grads):
        """Each leaf's sum of squares summed over the mesh dims that shard
        it, so that a replicated shard is counted once."""
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in grads.values()])
        for i, flags in enumerate(sharded_on):
            if any(flags):
                mask = torch.tensor(flags, device=sq.device)
                part = torch.where(mask, sq, 0.0)
                dist.all_reduce(part, group=mesh.get_group(i))
                sq = torch.where(mask, part, sq)
        return torch.sqrt(torch.sum(sq))

    def step(params, opt_state, batch):
        with torch.no_grad():
            for name, p in model_params.items():
                p.copy_(params[name].full_tensor())
        for m in moes:          # the load-balance loss of the whole batch
            m.batch_mean = world_mean
        try:
            _, metrics, grads = accumulate(model_params, local_batch(batch, k, rank, n_batch))
        finally:
            for m in moes:
                m.batch_mean = None
        grads = {name: DTensor.from_local(g, mesh, grad_pl).redistribute(mesh, placements[name])
                 .to_local() for name, g in grads.items()}
        keys = list(metrics)
        means = reduce_stack([metrics[m].float() for m in keys], dist.ReduceOp.SUM) / world
        metrics = dict(zip(keys, means.unbind()))

        opt_state = dict(opt_state)
        ef = opt_state.pop("ef", None)
        resid = None if ef is None else {name: r.to_local() for name, r in ef.items()}
        if pcfg.grad_compression == "int8":
            # amax over the whole leaf: the max over its shards
            grads, resid = _compress(grads, resid, groups,
                                     lambda v: reduce_stack(v, dist.ReduceOp.MAX))
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip_norm,
                                                 norm=global_norm(grads))
        lr = adamw.warmup_cosine(opt_state["step"], base_lr=tcfg.learning_rate,
                                 warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        if _elementwise(opt_cfg):
            local = {name: p.to_local() for name, p in params.items()}
            local_state = dict(opt_state, m={name: {key: v.to_local() for key, v in st.items()}
                                             for name, st in opt_state["m"].items()})
            local, opt_state = adamw.apply_updates(opt_cfg, local, grads, local_state, lr)
            params = {name: DTensor.from_local(p, mesh, placements[name])
                      for name, p in local.items()}
            opt_state["m"] = {name: {key: DTensor.from_local(v, mesh, placements[name])
                                     for key, v in st.items()}
                              for name, st in opt_state["m"].items()}
        else:
            full = {name: p.full_tensor() for name, p in params.items()}
            full_g = {name: DTensor.from_local(g, mesh, placements[name]).full_tensor()
                      for name, g in grads.items()}
            full, opt_state = adamw.apply_updates(opt_cfg, full, full_g, opt_state, lr)
            params = {name: shd.shard_tensor(p, mesh, placements[name])
                      for name, p in full.items()}
        if resid is not None:
            opt_state["ef"] = {name: DTensor.from_local(r, mesh, placements[name])
                               for name, r in resid.items()}
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return step


def make_prefill_step(model):
    """prefill(batch, cache): the batch's ``tokens`` or ``embeddings``."""
    @torch.no_grad()
    def prefill(batch, cache):
        logits, cache = model(mode="prefill", cache=cache, head="last", **model_inputs(batch))
        return logits, cache
    return prefill


def make_decode_step(model):
    """decode(batch, cache, pos): the batch's ``tokens`` or ``embeddings``."""
    @torch.no_grad()
    def decode(batch, cache, pos: int):
        logits, cache = model(mode="decode", cache=cache, pos=pos, **model_inputs(batch))
        return logits, cache
    return decode
