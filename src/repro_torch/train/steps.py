"""Train and serve steps.

Port of ``repro.train.steps``. ``make_train_step`` builds the BSP superstep:
microbatched gradient accumulation, the int8 lossy stage with error feedback
(``grad_compression="int8"``; the residual rides in the optimizer state as
``ef``), global-norm clipping, the schedule and the optimizer update.
``make_prefill_step`` / ``make_decode_step`` build the serving path; they run
under ``torch.no_grad`` and update the KV cache in place and return it, so the
call sites read like the JAX ones.

Given a ``DeviceMesh``, ``make_train_step`` builds the sharded step, the
counterpart of the JAX Trainer's GSPMD step. Each parameter's master copy, its
AdamW moments and its ``ef`` residual are DTensors placed by
``parallel.sharding.param_specs`` (FSDP over ``data``, TP and EP over
``model``), and the model holds this rank's shards
(``parallel.tensor.shard_model``): each step binds the model's parameters to
the masters' local tensors, so no rank holds a whole master. Each rank takes
its share of every global microbatch (``local_batch``) and computes its
``model`` shard of each layer, gathering the layer's weights over the batch
axes when it runs (``parallel.tensor``); the gradients arrive on the shards,
reduce-scattered by those gathers' backward, and a dim that the batch axes
leave whole is all-reduced over them (``make_local_step``). Plain ``adamw``
then updates each shard; ``adamw_factored`` and ``adamw_8bit`` take row and
column means or blocks of the flattened leaf, so they gather one leaf and its
gradient at a time, update it from replicated state and keep their shard. The
metrics, the MoE load-balance statistics, the int8 ``amax`` and the global
norm are those of the whole batch and the whole leaf, as GSPMD computes them.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.common.config import RunConfig
from repro_torch.models import moe
from repro_torch.models.model import DTYPES, lm_loss, model_inputs
from repro_torch.models.transformer import stack_positions
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
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

    With a ``mesh``, the sharded step (module docstring): a model holding
    whole parameters is cut to this rank's shards in place; ``params`` and
    ``opt_state`` are those of ``shard_train_state`` under
    ``param_placements`` of the whole parameters (or of
    ``init_train_state``), and ``batch`` is the global batch, the same on
    every rank. ``step.local`` is ``make_local_step``'s step on plain tensors."""
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


def init_train_state(model, opt_cfg: adamw.OptimizerConfig, mesh, int8: bool = False):
    """The sharded step's (params, opt_state) for a model on its shards
    (``parallel.tensor.build_sharded``), as ``shard_train_state`` would make
    them from the whole model: the masters are DTensors over the model's own
    local tensors; the ``adamw`` moments and the int8 residual are zeros on
    the shards; the factored and 8-bit statistics are zeros whole (made a
    leaf at a time, without a whole parameter)."""
    from torch.distributed.tensor import DTensor
    pl = tensor.placements(model, mesh)
    local = dict(model.named_parameters())
    masters = {n: DTensor.from_local(p.detach(), mesh, pl[n]) for n, p in local.items()}
    if _elementwise(opt_cfg):
        state = adamw.init_state(opt_cfg, local)
        state["m"] = {n: {k: DTensor.from_local(v, mesh, pl[n]) for k, v in st.items()}
                      for n, st in state["m"].items()}
    else:
        # a zero-stride stand-in of each whole leaf: init_state reads its shape
        shapes = {n: torch.empty((), dtype=p.dtype, device=p.device).expand(p.tp_full_shape)
                  for n, p in local.items()}
        state = adamw.init_state(opt_cfg, shapes)
    if int8:
        state["ef"] = {n: DTensor.from_local(v, mesh, pl[n])
                       for n, v in ErrorFeedback.init(local).items()}
    return masters, state


def make_local_step(model, run: RunConfig, opt_cfg: adamw.OptimizerConfig, tp):
    """The sharded step on plain tensors: step(params, opt_state, batch) ->
    (params, opt_state, metrics), where ``params`` is
    ``dict(model.named_parameters())`` of a model on its shards (updated in
    place), ``opt_state`` holds this rank's local tensors and ``batch`` is
    this rank's rows (``local_batch``). The dry run traces this."""
    pcfg, tcfg = run.parallel, run.train
    accumulate = make_grad_fn(model, run)
    moes = [m for m in model.modules() if isinstance(m, moe.MoE)]
    groups = int8_groups(model)
    names = list(tp.sizes)
    sharded_by = {n: {a for e in tp.spec(p) for a in shd._axes_of(e)}
                  for n, p in model.named_parameters()}

    def global_norm(grads):
        """Each leaf's sum of squares summed over the mesh axes that shard
        it, so that a replicated shard is counted once."""
        sq = torch.stack([torch.sum(torch.square(g.float())) for g in grads.values()])
        for axis in names:
            flags = [axis in sharded_by[n] for n in grads]
            if any(flags) and tp.sizes[axis] > 1:
                mask = torch.tensor(flags, device=sq.device)
                part = tensor.all_reduce(torch.where(mask, sq, 0.0), tp.groups[axis])
                sq = torch.where(mask, part, sq)
        return torch.sqrt(torch.sum(sq))

    def reduce_grads(params, grads):
        """The gradients summed over the batch ranks (the gathers'
        backward reduce-scattered those of the sharded dims; a dim the
        batch axes leave whole is all-reduced here), as their mean."""
        for name, g in grads.items():
            axes = tp.replicated_batch_axes(params[name])
            if axes:
                g = tp.sum_over(g, axes)
            grads[name] = g / tp.n_batch if tp.n_batch > 1 else g
        return grads

    def step(params, opt_state, batch):
        for m in moes:          # the load-balance loss of the whole batch
            m.batch_mean = tp.batch_mean
        try:
            _, metrics, grads = accumulate(params, batch)
        finally:
            for m in moes:
                m.batch_mean = None
        grads = reduce_grads(params, grads)
        keys = list(metrics)
        means = tp.sum_over(torch.stack([metrics[m].float() for m in keys]),
                            tp.batch_axes) / tp.n_batch
        metrics = dict(zip(keys, means.unbind()))

        opt_state = dict(opt_state)
        resid = opt_state.pop("ef", None)
        if pcfg.grad_compression == "int8":
            # amax over the whole leaf: the max over its shards
            grads, resid = _compress(grads, resid, groups,
                                     lambda v: tp.sum_over(torch.stack(v), names, "max"))
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip_norm,
                                                 norm=global_norm(grads))
        lr = adamw.warmup_cosine(opt_state["step"], base_lr=tcfg.learning_rate,
                                 warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        if _elementwise(opt_cfg):
            params, opt_state = adamw.apply_updates(opt_cfg, params, grads, opt_state, lr)
        else:
            # the factored and 8-bit statistics are of the whole leaf: each
            # leaf is gathered, updated and cut back in turn
            new_m = {}
            for name, p in params.items():
                spec = tp.spec(p)
                whole = tp.full(p.detach(), spec)
                _, st = adamw.apply_updates(
                    opt_cfg, {name: whole}, {name: tp.full(grads.pop(name), spec)},
                    {"step": opt_state["step"], "m": {name: opt_state["m"][name]}}, lr)
                new_m[name] = st["m"][name]
                with torch.no_grad():
                    p.copy_(tp.shard(whole, spec))
                del whole
            opt_state = {"step": opt_state["step"] + 1, "m": new_m}
        if resid is not None:
            opt_state["ef"] = resid
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)

    return step


def _make_sharded_step(model, run: RunConfig, opt_cfg: adamw.OptimizerConfig, mesh):
    from torch.distributed.tensor import DTensor

    tp = tensor.shard_model(model, mesh)
    k = max(run.parallel.microbatches, 1)
    model_params = dict(model.named_parameters())
    placements = tensor.placements(model, mesh)
    rank, n_batch = batch_coordinate(mesh)
    local_step = make_local_step(model, run, opt_cfg, tp)

    def wrap(t, name):
        return DTensor.from_local(t.detach(), mesh, placements[name])

    def step(params, opt_state, batch):
        with torch.no_grad():       # the model computes on the masters' own shards
            for name, p in model_params.items():
                p.data = params[name].to_local()
        state = dict(opt_state)
        if _elementwise(opt_cfg):
            state["m"] = {n: {key: v.to_local() for key, v in st.items()}
                          for n, st in opt_state["m"].items()}
        if "ef" in state:
            state["ef"] = {n: r.to_local() for n, r in state["ef"].items()}
        _, state, metrics = local_step(model_params, state, local_batch(batch, k, rank, n_batch))
        params = {name: wrap(p, name) for name, p in model_params.items()}
        if _elementwise(opt_cfg):
            state["m"] = {n: {key: wrap(v, n) for key, v in st.items()}
                          for n, st in state["m"].items()}
        if "ef" in state:
            state["ef"] = {n: wrap(r, n) for n, r in state["ef"].items()}
        return params, state, metrics

    step.local = local_step
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
