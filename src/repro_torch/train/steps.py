"""Train and serve steps.

Port of ``repro.train.steps``. ``make_train_step`` builds the BSP superstep:
microbatched gradient accumulation, the int8 lossy stage with error feedback
(``grad_compression="int8"``; the residual rides in the optimizer state as
``ef``), global-norm clipping, the schedule and the optimizer update.
``make_prefill_step`` / ``make_decode_step`` build the serving path; they run
under ``torch.no_grad`` and update the KV cache in place and return it, so the
call sites read like the JAX ones.

Given a ``DeviceMesh``, ``make_train_step`` builds the sharded step, the
counterpart of the JAX Trainer's GSPMD step. Each parameter's master copy and
its ``ef`` residual are DTensors placed by ``parallel.sharding.param_specs``
(FSDP over ``data``, TP and EP over ``model``), and its optimizer state as
the JAX package's ``opt_state_shardings`` places it
(``sharding.opt_state_specs``): the ``adamw`` moments and the factored first
moment like their parameter, the factored row and column statistics whole,
the 8-bit blocks like the JAX leaf where it is 2-D. A stack of per-layer
tensors that the optimizer updates as its JAX leaf (``adamw.stacks``) is
updated together: a factored stack of vectors on the shards as one (units,
d) leaf, an 8-bit stack whose blocks span its layers gathered whole. The
model holds this rank's shards (``parallel.tensor.shard_model``): each step
binds the model's parameters to the masters' local tensors, so no rank holds
a whole master. Each rank takes its share of every global microbatch
(``local_batch``) and computes its ``model`` shard of each layer, gathering
the layer's weights over the batch axes when it runs (``parallel.tensor``);
the gradients arrive on the shards, reduce-scattered by those gathers'
backward, and a dim that the batch axes leave whole is all-reduced over them
(``make_local_step``). ``adamw`` then updates each shard, and
``adamw_factored`` too: its row and column means are the shard's partial
sums all-reduced over the axes that shard the summed dim and gathered whole
(``LeafShards``). ``adamw_8bit``'s blocks span the flattened leaf: a leaf
whose 8-bit state sits like it is updated on its shard (``BlockShards``: the
codes moved between the two layouts by an all-to-all); any other leaf, its
gradient and its state are gathered whole one at a time and cut back.
The metrics, the MoE load-balance statistics, the int8 ``amax`` and the
global norm are those of the whole batch and the whole leaf, as GSPMD
computes them.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.common.config import RunConfig
from repro_torch.models import moe
from repro_torch.models.model import DTYPES, lm_loss, model_inputs
from repro_torch.models.transformer import stacked_leaves
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


def jax_leaves(model) -> Dict[str, str]:
    """``transformer.stacked_leaves`` of ``model``'s parameters: the stacked
    JAX leaf of each ``blocks.*`` parameter, which the optimizer takes."""
    return stacked_leaves(model.cfg, (n for n, _ in model.named_parameters()))


def int8_groups(model) -> Dict[str, str]:
    """The JAX leaf of each parameter: the JAX package quantises a leaf with
    one scale, and it stacks the layers of a segment's unit position on one
    leaf, so ``blocks.<layer>.<path>`` of every layer at one (segment,
    position) share a group; any other parameter is a group of its own."""
    leaves = jax_leaves(model)
    return {name: leaves.get(name, name) for name, _ in model.named_parameters()}


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
    leaves = jax_leaves(model)

    def step(params, opt_state, batch):
        _, metrics, grads = accumulate(params, batch)
        opt_state = dict(opt_state)
        ef = opt_state.pop("ef", None)
        if pcfg.grad_compression == "int8":
            grads, ef = _compress(grads, ef, groups)
        grads, gnorm = adamw.clip_by_global_norm(grads, tcfg.grad_clip_norm)
        lr = adamw.warmup_cosine(opt_state["step"], base_lr=tcfg.learning_rate,
                                 warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        params, opt_state = adamw.apply_updates(opt_cfg, params, grads, opt_state, lr, leaves)
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


def mark_batch(tp, rows: int, k: int, n: int) -> None:
    """Tell a model's ``tp`` whether the step's global batch of ``rows`` in
    ``k`` microbatches is held whole on each of the ``n`` batch ranks
    (``local_batch``): its rows then never split over ``model``
    (``TensorParallel.rows_over_model``)."""
    tp.batch_replicated = n > 1 and rows % (k * n) != 0


def _fitted_specs(specs: Dict[str, tuple], state: Dict[str, Dict[str, tuple]],
                  mesh) -> Dict[str, Dict[str, tuple]]:
    """``sharding.opt_state_specs`` of the state tensors of whole shapes
    ``state`` ({parameter: {key: shape}}) whose parameters have ``specs``,
    each fitted to its tensor (``fit_spec``)."""
    raw = shd.opt_state_specs(specs, state)
    return {n: {k: shd.fit_spec(spec, state[n][k], mesh) for k, spec in leaf.items()}
            for n, leaf in raw.items()}


def state_specs(opt_cfg: adamw.OptimizerConfig, specs: Dict[str, tuple],
                shapes: Dict[str, tuple], mesh, leaves: Dict[str, str]) -> Dict[str, Dict[str, tuple]]:
    """Each optimizer state tensor's spec as placed on ``mesh``: that of the
    state (``adamw.tree_layout`` under ``leaves``) of the leaves of whole
    ``shapes`` whose parameters have ``specs``."""
    layout = adamw.tree_layout(opt_cfg, shapes, leaves)
    return _fitted_specs(specs, {n: {k: v[0] for k, v in lay.items()}
                                 for n, lay in layout.items()}, mesh)


def _spec_placements(specs: Dict[str, Dict[str, tuple]], mesh) -> Dict[str, Dict[str, list]]:
    return {n: {k: shd.placements(s, mesh) for k, s in leaf.items()} for n, leaf in specs.items()}


def shard_train_state(params: Dict[str, torch.Tensor], opt_state, opt_cfg: adamw.OptimizerConfig,
                      mesh, placements: Dict[str, list]):
    """Full parameters and optimizer state (every rank the same) -> the
    sharded step's (params, opt_state): each parameter and its ``ef``
    residual a DTensor under its placements, each optimizer state tensor a
    DTensor under ``state_specs`` (Replicate where it is whole)."""
    masters = {n: shd.shard_tensor(p.detach(), mesh, placements[n]) for n, p in params.items()}
    specs = {n: shd.spec_of(placements[n], mesh, p.dim()) for n, p in params.items()}
    pl = _spec_placements(_fitted_specs(specs, {n: {k: tuple(v.shape) for k, v in st.items()}
                                                for n, st in opt_state["m"].items()}, mesh), mesh)
    state = dict(opt_state)
    state["m"] = {n: {k: shd.shard_tensor(v, mesh, pl[n][k]) for k, v in st.items()}
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


def local_opt_state(opt_cfg: adamw.OptimizerConfig, params: Dict[str, torch.Tensor], mesh,
                    leaves: Dict[str, str]):
    """``adamw.init_state`` of the whole leaves of ``params`` (a model's
    parameters on their shards: ``tp_spec``, ``tp_full_shape``; whole where
    they have none) under ``leaves``, each tensor made on this rank's shard
    under ``state_specs``: a factored ``mu`` is never whole. Returns (state
    of local tensors, the specs)."""
    whole = {n: tuple(getattr(p, "tp_full_shape", p.shape)) for n, p in params.items()}
    specs = state_specs(opt_cfg, {n: tensor.TensorParallel.spec(p) for n, p in params.items()},
                        whole, mesh, leaves)
    layout = adamw.tree_layout(opt_cfg, whole, leaves)
    m = {n: {k: torch.full(shd.local_shape(shape, specs[n][k], mesh), fill, dtype=dt,
                           device=p.device)
             for k, (shape, dt, fill) in layout[n].items()}
         for n, p in params.items()}
    device = next(iter(params.values())).device if params else None
    return {"step": torch.zeros((), dtype=torch.int32, device=device), "m": m}, specs


def init_train_state(model, opt_cfg: adamw.OptimizerConfig, mesh, int8: bool = False):
    """The sharded step's (params, opt_state) for a model on its shards
    (``parallel.tensor.build_sharded``), as ``shard_train_state`` would make
    them from the whole model: the masters are DTensors over the model's own
    local tensors; the optimizer state and the int8 residual are zeros made
    on their shards (``local_opt_state``)."""
    from torch.distributed.tensor import DTensor
    pl = tensor.placements(model, mesh)
    local = dict(model.named_parameters())
    masters = {n: DTensor.from_local(p.detach(), mesh, pl[n]) for n, p in local.items()}
    state, specs = local_opt_state(opt_cfg, local, mesh, jax_leaves(model))
    spl = _spec_placements(specs, mesh)
    state["m"] = {n: {k: DTensor.from_local(v, mesh, spl[n][k]) for k, v in st.items()}
                  for n, st in state["m"].items()}
    if int8:
        state["ef"] = {n: DTensor.from_local(v, mesh, pl[n])
                       for n, v in ErrorFeedback.init(local).items()}
    return masters, state


class LeafShards(adamw.Shards):
    """A parameter shard's factored statistics over the mesh: the shard's
    partial sums all-reduced over the axes that shard the summed dim, then
    gathered whole over those that shard the others (the JAX package holds
    ``nu_row`` and ``nu_col`` whole); the whole statistics cut back to the
    shard's rows and columns."""

    def __init__(self, tp, spec: tuple, shape):
        super().__init__(shape)
        self.tp = tp
        self.row_spec, self.col_spec = spec[:-1], spec[:-2] + spec[-1:]
        self.over_cols, self.over_rows = shd._axes_of(spec[-1]), shd._axes_of(spec[-2])

    def row_sums(self, part):
        return self.tp.full(self.tp.sum_over(part, self.over_cols), self.row_spec)

    def col_sums(self, part):
        return self.tp.full(self.tp.sum_over(part, self.over_rows), self.col_spec)

    def rows(self, whole):
        return self.tp.shard(whole, self.row_spec)

    def cols(self, whole):
        return self.tp.shard(whole, self.col_spec)


class BlockShards(adamw.Shards):
    """A 2-D leaf's 8-bit state where ``opt_state_specs`` places it like the
    parameter (spec (a, b): the codes (n, block) with the blocks over a and
    each block's offsets over b, the scales (n, 1) over a), updated on the
    parameter's shard (rows over a, columns over b). A row shard holds whole
    blocks (its rows x columns divide by the block: ``block_shards``), so the
    blocks of this rank's rows are the state's blocks over a, and only the
    ranks along b trade elements: a block's offsets lie over b's ranks in
    the state and its columns in the parameter, two layouts that the
    flattened row shard repeats every lcm(columns, block) elements. From
    one such period, each element's owner and place in both layouts give
    the all-to-all over b that moves the int8 codes either way. A block's
    scale is the max over the ranks that hold its elements (an all-reduce
    over b), so the codes are those of the whole leaf's ``_q8_encode``."""

    def __init__(self, tp, spec: tuple, shape, block: int, device):
        super().__init__(shape)
        rows, cols = shape
        self.group = tp.groups[spec[1]] if spec[1] else tensor.Group("", 1, 0)
        m, me = self.group.size, self.group.rank
        self.local = (rows // math.prod(tp.sizes[a] for a in shd._axes_of(spec[0])), cols // m)
        period = math.lcm(cols, block)
        self.periods = self.local[0] * cols // period
        self.blocks = period // block           # blocks a period
        f = np.arange(period)
        width = block // m
        p_own, p_pos = (f % cols) // self.local[1], (f // cols) * self.local[1] + f % self.local[1]
        s_own, s_pos = (f % block) // width, (f // block) * width + f % width

        def index(x):
            return torch.from_numpy(x.astype(np.int64)).to(device)
        # each element of this rank's period in the parameter's layout: its block
        block_of = np.empty(period // m, dtype=np.int64)
        block_of[p_pos[p_own == me]] = f[p_own == me] // block
        self.block_of = index(block_of)
        # (places sent to rank j, places received from rank i), either way
        self.to_state = ([index(p_pos[(p_own == me) & (s_own == j)]) for j in range(m)],
                         [index(s_pos[(p_own == i) & (s_own == me)]) for i in range(m)])
        self.to_param = ([index(s_pos[(s_own == me) & (p_own == j)]) for j in range(m)],
                         [index(p_pos[(s_own == i) & (p_own == me)]) for i in range(m)])
        self.width = width

    def _move(self, x: torch.Tensor, plan) -> torch.Tensor:
        """A period-major (periods, period / m) tensor in one layout -> the other."""
        send, recv = plan
        if self.group.size == 1:
            return x
        out = tensor.all_to_all(torch.cat([x[:, i].reshape(-1) for i in send]), self.group,
                                [self.periods * len(i) for i in recv],
                                [self.periods * len(i) for i in send])
        y = torch.empty_like(x)
        for i, part in zip(recv, out.split([self.periods * len(i) for i in recv])):
            y[:, i] = part.view(self.periods, -1)
        return y

    def _scales(self, scale: torch.Tensor) -> torch.Tensor:
        """Each element's block scale, (periods, period / m)."""
        return scale.reshape(self.periods, self.blocks)[:, self.block_of]

    def decode(self, q, scale, block):
        codes = self._move(q.reshape(self.periods, -1), self.to_param)
        return (codes.to(torch.float32) * self._scales(scale)).reshape(self.local)

    def encode(self, x, block):
        x = x.reshape(self.periods, -1)
        amax = torch.zeros(self.periods, self.blocks, dtype=torch.float32, device=x.device)
        amax.scatter_reduce_(1, self.block_of.expand(self.periods, -1), x.abs(), "amax")
        amax = tensor.all_reduce(amax, self.group, "max")
        scale = torch.clamp(amax / amax.new_tensor(127.0), min=1e-12)   # as _q8_encode
        q = torch.clamp(torch.round(x / self._scales(scale)), -127, 127).to(torch.int8)
        return (self._move(q, self.to_state).reshape(-1, self.width),
                scale.reshape(-1, 1))


def block_shards(tp, spec: tuple, shape, st_specs: Dict[str, tuple], block: int,
                 device) -> Optional[BlockShards]:
    """The ``BlockShards`` of a leaf whose 8-bit state sits like the
    parameter and whose row shard holds whole blocks, else None (its state
    is whole, or the layouts do not meet: the leaf is gathered whole to be
    updated)."""
    if len(shape) != 2 or st_specs.get("mu_q") != tuple(spec) \
            or st_specs.get("mu_s") != (spec[0], None) or isinstance(spec[1], tuple):
        return None
    rows = shape[0] // math.prod(tp.sizes[a] for a in shd._axes_of(spec[0]))
    if rows * shape[1] % block:
        return None
    return BlockShards(tp, tuple(spec), shape, block, device)


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
    whole = {n: tuple(getattr(p, "tp_full_shape", p.shape)) for n, p in model.named_parameters()}
    leaves = jax_leaves(model)
    specs = state_specs(opt_cfg, {n: tp.spec(p) for n, p in model.named_parameters()}, whole,
                        tp.mesh, leaves)
    stacks = adamw.stacks(opt_cfg, whole, leaves)
    stacked = {n for members in stacks.values() for n in members}
    shards = {n: LeafShards(tp, tp.spec(p), whole[n]) for n, p in model.named_parameters()
              if "nu_row" in specs[n] and n not in stacked}
    if opt_cfg.kind == "adamw_factored":
        # a stack of per-layer vectors: the (units, d) leaf, units whole
        params_now = dict(model.named_parameters())
        shards.update({leaf: LeafShards(tp, (None,) + tuple(tp.spec(params_now[ms[0]])),
                                        (len(ms),) + whole[ms[0]])
                       for leaf, ms in stacks.items()})
    if opt_cfg.kind == "adamw_8bit":
        blocks = {n: block_shards(tp, tp.spec(p), whole[n], specs[n], opt_cfg.block, p.device)
                  for n, p in model.named_parameters() if n not in stacked}
        shards = {n: b for n, b in blocks.items() if b is not None}
        # every other leaf gathered whole: a stack, or a leaf as a stack of one
        gathered = list(stacks.values()) + [[n] for n in blocks if blocks[n] is None]

    def cut(t, spec):
        """This rank's shard of a whole ``t``, in storage of its own."""
        return tp.shard(t, spec).clone() if any(spec) else t

    @torch.no_grad()
    def update_8bit(params, grads, opt_state, lr):
        """The 8-bit blocks span the flattened leaf. A leaf whose state sits
        like the parameter is updated on its shard (``BlockShards``); any
        other leaf, its gradient and its state are gathered whole in turn,
        updated, and cut back, a stack whose blocks span its layers
        (``adamw.stacks``) with its members together, as one stack. The
        gathered old state is the update's alone, so it is freed as it is
        decoded, before the new one is encoded."""
        step, new_m = opt_state["step"], {}
        for members in gathered:
            whole_p = [tp.full(params[n].detach(), tp.spec(params[n])) for n in members]
            new = adamw.update_stack(
                opt_cfg, whole_p, [tp.full(grads.pop(n), tp.spec(params[n])) for n in members],
                [{k: tp.full(v, specs[n][k]) for k, v in opt_state["m"][n].items()}
                 for n in members], lr, step)
            for n, leaf, st in zip(members, whole_p, new):
                new_m[n] = {k: cut(v, specs[n][k]) for k, v in st.items()}
                params[n].copy_(tp.shard(leaf, tp.spec(params[n])))
            del whole_p, new
        for name in shards:
            new_m[name] = adamw.update_leaf(opt_cfg, params[name], grads.pop(name),
                                            dict(opt_state["m"][name]), lr, step, shards[name])
        return {"step": step + 1, "m": {n: new_m[n] for n in params}}

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
        if opt_cfg.kind == "adamw_8bit":
            opt_state = update_8bit(params, grads, opt_state, lr)
        else:
            params, opt_state = adamw.apply_updates(opt_cfg, params, grads, opt_state, lr,
                                                    leaves, shards)
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
    state_pl = _spec_placements(state_specs(
        opt_cfg, {n: tp.spec(p) for n, p in model_params.items()},
        {n: tuple(p.tp_full_shape) for n, p in model_params.items()}, mesh,
        jax_leaves(model)), mesh)
    rank, n_batch = batch_coordinate(mesh)
    local_step = make_local_step(model, run, opt_cfg, tp)

    def wrap(t, pl):
        return DTensor.from_local(t.detach(), mesh, pl)

    def step(params, opt_state, batch):
        with torch.no_grad():       # the model computes on the masters' own shards
            for name, p in model_params.items():
                p.data = params[name].to_local()
        state = dict(opt_state)
        state["m"] = {n: {key: v.to_local() for key, v in st.items()}
                      for n, st in opt_state["m"].items()}
        if "ef" in state:
            state["ef"] = {n: r.to_local() for n, r in state["ef"].items()}
        mark_batch(tp, next(iter(batch.values())).shape[0], k, n_batch)
        _, state, metrics = local_step(model_params, state, local_batch(batch, k, rank, n_batch))
        params = {name: wrap(p, placements[name]) for name, p in model_params.items()}
        state["m"] = {n: {key: wrap(v, state_pl[n][key]) for key, v in st.items()}
                      for n, st in state["m"].items()}
        if "ef" in state:
            state["ef"] = {n: wrap(r, placements[n]) for n, r in state["ef"].items()}
        return params, state, metrics

    step.local = local_step
    return step


def make_prefill_step(model):
    """prefill(batch, cache): the batch's ``tokens`` or ``embeddings``. On a
    mesh (a model on its shards: ``tensor.shard_model``, ``build_sharded``)
    the batch is this rank's rows and the cache its shards
    (``LM.init_cache``); the logits come back whole over the vocab on every
    ``model`` rank (``LM.forward`` gathers the vocab-parallel read-out)."""
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
