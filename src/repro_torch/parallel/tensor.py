"""Tensor and expert parallelism over a ``DeviceMesh``: the counterpart of
what GSPMD derives from ``repro.parallel.sharding``'s specs.

The JAX Trainer jits its step with the parameters placed by the sharding
rules (attention heads, FFN hidden, vocab and experts over ``model``; the
other weight dim over ``data``), and GSPMD computes each projection on its
``model`` shard and gathers the ``data`` shards where a layer needs them. The
port writes that out, Megatron-style:

  * every parameter of a model on a mesh is this rank's shard under the same
    rules (``shard_model``; its spec rides on the parameter as ``tp_spec``);
  * a layer gathers its parameters over the batch axes (``pod``, ``data``)
    just before it runs (``TensorParallel.gather_batch``; an all-gather whose
    backward is a reduce-scatter, so the gradient lands on the shard summed
    over the batch ranks). Under remat the gather is inside the checkpointed
    block and runs again in the recompute; the gathered copy is freed once
    the layer's backward has used it;
  * a layer whose ``model`` split falls on whole heads, experts or FFN
    columns computes on its shard between ``copy_in`` (identity forward,
    all-reduce over ``model`` backward: Megatron's f) and ``reduce_out``
    (all-reduce forward, identity backward: Megatron's g);
  * a layer whose split does not fall on whole units gathers its ``model``
    shards too (``whole``) and computes whole on every ``model`` rank; its
    gradient is then the same on each, and the backward of that gather keeps
    this rank's slice. A slice that each rank reads only in part (a kv head
    shared by the q heads of two ranks) takes ``whole(partial=True)``, whose
    backward sums over ``model``;
  * under the "batch" attention mode a layer moves its rows over ``model``
    instead (``split_rows``, ``rows_to_heads``/``heads_to_rows``: an
    all-to-all whose backward is the inverse one), where they divide
    (``rows_over_model``); under the "sequence" mode it moves its queries'
    positions likewise (``split_seq`` at ``seq_start``,
    ``seq_to_heads``/``heads_to_seq``), where they divide
    (``seq_over_model``).

Serving (``prefill``/``decode`` on a mesh) runs the same layers without
autograd, its caches placed by ``sharding.cache_spec``: each cache tensor is
this rank's shard, ``model`` on the sequence (a recurrent state's on any of
its dims; ``cache_dim``) and the rows over the batch axes. A layer writes its whole new keys into its shard (``write_cache``: the
rank that holds a position writes it), attends over its shard of the
sequence and merges the ranks' outputs by their log-sum-exp
(``merge_over_model``); a recurrent cell whose heads ``model`` does not
divide gathers its state whole (``gather_cache``), steps it and keeps its
shard.

A recurrent cell whose heads ``model`` divides computes on this rank's heads
(``models/ssm.py``). The rules cut its projections' columns into contiguous
blocks that fall on no head boundary, so a ``ColumnExchange`` moves the
columns each rank's heads read to it (one all-to-all over ``model``, its
backward the reverse one), the columns every head reads (Mamba2's B and C,
mLSTM's xi) to every rank (their gradients summed over ``model``); a norm
over every head sums its rows' squares over ``model`` (``row_sum``, the
RMSNorm kernel's split mode), and a state moves from its ``cache_spec`` dim
to the heads for a step and back (``cache_to_heads``/``keep_heads``).

A recurrent cell whose H heads ``model`` does not divide, where ``model`` is
a multiple g·H of them (xlstm-125m's 4 heads at 8 and 16), computes one
head's 1/g on each rank (``parts_over_model``, ``HeadPart``): rank r takes
head r // g and part r % g of its width. The rules' column blocks are then
each exactly one head's part, so the exchanges above serve unchanged; what
a head's g ranks share (its scores and normaliser, q and k across its
width, sLSTM's hidden state) is summed or gathered over a subgroup of
``model``: the g ranks of the head, made once by every rank when the model
is placed (``attach``; ``torch.distributed.new_subgroups_by_enumeration``
over every batch coordinate's ``model`` ranks). A collective over the whole
of ``model`` whose other ranks add zeros would move H times the bytes. Its
gather's backward is a reduce-scatter over the head's ranks, its sum's an
all-reduce: each rank uses the sum with its own part of the head, so each
holds only its part of the sum's gradient. A state moves between its
``cache_spec`` shard and the rank's (head, part) by one all-to-all over
``model`` each way (``cache_to_part``/``keep_part``).

Every collective is a ``torch.ops._c10d_functional`` op followed by its
``wait_tensor``: the dispatcher sees it (the dry run counts it, under a fake
process group, on the meta device), and gloo runs it (its reduce-scatter
included). A collective over a group of one rank is skipped.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.parallel import sharding as shd

_fc = torch.ops._c10d_functional


# ---------------------------------------------------------------------------
# Plain collectives on one group (no autograd)
# ---------------------------------------------------------------------------

class Group(NamedTuple):
    """One process group of a mesh axis: its name, size and this rank's index."""
    name: str
    size: int
    rank: int


def all_reduce(t: torch.Tensor, group: Group, op: str = "sum") -> torch.Tensor:
    if group.size == 1:
        return t
    return _fc.wait_tensor(_fc.all_reduce(t.contiguous(), op, group.name))


def all_gather(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The group's shards of ``dim`` concatenated in rank order."""
    if group.size == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = _fc.wait_tensor(_fc.all_gather_into_tensor(x, group.size, group.name))
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This rank's chunk of ``dim`` of the sum over the group."""
    if group.size == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = _fc.wait_tensor(_fc.reduce_scatter_tensor(x, "sum", group.size, group.name))
    return out.movedim(0, dim)


def local_chunk(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    return t.chunk(group.size, dim=dim)[group.rank] if group.size > 1 else t


def all_to_all(t: torch.Tensor, group: Group, out_splits: Sequence[int],
               in_splits: Sequence[int]) -> torch.Tensor:
    """Rows ``in_splits[j]`` of ``t``'s dim 0 (in order) sent to rank j; the
    rows received, ``out_splits[i]`` from rank i, concatenated in rank order."""
    if group.size == 1:
        return t
    return _fc.wait_tensor(_fc.all_to_all_single(t.contiguous(), list(out_splits),
                                                 list(in_splits), group.name))


def swap_dims(t: torch.Tensor, group: Group, split_dim: int, cat_dim: int) -> torch.Tensor:
    """``t`` cut into the group's size of chunks along ``split_dim``, chunk j
    sent to rank j, and the chunks received concatenated along ``cat_dim``
    in rank order: (all rows, this rank's heads) -> (this rank's rows, every
    head) with ``split_dim`` 0 and ``cat_dim`` the heads', and back."""
    if group.size == 1:
        return t
    x = torch.stack(t.chunk(group.size, dim=split_dim))
    out = all_to_all(x, group, [1] * group.size, [1] * group.size)
    return torch.cat(out.unbind(0), dim=cat_dim)


# ---------------------------------------------------------------------------
# Autograd-aware collectives
# ---------------------------------------------------------------------------

class _CopyIn(torch.autograd.Function):
    """Megatron's f: identity forward, all-reduce of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceOut(torch.autograd.Function):
    """Megatron's g: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBoth(torch.autograd.Function):
    """All-reduce forward and backward: a value summed over ranks that each
    use the sum (the load-balance loss's means)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        for gr in groups:
            x = all_reduce(x, gr)
        return x

    @staticmethod
    def backward(ctx, g):
        for gr in ctx.groups:
            g = all_reduce(g, gr)
        return g, None


class _Swap(torch.autograd.Function):
    """``swap_dims`` forward; backward the inverse move of the gradient."""

    @staticmethod
    def forward(ctx, x, group, split_dim, cat_dim):
        ctx.args = group, cat_dim, split_dim
        return swap_dims(x, group, split_dim, cat_dim)

    @staticmethod
    def backward(ctx, g):
        return swap_dims(g, *ctx.args), None, None, None


class _Split(torch.autograd.Function):
    """This rank's chunk of ``dim`` forward; backward the ranks' gradients
    gathered in rank order (every rank computed on the whole before)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return local_chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Exchange(torch.autograd.Function):
    """``ColumnExchange.move`` of ``dim``; backward the gradient moved
    back, the shared columns' summed over the ranks that read them."""

    @staticmethod
    def forward(ctx, x, ex, group, dim):
        ctx.args = ex, group, dim
        return ex.move(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        ex, group, dim = ctx.args
        return ex.move_back(g, group, dim), None, None, None


class _Gather(torch.autograd.Function):
    """All-gather over ``steps`` ((dim, group), minor axis first); backward a
    reduce-scatter over them (``sum``) or this rank's slice."""

    @staticmethod
    def forward(ctx, x, steps, sum_grad: bool):
        ctx.steps, ctx.sum_grad = steps, sum_grad
        for dim, gr in steps:
            x = all_gather(x, gr, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        for dim, gr in reversed(ctx.steps):
            g = reduce_scatter(g, gr, dim) if ctx.sum_grad else local_chunk(g, gr, dim)
        return g, None, None


class HeadPart(NamedTuple):
    """This rank's share of a cell of ``heads`` heads on a ``model`` of
    g·heads ranks: head ``head`` (``model`` rank // g), part ``group.rank``
    (``model`` rank % g) of its width, and ``group``, the head's g ranks."""
    g: int
    head: int
    group: Group

    @property
    def part(self) -> int:
        return self.group.rank

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The head's g parts of ``dim`` of ``x`` concatenated in part
        order; the backward sums each rank's gradient of the whole over the
        head's ranks onto this rank's part (a reduce-scatter)."""
        return _Gather.apply(x, [(dim % x.dim(), self.group)], True)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, a part's partial sum, summed over the head's ranks; the
        backward sums the gradient over them too."""
        return _SumBoth.apply(x, [self.group])


# ---------------------------------------------------------------------------
# Head-aligned columns out of contiguous shards
# ---------------------------------------------------------------------------

class ColumnExchange:
    """A dim of ``n`` columns held in contiguous blocks of ``n / size``, one a
    rank in rank order (the rules' shard of a weight, of a projection's
    output or of a cache), and the columns this rank's heads read:
    ``segments`` ((start, length, shared), ...), each read in its ``1/size``
    chunk a rank, or whole by every rank where ``shared``. A rank's columns
    are the union over segments, in column order (z_r | x_r | B | C | dt_r of
    Mamba2's in_proj). Built by ``exchange`` (cached); its index tensors are
    kept by device."""

    def __init__(self, n: int, segments: Tuple[Tuple[int, int, bool], ...], size: int,
                 rank: int):
        if n % size:
            raise ValueError(f"{n} columns do not split over {size} ranks")
        self.block = n // size
        self.wanted = [self._wanted(segments, size, j) for j in range(size)]
        lo, hi = rank * self.block, (rank + 1) * self.block
        mine = [[c - lo for c in w if lo <= c < hi] for w in self.wanted]
        self.in_splits = [len(m) for m in mine]                 # sent to rank j
        self.send = [c for m in mine for c in m]                # in my block, by rank
        self.out_splits = [sum(1 for c in self.wanted[rank] if j * self.block <= c
                               < (j + 1) * self.block) for j in range(size)]
        # the inverse: each column of my block from its owner's columns (a
        # shared column from my own)
        shared = {c for a, l, sh in segments if sh for c in range(a, a + l)}
        owner = {c: j for j, w in enumerate(self.wanted) for c in w if c not in shared}
        pos = [{c: i for i, c in enumerate(w)} for w in self.wanted]
        src = lambda c, me: me if c in shared else owner[c]  # noqa: E731
        self.back_send, self.back_in = [], []
        for j in range(size):
            cols = [c for c in range(j * self.block, (j + 1) * self.block) if src(c, j) == rank]
            self.back_send += [pos[rank][c] for c in cols]
            self.back_in.append(len(cols))
        got = [[c - lo for c in range(lo, hi) if src(c, rank) == i] for i in range(size)]
        self.back_out = [len(g) for g in got]
        self.back_place = [c for g in got for c in g]
        if sorted(self.back_place) != list(range(self.block)):
            raise ValueError(f"segments {segments} do not cover the {n} columns")
        self._idx: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    @staticmethod
    def _wanted(segments, size: int, j: int) -> List[int]:
        cols = []
        for a, length, shared in segments:
            if shared:
                cols += range(a, a + length)
            else:
                k = length // size
                cols += range(a + j * k, a + (j + 1) * k)
        return sorted(cols)

    def index(self, name: str, device) -> torch.Tensor:
        key = (name, torch.device(device))
        if key not in self._idx:
            self._idx[key] = torch.tensor(getattr(self, name), dtype=torch.long, device=device)
        return self._idx[key]

    def _a2a(self, x: torch.Tensor, group: Group, dim: int, pick: str, out_splits, in_splits
             ) -> torch.Tensor:
        t = x.movedim(dim, 0).index_select(0, self.index(pick, x.device))
        return all_to_all(t, group, out_splits, in_splits).movedim(0, dim)

    def move(self, x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
        """This rank's block of ``dim`` -> the columns its heads read."""
        return self._a2a(x, group, dim, "send", self.out_splits, self.in_splits)

    def move_back(self, g: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
        """``move``'s backward: the read columns' gradients sent to their
        blocks' ranks and summed into the block (a shared column's from
        every rank)."""
        t = all_to_all(g.movedim(dim, 0), group, self.in_splits, self.out_splits)
        out = t.new_zeros((self.block, *t.shape[1:]))
        return out.index_add_(0, self.index("send", g.device), t).movedim(0, dim)

    def restore(self, x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
        """``move``'s inverse (no autograd): the read columns of every rank
        -> this rank's block, a shared column taken from this rank's own."""
        t = self._a2a(x, group, dim, "back_send", self.back_out, self.back_in)
        return torch.empty_like(t).index_copy_(dim, self.index("back_place", x.device), t)


@functools.lru_cache(maxsize=None)
def exchange(n: int, segments: Tuple[Tuple[int, int, bool], ...], size: int,
             rank: int) -> ColumnExchange:
    return ColumnExchange(n, segments, size, rank)


# ---------------------------------------------------------------------------
# The mesh a model computes over
# ---------------------------------------------------------------------------

class TensorParallel:
    """The groups of a ``DeviceMesh`` a model on its shards computes over:
    ``model`` (``size``, ``rank``) and the batch axes. Every rank holds the
    same object shape; ``sizes`` and ``coord`` are by axis name."""

    def __init__(self, mesh):
        names = tuple(mesh.mesh_dim_names)
        self.mesh = mesh
        self.sizes = dict(zip(names, (int(s) for s in mesh.mesh.shape)))
        coord = mesh.get_coordinate()
        self.coord = dict(zip(names, coord))
        self.groups = {a: Group(mesh.get_group(a).group_name, self.sizes[a], self.coord[a])
                       for a in names}
        self.model = self.groups.get("model", Group("", 1, 0))
        self.size, self.rank = self.model.size, self.model.rank
        self.batch_axes = tuple(a for a in shd.BATCH_AXES if a in names)
        self.n_batch = math.prod(self.sizes[a] for a in self.batch_axes)
        # the step's batch is held whole on every batch rank (rows that the
        # batch axes do not divide: ``steps.local_batch``); set by the caller
        self.batch_replicated = False
        self._parts: Dict[int, Group] = {}      # g -> this rank's group of a head's g ranks

    # --- specs ----------------------------------------------------------
    @staticmethod
    def spec(p: torch.Tensor) -> tuple:
        return getattr(p, "tp_spec", (None,) * p.dim())

    def split_dim(self, p: torch.Tensor) -> Optional[int]:
        """The dim of ``p`` split over ``model``, or None."""
        for d, entry in enumerate(self.spec(p)):
            if "model" in shd._axes_of(entry):
                return d
        return None

    def split_on(self, *pairs: Tuple[torch.Tensor, int]) -> bool:
        """Each (tensor, dim): the tensor is split over ``model`` on that dim
        (a size-one ``model`` axis splits every dim the rules name)."""
        return all(self.split_dim(p) == d for p, d in pairs)

    def _steps(self, p: torch.Tensor, axes: Sequence[str]) -> List[Tuple[int, Group]]:
        """(dim, group) of each axis in ``axes`` that shards ``p``, minor first."""
        steps = []
        for d, entry in enumerate(self.spec(p)):
            for a in reversed(shd._axes_of(entry)):
                if a in axes and self.sizes[a] > 1:
                    steps.append((d, self.groups[a]))
        return steps

    def replicated_batch_axes(self, p: torch.Tensor) -> Tuple[str, ...]:
        """The batch axes that do not shard ``p``: its gradient is summed
        over them after the backward."""
        on = {a for e in self.spec(p) for a in shd._axes_of(e)}
        return tuple(a for a in self.batch_axes if a not in on and self.sizes[a] > 1)

    # --- gathers ----------------------------------------------------------
    def gather_batch(self, p: torch.Tensor) -> torch.Tensor:
        """``p`` whole over the batch axes, still split over ``model``; the
        backward reduce-scatters the gradient onto the shard."""
        steps = self._steps(p, self.batch_axes)
        return _Gather.apply(p, steps, True) if steps else p

    def whole(self, p: torch.Tensor, partial: bool = False) -> torch.Tensor:
        """``p`` whole on every rank. The compute that reads it runs whole on
        each ``model`` rank (the backward keeps this rank's slice), or with
        ``partial`` each rank's gradient is a part (the backward sums it over
        ``model``; a tensor the rules leave whole goes through ``copy_in``)."""
        w = self.gather_batch(p)
        steps = self._steps(p, ("model",))
        if steps:
            return _Gather.apply(w, steps, partial)
        return self.copy_in(w) if partial else w

    def full(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """A stored shard under ``spec`` gathered whole over every axis (no
        autograd: the optimizer's whole-leaf update)."""
        for d, entry in enumerate(spec):
            for a in reversed(shd._axes_of(entry)):
                t = all_gather(t, self.groups[a], d)
        return t

    def shard(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's shard of a whole ``t`` under ``spec`` (no collective)."""
        for d, entry in enumerate(spec):
            for a in shd._axes_of(entry):
                t = local_chunk(t, self.groups[a], d)
        return t

    # --- Megatron's f and g, and sums over the batch ------------------------
    def gather_model(self, x: torch.Tensor, dim: int, partial: bool = False) -> torch.Tensor:
        """Every ``model`` rank's part of ``x`` along ``dim``, concatenated;
        each rank then computes on the whole, so the backward keeps this
        rank's slice, or, with ``partial``, each rank's gradient of the whole
        is a part: the backward sums it over ``model`` onto this rank's
        slice (a reduce-scatter)."""
        return _Gather.apply(x, [(dim, self.model)], partial) if self.size > 1 else x

    def copy_in(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyIn.apply(x, self.model) if self.size > 1 else x

    # --- the "batch" attention mode's moves ---------------------------------
    def rows_over_model(self, rows: int) -> bool:
        """A layer of this rank's ``rows`` can split them over ``model``: the
        microbatch's global rows divide pod x data x model, as the JAX
        package's ``_maybe_shard`` requires of ``("pod", "data", "model")``
        (this rank's share of rows split over the batch axes divides
        ``model``; a batch held whole on every batch rank,
        ``batch_replicated``, does not divide them)."""
        return self.size > 1 and rows % self.size == 0 and not self.batch_replicated

    def split_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's ``1/model`` of the rows (dim 0) of ``x``, which every
        ``model`` rank holds whole; the backward gathers the rows'
        gradients over ``model`` in row order."""
        return _Split.apply(x, self.model, 0) if self.size > 1 else x

    def rows_to_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(rows, S, this rank's heads, D) -> (this rank's rows, S, every
        head, D): an all-to-all over ``model``, its inverse backward."""
        return _Swap.apply(x, self.model, 0, 2) if self.size > 1 else x

    def heads_to_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``rows_to_heads``' inverse."""
        return _Swap.apply(x, self.model, 2, 0) if self.size > 1 else x

    # --- the "sequence" attention mode's moves ------------------------------
    def seq_over_model(self, s: int) -> bool:
        """A layer of ``s`` positions can split its queries' positions over
        ``model``: ``model`` divides them, as the JAX package's
        ``_maybe_shard`` requires of q's sequence constrained to ``model``
        (it drops the constraint where it does not divide)."""
        return self.size > 1 and s % self.size == 0

    def seq_start(self, s: int) -> int:
        """The global position of this rank's first query of a sequence of
        ``s`` positions split over ``model`` (``split_seq``)."""
        return self.rank * (s // self.size)

    def split_seq(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's ``1/model`` of the positions (dim 1) of ``x``, which
        every ``model`` rank holds whole; the backward gathers the
        positions' gradients over ``model`` in order."""
        return _Split.apply(x, self.model, 1) if self.size > 1 else x

    def seq_to_heads(self, x: torch.Tensor) -> torch.Tensor:
        """(B, every position, this rank's heads, D) -> (B, this rank's
        positions, every head, D): an all-to-all over ``model``, its inverse
        backward."""
        return _Swap.apply(x, self.model, 1, 2) if self.size > 1 else x

    def heads_to_seq(self, x: torch.Tensor) -> torch.Tensor:
        """``seq_to_heads``' inverse."""
        return _Swap.apply(x, self.model, 2, 1) if self.size > 1 else x

    def reduce_out(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceOut.apply(x, self.model) if self.size > 1 else x

    # --- a recurrent cell on this rank's heads --------------------------------
    def heads_over_model(self, heads: int) -> bool:
        """A cell of ``heads`` heads can compute on this rank's: ``model``
        (above 1) divides them."""
        return self.size > 1 and heads % self.size == 0

    def parts_over_model(self, heads: int, width: int) -> bool:
        """A cell of ``heads`` heads of ``width`` columns can compute on a
        part of one head: ``model`` is a multiple g·heads with g > 1, and g
        divides the head's width (the rules' column blocks of the heads are
        then each one head's part)."""
        return (self.size > heads and self.size % heads == 0
                and width % (self.size // heads) == 0)

    def head_part(self, heads: int) -> HeadPart:
        """This rank's head and part where ``parts_over_model``. Every rank
        makes the head groups of a g together the first time one asks (all
        of them, in the same order: ``attach``)."""
        g = self.size // heads
        if g not in self._parts:
            import torch.distributed as dist
            axis = list(self.sizes).index("model")
            rows = self.mesh.mesh.movedim(axis, -1).reshape(-1, self.size).tolist()
            pg, _ = dist.new_subgroups_by_enumeration(
                [row[i:i + g] for row in rows for i in range(0, self.size, g)])
            self._parts[g] = Group(pg.group_name, g, self.rank % g)
        return HeadPart(g, self.rank // g, self._parts[g])

    def exchange(self, n: int, segments) -> ColumnExchange:
        """The ``ColumnExchange`` of ``n`` columns over ``model`` for this rank."""
        return exchange(n, tuple(segments), self.size, self.rank)

    def to_heads(self, x: torch.Tensor, ex: ColumnExchange, dim: int) -> torch.Tensor:
        """``x``'s block of ``dim`` (this rank's contiguous shard, of a weight
        or of a projection's output) -> the columns this rank's heads read:
        one all-to-all over ``model``; backward the reverse one, a shared
        column's gradient summed over ``model``."""
        return _Exchange.apply(x, ex, self.model, dim)

    def chunk(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's ``1/model`` of ``dim`` of ``x``, which every ``model``
        rank holds whole (a weight the rules leave whole): the backward
        gathers the chunks' gradients, so each rank's is the whole's."""
        return _Split.apply(x, self.model, dim) if self.size > 1 else x

    def rows_of(self, w: torch.Tensor) -> torch.Tensor:
        """A weight's ``model`` block of columns (its rows whole) -> this
        rank's ``1/model`` of its rows (its columns whole): an all-to-all
        over ``model`` (``swap_dims``), its inverse backward."""
        return _Swap.apply(w, self.model, 0, 1) if self.size > 1 else w

    def row_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Per-row float32 values summed over ``model`` (no autograd): the
        RMSNorm split mode's ``reduce``."""
        return all_reduce(t, self.model)

    def cache_to_heads(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """A cache shard (``tp_dim`` its ``model`` dim: ``cache_spec`` puts
        ``model`` on some dim of a state whose heads it divides) as this
        rank's ``1/model`` of ``dim`` (its heads), every other dim whole: an
        all-to-all where ``model`` is on another dim."""
        return t if t.tp_dim == dim else swap_dims(t, self.model, dim, t.tp_dim)

    def keep_heads(self, dst: torch.Tensor, t: torch.Tensor, dim: int) -> None:
        """Write this rank's heads ``t`` of a new state (``cache_to_heads``'
        layout) into the cache shard ``dst``."""
        dst.copy_(t if dst.tp_dim == dim else swap_dims(t, self.model, dst.tp_dim, dim))

    def cache_to_part(self, t: torch.Tensor, hp: HeadPart, dim: Optional[int]) -> torch.Tensor:
        """A cache shard (B, heads, ...) as this rank's head (a dim of one)
        and part ``hp`` of ``dim`` (None: a state of no width, m), every
        other dim whole. ``cache_spec`` leaves a state whole (sliced here),
        puts ``model`` on ``dim`` (an all-to-all: this rank's block of ``dim``
        of every head to the ranks of each head's part that holds it), or on
        a later dim (an all-to-all of (heads·``dim``) in ``model`` chunks, one
        a rank, the later dim's blocks concatenated: mLSTM's C, its value
        rows against every key column)."""
        src = t.tp_dim
        if src is None:
            t = t.narrow(1, hp.head, 1)
            return t if dim is None else t.narrow(dim, hp.part * (t.shape[dim] // hp.g),
                                                  t.shape[dim] // hp.g)
        heads = self.size // hp.g
        if src == dim:
            p = self.rank // heads          # the part this rank's block lies in
            out = all_to_all(t.movedim(1, 0), self.model,
                             [int(i // heads == hp.part) for i in range(self.size)],
                             [int(r % hp.g == p) for r in range(self.size)])
            return torch.cat(out.unbind(0), dim=dim - 1).unsqueeze(1)
        if dim == 2 and src > dim:
            return swap_dims(t.flatten(1, 2), self.model, 1, src - 1).unsqueeze(1)
        raise ValueError(f"cache {tuple(t.shape)}: model on dim {src}, parts of dim {dim}")

    def keep_part(self, dst: torch.Tensor, t: torch.Tensor, hp: HeadPart,
                  dim: Optional[int]) -> None:
        """Write this rank's head and part ``t`` of a new state
        (``cache_to_part``'s layout) into the cache shard ``dst``: the
        inverse all-to-all, or for a state left whole every rank's part
        gathered over ``model`` (a head's g copies of m are equal)."""
        src = dst.tp_dim
        heads = self.size // hp.g
        if src is None:
            x = all_gather(t, self.model, 1).unflatten(1, (heads, hp.g))
            dst.copy_(x[:, :, 0] if dim is None else x.movedim(2, dim).flatten(dim, dim + 1))
        elif src == dim:
            p = self.rank // heads
            x = torch.stack(t.squeeze(1).chunk(heads, dim=dim - 1))
            out = all_to_all(x, self.model, [int(r % hp.g == p) for r in range(self.size)],
                             [int(i // heads == hp.part) for i in range(self.size)])
            dst.copy_(out.movedim(0, 1))
        else:
            x = swap_dims(t.squeeze(1), self.model, src - 1, 1)
            dst.copy_(x.unflatten(1, (heads, x.shape[1] // heads)))

    def max_over_model(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x.detach(), self.model, "max")

    def batch_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over the batch ranks of a value every rank then uses
        (differentiable: the ranks along ``model`` hold the same value)."""
        groups = [self.groups[a] for a in self.batch_axes if self.sizes[a] > 1]
        if not groups:
            return x
        return _SumBoth.apply(x, groups) / self.n_batch

    def sum_over(self, x: torch.Tensor, axes: Sequence[str], op: str = "sum") -> torch.Tensor:
        for a in axes:
            x = all_reduce(x, self.groups[a], op)
        return x

    # --- the serve step's caches (no autograd) ------------------------------
    def cache_dim(self, shape: Sequence[int], allowed: Optional[Sequence[int]] = None
                  ) -> Optional[int]:
        """The dim of a cache tensor of ``shape`` (one block application's,
        (B, ...state)) that ``sharding.cache_spec`` puts ``model`` on, or None
        (whole on every ``model`` rank). ``allowed``: the dims the layer can
        compute a shard of (an attention cache's sequence); another is
        refused."""
        spec = shd.cache_spec(tuple(shape), {"model": self.size})
        dim = next((d for d, e in enumerate(spec) if e == "model"), None)
        if dim is not None and allowed is not None and dim not in allowed:
            raise ValueError(f"cache {tuple(shape)}: cache_spec puts model ({self.size}) on dim "
                             f"{dim}; this layer computes on a shard of dims {tuple(allowed)} "
                             "only (serve rounds the cache length up to a multiple of model)")
        return dim

    def local_cache(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of a whole cache tensor, with its ``model`` dim
        (``cache_dim``) as ``tp_dim``."""
        dim = self.cache_dim(t.shape)
        out = t if dim is None else local_chunk(t, self.model, dim).clone()
        out.tp_dim = dim
        return out

    def gather_cache(self, t: torch.Tensor) -> torch.Tensor:
        """A cache shard made whole over ``model``."""
        dim = getattr(t, "tp_dim", None)
        return t if dim is None else all_gather(t, self.model, dim)

    def keep_cache(self, dst: torch.Tensor, whole: torch.Tensor) -> None:
        """Write this rank's shard of ``whole`` into the cache shard ``dst``."""
        dim = getattr(dst, "tp_dim", None)
        dst.copy_(whole if dim is None else local_chunk(whole, self.model, dim))

    def seq_offset(self, t: torch.Tensor) -> int:
        """The global position of a cache shard's first entry."""
        return self.rank * t.shape[1] if getattr(t, "tp_dim", None) == 1 else 0

    def merge_over_model(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """Each ``model`` rank's attention output over its shard of the keys,
        out (B, Q, H, Dv) with lse (B, H), merged into the whole keys'
        output: weights exp(lse - max over ranks), the weighted outputs and
        the weights summed over ranks in one all-reduce (``ref.merge_shards``
        across ranks), in float32. A shard with no valid key (lse NEG_INF)
        weighs 0."""
        if self.size == 1:
            return out.float()
        m = all_reduce(lse.float(), self.model, "max")
        w = torch.exp(lse.float() - m)[:, None, :, None]
        w = w.expand(*out.shape[:-1], 1)
        both = all_reduce(torch.cat([out.float() * w, w], dim=-1), self.model)
        return both[..., :-1] / both[..., -1:]

    def units(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this rank's block of ``n`` units split over ``model``."""
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


# ---------------------------------------------------------------------------
# A model on its shards
# ---------------------------------------------------------------------------

def write_cache(tp: Optional[TensorParallel], dst: torch.Tensor, src: torch.Tensor,
                start: int) -> None:
    """Write ``src``, the whole new entries at positions ``start`` ..
    ``start + src.shape[1] - 1`` of a cache's sequence, into ``dst``: the
    whole cache on one device (``tp`` None), else this rank's shard of it:
    where ``model`` cuts the sequence (``tp_dim`` 1), the positions this rank
    holds (none, some or all)."""
    off = tp.seq_offset(dst) if tp is not None else 0
    a, b = max(start, off), min(start + src.shape[1], off + dst.shape[1])
    if a < b:
        dst[:, a - off:b - off] = src[:, a - start:b - start].to(dst.dtype)


def param_specs(model, mesh, **rules) -> Dict[str, tuple]:
    """The rules' spec of each parameter (``sharding.param_specs`` of the
    whole shapes, with its ``attn_zero``/``moe_zero`` ``rules``; a parameter
    already cut carries its own)."""
    shapes = {n: getattr(p, "tp_full_shape", tuple(p.shape)) for n, p in model.named_parameters()}
    return shd.param_specs(shapes, mesh, **rules)


def attach(model, tp: TensorParallel) -> TensorParallel:
    """Every module of ``model`` computes over ``tp``; the head groups of a
    cell that computes on a part of one head are made (every rank makes
    them together, here, outside any step)."""
    for m in model.modules():
        m.tp = tp
    for m in model.modules():
        if hasattr(m, "head_part"):
            m.head_part()
    return tp


def cut(model, tp: TensorParallel, specs: Dict[str, tuple]) -> None:
    """Cut each whole, materialised parameter of ``model`` to this rank's
    shard under ``specs`` in place; one already cut, or still on the meta
    device while the model is not, is left alone."""
    all_meta = all(q.is_meta for q in model.parameters())
    with torch.no_grad():
        for name, p in model.named_parameters():
            if hasattr(p, "tp_spec") or (p.is_meta and not all_meta):
                continue
            full_shape = tuple(p.shape)
            p.data = tp.shard(p.data, specs[name]).clone()
            p.tp_spec, p.tp_full_shape = specs[name], full_shape


def shard_model(model, mesh, **rules) -> TensorParallel:
    """Turn a model holding whole parameters into one on this rank's shards
    (every rank holds the same whole model; nothing is sent). A model on its
    shards is moved onto ``mesh``'s groups (a mesh rebuilt after a restart).
    ``rules``: ``param_specs``' ``attn_zero``/``moe_zero``."""
    tp = getattr(model, "tp", None)
    if tp is not None and tp.mesh is mesh:
        return tp
    tp = TensorParallel(mesh)
    cut(model, tp, param_specs(model, mesh, **rules))
    return attach(model, tp)


def build_sharded(model, mesh, generator: torch.Generator, **rules) -> TensorParallel:
    """Draw the weights of ``model``, built on the meta device, onto
    ``generator``'s device as the one-device ``init_weights`` draws them,
    cutting each part to this rank's shards as soon as it is drawn: no more
    than one block is ever whole. ``rules`` as ``shard_model``'s."""
    tp = TensorParallel(mesh)
    specs = param_specs(model, mesh, **rules)
    model.init_weights(generator, cut=lambda: cut(model, tp, specs))
    return attach(model, tp)


def placements(model, mesh) -> Dict[str, list]:
    """Each parameter's DTensor placements (``sharding.placements`` of its spec)."""
    return {n: shd.placements(TensorParallel.spec(p), mesh) for n, p in model.named_parameters()}
