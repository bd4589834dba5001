"""Dry run: every (architecture x input shape x mesh) cell's FLOPs, bytes,
per-device memory and collectives, counted without weights or a GPU.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-2b \\
        --shape train_4k [--multi-pod | --both-meshes] [--roofline] \\
        [--out experiments/dryrun_torch]

Port of ``repro.launch.dryrun``. The JAX package lowers and compiles each cell
for 256 or 512 forced host devices and reads XLA's memory and cost analyses.
The port has no compiler to ask. ``trace_cell`` builds the model on the meta
device (shapes and dtypes, no storage) with ``use_kernel=False``, as the JAX
package's ``lower_cell`` does, and runs one device's step on it under
``StepCounter``, a dispatch mode that counts each op's FLOPs by the rules of
``torch.utils.flop_counter`` (its ``flop_registry``), sums each op's input and output
bytes (the unfused upper bound, as XLA's "bytes accessed" is) and follows
the bytes alive at once through finalizers on the outputs' storages.
``FlopCounterMode`` itself is not used: its module tracker keeps activations
alive through the step (2.6 GB more at the peak of gemma2-2b's train step at
2 units, measured on the meta device). The steps:

  * train on one device: ``make_train_step`` (the one-device step) with the
    config's microbatches, remat and optimizer;
  * train on a mesh: rank 0's share of the sharded step
    (``steps.make_local_step``) on the model cut to its shards
    (``parallel.tensor.shard_model``), run by the port's own tensor- and
    expert-parallel code under torch's fake process group (``fake_world``:
    the groups exist, nothing moves). ``StepCounter`` records each
    collective op the step issues instead of running it, so the FLOPs, the
    bytes and the collectives are those of the code that runs. Every rank of
    a mesh holds shards of one shape, so rank 0 stands for all; under the
    "sequence" attention mode the last ``model`` rank (``traced_rank``: the
    one that holds the last query positions; the plain attention masks
    every key and cuts none, so every rank's FLOPs are equal);
  * prefill: ``make_prefill_step``; decode: ``make_decode_step`` at the last
    position of a cache of the shape's length. On a mesh, the last rank's
    share of the sharded serve step, as the JAX package's ``lower_cell``
    places it: the model cut to its shards under ``param_specs`` with the
    ``zero_rules`` (``parallel.tensor.shard_model``), its rows of the batch,
    its shard of the caches under ``cache_spec`` (the sequence over
    ``model``), each layer computed on its shard and a decode step's
    attention merged over ``model`` (``models/attention.py``), under the same
    fake group. The last rank holds the decoded position, so its shard of
    the cache is all valid keys: the rank with the most work.

The mesh is a plain ``{axis: size}`` mapping; the fake group of 256 or 512
ranks costs nothing. A device does what the port does:

  * a train step's batch splits over ``pod x data`` (``steps.local_batch``);
    each layer runs on this rank's ``model`` shard where the heads, the FFN
    columns, the experts or the vocab divide by the ``model`` size, and whole
    on every ``model`` rank where they do not (attention where ``n_heads``
    does not divide: gemma2-2b's 8, smollm-135m's 9, musicgen-medium's 24,
    yi-34b's and arctic-480b's 56 at 16), whose weights are then gathered
    over ``model`` too. A recurrent cell whose heads divide (zamba2-7b's 112
    Mamba2 heads) computes on the rank's heads (``models/ssm.py``): its
    projections' columns moved by all-to-alls over ``model``, its norm's
    row sums and its output all-reduced over ``model``; an xLSTM cell whose
    4 heads ``model`` 16 does not divide (xlstm-125m) on a part of one head,
    1/4 of its width, its scores, normaliser, q and k and sLSTM's hidden
    state summed or gathered over the head's 4 ranks;
  * ``memory.argument_bytes`` is the state stored under the JAX package's
    placements: ``param_specs`` with its ``attn_zero`` rule (tp = the mesh's
    ``model`` size) and ``moe_zero``; the optimizer state under
    ``opt_state_shardings`` (``sharding.opt_state_specs``, as
    ``shard_train_state`` places it: the ``adamw`` moments and the factored
    first moment like their parameter, the factored row and column
    statistics whole, the 8-bit blocks like the JAX leaf where it is 2-D;
    a stacked leaf's state as ``adamw.tree_layout`` holds it) and the int8
    residual like its parameter;
    ``cache_specs`` at ``kv_cache_dtype`` and ``batch_spec``;
  * ``memory.gathered_bytes`` is what a device holds beyond its shards: in a
    train step the most bytes of all-gather outputs alive at once in the
    trace (a layer's weights whole over the batch axes, the factored
    optimizer's row and column statistics, or ``adamw_8bit`` gathering one
    leaf whose state is whole, its gradient and its state), plus the
    global batch the step takes; in a serve step likewise the most bytes of
    all-gather outputs alive (a layer's weights over the batch axes, the
    activations a layer gathers over ``model``: the new keys, the queries of
    every head, the logits of every vocab shard). ``fits`` is false where
    that does not fit 80 GB, which is a finding;
  * ``attn_activation_sharding`` is resolved as the JAX package's
    ``build_model`` resolves it (``models.model.attn_activation_mode``:
    "auto" is "batch" where the kv heads do not divide 16 and the model has
    no MLA) and runs in the traced step: under "batch", a GQA layer whose
    rank's rows divide ``model`` attends its ``1/model`` of them over every
    head, under "sequence" one whose sequence divides ``model`` its
    ``1/model`` of the query positions against every key
    (``models/attention.py``; their all-to-alls over ``model`` counted as
    "all-to-all"); the record carries the configured value, the resolved
    one (``parallel.attn_activation_mode``) and the traced rank
    (``parallel.traced_rank``);
  * a step's collectives are those its trace issued (``collectives_of``): a
    serve step's are each layer's gathers of its weights over the batch
    axes, the tensor-parallel all-reduces over ``model``, the gathers of
    the new keys, the queries and the logits, and a decode step's merge of
    the attention over ``model``.

A mesh of one device is the one-device step: no gathered copy, no
collective (``chip_smoke.py``'s ``[dryrun]`` holds such cells to the card).

Trip counts. FLOPs, bytes and peak bytes come from traces at 2 and 3 units
(``with_units``; the whole model where it has no more), extrapolated to
``full_units`` as the JAX package's ``roofline_cell`` extrapolates its 1 and
2: FLOPs and bytes are affine in the units. The peak is the largest of the
bytes alive at each point of the step: the two traces' timelines are
aligned (``counterparts``: the longer one is the shorter with the added
unit's ops inserted) and each point extrapolated, which is exact where the
added unit repeats a later one, hence 2 and 3 (``UNITS``). A model of
recurrent blocks only (xlstm-125m) steps its sLSTM one token at a time in
Python, so its prefill and train cells are traced at two sequence lengths
(``LENGTHS``) and extrapolated in the length too: mLSTM chunks, sLSTM steps
and the loss's chunks are linear in S, and so are the collectives of a cell
on a part of a head, so the traces give the full cell exactly. Eager counting counts every step of a loop, so the JAX package's
``scan_utils`` (XLA counts a ``scan`` body once) has no counterpart. The
record's ``extrapolation`` says what was traced and how the peak was
extrapolated, and gives the affine peak's temporaries beside it
(``affine_temp_bytes``): where the peak moves from the loss to the backward
pass as units are added, the affine peak of the two traces falls short of
the full-depth trace and the aligned timelines do not.

Record keys follow the JAX package's where they mean the same. Renamed:
``compile_s`` -> ``trace_s``; ``flops_per_device_scanbody_once`` ->
``flops_per_device`` (and ``bytes_per_device_scanbody_once`` ->
``bytes_per_device``, ``collectives_scanbody_once`` -> ``collectives``);
``tpu_corrected_peak_bytes`` -> ``peak_bytes``; in ``roofline``,
``t_mem_hlo_s`` -> ``t_mem_traced_s``, ``t_mem_tpu_s`` -> ``t_mem_s`` (the
structural estimate), ``dominant_hlo`` -> ``dominant_traced``,
``hlo_flops_global`` -> ``flops_global`` and ``roofline_fraction_hlo`` ->
``roofline_fraction_traced``. ``cpu_float_normalization_bytes`` (an XLA:CPU
artifact) has no counterpart. The roofline is written for both meshes. As the
JAX package's ``roofline_cell``, a train cell's roofline is traced at one
microbatch, while its memory, ``cost_analysis`` and ``collectives`` are the
config's microbatches' (``run_cell``); the roofline section keeps the costs
it was computed from and their microbatches (``stored_cost``), which
``--roofline-only`` reads.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.common.config import RunConfig, SHAPES, ShapeSpec, shape_applicable
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh as meshmod
from repro_torch.launch import roofline as rl
from repro_torch.models.model import (attn_activation_mode, build_model,
                                      count_params_analytic, input_specs)
from repro_torch.models.transformer import RECURRENT_BLOCKS, layer_plan, stacked_leaves
from repro_torch.optim import adamw
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor
from repro_torch.parallel.compression import ErrorFeedback
from repro_torch.train.steps import (local_opt_state, make_decode_step, make_local_step,
                                     make_prefill_step, make_train_step, mark_batch,
                                     state_specs)

DEFAULT_OUT = "experiments/dryrun_torch"
# the JAX package's production meshes (launch/mesh.py::make_production_mesh)
MESHES = {False: ("single_pod_16x16", {"data": 16, "model": 16}),
          True: ("multi_pod_2x16x16", {"pod": 2, "data": 16, "model": 16})}
# the units of the two traces a cell is extrapolated from. The JAX package
# lowers 1 and 2; here a first unit may hold fewer bytes than a later one (the
# audio family's first block reads the batch's embeddings in place, a later
# one its predecessor's new output), and the peak's extrapolation needs the
# added unit to repeat a later one: 2 and 3
UNITS = (2, 3)
# the two lengths of a recurrent-only model's traces, by step: multiples of
# the mLSTM chunk (256), the second at most twice the first (the longer
# trace's extra steps then repeat steps the shorter one has, which the peak's
# extrapolation needs). The train step's loss reads S - 1 positions in
# chunks of 512, which a length of 512 leaves in one chunk of 511 and every
# longer multiple of 512 pads to S, so its lengths are such multiples above 512
LENGTHS = {"train": (1024, 1536), "prefill": (512, 768)}


# ---------------------------------------------------------------------------
# Reduced-depth configs for per-unit cost extraction
# ---------------------------------------------------------------------------

def with_units(run: RunConfig, k: int) -> RunConfig:
    cfg = run.model
    if cfg.cross_attn_every:
        n = k * cfg.cross_attn_every
    elif cfg.shared_attn_every and cfg.ssm is not None:
        rem = cfg.n_layers % cfg.shared_attn_every
        n = k * cfg.shared_attn_every + rem
    elif cfg.block_pattern:
        n = k * len(cfg.block_pattern)
    elif cfg.local_global_alternating:
        n = 2 * k
    elif cfg.moe is not None and cfg.first_k_dense:
        n = cfg.first_k_dense + k
    else:
        n = k
    return run.replace(model=dataclasses.replace(cfg, n_layers=n))


def full_units(run: RunConfig) -> int:
    cfg = run.model
    if cfg.cross_attn_every:
        return cfg.n_layers // cfg.cross_attn_every
    if cfg.shared_attn_every and cfg.ssm is not None:
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.block_pattern:
        return cfg.n_layers // len(cfg.block_pattern)
    if cfg.local_global_alternating:
        return cfg.n_layers // 2
    if cfg.moe is not None and cfg.first_k_dense:
        return cfg.n_layers - cfg.first_k_dense
    return cfg.n_layers


def recurrent_only(run: RunConfig) -> bool:
    """Every block is recurrent: the cost is linear in the sequence."""
    return all(k in RECURRENT_BLOCKS for k in layer_plan(run.model))


# ---------------------------------------------------------------------------
# Counting one device's step on the meta device
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_nbytes(t: torch.Tensor) -> int:
    """The bytes ``torch.empty_strided`` gives a tensor of ``t``'s shape and strides."""
    if t.numel() == 0:
        return 0
    return (1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride()))) * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


_aten = torch.ops.aten
# ops that move no data and are not views: allocations, and a reshape that
# shares its input's storage without an alias annotation
NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
              _aten.new_empty.default, _aten.new_empty_strided.default,
              _aten._unsafe_view.default}


def _fresh_outputs(func) -> bool:
    """The op writes no input and declares no output an alias of one."""
    schema = func._schema
    return (not func.is_view and not schema.is_mutable
            and all(r.alias_info is None for r in schema.returns))


_LEAF_TYPES = (int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
               torch.memory_format)


class _Empty(NamedTuple):
    shape: tuple
    stride: tuple
    dtype: torch.dtype
    device: torch.device


class StepCounter(TorchDispatchMode):
    """Counts what a step does on the meta device: each op's FLOPs
    (``flop_registry``), its input and output bytes (views and allocations
    move none), and the bytes of the storages alive at once: a storage
    counts from the op that made it (or from ``hold``, for the step's
    arguments) until it is freed.

    Most meta kernels are Python (``torch._refs``), about 0.6 ms an op, and a
    step repeats the same ops on the same shapes (every layer, token step
    and microbatch). So an op that makes fresh outputs is run once for each
    signature (the op, its inputs' shapes, strides, dtypes and devices, its
    other arguments); a repeat gets new empty tensors of the outputs' recorded
    metadata, which is all a meta kernel gives."""

    def __init__(self, ids: Optional[dict] = None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        # the collectives (``roofline.CollectiveStats``) and the bytes alive
        # of all-gathers' outputs (what a rank holds beyond its shards)
        self.coll = rl.CollectiveStats()
        self.gathered_live = 0
        self.gathered_peak = 0
        # the timeline: each op's signature id (the op and its inputs', or
        # else its outputs', metadata), the op's id, the bytes alive after it;
        # ``ids`` numbers them, shared by the traces that are compared
        self.sigs, self.names, self.lives = [], [], []
        self._ids = {} if ids is None else ids
        self._held = set()
        self._outputs = {}          # signature -> _record of its outputs
        self._fresh = {}            # op -> _fresh_outputs(op)

    def hold(self, tensors) -> None:
        for t in tensors:
            self._hold(t)

    def _hold(self, t: torch.Tensor, gathered: bool = False) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._held:
            return
        n = st.nbytes()
        self._held.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        if gathered:
            self.gathered_live += n
            self.gathered_peak = max(self.gathered_peak, self.gathered_live)
        weakref.finalize(st, self._free, key, n, gathered).atexit = False

    def _free(self, key: int, n: int, gathered: bool = False) -> None:
        self._held.discard(key)
        self.live -= n
        if gathered:
            self.gathered_live -= n

    def _collective(self, func, args):
        """A ``_c10d_functional`` op: recorded, not run (on the meta device
        under a fake group nothing would move); an empty output of its shape."""
        name = func._schema.name.split("::")[1]
        if name == "wait_tensor":
            return args[0]
        t = args[0]
        if name == "all_reduce":
            kind, shape, group = "all-reduce", t.shape, _group_size(args[2])
        elif name == "all_gather_into_tensor":
            kind, shape, group = "all-gather", (t.shape[0] * args[1], *t.shape[1:]), args[1]
        elif name == "reduce_scatter_tensor":
            kind, shape, group = "reduce-scatter", (t.shape[0] // args[2], *t.shape[1:]), args[2]
        elif name == "all_to_all_single":
            kind, shape, group = "all-to-all", (sum(args[1]), *t.shape[1:]), _group_size(args[3])
        else:
            raise NotImplementedError(f"the dry run does not count {func}")
        out = torch.empty(shape, dtype=t.dtype, device=t.device)
        nbytes = _nbytes(out) if kind == "all-gather" else _nbytes(t)
        if group > 1:
            self.coll.add(kind, nbytes, group)
        return out

    def _run(self, func, args, kwargs, ins):
        """(the op's outputs, its signature or None)."""
        fresh = self._fresh.get(func)
        if fresh is None:
            fresh = self._fresh[func] = _fresh_outputs(func)
        sig = (func, _signature(args, ins), _signature(kwargs, ins)) if fresh else None
        if sig is None or None in sig:
            return func(*args, **kwargs), None
        known = self._outputs.get(sig)
        if known is not None:
            return _replay(known), sig
        out = func(*args, **kwargs)
        record = _record(out, {id(t.untyped_storage()) for t in ins})
        if record is not None:
            self._outputs[sig] = record
        return out, sig

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "_c10d_functional":
            out = self._collective(func, args)
            self._hold(out, gathered=func._schema.name.endswith("all_gather_into_tensor"))
            sig = (func, tuple(out.shape), out.dtype)
            self.sigs.append(self._ids.setdefault(sig, len(self._ids)))
            self.names.append(self._ids.setdefault(func, len(self._ids)))
            self.lives.append(self.live)
            return out
        ins = []            # the input tensors, which _run collects for a fresh-output op
        out, sig = self._run(func, args, kwargs, ins)
        if not self._fresh[func]:
            ins = _tensors((args, kwargs))
        rule = flop_registry.get(func._overloadpacket)
        if rule is not None:
            self.flops += rule(*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if not func.is_view and func not in NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        for t in outs:
            self._hold(t)
        if sig is None:
            sig = (func, tuple((tuple(t.shape), t.dtype) for t in outs))
        self.sigs.append(self._ids.setdefault(sig, len(self._ids)))
        self.names.append(self._ids.setdefault(func, len(self._ids)))
        self.lives.append(self.live)
        return out


def _group_size(name: str) -> int:
    import torch.distributed as dist
    return dist.distributed_c10d._resolve_process_group(name).size()


def _signature(x, tensors: list):
    """``x`` with each tensor replaced by its metadata (every tensor appended
    to ``tensors``), lists as tuples; None where an argument is not plain."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return (tuple(x.shape), x.stride(), x.dtype, x.device, x.storage_offset())
    if isinstance(x, (list, tuple)):
        out = tuple(_signature(y, tensors) for y in x)
        return None if any(y is None and z is not None for y, z in zip(out, x)) else out
    if isinstance(x, dict):
        out = tuple((k, _signature(v, tensors)) for k, v in x.items())
        return None if any(y is None and x[k] is not None for k, y in out) else out
    return x if isinstance(x, _LEAF_TYPES) else None


def _record(out, inputs: set):
    """What ``_replay`` needs to make ``out`` again: each tensor's metadata,
    or None where an output is not a fresh storage of its own (an input's
    storage: ``_unsafe_view`` has no alias annotation; an offset; more bytes
    than ``empty_strided`` gives) or the output is not a tensor or a flat
    tuple or list."""
    items = out if isinstance(out, (list, tuple)) else [out]
    metas = []
    for x in items:
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if id(st) in inputs or x.storage_offset() or st.nbytes() != _storage_nbytes(x):
                return None
            metas.append(_Empty(tuple(x.shape), x.stride(), x.dtype, x.device))
        elif isinstance(x, _LEAF_TYPES):
            metas.append(x)
        else:
            return None
    return (type(out) if isinstance(out, (list, tuple)) else None), metas


def _replay(record):
    kind, metas = record
    items = [torch.empty_strided(m.shape, m.stride, dtype=m.dtype, device=m.device)
             if isinstance(m, _Empty) else m for m in metas]
    return items[0] if kind is None else kind(items)


@dataclasses.dataclass
class Trace:
    """One device's step as traced: FLOPs, bytes moved, the most bytes alive
    at once (its arguments included), its arguments' bytes, the collectives
    it issued, the most bytes of all-gathers' outputs alive at once, and the
    timeline (``StepCounter``'s ``sigs``, ``names``, ``lives``)."""
    flops: float
    bytes: float
    peak_bytes: float
    arg_bytes: float
    seconds: float
    coll: rl.CollectiveStats = dataclasses.field(default_factory=rl.CollectiveStats)
    gathered_bytes: float = 0.0
    sigs: list = dataclasses.field(default_factory=list, repr=False)
    names: list = dataclasses.field(default_factory=list, repr=False)
    lives: list = dataclasses.field(default_factory=list, repr=False)


def batch_rows(global_batch: int, mesh_sizes: Dict[str, int], microbatches: int = 1) -> int:
    """A device's rows of the global batch: its share over ``pod x data``
    where ``microbatches`` x that divides the batch, else all of it
    (``steps.local_batch``)."""
    n = math.prod(mesh_sizes.get(a, 1) for a in shd.BATCH_AXES)
    return global_batch if global_batch % (microbatches * n) else global_batch // n


def optimizer_config(run: RunConfig) -> adamw.OptimizerConfig:
    """The Trainer's optimizer (``train/trainer.py``)."""
    return adamw.OptimizerConfig(kind=run.parallel.optimizer_state,
                                 weight_decay=run.train.weight_decay)


def init_opt_state(run: RunConfig, params: Dict[str, torch.Tensor], mesh=None):
    """The Trainer's initial optimizer state: ``adamw.init_state``, and the
    int8 residual ``ef`` with int8 compression. On a ``mesh``, for
    parameters cut to a rank's shards, this rank's share: each state tensor
    made on its shard under ``steps.state_specs`` and ``ef`` on the
    parameter's (``steps.init_train_state``)."""
    state = local_opt_state(optimizer_config(run), params, {} if mesh is None else mesh,
                            stacked_leaves(run.model, params))[0]
    if run.parallel.grad_compression == "int8":
        state["ef"] = ErrorFeedback.init(params)
    return state


@contextlib.contextmanager
def fake_world(mesh_sizes: Dict[str, int], rank: int = 0):
    """A ``DeviceMesh`` of ``mesh_sizes`` over torch's fake process group,
    this process its ``rank``: the groups exist, and a collective would move
    nothing (``StepCounter`` runs none). The process may have no other group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run traces a mesh under a fake process group of its own, "
                           "and this process already has a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=math.prod(mesh_sizes.values()))
    try:
        yield init_device_mesh("cpu", tuple(mesh_sizes.values()),
                               mesh_dim_names=tuple(mesh_sizes))
    finally:
        dist.destroy_process_group()


def traced_rank(run: RunConfig, shape: ShapeSpec, mesh_sizes: Dict[str, int]) -> Tuple[int, str]:
    """The rank whose share of the step a cell traces, and why: a serve
    step's last rank (it holds the decoded position); a train step's rank 0,
    or under the "sequence" attention mode the last ``model`` rank of the
    first batch coordinate, which holds the last query positions (the plain
    attention masks every key and cuts none, so each ``model`` rank's FLOPs
    are equal). The mesh's ``model`` axis is its last."""
    if math.prod(mesh_sizes.values()) == 1:
        return 0, "one device"
    if shape.kind != "train":
        return (math.prod(mesh_sizes.values()) - 1,
                "the last rank, which holds the decoded position")
    if attn_activation_mode(run) == "sequence":
        return (mesh_sizes.get("model", 1) - 1,
                "the last model rank, which holds the last query positions; the plain "
                "attention masks every key and cuts none, so every model rank's FLOPs are equal")
    return 0, "every rank holds shards of one shape"


def trace_cell(run: RunConfig, shape: ShapeSpec, mesh_sizes: Dict[str, int], *,
               units: Optional[int] = None, seq_len: Optional[int] = None,
               ids: Optional[dict] = None) -> Trace:
    """One device's step of the cell (``run`` at ``units`` units, or whole;
    ``shape`` at ``seq_len``, or its own) on the meta device, counted;
    ``ids`` numbers the timeline's signatures (share it between traces to be
    aligned). A train step on a mesh of more than one device is rank 0's
    share of the sharded step (``steps.make_local_step``), run by the port's
    own TP code on the model cut to that rank's shards, under a fake process
    group (``fake_world``); a serve step the last rank's share of the
    sharded serve step (module docstring)."""
    if units is not None:
        run = with_units(run, units)
    seq = shape.seq_len if seq_len is None else seq_len
    k = max(run.parallel.microbatches, 1) if shape.kind == "train" else 1
    rows = batch_rows(shape.global_batch, mesh_sizes, k)
    local = ShapeSpec(shape.name, seq, rows, shape.kind)
    model = build_model(run, device="meta", use_kernel=False)
    batch = input_specs(run.model, local)
    world = math.prod(mesh_sizes.values())
    meshed = world > 1
    rank = traced_rank(run, shape, mesh_sizes)[0]
    n_batch = math.prod(mesh_sizes.get(a, 1) for a in shd.BATCH_AXES)
    with (fake_world(mesh_sizes, rank) if meshed else contextlib.nullcontext()) as mesh:
        if shape.kind == "train":
            run = run.replace(train=dataclasses.replace(run.train, seq_len=seq,
                                                        global_batch=rows))
            opt_cfg = optimizer_config(run)
            if meshed:
                tp = tensor.shard_model(model, mesh)
                mark_batch(tp, shape.global_batch, k, n_batch)
                params = dict(model.named_parameters())
                opt_state = init_opt_state(run, params, mesh)
                step = make_local_step(model, run, opt_cfg, tp)
            else:
                params = dict(model.named_parameters())
                opt_state = init_opt_state(run, params)
                step = make_train_step(model, run, opt_cfg)
            args = [*params.values(), *_tensors(opt_state), *batch.values()]

            def call():
                step(params, opt_state, batch)
        else:
            if meshed:
                attn_zero, moe_zero = shd.zero_rules(run, mesh_sizes)
                tp = tensor.shard_model(model, mesh, attn_zero=attn_zero, moe_zero=moe_zero)
                mark_batch(tp, shape.global_batch, 1, n_batch)
                seq = shd.serve_cache_len(seq, mesh_sizes)
            cache = model.init_cache(rows, seq, dtype=getattr(torch, run.parallel.kv_cache_dtype))
            args = [*model.parameters(), *_tensors(cache), *batch.values()]
            if shape.kind == "prefill":
                prefill = make_prefill_step(model)

                def call():
                    prefill(batch, cache)
            else:
                decode = make_decode_step(model)

                def call():
                    decode(batch, cache, seq - 1)
        counter = StepCounter(ids)
        counter.hold(args)
        arg_bytes = counter.live
        t0 = time.perf_counter()
        with counter:
            call()
    return Trace(float(counter.flops), float(counter.bytes), float(counter.peak),
                 float(arg_bytes), time.perf_counter() - t0, counter.coll,
                 float(counter.gathered_peak), counter.sigs, counter.names, counter.lives)


def collectives_of(run: RunConfig, shape: ShapeSpec,
                   mesh_sizes: Dict[str, int]) -> rl.CollectiveStats:
    """The collectives one rank's share of the cell's step issues, as its
    trace counts them (``trace_cell``; a group of one rank moves nothing and
    is not counted). A serve step's: see the module docstring. A train
    step's: each layer's gathers over the batch axes in the
    forward and again in remat's recompute, the reduce-scatters of their
    gradients, the all-reduces over ``model`` of the tensor-parallel layers
    (forward, backward and recompute) and of the vocab-parallel loss, the
    all-reduces over the batch axes of the gradients they leave whole, the
    factored optimizer's all-reduces and all-gathers of its row and column
    sums, ``adamw_8bit``'s whole-leaf gathers (and, for a leaf whose state
    sits like it, the all-to-alls of its codes and the max of its blocks'
    scales), the "batch" attention mode's moves over ``model``, the
    metrics, the global norm, the int8 maxima and the MoE load-balance
    means."""
    return trace_cell(run, shape, mesh_sizes).coll


# ---------------------------------------------------------------------------
# Per-device state under the placements
# ---------------------------------------------------------------------------

def _sharded(nbytes: int, spec, sizes: Dict[str, int]) -> float:
    return nbytes / math.prod(sizes[a] for e in spec for a in shd._axes_of(e))


def state_bytes(run: RunConfig, shape: ShapeSpec, mesh_sizes: Dict[str, int]) -> Dict[str, float]:
    """A device's stored arguments of the cell, in bytes, under the
    placements (module docstring), and the full sizes they are cut from."""
    sizes = dict(mesh_sizes)
    model = build_model(run, device="meta", use_kernel=False)
    params = dict(model.named_parameters())
    attn_zero, moe_zero = shd.zero_rules(run, sizes)
    specs = shd.param_specs(params, sizes, attn_zero=attn_zero, moe_zero=moe_zero)
    full = {"params": float(sum(map(_nbytes, params.values())))}
    out = {"params": sum(_sharded(_nbytes(p), specs[n], sizes) for n, p in params.items()),
           "opt": 0.0, "cache": 0.0}
    if shape.kind == "train":
        state = init_opt_state(run, params)
        ospecs = state_specs(optimizer_config(run), specs,
                             {n: tuple(p.shape) for n, p in params.items()}, sizes,
                             stacked_leaves(run.model, params))
        opt = float(_nbytes(state["step"]))
        for name, leaf in state["m"].items():
            for key, t in leaf.items():
                opt += _sharded(_nbytes(t), ospecs[name][key], sizes)
        for name, t in state.get("ef", {}).items():
            opt += _sharded(_nbytes(t), specs[name], sizes)
        out["opt"] = opt
    else:
        dt = getattr(torch, run.parallel.kv_cache_dtype)
        seq = shd.serve_cache_len(shape.seq_len, sizes) if math.prod(sizes.values()) > 1 \
            else shape.seq_len
        cache = model.init_cache(shape.global_batch, seq, dtype=dt)
        out["cache"] = sum(_sharded(_nbytes(t), spd, sizes)
                           for c, cs in zip(cache, shd.cache_specs(cache, sizes))
                           if c is not None for t, spd in zip(c, cs))
    batch = input_specs(run.model, shape)
    out["batch"] = sum(_sharded(_nbytes(t), shd.batch_spec(tuple(t.shape), sizes), sizes)
                       for t in batch.values())
    full["batch"] = float(sum(map(_nbytes, batch.values())))
    return {"stored": out, "full": full}


# ---------------------------------------------------------------------------
# A cell
# ---------------------------------------------------------------------------

def _affine(a: float, b: float, x0: float, x1: float, x: float) -> float:
    return a + (b - a) * (x - x0) / (x1 - x0)


def _window_index(seq: list, window: int) -> Tuple[list, Dict[int, list]]:
    """Each point's window (the ``window`` ids from it) as a hash, and the
    points of each hash in order."""
    keys = [hash(tuple(seq[x:x + window])) for x in range(len(seq))]
    where: Dict[int, list] = {}
    for x, k in enumerate(keys):
        where.setdefault(k, []).append(x)
    return keys, where


def _gap(s1: list, s2: list, k1: list, where2: dict, i: int, j: int, window: int,
         reach: int) -> Optional[Tuple[int, int, int]]:
    """(a, extra, x) for a disagreement at points i of ``s1`` and j of ``s2``:
    the fewest points a of ``s1`` after which ``s2`` agrees again, ``extra``
    points later (at its first few places, nearest first), where those extra
    points, from ``j + x``, repeat the points before them (the window found
    the gap up to ``window`` points early, so the repeat may start past the
    gap, where both timelines agree). Failing that, a gap where ``s2`` has up
    to ``window`` points fewer (an op the autograd engine runs once per
    parameter, such as the ``detach`` of a gradient, where a shared block's
    parameter gathers two): extra < 0. None where neither is found."""
    n1, n2 = len(s1), len(s2)
    fewer = None
    for a in range(min(reach, n1 - i) + 1):
        if i + a == n1:
            places = [n2]
        else:
            xs = where2.get(k1[i + a], [])
            at = bisect.bisect_left(xs, j + max(a - window, 0))
            places = xs[at:at + 4 + window]
        for place in places:
            extra = place - j - a
            if extra < 0:
                fewer = fewer or (a, extra, 0)
                continue
            if extra == 0:
                return a, 0, 0
            x = next((x for x in range(a + window + 1)
                      if extra <= j + x and j + x + extra <= n2
                      and s2[j + x:j + x + extra] == s2[j + x - extra:j + x]
                      and s1[i + a:i + x] == s2[j + a:j + x]), None)
            if x is not None:
                return a, extra, x
    return fewer


def counterparts(s1: list, s2: list, window: int = 16, reach: int = 64) -> Optional[list]:
    """Pairs (i, j): point j of the longer timeline ``s2`` is point i of
    ``s1``, or a repeat of it. ``s2`` is read as ``s1`` with blocks inserted,
    each a repeat of the block just before it (the second unit's layers, a
    longer loop's extra steps), and with points whose signature changed (a
    ``stack`` of every leaf). Points pair where the ``window`` ids from them
    agree; at a disagreement, ``_gap`` finds where they agree again; the
    gap's points pair in order, its extra points of ``s2`` with what they
    repeat. None where a gap is not of that form."""
    n1, n2 = len(s1), len(s2)
    k1, _ = _window_index(s1, window)
    k2, where2 = _window_index(s2, window)
    of2 = [-1] * n2                     # the point of s1 each point of s2 pairs with
    pairs = []
    i = j = 0
    while i < n1 or j < n2:
        if i < n1 and j < n2 and k1[i] == k2[j]:
            pairs.append((i, j))
            of2[j] = i
            i, j = i + 1, j + 1
            continue
        gap = _gap(s1, s2, k1, where2, i, j, window, reach)
        if gap is None:
            return None
        a, extra, x = gap
        if extra < 0:           # s2 has fewer points: the last of its gap stands in
            for k in range(a):
                pairs.append((i + k, max(j + min(k, a + extra - 1), 0)))
            for k in range(a + extra):
                of2[j + k] = i + k
            i, j = i + a, j + a + extra
            continue
        for k in range(x):
            pairs.append((i + k, j + k))
            of2[j + k] = i + k
        for k in range(extra):
            pairs.append((of2[j + x - extra + k], j + x + k))
            of2[j + x + k] = of2[j + x - extra + k]
        for k in range(x, a):
            pairs.append((i + k, j + extra + k))
            of2[j + extra + k] = i + k
        m = max(a, x)
        i, j = i + m, j + m + extra
    return pairs


def extrapolated_lives(v1: list, v2: list, pairs: list, scale: float) -> list:
    """Each point of the shorter timeline at the full size: its bytes alive
    plus ``scale`` times the rise to the largest of its counterparts'. A
    point's bytes are affine in the units (or the length), and those of a
    repeated block's point in its place among the repeats as well, so the
    largest of the repeats' is at the first or the last, the two
    counterparts."""
    best = list(v1)
    seen = [False] * len(v1)
    for i, j in pairs:
        best[i] = v2[j] if not seen[i] else max(best[i], v2[j])
        seen[i] = True
    return [a + scale * (b - a) for a, b in zip(v1, best)]


def cell_costs(run: RunConfig, shape: ShapeSpec, mesh_sizes: Dict[str, int]) -> Dict:
    """The cell's per-device costs extrapolated from traces at ``UNITS`` (the
    whole model where it has no more units; and, for a recurrent-only
    model's prefill and train, at its two ``LENGTHS``): ``cost``
    (``roofline.CostTerms``: FLOPs, bytes, the train
    step's collectives), ``temp_bytes`` (the peak over the arguments, both as
    the full one-device step would trace them), the traces' seconds and the
    extrapolation used, with the affine peak's temporaries beside it.

    FLOPs, bytes and the arguments are affine in the units and the length.
    The peak is the largest of the bytes alive at each point of the step,
    each affine: the traces' timelines are aligned (``counterparts``) and
    every point extrapolated (``extrapolated_lives``), in the units on the
    ops' signatures, then in the length on the ops alone. Where a timeline
    does not align, the peak itself is extrapolated, which is exact only
    where the same point peaks at every size; ``extrapolation.peak`` says
    which."""
    units = full_units(run)
    traced = UNITS if units > UNITS[-1] else (units,)
    extra = units - traced[0]
    lengths = LENGTHS.get(shape.kind) if recurrent_only(run) else None
    ids: dict = {}
    totals, args, peaks, lives, names, seconds = [], [], [], [], [], 0.0
    aligned = True
    for seq in lengths or (None,):
        traces = []
        for k in traced:
            tr = trace_cell(run, shape, mesh_sizes, units=k, seq_len=seq, ids=ids)
            seconds += tr.seconds
            gathered = tr.gathered_bytes
            traces.append((tr, rl.CostTerms(tr.flops, tr.bytes, tr.coll)))
        (t1, c1), (t2, c2) = traces[0], traces[-1]
        totals.append(c1.extrapolate(c2.diff(c1), extra))
        args.append(t1.arg_bytes + (t2.arg_bytes - t1.arg_bytes) * extra)
        pairs = counterparts(t1.sigs, t2.sigs)
        aligned = aligned and pairs is not None
        lives.append(extrapolated_lives(t1.lives, t2.lives, pairs, extra) if pairs else [])
        peaks.append(t1.peak_bytes + (t2.peak_bytes - t1.peak_bytes) * extra)
        names.append(t1.names)
    total, arg, affine = totals[0], args[0], peaks[0]
    if lengths:
        (l0, l1), s = lengths, shape.seq_len
        # FLOPs, bytes and the collectives (a cell on a part of a head sums
        # and gathers activations: every chunk, every sLSTM step) affine in S
        total = totals[0].extrapolate(totals[1].diff(totals[0]), (s - l0) / (l1 - l0))
        arg = _affine(args[0], args[1], l0, l1, s)
        affine = _affine(peaks[0], peaks[1], l0, l1, s)
        pairs = counterparts(names[0], names[1]) if aligned else None
        aligned = pairs is not None
        peak = (max(extrapolated_lives(lives[0], lives[1], pairs, (s - l0) / (l1 - l0)))
                if aligned else affine)
    else:
        peak = max(lives[0]) if aligned else affine
    # the affine peak beside the one used: how much the alignment moved it
    extrapolation = {"units": list(traced), "full_units": units,
                     "seq_len": list(lengths) if lengths else None,
                     "full_seq_len": shape.seq_len,
                     "peak": "timeline" if aligned else "peak",
                     "affine_temp_bytes": affine - arg}
    return {"cost": total, "temp_bytes": peak - arg, "gathered_bytes": gathered,
            "trace_s": seconds, "extrapolation": extrapolation}


def memory_record(run: RunConfig, shape: ShapeSpec, mesh_sizes: Dict[str, int],
                  temp_bytes: float, traced_gathered: float = 0.0) -> Dict:
    """``memory`` of a record: the stored arguments, what the port holds
    beyond them, the step's temporaries, the peak and whether it fits.
    ``temp_bytes`` is the traced peak over the traced arguments, of which
    ``traced_gathered`` (the step's all-gather outputs at their most,
    ``Trace.gathered_bytes``) is reported under ``gathered_bytes``."""
    st = state_bytes(run, shape, mesh_sizes)
    stored, full = st["stored"], st["full"]
    world = math.prod(mesh_sizes.values())
    gathered = 0.0
    if world > 1:
        gathered = full["batch"] - stored["batch"] + traced_gathered
        temp_bytes -= traced_gathered
    argument = sum(stored.values())
    peak = argument + gathered + temp_bytes
    return {"argument_bytes": argument, "param_bytes": stored["params"],
            "opt_bytes": stored["opt"], "cache_bytes": stored["cache"],
            "batch_bytes": stored["batch"], "gathered_bytes": gathered,
            "temp_bytes": temp_bytes, "peak_bytes": peak,
            "hbm_limit_bytes": meshmod.HBM_BYTES, "fits": bool(peak < meshmod.HBM_BYTES)}


def roofline_record(run: RunConfig, shape: ShapeSpec, mesh_name: str, chips: int, arch: str,
                    cost: rl.CostTerms, extrapolation: Dict, microbatches: int = 1) -> Dict:
    """The roofline section of a record from its extrapolated costs, traced
    at ``microbatches``; the section keeps those costs (``stored_cost``
    reads them back)."""
    n_active = count_params_analytic(run.model, active_only=True)
    mf = rl.step_model_flops(run.model, n_active, shape)
    roof = rl.roofline_terms(arch, shape.name, mesh_name, chips, cost, mf, 0.0)
    # the memory term of perfect fusion (the JAX package's structural
    # estimate); the traced bytes are an unfused upper bound
    t_mem = rl.structural_hbm_bytes(run, shape, chips) / meshmod.HBM_BW
    terms = {"compute": roof.t_comp, "memory": t_mem, "collective": roof.t_coll}
    dominant = max(terms, key=terms.get)
    ideal = mf / (chips * meshmod.PEAK_FLOPS_BF16)
    return {
        "t_comp_s": roof.t_comp, "t_mem_traced_s": roof.t_mem,
        "t_mem_s": t_mem, "t_coll_s": roof.t_coll,
        "dominant_traced": roof.dominant, "dominant": dominant,
        "model_flops": mf,
        "flops_global": roof.hlo_flops,
        "useful_flops_ratio": roof.useful_flops_ratio,
        "roofline_fraction_traced": roof.roofline_fraction,
        "roofline_fraction": ideal / max(max(terms.values()), 1e-30),
        "collective_counts": cost.coll.counts,
        "collective_wire_bytes_per_device": cost.coll.wire_bytes,
        "flops_per_device": cost.flops,
        "bytes_per_device": cost.hbm_bytes,
        "microbatches": microbatches,
        "units_extrapolated": extrapolation["full_units"],
    }


def config_cost(rec: Dict) -> rl.CostTerms:
    """A record's costs at the config's microbatches (``cost_analysis`` and
    ``collectives``)."""
    coll = rl.CollectiveStats(dict(rec["collectives"]["counts"]), {},
                              rec["collectives"]["wire_bytes_per_device"])
    return rl.CostTerms(rec["cost_analysis"]["flops_per_device"],
                        rec["cost_analysis"]["bytes_per_device"], coll)


def stored_cost(rec: Dict) -> Tuple[rl.CostTerms, Optional[int]]:
    """(the costs, their microbatches) a record's roofline was computed
    from: its own where the section keeps them, else (a record written
    before it did) ``config_cost`` and None."""
    roof = rec.get("roofline", {})
    if "flops_per_device" not in roof:
        return config_cost(rec), None
    coll = rl.CollectiveStats(dict(roof["collective_counts"]), {},
                              roof["collective_wire_bytes_per_device"])
    return rl.CostTerms(roof["flops_per_device"], roof["bytes_per_device"], coll), \
        roof["microbatches"]


def run_cell(arch: str, shape_name: str, multi_pod: bool, do_roofline: bool,
             out_dir: str, mesh: Optional[Tuple[str, Dict[str, int]]] = None,
             run: Optional[RunConfig] = None, shape: Optional[ShapeSpec] = None) -> Dict:
    """One cell's record, written to ``out_dir``. ``mesh`` ((name, sizes)),
    ``run`` and ``shape`` override the production mesh, the config and the
    shape of the grid (``chip_smoke.py`` runs the card's own cells)."""
    run = get_config(arch) if run is None else run
    shape = SHAPES[shape_name] if shape is None else shape
    mesh_name, sizes = MESHES[multi_pod] if mesh is None else mesh
    chips = math.prod(sizes.values())
    rec: Dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": chips, "status": "unknown"}
    if not shape_applicable(run.model, shape):
        rec["status"] = "skipped_by_design"
        rec["reason"] = "long_500k requires sub-quadratic attention / compressed cache"
        return _write(rec, out_dir)
    try:
        costs = cell_costs(run, shape, sizes)
        cost = costs["cost"]
        attn_zero, moe_zero = shd.zero_rules(run, sizes)
        rec.update({
            "status": "ok",
            "trace_s": round(costs["trace_s"], 1),
            "extrapolation": costs["extrapolation"],
            "parallel": {"local_batch": batch_rows(shape.global_batch, sizes,
                                                   run.parallel.microbatches
                                                   if shape.kind == "train" else 1),
                         "attn_zero": attn_zero, "moe_zero": moe_zero,
                         "attn_activation_sharding": run.parallel.attn_activation_sharding,
                         "attn_activation_mode": attn_activation_mode(run),
                         "traced_rank": "{}: {}".format(*traced_rank(run, shape, sizes)),
                         "optimizer_state": run.parallel.optimizer_state},
            "memory": memory_record(run, shape, sizes, costs["temp_bytes"],
                                    costs["gathered_bytes"]),
            "cost_analysis": {"flops_per_device": cost.flops,
                              "bytes_per_device": cost.hbm_bytes},
            "collectives": {"counts": cost.coll.counts,
                            "wire_bytes_per_device": cost.coll.wire_bytes},
        })
        if do_roofline:
            # the JAX package's rule (``roofline_cell``): a train step's
            # roofline at one microbatch, its memory at the config's
            k = max(run.parallel.microbatches, 1) if shape.kind == "train" else 1
            if k > 1:
                one = run.replace(parallel=dataclasses.replace(run.parallel, microbatches=1))
                costs = cell_costs(one, shape, sizes)
                rec["trace_s"] = round(rec["trace_s"] + costs["trace_s"], 1)
            rec["roofline"] = roofline_record(run, shape, mesh_name, chips, arch, costs["cost"],
                                              costs["extrapolation"], 1)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return _write(rec, out_dir)


def _write(rec: Dict, out_dir: str) -> Dict:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{rec['mesh']}__{rec['arch']}__{rec['shape']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    status = rec["status"]
    extra = ""
    if status == "ok":
        mem = rec["memory"]
        extra = (f" mem/dev={mem['peak_bytes'] / 2**30:.2f}GiB (args "
                 f"{mem['argument_bytes'] / 2**30:.2f}, gathered "
                 f"{mem['gathered_bytes'] / 2**30:.2f}) fits={mem['fits']}")
        if "roofline" in rec:
            r = rec["roofline"]
            extra += (f" comp={r['t_comp_s']:.3g}s mem={r['t_mem_s']:.3g}s "
                      f"coll={r['t_coll_s']:.3g}s dom={r['dominant']} "
                      f"frac={r['roofline_fraction']:.3f}")
    print(f"[{status}] {rec['mesh']} {rec['arch']} {rec['shape']}{extra}", flush=True)
    return rec


def refresh_roofline(arch: str, shape_name: str, out_dir: str) -> Dict:
    """Recompute only the roofline section of an existing single-pod record
    from the costs it was computed from (``stored_cost``; after a change of
    peaks); a cell without a record, or a train cell whose record holds only
    the costs at the config's microbatches (more than one), is traced."""
    run = get_config(arch)
    shape = SHAPES[shape_name]
    if not shape_applicable(run.model, shape):
        return {"status": "skipped_by_design", "arch": arch, "shape": shape_name}
    mesh_name, sizes = MESHES[False]
    path = os.path.join(out_dir, f"{mesh_name}__{arch}__{shape_name}.json")
    if not os.path.exists(path):
        return run_cell(arch, shape_name, False, True, out_dir)
    with open(path) as f:
        rec = json.load(f)
    try:
        cost, k = stored_cost(rec)
        if k is None:
            k = max(run.parallel.microbatches, 1) if shape.kind == "train" else 1
            if k > 1:
                return run_cell(arch, shape_name, False, True, out_dir)
        rec["roofline"] = roofline_record(run, shape, mesh_name, rec["chips"], arch, cost,
                                          rec["extrapolation"], k)
    except Exception as e:
        rec["roofline_error"] = f"{type(e).__name__}: {e}"
    return _write(rec, out_dir)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--roofline-only", action="store_true",
                    help="recompute only roofline terms into existing records")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    if args.roofline_only:
        for arch in archs:
            for shape in shapes:
                refresh_roofline(arch, shape, args.out)
        return
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.roofline, args.out)
                if rec["status"] == "error":
                    failures += 1
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
