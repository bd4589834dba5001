"""The recurrent cells on a rank's heads, or on a part of one head, on gloo
ranks, against the JAX package's GSPMD steps.

A cell whose heads the ``model`` size divides computes on this rank's heads
(``models/ssm.py``): its projections' columns moved to the heads by
all-to-alls over ``model`` (``parallel.tensor.ColumnExchange``), its norm
over every head in the RMSNorm kernel's split mode, its output summed over
``model``. An xLSTM cell whose H heads ``model`` = g·H does not divide
computes one head's 1/g a rank (``tensor.HeadPart``): its scores, q and k
and sLSTM's hidden state summed or gathered over the head's g ranks. One
spawn of four gloo ranks (``_dist.run_world``) on (data 2, model 2) and
(data 1, model 4) runs zamba2-7b's smoke config (8 Mamba2 heads, the shared
attention block) and xlstm-125m's (4 heads: mLSTM and sLSTM), and on (1, 4)
xlstm-125m's with 2 heads (g = 2: ``PART_CASE``), in fp32, while a JAX child
(``_dist.JaxChild``, 4 forced host devices) jits the JAX package's train
step, prefill and decode on the same meshes with ``param_specs``,
``batch_specs`` and ``cache_specs`` as ``in_shardings``
(``shard_activations`` / ``_maybe_shard`` patched to the identity: they pin
layouts only), and each of the reference's cell functions
(``mamba2_forward``, ``mlstm_forward``, ``slstm_forward``) at d_model 256 on
one device and on (1, 4), for XLA's per-device FLOPs (the xLSTM cells at 4,
2 and 1 heads: g = 1, 2 and 4).

Held:
  (a) two train steps (microbatches 2) against the JAX GSPMD step and the
      port's one-device step: loss and grad norm 1e-5, every parameter 1e-5
      (as tests/test_torch_mesh_seq_train.py counts the rare AdamW sign
      flips);
  (b) a prefill of 36 tokens and 6 greedy decode steps against the JAX
      GSPMD prefill and decode: logits 1e-4, tokens equal; each rank's state
      shards within 1e-5 of the gathered path's (every cell forced whole);
  (c) a rank's traced FLOPs of each cell at (1, 4), forward and gradient,
      over one device's: at most XLA's share of the reference's cell + 0.05,
      the xLSTM cells on heads (4 heads) and on head parts (2 and 1 heads);
  (d) a split step's all-gathers over ``model`` are of no projection: only
      the gradients of the small weights the rules leave whole (norm
      scales, mLSTM's ``wif``/``if_bias``, sLSTM's ``r`` and ``b``); its
      all-to-alls are counted; a head-part step's gathers over a head's
      ranks are of one head's activations (q and k, the hidden state);
  (e) heads that ``model`` does not divide: at 2 heads on model 4 every
      cell computes on a head part, its step and serve (state shards
      included) within 1e-5 of the gathered path (every cell forced whole);
      at 3 heads (d_model 48), where model is no multiple of them either,
      every cell computes whole: the step and the serve ``torch.equal`` to
      the gathered path;
  and a step under remat "full" at (1, 4) against the one-device step.
"""
import contextlib
import dataclasses
import os

import numpy as np
import pytest
import torch

import test_torch_mesh_serve as ms
import test_torch_mesh_train as mt
from _dist import JaxChild, run_world

HERE = os.path.abspath(__file__)
ARCHS = ("zamba2-7b", "xlstm-125m")
MESHES = {"data2_model2": (2, 2), "data1_model4": (1, 4)}
BATCH, PROMPT, STEPS, MAX_LEN = ms.BATCH, ms.PROMPT, ms.STEPS, ms.MAX_LEN
# (c): the widths of the cells whose FLOP share is measured, batch 2
CELL_WIDTHS = dict(d_model=256, batch=2, mamba_seq=512, xlstm_seq=256, state=16, head_dim=16,
                   chunk=64, heads=4)
CELLS = ("mamba2", "mlstm", "slstm")
# (c) on head parts: the xLSTM cells at 2 and 1 heads on model 4 (g = 2, 4)
PART_CELLS = [(cell, heads) for heads in (2, 1) for cell in ("mlstm", "slstm")]
SHARE_SLACK = 0.05
# a config by name: (arch, ModelConfig overrides). PART_CASE: 2 heads, which
# model 4 does not divide but splits in halves (g = 2); WHOLE_CASE: 3 heads
# at d_model 48, which model 4 neither divides nor is a multiple of
CONFIGS = {"zamba2-7b": ("zamba2-7b", {}), "xlstm-125m": ("xlstm-125m", {}),
           "xlstm-125m-2heads": ("xlstm-125m", {"n_heads": 2})}
PART_CASE = "xlstm-125m-2heads"
WHOLE_CASE = ("xlstm-125m", {"n_heads": 3, "d_model": 48})
CASES = [(key, arch) for key in MESHES for arch in ARCHS] + [("data1_model4", PART_CASE)]
NAMES = (*ARCHS, PART_CASE)

JAX_SIDE = r"""
import dataclasses
import numpy as np
import jax.numpy as jnp
import repro.models.moe as jax_moe
import repro.models.transformer as jt
jt.shard_activations = lambda x: x
jax_moe._maybe_shard = lambda x, spec: x
from repro.common.config import SSMConfig, ShapeSpec
from repro.configs import get_smoke_config
from repro.models import ssm as jssm
from repro.models.model import build_model, synthetic_batch
from repro.optim import adamw
from repro.parallel import sharding as shd
from repro.train.steps import make_decode_step, make_prefill_step, make_train_step
from repro_torch.convert import params_from_jax

def smoke(name):
    # the smoke config of name (CONFIGS: its arch and overrides)
    arch, over = CONFIGS[name]
    run = get_smoke_config(arch)
    return run.replace(model=dataclasses.replace(run.model, **over))


if "params" in JOB:
    # the JAX package's LM.init of each smoke config (key 0), in the port's
    # names, for the ranks (they wait for the files)
    for name in CONFIGS:
        cfg = smoke(name).model
        params = jt.LM(cfg, param_dtype=jnp.float32, remat="none",
                       use_kernel=False).init(jax.random.key(0))
        state = params_from_jax(jax.tree.map(np.asarray, params), cfg)
        np.savez(PARAMS[name] + ".part.npz", **{k: v.numpy() for k, v in state.items()})
        os.replace(PARAMS[name] + ".part.npz", PARAMS[name])

out = {}
for key, shape in MESHES.items():
    mesh = jc.make_mesh(shape, ("data", "model"), axis_types=(jc.AxisType.Auto,) * 2)
    for arch in CONFIGS:
        if (key, arch) not in JOB:
            continue
        # (a) two train steps
        run = smoke(arch)
        run = run.replace(parallel=dataclasses.replace(
            run.parallel, param_dtype="float32", microbatches=2),
            train=dataclasses.replace(run.train, **TRAIN))
        model = build_model(run, use_kernel=False)
        np_tree = lambda t: params_from_jax(jax.tree.map(np.asarray, t), run.model)
        with jc.set_mesh(mesh):
            params = p0 = model.init(jax.random.key(0))
            shardings = shd.param_shardings(params, mesh)
            params = jax.tree.map(jax.device_put, params, shardings)
            cfg = adamw.OptimizerConfig()
            state = adamw.init_state(cfg, params)
            step = None
            for i in range(2):
                batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
                    run.model, ShapeSpec("t", SEQ, ROWS, "train"), seed=10 + i).items()}
                bsh = shd.to_shardings(shd.batch_specs(batch, mesh), mesh)
                batch = jax.tree.map(jax.device_put, batch, bsh)
                if step is None:
                    step = jax.jit(make_train_step(model, run, cfg, mesh),
                                   in_shardings=(shardings, None, bsh),
                                   out_shardings=(shardings, None, None))
                params, state, met = step(params, state, batch)
                for m, v in met.items():
                    out[f"train/{key}/{arch}/{m}/{i}"] = np.asarray(v)
            out.update({f"train/{key}/{arch}/p2/{k}": v.numpy()
                        for k, v in np_tree(params).items()})
        # (b) prefill and greedy decode, from the same LM.init
        cfg = smoke(arch).model
        model = jt.LM(cfg, param_dtype=jnp.float32, remat="none", use_kernel=False)
        with jc.set_mesh(mesh):
            params = p0
            pshard = shd.to_shardings(shd.param_specs(params, mesh), mesh)
            params = jax.tree.map(jax.device_put, params, pshard)
            batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
                cfg, ShapeSpec("p", PROMPT, BATCH, "prefill"), seed=1).items()}
            bshard = shd.to_shardings(shd.batch_specs(batch, mesh), mesh)
            batch = jax.tree.map(jax.device_put, batch, bshard)
            cache = model.init_cache(BATCH, MAX_LEN, dtype=jnp.float32)
            cshard = shd.to_shardings(shd.cache_specs(cache, mesh), mesh)
            cache = jax.tree.map(jax.device_put, cache, cshard)
            logits, cache = jax.jit(make_prefill_step(model),
                                    in_shardings=(pshard, bshard, cshard))(params, batch, cache)
            out[f"serve/{key}/{arch}/0"] = np.asarray(logits)
            decode = None
            for i in range(STEPS):
                tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
                step = {"tokens": tok[:, None]}
                sshard = shd.to_shardings(shd.batch_specs(step, mesh), mesh)
                if decode is None:
                    decode = jax.jit(make_decode_step(model),
                                     in_shardings=(pshard, sshard, cshard, None))
                step = jax.tree.map(jax.device_put, step, sshard)
                # the cache back on its cache_specs: where they leave a state
                # whole (xlstm's m at 2 heads on model 4) the step's output
                # may come out split
                cache = jax.tree.map(jax.device_put, cache, cshard)
                logits, cache = decode(params, step, cache, jnp.asarray(PROMPT + i, jnp.int32))
                out[f"serve/{key}/{arch}/{i + 1}"] = np.asarray(logits)

# (c) XLA's per-device FLOPs of each reference cell on (1, 4) over one device's
w = WIDTHS
base = get_smoke_config("zamba2-7b").model
mcfg = dataclasses.replace(base, d_model=w["d_model"], ssm=SSMConfig(
    state_dim=w["state"], head_dim=w["head_dim"], expand=2, conv_width=4, chunk_size=w["chunk"]))

def xlstm_cfg(heads):
    return dataclasses.replace(get_smoke_config("xlstm-125m").model, d_model=w["d_model"],
                               n_heads=heads)


# the xLSTM cells at 4 heads under their own names, at 2 and 1 as "cell/heads"
cells = {"mamba2": (jssm.init_mamba2, lambda p, x: jssm.mamba2_forward(p, mcfg, x)[0], mcfg,
                    w["mamba_seq"])}
for heads in (w["heads"], *sorted({h for _, h in PART_CELLS})):
    cfg = xlstm_cfg(heads)
    tag = "" if heads == w["heads"] else f"/{heads}"
    cells[f"mlstm{tag}"] = (jssm.init_mlstm,
                            lambda p, x, cfg=cfg: jssm.mlstm_forward(p, cfg, x)[0], cfg,
                            w["xlstm_seq"])
    cells[f"slstm{tag}"] = (jssm.init_slstm,
                            lambda p, x, cfg=cfg: jssm.slstm_forward(p, cfg, x)[0], cfg,
                            w["xlstm_seq"])
cells = cells if "cells" in JOB else {}
one = jc.make_mesh((1, 1), ("data", "model"), axis_types=(jc.AxisType.Auto,) * 2,
                   devices=jax.devices()[:1])
four = jc.make_mesh((1, 4), ("data", "model"), axis_types=(jc.AxisType.Auto,) * 2)
for name, (init, fwd, cfg, seq) in cells.items():
    p = {"cell": init(jax.random.key(1), cfg)}
    x = jax.random.normal(jax.random.key(2), (w["batch"], seq, w["d_model"]), jnp.float32)
    fns = {"forward": lambda p, x, fwd=fwd: fwd(p["cell"], x),
           "gradient": jax.grad(lambda p, x, fwd=fwd: jnp.sum(fwd(p["cell"], x) ** 2),
                                argnums=(0, 1))}
    for kind, fn in fns.items():
        flops = []
        for mesh in (one, four):
            with jc.set_mesh(mesh):
                psh = shd.to_shardings(shd.param_specs(p, mesh), mesh)
                xsh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
                compiled = jax.jit(fn, in_shardings=(psh, xsh)).lower(p, x).compile()
                cost = compiled.cost_analysis()
                cost = cost[0] if isinstance(cost, (list, tuple)) else cost
                flops.append(float(cost["flops"]))
        out[f"share/{name}/{kind}"] = np.asarray(flops[1] / flops[0])
np.savez(os.path.join(OUT, "jax.npz"), **out)
"""


def fp32_run(arch, overrides=None):
    run = ms.fp32_run(arch)
    return run.replace(model=dataclasses.replace(run.model, **(overrides or {})))


def step_run(name):
    """``mt.step_run`` of the config ``name`` (CONFIGS)."""
    arch, over = CONFIGS[name]
    run = mt.step_run(arch)
    return run.replace(model=dataclasses.replace(run.model, **over))


def _force_whole(model):
    """Every recurrent cell of ``model`` on the gathered path: its weights
    whole on every rank, the whole cell run (what a cell whose heads
    ``model`` does not divide does)."""
    for m in model.modules():
        if hasattr(m, "heads_split"):
            m.heads_split = lambda: False
    return model


@contextlib.contextmanager
def _built_whole(on: bool):
    """``build_model`` making models whose cells take the gathered path."""
    import repro_torch.models.model as mm
    build = mm.build_model
    if on:
        mm.build_model = lambda *a, **k: _force_whole(build(*a, **k))
    try:
        yield
    finally:
        mm.build_model = build


def _split_cells(model):
    return [m.heads_split() for m in model.modules() if hasattr(m, "heads_split")]


def _part_cells(model):
    """Each recurrent cell's g where it computes on a part of one head, else 0."""
    return [getattr(m.head_part(), "g", 0) for m in model.modules() if hasattr(m, "head_part")]


# --- rank side -----------------------------------------------------------------------------

def _serve(run, p0, mesh, row, n_rows, whole=False):
    """The sharded prefill and greedy decode of ``run`` on ``mesh`` from
    ``p0``: each step's logits and the cache shards after them."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.models.model import build_model, synthetic_batch
    from repro_torch.parallel import tensor
    from repro_torch.train.steps import local_batch
    model = build_model(run, device="cpu")
    model.load_state_dict(p0)
    tensor.shard_model(model, mesh)
    if whole:
        _force_whole(model)
    batch = local_batch(synthetic_batch(run.model, ShapeSpec("p", PROMPT, BATCH, "prefill"),
                                        seed=1, device="cpu"), 1, row, n_rows)
    cache = model.init_cache(BATCH // n_rows, MAX_LEN, dtype=torch.float32)
    parts = _part_cells(model)
    logits = ms._greedy(model, batch, cache)
    return (logits, [t.clone() for c in cache if c is not None for t in c], _split_cells(model),
            parts)


def _gathers_and_all_to_alls(run, mesh, p0):
    """One sharded train step's all-gathers over model and over a head's
    ranks (output shape) and its all-to-all count, beside the cells'
    projection shapes."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.steps import jax_leaves, make_train_step, shard_train_state
    model_group = mesh.get_group("model").group_name

    class Mode(TorchDispatchMode):
        def __init__(self, head_groups):
            super().__init__()
            self.head_groups = head_groups
            self.gathers, self.head_gathers, self.a2a = [], [], 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out_ = func(*args, **(kwargs or {}))
            name = func._schema.name
            if name == "_c10d_functional::all_gather_into_tensor":
                if args[2] == model_group:
                    self.gathers.append(list(out_.shape))
                elif args[2] in self.head_groups:
                    # the gathered dim moved to the front: put it back last
                    self.head_gathers.append(list(out_.shape[1:]) + [out_.shape[0]])
            elif name == "_c10d_functional::all_to_all_single" and args[3] == model_group:
                self.a2a += 1
            return out_

    cfg = adamw.OptimizerConfig()
    model = build_model(run, device="cpu")
    model.load_state_dict(p0)
    params = dict(model.named_parameters())
    masters, state = shard_train_state(params, adamw.init_state(cfg, params, jax_leaves(model)),
                                       cfg, mesh, shd.param_placements(params, mesh))
    step = make_train_step(model, run, cfg, mesh)
    parts = [m.head_part() for m in model.modules() if hasattr(m, "head_part")]
    mode = Mode({p.group.name for p in parts if p is not None})
    with mode:
        step(masters, state, mt._batch(run, 10))
    cells = {n: list(p.tp_full_shape) for n, p in model.named_parameters() if ".cell." in n}
    whole = [n for n, p in model.named_parameters() if ".cell." in n
             and not any("model" in shd._axes_of(e) for e in p.tp_spec)]
    return {"gathers": mode.gathers, "head_gathers": mode.head_gathers, "a2a": mode.a2a,
            "cells": cells, "whole": whole, "split": _split_cells(model),
            "parts": _part_cells(model)}


def ranks(rank, world, out, inputs):
    import json
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.steps import batch_coordinate
    saved, facts = {}, {}
    for key, (data, model_size) in MESHES.items():
        mesh = make_local_mesh(data, model_size, device="cpu")
        row, n_rows = batch_coordinate(mesh)
        for name in [n for k, n in CASES if k == key]:
            arch, over = CONFIGS[name]
            p0 = _wait_for(inputs[name])
            res = mt._sharded_steps(step_run(name), mesh, p0, 2, with_plain=True)
            saved.update({f"train/{key}/{name}/{k}": v for k, v in res.items()})
            logits, cache, split, parts = _serve(fp32_run(arch, over), p0, mesh, row, n_rows)
            whole_logits, gathered, _, _ = _serve(fp32_run(arch, over), p0, mesh, row, n_rows,
                                                  whole=True)
            saved.update({f"serve/{key}/{name}/{i}": x.numpy() for i, x in enumerate(logits)})
            facts[f"{key}/{name}"] = {
                "rows": [row, n_rows], "split": split, "parts": parts,
                "state_err": max(float(((a - b).abs() - 1e-5 * b.abs()).max())
                                 for a, b in zip(cache, gathered)),
                "logit_err": max(float((a - b).abs().max())
                                 for a, b in zip(logits, whole_logits))}
            if key == "data1_model4":
                facts[f"collectives/{name}"] = _gathers_and_all_to_alls(
                    step_run(name), mesh, mt._port_init(step_run(name)))
            if name == PART_CASE:
                # (e) on head parts: the same two steps on the gathered path
                with _built_whole(True):
                    res = mt._sharded_steps(step_run(name), mesh, p0, 2)
                saved.update({f"gathered/{name}/{k}": v for k, v in res.items()})
        if key == "data1_model4":
            # (e) heads that model neither divides nor is a multiple of: the
            # gathered path, equal
            arch, over = WHOLE_CASE
            run = mt.step_run(arch)
            run = run.replace(model=dataclasses.replace(run.model, **over))
            p0, srun = mt._port_init(run), fp32_run(arch, over)
            got = {}
            for whole in (False, True):
                with _built_whole(whole):
                    res = mt._sharded_steps(run, mesh, p0, 1)
                got[whole] = (res, *_serve(srun, mt._port_init(srun), mesh, row, n_rows,
                                           whole=whole)[:3])
            (r0, l0, c0, s0), (r1, l1, c1, _) = got[False], got[True]
            # remat "full": each cell's exchanges and all-reduces (and a head
            # part's gathers and sums) run again in the recompute
            for name in NAMES:
                run = step_run(name)
                run = run.replace(parallel=dataclasses.replace(run.parallel, remat="full"))
                res = mt._sharded_steps(run, mesh, mt._port_init(run), 1, with_plain=True)
                saved.update({f"remat/{name}/{k}": v for k, v in res.items()})
            facts["whole_case"] = {
                "split": s0,
                "step_equal": sorted(r0) == sorted(r1) and all(
                    np.array_equal(r0[k], r1[k]) for k in r0),
                "serve_equal": all(torch.equal(a, b) for a, b in zip(l0 + c0, l1 + c1))}
    np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(facts, f)


# --- (c): a rank's traced FLOPs of a cell -------------------------------------------------------

def _cell_flops(name, mesh_sizes, heads=CELL_WIDTHS["heads"]):
    """The dry run's trace (``StepCounter``, meta device) of one cell's
    forward, and of its forward and backward, at ``CELL_WIDTHS`` (an xLSTM
    cell at ``heads`` heads): rank 0's share under a fake group of
    ``mesh_sizes``, or one device's."""
    from torch import nn
    from repro_torch.common.config import SSMConfig
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import transformer as tr
    from repro_torch.parallel import tensor
    w = CELL_WIDTHS
    if name == "mamba2":
        cfg = dataclasses.replace(get_smoke_config("zamba2-7b").model, d_model=w["d_model"],
                                  ssm=SSMConfig(state_dim=w["state"], head_dim=w["head_dim"],
                                                expand=2, conv_width=4, chunk_size=w["chunk"]))
        block, seq = tr.MambaBlock, w["mamba_seq"]
    else:
        cfg = dataclasses.replace(get_smoke_config("xlstm-125m").model, d_model=w["d_model"],
                                  n_heads=heads)
        block, seq = (tr.MLSTMBlock if name == "mlstm" else tr.SLSTMBlock), w["xlstm_seq"]

    class Holder(nn.Module):             # the rules' names: blocks.0.cell.*
        def __init__(self):
            super().__init__()
            self.blocks = nn.ModuleList([block(cfg, torch.float32, "meta")])

    holder = Holder()
    meshed = mesh_sizes is not None
    out = {}
    with (dr.fake_world(mesh_sizes) if meshed else contextlib.nullcontext()) as mesh:
        if meshed:
            tensor.shard_model(holder, mesh)
        cell = holder.blocks[0].cell
        assert cell.heads_split() == meshed
        out["g"] = getattr(cell.head_part(), "g", 1) if meshed and name != "mamba2" else 1
        x = torch.empty(w["batch"], seq, w["d_model"], device="meta", requires_grad=True)
        for kind in ("forward", "gradient"):
            counter = dr.StepCounter()
            with counter:
                y, _ = cell(x, None, False)
                if kind == "gradient":
                    torch.autograd.grad((y * y).sum(), [x, *cell.parameters()])
            out[kind] = float(counter.flops)
    return out


# --- fixtures ----------------------------------------------------------------------------------

def _wait_for(path, timeout=120.0):
    """The JAX child's parameters at ``path``, once it has written them."""
    import time
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no parameters at {path} after {timeout:.0f} s")
        time.sleep(0.1)
    return {k: torch.from_numpy(v) for k, v in np.load(path).items()}


@pytest.fixture(scope="module")
def ssm_mesh(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ssm")
    inputs = {name: os.path.join(str(tmp), f"{name}.npz") for name in NAMES}
    code = JAX_SIDE
    for name, value in (("MESHES", MESHES), ("CONFIGS", CONFIGS), ("TRAIN", mt.TRAIN),
                        ("SEQ", mt.SEQ), ("ROWS", mt.BATCH), ("BATCH", BATCH),
                        ("PROMPT", PROMPT), ("STEPS", STEPS), ("MAX_LEN", MAX_LEN),
                        ("WIDTHS", CELL_WIDTHS), ("PART_CELLS", PART_CELLS),
                        ("PARAMS", inputs)):
        code = code.replace(name, repr(value))
    # two children in parallel beside the ranks (three of _dist's slots; a
    # GSPMD train step compiles for 10-30 s): the parameters, xlstm's steps
    # and the cells; zamba2's steps and the 2-head xlstm's. LLVM's
    # optimisation level 0: the same losses, a third less compile time
    jobs = [["params", "cells", *(c for c in CASES if c[1] == "xlstm-125m")],
            [c for c in CASES if c[1] in ("zamba2-7b", PART_CASE)]]
    children = [JaxChild(code.replace("JOB", repr(job)), tmp_path_factory.mktemp("jax"),
                         xla_flags="--xla_backend_optimization_level=0")
                for job in jobs]
    import json
    out = run_world(f"{HERE}:ranks", 4, tmp, inputs=inputs)
    ranks_out = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            facts = json.load(f)
        ranks_out.append((dict(np.load(os.path.join(out, f"rank{r}.npz"))), facts))
    jx = {}
    for child in children:
        jx.update(np.load(os.path.join(child.result(), "jax.npz")))
    return dict(ranks=ranks_out, jax=jx)


# --- (a) the train step -----------------------------------------------------------------------

@pytest.mark.parametrize("key, arch", CASES)
def test_head_split_step_matches_the_jax_gspmd_step(key, arch, ssm_mesh):
    """Two sharded steps, every cell on its rank's heads (on ``PART_CASE``
    every xLSTM cell on its rank's half of a head), against the JAX GSPMD
    step and the port's one-device step: loss and grad norm 1e-5; every
    parameter within two learning-rate steps, 1e-5 but for at most 1
    element in 2,000."""
    ref = ssm_mesh["jax"]
    ours, facts = ssm_mesh["ranks"][0]
    assert all(facts[f"{key}/{arch}"]["split"])
    assert facts[f"{key}/{arch}"]["parts"] == [2 if arch == PART_CASE else 0] * len(
        facts[f"{key}/{arch}"]["parts"])
    pre = f"train/{key}/{arch}"
    names = [k[len(f"{pre}/p2/"):] for k in ref if k.startswith(f"{pre}/p2/")]
    assert any(".cell." in n for n in names)
    for side, want_of in (("jax", lambda m: ref[f"{pre}/{m}"]),
                          ("one device", lambda m: ours[f"{pre}/plain/{m}"])):
        for i in range(2):
            for m in ("loss", "grad_norm"):
                np.testing.assert_allclose(ours[f"{pre}/{m}/{i}"], want_of(f"{m}/{i}"),
                                           rtol=1e-5, err_msg=f"{side} step {i} {m}")
        off, total = 0, 0
        for n in names:
            got, want = ours[f"{pre}/p2/{n}"], want_of(f"p2/{n}")
            assert np.abs(got - want).max() <= 1.5 * mt.TRAIN["learning_rate"] * 2, (side, n)
            off += mt._off(got, want)
            total += want.size
        assert off <= total / 2000, f"{side}: {off} of {total} elements off 1e-5"


# --- (b) serving ------------------------------------------------------------------------------

@pytest.mark.parametrize("key, arch", CASES)
def test_head_split_serve_matches_the_jax_gspmd_serve(key, arch, ssm_mesh):
    """Every rank's rows: the prefill logits and each of 6 decode steps'
    within 1e-4 of the JAX package's, the greedy tokens equal; the state
    shards after them within 1e-5 of the gathered path's (on ``PART_CASE``
    every xLSTM cell on its rank's half of a head)."""
    ref = ssm_mesh["jax"]
    for saved, facts in ssm_mesh["ranks"]:
        f = facts[f"{key}/{arch}"]
        assert all(f["split"]) and all(g == (2 if arch == PART_CASE else 0) for g in f["parts"])
        row, n_rows = f["rows"]
        rows = slice(row * (BATCH // n_rows), (row + 1) * (BATCH // n_rows))
        for i in range(STEPS + 1):
            got, want = saved[f"serve/{key}/{arch}/{i}"], ref[f"serve/{key}/{arch}/{i}"][rows]
            np.testing.assert_allclose(got, want, atol=ms.TOL, rtol=ms.TOL, err_msg=f"step {i}")
            np.testing.assert_array_equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1),
                                          err_msg=f"step {i}")
        assert f["state_err"] <= 1e-5


# --- (c) a rank's FLOP share ------------------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS)
def test_a_ranks_cell_flops_are_at_most_xlas_share(cell, ssm_mesh):
    """A rank's traced FLOPs of the cell at (1, 4) over one device's,
    forward and gradient: about 1/4, and at most XLA's per-device share of
    the reference's cell on the same mesh + 0.05."""
    one = _cell_flops(cell, None)
    four = _cell_flops(cell, {"data": 1, "model": 4})
    for kind in ("forward", "gradient"):
        share = four[kind] / one[kind]
        xla = float(ssm_mesh["jax"][f"share/{cell}/{kind}"])
        assert 0.24 <= share <= xla + SHARE_SLACK, (kind, share, xla)


@pytest.mark.parametrize("cell, heads", PART_CELLS)
def test_a_ranks_head_part_flops_are_at_most_xlas_share(cell, heads, ssm_mesh):
    """An xLSTM cell at 2 or 1 heads on (1, 4), each rank on half or a
    quarter of one head: its traced FLOPs over one device's, forward and
    gradient, about 1/4 and at most XLA's per-device share of the
    reference's cell on the same mesh + 0.05."""
    one = _cell_flops(cell, None, heads)
    four = _cell_flops(cell, {"data": 1, "model": 4}, heads)
    assert four["g"] == 4 // heads
    for kind in ("forward", "gradient"):
        share = four[kind] / one[kind]
        xla = float(ssm_mesh["jax"][f"share/{cell}/{heads}/{kind}"])
        assert 0.24 <= share <= xla + SHARE_SLACK, (kind, share, xla)


# --- (d) what a split step gathers over model -----------------------------------------------

@pytest.mark.parametrize("arch", NAMES)
def test_a_head_split_step_gathers_no_projection_over_model(arch, ssm_mesh):
    """One step at (1, 4): every cell on its heads (or its part of one),
    all-to-alls over ``model``, and every all-gather over ``model`` of the
    gradient of a weight the rules leave whole (norm scales, ``wif``,
    ``if_bias``, ``b``; on head parts ``r``) or smaller than any of the
    projections the rules split, none of a split projection's whole shape.
    On head parts the gathers over a head's ranks are of one head's
    activations, as wide as the head (q and k, the hidden state), none a
    weight's."""
    _, facts = ssm_mesh["ranks"][0]
    f = facts[f"collectives/{arch}"]
    assert f["split"] and all(f["split"])
    assert f["a2a"] > 0
    proj = {n: s for n, s in f["cells"].items()
            if n.rsplit(".", 1)[1] in ("in_proj", "out_proj", "up", "wq", "wk", "wv", "down",
                                        "w", "out", "r")}
    assert proj
    split = {n: s for n, s in proj.items() if n not in f["whole"]}
    smallest = min(int(np.prod(s)) for s in split.values())
    whole = {int(np.prod(f["cells"][n])) for n in f["whole"]}
    for shape in f["gathers"]:
        n = int(np.prod(shape))
        assert (n < smallest or n in whole) and shape not in split.values(), shape
    if arch != PART_CASE:
        assert not any(f["parts"]) and not f["head_gathers"]
        return
    model = CONFIGS[arch][1]
    cfg = dataclasses.replace(fp32_run("xlstm-125m").model, **model)
    widths = {2 * cfg.d_model // cfg.n_heads, cfg.d_model // cfg.n_heads}   # mLSTM P, sLSTM Dh
    assert all(f["parts"]) and f["head_gathers"]
    for shape in f["head_gathers"]:
        assert shape[-2] == 1 and shape[-1] in widths and shape not in proj.values(), shape


@pytest.mark.parametrize("arch", NAMES)
def test_head_split_step_under_full_remat_equals_the_one_device_step(arch, ssm_mesh):
    """One step at (1, 4) under remat "full" (the cells' all-to-alls and
    all-reduces, and a head part's gathers and sums, issued again in the
    recompute) against the one-device step under the same remat: loss and
    grad norm 1e-5, every parameter 1e-5."""
    ours, _ = ssm_mesh["ranks"][0]
    for m in ("loss", "grad_norm"):
        np.testing.assert_allclose(ours[f"remat/{arch}/{m}/0"], ours[f"remat/{arch}/plain/{m}/0"],
                                   rtol=1e-5, err_msg=m)
    names = [k[len(f"remat/{arch}/p2/"):] for k in ours if k.startswith(f"remat/{arch}/p2/")]
    assert any(".cell." in n for n in names)
    for n in names:
        np.testing.assert_allclose(ours[f"remat/{arch}/p2/{n}"],
                                   ours[f"remat/{arch}/plain/p2/{n}"], rtol=1e-5, atol=1e-5,
                                   err_msg=n)


# --- (e) heads that model does not divide ------------------------------------------------------

@pytest.mark.parametrize("mode", ("train", "serve"))
def test_heads_that_model_does_not_divide_compute_on_head_parts(mode, ssm_mesh):
    """xlstm with 2 heads at (1, 4), which model 4 does not divide: every
    cell on every rank computes on half of one head (g = 2). Its two
    sharded steps against the gathered path's (every cell forced whole):
    loss and grad norm 2e-5 (each path is held within 1e-5 of the JAX GSPMD
    step by (a), so within 2e-5 of the other), every parameter 1e-5 but for
    at most 1 element in 2,000; its serve: every step's logits within 1e-5
    of the gathered path's, the state shards after them within 1e-5."""
    key = f"data1_model4/{PART_CASE}"
    for saved, facts in ssm_mesh["ranks"]:
        f = facts[key]
        assert all(f["split"]) and all(g == 2 for g in f["parts"]) and f["parts"]
        if mode == "serve":
            assert f["logit_err"] <= 1e-5 and f["state_err"] <= 1e-5, f
    if mode == "serve":
        return
    ours, _ = ssm_mesh["ranks"][0]
    pre, ref = f"train/{key}", f"gathered/{PART_CASE}"
    for i in range(2):
        for m in ("loss", "grad_norm"):
            np.testing.assert_allclose(ours[f"{pre}/{m}/{i}"], ours[f"{ref}/{m}/{i}"],
                                       rtol=2e-5, err_msg=f"step {i} {m}")
    names = [k[len(f"{ref}/p2/"):] for k in ours if k.startswith(f"{ref}/p2/")]
    assert any(".cell." in n for n in names)
    off = sum(mt._off(ours[f"{pre}/p2/{n}"], ours[f"{ref}/p2/{n}"]) for n in names)
    total = sum(ours[f"{ref}/p2/{n}"].size for n in names)
    assert off <= total / 2000, f"{off} of {total} elements off 1e-5"


def test_heads_that_model_does_not_divide_compute_whole(ssm_mesh):
    """xlstm with 3 heads (d_model 48) at (1, 4), which model 4 neither
    divides nor is a multiple of: no cell splits, and the sharded step and
    the sharded serve (logits and cache shards) are ``torch.equal`` to the
    gathered path (every cell forced whole)."""
    for _, facts in ssm_mesh["ranks"]:
        f = facts["whole_case"]
        assert f["split"] and not any(f["split"])
        assert f["step_equal"] and f["serve_equal"]
