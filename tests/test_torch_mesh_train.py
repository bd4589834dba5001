"""The sharded (tensor- and expert-parallel) train step, the mesh Trainer and
the mesh CLIs, on gloo ranks.

One spawn of four gloo ranks (``_dist.run_world``) on a (data 2, model 2)
mesh runs every multi-rank case of this file while a JAX child
(``_dist.JaxChild``, 4 forced host devices) runs the JAX package's jitted
step on its own (2, 2) mesh, with its ``param_shardings`` and
``batch_specs`` and ``shard_activations`` / ``_maybe_shard`` patched to the
identity (they pin layouts only). The parameters are carried across from
one ``LM.init``.

Held, fp32 throughout:
  * two sharded steps against the JAX GSPMD step: gemma2-2b smoke with int8
    compression and deepseek-v2-236b smoke (MoE load-balance loss over the
    global batch, MLA), microbatches 2: loss, grad norm and the MoE metrics
    1e-5; params and ``ef`` 1e-5 but for the rare elements whose int8
    rounding sat on a tie (counted, at most 1 in 2,000; see
    test_torch_train.py's int8 test);
  * gemma2-2b's ``adamw_factored`` step, its state on the shards, against
    the JAX GSPMD step with its state under ``opt_state_shardings``: loss,
    grad norm and every parameter 1e-5 after two steps (the norm scales
    updated as their stacked JAX leaf), every state tensor in the port's
    layout of the JAX state (bf16 moments but for flips at ties); each
    rank's ``mu`` its shard, the statistics whole; the step gathers no
    whole parameter over model;
  * the sharded step against the one-device step for every optimizer:
    ``adamw`` and ``adamw_factored`` 1e-5 after two steps, ``adamw_8bit``
    after one (its int8 moments turn an fp32 difference into a block's
    quantisation step from the second on); and for more families
    (``TP_CASES``) from the port's own init, 1e-5 after two steps; and
    zamba2-7b's stacks of per-head vectors split over model under
    ``adamw_factored`` and ``adamw_8bit``, every parameter and every state
    tensor (gathered whole) after each of two steps;
  * every rank's parameters are its shards, a step gathers them over data
    only and a layer at a time;
  * ``attn_activation_sharding`` "auto" (-> "batch") at one microbatch on
    (2, 2) and (1, 4), smollm-135m (heads that do not divide) and
    stablelm-12b (heads that divide), against the JAX GSPMD step with its
    ``_sp_shard`` constraint (the real ``_maybe_shard`` there) and the
    one-device step: loss, grad norm, parameters 1e-5 after two steps;
  * ``adamw_8bit``: the tied table's state updated on the shards
    (``BlockShards``) and the norm scales' blocks spanning their layers,
    against the JAX step under ``opt_state_shardings`` after two steps
    (every parameter and state tensor, codes but for flips at ties), four
    leaf layouts against the whole-leaf update (codes and scales equal),
    and no gather of the table over model;
  * the mesh Trainer with a crash at step 2, under ``adamw``,
    ``adamw_factored`` and ``adamw_8bit``: the one-device Trainer's
    detections, its losses at 1e-5, checkpoints that restore across;
  * ``launch.train`` and ``launch.serve`` on the mesh: the JAX launcher's
    keys from rank 0 alone; the one-process run's sampled tokens.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _dist import JaxChild, run_world

HERE = os.path.abspath(__file__)
STEP_ARCHS = {"gemma2-2b": "int8", "deepseek-v2-236b": "none"}
TRAIN = dict(warmup_steps=1, learning_rate=1e-4)
BATCH, SEQ = 4, 32
OPTIMIZERS = {"adamw_factored": 2, "adamw_8bit": 2}       # optimizer -> steps run
# more families held to the one-device step: case -> (arch, ModelConfig overrides).
# qk-norm and an untied head; cross attention; 3 heads on model 2 (the layer
# computes whole); one kv head (each rank computes the kv head its q heads
# read); the Mamba2 cell and zamba2's shared attention block
TP_CASES = {"stablelm-12b": ("stablelm-12b", {}),
            "llama-3.2-vision-11b": ("llama-3.2-vision-11b", {}),
            "smollm-135m": ("smollm-135m", {}),
            "gemma2-2b-mqa": ("gemma2-2b", {"n_kv_heads": 1}),
            "zamba2-7b": ("zamba2-7b", {})}
# the TP case whose stacked per-layer vectors the rules split over model
# (Mamba2's A_log, dt_bias, D, conv_b), under each of OPTIMIZERS
STACK_CASE = "zamba2-7b"
SHAPE_ARCHS = ("gemma2-2b", "deepseek-v2-236b")
SERVE = dict(batch=4, prompt_len=12, decode_steps=6)
# the optimizers of the mesh Trainer's fault run and cross restores
TRAINER_OPTS = ("adamw", "adamw_factored", "adamw_8bit")
SERVE_MESHES = {"data2_model2": (2, 2), "data4": (4, 1)}
# attn_activation_sharding "auto" (-> "batch": neither config's kv heads divide
# 16) at one microbatch, so a batch of 4 splits over pod x data x model: 3
# heads that no model size here divides (the rows cut before the
# projections), and 4 heads that divide (2 kv heads: divided on model 2, not
# on model 4)
MODE_ARCHS = ("smollm-135m", "stablelm-12b")
MODE_MESHES = {"data2_model2": (2, 2), "data1_model4": (1, 4)}
# 2-D leaves whose 8-bit state is placed like the parameter, updated on the
# shards against the whole-leaf update: (rows, cols, spec); a block spans
# rows (64, 96 columns), a row's shard (384 over 2), whole shards (512 over 2)
Q8_LEAVES = {"a": (512, 64, ("model", "data")), "b": (96, 96, ("data", "model")),
             "c": (16, 384, ("data", "model")), "d": (8, 512, ("model", "data"))}


def step_run(arch, compression="none", optimizer="adamw"):
    from repro_torch.configs import get_smoke_config
    run = get_smoke_config(arch)
    return run.replace(parallel=dataclasses.replace(
        run.parallel, param_dtype="float32", microbatches=2, grad_compression=compression,
        optimizer_state=optimizer), train=dataclasses.replace(run.train, **TRAIN))


def mode_run(arch):
    run = step_run(arch)
    return run.replace(parallel=dataclasses.replace(run.parallel, microbatches=1,
                                                    attn_activation_sharding="auto"))


def tp_case_run(case):
    arch, overrides = TP_CASES[case]
    run = step_run(arch)
    return run.replace(model=dataclasses.replace(run.model, **overrides))


def trainer_run(optimizer="adamw"):
    from repro_torch.configs import get_smoke_config
    run = get_smoke_config("gemma2-2b")
    return run.replace(parallel=dataclasses.replace(run.parallel, param_dtype="float32",
                                                    optimizer_state=optimizer),
                       train=dataclasses.replace(run.train, checkpoint_every=2))


def trainer_shape(run):
    from repro_torch.common.config import ShapeSpec
    return ShapeSpec("train", run.train.seq_len, run.train.global_batch, "train")


JAX_SIDE = r"""
import dataclasses
import numpy as np
import jax.numpy as jnp
import repro.models.attention as jax_attention
import repro.models.moe as jax_moe
import repro.models.transformer as jax_transformer
jax_transformer.shard_activations = lambda x: x
jax_moe_maybe_shard = jax_moe._maybe_shard
jax_moe._maybe_shard = lambda x, spec: x
from repro.common.config import ShapeSpec
from repro.configs import get_smoke_config
from repro.models.model import build_model, synthetic_batch
from repro.optim import adamw
from repro.parallel import sharding as shd
from repro.train.steps import make_train_step
from repro_torch.convert import opt_state_from_jax, params_from_jax


def state_arrays(prefix, state, cfg):
    # the JAX state in the port's layout, a bf16 moment widened to float32
    port = opt_state_from_jax(jax.tree.map(np.asarray, state), cfg)
    return {f"{prefix}/{n}/{k}": (v.float() if v.is_floating_point() else v).numpy()
            for n, st in port["m"].items() for k, v in st.items()}

out = {}
mesh = jc.make_mesh((2, 2), ("data", "model"), axis_types=(jc.AxisType.Auto,) * 2)
for arch, compression in STEP_ARCHS.items():
    run = get_smoke_config(arch)
    run = run.replace(parallel=dataclasses.replace(
        run.parallel, param_dtype="float32", microbatches=2, grad_compression=compression),
        train=dataclasses.replace(run.train, **TRAIN))
    model = build_model(run, use_kernel=False)
    np_tree = lambda t: params_from_jax(jax.tree.map(np.asarray, t), run.model)
    with jc.set_mesh(mesh):
        params = model.init(jax.random.key(0))
        out.update({f"{arch}/p0/{k}": v.numpy() for k, v in np_tree(params).items()})
        shardings = shd.param_shardings(params, mesh)
        params = jax.tree.map(jax.device_put, params, shardings)
        cfg = adamw.OptimizerConfig()
        state = adamw.init_state(cfg, params)
        step = None
        for i in range(2):
            batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
                run.model, ShapeSpec("t", SEQ, BATCH, "train"), seed=10 + i).items()}
            bsh = shd.to_shardings(shd.batch_specs(batch, mesh), mesh)
            batch = jax.tree.map(jax.device_put, batch, bsh)
            if step is None:
                step = jax.jit(make_train_step(model, run, cfg, mesh),
                               in_shardings=(shardings, None, bsh),
                               out_shardings=(shardings, None, None))
            params, state, met = step(params, state, batch)
            for key, v in met.items():
                out[f"{arch}/{key}/{i}"] = np.asarray(v)
        out.update({f"{arch}/p2/{k}": v.numpy() for k, v in np_tree(params).items()})
        if "ef" in state:
            out.update({f"{arch}/ef/{k}": v.numpy() for k, v in np_tree(state["ef"]).items()})

# the factored step with its state under opt_state_shardings, as lower_cell
# places it: gemma2-2b, no compression
from repro.launch.dryrun import opt_state_shardings
run = get_smoke_config("gemma2-2b")
run = run.replace(parallel=dataclasses.replace(run.parallel, param_dtype="float32",
                                               microbatches=2),
                  train=dataclasses.replace(run.train, **TRAIN))
model = build_model(run, use_kernel=False)
np_tree = lambda t: params_from_jax(jax.tree.map(np.asarray, t), run.model)
with jc.set_mesh(mesh):
    params = model.init(jax.random.key(0))
    pspecs = shd.param_specs(params, mesh)
    shardings = shd.to_shardings(pspecs, mesh)
    params = jax.tree.map(jax.device_put, params, shardings)
    cfg = adamw.OptimizerConfig(kind="adamw_factored")
    oshard = opt_state_shardings(jax.eval_shape(lambda p: adamw.init_state(cfg, p), params),
                                 pspecs, mesh)
    state = jax.tree.map(jax.device_put, adamw.init_state(cfg, params), oshard)
    step = None
    for i in range(2):
        batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
            run.model, ShapeSpec("t", SEQ, BATCH, "train"), seed=10 + i).items()}
        bsh = shd.to_shardings(shd.batch_specs(batch, mesh), mesh)
        batch = jax.tree.map(jax.device_put, batch, bsh)
        if step is None:
            step = jax.jit(make_train_step(model, run, cfg, mesh),
                           in_shardings=(shardings, oshard, bsh),
                           out_shardings=(shardings, oshard, None))
        params, state, met = step(params, state, batch)
        for key, v in met.items():
            out[f"factored/{key}/{i}"] = np.asarray(v)
    out.update({f"factored/p2/{k}": v.numpy() for k, v in np_tree(params).items()})
    out.update(state_arrays("factored/m", state, run.model))

# the 8-bit step, its state under opt_state_shardings (a spec whose axes do
# not divide a dim fitted as the port's fit_spec does: jit refuses it)
def fitted(sharding, leaf):
    spec = tuple(sharding.spec) + (None,) * (leaf.ndim - len(sharding.spec))
    out_spec = []
    for dim, entry in zip(leaf.shape, spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        k = len(axes)
        while k and dim % int(np.prod([mesh.shape[a] for a in axes[:k]])):
            k -= 1
        out_spec.append(None if not k else axes[0] if k == 1 else axes[:k])
    return jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(*out_spec))

with jc.set_mesh(mesh):
    params = model.init(jax.random.key(0))
    pspecs = shd.param_specs(params, mesh)
    shardings = shd.to_shardings(pspecs, mesh)
    params = jax.tree.map(jax.device_put, params, shardings)
    cfg = adamw.OptimizerConfig(kind="adamw_8bit")
    abstract = jax.eval_shape(lambda p: adamw.init_state(cfg, p), params)
    oshard = jax.tree.map(fitted, opt_state_shardings(abstract, pspecs, mesh), abstract)
    state = jax.tree.map(jax.device_put, adamw.init_state(cfg, params), oshard)
    step = None
    for i in range(2):
        batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
            run.model, ShapeSpec("t", SEQ, BATCH, "train"), seed=10 + i).items()}
        bsh = shd.to_shardings(shd.batch_specs(batch, mesh), mesh)
        batch = jax.tree.map(jax.device_put, batch, bsh)
        if step is None:
            step = jax.jit(make_train_step(model, run, cfg, mesh),
                           in_shardings=(shardings, oshard, bsh),
                           out_shardings=(shardings, oshard, None))
        params, state, met = step(params, state, batch)
        for key, v in met.items():
            out[f"q8/{key}/{i}"] = np.asarray(v)
        out.update({f"q8/p{i + 1}/{k}": v.numpy() for k, v in np_tree(params).items()})
    out.update(state_arrays("q8/m", state, run.model))

# the "batch" attention mode: the reference's _sp_shard with its own
# _maybe_shard (the constraint over pod x data x model), the rest as above
real_maybe_shard = jax_moe_maybe_shard
real_sp_shard = jax_attention._sp_shard


def sp_shard(q, k, v, mode="sequence"):
    jax_moe._maybe_shard = real_maybe_shard
    try:
        return real_sp_shard(q, k, v, mode)
    finally:
        jax_moe._maybe_shard = lambda x, spec: x


jax_attention._sp_shard = sp_shard
for key, shape in MODE_MESHES.items():
    mode_mesh = jc.make_mesh(shape, ("data", "model"), axis_types=(jc.AxisType.Auto,) * 2)
    for arch in MODE_ARCHS:
        run = get_smoke_config(arch)
        run = run.replace(parallel=dataclasses.replace(
            run.parallel, param_dtype="float32", microbatches=1, attn_activation_sharding="auto"),
            train=dataclasses.replace(run.train, **TRAIN))
        model = build_model(run, use_kernel=False)
        assert model.sp_attn == "batch", model.sp_attn
        np_tree = lambda t: params_from_jax(jax.tree.map(np.asarray, t), run.model)
        with jc.set_mesh(mode_mesh):
            params = model.init(jax.random.key(0))
            shardings = shd.param_shardings(params, mode_mesh)
            params = jax.tree.map(jax.device_put, params, shardings)
            cfg = adamw.OptimizerConfig()
            state = adamw.init_state(cfg, params)
            step = None
            for i in range(2):
                batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
                    run.model, ShapeSpec("t", SEQ, BATCH, "train"), seed=10 + i).items()}
                bsh = shd.to_shardings(shd.batch_specs(batch, mode_mesh), mode_mesh)
                batch = jax.tree.map(jax.device_put, batch, bsh)
                if step is None:
                    step = jax.jit(make_train_step(model, run, cfg, mode_mesh),
                                   in_shardings=(shardings, None, bsh),
                                   out_shardings=(shardings, None, None))
                    text = step.lower(params, state, batch).as_text()
                    out[f"mode/{key}/{arch}/constraints"] = np.asarray(
                        text.count("sharding_constraint"))
                params, state, met = step(params, state, batch)
                for m, v in met.items():
                    out[f"mode/{key}/{arch}/{m}/{i}"] = np.asarray(v)
            out.update({f"mode/{key}/{arch}/p2/{k}": v.numpy()
                        for k, v in np_tree(params).items()})
np.savez(os.path.join(OUT, "steps.npz"), **out)
"""


# --- rank side -----------------------------------------------------------------------

def _batch(run, seed):
    from repro_torch.common.config import ShapeSpec
    from repro_torch.models.model import synthetic_batch
    return synthetic_batch(run.model, ShapeSpec("t", SEQ, BATCH, "train"), seed=seed,
                           device="cpu")


def _whole_state(prefix, m):
    """An optimizer state's tensors, whole, as float32 or int8 arrays."""
    from repro_torch.train.steps import gather
    return {f"{prefix}/{n}/{k}": (v.float() if v.is_floating_point() else v).numpy().copy()
            for n, st in gather(m).items() for k, v in st.items()}


def _sharded_steps(run, mesh, p0, n_steps, with_plain=False, keep=None, states=False):
    """n_steps sharded steps from ``p0`` (and, on request, the one-device
    steps beside them). Returns per-step metrics, full params, full ef;
    ``keep`` (a dict) receives the last masters and optimizer state;
    ``states``: every optimizer state tensor, whole, after the first step
    (``step1/m/...``) and the last (``m/...``), the one-device state's under
    ``plain/``."""
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel.compression import ErrorFeedback
    from repro_torch.train.steps import gather, jax_leaves, make_train_step, shard_train_state
    cfg = adamw.OptimizerConfig(kind=run.parallel.optimizer_state)

    def fresh():
        model = build_model(run, device="cpu")
        model.load_state_dict(p0)
        params = dict(model.named_parameters())
        state = adamw.init_state(cfg, params, jax_leaves(model))
        if run.parallel.grad_compression == "int8":
            state["ef"] = ErrorFeedback.init(params)
        return model, params, state

    model, params, state = fresh()
    pl = shd.param_placements(params, mesh)
    masters, sstate = shard_train_state(params, state, cfg, mesh, pl)
    step = make_train_step(model, run, cfg, mesh)
    plain = None
    if with_plain:
        pmodel, pparams, pstate = fresh()
        plain = make_train_step(pmodel, run, cfg)
    res = {}
    for i in range(n_steps):
        batch = _batch(run, 10 + i)
        masters, sstate, met = step(masters, sstate, batch)
        res.update({f"{k}/{i}": v.detach().numpy() for k, v in met.items()})
        if plain is not None:
            pparams, pstate, pmet = plain(pparams, pstate, batch)
            res.update({f"plain/{k}/{i}": v.detach().numpy() for k, v in pmet.items()})
        if i == 0 < n_steps - 1:     # copies: the next step updates the tensors in place
            res.update({f"p1/{k}": v.detach().numpy().copy() for k, v in gather(masters).items()})
            if plain is not None:
                res.update({f"plain/p1/{k}": v.detach().numpy().copy()
                            for k, v in pparams.items()})
            if states:
                res.update(_whole_state("step1/m", sstate["m"]))
                res.update(_whole_state("step1/plain/m", pstate["m"]))
    if keep is not None:
        keep.update(masters=masters, state=sstate)
    res.update({f"p2/{k}": v.detach().numpy() for k, v in gather(masters).items()})
    if "ef" in sstate:
        res.update({f"ef/{k}": v.numpy() for k, v in gather(sstate["ef"]).items()})
    if plain is not None:
        res.update({f"plain/p2/{k}": v.detach().numpy() for k, v in pparams.items()})
    if states:
        res.update(_whole_state("m", sstate["m"]))
        res.update(_whole_state("plain/m", pstate["m"]))
    return res


def _port_init(run):
    """The port's own LM.init_weights (seed 0), the same on every rank."""
    from repro_torch.models.model import build_model
    model = build_model(run, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _shapes_and_gathers(mesh):
    """For each of SHAPE_ARCHS: the model's parameter shapes once the step
    has cut it, and (shape, bytes, group) of every all-gather one step
    issues."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.steps import jax_leaves, make_train_step, shard_train_state

    class Gathers(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out_ = func(*args, **(kwargs or {}))
            if func._schema.name == "_c10d_functional::all_gather_into_tensor":
                self.seen.append((list(out_.shape), out_.numel() * out_.element_size(), args[2]))
            return out_

    res = {"groups": {a: mesh.get_group(a).group_name for a in mesh.mesh_dim_names}}
    for arch in SHAPE_ARCHS:
        run = step_run(arch)
        cfg = adamw.OptimizerConfig()
        model = build_model(run, device="cpu")
        model.load_state_dict(_port_init(run))
        params = dict(model.named_parameters())
        masters, state = shard_train_state(params, adamw.init_state(cfg, params, jax_leaves(model)),
                                           cfg, mesh, shd.param_placements(params, mesh))
        step = make_train_step(model, run, cfg, mesh)
        mode = Gathers()
        with mode:
            step(masters, state, _batch(run, 10))
        res[arch] = {"shapes": {n: list(p.shape) for n, p in model.named_parameters()},
                     "full": {n: list(p.tp_full_shape) for n, p in model.named_parameters()},
                     "gathers": mode.seen}
    # one factored step of gemma2-2b: its update's gathers
    run = step_run("gemma2-2b", optimizer="adamw_factored")
    cfg = adamw.OptimizerConfig(kind="adamw_factored")
    model = build_model(run, device="cpu")
    model.load_state_dict(_port_init(run))
    params = dict(model.named_parameters())
    masters, state = shard_train_state(params, adamw.init_state(cfg, params, jax_leaves(model)),
                                       cfg, mesh, shd.param_placements(params, mesh))
    step = make_train_step(model, run, cfg, mesh)
    mode = Gathers()
    with mode:
        step(masters, state, _batch(run, 10))
    res["factored_gathers"] = mode.seen
    # one 8-bit step of gemma2-2b
    run = step_run("gemma2-2b", optimizer="adamw_8bit")
    cfg = adamw.OptimizerConfig(kind="adamw_8bit")
    model = build_model(run, device="cpu")
    model.load_state_dict(_port_init(run))
    params = dict(model.named_parameters())
    masters, state = shard_train_state(params, adamw.init_state(cfg, params, jax_leaves(model)),
                                       cfg, mesh, shd.param_placements(params, mesh))
    step = make_train_step(model, run, cfg, mesh)
    mode = Gathers()
    with mode:
        step(masters, state, _batch(run, 10))
    res["q8_gathers"] = mode.seen
    return res


def _q8_block_shards(mesh):
    """Each ``Q8_LEAVES`` leaf, its gradient and a non-zero 8-bit state (the
    same on every rank) updated whole and, on this rank's shards, through
    ``steps.BlockShards``: the codes and scales gathered whole, and the
    parameter, beside the whole update's."""
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    from repro_torch.train.steps import block_shards, state_specs
    cfg = adamw.OptimizerConfig(kind="adamw_8bit")
    tp = tensor.TensorParallel(mesh)
    gen = torch.Generator().manual_seed(5)
    out = {}
    for key, (rows, cols, spec) in Q8_LEAVES.items():
        p = torch.randn(rows, cols, generator=gen)
        g = torch.randn(rows, cols, generator=gen) * 1e-2
        mu, nu = torch.randn(rows, cols, generator=gen) * 1e-3, torch.rand(rows, cols,
                                                                            generator=gen) * 1e-4
        (mq, ms), (nq, ns) = adamw._q8_encode(mu, 256), adamw._q8_encode(nu, 256)
        st = {"mu_q": mq, "mu_s": ms, "nu_q": nq, "nu_s": ns}
        lr, step = torch.tensor(1e-3), torch.tensor(3, dtype=torch.int32)
        whole_p = p.clone()
        want = adamw.update_leaf(cfg, whole_p, g, dict(st), lr, step)
        specs = state_specs(cfg, {"w": spec}, {"w": (rows, cols)}, mesh, {})["w"]
        shards = block_shards(tp, spec, (rows, cols), specs, 256, p.device)
        assert shards is not None, key
        local = tp.shard(p, spec).clone()
        got = adamw.update_leaf(cfg, local, tp.shard(g, spec),
                                {k: tp.shard(v, specs[k]).clone() for k, v in st.items()},
                                lr, step, shards)
        out[f"q8leaf/{key}/p"] = [tp.full(local, spec).numpy(), whole_p.numpy()]
        for k in st:
            out[f"q8leaf/{key}/{k}"] = [tp.full(got[k], specs[k]).numpy(), want[k].numpy()]
    return {k: np.stack(v) for k, v in out.items()}


def _state_sizes(kept):
    """Each factored leaf's local and whole sizes on this rank: the
    parameter's shard and whole numel, ``mu``'s local numel and dtype,
    ``nu_row`` and ``nu_col``'s local and whole shapes."""
    masters, state = kept["masters"], kept["state"]
    out = {}
    for name, st in state["m"].items():
        if "nu_row" not in st:
            continue
        out[name] = {"param": [masters[name].to_local().numel(), masters[name].numel()],
                     "mu": [st["mu"].to_local().numel(), str(st["mu"].dtype)],
                     **{k: [list(st[k].to_local().shape), list(st[k].shape)]
                        for k in ("nu_row", "nu_col") if k in st}}
    return out


def ranks(rank, world, out, inputs):
    import contextlib
    import io
    import torch.distributed as dist
    from repro_torch.core.faults import Fault
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.trainer import FaultInjector, Trainer

    with pytest.raises(ValueError, match="needs 3 ranks"):
        make_local_mesh(3, 1, device="cpu")
    mesh = make_local_mesh(2, 2, device="cpu")
    saved = {}
    # the sharded steps against the JAX package's and the one-device step
    for arch, compression in STEP_ARCHS.items():
        p0 = {k: torch.from_numpy(v) for k, v in np.load(inputs[arch]).items()}
        res = _sharded_steps(step_run(arch, compression), mesh, p0, 2)
        saved.update({f"{arch}/{k}": v for k, v in res.items()})
    p0 = {k: torch.from_numpy(v) for k, v in np.load(inputs["gemma2-2b"]).items()}
    kept = {}
    for opt, n in {"adamw": 2, **OPTIMIZERS}.items():
        res = _sharded_steps(step_run("gemma2-2b", optimizer=opt), mesh, p0, n, with_plain=True,
                             keep=kept.setdefault(opt, {}))
        saved.update({f"{opt}/{k}": v for k, v in res.items()})
    factored = _state_sizes(kept["adamw_factored"])
    for opt in OPTIMIZERS:       # every state tensor, whole; a bf16 moment as float32
        saved.update(_whole_state(f"{opt}/m", kept[opt]["state"]["m"]))
    del kept
    # the "batch" attention mode on (2, 2) and (1, 4)
    for key, (data, model_size) in MODE_MESHES.items():
        mode_mesh = mesh if (data, model_size) == (2, 2) else make_local_mesh(data, model_size,
                                                                              device="cpu")
        for arch in MODE_ARCHS:
            p0 = {k: torch.from_numpy(v) for k, v in np.load(inputs[arch]).items()}
            res = _sharded_steps(mode_run(arch), mode_mesh, p0, 2, with_plain=True)
            saved.update({f"mode/{key}/{arch}/{k}": v for k, v in res.items()})
    saved.update(_q8_block_shards(mesh))
    for case in TP_CASES:
        run = tp_case_run(case)
        res = _sharded_steps(run, mesh, _port_init(run), 2, with_plain=True)
        saved.update({f"{case}/{k}": v for k, v in res.items()})
    # zamba2-7b's stacks of per-head vectors, split over model, under the
    # optimizers that update a stack as one
    run = tp_case_run(STACK_CASE)
    p0 = _port_init(run)
    for opt in OPTIMIZERS:
        res = _sharded_steps(run.replace(parallel=dataclasses.replace(
            run.parallel, optimizer_state=opt)), mesh, p0, 2, with_plain=True, states=True)
        saved.update({f"stack/{opt}/{k}": v for k, v in res.items()})
    shapes = _shapes_and_gathers(mesh)

    # the mesh Trainer of each optimizer: a crash at step 2; then a restore of
    # the one-device Trainer's checkpoint
    trainers = {}
    for opt in TRAINER_OPTS:
        run = trainer_run(opt)
        tr = Trainer(run, trainer_shape(run), os.path.join(out, f"mesh_ckpt_{opt}"),
                     device="cpu", mesh=mesh, checkpoint_async=False)
        first_mesh = tr.mesh
        rep = tr.train(4, injector=FaultInjector({2: Fault("crash", rank=3)}))
        dist.barrier()              # rank 0 may still be writing the last checkpoint
        res = {"losses": rep.losses, "restarts": rep.restarts,
               "detections": [{k: d[k] for k in ("fault", "at_step", "verdicts", "isolated",
                                                  "detection_windows", "restored_step")}
                              for d in rep.detections],
               "rebuilt_mesh": tr.mesh is not first_mesh,
               "disk_steps": tr.ckpt.disk_steps(), "save_count": tr.ckpt.save_count}
        back = Trainer(run, trainer_shape(run), inputs[f"one_device_ckpt_{opt}"], device="cpu",
                       mesh=mesh, checkpoint_async=False)
        res["restored"] = back.restore(step=2)
        back.ckpt.disk = False      # leave the one-device run's directory as it was
        res["continued"] = back.train(2).losses
        trainers[opt] = res
    trainer = {"trainers": trainers, "factored": factored}

    # the CLIs
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train_cli.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu", "--steps", "2",
                        "--data", "2", "--model", "2", "--inject-fault", "crash:1",
                        "--workdir", os.path.join(out, "cli")])
    trainer["train_cli"] = buf.getvalue()
    for key, (data, model) in SERVE_MESHES.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_cli.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                            "--batch", str(SERVE["batch"]),
                            "--prompt-len", str(SERVE["prompt_len"]),
                            "--decode-steps", str(SERVE["decode_steps"]),
                            "--data", str(data), "--model", str(model)])
        trainer[f"serve/{key}"] = buf.getvalue()
    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(out, "steps.npz"), **saved)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(dict(trainer, shapes=shapes), f)


# --- fixtures ------------------------------------------------------------------------------

def _initial_params(tmp):
    """The JAX package's LM.init of each step config, in the port's names."""
    import jax
    import repro.configs as jax_configs
    import repro.models.model as jax_model
    from repro_torch.convert import params_from_jax
    paths = {}
    for arch in (*STEP_ARCHS, *MODE_ARCHS):
        jrun = jax_configs.get_smoke_config(arch)
        jrun = jrun.replace(parallel=dataclasses.replace(jrun.parallel, param_dtype="float32"))
        params = jax_model.build_model(jrun, use_kernel=False).init(jax.random.key(0))
        state = params_from_jax(jax.tree.map(np.asarray, params), step_run(arch).model)
        paths[arch] = os.path.join(tmp, f"{arch}.npz")
        np.savez(paths[arch], **{k: v.numpy() for k, v in state.items()})
    return paths


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    from repro_torch.core.faults import Fault
    from repro_torch.train.trainer import FaultInjector, Trainer
    tmp = tmp_path_factory.mktemp("mesh")
    code = JAX_SIDE.replace("MODE_ARCHS", repr(MODE_ARCHS))
    code = code.replace("MODE_MESHES", repr(MODE_MESHES))
    code = code.replace("STEP_ARCHS", repr(STEP_ARCHS)).replace("TRAIN", repr(TRAIN))
    code = code.replace("SEQ", str(SEQ)).replace("BATCH", str(BATCH))
    child = JaxChild(code, tmp_path_factory.mktemp("jax"))
    inputs = _initial_params(str(tmp))
    # the one-device Trainer's run of each optimizer, and its checkpoints for
    # the mesh to restore
    one_rep = {}
    for opt in TRAINER_OPTS:
        run = trainer_run(opt)
        one = Trainer(run, trainer_shape(run), str(tmp / f"one_ckpt_{opt}"), device="cpu",
                      checkpoint_async=False)
        one_rep[opt] = one.train(4, injector=FaultInjector({2: Fault("crash", rank=3)}))
        inputs[f"one_device_ckpt_{opt}"] = str(tmp / f"one_ckpt_{opt}")
    out = run_world(f"{HERE}:ranks", 4, tmp, inputs=inputs)
    ranks_out = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks_out.append(json.load(f))
    ours = dict(np.load(os.path.join(out, "steps.npz")))
    jax_out = dict(np.load(os.path.join(child.result(), "steps.npz")))
    return dict(ranks=ranks_out, ours=ours, jax=jax_out, one=one_rep, out=out,
                inputs=inputs)


def _off(got, want):
    """How many elements miss 1e-5 (rtol and atol)."""
    return int((np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)).sum())


# --- the sharded step -------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(STEP_ARCHS))
def test_sharded_step_matches_the_jax_gspmd_step(arch, mesh_run):
    ours, ref = mesh_run["ours"], mesh_run["jax"]
    p0 = np.load(mesh_run["inputs"][arch])
    for k in p0.files:          # the same LM.init on both sides
        np.testing.assert_array_equal(p0[k], ref[f"{arch}/p0/{k}"])
    keys = {k.split("/")[1] for k in ref if k.endswith("/0") and k.startswith(arch)}
    assert {"loss", "grad_norm", "lr"} <= keys
    if arch == "deepseek-v2-236b":
        assert {"moe_lb_loss", "moe_z_loss"} <= keys
    for i in range(2):
        for key in keys:
            np.testing.assert_allclose(ours[f"{arch}/{key}/{i}"], ref[f"{arch}/{key}/{i}"],
                                       rtol=1e-5, err_msg=f"step {i} {key}")
    flips, total = 0, 0
    lr_bound = 1.5 * TRAIN["learning_rate"] * 2
    for k in p0.files:
        got, want = ours[f"{arch}/p2/{k}"], ref[f"{arch}/p2/{k}"]
        assert np.abs(got - want).max() <= lr_bound, k
        flips += _off(got, want)
        total += want.size
        if STEP_ARCHS[arch] == "int8":
            got, want = ours[f"{arch}/ef/{k}"], ref[f"{arch}/ef/{k}"]
            step = 2 * max(np.abs(got).max(), np.abs(want).max())
            assert np.abs(got - want).max() <= step + 1e-5, k
            flips += int((np.abs(got - want) > 1e-5).sum())
    if STEP_ARCHS[arch] == "int8":
        assert flips <= total / 2000, f"{flips} of {total} elements flipped"
    else:
        assert flips == 0


def _hold_state(ours, ref, opt, ref_key):
    """Every optimizer state tensor of the sharded run, gathered whole, against
    the JAX GSPMD step's carried into the port's layout
    (``convert.opt_state_from_jax``): the same tensors; float32 statistics
    and 8-bit scales 1e-5; int8 codes and bf16 first moments (both stored as
    float32 here) equal but for flips at rounding ties (one code, or one bf16
    step), at most 1 in 2,000."""
    mine = {k[len(f"{opt}/m/"):]: v for k, v in ours.items() if k.startswith(f"{opt}/m/")}
    want = {k[len(f"{ref_key}/m/"):]: v for k, v in ref.items()
            if k.startswith(f"{ref_key}/m/")}
    assert mine.keys() == want.keys() and mine
    flips = total = 0
    for k, w in want.items():
        got = mine[k]
        assert got.shape == w.shape, k
        if k.endswith(("_q", "/mu")):
            off = np.abs(got.astype(np.float64) - w) > 1e-5 + 1e-5 * np.abs(w)
            step = 1.0 if k.endswith("_q") else np.abs(w) * 2.0 ** -7
            assert (np.abs(got.astype(np.float64) - w) <= step + 1e-30)[off].all(), k
            flips, total = flips + int(off.sum()), total + w.size
        else:
            np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-12 if k.endswith("_s") else 1e-5,
                                       err_msg=k)
    assert flips <= total / 2000, f"{opt}: {flips} of {total} flipped"
    return len(want)


def test_factored_step_matches_the_jax_gspmd_step_under_its_state_placement(mesh_run):
    """gemma2-2b's factored step on the (2, 2) mesh, its state under
    ``opt_state_specs`` and updated on the shards, against the JAX GSPMD step
    with its state under ``opt_state_shardings`` as ``in_shardings``: loss and
    grad norm at both steps 1e-5, every parameter 1e-5 after two steps, the
    norm scales of every layer updated as their stacked (units, d) JAX leaf
    (``optim/adamw.py``), and every state tensor as ``_hold_state`` holds it."""
    ours, ref = mesh_run["ours"], mesh_run["jax"]
    for i in range(2):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(ours[f"adamw_factored/{key}/{i}"],
                                       ref[f"factored/{key}/{i}"], rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    names = [k[len("factored/p2/"):] for k in ref if k.startswith("factored/p2/")]
    assert any(ref[f"factored/p2/{n}"].ndim == 1 and n.startswith("blocks.") for n in names)
    for n in names:
        np.testing.assert_allclose(ours[f"adamw_factored/p2/{n}"], ref[f"factored/p2/{n}"],
                                   rtol=1e-5, atol=1e-5, err_msg=n)
    assert _hold_state(ours, ref, "adamw_factored", "factored") > len(names)


def test_each_rank_holds_its_shard_of_the_factored_first_moment(mesh_run):
    """On every rank each factored leaf's bf16 ``mu`` is a local shard of
    numel / (the shards of its parameter), never the whole leaf where the
    parameter is cut; ``nu_row`` and ``nu_col`` are whole, as the JAX
    package places them."""
    cut = 0
    for r, res in enumerate(mesh_run["ranks"]):
        sizes = res["factored"]
        assert sizes, r
        for name, sz in sizes.items():
            local, whole = sz["param"]
            assert sz["mu"] == [local, "torch.bfloat16"], (r, name, sz)
            assert local * (whole // local) == whole
            cut += local < whole
            for key in ("nu_row", "nu_col"):
                assert key not in sz or sz[key][0] == sz[key][1], (r, name, key)
    assert cut >= 4 * len(mesh_run["ranks"][0]["factored"]) // 2


def test_a_factored_step_gathers_no_whole_parameter(mesh_run):
    """One factored step of gemma2-2b on the (2, 2) mesh, its all-gathers
    counted by a dispatch mode: the forward's are one layer's weights over
    data (half a parameter, still split over model), the update's are the
    row and column statistics, vectors: no gather outputs a whole parameter
    over model (the whole-leaf update's last gather of a model-split leaf
    did)."""
    for r, res in enumerate(mesh_run["ranks"]):
        sh = res["shapes"]
        full = {d for s in sh["gemma2-2b"]["full"].values() for d in s}
        over_model = [g for g in sh["factored_gathers"] if g[2] == sh["groups"]["model"]]
        assert over_model, r             # the column statistics of the model-split leaves
        assert all(len(g[0]) == 1 and g[0][0] in full for g in over_model), (r, over_model)


def _hold_to_one_device(ours, key, n, at="p2"):
    """Loss and grad norm at each of ``n`` steps (1e-5), and the params
    ``at`` a step (1e-5 relative and absolute: "p1" after the first, "p2"
    after the last), against the one-device step."""
    for i in range(n):
        for m in ("loss", "grad_norm"):
            np.testing.assert_allclose(ours[f"{key}/{m}/{i}"], ours[f"{key}/plain/{m}/{i}"],
                                       rtol=1e-5, err_msg=f"{key} step {i} {m}")
    names = [k[len(f"{key}/{at}/"):] for k in ours if k.startswith(f"{key}/{at}/")]
    assert names
    for k in names:
        np.testing.assert_allclose(ours[f"{key}/{at}/{k}"], ours[f"{key}/plain/{at}/{k}"],
                                   rtol=1e-5, atol=1e-5, err_msg=f"{key} {k}")


@pytest.mark.parametrize("opt", ["adamw", *OPTIMIZERS])
def test_sharded_step_equals_the_one_device_step(opt, mesh_run):
    """The elementwise and factored updates on the shards, the 8-bit one on
    the shards where its state sits like the parameter (the tied table) and
    on the gathered leaf elsewhere (a stack whose blocks span its layers
    gathered together), against the same steps on one device: two steps,
    the 8-bit parameters after the first (its int8 moments turn an fp32
    difference into a block's quantisation step from the second on; the
    second is held to the JAX step with its ties counted)."""
    _hold_to_one_device(mesh_run["ours"], opt, 2, "p1" if opt == "adamw_8bit" else "p2")


@pytest.mark.parametrize("case", list(TP_CASES))
def test_tp_step_equals_the_one_device_step(case, mesh_run):
    """Tensor-parallel attention with qk-norm and an untied vocab-parallel
    head (stablelm-12b), cross attention (llama-3.2-vision-11b), attention
    computed whole where 3 heads do not divide by 2 (smollm-135m), one kv
    head read by both ranks' q heads, the Mamba2 cell and the shared block
    (zamba2-7b): two steps on the (2, 2) mesh against the one-device step."""
    _hold_to_one_device(mesh_run["ours"], case, 2)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_stacks_split_over_model_equal_the_one_device_step(opt, mesh_run):
    """zamba2-7b's stacked per-head vectors, which the rules split over
    model ((None, 'model') over (units, heads)), under ``adamw_factored``
    (a ``LeafShards`` keyed by the JAX leaf) and ``adamw_8bit`` (the stack's
    members and blocks gathered together): two steps on the (2, 2) mesh
    against the one-device step (itself held to the JAX step by
    test_torch_train.py's stacked test). Loss and grad norm 1e-5 at both
    steps; every parameter 1e-5 after the first; every state tensor,
    gathered whole, after each step as ``_hold_state`` holds it; every
    parameter 1e-5 after the second but for the 8-bit elements
    ``_ties.unsettled`` names."""
    from _ties import unsettled
    from repro_torch.models.model import build_model
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.steps import jax_leaves
    ours, key = mesh_run["ours"], f"stack/{opt}"
    model = build_model(tp_case_run(STACK_CASE), device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    stacks = adamw.stacks(adamw.OptimizerConfig(kind=opt), shapes, jax_leaves(model))
    specs = shd.param_specs(shapes, {"data": 2, "model": 2})
    split = [n for ms in stacks.values() for n in ms if "model" in specs[n]]
    assert any(n.endswith("A_log") for n in split), split
    _hold_to_one_device(ours, key, 2, "p1")
    n_state = _hold_state(ours, ours, f"{key}/step1", f"{key}/step1/plain")
    assert _hold_state(ours, ours, key, f"{key}/plain") == n_state
    loose = None
    if opt == "adamw_8bit":
        def m(prefix):
            out = {}
            for k, v in ours.items():
                if k.startswith(prefix):
                    n, sk = k[len(prefix):].rsplit("/", 1)
                    out.setdefault(n, {})[sk] = v
            return out
        loose = unsettled(m(f"{key}/step1/m/"), m(f"{key}/step1/plain/m/"), shapes, stacks)
    for n in shapes:
        got, want = ours[f"{key}/p2/{n}"], ours[f"{key}/plain/p2/{n}"]
        off = np.abs(got - want) > 1e-5 + 1e-5 * np.abs(want)
        if loose is not None:
            off &= ~loose[n]
        assert not off.any(), f"{key} {n}: {int(off.sum())} elements off 1e-5"


def test_ranks_hold_local_shards_and_gather_one_layer_over_data(mesh_run):
    """On the (data 2, model 2) mesh each rank's module parameters are its
    shards: ``wq`` (d/2, H hd/2), whole over data when the layer runs (d,
    H hd/2); the MoE ``wi_gate`` (E/2, d/2, f); the table (V/2, d/2). A step
    gathers only over data (every layer of these configs splits over
    model), and its largest gather is one layer's weights."""
    from repro_torch.configs import get_smoke_config
    for r, res in enumerate(mesh_run["ranks"]):
        sh = res["shapes"]
        data_group = sh["groups"]["data"]
        for arch in SHAPE_ARCHS:
            cfg = get_smoke_config(arch).model
            d, h, hd, v = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim, cfg.vocab_size
            shapes, gathers = sh[arch]["shapes"], sh[arch]["gathers"]
            assert shapes["embed.table"] == [v // 2, d // 2], (r, arch)
            if arch == "gemma2-2b":
                assert shapes["blocks.0.attn.wq"] == [d // 2, h * hd // 2]
                assert [d, h * hd // 2] in [g[0] for g in gathers]
            else:
                m = cfg.moe
                moe_layer = next(i for i in range(cfg.n_layers) if i >= cfg.first_k_dense)
                assert shapes[f"blocks.{moe_layer}.moe.wi_gate"] == [
                    m.num_experts // 2, d // 2, m.d_ff_expert]
            assert gathers and all(g[2] == data_group for g in gathers), (r, arch)
            layers = {}
            for name, shape in shapes.items():
                layer = ".".join(name.split(".")[:2]) if name.startswith("blocks.") else name
                layers[layer] = layers.get(layer, 0) + 2 * int(np.prod(shape)) * 4
            assert max(g[1] for g in gathers) <= max(layers.values()), (r, arch)


# --- the Trainer -------------------------------------------------------------------------------

@pytest.mark.parametrize("opt", TRAINER_OPTS)
def test_mesh_trainer_fault_run_equals_the_one_device_trainer(opt, mesh_run):
    """Every rank runs the same seeded control plane: the same detection
    and isolation as the one-device Trainer, the restore to step 2, the
    mesh rebuilt, the same losses (1e-5); rank 0 alone wrote checkpoints."""
    one = mesh_run["one"][opt]
    want = [{k: d[k] for k in ("fault", "at_step", "verdicts", "isolated",
                               "detection_windows", "restored_step")} for d in one.detections]
    want = json.loads(json.dumps(want))
    for r, ranks_out in enumerate(mesh_run["ranks"]):
        res = ranks_out["trainers"][opt]
        assert res["detections"] == want, r
        assert res["restarts"] == 1 and res["rebuilt_mesh"]
        np.testing.assert_allclose(res["losses"], one.losses, rtol=1e-5, err_msg=f"rank {r}")
        assert res["disk_steps"] == [0, 2, 4] and res["save_count"] == 3
    assert want[0]["restored_step"] == 2
    files = sorted(os.listdir(os.path.join(mesh_run["out"], f"mesh_ckpt_{opt}")))
    assert files == [f"ckpt_{s:08d}.{e}" for s in (0, 2, 4) for e in ("json", "npz")]


@pytest.mark.parametrize("opt", TRAINER_OPTS)
def test_mesh_checkpoint_restores_into_a_one_device_trainer(opt, mesh_run, tmp_path):
    """The mesh Trainer's checkpoint holds the one-device keys and whole
    tensors (its sharded optimizer state gathered): a one-device Trainer
    restores it and replays the mesh run's last two steps."""
    import shutil
    from repro_torch.train.trainer import Trainer
    run = trainer_run(opt)
    work = tmp_path / "ckpt"
    shutil.copytree(os.path.join(mesh_run["out"], f"mesh_ckpt_{opt}"), work)
    tr = Trainer(run, trainer_shape(run), str(work), device="cpu", checkpoint_async=False)
    one = Trainer(run, trainer_shape(run), mesh_run["inputs"][f"one_device_ckpt_{opt}"],
                  device="cpu", checkpoint_async=False)
    # the same keys, shapes and dtypes as the one-device Trainer's checkpoint
    _, mine = tr.ckpt.restore_flat(2)
    _, theirs = one.ckpt.restore_flat(2)
    assert {k: (tuple(v.shape), v.dtype) for k, v in mine.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in theirs.items()}
    assert tr.restore(step=2) == 2
    losses = tr.train(2).losses
    mesh_losses = mesh_run["ranks"][0]["trainers"][opt]["losses"]
    # the mesh run's steps 2 and 3, replayed after its restore (its last two)
    np.testing.assert_allclose(losses, mesh_losses[-2:], rtol=1e-5)


@pytest.mark.parametrize("opt", TRAINER_OPTS)
def test_one_device_checkpoint_restores_into_a_mesh_trainer(opt, mesh_run):
    one = mesh_run["one"][opt]
    for r, ranks_out in enumerate(mesh_run["ranks"]):
        res = ranks_out["trainers"][opt]
        assert res["restored"] == 2
        np.testing.assert_allclose(res["continued"], one.losses[-2:], rtol=1e-5,
                                   err_msg=f"rank {r}")


# --- the CLIs ---------------------------------------------------------------------------------

def test_train_cli_trains_on_a_data_model_mesh(mesh_run):
    outs = [res["train_cli"] for res in mesh_run["ranks"]]
    assert all(o == "" for o in outs[1:])
    out = json.loads(outs[0])
    assert set(out) == {"arch", "steps_run", "restarts", "first_loss", "last_loss",
                        "detections", "step_stats", "checkpoints_saved"}
    assert out["steps_run"] == 3 and out["restarts"] == 1 and np.isfinite(out["last_loss"])
    assert out["detections"][0]["restored_step"] == 0


@pytest.mark.parametrize("mesh", list(SERVE_MESHES))
def test_serve_cli_data_ranks_give_the_one_process_tokens(mesh, mesh_run):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.serve import serve
    outs = [res[f"serve/{mesh}"] for res in mesh_run["ranks"]]
    assert all(o == "" for o in outs[1:])
    out = json.loads(outs[0])
    assert set(out) == {"arch", "device", "prefill_s", "decode_s", "decode_tok_per_s",
                        "sampled_tokens_head", "kernel_launches"}
    want = serve(get_smoke_config("gemma2-2b"), device="cpu", **SERVE)
    assert out["sampled_tokens_head"] == want["sampled_tokens_head"]
    assert len(out["sampled_tokens_head"]) == SERVE["batch"]


# --- the "batch" attention mode -----------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MODE_MESHES))
@pytest.mark.parametrize("arch", MODE_ARCHS)
def test_batch_mode_step_matches_the_jax_gspmd_step(arch, mesh, mesh_run):
    """``attn_activation_sharding`` "auto" (resolved to "batch") at one
    microbatch on (2, 2) and (1, 4): each model rank attends its rows of
    the 4 over every head. Two sharded steps against the JAX GSPMD step
    whose ``_sp_shard`` constrains q, k and v over pod x data x model (the
    constraint is in its HLO): loss and grad norm 1e-5; every parameter
    1e-5 after two steps but for the rare element whose AdamW step divides
    a gradient near eps by its own root (the update's sign from fp32
    noise: at most 1 in 2,000, each within two steps of the learning
    rate, as the int8 test above counts its ties); and against the port's
    one-device step likewise. stablelm-12b's table holds one such element
    (its first gradient 7.6e-9), off with the mode "off" too."""
    ours, ref = mesh_run["ours"], mesh_run["jax"]
    key = f"mode/{mesh}/{arch}"
    assert ref[f"{key}/constraints"] > 0
    names = [k[len(f"{key}/p2/"):] for k in ref if k.startswith(f"{key}/p2/")]
    assert names
    for side, want_of in (("jax", lambda m: ref[f"{key}/{m}"]),
                          ("one device", lambda m: ours[f"{key}/plain/{m}"])):
        for i in range(2):
            for m in ("loss", "grad_norm"):
                np.testing.assert_allclose(ours[f"{key}/{m}/{i}"], want_of(f"{m}/{i}"),
                                           rtol=1e-5, err_msg=f"{side} step {i} {m}")
        off, total = 0, 0
        for n in names:
            got, want = ours[f"{key}/p2/{n}"], want_of(f"p2/{n}")
            assert np.abs(got - want).max() <= 1.5 * TRAIN["learning_rate"] * 2, (side, n)
            off += _off(got, want)
            total += want.size
        assert off <= total / 2000, f"{side}: {off} of {total} elements off 1e-5"


# --- adamw_8bit on the shards --------------------------------------------------------------

@pytest.mark.parametrize("leaf", sorted(Q8_LEAVES))
def test_8bit_update_on_the_shards_equals_the_whole_leaf_update(leaf, mesh_run):
    """A 2-D leaf's 8-bit state placed like the parameter, updated on the
    (2, 2) mesh's shards (``BlockShards``: blocks that span rows, a block
    split between two ranks' columns, whole blocks a rank), gathered: the
    int8 codes and the scales equal to the whole-leaf update's, the
    parameter within 1e-5."""
    ours = mesh_run["ours"]
    got, want = ours[f"q8leaf/{leaf}/p"]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for k in ("mu_q", "mu_s", "nu_q", "nu_s"):
        got, want = ours[f"q8leaf/{leaf}/{k}"]
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert np.abs(ours[f"q8leaf/{leaf}/mu_q"][1]).max() > 64


def test_8bit_step_matches_the_jax_step_under_its_state_placement(mesh_run):
    """gemma2-2b's ``adamw_8bit`` step on the (2, 2) mesh, the tied
    table's 8-bit state on its shards and the norm scales' blocks spanning
    their layers, against the JAX GSPMD step with its state under
    ``opt_state_shardings``: loss and grad norm 1e-5 at both steps, every
    parameter 1e-5 after the first step (it updates from the fp32 moments)
    and after the second but for the rare element whose moment's code
    flipped at a rounding tie (at most 1 in 2,000, as the int8 test counts
    them), and every state tensor as ``_hold_state`` holds it."""
    ours, ref = mesh_run["ours"], mesh_run["jax"]
    for i in range(2):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(ours[f"adamw_8bit/{key}/{i}"], ref[f"q8/{key}/{i}"],
                                       rtol=1e-5, err_msg=f"step {i} {key}")
    names = [k[len("q8/p1/"):] for k in ref if k.startswith("q8/p1/")]
    assert names
    off = total = 0
    for n in names:
        np.testing.assert_allclose(ours[f"adamw_8bit/p1/{n}"], ref[f"q8/p1/{n}"], rtol=1e-5,
                                   atol=1e-5, err_msg=n)
        got, want = ours[f"adamw_8bit/p2/{n}"], ref[f"q8/p2/{n}"]
        off += _off(got, want)
        total += want.size
    assert off <= total / 2000, f"{off} of {total} elements off 1e-5"
    assert _hold_state(ours, ref, "adamw_8bit", "q8") > len(names)


def test_8bit_step_gathers_no_placed_leaf_over_model(mesh_run):
    """One 8-bit step of gemma2-2b on the (2, 2) mesh: the tied table, whose
    8-bit state sits like it, is never gathered whole, nor its state, nor
    its gradient: its update trades codes over data and a block maximum
    (``BlockShards``). The stacked layers' state stays whole and they are
    updated whole, as before."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("gemma2-2b").model
    n_blocks = cfg.vocab_size * cfg.d_model // 256
    whole = ([cfg.vocab_size, cfg.d_model], [cfg.vocab_size // 2, cfg.d_model],
             [n_blocks, 256], [n_blocks // 2, 256])
    for r, res in enumerate(mesh_run["ranks"]):
        sh = res["shapes"]
        over_model = [g for g in sh["q8_gathers"] if g[2] == sh["groups"]["model"]]
        assert over_model, r           # the stacked layers' whole update
        assert not [g for g in over_model if g[0] in whole], (r, over_model)
