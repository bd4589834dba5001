"""The "sequence" attention mode's train step on gloo ranks, against the JAX
package's GSPMD step.

``attn_activation_sharding="sequence"`` at one microbatch: each ``model`` rank
attends its 32 / model query positions, at their global positions, against
every key. One spawn of four gloo ranks (``_dist.run_world``) runs the port's
sharded step on (data 2, model 2) and (data 1, model 4) for smollm-135m (3
heads, which neither model size divides: the weights whole, q projected from
the rank's positions) and stablelm-12b (4 heads with qk-norm: q moved to every
head by an all-to-all; its 2 kv heads split on model 2, whole on model 4),
and zamba2-7b's shared attention block on (2, 2); a JAX child
(``_dist.JaxChild``, 4 forced host devices) jits the JAX package's step on
the same meshes with its ``param_shardings`` and ``batch_specs``,
``shard_activations`` patched to the identity and ``_sp_shard`` running the
real ``_maybe_shard`` (q's sequence over model), so its constraint is in the
HLO. The parameters are carried across from one ``LM.init``. Held, fp32: loss
and grad norm 1e-5 over two steps, every parameter 1e-5 after them (as the
"batch" mode's tests in tests/test_torch_mesh_train.py count the rare AdamW
sign flips), against the JAX step and the port's one-device step; zamba2
against the one-device step; with no mesh, "sequence" equal to "off".
The mode's cases run in files of their own (this one and
tests/test_torch_mesh_seq_serve.py), so that each spawn and JAX child stays
well inside ``_dist``'s time limit under the suite's parallel workers.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import test_torch_mesh_train as mt
from _dist import JaxChild, run_world

HERE = os.path.abspath(__file__)
ARCHS = mt.MODE_ARCHS
MESHES = mt.MODE_MESHES

JAX_SIDE = r"""
import dataclasses
import numpy as np
import jax.numpy as jnp
import repro.models.attention as jax_attention
import repro.models.moe as jax_moe
import repro.models.transformer as jax_transformer
jax_transformer.shard_activations = lambda x: x
real_maybe_shard = jax_moe._maybe_shard
jax_moe._maybe_shard = lambda x, spec: x
real_sp_shard = jax_attention._sp_shard


def sp_shard(q, k, v, mode="sequence"):
    jax_moe._maybe_shard = real_maybe_shard
    try:
        return real_sp_shard(q, k, v, mode)
    finally:
        jax_moe._maybe_shard = lambda x, spec: x


jax_attention._sp_shard = sp_shard
from repro.common.config import ShapeSpec
from repro.configs import get_smoke_config
from repro.models.model import build_model, synthetic_batch
from repro.optim import adamw
from repro.parallel import sharding as shd
from repro.train.steps import make_train_step
from repro_torch.convert import params_from_jax

out = {}
for key, shape in _MESHES_.items():
    mesh = jc.make_mesh(shape, ("data", "model"), axis_types=(jc.AxisType.Auto,) * 2)
    for arch in _ARCHS_:
        run = get_smoke_config(arch)
        run = run.replace(parallel=dataclasses.replace(
            run.parallel, param_dtype="float32", microbatches=1,
            attn_activation_sharding="sequence"), train=dataclasses.replace(run.train, **_TRAIN_))
        model = build_model(run, use_kernel=False)
        assert model.sp_attn == "sequence", model.sp_attn
        np_tree = lambda t: params_from_jax(jax.tree.map(np.asarray, t), run.model)
        with jc.set_mesh(mesh):
            params = model.init(jax.random.key(0))
            shardings = shd.param_shardings(params, mesh)
            params = jax.tree.map(jax.device_put, params, shardings)
            cfg = adamw.OptimizerConfig()
            state = adamw.init_state(cfg, params)
            step = None
            for i in range(2):
                batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
                    run.model, ShapeSpec("t", _LEN_, _ROWS_, "train"), seed=10 + i).items()}
                bsh = shd.to_shardings(shd.batch_specs(batch, mesh), mesh)
                batch = jax.tree.map(jax.device_put, batch, bsh)
                if step is None:
                    step = jax.jit(make_train_step(model, run, cfg, mesh),
                                   in_shardings=(shardings, None, bsh),
                                   out_shardings=(shardings, None, None))
                    text = step.lower(params, state, batch).as_text()
                    out[f"{key}/{arch}/constraints"] = np.asarray(
                        text.count("sharding_constraint"))
                params, state, met = step(params, state, batch)
                for m, v in met.items():
                    out[f"{key}/{arch}/{m}/{i}"] = np.asarray(v)
            out.update({f"{key}/{arch}/p2/{k}": v.numpy() for k, v in np_tree(params).items()})
np.savez(os.path.join(OUT, "steps.npz"), **out)
"""


def seq_run(arch, mode="sequence"):
    run = mt.step_run(arch)
    return run.replace(parallel=dataclasses.replace(run.parallel, microbatches=1,
                                                    attn_activation_sharding=mode))


# --- rank side -----------------------------------------------------------------------

def ranks(rank, world, out, inputs):
    from repro_torch.launch.mesh import make_local_mesh
    saved = {}
    for key, (data, model_size) in MESHES.items():
        mesh = make_local_mesh(data, model_size, device="cpu")
        for arch in ARCHS:
            p0 = {k: torch.from_numpy(v) for k, v in np.load(inputs[arch]).items()}
            res = mt._sharded_steps(seq_run(arch), mesh, p0, 2, with_plain=True)
            saved.update({f"{key}/{arch}/{k}": v for k, v in res.items()})
        if (data, model_size) == (2, 2):
            # zamba2's shared attention block (4 heads on 2) and its Mamba2 layers
            run = seq_run("zamba2-7b")
            res = mt._sharded_steps(run, mesh, mt._port_init(run), 2, with_plain=True)
            saved.update({f"zamba2-7b/{k}": v for k, v in res.items()})
    if rank == 0:
        np.savez(os.path.join(out, "steps.npz"), **saved)


# --- fixtures ------------------------------------------------------------------------------

def _initial_params(tmp):
    """The JAX package's LM.init of each arch, in the port's names."""
    import jax
    import repro.configs as jax_configs
    import repro.models.model as jax_model
    from repro_torch.convert import params_from_jax
    paths = {}
    for arch in ARCHS:
        jrun = jax_configs.get_smoke_config(arch)
        jrun = jrun.replace(parallel=dataclasses.replace(jrun.parallel, param_dtype="float32"))
        params = jax_model.build_model(jrun, use_kernel=False).init(jax.random.key(0))
        state = params_from_jax(jax.tree.map(np.asarray, params), seq_run(arch).model)
        paths[arch] = os.path.join(tmp, f"{arch}.npz")
        np.savez(paths[arch], **{k: v.numpy() for k, v in state.items()})
    return paths


@pytest.fixture(scope="module")
def seq_steps(tmp_path_factory):
    code = JAX_SIDE
    for name, value in (("_MESHES_", MESHES), ("_ARCHS_", ARCHS), ("_TRAIN_", mt.TRAIN),
                        ("_LEN_", mt.SEQ), ("_ROWS_", mt.BATCH)):
        code = code.replace(name, repr(value))
    child = JaxChild(code, tmp_path_factory.mktemp("jax"))
    tmp = tmp_path_factory.mktemp("seq")
    inputs = _initial_params(str(tmp))
    out = run_world(f"{HERE}:ranks", 4, tmp, inputs=inputs)
    ours = dict(np.load(os.path.join(out, "steps.npz")))
    ref = dict(np.load(os.path.join(child.result(), "steps.npz")))
    return ours, ref


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_mode_step_matches_the_jax_gspmd_step(arch, mesh, seq_steps):
    """Two sharded steps under "sequence" against the JAX GSPMD step whose
    ``_sp_shard`` constrains q's positions over model (the constraint is in
    its HLO), and against the port's one-device step: loss and grad norm
    1e-5; every parameter within two learning-rate steps, 1e-5 but for at
    most 1 element in 2,000 (an AdamW update whose sign comes from fp32
    noise on a gradient near eps, as tests/test_torch_mesh_train.py counts
    them)."""
    ours, ref = seq_steps
    key = f"{mesh}/{arch}"
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
            assert np.abs(got - want).max() <= 1.5 * mt.TRAIN["learning_rate"] * 2, (side, n)
            off += mt._off(got, want)
            total += want.size
        assert off <= total / 2000, f"{side}: {off} of {total} elements off 1e-5"


def test_sequence_mode_through_the_shared_block_matches_the_one_device_step(seq_steps):
    """zamba2-7b's shared attention block (applied every 6 layers, 4 heads
    on model 2) and its Mamba2 layers under "sequence" on (2, 2): two
    sharded steps against the one-device step, loss and grad norm 1e-5,
    every parameter 1e-5."""
    ours, _ = seq_steps
    for i in range(2):
        for m in ("loss", "grad_norm"):
            np.testing.assert_allclose(ours[f"zamba2-7b/{m}/{i}"],
                                       ours[f"zamba2-7b/plain/{m}/{i}"], rtol=1e-5,
                                       err_msg=f"step {i} {m}")
    names = [k[len("zamba2-7b/p2/"):] for k in ours if k.startswith("zamba2-7b/p2/")]
    assert any(n.startswith("shared_attn.") for n in names)
    for n in names:
        np.testing.assert_allclose(ours[f"zamba2-7b/p2/{n}"], ours[f"zamba2-7b/plain/p2/{n}"],
                                   rtol=1e-5, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("arch", [*ARCHS, "gemma2-2b", "zamba2-7b"])
def test_sequence_mode_without_a_mesh_equals_off(arch):
    """With no mesh the mode changes nothing, as ``_maybe_shard`` returns
    its input: the train loss and gradients and the prefill's logits and
    cache of "sequence" equal those of "off" (``torch.equal``)."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.models.model import build_model, lm_loss, synthetic_batch
    from repro_torch.train.steps import make_prefill_step
    p0 = mt._port_init(seq_run(arch, "off"))
    got = {}
    for mode in ("off", "sequence"):
        run = seq_run(arch, mode)
        model = build_model(run, device="cpu")
        model.load_state_dict(p0)
        batch = synthetic_batch(run.model, ShapeSpec("t", mt.SEQ, mt.BATCH, "train"), seed=3,
                                device="cpu")
        loss = lm_loss(model, batch)[0]
        loss.backward()
        grads = [p.grad.clone() for p in model.parameters()]
        with torch.no_grad():
            cache = model.init_cache(mt.BATCH, mt.SEQ, dtype=torch.float32)
            logits, cache = make_prefill_step(model)(batch, cache)
        got[mode] = [loss.detach(), *grads, logits,
                     *(t for c in cache if c is not None for t in c)]
    assert len(got["off"]) == len(got["sequence"])
    assert all(torch.equal(a, b) for a, b in zip(got["off"], got["sequence"]))
