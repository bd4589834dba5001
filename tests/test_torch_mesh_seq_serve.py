"""The "sequence" attention mode's sharded prefill on gloo ranks, against the
JAX package's GSPMD prefill.

One spawn of four gloo ranks (``_dist.run_world``) runs, on (data 2, model 2)
and (data 1, model 4), the port's sharded prefill of a batch of 4 and a
36-token prompt under ``attn_activation_sharding`` "sequence" and "off":
gemma2-2b (window 16 on alternate layers, soft-caps; 4 heads split over
model and moved by all-to-all, its 2 kv heads split on model 2 only) and
smollm-135m (3 heads, whole on every rank: q projected from the rank's
positions). Each model rank runs the flash path on its 36 / model query
positions at their global offset against all 36 keys. A JAX child
(``_dist.JaxChild``) jits the JAX package's ``make_prefill_step`` of
``LM(sp_attn="sequence")`` with ``param_specs``, ``batch_specs`` and
``cache_specs``, ``_sp_shard`` running the real ``_maybe_shard``. The
parameters are the JAX package's ``LM.init`` (key 0), converted by
``repro_torch.convert``. Held, fp32: every rank's last-position logits within
1e-4 of the JAX prefill's and 1e-5 of the mode-off prefill's, the cache
shards equal to the mode-off prefill's.
"""
import json
import os

import numpy as np
import pytest
import torch

import test_torch_mesh_serve as ms
from _dist import JaxChild, run_world

HERE = os.path.abspath(__file__)
ARCHS = ms.MODE_ARCHS
MESHES = ms.MESHES

JAX_SIDE = r"""
import numpy as np
import jax.numpy as jnp
import repro.models.attention as jax_attention
import repro.models.moe as jax_moe
import repro.models.transformer as jt
jt.shard_activations = lambda x: x
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
from repro.models.model import synthetic_batch
from repro.parallel import sharding as shd
from repro.train.steps import make_prefill_step

out = {}
for key, shape in _MESHES_.items():
    mesh = jc.make_mesh(shape, ("data", "model"), axis_types=(jc.AxisType.Auto,) * 2)
    for arch in _ARCHS_:
        cfg = get_smoke_config(arch).model
        model = jt.LM(cfg, param_dtype=jnp.float32, remat="none", use_kernel=False,
                      sp_attn="sequence")
        with jc.set_mesh(mesh):
            params = model.init(jax.random.key(0))
            pshard = shd.to_shardings(shd.param_specs(params, mesh), mesh)
            params = jax.tree.map(jax.device_put, params, pshard)
            batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
                cfg, ShapeSpec("p", _PROMPT_, _ROWS_, "prefill"), seed=1).items()}
            bshard = shd.to_shardings(shd.batch_specs(batch, mesh), mesh)
            batch = jax.tree.map(jax.device_put, batch, bshard)
            cache = model.init_cache(_ROWS_, _MAX_LEN_, dtype=jnp.float32)
            cshard = shd.to_shardings(shd.cache_specs(cache, mesh), mesh)
            cache = jax.tree.map(jax.device_put, cache, cshard)
            prefill = jax.jit(make_prefill_step(model), in_shardings=(pshard, bshard, cshard))
            out[f"{key}/{arch}/constraints"] = np.asarray(
                prefill.lower(params, batch, cache).as_text().count("sharding_constraint"))
            logits, cache = prefill(params, batch, cache)
            out[f"{key}/{arch}"] = np.asarray(logits)
np.savez(os.path.join(OUT, "serve.npz"), **out)
"""


# --- rank side -------------------------------------------------------------------------------

def ranks(rank, world, out, inputs):
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import build_model, synthetic_batch
    from repro_torch.parallel import tensor
    from repro_torch.train.steps import batch_coordinate, local_batch, make_prefill_step

    saved, facts = {}, {}
    for key, (data, model_size) in MESHES.items():
        mesh = make_local_mesh(data, model_size, device="cpu")
        row, n_rows = batch_coordinate(mesh)
        for arch in ARCHS:
            caches, split = {}, {}
            for mode in ("sequence", "off"):
                run = ms.mode_run(arch, mode)
                model = build_model(run, device="cpu")
                model.load_state_dict({k: torch.from_numpy(v)
                                       for k, v in np.load(inputs[arch]).items()})
                tensor.shard_model(model, mesh)
                batch = local_batch(synthetic_batch(
                    run.model, ShapeSpec("p", ms.PROMPT, ms.BATCH, "prefill"), seed=1,
                    device="cpu"), 1, row, n_rows)
                cache = model.init_cache(ms.BATCH // n_rows, ms.MAX_LEN, dtype=torch.float32)
                logits, cache = make_prefill_step(model)(batch, cache)
                saved[f"{key}/{arch}/{mode}"] = logits.numpy()
                caches[mode] = [t for c in cache for t in c]
                split[mode] = model.blocks[0].attn.seq_split(ms.PROMPT)
            facts[f"{key}/{arch}"] = {
                "rows": [row, n_rows], "split": [split["sequence"], split["off"]],
                "cache_equal": all(torch.equal(a, b) for a, b in zip(caches["sequence"],
                                                                     caches["off"]))}
    np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(facts, f)


# --- fixtures --------------------------------------------------------------------------------

def _jax_params(tmp):
    """The JAX package's LM.init of each arch (key 0), in the port's names."""
    import jax
    import jax.numpy as jnp
    import repro.models.transformer as jt
    from repro.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    paths = {}
    for arch in ARCHS:
        cfg = get_smoke_config(arch).model
        params = jt.LM(cfg, param_dtype=jnp.float32, remat="none",
                       use_kernel=False).init(jax.random.key(0))
        state = params_from_jax(jax.tree.map(np.asarray, params), ms.fp32_run(arch).model)
        paths[arch] = os.path.join(tmp, f"{arch}.npz")
        np.savez(paths[arch], **{k: v.numpy() for k, v in state.items()})
    return paths


@pytest.fixture(scope="module")
def seq_serve(tmp_path_factory):
    code = JAX_SIDE
    for name, value in (("_MESHES_", MESHES), ("_ARCHS_", ARCHS), ("_PROMPT_", ms.PROMPT),
                        ("_ROWS_", ms.BATCH), ("_MAX_LEN_", ms.MAX_LEN)):
        code = code.replace(name, repr(value))
    child = JaxChild(code, tmp_path_factory.mktemp("jax"))
    tmp = tmp_path_factory.mktemp("serve")
    inputs = _jax_params(str(tmp))
    out = run_world(f"{HERE}:ranks", 4, tmp, inputs=inputs)
    ranks_out = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks_out.append((dict(np.load(os.path.join(out, f"rank{r}.npz"))), json.load(f)))
    return ranks_out, dict(np.load(os.path.join(child.result(), "serve.npz")))


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sequence_mode_prefill_matches_the_jax_gspmd_prefill(key, arch, seq_serve):
    """``attn_activation_sharding`` "sequence": each model rank runs the
    flash path on its 36 / model query positions at their global offset
    (gemma2-2b's window and soft-caps at global positions). Every rank's
    last-position logits within 1e-4 of the JAX GSPMD prefill whose
    ``_sp_shard`` constrains q's positions over model (the constraint in
    its HLO), and within 1e-5 of the mode-off prefill's; the mode applies
    (36 divides 2 and 4) and the cache shards equal the mode-off prefill's."""
    ranks_out, ref = seq_serve
    assert ref[f"{key}/{arch}/constraints"] > 0
    for saved, facts in ranks_out:
        f = facts[f"{key}/{arch}"]
        row, n_rows = f["rows"]
        share = ms.BATCH // n_rows
        got = saved[f"{key}/{arch}/sequence"]
        want = ref[f"{key}/{arch}"][row * share:(row + 1) * share]
        np.testing.assert_allclose(got, want, atol=ms.TOL, rtol=ms.TOL)
        np.testing.assert_allclose(got, saved[f"{key}/{arch}/off"], atol=1e-5, rtol=1e-5)
        assert f["split"] == [True, False] and f["cache_equal"]
