"""Sharded serving on a mesh, as the JAX package's dry run places a serve step.

One spawn of four gloo ranks (``_dist.run_world``) runs every multi-rank case
of this file on two meshes, (data 2, model 2) and (data 1, model 4), while a
JAX child (``_dist.JaxChild``, 4 forced host devices) jits the JAX package's
``make_prefill_step`` and ``make_decode_step`` with ``param_specs``,
``batch_specs`` and ``cache_specs`` as ``in_shardings``, as its
``lower_cell`` does (``shard_activations`` / ``_maybe_shard`` patched to the
identity: they pin layouts only). The smoke configs, in fp32: gemma2-2b
(window 16 on alternate layers, soft-caps; 2 kv heads, which model 4 does
not divide), deepseek-v2-236b (MLA, experts over model), llama-3.2-vision-11b
(cross attention, its gates drawn non-zero) and zamba2-7b (Mamba2 states,
the shared attention block). The parameters are the JAX package's
``LM.init``, converted by ``repro_torch.convert`` and cut to each rank's
shards (``parallel.tensor.shard_model``).

Held: a batch of 4, a 36-token prompt and 6 greedy decode steps against a
cache of 64 (its sequence over model: at model 4 the shard of positions
48..63 lies wholly past every decoded position (36..41), and the window's
local layers mask the shard of 0..15 wholly), prefill and decode
logits within 1e-4 of the JAX package's (as tests/test_torch_serve.py) and
the greedy tokens equal; each rank's caches of ``cache_spec``'s local
shapes; the "batch" attention mode's prefill (gemma2-2b, smollm-135m)
against the JAX prefill whose ``_sp_shard`` keeps its own ``_maybe_shard``
(1e-4) and its cache shards equal to the mode-off prefill's; ``serve(..., sharded=True)`` against the one-device ``serve``; the
collectives one sharded prefill issues against the dry run's trace of it.
Without a process group: ``ref.merge_shards`` over
``ref.decode_attention_shard``'s partials against ``ref.decode_attention``
at fp32 1e-6, the refused placements, and the dry run's share of a prefill.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from _dist import JaxChild, run_world

HERE = os.path.abspath(__file__)
ARCHS = ("gemma2-2b", "deepseek-v2-236b", "llama-3.2-vision-11b", "zamba2-7b")
# the "batch" attention mode's prefill: 4 heads (2 kv heads: divided by
# model 2, not by model 4) and 3 heads (divided by neither)
MODE_ARCHS = ("gemma2-2b", "smollm-135m")
MESHES = {"data2_model2": (2, 2), "data1_model4": (1, 4)}
BATCH, PROMPT, STEPS, MAX_LEN = 4, 36, 6, 64
TOL = 1e-4
SERVE = dict(batch=BATCH, prompt_len=PROMPT, decode_steps=STEPS)   # cache 42: 44 at model 4
GATE_SEED = 3


def fp32_run(arch):
    from repro_torch.configs import get_smoke_config
    run = get_smoke_config(arch)
    return run.replace(parallel=dataclasses.replace(run.parallel, param_dtype="float32"))


def mode_run(arch, mode):
    run = fp32_run(arch)
    return run.replace(parallel=dataclasses.replace(run.parallel,
                                                    attn_activation_sharding=mode))


JAX_SIDE = r"""
import numpy as np
import jax.numpy as jnp
import repro.models.moe as jax_moe
import repro.models.transformer as jt
jt.shard_activations = lambda x: x
real_maybe_shard = jax_moe._maybe_shard
jax_moe._maybe_shard = lambda x, spec: x
from repro.common.config import ShapeSpec
from repro.configs import get_smoke_config
from repro.models.model import synthetic_batch
from repro.parallel import sharding as shd
from repro.train.steps import make_decode_step, make_prefill_step


def gated(params):
    rng = np.random.default_rng(GATE_SEED)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.normal(0, 1, a.shape), a.dtype)
        if path[-1].key in ("gate", "ffn_gate") else a, params)


out = {}
for key, shape in MESHES.items():
    mesh = jc.make_mesh(shape, ("data", "model"), axis_types=(jc.AxisType.Auto,) * 2)
    for arch in ARCHS:
        cfg = get_smoke_config(arch).model
        model = jt.LM(cfg, param_dtype=jnp.float32, remat="none", use_kernel=False)
        with jc.set_mesh(mesh):
            params = gated(model.init(jax.random.key(0)))
            pshard = shd.to_shardings(shd.param_specs(params, mesh), mesh)
            params = jax.tree.map(jax.device_put, params, pshard)
            batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
                cfg, ShapeSpec("p", PROMPT, BATCH, "prefill"), seed=1).items()}
            bshard = shd.to_shardings(shd.batch_specs(batch, mesh), mesh)
            batch = jax.tree.map(jax.device_put, batch, bshard)
            cache = model.init_cache(BATCH, MAX_LEN, dtype=jnp.float32)
            cshard = shd.to_shardings(shd.cache_specs(cache, mesh), mesh)
            cache = jax.tree.map(jax.device_put, cache, cshard)
            prefill = jax.jit(make_prefill_step(model), in_shardings=(pshard, bshard, cshard))
            logits, cache = prefill(params, batch, cache)
            out[f"{key}/{arch}/0"] = np.asarray(logits)
            decode = None
            for i in range(STEPS):
                tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
                step = {"tokens": tok[:, None]}
                if "vision_embed" in batch:
                    step["vision_embed"] = batch["vision_embed"]
                sshard = shd.to_shardings(shd.batch_specs(step, mesh), mesh)
                if decode is None:
                    decode = jax.jit(make_decode_step(model),
                                     in_shardings=(pshard, sshard, cshard, None))
                step = jax.tree.map(jax.device_put, step, sshard)
                logits, cache = decode(params, step, cache, jnp.asarray(PROMPT + i, jnp.int32))
                out[f"{key}/{arch}/{i + 1}"] = np.asarray(logits)

# the "batch" mode's prefill: LM(sp_attn="batch"), whose _sp_shard constrains
# q, k and v over pod x data x model with its own _maybe_shard
import repro.models.attention as jax_attention
real_sp_shard = jax_attention._sp_shard


def sp_shard(q, k, v, mode="sequence"):
    jax_moe._maybe_shard = real_maybe_shard
    try:
        return real_sp_shard(q, k, v, mode)
    finally:
        jax_moe._maybe_shard = lambda x, spec: x


jax_attention._sp_shard = sp_shard
for key, shape in MESHES.items():
    mesh = jc.make_mesh(shape, ("data", "model"), axis_types=(jc.AxisType.Auto,) * 2)
    for arch in MODE_ARCHS:
        cfg = get_smoke_config(arch).model
        model = jt.LM(cfg, param_dtype=jnp.float32, remat="none", use_kernel=False,
                      sp_attn="batch")
        with jc.set_mesh(mesh):
            params = gated(model.init(jax.random.key(0)))
            pshard = shd.to_shardings(shd.param_specs(params, mesh), mesh)
            params = jax.tree.map(jax.device_put, params, pshard)
            batch = {k: jnp.asarray(v) for k, v in synthetic_batch(
                cfg, ShapeSpec("p", PROMPT, BATCH, "prefill"), seed=1).items()}
            bshard = shd.to_shardings(shd.batch_specs(batch, mesh), mesh)
            batch = jax.tree.map(jax.device_put, batch, bshard)
            cache = model.init_cache(BATCH, MAX_LEN, dtype=jnp.float32)
            cshard = shd.to_shardings(shd.cache_specs(cache, mesh), mesh)
            cache = jax.tree.map(jax.device_put, cache, cshard)
            prefill = jax.jit(make_prefill_step(model), in_shardings=(pshard, bshard, cshard))
            out[f"mode/{key}/{arch}/constraints"] = np.asarray(
                prefill.lower(params, batch, cache).as_text().count("sharding_constraint"))
            logits, cache = prefill(params, batch, cache)
            out[f"mode/{key}/{arch}/0"] = np.asarray(logits)
np.savez(os.path.join(OUT, "serve.npz"), **out)
"""


# --- rank side -------------------------------------------------------------------------------

class _Collectives:
    """A dispatch mode recording (kind, bytes, group size) of every
    collective: out bytes for an all-gather, the tensor's for an all-reduce."""

    def __new__(cls):
        import torch.distributed as dist
        from torch.utils._python_dispatch import TorchDispatchMode

        class Mode(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.seen = []

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out_ = func(*args, **(kwargs or {}))
                name = func._schema.name
                if name == "_c10d_functional::all_gather_into_tensor":
                    self.seen.append(("all-gather", out_.numel() * out_.element_size(),
                                      args[1]))
                elif name == "_c10d_functional::all_reduce":
                    group = dist.distributed_c10d._resolve_process_group(args[2]).size()
                    self.seen.append(("all-reduce", args[0].numel() * args[0].element_size(),
                                      group))
                elif "c10d" in name and not name.endswith(("wait_tensor",
                                                           "_wrap_tensor_autograd")):
                    self.seen.append((name, 0, 0))
                return out_

        return Mode()


def _greedy(model, batch, cache):
    """Prefill, then STEPS greedy decode steps: each step's logits."""
    from repro_torch.train.steps import make_decode_step, make_prefill_step
    prefill, decode = make_prefill_step(model), make_decode_step(model)
    logits, cache = prefill(batch, cache)
    out = [logits]
    for i in range(STEPS):
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        step = {"tokens": tok[:, None]}
        if "vision_embed" in batch:
            step["vision_embed"] = batch["vision_embed"]
        logits, cache = decode(step, cache, PROMPT + i)
        out.append(logits)
    return out


def ranks(rank, world, out, inputs):
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import build_model, synthetic_batch
    from repro_torch.parallel import sharding as shd
    from repro_torch.parallel import tensor
    from repro_torch.train.steps import batch_coordinate, local_batch, make_prefill_step

    saved, facts = {}, {}
    for key, (data, model_size) in MESHES.items():
        mesh = make_local_mesh(data, model_size, device="cpu")
        row, n_rows = batch_coordinate(mesh)
        for arch in ARCHS:
            run = fp32_run(arch)
            model = build_model(run, device="cpu")
            model.load_state_dict({k: torch.from_numpy(v)
                                   for k, v in np.load(inputs[arch]).items()})
            tensor.shard_model(model, mesh)
            batch = local_batch(synthetic_batch(run.model, ShapeSpec("p", PROMPT, BATCH, "prefill"),
                                                seed=1, device="cpu"), 1, row, n_rows)
            cache = model.init_cache(next(iter(batch.values())).shape[0], MAX_LEN,
                                     dtype=torch.float32)
            shapes = [None if c is None else [list(t.shape) for t in c] for c in cache]
            for i, logits in enumerate(_greedy(model, batch, cache)):
                saved[f"{key}/{arch}/{i}"] = logits.numpy()
            sharded = serve(run, device="cpu", mesh=mesh, sharded=True, **SERVE)
            whole = serve(run, device="cpu", **SERVE)
            facts[f"{key}/{arch}"] = {
                "rows": [row, n_rows], "cache_shapes": shapes,
                "serve_tokens": [sharded["tokens"].tolist(), whole["tokens"].tolist()],
                "serve_logits": float((sharded["prefill_logits"]
                                       - whole["prefill_logits"]).abs().max()),
                "weight_bytes": [sharded["weight_bytes"], whole["weight_bytes"]]}
        if key == "data2_model2":
            # the collectives of one sharded prefill, as the dry run traces it
            for arch in ("gemma2-2b", "deepseek-v2-236b"):
                run = fp32_run(arch)
                model = build_model(run, device="cpu")
                model.load_state_dict({k: torch.from_numpy(v)
                                       for k, v in np.load(inputs[arch]).items()})
                tensor.shard_model(model, mesh)
                batch = local_batch(synthetic_batch(
                    run.model, ShapeSpec("p", PROMPT, BATCH, "prefill"), seed=1, device="cpu"),
                    1, row, n_rows)
                cache = model.init_cache(BATCH // n_rows, shd.serve_cache_len(PROMPT, mesh),
                                         dtype=torch.float32)
                mode = _Collectives()
                with mode:
                    make_prefill_step(model)(batch, cache)
                seen = rl.CollectiveStats()
                for kind, nbytes, group in mode.seen:
                    if group > 1:
                        seen.add(kind, nbytes, group)
                facts[f"collectives/{arch}"] = {
                    "seen": [seen.counts, seen.raw_bytes, seen.wire_bytes],
                    "unknown": [s for s in mode.seen if s[2] == 0]}
    # the "batch" mode's sharded prefill, beside the same prefill with the mode off
    for key, (data, model_size) in MESHES.items():
        mesh = make_local_mesh(data, model_size, device="cpu")
        row, n_rows = batch_coordinate(mesh)
        for arch in MODE_ARCHS:
            caches = {}
            for mode in ("batch", "off"):
                run = mode_run(arch, mode)
                model = build_model(run, device="cpu")
                model.load_state_dict({k: torch.from_numpy(v)
                                       for k, v in np.load(inputs[arch]).items()})
                tensor.shard_model(model, mesh)
                batch = local_batch(synthetic_batch(
                    run.model, ShapeSpec("p", PROMPT, BATCH, "prefill"), seed=1, device="cpu"),
                    1, row, n_rows)
                cache = model.init_cache(BATCH // n_rows, MAX_LEN, dtype=torch.float32)
                logits, cache = make_prefill_step(model)(batch, cache)
                saved[f"mode/{key}/{arch}/{mode}"] = logits.numpy()
                caches[mode] = [t for c in cache for t in c]
                caches[f"split/{mode}"] = model.blocks[0].attn.rows_split(BATCH // n_rows)
            facts[f"mode/{key}/{arch}"] = {
                "rows": [row, n_rows],
                "cache_equal": all(torch.equal(a, b) for a, b in zip(caches["batch"],
                                                                     caches["off"])),
                "split": [caches["split/batch"], caches["split/off"]]}
    np.savez(os.path.join(out, f"rank{rank}.npz"), **saved)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(facts, f)


# --- fixtures --------------------------------------------------------------------------------

def _jax_params(tmp):
    """The JAX package's LM.init of each smoke config (key 0, gates drawn
    from N(0, 1) at GATE_SEED, as the JAX child draws them), in the port's
    names."""
    import jax
    import jax.numpy as jnp
    import repro.models.transformer as jt
    from repro.configs import get_smoke_config
    from repro_torch.convert import params_from_jax
    paths = {}
    for arch in dict.fromkeys((*ARCHS, *MODE_ARCHS)):
        cfg = get_smoke_config(arch).model
        params = jt.LM(cfg, param_dtype=jnp.float32, remat="none",
                       use_kernel=False).init(jax.random.key(0))
        rng = np.random.default_rng(GATE_SEED)
        params = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(rng.normal(0, 1, a.shape), a.dtype)
            if path[-1].key in ("gate", "ffn_gate") else a, params)
        state = params_from_jax(jax.tree.map(np.asarray, params), fp32_run(arch).model)
        paths[arch] = os.path.join(tmp, f"{arch}.npz")
        np.savez(paths[arch], **{k: v.numpy() for k, v in state.items()})
    return paths


@pytest.fixture(scope="module")
def mesh_serve(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    code = JAX_SIDE
    for name, value in (("MODE_ARCHS", MODE_ARCHS), ("ARCHS", ARCHS), ("MESHES", MESHES),
                        ("GATE_SEED", GATE_SEED),
                        ("BATCH", BATCH), ("PROMPT", PROMPT), ("STEPS", STEPS),
                        ("MAX_LEN", MAX_LEN)):
        code = code.replace(name, repr(value))
    child = JaxChild(code, tmp_path_factory.mktemp("jax"))
    inputs = _jax_params(str(tmp))
    out = run_world(f"{HERE}:ranks", 4, tmp, inputs=inputs)
    ranks_out = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            facts = json.load(f)
        ranks_out.append((dict(np.load(os.path.join(out, f"rank{r}.npz"))), facts))
    jax_out = dict(np.load(os.path.join(child.result(), "serve.npz")))
    return dict(ranks=ranks_out, jax=jax_out)


CASES = [(key, arch) for key in MESHES for arch in ARCHS]


# --- the sharded serve step against the JAX package's GSPMD serve step -----------------------

@pytest.mark.parametrize("key, arch", CASES)
def test_sharded_serve_matches_the_jax_gspmd_serve(key, arch, mesh_serve):
    """Every rank's rows: the prefill logits and each decode step's within
    1e-4 of the JAX package's, and the greedy tokens equal (each side
    follows its own tokens). The ranks along model hold the same rows and
    the same logits."""
    ref = mesh_serve["jax"]
    for saved, facts in mesh_serve["ranks"]:
        row, n_rows = facts[f"{key}/{arch}"]["rows"]
        share = BATCH // n_rows
        rows = slice(row * share, (row + 1) * share)
        for i in range(STEPS + 1):
            got, want = saved[f"{key}/{arch}/{i}"], ref[f"{key}/{arch}/{i}"][rows]
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=f"step {i}")
            np.testing.assert_array_equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1),
                                          err_msg=f"step {i}")


@pytest.mark.parametrize("key, arch", CASES)
def test_each_rank_holds_its_cache_spec_shard(key, arch, mesh_serve):
    """Every cache tensor of every rank has ``cache_spec``'s local shape of
    the whole cache (global batch, MAX_LEN): its rows over data, the
    sequence (or a recurrent state's dim) over model."""
    from repro_torch.models.model import build_model
    from repro_torch.parallel import sharding as shd
    sizes = dict(zip(("data", "model"), MESHES[key]))
    whole = build_model(fp32_run(arch), device="meta").init_cache(BATCH, MAX_LEN,
                                                                   dtype=torch.float32)
    want = [None if c is None else [list(shd.local_shape(t.shape, shd.cache_spec(t.shape, sizes),
                                                         sizes)) for t in c] for c in whole]
    cut = sum(1 for c in whole if c is not None for t in c
              if "model" in shd.cache_spec(t.shape, sizes))
    assert cut >= 2
    for _, facts in mesh_serve["ranks"]:
        assert facts[f"{key}/{arch}"]["cache_shapes"] == want


@pytest.mark.parametrize("key, arch", CASES)
def test_sharded_serve_equals_the_one_device_serve(key, arch, mesh_serve):
    """``serve(..., mesh, sharded=True)`` (its weights drawn on the shards)
    against ``serve`` on one device from the same seed: the same tokens,
    prefill logits within 1e-5, and a quarter of the weights' bytes or more
    held but less than all of them."""
    for _, facts in mesh_serve["ranks"]:
        f = facts[f"{key}/{arch}"]
        assert f["serve_tokens"][0] == f["serve_tokens"][1]
        assert f["serve_logits"] <= 1e-5
        held, whole = f["weight_bytes"]
        assert whole / 4 <= held < whole


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-236b"])
def test_collectives_of_a_sharded_prefill_equal_the_dry_runs(arch, mesh_serve):
    """The collectives one sharded prefill issues on the (2, 2) mesh equal
    those of the dry run's trace of the same cell (``collectives_of``): the
    layers' all-reduces over model, the gathers of the new keys and of the
    vocab shards' logits."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    want = dr.collectives_of(fp32_run(arch), ShapeSpec("p", PROMPT, BATCH, "prefill"),
                             {"data": 2, "model": 2})
    assert want.counts["all-gather"] > 0 and want.counts["all-reduce"] > 0
    for _, facts in mesh_serve["ranks"]:
        got = facts[f"collectives/{arch}"]
        assert not got["unknown"]
        counts, raw, wire = got["seen"]
        assert counts == want.counts and raw.keys() == want.raw_bytes.keys()
        for kind, nbytes in want.raw_bytes.items():
            assert raw[kind] == pytest.approx(nbytes, rel=1e-9), kind
        assert wire == pytest.approx(want.wire_bytes, rel=1e-9)


@pytest.mark.parametrize("key", list(MESHES))
@pytest.mark.parametrize("arch", MODE_ARCHS)
def test_batch_mode_prefill_matches_the_jax_gspmd_prefill(key, arch, mesh_serve):
    """``attn_activation_sharding`` "batch": each model rank runs the flash
    path on its rows of the rank's 2 (2, 2) or 4 (1, 4) rows over every
    head (gemma2-2b's heads split, its kv heads on model 2 only;
    smollm-135m's 3 heads whole). Every rank's last-position logits within
    1e-4 of the JAX GSPMD prefill whose ``_sp_shard`` constrains q, k and v
    (the constraint in its HLO), and within 1e-5 of the mode-off prefill's;
    the cache shards the new k/v were written into equal to the mode-off
    prefill's."""
    ref = mesh_serve["jax"]
    assert ref[f"mode/{key}/{arch}/constraints"] > 0
    for saved, facts in mesh_serve["ranks"]:
        f = facts[f"mode/{key}/{arch}"]
        row, n_rows = f["rows"]
        share = BATCH // n_rows
        got = saved[f"mode/{key}/{arch}/batch"]
        want = ref[f"mode/{key}/{arch}/0"][row * share:(row + 1) * share]
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got, saved[f"mode/{key}/{arch}/off"], atol=1e-5, rtol=1e-5)
        assert f["split"] == [True, False] and f["cache_equal"]


# --- the plain versions, no process group ----------------------------------------------------

# (batch, cache, heads, kv heads, head_dim, pos, window, cap, shards)
MERGE_CASES = [
    (2, 50, 6, 2, 16, 49, 0, 0.0, 1),
    (2, 50, 6, 2, 16, 30, 8, 50.0, 3),       # shards past pos and before the window
    (1, 64, 4, 4, 32, 10, 0, 0.0, 8),        # six of eight shards past pos
    (2, 77, 8, 2, 16, 70, 12, 30.0, 5),      # a soft-cap, the window in the last two
    (3, 40, 9, 3, 8, 39, 40, 0.0, 7),        # uneven shards
    (1, 16, 2, 1, 16, 0, 0, 0.0, 2),         # one valid key
]


@pytest.mark.parametrize("case", MERGE_CASES)
def test_merged_shards_equal_the_whole_cache_decode(case):
    """The cache cut into shards (the last ones longer where the cut is
    uneven), each shard's (out, lse) from ``decode_attention_shard`` at its
    offset, merged by ``merge_shards``: ``decode_attention`` of the whole
    cache at fp32 1e-6. Through the wrapper's CPU path too."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    b, s, h, hkv, d, pos, window, cap, n = case
    g = torch.Generator().manual_seed(sum(case[:6]))
    q = torch.randn(b, 1, h, d, generator=g)
    k = torch.randn(b, s, hkv, d, generator=g)
    v = torch.randn(b, s, hkv, d, generator=g)
    kw = dict(window=window, logit_cap=cap, scale=d ** -0.5)
    want = ref.decode_attention(q, k, v, pos, **kw)
    cuts = [i * s // n for i in range(n + 1)]
    parts = [ref.decode_attention_shard(q, k[:, a:c], v[:, a:c], pos, k0=a, **kw)
             for a, c in zip(cuts, cuts[1:])]
    np.testing.assert_allclose(ref.merge_shards(*zip(*parts)).numpy(), want.numpy(),
                               atol=1e-6, rtol=1e-6)
    wrapped = [da.decode_attention_fwd(q, k[:, a:c].contiguous(), v[:, a:c].contiguous(), pos,
                                       k0=a, return_lse=True, **kw)
               for a, c in zip(cuts, cuts[1:])]
    for (o, l), (wo, wl) in zip(parts, wrapped):
        assert torch.equal(o, wo) and torch.equal(l, wl)
    lo = max(0, pos - window + 1) if window else 0
    empty = [i for i, (a, c) in enumerate(zip(cuts, cuts[1:])) if a > pos or c <= lo]
    for i in empty:
        o, l = parts[i]
        assert torch.equal(o, torch.zeros_like(o)) and bool((l == ref.NEG_INF).all())
    if n == 8:
        assert len(empty) == 6


def test_an_empty_shard_weighs_nothing_and_holds_no_nan():
    """A shard wholly past pos and one wholly before the window's first key
    give out 0 and lse NEG_INF, finite; merging them with the shard that
    holds the keys gives that shard's output."""
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(5)
    q = torch.randn(2, 1, 4, 16, generator=g)
    k, v = torch.randn(2, 48, 2, 16, generator=g), torch.randn(2, 48, 2, 16, generator=g)
    kw = dict(window=8, logit_cap=50.0, scale=0.25)
    before = ref.decode_attention_shard(q, k[:, :16], v[:, :16], 30, k0=0, **kw)
    inside = ref.decode_attention_shard(q, k[:, 16:32], v[:, 16:32], 30, k0=16, **kw)
    past = ref.decode_attention_shard(q, k[:, 32:], v[:, 32:], 30, k0=32, **kw)
    for o, l in (before, past):
        assert torch.isfinite(o).all() and not o.any() and bool((l == ref.NEG_INF).all())
    assert torch.isfinite(inside[1]).all() and bool((inside[1] > ref.NEG_INF).all())
    merged = ref.merge_shards(*zip(before, inside, past))
    assert torch.isfinite(merged).all()
    np.testing.assert_allclose(merged.numpy(), inside[0].numpy(), atol=1e-6, rtol=1e-6)


def test_shard_outputs_are_float32_and_the_merge_rounds_once():
    """bf16 inputs: each shard's (out, lse) is float32 (the wrapper's CPU
    path as the plain version), and the merged output, rounded once to
    bf16, is within one bf16 rounding of the whole cache's fp32 output,
    where a merge of outputs each rounded to bf16 first would round twice."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ref
    g = torch.Generator().manual_seed(11)
    q = torch.randn(2, 1, 8, 32, generator=g).bfloat16()
    k, v = (torch.randn(2, 64, 2, 32, generator=g).bfloat16() for _ in range(2))
    kw = dict(window=40, logit_cap=50.0, scale=32 ** -0.5)
    parts = [da.decode_attention_fwd(q, k[:, a:a + 16].contiguous(), v[:, a:a + 16].contiguous(),
                                     50, k0=a, return_lse=True, **kw) for a in range(0, 64, 16)]
    assert all(o.dtype == torch.float32 and l.dtype == torch.float32 for o, l in parts)
    merged = ref.merge_shards(*zip(*parts))
    assert merged.dtype == torch.float32
    exact = ref.decode_attention(q.float(), k.float(), v.float(), 50, **kw)
    np.testing.assert_allclose(merged.numpy(), exact.numpy(), atol=1e-6, rtol=1e-5)
    want = ref.decode_attention(q, k, v, 50, **kw)
    assert torch.equal(merged.bfloat16(), want)


def test_shard_mode_arguments_are_checked():
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    q, k = torch.zeros(1, 1, 2, 8), torch.zeros(1, 16, 1, 8)
    with pytest.raises(ValueError, match="return_lse"):
        decode_attention_fwd(q, k, k, 3, k0=16, scale=1.0)
    with pytest.raises(ValueError, match="outside"):
        decode_attention_fwd(q, k, k, 16, scale=1.0)
    with pytest.raises(ValueError, match="outside"):
        decode_attention_fwd(q, k, k, -1, k0=16, return_lse=True, scale=1.0)
    out, lse = decode_attention_fwd(q, k, k, 40, k0=16, return_lse=True, scale=1.0)
    assert out.shape == q.shape and lse.shape == (1, 2)


def test_serve_cache_len_puts_model_on_the_sequence():
    from repro_torch.parallel import sharding as shd
    sizes = {"data": 1, "model": 4}
    assert shd.serve_cache_len(42, sizes) == 44 and shd.serve_cache_len(64, sizes) == 64
    assert shd.cache_spec((2, 42, 2, 16), sizes) == (None, None, None, "model")
    assert shd.cache_spec((2, 44, 2, 16), sizes) == (None, "model", None, None)


def test_a_cache_placement_off_the_sequence_is_refused():
    """On a mesh whose model size does not divide the cache length, the
    head_dim of a KV cache (or MLA's latent width) takes model under
    ``cache_spec``: ``init_cache`` refuses it, naming the shape; so is an
    attention cache whose kv heads take model (as long as its sequence)."""
    from repro_torch.launch import dryrun as dr
    from repro_torch.models.model import build_model
    from repro_torch.parallel import tensor
    for arch, shape in (("gemma2-2b", r"\(2, 42, 2, 16\)"), ("deepseek-v2-236b", r"\(2, 42, 32\)")):
        with dr.fake_world({"data": 1, "model": 4}) as mesh:
            model = build_model(fp32_run(arch), device="meta")
            tensor.shard_model(model, mesh)
            with pytest.raises(ValueError, match=shape):
                model.init_cache(2, 42, dtype=torch.float32)
            assert model.init_cache(2, 44, dtype=torch.float32)[0][0].shape[1] == 11
            with pytest.raises(ValueError, match=r"\(2, 8, 8, 4\)"):   # the kv heads'
                model.tp.cache_dim((2, 8, 8, 4), allowed=(1,))


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-236b"])
def test_a_ranks_sharded_prefill_traces_a_quarter_of_the_one_device_flops(arch):
    """The dry run's prefill cell on a (data 2, model 2) mesh traces the last
    rank's share of the sharded serve step: half the batch on half the
    heads, FFN columns, experts and vocab, between 0.2 and 0.35 of the
    one-device step's FLOPs (ideal 0.25; MLA's latents and the routing are
    whole); its collectives are those its trace issued."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    run = fp32_run(arch)
    shape = ShapeSpec("p", PROMPT, BATCH, "prefill")
    one = dr.trace_cell(run, shape, {"data": 1, "model": 1})
    rank = dr.trace_cell(run, shape, {"data": 2, "model": 2})
    assert 0.2 * one.flops <= rank.flops <= 0.35 * one.flops
    assert not one.coll.counts and rank.coll.counts["all-reduce"] >= run.model.n_layers
    assert rank.gathered_bytes > 0
