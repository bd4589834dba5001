"""``repro_torch.parallel`` against ``repro.parallel``, on the CPU.

One JAX child (4 forced host devices, ``_dist.JaxChild``) computes the
reference side: int8 quantisation of every case, ``_ring_allreduce_int8_local``
at 2, 3 and 4 devices, ``_hier_allreduce_local`` on (pod 2, data 2), plain
and with the int8 slow axis, ``pipeline_forward`` at 2 and 4 stages, the
sharding specs of all ten full configs, and ``opt_state_shardings`` over
``adamw.init_state``'s tree for ``adamw_factored`` and ``adamw_8bit`` on the
same meshes. The port runs the collectives on
gloo ranks spawned once a world size (``_dist.run_world``) while the child
runs.

Tolerances: quantisation bit-equal (fp32 and bf16 leaves, an all-zero leaf at
the 1e-12 floor, exact .5 ties). The ring, and the hierarchical reduction
with it, are held per element to one quantisation step of the ring's hops
(the largest |partial sum| / 127), and the test reports how many elements
differ and by how much: XLA's CPU compiler fuses a hop's dequantise-and-add,
acc + q * scale, into one FMA (one rounding), where the port rounds the
product and the sum apart, so about one element in seven differs by an ulp
(2.4e-7 at world 2), and a later requantisation can turn an ulp into a
step. The plain hierarchical reduction sums two values an axis, so it is
bit-equal. The pipeline 1e-6 (fp32 matmuls in two libraries). Specs equal,
entry for entry, with the JAX leaf's units dim dropped; the optimizer
state's too, each state tensor against the JAX one it is a layer's row of or
holds whole.
"""
import json
import os

import numpy as np
import pytest
import torch

from _dist import JaxChild, run_world

HERE = os.path.abspath(__file__)
ARCHS = ["gemma2-2b", "smollm-135m", "yi-34b", "stablelm-12b", "musicgen-medium",
         "arctic-480b", "deepseek-v2-236b", "llama-3.2-vision-11b", "zamba2-7b", "xlstm-125m"]
MESHES = {"1pod": {"data": 16, "model": 16}, "2pod": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}
# the param_specs options on the 2-pod mesh
VARIANTS = {"fsdp_over_pod": dict(fsdp_over_pod=True), "attn_zero": dict(attn_zero=True),
            "moe_zero": dict(moe_zero=True)}
RING_WORLDS = [2, 3, 4]
RING_SHAPE = (5, 67)           # 335 elements: padded at every world size
STAGES = [2, 4]
N_MICRO, MB, D = 6, 2, 8
OPT_KINDS = ("adamw_factored", "adamw_8bit")
# the unstacked parameters whose 8-bit blocks take their spec: the JAX
# package's 2-D leaves that are not stacked on a units dim (the embedding, an
# untied head, zamba2's shared attention block, applied every 6 layers); of
# the stacked ones, a stack of vectors is 2-D and its blocks take its spec
# where an axis splits it (zamba2's per-head vectors and conv bias)
BLOCKS_SHARDED = {"embed.table", "head", *(f"shared_attn.attn.w{x}" for x in "qkvo"),
                  *(f"shared_attn.mlp.{w}" for w in ("wi_gate", "wi_up", "wo"))}


def quant_cases():
    """name -> (array, dtype name); bf16 as float32 values exactly
    representable in bf16."""
    rng = np.random.default_rng(0)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, 127.0, 3.0, 0.0], np.float32)
    bf = rng.normal(0, 3, (48, 40)).astype(np.float32)
    bf = (bf.view(np.uint32) & 0xFFFF0000).view(np.float32)
    return {
        "f32": (rng.normal(0, 1, (64, 33)).astype(np.float32), "float32"),
        "bf16": (bf, "bfloat16"),
        "zeros": (np.zeros((16, 3), np.float32), "float32"),
        "below_floor": (np.array([1e-13, -3e-14, 0.0, 5e-14], np.float32), "float32"),
        "ties_scale1": (ties, "float32"),
        "ties_scale2": (ties * 2, "float32"),        # amax 254: x / 2 ties at 0.5 steps
        "ties_bf16": (ties, "bfloat16"),
    }


def ring_input(world):
    return np.random.default_rng(10 + world).normal(0, 1, (world,) + RING_SHAPE).astype(np.float32)


def hier_inputs():
    rng = np.random.default_rng(1)
    return {"plain": rng.normal(0, 1, (4, 5, 7)).astype(np.float32),
            "int8": rng.normal(0, 1, (4, 33)).astype(np.float32)}


def pipe_inputs(n_stages):
    rng = np.random.default_rng(20 + n_stages)
    return (rng.normal(0, 0.5, (n_stages, D, D)).astype(np.float32),
            rng.normal(0, 0.1, (n_stages, D)).astype(np.float32),
            rng.normal(0, 1, (N_MICRO, MB, D)).astype(np.float32))


JAX_SIDE = r"""
import functools, importlib.util, json
import numpy as np
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
spec = importlib.util.spec_from_file_location("t", HERE)
t = importlib.util.module_from_spec(spec); spec.loader.exec_module(t)
from repro.parallel.compression import quantize_int8, dequantize_int8, _ring_allreduce_int8_local
from repro.parallel.collectives import _hier_allreduce_local
from repro.parallel.pipeline import pipeline_forward
from repro.parallel import sharding as shd
from repro.configs import get_config
from repro.launch.dryrun import opt_state_shardings
from repro.optim import adamw
from jax.sharding import AbstractMesh, NamedSharding
from repro.models.model import batch_shapes
from repro.models.transformer import LM
from repro.common.config import ShapeSpec
import repro_torch.convert as convert

out = {}
for name, (x, dt) in t.quant_cases().items():
    q, s = quantize_int8(jnp.asarray(x, dt))
    out[f"q/{name}"], out[f"s/{name}"] = np.asarray(q), np.asarray(s)
    out[f"deq/{name}"] = np.asarray(dequantize_int8(q, s))
    out[f"rt/{name}"] = np.asarray(dequantize_int8(q, s).astype(dt)).astype(np.float32)

def smap(fn, mesh, spec):
    return jax.jit(jc.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec, check_vma=False))

for n in t.RING_WORLDS:
    mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
    fn = smap(functools.partial(_ring_allreduce_int8_local, axis_name="pod"), mesh, P("pod"))
    with jc.set_mesh(mesh):
        out[f"ring/{n}"] = np.asarray(fn(jnp.asarray(t.ring_input(n))))

mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("pod", "data"))
for key, x in t.hier_inputs().items():
    fn = smap(functools.partial(_hier_allreduce_local, fast_axis="data", slow_axis="pod",
                                compress_slow=key == "int8"), mesh, P(("pod", "data")))
    with jc.set_mesh(mesh):
        out[f"hier/{key}"] = np.asarray(fn(jnp.asarray(x)))

def stage_fn(params, x):
    w, c = params
    return jnp.tanh(x @ w + c)

for n in t.STAGES:
    mesh = Mesh(np.array(jax.devices()[:n]), ("pod",))
    ws, bs, mbs = t.pipe_inputs(n)
    with jc.set_mesh(mesh):
        out[f"pipe/{n}"] = np.asarray(jax.jit(
            lambda p, m: pipeline_forward(stage_fn, p, m, mesh))((ws, bs), mbs))
np.savez(os.path.join(OUT, "ref.npz"), **out)

class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape); self.axis_names = tuple(shape)

def entry(e):
    return list(e) if isinstance(e, tuple) else e

def full(spec, nd):
    s = [entry(e) for e in tuple(spec)]
    return s + [None] * (nd - len(s))

meshes = {k: FakeMesh(v) for k, v in t.MESHES.items()}
specs = {}
for arch in t.ARCHS:
    run = get_config(arch)
    model = LM(run.model, param_dtype=jnp.bfloat16)
    abstract = jax.eval_shape(model.init, jax.random.key(0))
    paths = jax.tree_util.tree_flatten_with_path(abstract)[0]
    # markers: leaf id * 1000 + unit, carried to the port's names by convert
    ids = {}
    def mark(path, leaf):
        key = shd._path_str(path)
        ids[key] = len(ids)
        stacked = "unit" in key.split("/")
        return (np.arange(leaf.shape[0]) if stacked else np.array(0)) + 1000 * ids[key]
    marks = jax.tree_util.tree_map_with_path(mark, abstract)
    port = {n: int(np.asarray(v).reshape(-1)[0]) for n, v in
            convert.params_from_jax(jax.tree.map(np.asarray, marks), run.model).items()}
    by_id = {i: k for k, i in ids.items()}
    leaf = {shd._path_str(p): l for p, l in paths}
    per = {}
    tables = {m: shd.param_specs(abstract, mesh) for m, mesh in meshes.items()}
    tables.update({v: shd.param_specs(abstract, meshes["2pod"], **kw)
                   for v, kw in t.VARIANTS.items()})
    flat = {m: {shd._path_str(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        tab, is_leaf=lambda x: isinstance(x, P))[0]} for m, tab in tables.items()}
    for name, marker in port.items():
        key = by_id[marker // 1000]
        shape = leaf[key].shape
        stacked = "unit" in key.split("/")
        per[name] = {"shape": list(shape[1:] if stacked else shape), "leaf": key,
                     "stacked": stacked,
                     "specs": {m: full(f[key], len(shape))[1 if stacked else 0:]
                               for m, f in flat.items()}}
    # the optimizer state's placement: opt_state_shardings over init_state's
    # abstract tree, on an abstract mesh of each table's sizes
    opt = {}
    for kind in t.OPT_KINDS:
        ocfg = adamw.OptimizerConfig(kind=kind)
        abstract_opt = jax.eval_shape(lambda p: adamw.init_state(ocfg, p), abstract)
        for m, tab in tables.items():
            mesh = meshes["2pod" if m in t.VARIANTS else m]
            amesh = AbstractMesh(tuple(mesh.shape.values()), tuple(mesh.shape))
            shard = opt_state_shardings(abstract_opt, tab, amesh)
            rows = opt.setdefault(kind, {}).setdefault(m, {})
            for (p, sh), (_, l) in zip(
                    jax.tree_util.tree_flatten_with_path(
                        shard["m"], is_leaf=lambda x: isinstance(x, NamedSharding))[0],
                    jax.tree_util.tree_flatten_with_path(abstract_opt["m"])[0]):
                key, leaf_key = shd._path_str(p[:-1]), p[-1].key
                rows.setdefault(key, {})[leaf_key] = full(sh.spec, len(l.shape))
    for name in per:
        per[name]["opt"] = {kind: {m: rows[per[name]["leaf"]] for m, rows in tabs.items()}
                            for kind, tabs in opt.items()}
    cache = jax.eval_shape(lambda: model.init_cache(4, 64, jnp.bfloat16))
    cache_rows = []
    for m, mesh in meshes.items():
        cs = shd.cache_specs(cache, mesh)
        for (p, l), s in zip(jax.tree_util.tree_flatten_with_path(cache)[0],
                             jax.tree_util.tree_leaves(cs, is_leaf=lambda x: isinstance(x, P))):
            cache_rows.append([m, list(l.shape[1:]), full(s, len(l.shape))[1:]])
    batch = {k: jax.ShapeDtypeStruct(s, d) for k, (s, d) in batch_shapes(
        run.model, ShapeSpec("train", run.train.seq_len, 16, "train")).items()}
    batch_rows = []
    for m, mesh in meshes.items():
        bs = shd.batch_specs(batch, mesh)
        for k in batch:
            batch_rows.append([m, k, list(batch[k].shape), full(bs[k], len(batch[k].shape))])
    specs[arch] = {"params": per, "cache": cache_rows, "batch": batch_rows}
with open(os.path.join(OUT, "specs.json"), "w") as f:
    json.dump(specs, f)
"""


# --- rank side -----------------------------------------------------------------

def ranks(rank, world, out):
    """Every collective of the world size on this rank; outputs to npz."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.parallel.collectives import hierarchical_allreduce
    from repro_torch.parallel.compression import ring_allreduce_int8
    from repro_torch.parallel.pipeline import pipeline_forward
    res = {"ring": ring_allreduce_int8(torch.from_numpy(ring_input(world)[rank])).numpy()}
    for n in STAGES:
        if n == world:
            mesh = make_local_mesh(1, 1, pod=n, device="cpu")
            ws, bs, mbs = (torch.from_numpy(a) for a in pipe_inputs(n))
            res[f"pipe/{n}"] = pipeline_forward(
                lambda p, x: torch.tanh(x @ p[0] + p[1]), (ws, bs), mbs, mesh).numpy()
    if world == 4:
        from torch.distributed.tensor import Shard
        from repro_torch.parallel import sharding as shd
        mesh = make_local_mesh(2, 1, pod=2, device="cpu")
        for key, x in hier_inputs().items():
            res[f"hier/{key}"] = hierarchical_allreduce(
                {"x": torch.from_numpy(x[rank])}, mesh, compress_slow=key == "int8")["x"].numpy()
        # a dim over ("pod", "data"): this rank's shard is block pod * 2 + data
        full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        pl = shd.placements((("pod", "data"), None), mesh)
        assert pl == [Shard(0), Shard(0), pl[2]]
        dt = shd.shard_tensor(full, mesh, pl)
        res["shard"] = dt.to_local().numpy()
        res["shard_full"] = dt.full_tensor().numpy()
        # the placement of a no-pod mesh: the sum over data alone
        flat = make_local_mesh(4, 1, device="cpu")
        res["flat_sum"] = hierarchical_allreduce({"x": torch.full((3,), float(rank))},
                                                 flat)["x"].numpy()
    dist.barrier()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


# --- fixtures --------------------------------------------------------------------

@pytest.fixture(scope="module")
def world_outputs(tmp_path_factory):
    """{world: [rank outputs]} and the JAX child's arrays and specs; the
    child runs while the ranks do."""
    child = JaxChild(JAX_SIDE.replace("HERE", repr(HERE)), tmp_path_factory.mktemp("jax"))
    worlds = {}
    for world in RING_WORLDS:
        out = run_world(f"{HERE}:ranks", world, tmp_path_factory.mktemp(f"world{world}"))
        worlds[world] = [dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(world)]
    jax_out = child.result()
    ref = dict(np.load(os.path.join(jax_out, "ref.npz")))
    with open(os.path.join(jax_out, "specs.json")) as f:
        specs = json.load(f)
    return worlds, ref, specs


# --- a: quantisation and the ring ----------------------------------------------------

@pytest.mark.parametrize("case", list(quant_cases()))
def test_quantize_int8_is_bit_equal_to_jax(case, world_outputs):
    from repro_torch.parallel.compression import dequantize_int8, quantize_int8, roundtrip_int8
    _, ref, _ = world_outputs
    x, dt = quant_cases()[case]
    xt = torch.from_numpy(x).to(getattr(torch, dt))
    q, s = quantize_int8(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == ()
    np.testing.assert_array_equal(q.numpy(), ref[f"q/{case}"])
    np.testing.assert_array_equal(s.numpy(), ref[f"s/{case}"])
    np.testing.assert_array_equal(dequantize_int8(q, s).numpy(), ref[f"deq/{case}"])
    rt = roundtrip_int8(xt)
    assert rt.dtype == xt.dtype
    np.testing.assert_array_equal(rt.float().numpy(), ref[f"rt/{case}"])
    if case.startswith("ties"):         # half to even: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
        assert q.numpy()[:6].tolist() == [0, 2, 2, 0, -2, -2]
    if case in ("zeros", "below_floor"):
        assert float(s) == np.float32(1e-12)


def test_error_feedback_carries_the_residual():
    """g' = q(g + r), r' = (g + r) - g', in fp32 whatever g's dtype; init
    is zeros; the gradients are consumed and r' written in r's tensor."""
    from repro_torch.parallel.compression import ErrorFeedback, roundtrip_int8
    g = {"a": torch.tensor([1.0, -0.3, 0.004], dtype=torch.bfloat16)}
    r = ErrorFeedback.init(g)
    assert r["a"].dtype == torch.float32 and not r["a"].any()
    r = {"a": torch.tensor([0.25, 0.0, -0.001])}
    corrected = g["a"].float() + r["a"]
    buf = r["a"]
    out, resid = ErrorFeedback.apply(g, r, lambda _, x: roundtrip_int8(x))
    assert out["a"].dtype == torch.float32 and not g
    assert torch.equal(out["a"], roundtrip_int8(corrected))
    assert torch.equal(resid["a"], corrected - out["a"]) and resid["a"] is buf


def _hold_to_a_step(got, want, x, where):
    """Equal, or within one quantisation step of the hops, element by
    element; the message says how many differ and by how much."""
    diff = np.abs(got - want)
    step = np.abs(x).sum(0).max() / 127.0       # >= every hop's amax / 127
    n_bad = int((diff > 0).sum())
    assert diff.max() <= step, (f"{where}: {n_bad} of {diff.size} elements differ, by at most "
                                f"{diff.max():.3g}, above a step of {step:.3g}")
    return n_bad, float(diff.max())


@pytest.mark.parametrize("world", RING_WORLDS)
def test_ring_allreduce_int8_matches_jax_at_every_rank(world, world_outputs):
    worlds, ref, _ = world_outputs
    want = ref[f"ring/{world}"]
    x = ring_input(world)
    for rank, res in enumerate(worlds[world]):
        got = res["ring"]
        assert got.shape == RING_SHAPE and got.dtype == np.float32
        _hold_to_a_step(got, want[rank], x, f"rank {rank}")
        # and it is a sum, within the int8 error of 2 (n - 1) requantisations
        err = np.abs(got - x.sum(0)).max() / np.abs(x.sum(0)).max()
        assert err < 0.02 * world, err


def test_ring_of_one_rank_returns_its_input():
    import torch.distributed as dist
    from repro_torch.parallel.compression import ring_allreduce_int8
    x = torch.randn(7)
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        assert ring_allreduce_int8(x) is x
    finally:
        dist.destroy_process_group()


# --- c: the hierarchical reduction and the pipeline ------------------------------------

@pytest.mark.parametrize("key", ["plain", "int8"])
def test_hierarchical_allreduce_matches_jax(key, world_outputs):
    worlds, ref, _ = world_outputs
    x = hier_inputs()[key]
    for rank, res in enumerate(worlds[4]):
        got, want = res[f"hier/{key}"], ref[f"hier/{key}"][rank]
        assert got.shape == x.shape[1:]
        if key == "plain":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_allclose(got, x.sum(0), rtol=1e-6, atol=1e-6)
        else:
            _hold_to_a_step(got, want, x, f"rank {rank}")


def test_hierarchical_allreduce_without_pod_is_a_sum_over_data(world_outputs):
    worlds, _, _ = world_outputs
    for res in worlds[4]:
        assert res["flat_sum"].tolist() == [6.0, 6.0, 6.0]


def test_pod_data_shard_order_is_jax_major_to_minor(world_outputs):
    worlds, _, _ = world_outputs
    full = np.arange(24, dtype=np.float32).reshape(8, 3)
    for rank, res in enumerate(worlds[4]):
        pod, data = divmod(rank, 2)
        np.testing.assert_array_equal(res["shard"], full[2 * (pod * 2 + data):][:2])
        np.testing.assert_array_equal(res["shard_full"], full)


@pytest.mark.parametrize("n_stages", STAGES)
def test_pipeline_forward_matches_jax_on_every_rank(n_stages, world_outputs):
    worlds, ref, _ = world_outputs
    ws, bs, mbs = pipe_inputs(n_stages)
    seq = mbs.copy()
    for s in range(n_stages):
        seq = np.tanh(seq @ ws[s] + bs[s])
    for res in worlds[n_stages]:
        got = res[f"pipe/{n_stages}"]
        np.testing.assert_allclose(got, ref[f"pipe/{n_stages}"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got, seq, rtol=1e-5, atol=1e-5)


# --- b: the sharding rules ---------------------------------------------------------------

def _port_model(arch, monkeypatch):
    """The port's LM of the full config on the meta device: names, shapes
    and cache shapes, no memory."""
    import repro_torch.models.transformer as transformer
    from repro_torch.configs import get_config
    monkeypatch.setattr(transformer, "resolve_device", lambda d: torch.device("meta"))
    return transformer.LM(get_config(arch).model, device="meta")


def _as_lists(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_without_the_units_dim(arch, world_outputs, monkeypatch):
    from repro_torch.parallel import sharding as shd
    _, _, specs = world_outputs
    want = specs[arch]["params"]
    shapes = {n: tuple(p.shape) for n, p in _port_model(arch, monkeypatch).named_parameters()}
    assert set(shapes) == set(want)
    for name, shape in shapes.items():
        assert list(shape) == want[name]["shape"], name
    tables = {m: shd.param_specs(shapes, mesh) for m, mesh in MESHES.items()}
    tables.update({v: shd.param_specs(shapes, MESHES["2pod"], **kw) for v, kw in VARIANTS.items()})
    for m, table in tables.items():
        for name, spec in table.items():
            assert _as_lists(spec) == want[name]["specs"][m], (m, name, spec)


@pytest.mark.parametrize("kind", OPT_KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_specs_equal_jax_without_the_units_dim(arch, kind, world_outputs, monkeypatch):
    """``sharding.opt_state_specs`` against the JAX package's
    ``opt_state_shardings`` over ``adamw.init_state``'s tree, on every mesh
    and variant of the parameter specs' test, every state tensor: a layer's
    row of a stacked JAX state tensor (its moments, a factored member's
    ``mu`` and ``nu_row`` entry) with the units dim dropped, and a JAX state
    tensor the port holds whole (a stack of vectors' ``nu_col``, the 8-bit
    blocks of a stack whose blocks span its layers, a layer's slice of a
    stack's blocks, an unstacked leaf's state) entry for entry. Exactly the
    2-D JAX leaves (``BLOCKS_SHARDED`` and the stacks of vectors split over
    an axis) give their blocks a spec."""
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as shd
    from repro_torch.train.steps import jax_leaves
    _, _, specs = world_outputs
    want = specs[arch]["params"]
    model = _port_model(arch, monkeypatch)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    cfg = adamw.OptimizerConfig(kind=kind)
    leaves = jax_leaves(model)
    layout = adamw.tree_layout(cfg, shapes, leaves)
    state = {n: {k: v[0] for k, v in lay.items()} for n, lay in layout.items()}
    tables = {m: shd.param_specs(shapes, mesh) for m, mesh in MESHES.items()}
    tables.update({v: shd.param_specs(shapes, MESHES["2pod"], **kw) for v, kw in VARIANTS.items()})
    compared, sharded_blocks = 0, set()
    for m, table in tables.items():
        got = shd.opt_state_specs(table, state)
        for name, leaf in got.items():
            ref, stacked = want[name]["opt"][kind][m], want[name]["stacked"]
            assert shd.stacked(name) == stacked, name
            assert set(leaf) <= set(ref), (name, set(leaf), set(ref))
            for key, spec in leaf.items():
                assert len(spec) == len(state[name][key]), (m, name, key)
                # the JAX tensor held whole by this layer, or a layer's row of it
                held_whole = (not stacked or key in shd.BLOCK_KEYS
                              or (key == "nu_col" and len(ref[key]) == 1))
                r = ref[key] if held_whole else ref[key][1:]
                assert _as_lists(spec) == r, (m, name, key, spec, ref[key])
                compared += 1
                if key in shd.BLOCK_KEYS and any(spec):
                    sharded_blocks.add(name)
    # every state tensor of every parameter on every mesh
    assert compared == len(tables) * sum(len(lay) for lay in state.values())
    if kind == "adamw_8bit":
        split_stacks = {n for n, shape in shapes.items() if shd.stacked(n) and len(shape) == 1
                        and state[n] and any(s for t in tables.values() for s in t[n])}
        assert sharded_blocks == (BLOCKS_SHARDED & set(shapes)) | split_stacks, sharded_blocks
    else:
        mu = shd.opt_state_specs(tables["1pod"], state)
        assert all(mu[n]["mu"] == tables["1pod"][n] for n in shapes)
        assert all(not any(mu[n][k]) for n in shapes for k in ("nu_row", "nu_col") if k in mu[n])


def test_fit_spec_holds_a_dim_whole_that_its_axes_do_not_divide():
    from repro_torch.parallel import sharding as shd
    mesh = {"pod": 2, "data": 16, "model": 16}
    # an 8-bit scale (n, 1) of a leaf specced (model, (pod, data)): dim 1 whole
    assert shd.fit_spec(("model", ("pod", "data")), (3584, 1), mesh) == ("model", None)
    assert shd.fit_spec(("model", ("pod", "data")), (3584, 256), mesh) == (
        "model", ("pod", "data"))
    assert shd.fit_spec((("pod", "data"), None), (48, 7), mesh) == ("pod", None)
    assert shd.local_shape((3584, 256), ("model", ("pod", "data")), mesh) == (224, 8)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_groups_are_the_jax_leaves(arch, world_outputs, monkeypatch):
    """The int8 stage gives the tensors of one JAX leaf one scale: the
    port's groups partition the parameters as the JAX leaves do."""
    from repro_torch.train.steps import int8_groups
    _, _, specs = world_outputs
    want = specs[arch]["params"]
    groups = int8_groups(_port_model(arch, monkeypatch))

    def partition(key_of):
        parts = {}
        for name in sorted(key_of):
            parts.setdefault(key_of[name], []).append(name)
        return sorted(parts.values())
    assert partition(groups) == partition({n: w["leaf"] for n, w in want.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_specs_equal_jax(arch, world_outputs, monkeypatch):
    from repro_torch.common.config import ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.models.model import batch_shapes
    from repro_torch.parallel import sharding as shd
    _, _, specs = world_outputs
    rows = specs[arch]["cache"]
    for m, shape, want in rows:
        assert _as_lists(shd.cache_spec(tuple(shape), MESHES[m])) == want, (m, shape)
    cache = _port_model(arch, monkeypatch).init_cache(4, 64)
    ref_shapes = {tuple(s) for _, s, _ in rows}
    for c, cs in zip(cache, shd.cache_specs(cache, MESHES["2x2"])):
        if c is not None:
            for tensor, spec in zip(c, cs):
                assert tuple(tensor.shape) in ref_shapes, tensor.shape
                assert spec == shd.cache_spec(tuple(tensor.shape), MESHES["2x2"])
    run = get_config(arch)
    port_batch = batch_shapes(run.model, ShapeSpec("train", run.train.seq_len, 16, "train"))
    for m, key, shape, want in specs[arch]["batch"]:
        assert list(port_batch[key][0]) == shape
        assert _as_lists(shd.batch_spec(tuple(shape), MESHES[m])) == want, (m, key)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.parallel import sharding as shd
    mesh = {"pod": 2, "data": 2, "model": 2}
    assert shd.placements(("model", ("pod", "data")), mesh) == [Shard(1), Shard(1), Shard(0)]
    assert shd.placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements((("data", "pod"),), mesh)
