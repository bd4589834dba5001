"""The dry run and the roofline (``repro_torch.launch.{dryrun,roofline}``) and
the parameter accounting (``models.model``) on the CPU.

Held equal to the JAX package, whose side a JAX child computes
(``_dist.JaxChild``; ``repro.launch.dryrun`` and ``roofline`` import under
jax 0.4.37, since ``jax_compat`` refuses this jax), exactly unless said:
  * ``count_params_analytic`` (both modes) and ``input_specs`` (the four
    shapes) of all ten configs; ``with_units`` / ``full_units`` for k = 1-3;
  * ``structural_hbm_bytes`` for the four shapes at 256 and 512 devices
    (relative 1e-12: the same float formula);
  * ``roofline.py``'s arithmetic on the same inputs, with the JAX package's
    TPU v5e constants patched into the port's ``launch/mesh.py`` (relative
    1e-12); the port's H100 constants pinned by value;
  * the meta-device trace's FLOPs against XLA's matmul FLOPs of the same
    cell in the JAX package's program (``lower_cell``), dense and MoE + MLA:
    prefill and decode equal, train as its test says;
  * a rank's share of the tensor-parallel train step on a (data 2, model 2)
    mesh, traced under a fake group, at most 0.30 of the one-device step's
    FLOPs for the same global batch (dense and MoE + MLA), printed beside
    XLA's per-device dot FLOPs of the JAX package's GSPMD step on 4 host
    devices;
Held to the port itself:
  * the meta-device trace counts the FLOPs that ``FlopCounterMode`` counts
    when the same step runs on real CPU tensors, for each family (dense,
    MoE + MLA, cross attention, Mamba2, xLSTM) in train, prefill and decode,
    exactly;
  * the extrapolations from 2 and 3 units (and, for xLSTM, from two lengths)
    equal the full-depth trace: FLOPs and bytes exactly, the peak bytes
    within 1%; and a cell whose peak moves from the loss to the backward
    pass as layers are added, where the affine peak of the two traces
    misses by more than 10% and the aligned timelines do not;
  * on one spawned gloo world of four ranks, a (data 2, model 2) mesh: the
    predicted per-device argument bytes equal the local shards the sharded
    Trainer holds, and ``collectives_of`` (the dry run's trace of rank 0's
    share under a fake group, on the meta device) equals the collectives one
    step issues on gloo, counted by a dispatch mode (counts and bytes
    exactly, wire bytes relative 1e-12), for int8, a factored optimizer, MoE
    and remat ``dots``;
  * the record's keys, ``skipped_by_design`` exactly where
    ``shape_applicable`` is false, and the CLI on smollm-135m train_4k
    (its roofline at one microbatch, reproduced by ``--roofline-only``);
  * a train cell's roofline traced at one microbatch and its memory at the
    config's two, as the JAX package's ``run_cell`` divides them;
  * ``attn_activation_sharding`` resolved as the JAX package's
    ``build_model`` does for all ten configs, "sequence" and unknown values
    refused; a rank's attention FLOPs under "batch" 1/model of "off"'s where
    the rows divide and the heads do not, equal elsewhere; an 8-bit cell's
    gathered bytes below the whole-leaf update's.
"""
import dataclasses
import json
import os

import pytest
import torch

from _dist import JaxChild, run_world

HERE = os.path.abspath(__file__)
V5E = {"PEAK_FLOPS_BF16": 197e12, "HBM_BW": 819e9, "NET_BW": 50e9}
SEQ, BATCH = 32, 4
# world variants: (arch, ParallelConfig overrides)
VARIANTS = {
    "gemma2_int8": ("gemma2-2b", dict(microbatches=2, remat="full", grad_compression="int8")),
    "gemma2_factored": ("gemma2-2b", dict(optimizer_state="adamw_factored")),
    "deepseek_moe": ("deepseek-v2-236b", dict(microbatches=2, remat="full")),
    "arctic_8bit_dots": ("arctic-480b", dict(optimizer_state="adamw_8bit", remat="dots")),
}
# the families whose matmul FLOPs are held to XLA's count: dense, MoE + MLA
XLA_ARCHS = ("gemma2-2b", "deepseek-v2-236b")
FAMILIES = ("gemma2-2b", "deepseek-v2-236b", "llama-3.2-vision-11b", "zamba2-7b", "xlstm-125m")

# the roofline arithmetic's inputs: collectives as (kind, bytes, group)
COLL_A = [("all-reduce", 1e6, 16), ("all-gather", 3e5, 2), ("reduce-scatter", 7e5, 16),
          ("all-to-all", 5e4, 8), ("collective-permute", 2e3, 2), ("all-reduce", 10.0, 1)]
COLL_B = [("all-gather", 4e5, 16), ("all-reduce", 2e6, 2), ("all-reduce", 3e5, 16)]
# (flops, bytes, scale of COLL_B, units, model flops, kind): compute, memory
# and collective bound in turn
CASES = [(1.5e12, 3e9, 1.0, 26, 9e15, "train"), (2e9, 8e10, 1.0, 13, 4e14, "prefill"),
         (1e9, 1e9, 5e4, 60, 1e14, "decode")]

JAX_SIDE = r"""
import dataclasses
import json
import re
_flags = os.environ["XLA_FLAGS"]
import repro.launch.dryrun as dr          # forces 512 host devices at import
os.environ["XLA_FLAGS"] = _flags
from repro.common.config import SHAPES
from repro.configs import ARCHS, get_config
from repro.launch import roofline as rl
from repro.models.model import count_params_analytic, input_specs

from repro.models.model import build_model as jax_build_model
out = {"params": {}, "specs": {}, "units": {}, "structural": {}, "roofline": [], "sp_attn": {}}
for a in ARCHS:
    run = get_config(a)
    out["params"][a] = [count_params_analytic(run.model),
                        count_params_analytic(run.model, active_only=True)]
    out["specs"][a] = {s: {k: [list(v.shape), str(v.dtype)]
                           for k, v in input_specs(run.model, sh).items()}
                       for s, sh in SHAPES.items()}
    out["units"][a] = [dr.full_units(run)] + [dr.with_units(run, k).model.n_layers
                                              for k in (1, 2, 3)]
    out["sp_attn"][a] = {m: jax_build_model(run.replace(parallel=dataclasses.replace(
        run.parallel, attn_activation_sharding=m)), use_kernel=False).sp_attn
        for m in ("off", "auto", "batch", "sequence")}
    out["structural"][a] = {f"{s}/{c}": rl.structural_hbm_bytes(run, sh, c)
                            for s, sh in SHAPES.items() for c in (256, 512)}

def stats(items, scale=1.0):
    s = rl.CollectiveStats()
    for kind, nbytes, group in items:
        s.add(kind, nbytes * scale, group)
    return s

for flops, nbytes, scale, units, mf, kind in CASES:
    a, b = stats(COLL_A), stats(COLL_B, scale)
    c1 = rl.CostTerms(flops, nbytes, a)
    c2 = rl.CostTerms(1.75 * flops, 1.5 * nbytes, a.merged(b, 1.0))
    per = c2.diff(c1)
    total = c1.extrapolate(per, units - 1)
    roof = rl.roofline_terms("x", kind, "single_pod_16x16", 256, total, mf, 0.0)
    m = a.merged(b, 2.5)
    out["roofline"].append({
        "merged": [m.counts, m.raw_bytes, m.wire_bytes],
        "per": [per.flops, per.hbm_bytes, per.coll.counts, per.coll.raw_bytes, per.coll.wire_bytes],
        "total": [total.flops, total.hbm_bytes, total.coll.counts, total.coll.raw_bytes,
                  total.coll.wire_bytes],
        "roof": [roof.t_comp, roof.t_mem, roof.t_coll, roof.hlo_flops, roof.dominant,
                 roof.useful_flops_ratio, roof.roofline_fraction],
        "model_flops": rl.model_flops_estimate(123456789, 1048576, kind)})

# XLA's matmul FLOPs of smoke cells, lowered as roofline_cell lowers them
# (one microbatch, every loop unrolled) on one device: 2 x the output's
# elements x the contracted extent of every dot of the optimized HLO
INS = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")
DOT = re.compile(r"\sdot\(%([\w.\-]+),\s*%([\w.\-]+)\).*?lhs_contracting_dims=\{([\d,]*)\}")


def dims(text):
    return [int(v) for v in text.split(",") if v]


def dot_flops(hlo):
    total, shapes = 0, {}
    for line in hlo.splitlines():
        if line.rstrip().endswith("{") and "=" not in line.split("(")[0]:
            # a computation's header: its parameters' shapes; names are local to it
            shapes = {n: dims(d) for n, d in re.findall(r"([\w.\-]+):\s*\w+\[([\d,]*)\]", line)}
            continue
        m = INS.match(line)
        if m is None:
            continue
        shapes[m.group(1)] = dims(m.group(2))
        d = DOT.search(line)
        if d is not None:
            n = 2
            for x in dims(m.group(2)):
                n *= x
            for c in dims(d.group(3)):
                n *= shapes[d.group(1)][c]
            total += n
    return total


from repro.common.config import ShapeSpec
from repro.configs import get_smoke_config
from repro.launch.mesh import make_local_mesh
os.environ["REPRO_UNROLL_SCANS"] = "1"
mesh = make_local_mesh(1, 1)
out["xla_dots"] = {}
for arch in XLA_ARCHS:
    run = get_smoke_config(arch)
    run = run.replace(parallel=dataclasses.replace(run.parallel, microbatches=1, remat="full"))
    for kind in ("train", "prefill", "decode"):
        compiled = dr.lower_cell(run, ShapeSpec(kind, SEQ, 2, kind), mesh, unroll=True)
        out["xla_dots"][f"{arch}/{kind}"] = dot_flops(compiled.as_text())
# the GSPMD train step on a (data 2, model 2) mesh of the 4 host devices: the
# partitioned program is one device's
mesh4 = make_local_mesh(2, 2)
out["xla_dots_mesh"] = {}
for arch in XLA_ARCHS:
    run = get_smoke_config(arch)
    run = run.replace(parallel=dataclasses.replace(run.parallel, microbatches=1, remat="full"))
    compiled = dr.lower_cell(run, ShapeSpec("train", SEQ, 4, "train"), mesh4, unroll=True)
    out["xla_dots_mesh"][arch] = dot_flops(compiled.as_text())
with open(os.path.join(OUT, "ref.json"), "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    code = JAX_SIDE.replace("COLL_A", repr(COLL_A)).replace("COLL_B", repr(COLL_B))
    code = code.replace("XLA_ARCHS", repr(XLA_ARCHS)).replace("SEQ", repr(SEQ))
    child = JaxChild(code.replace("CASES", repr(CASES)), tmp_path_factory.mktemp("dryrun"),
                     n_devices=4)
    with open(os.path.join(child.result(), "ref.json")) as f:
        return json.load(f)


def _archs():
    from repro_torch.configs import ARCHS
    return list(ARCHS)


# --- the parameter accounting, the inputs, the units -----------------------------------------

@pytest.mark.parametrize("arch", _archs())
def test_count_params_and_input_specs_equal_the_jax_packages(arch, jax_ref):
    from repro_torch.common.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.models.model import count_params_analytic, input_specs
    cfg = get_config(arch).model
    assert [count_params_analytic(cfg), count_params_analytic(cfg, active_only=True)] == \
        jax_ref["params"][arch]
    for s, shape in SHAPES.items():
        specs = input_specs(cfg, shape)
        assert all(t.device.type == "meta" for t in specs.values())
        got = {k: [list(t.shape), str(t.dtype).replace("torch.", "")] for k, t in specs.items()}
        assert got == jax_ref["specs"][arch][s], s


@pytest.mark.parametrize("arch", _archs())
def test_units_and_structural_bytes_equal_the_jax_packages(arch, jax_ref):
    from repro_torch.common.config import SHAPES
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import roofline as rl
    run = get_config(arch)
    assert [dr.full_units(run)] + [dr.with_units(run, k).model.n_layers for k in (1, 2, 3)] \
        == jax_ref["units"][arch]
    for s, shape in SHAPES.items():
        for chips in (256, 512):
            want = jax_ref["structural"][arch][f"{s}/{chips}"]
            assert rl.structural_hbm_bytes(run, shape, chips) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("arch", _archs())
def test_attn_activation_mode_resolves_as_the_jax_build_model(arch, jax_ref):
    """"off", "auto", "batch" and "sequence" of each full config resolve to the JAX
    ``build_model``'s ``sp_attn`` ("" for "off"), and the port's ``LM``
    carries it: "auto" is "batch" for every GQA config whose kv heads do not
    divide 16, "off" for deepseek-v2-236b (MLA) and zamba2-7b (32 kv
    heads)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import attn_activation_mode, build_model
    run = get_config(arch)
    for mode, want in jax_ref["sp_attn"][arch].items():
        r = run.replace(parallel=dataclasses.replace(run.parallel, attn_activation_sharding=mode))
        got = attn_activation_mode(r)
        assert ("" if got == "off" else got) == want, mode
        assert build_model(r, device="meta", use_kernel=False).sp_attn == want, mode
    auto = jax_ref["sp_attn"][arch]["auto"]
    assert auto == ("" if arch in ("deepseek-v2-236b", "zamba2-7b") else "batch")


@pytest.mark.parametrize("mode", ["sequence", "batched", "on"])
def test_other_attn_activation_modes_are_refused_by_name(mode):
    """Unknown names are refused by name, by ``attn_activation_mode`` (through
    ``build_model``) and by ``LM``; "sequence", which the port refused
    until it ran it, is accepted for all ten configs, as the JAX
    ``build_model`` accepts it."""
    from repro_torch.configs import ARCHS, get_config, get_smoke_config
    from repro_torch.models.model import attn_activation_mode, build_model
    from repro_torch.models.transformer import LM
    if mode == "sequence":
        for arch in ARCHS:
            run = get_config(arch)
            run = run.replace(parallel=dataclasses.replace(run.parallel,
                                                           attn_activation_sharding=mode))
            assert attn_activation_mode(run) == mode, arch
            assert build_model(run, device="meta").sp_attn == mode, arch
            assert LM(run.model, device="meta", sp_attn=mode).sp_attn == mode, arch
        return
    run = get_smoke_config("gemma2-2b")
    run = run.replace(parallel=dataclasses.replace(run.parallel, attn_activation_sharding=mode))
    with pytest.raises(ValueError, match=f"'{mode}'"):
        build_model(run, device="meta")
    with pytest.raises(ValueError, match=f"'{mode}'"):
        LM(run.model, device="meta", sp_attn=mode)


# --- the roofline's arithmetic ---------------------------------------------------------------

def _close(got, want, path="") -> None:
    """Equal structure and strings; numbers within relative 1e-12."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}/{i}")
    elif isinstance(want, str):
        assert got == want, path
    else:
        assert got == pytest.approx(want, rel=1e-12, abs=0), path


def _stats(rl, items, scale=1.0):
    s = rl.CollectiveStats()
    for kind, nbytes, group in items:
        s.add(kind, nbytes * scale, group)
    return s


@pytest.mark.parametrize("case", range(len(CASES)))
def test_roofline_arithmetic_equals_the_jax_packages(case, jax_ref, monkeypatch):
    from repro_torch.launch import mesh as meshmod
    from repro_torch.launch import roofline as rl
    for name, value in V5E.items():
        monkeypatch.setattr(meshmod, name, value)
    flops, nbytes, scale, units, mf, kind = CASES[case]
    want = jax_ref["roofline"][case]
    a, b = _stats(rl, COLL_A), _stats(rl, COLL_B, scale)
    c1 = rl.CostTerms(flops, nbytes, a)
    c2 = rl.CostTerms(1.75 * flops, 1.5 * nbytes, a.merged(b, 1.0))
    per = c2.diff(c1)
    total = c1.extrapolate(per, units - 1)
    roof = rl.roofline_terms("x", kind, "single_pod_16x16", 256, total, mf, 0.0)
    m = a.merged(b, 2.5)
    got = {"merged": [m.counts, m.raw_bytes, m.wire_bytes],
           "per": [per.flops, per.hbm_bytes, per.coll.counts, per.coll.raw_bytes,
                   per.coll.wire_bytes],
           "total": [total.flops, total.hbm_bytes, total.coll.counts, total.coll.raw_bytes,
                     total.coll.wire_bytes],
           "roof": [roof.t_comp, roof.t_mem, roof.t_coll, roof.hlo_flops, roof.dominant,
                    roof.useful_flops_ratio, roof.roofline_fraction],
           "model_flops": rl.model_flops_estimate(123456789, 1048576, kind)}
    _close(json.loads(json.dumps(got)), want)
    assert roof.dominant == ("compute", "memory", "collective")[case]


def test_h100_constants():
    from repro_torch.launch import mesh as meshmod
    assert (meshmod.PEAK_FLOPS_BF16, meshmod.PEAK_FLOPS_FP32, meshmod.HBM_BW,
            meshmod.HBM_BYTES, meshmod.NET_BW) == (989e12, 67e12, 3.35e12, 80e9, 50e9)
    assert not hasattr(meshmod, "ICI_BW") and not hasattr(meshmod, "DCN_BW")


# --- the trace against real tensors, and the extrapolations ----------------------------------

def _smoke(arch, **parallel):
    from repro_torch.configs import get_smoke_config
    run = get_smoke_config(arch)
    return run.replace(parallel=dataclasses.replace(run.parallel, **parallel))


def _real_flops(run, shape):
    """FlopCounterMode's count of the step on real CPU tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun as dr
    from repro_torch.models.model import build_model, synthetic_batch
    from repro_torch.train.steps import make_decode_step, make_prefill_step, make_train_step
    model = build_model(run, device="cpu", use_kernel=False)
    model.init_weights(torch.Generator().manual_seed(0))
    batch = synthetic_batch(run.model, shape, device="cpu")
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            params = dict(model.named_parameters())
            state = dr.init_opt_state(run, params)
            run = run.replace(train=dataclasses.replace(run.train, seq_len=shape.seq_len,
                                                        global_batch=shape.global_batch))
            make_train_step(model, run, dr.optimizer_config(run))(params, state, batch)
        else:
            cache = model.init_cache(shape.global_batch, shape.seq_len, torch.bfloat16)
            if shape.kind == "prefill":
                make_prefill_step(model)(batch, cache)
            else:
                make_decode_step(model)(batch, cache, shape.seq_len - 1)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_meta_trace_counts_the_flops_of_real_tensors(arch, kind):
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    run = _smoke(arch, remat="full", microbatches=2)
    shape = ShapeSpec(kind, SEQ, 2, kind)
    tr = dr.trace_cell(run, shape, {"data": 1, "model": 1})
    assert tr.flops > 0 and tr.bytes > 0 and tr.peak_bytes > tr.arg_bytes > 0
    assert tr.flops == _real_flops(run, shape)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", XLA_ARCHS)
def test_meta_trace_counts_the_matmul_flops_of_the_jax_packages_program(arch, kind, jax_ref):
    """The counted FLOPs against XLA's dots in the JAX package's program of the
    same cell (one microbatch, remat full). Prefill and decode: equal. Train:
    XLA's plus the chunked loss's read-out recomputed in the backward pass
    (2 B (S-1) V d: the port's ``_chunked_ce`` checkpoints each chunk and runs
    its product again; XLA merges that recompute with the forward's), and
    within 0.1 % of that (the MoE top-k combine, a batched product here and a
    multiply-reduce in XLA). A missing or doubled layer moves either by
    more than 10 %."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    run = _smoke(arch, remat="full", microbatches=1)
    tr = dr.trace_cell(run, ShapeSpec(kind, SEQ, 2, kind), {"data": 1, "model": 1})
    xla = jax_ref["xla_dots"][f"{arch}/{kind}"]
    if kind != "train":
        assert tr.flops == xla
        return
    readout = 2 * 2 * (SEQ - 1) * run.model.vocab_size * run.model.d_model
    assert 0 <= tr.flops - xla - readout <= 1e-3 * xla


@pytest.mark.parametrize("arch", XLA_ARCHS)
def test_a_ranks_tp_step_traces_a_quarter_of_the_one_device_flops(arch, jax_ref):
    """One rank of a (data 2, model 2) mesh computes its half of the batch
    on its half of the heads, FFN columns, experts and vocab: its traced
    FLOPs (every one a matmul's) are at most 0.30 of the one-device step's
    for the same global batch of 4 (ideal 0.25; what is left is computed
    whole, as MLA's latents and the routing are). XLA's per-device dot
    FLOPs of the GSPMD step on the same mesh are printed beside them."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    run = _smoke(arch, remat="full", microbatches=1)
    shape = ShapeSpec("train", SEQ, 4, "train")
    one = dr.trace_cell(run, shape, {"data": 1, "model": 1}).flops
    rank = dr.trace_cell(run, shape, {"data": 2, "model": 2}).flops
    xla = jax_ref["xla_dots_mesh"][arch]
    print(f"{arch}: a rank's traced FLOPs {rank:.0f} = {rank / one:.4f} of one device's "
          f"{one:.0f}; XLA's per-device dots of the GSPMD step {xla} = {xla / one:.4f}")
    assert rank <= 0.30 * one


# (arch, kind): (layers, seq, how the peak is extrapolated). full_units > 3
# (traced at 2 and 3 units), but xlstm's 2 (traced whole, at two lengths,
# extrapolated to 1,024 tokens). zamba2's shared block gathers its gradient
# from two applications at 2 units and three at 3, so its train timelines do
# not align and its peak is extrapolated as a peak.
EXTRAPOLATIONS = {
    ("gemma2-2b", "train"): (8, SEQ, "timeline"),
    ("gemma2-2b", "prefill"): (8, SEQ, "timeline"),
    ("deepseek-v2-236b", "train"): (5, SEQ, "timeline"),
    ("deepseek-v2-236b", "prefill"): (5, SEQ, "timeline"),
    ("llama-3.2-vision-11b", "train"): (20, SEQ, "timeline"),
    ("musicgen-medium", "train"): (5, SEQ, "timeline"),
    ("musicgen-medium", "prefill"): (5, SEQ, "timeline"),
    ("zamba2-7b", "prefill"): (13, SEQ, "timeline"),
    ("zamba2-7b", "train"): (13, SEQ, "peak"),
    ("xlstm-125m", "prefill"): (8, 1024, "timeline"),
}


@pytest.mark.parametrize("arch, kind", sorted(EXTRAPOLATIONS))
def test_extrapolation_equals_the_full_depth_trace(arch, kind):
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    layers, seq, method = EXTRAPOLATIONS[arch, kind]
    run = _smoke(arch, remat="full")
    run = run.replace(model=dataclasses.replace(run.model, n_layers=layers))
    shape = ShapeSpec(kind, seq, 2, kind)
    costs = dr.cell_costs(run, shape, {"data": 1, "model": 1})
    by_length = arch == "xlstm-125m"
    assert costs["extrapolation"]["units"] == ([2] if by_length else [2, 3])
    assert costs["extrapolation"]["seq_len"] == (list(dr.LENGTHS[kind]) if by_length else None)
    assert costs["extrapolation"]["peak"] == method
    full = dr.trace_cell(run, shape, {"data": 1, "model": 1})
    assert costs["cost"].flops == full.flops
    assert costs["cost"].hbm_bytes == full.bytes
    assert full.arg_bytes + costs["temp_bytes"] == pytest.approx(full.peak_bytes, rel=1e-2)
    # these cells do not tell the two extrapolations apart: the affine peak
    # is exact here too (test_the_peak_needs_the_aligned_timelines does)
    affine = full.arg_bytes + costs["extrapolation"]["affine_temp_bytes"]
    assert affine == pytest.approx(full.peak_bytes, rel=1e-2)


def test_a_head_part_cells_collectives_are_extrapolated_in_the_length():
    """xlstm's smoke config at 2 heads on (1, 4), every cell on half of one
    head: its prefill's collectives (each mLSTM chunk's sums, each sLSTM
    step's gather) grow with the length, and the two lengths' traces
    extrapolate to the full length's counts and wire bytes, as the FLOPs."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    run = _smoke("xlstm-125m")
    run = run.replace(model=dataclasses.replace(run.model, n_layers=4, n_heads=2))
    shape, sizes = ShapeSpec("prefill", 1024, 2, "prefill"), {"data": 1, "model": 4}
    costs = dr.cell_costs(run, shape, sizes)
    assert costs["extrapolation"]["seq_len"] == list(dr.LENGTHS["prefill"])
    short = dr.trace_cell(run, shape, sizes, seq_len=dr.LENGTHS["prefill"][0])
    full = dr.trace_cell(run, shape, sizes)
    assert full.coll.counts["all-gather"] > short.coll.counts["all-gather"]
    assert costs["cost"].coll.counts == full.coll.counts
    assert costs["cost"].coll.wire_bytes == pytest.approx(full.coll.wire_bytes, rel=1e-9)
    assert costs["cost"].flops == full.flops


def test_the_peak_needs_the_aligned_timelines():
    """gemma2 at 24 layers with a small vocabulary: at 2 and 3 units the
    peak is the loss's, at 12 it is the backward pass's, so the affine peak
    of the two traces misses the full-depth trace by more than 10%; the
    aligned timelines give it within 1%."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    run = _smoke("gemma2-2b", remat="full")
    run = run.replace(model=dataclasses.replace(run.model, n_layers=24, vocab_size=2048))
    shape, one = ShapeSpec("train", 64, 2, "train"), {"data": 1, "model": 1}
    costs = dr.cell_costs(run, shape, one)
    assert costs["extrapolation"]["peak"] == "timeline"
    full = dr.trace_cell(run, shape, one)
    affine = full.arg_bytes + costs["extrapolation"]["affine_temp_bytes"]
    assert abs(affine / full.peak_bytes - 1) > 0.1
    assert full.arg_bytes + costs["temp_bytes"] == pytest.approx(full.peak_bytes, rel=1e-2)


def test_timeline_alignment_pairs_a_tandem_repeat_and_a_changed_point():
    """A block of ``s1`` repeated once in ``s2`` (the repeat found where the
    window first disagrees, before it starts), a point whose signature
    changed, and a timeline that is not of that form."""
    from repro_torch.launch import dryrun as dr
    pre, body, post = list(range(100, 140)), list(range(200, 230)), list(range(300, 340))
    s1 = pre + body + [7] + post
    s2 = pre + body + body + [8] + post
    pairs = dr.counterparts(s1, s2)
    got = {}
    for i, j in pairs:
        got.setdefault(i, []).append(j)
    assert sorted(got) == list(range(len(s1)))
    b0 = len(pre)
    assert all(got[b0 + k] == [b0 + k, b0 + len(body) + k] for k in range(len(body)))
    assert got[b0 + len(body)] == [b0 + 2 * len(body)]
    assert got[len(s1) - 1] == [len(s2) - 1]
    lives = dr.extrapolated_lives([1.0] * len(s1), [1.0] * b0 + [2.0] * (len(s2) - b0), pairs, 3)
    assert max(lives) == 4.0 and lives[0] == 1.0
    assert dr.counterparts(s1, pre + body + list(range(500, 540)) + post) is None


# --- the sharded Trainer on four gloo ranks --------------------------------------------------

def _variant_run(arch, overrides):
    from repro_torch.configs import get_smoke_config
    run = get_smoke_config(arch)
    return run.replace(parallel=dataclasses.replace(run.parallel, **overrides))


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    t = tree.to_local() if isinstance(tree, DTensor) else tree
    return t.numel() * t.element_size()


def ranks(rank, world, out, variants):
    """Each variant: a mesh Trainer's stored shards, and the collectives one
    sharded step issues, beside the dry run's predictions."""
    import torch.distributed as dist
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.trainer import Trainer

    class Collectives(TorchDispatchMode):
        """(kind, bytes, group) of every collective: in bytes for a
        reduce-scatter and an all-to-all, out bytes for an all-gather, the
        tensor's for an all-reduce."""

        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out_ = func(*args, **(kwargs or {}))
            name = func._schema.name
            if name == "_c10d_functional::all_gather_into_tensor":
                self.seen.append(("all-gather", out_.numel() * out_.element_size(), args[1]))
            elif name == "_c10d_functional::reduce_scatter_tensor":
                self.seen.append(("reduce-scatter", args[0].numel() * args[0].element_size(),
                                  args[2]))
            elif name == "_c10d_functional::all_reduce":
                group = dist.distributed_c10d._resolve_process_group(args[2]).size()
                self.seen.append(("all-reduce", args[0].numel() * args[0].element_size(), group))
            elif name == "_c10d_functional::all_to_all_single":
                group = dist.distributed_c10d._resolve_process_group(args[3]).size()
                self.seen.append(("all-to-all", args[0].numel() * args[0].element_size(), group))
            elif name == "c10d::allreduce_":
                nbytes = sum(t.numel() * t.element_size() for t in args[0])
                group = dist.ProcessGroup.unbox(args[1]).size()
                self.seen.append(("all-reduce", nbytes, group))
            elif "c10d" in name and not name.endswith(("wait_tensor", "_wrap_tensor_autograd")):
                self.seen.append((name, 0, 0))
            return out_

    mesh = make_local_mesh(2, 2, device="cpu")
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    shape = ShapeSpec("train", SEQ, BATCH, "train")
    res = {}
    for key, (arch, overrides) in variants.items():
        run = _variant_run(arch, overrides)
        tr = Trainer(run, shape, os.path.join(out, f"{key}_{rank}"), device="cpu", mesh=mesh,
                     checkpoint_async=False)
        held = {"params": _local_bytes(tr.params), "opt": _local_bytes(tr.opt_state)}
        batch = {k: torch.from_numpy(v) for k, v in tr.pipeline.batch(0).items()}
        counter = Collectives()
        with counter:
            tr._step_fn(tr.params, tr.opt_state, batch)
        seen = rl.CollectiveStats()
        for kind, nbytes, group in counter.seen:
            if group > 1:
                seen.add(kind, nbytes, group)
        stored = dr.state_bytes(run, shape, sizes)["stored"]
        res[key] = {"held": held, "predicted": {"params": stored["params"], "opt": stored["opt"]},
                    "seen": [seen.counts, seen.raw_bytes, seen.wire_bytes],
                    "unknown": [s for s in counter.seen if s[2] == 0]}
        tr.ckpt.close()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The ranks' records, each variant with ``want``: the collectives of
    the dry run's trace of rank 0's share of the same step, on the meta
    device under a fake group of four ranks."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    out = run_world(f"{HERE}:ranks", 4, tmp_path_factory.mktemp("world"), variants=VARIANTS)
    res = []
    for r in range(4):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            res.append(json.load(f))
    shape = ShapeSpec("train", SEQ, BATCH, "train")
    for key, (arch, overrides) in VARIANTS.items():
        want = dr.collectives_of(_variant_run(arch, overrides), shape, {"data": 2, "model": 2})
        for r in res:
            r[key]["want"] = [want.counts, want.raw_bytes, want.wire_bytes]
    return res


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_predicted_argument_bytes_equal_the_sharded_trainers_shards(variant, world):
    for r in world:
        assert r[variant]["predicted"] == r[variant]["held"]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_collectives_of_equals_the_sharded_steps(variant, world):
    for r in world:
        got = r[variant]
        assert not got["unknown"]
        _close(got["seen"], got["want"])
    if VARIANTS[variant][0] != "gemma2-2b":
        assert world[0][variant]["want"][0]["all-reduce"] > 10    # the MoE means


# --- records and the CLI ---------------------------------------------------------------------

RECORD_KEYS = {"arch", "shape", "mesh", "chips", "status", "trace_s", "extrapolation",
               "parallel", "memory", "cost_analysis", "collectives", "roofline"}
MEMORY_KEYS = {"argument_bytes", "param_bytes", "opt_bytes", "cache_bytes", "batch_bytes",
               "gathered_bytes", "temp_bytes", "peak_bytes", "hbm_limit_bytes", "fits"}
ROOFLINE_KEYS = {"t_comp_s", "t_mem_traced_s", "t_mem_s", "t_coll_s", "dominant_traced",
                 "dominant", "model_flops", "flops_global", "useful_flops_ratio",
                 "roofline_fraction_traced", "roofline_fraction", "collective_counts",
                 "collective_wire_bytes_per_device", "flops_per_device", "bytes_per_device",
                 "microbatches", "units_extrapolated"}


def test_cli_writes_the_record_of_smollm_train_4k(tmp_path, capsys):
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import mesh as meshmod
    dr.main(["--arch", "smollm-135m", "--shape", "train_4k", "--roofline", "--out",
             str(tmp_path)])
    assert "[ok] single_pod_16x16 smollm-135m train_4k" in capsys.readouterr().out
    with open(tmp_path / "single_pod_16x16__smollm-135m__train_4k.json") as f:
        rec = json.load(f)
    assert set(rec) == RECORD_KEYS and rec["status"] == "ok" and rec["chips"] == 256
    assert set(rec["memory"]) == MEMORY_KEYS and set(rec["roofline"]) == ROOFLINE_KEYS
    assert set(rec["cost_analysis"]) == {"flops_per_device", "bytes_per_device"}
    mem, roof = rec["memory"], rec["roofline"]
    assert mem["peak_bytes"] == pytest.approx(
        mem["argument_bytes"] + mem["gathered_bytes"] + mem["temp_bytes"])
    assert mem["argument_bytes"] == pytest.approx(
        sum(mem[k] for k in ("param_bytes", "opt_bytes", "cache_bytes", "batch_bytes")))
    run = get_config("smollm-135m")
    assert rec["parallel"]["local_batch"] == 256 // 16
    assert rec["parallel"]["attn_activation_mode"] == "off"
    assert roof["units_extrapolated"] == dr.full_units(run) == rec["extrapolation"]["full_units"]
    # the roofline at one microbatch (the config's is 2), from its own costs
    assert run.parallel.microbatches == 2 and roof["microbatches"] == 1
    assert roof["t_comp_s"] == pytest.approx(roof["flops_per_device"] / meshmod.PEAK_FLOPS_BF16)
    # --roofline-only recomputes the section from those costs: the same
    dr.main(["--arch", "smollm-135m", "--shape", "train_4k", "--roofline-only", "--out",
             str(tmp_path)])
    with open(tmp_path / "single_pod_16x16__smollm-135m__train_4k.json") as f:
        assert json.load(f)["roofline"] == roof
    assert roof["t_coll_s"] > 0 and rec["collectives"]["counts"]["all-gather"] > 0
    # smollm-135m's 9 heads do not divide by 16: its attention runs whole on
    # every model rank, and the all-reduces of d_model 576 activations over
    # model bound the cell
    assert rec["collectives"]["counts"]["all-reduce"] > 0 and roof["dominant"] == "collective"
    assert 0 < roof["roofline_fraction"] < 1 / 16 * 1.5


def test_a_train_cells_roofline_is_traced_at_one_microbatch(tmp_path):
    """gemma2-2b's smoke train cell at microbatches 2 on (2, 2), as the JAX
    package's ``run_cell`` and ``roofline_cell`` divide it: the roofline
    equals ``cell_costs`` of the same run at microbatches 1, and the memory,
    ``cost_analysis`` and collectives those of the microbatches-2 trace. The
    collective term differs: each layer's gathers and reduce-scatters run
    once a microbatch."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    run = _smoke("gemma2-2b", microbatches=2, remat="full")
    shape = ShapeSpec("train_smoke", SEQ, BATCH, "train")
    sizes = {"data": 2, "model": 2}
    rec = dr.run_cell("gemma2-2b", shape.name, False, True, str(tmp_path),
                      mesh=("data2_model2", sizes), run=run, shape=shape)
    one = dr.cell_costs(run.replace(parallel=dataclasses.replace(run.parallel, microbatches=1)),
                        shape, sizes)
    two = dr.cell_costs(run, shape, sizes)
    roof = rec["roofline"]
    assert roof["microbatches"] == 1
    assert roof["flops_per_device"] == one["cost"].flops
    assert roof["bytes_per_device"] == one["cost"].hbm_bytes
    assert roof["collective_counts"] == one["cost"].coll.counts
    assert roof["collective_wire_bytes_per_device"] == one["cost"].coll.wire_bytes
    assert rec["cost_analysis"] == {"flops_per_device": two["cost"].flops,
                                    "bytes_per_device": two["cost"].hbm_bytes}
    assert rec["collectives"]["counts"] == two["cost"].coll.counts
    assert rec["memory"] == dr.memory_record(run, shape, sizes, two["temp_bytes"],
                                             two["gathered_bytes"])
    assert rec["collectives"]["wire_bytes_per_device"] > roof["collective_wire_bytes_per_device"]
    assert dr.stored_cost(rec)[0].flops == roof["flops_per_device"]


# (arch, mesh, microbatches): a rank's attention score FLOPs under "batch"
# over "off": 1/model where the rows divide and the heads do not (smollm-135m's
# 3), the same where the heads divide (stablelm-12b's 4: each rank's share of
# heads x rows either way) or the rows do not (microbatches 2: 1 row a rank)
ATTN_SHARE = [("smollm-135m", (2, 2), 1, 1 / 2), ("smollm-135m", (1, 4), 1, 1 / 4),
              ("smollm-135m", (2, 2), 2, 1.0), ("smollm-135m", (1, 4), 2, 1.0),
              ("stablelm-12b", (1, 4), 1, 1.0)]


@pytest.mark.parametrize("arch, mesh, k, share", ATTN_SHARE)
def test_a_ranks_attention_flops_under_the_batch_mode(arch, mesh, k, share, monkeypatch):
    """Rank 0's train step traced on the meta device under "batch" and
    "off" (global batch 4): the FLOPs of the attention's score and PV
    products (a ``FlopCounterMode`` around each call of the plain
    attention's core), and where the mode applies, its all-to-alls (heads
    that divide) counted."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import attention as att
    real, seen = att._softmax_attend, []

    def counted(*a, **kw):
        with FlopCounterMode(display=False) as fc:
            out = real(*a, **kw)
        seen.append(fc.get_total_flops())
        return out

    monkeypatch.setattr(att, "_softmax_attend", counted)
    sizes = dict(zip(("data", "model"), mesh))
    flops, coll = {}, {}
    for mode in ("off", "batch"):
        seen.clear()
        tr = dr.trace_cell(_smoke(arch, microbatches=k, attn_activation_sharding=mode),
                           ShapeSpec("t", SEQ, BATCH, "train"), sizes)
        flops[mode], coll[mode] = sum(seen), tr.coll.counts
    assert flops["off"] > 0 and flops["batch"] == flops["off"] * share
    split_heads = arch == "stablelm-12b" and k == 1
    assert ("all-to-all" in coll["batch"]) == split_heads and "all-to-all" not in coll["off"]


# (arch, mesh): a rank's attention score FLOPs under "sequence" over "off",
# the last model rank traced: 1/model where the heads do not divide
# (smollm-135m's 3: the rank's query positions against every key instead of
# every position), the same where they divide (stablelm-12b's 4: every head
# of a quarter of the positions instead of a quarter of the heads)
SEQ_SHARE = [("smollm-135m", (2, 2), 1 / 2), ("smollm-135m", (1, 4), 1 / 4),
             ("stablelm-12b", (1, 4), 1.0), ("stablelm-12b", (2, 2), 1.0)]


@pytest.mark.parametrize("arch, mesh, share", SEQ_SHARE)
def test_a_ranks_attention_flops_under_the_sequence_mode(arch, mesh, share, monkeypatch):
    """The last model rank's train step traced on the meta device under
    "sequence" and "off" (sequence 32): the FLOPs of the plain attention's
    score and PV products, the ``q_offset`` each call is given (the rank's
    first global position under the mode), and, where the heads divide, the
    all-to-alls that move q and the output counted."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import attention as att
    real, seen, offsets = att.chunked_causal_attention, [], []

    def counted(*a, **kw):
        offsets.append(kw.get("q_offset", 0))
        with FlopCounterMode(display=False) as fc:
            out = real(*a, **kw)
        seen.append(fc.get_total_flops())
        return out

    monkeypatch.setattr(att, "chunked_causal_attention", counted)
    sizes = dict(zip(("data", "model"), mesh))
    shape = ShapeSpec("t", SEQ, BATCH, "train")
    flops, coll = {}, {}
    for mode in ("off", "sequence"):
        seen.clear()
        offsets.clear()
        run = _smoke(arch, microbatches=1, attn_activation_sharding=mode)
        tr = dr.trace_cell(run, shape, sizes)
        flops[mode], coll[mode] = sum(seen), tr.coll.counts
        last = mesh[1] - 1
        assert dr.traced_rank(run, shape, sizes)[0] == (last if mode == "sequence" else 0)
        want = last * SEQ // mesh[1] if mode == "sequence" else 0
        assert offsets and set(offsets) == {want}, (mode, offsets)
    assert flops["off"] > 0 and flops["sequence"] == flops["off"] * share
    split_heads = arch == "stablelm-12b"
    assert ("all-to-all" in coll["sequence"]) == split_heads and "all-to-all" not in coll["off"]


@pytest.mark.parametrize("arch", ["gemma2-2b", "stablelm-12b"])
def test_8bit_cells_gather_less_with_the_state_on_its_shards(arch, monkeypatch):
    """An ``adamw_8bit`` train cell on (2, 2): the traced bytes of all-gather
    outputs alive at once fall below those of the same step with every leaf
    gathered whole for its update (``steps.block_shards`` patched to place
    none), by the whole tied table (gemma2-2b) or untied head and table
    (stablelm-12b) it no longer gathers; the shards' codes move by
    all-to-all."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.launch import dryrun as dr
    from repro_torch.train import steps
    run = _smoke(arch, microbatches=1, optimizer_state="adamw_8bit")
    shape = ShapeSpec("t", SEQ, BATCH, "train")
    sizes = {"data": 2, "model": 2}
    shards = dr.trace_cell(run, shape, sizes)
    monkeypatch.setattr(steps, "block_shards", lambda *a, **kw: None)
    whole = dr.trace_cell(run, shape, sizes)
    assert shards.gathered_bytes < whole.gathered_bytes
    assert shards.coll.counts["all-to-all"] > 0 and "all-to-all" not in whole.coll.counts
    assert shards.coll.counts["all-gather"] < whole.coll.counts["all-gather"]


def test_prefill_model_flops_count_the_read_out_at_the_last_position(tmp_path):
    """gemma2-2b's prefill at 2 x 4352 on one device (``chip_smoke.py``'s
    cell): the model FLOPs count the read-out once a row, so the counted
    FLOPs are at least the model FLOPs (useful ratio and traced fraction at
    most 1); a train and a decode step keep 6 N D and 2 N D."""
    from repro_torch.common.config import ShapeSpec
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import roofline as rl
    from repro_torch.models.model import count_params_analytic
    run = get_config("gemma2-2b")
    shape = ShapeSpec("prefill_card", 4352, 2, "prefill")
    rec = dr.run_cell("gemma2-2b", shape.name, False, True, str(tmp_path),
                      mesh=("one_device", {"data": 1, "model": 1}), run=run, shape=shape)
    n = count_params_analytic(run.model, active_only=True)
    vd = run.model.vocab_size * run.model.d_model
    roof = rec["roofline"]
    assert roof["model_flops"] == 2 * (n - vd) * 2 * 4352 + 2 * vd * 2
    assert roof["useful_flops_ratio"] <= 1 and roof["roofline_fraction_traced"] <= 1
    for kind, tokens, factor in (("train", 2 * 4096, 6), ("decode", 2, 2)):
        assert rl.step_model_flops(run.model, n, ShapeSpec(kind, 4096, 2, kind)) == \
            factor * n * tokens


def test_skipped_by_design_exactly_where_the_shape_does_not_apply(tmp_path, monkeypatch):
    from repro_torch.common.config import SHAPES, shape_applicable
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import roofline as rl
    monkeypatch.setattr(dr, "cell_costs", lambda run, shape, sizes: {
        "cost": rl.CostTerms(1.0, 1.0), "temp_bytes": 0.0, "gathered_bytes": 0.0,
        "trace_s": 0.0, "extrapolation": {"full_units": 1}})
    monkeypatch.setattr(dr, "memory_record", lambda *a: dict.fromkeys(
        ("argument_bytes", "gathered_bytes", "peak_bytes", "fits"), 0))
    skipped = 0
    for arch in ARCHS:
        for name, shape in SHAPES.items():
            rec = dr.run_cell(arch, name, False, False, str(tmp_path))
            applies = shape_applicable(get_config(arch).model, shape)
            assert rec["status"] == ("ok" if applies else "skipped_by_design"), (arch, name)
            skipped += not applies
    assert skipped == 6
