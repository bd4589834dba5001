"""The training slice of the port against the JAX package, on the CPU.

Everything runs in float32 on the smoke configs (seq 32, above the smoke
window of 16, so local layers mask). The JAX ``LM`` needs
``repro.models.transformer.shard_activations`` patched to the identity on
this jax (as in test_torch_serve.py); ``repro.train.steps`` does not import
here (it needs ``jax_compat``), so the JAX train step is built in this file
from ``lm_loss``, ``clip_by_global_norm``, ``warmup_cosine`` and
``apply_updates`` as ``repro/train/steps.py`` composes them.

Tolerances (both sides fp32; they differ only in the order of sums):
loss 1e-5; gradients per leaf ||g_port - g_jax|| / ||g_jax|| <= 1e-4 (small
leaves such as norm scales sum many products); AdamW and the schedule 1e-6;
two train steps: losses and parameters 1e-5. The data pipeline is
byte-equal; checkpoints restore bit-exact; a restarted Trainer repeats the
first run's losses exactly.
"""
import collections
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as jax_configs
import repro.models.model as jax_model
import repro.models.moe as jax_moe
import repro.models.transformer as jax_transformer
from repro.common.config import ShapeSpec as JaxShapeSpec
from repro.data import pipeline as jax_pipeline
from repro.optim import adamw as jax_adamw
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.config import ShapeSpec
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline as torch_pipeline
from repro_torch.kernels import rmsnorm as rmsnorm_mod
from repro_torch.launch import train as train_cli
from repro_torch.models import model as torch_model
from repro_torch.models.model import _chunked_ce, build_model, lm_loss
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step
from repro_torch.train.trainer import Trainer

SEQ, BATCH = 32, 2


@pytest.fixture
def no_shard(monkeypatch):
    monkeypatch.setattr(jax_transformer, "shard_activations", lambda x: x)
    monkeypatch.setattr(jax_moe, "_maybe_shard", lambda x, spec: x)


def _run(arch, **parallel):
    run = get_smoke_config(arch)
    return run.replace(parallel=dataclasses.replace(run.parallel, param_dtype="float32",
                                                    **parallel))


def _gated(params, seed=3):
    """``params`` with every cross-attention ``gate`` and ``ffn_gate`` drawn
    from N(0, 1): at the JAX init they are zero and a cross block is the
    identity. Other trees come back unchanged."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.normal(0, 1, a.shape), a.dtype)
        if path[-1].key in ("gate", "ffn_gate") else a, params)


def _pair(arch, **parallel):
    """The JAX LM with fp32 params from a key (the cross gates drawn
    non-zero), and the port's model loaded with the same values."""
    jrun = jax_configs.get_smoke_config(arch)
    jrun = jrun.replace(parallel=dataclasses.replace(jrun.parallel, param_dtype="float32",
                                                     **parallel))
    jm = jax_model.build_model(jrun, use_kernel=False)
    params = _gated(jm.init(jax.random.key(0)))
    run = _run(arch, **parallel)
    model = build_model(run, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), run.model))
    return jrun, jm, params, run, model


def _batch(cfg, seed=1):
    """The JAX package's synthetic train batch (tokens, or the audio family's
    bf16 embeddings and labels) and the same bytes as torch tensors."""
    jb = jax_model.synthetic_batch(cfg, JaxShapeSpec("t", SEQ, BATCH, "train"), seed=seed)

    def to_torch(a):
        a = np.array(a)
        if a.dtype == jnp.bfloat16:
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        return torch.from_numpy(a)
    return jb, {k: to_torch(v) for k, v in jb.items()}


def _leaf_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


# --- loss and gradients -------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_jax(arch, no_shard):
    jrun, jm, params, run, model = _pair(arch)
    jb, tb = _batch(jrun.model)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model.lm_loss(jm, p, b), has_aux=True))(params, jb)
    loss, metrics = lm_loss(model, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    moe = {"moe_lb_loss", "moe_z_loss"} if run.model.moe is not None else set()
    assert set(metrics) == set(jmet) == {"ce_loss", "loss"} | moe
    for key in jmet:
        np.testing.assert_allclose(metrics[key].item(), float(jmet[key]), rtol=1e-5, err_msg=key)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), run.model)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    worst = max((_leaf_rel(got[n], want[n]), n) for n in want)
    assert worst[0] <= 1e-4, worst


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "zamba2-7b", "xlstm-125m"])
def test_remat_full_gradients_match_jax(arch, no_shard):
    """Remat ``full`` (each block recomputed in the backward pass; zamba2's
    shared block at each of its applications) against ``jax.grad`` of
    ``lm_loss`` under the JAX package's ``nothing_saveable``: loss 1e-5,
    gradients by the per-leaf tolerance above (the shared block's sum over
    its applications among them)."""
    jrun, jm, params, run, model = _pair(arch, remat="full")
    jb, tb = _batch(jrun.model)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model.lm_loss(jm, p, b)[0]))(params, jb)
    loss, _ = lm_loss(model, tb)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), run.model)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    worst = max((_leaf_rel(got[n], want[n]), n) for n in want)
    assert worst[0] <= 1e-4, worst


def test_chunked_ce_pads_and_masks_the_tail_as_jax(no_shard):
    """A chunk of 8 over 31 positions: 4 chunks, the last padded by one."""
    jrun, jm, params, run, model = _pair("gemma2-2b")
    rng = np.random.default_rng(3)
    hidden = rng.normal(0, 1, (BATCH, 31, run.model.d_model)).astype(np.float32)
    labels = rng.integers(0, run.model.vocab_size, (BATCH, 31)).astype(np.int32)
    want = jax_model._chunked_ce(jm, params, jnp.asarray(hidden), jnp.asarray(labels), chunk=8)
    h = torch.from_numpy(hidden).requires_grad_()
    got = _chunked_ce(model, h, torch.from_numpy(labels), chunk=8)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    got.backward()
    jgrad = jax.grad(lambda x: jax_model._chunked_ce(jm, params, x, jnp.asarray(labels),
                                                      chunk=8))(jnp.asarray(hidden))
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(jgrad), atol=1e-6, rtol=1e-4)


def test_remat_full_and_none_give_equal_gradients_and_recompute_the_block_norms(monkeypatch):
    """And ``dots``: it recomputes the block norms as ``full`` does (the
    RMSNorm launches run outside the dispatcher, so its policy cannot save
    them)."""
    calls = []
    fwd = rmsnorm_mod.rmsnorm_fwd
    monkeypatch.setattr(rmsnorm_mod, "rmsnorm_fwd", lambda *a: calls.append(1) or fwd(*a))
    tokens = {"tokens": torch.from_numpy(
        np.random.default_rng(4).integers(0, 512, (BATCH, SEQ)).astype(np.int32))}
    grads, norms = {}, {}
    for remat in ("none", "full", "dots"):
        model = build_model(_run("gemma2-2b", remat=remat), device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        calls.clear()
        loss, _ = lm_loss(model, tokens)
        loss.backward()
        norms[remat] = len(calls)
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
    for remat in ("full", "dots"):
        for n, g in grads["none"].items():
            torch.testing.assert_close(grads[remat][n], g, atol=1e-6, rtol=1e-6)
    n_layers = model.cfg.n_layers
    # 4 norms a block + the final norm; remat full and dots run each block's 4 again
    assert norms == {"none": 4 * n_layers + 1, "full": 8 * n_layers + 1,
                     "dots": 8 * n_layers + 1}


NEW_ARCHS = ["yi-34b", "stablelm-12b", "musicgen-medium"]


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_gradients_match_none_and_jax_dots(arch, no_shard):
    """``dots`` against ``none`` in the port (1e-6), and against ``jax.grad``
    of ``lm_loss`` under the JAX package's ``dots_with_no_batch_dims_saveable``
    (the gradient tolerance above)."""
    jrun, jm, params, run, model = _pair(arch, remat="dots")
    jb, tb = _batch(jrun.model)
    jgrads = jax.jit(jax.grad(lambda p, b: jax_model.lm_loss(jm, p, b)[0]))(params, jb)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), run.model)
    got = {}
    for remat in ("dots", "none"):
        model.remat = remat
        model.zero_grad(set_to_none=True)
        lm_loss(model, tb)[0].backward()
        got[remat] = {n: p.grad for n, p in model.named_parameters()}
    for n, g in got["none"].items():
        torch.testing.assert_close(got["dots"][n], g, atol=1e-6, rtol=1e-6, msg=n)
    worst = max((_leaf_rel(got["dots"][n], want[n]), n) for n in want)
    assert worst[0] <= 1e-4, worst


class _OpCounts(TorchDispatchMode):
    """Counts the aten ops dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_remat_dots_recomputes_the_bmm_and_norms_but_no_mm(arch, monkeypatch):
    """The backward pass under ``dots`` makes as many ``aten.mm`` as under
    ``none`` (the saved projections are not recomputed) and repeats every
    ``aten.bmm`` of the forward pass (the attention's score and PV einsums)
    and every block norm; ``full`` repeats the projections too."""
    calls = []
    fwd = rmsnorm_mod.rmsnorm_fwd
    monkeypatch.setattr(rmsnorm_mod, "rmsnorm_fwd", lambda *a: calls.append(1) or fwd(*a))
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    run = _run(arch)
    batch = torch_model.synthetic_batch(run.model, ShapeSpec("t", SEQ, BATCH, "train"),
                                        seed=2, device="cpu")
    fwd_n, bwd_n, norms = {}, {}, {}
    for remat in ("none", "dots", "full"):
        model = build_model(_run(arch, remat=remat), device="cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        calls.clear()
        with _OpCounts() as f:
            loss, _ = lm_loss(model, batch)
        with _OpCounts() as b:
            loss.backward()
        fwd_n[remat], bwd_n[remat], norms[remat] = f.n, b.n, len(calls)
    assert fwd_n["dots"][bmm] > 0 and fwd_n["dots"][mm] > 0
    assert bwd_n["dots"][mm] == bwd_n["none"][mm] < bwd_n["full"][mm]
    assert bwd_n["dots"][bmm] == bwd_n["none"][bmm] + fwd_n["dots"][bmm] == bwd_n["full"][bmm]
    per_block = 2 + 2 * run.model.qk_norm
    n_layers = run.model.n_layers
    assert norms == {"none": per_block * n_layers + 1, "dots": 2 * per_block * n_layers + 1,
                     "full": 2 * per_block * n_layers + 1}


def test_chunked_train_attention_gradients_match_jax():
    """Several query chunks, each under a checkpoint, as the JAX scan body."""
    from repro.models.attention import chunked_causal_attention as jax_chunked
    from repro_torch.models.attention import chunked_causal_attention as torch_chunked
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(0, 1, (2, 40, h, 16)).astype(np.float32) for h in (4, 2, 2))
    kw = dict(window=12, logit_cap=50.0, scale=0.25, q_chunk=16)
    jgrads = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_chunked(*a, **kw))), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch.sin(torch_chunked(*ts, **kw)).sum().backward()
    for t, want in zip(ts, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# --- optimizer ----------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 50, 99, 100, 500, 1000, 1200])
def test_warmup_cosine_matches_jax(step):
    kw = dict(base_lr=3e-4, warmup=100, total=1000)
    np.testing.assert_allclose(adamw.warmup_cosine(step, **kw).item(),
                               float(jax_adamw.warmup_cosine(step, **kw)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["adamw", "adamw_factored", "adamw_8bit"])
def test_adamw_three_updates_match_jax(kind):
    rng = np.random.default_rng(6)
    shapes = {"w": (64, 32), "b": (32,), "stack": (3, 8, 100)}
    p0 = {n: rng.normal(0, 1, s).astype(np.float32) for n, s in shapes.items()}
    cfg, jcfg = adamw.OptimizerConfig(kind=kind), jax_adamw.OptimizerConfig(kind=kind)
    params = {n: torch.from_numpy(a.copy()) for n, a in p0.items()}
    jparams = {n: jnp.asarray(a) for n, a in p0.items()}
    state, jstate = adamw.init_state(cfg, params), jax_adamw.init_state(jcfg, jparams)
    for i in range(3):
        g = {n: rng.normal(0, 1e-2, s).astype(np.float32) for n, s in shapes.items()}
        tg, jg = {n: torch.from_numpy(a) for n, a in g.items()}, {
            n: jnp.asarray(a) for n, a in g.items()}
        tg, norm = adamw.clip_by_global_norm(tg, 0.5)
        jg, jnorm = jax_adamw.clip_by_global_norm(jg, 0.5)
        np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
        kw = dict(base_lr=1e-2, warmup=2, total=10)
        lr, jlr = adamw.warmup_cosine(state["step"], **kw), jax_adamw.warmup_cosine(
            jstate["step"], **kw)
        params, state = adamw.apply_updates(cfg, params, tg, state, lr)
        jparams, jstate = jax_adamw.apply_updates(jcfg, jparams, jg, jstate, jlr)
        assert int(state["step"]) == int(jstate["step"]) == i + 1
        for n in shapes:
            np.testing.assert_allclose(params[n].numpy(), np.asarray(jparams[n]),
                                       atol=1e-6, rtol=1e-6, err_msg=f"{kind} {n} update {i}")
            for key, val in state["m"][n].items():
                np.testing.assert_allclose(val.float().numpy(),
                                           np.asarray(jstate["m"][n][key], np.float32),
                                           atol=1e-6, rtol=1e-6, err_msg=f"{n}/{key}")
    assert adamw.state_bytes_per_param(kind) == jax_adamw.state_bytes_per_param(kind)


def test_q8_rounds_half_to_even_as_jax():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.0], np.float32)
    q, s = adamw._q8_encode(torch.from_numpy(x), 8)
    jq, js = jax_adamw._q8_encode(jnp.asarray(x), 8)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(adamw._q8_decode(q, s, (7,), 8).numpy(),
                                  np.asarray(jax_adamw._q8_decode(jq, js, (7,), 8)))


# --- the composed train step ----------------------------------------------------

def _jax_train_step(jm, jrun, opt_cfg):
    """repro/train/steps.py's step (no compression), microbatches as a loop."""
    k, tcfg = jrun.parallel.microbatches, jrun.train

    def step(params, opt_state, batch):
        mbs = jax.tree.map(lambda x: x.reshape((k, x.shape[0] // k) + x.shape[1:]), batch)
        acc = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
        for i in range(k):
            (_, metrics), g = jax.value_and_grad(
                lambda p: jax_model.lm_loss(jm, p, jax.tree.map(lambda x: x[i], mbs)),
                has_aux=True)(params)
            acc = jax.tree.map(lambda a, b: a + b.astype(jnp.float32), acc, g)
        grads = jax.tree.map(lambda g: g / k, acc)
        grads, gnorm = jax_adamw.clip_by_global_norm(grads, tcfg.grad_clip_norm)
        lr = jax_adamw.warmup_cosine(opt_state["step"], base_lr=tcfg.learning_rate,
                                     warmup=tcfg.warmup_steps, total=tcfg.total_steps)
        params, opt_state = jax_adamw.apply_updates(opt_cfg, params, grads, opt_state, lr)
        return params, opt_state, dict(metrics, grad_norm=gnorm, lr=lr)
    return jax.jit(step)


def test_two_train_steps_match_a_jax_step(no_shard):
    """Microbatches 2, remat full, a learning rate of 1e-4 from the first
    step (warm-up 1): each parameter moves by ~1e-4 a step, ten times the
    tolerance (a missing bias correction alone would be off by 5e-5). A
    larger rate does not fit the elementwise tolerance: where a gradient
    entry is near 0, Adam's step, ~g / (|g| + eps), magnifies the fp32
    difference in the order of sums (at 1e-3, one entry of 8192 in an MLP
    weight differs by 1.6e-5)."""
    jrun, jm, params, run, model = _pair("gemma2-2b", microbatches=2, remat="full")
    train = dict(warmup_steps=1, learning_rate=1e-4)
    jrun = jrun.replace(train=dataclasses.replace(jrun.train, **train))
    run = run.replace(train=dataclasses.replace(run.train, **train))
    jcfg, cfg = jax_adamw.OptimizerConfig(), adamw.OptimizerConfig()
    jstep, step = _jax_train_step(jm, jrun, jcfg), make_train_step(model, run, cfg)
    jstate = jax_adamw.init_state(jcfg, params)
    tparams = dict(model.named_parameters())
    state = adamw.init_state(cfg, tparams)
    p0 = {n: p.detach().clone() for n, p in tparams.items()}
    for i in range(2):
        jb, tb = _batch(jrun.model, seed=10 + i)
        params, jstate, jmet = jstep(params, jstate, jb)
        tparams, state, met = step(tparams, state, tb)
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(met[key].item(), float(jmet[key]), rtol=1e-5,
                                       err_msg=f"step {i} {key}")
    want = params_from_jax(jax.tree.map(np.asarray, params), run.model)
    for n, p in tparams.items():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=n)
    moved = max((tparams[n] - p0[n]).abs().max().item() for n in p0)
    assert moved > 1e-4          # the updates are above the tolerance


def test_int8_grad_compression_is_refused():
    run = _run("gemma2-2b", grad_compression="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_train_step(build_model(run, device="cpu"), run, adamw.OptimizerConfig())


# --- data ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_pipeline_batches_are_byte_equal_to_jax(arch):
    """Tokens; for the audio family float32 embeddings (salt 0) and int32
    labels (salt 1); for the vlm family tokens (salt 0) and float32
    ``vision_embed`` (salt 1)."""
    cfg = get_smoke_config(arch).model
    jcfg = jax_configs.get_smoke_config(arch).model
    kw = dict(seed=7, n_hosts=2)
    tp = torch_pipeline.TokenPipeline(cfg, ShapeSpec("t", 64, 4, "train"),
                                      torch_pipeline.PipelineConfig(**kw))
    jp = jax_pipeline.TokenPipeline(jcfg, JaxShapeSpec("t", 64, 4, "train"),
                                    jax_pipeline.PipelineConfig(**kw))
    keys = {"embeddings", "labels"} if cfg.family == "audio" else {"tokens"}
    if cfg.cross_attn_every:
        keys.add("vision_embed")
    for step in (0, 1, 7, 1000):
        got, want = tp.batch(step), jp.batch(step)
        assert got.keys() == want.keys() == keys
        for key in keys:
            assert got[key].dtype == want[key].dtype
            assert got[key].dtype == (np.float32 if key in ("embeddings", "vision_embed")
                                      else np.int32)
            assert got[key].tobytes() == want[key].tobytes()
            for host in (0, 1):
                assert (tp.host_batch(step, host)[key].tobytes()
                        == jp.host_batch(step, host)[key].tobytes())
    for key in keys:
        assert tp.batch(1)[key].tobytes() != tp.batch(0)[key].tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_synthetic_batches_are_byte_equal_to_jax(arch):
    """bf16 embeddings included: both round numpy's float64 draws the same way."""
    cfg, jcfg = get_smoke_config(arch).model, jax_configs.get_smoke_config(arch).model
    for kind in ("train", "prefill", "decode"):
        got = torch_model.synthetic_batch(cfg, ShapeSpec("t", SEQ, BATCH, kind), seed=3,
                                          device="cpu")
        want = jax_model.synthetic_batch(jcfg, JaxShapeSpec("t", SEQ, BATCH, kind), seed=3)
        assert got.keys() == want.keys()
        for key, w in want.items():
            w = np.asarray(w)
            g = got[key]
            assert tuple(g.shape) == w.shape and str(g.dtype)[6:] == str(w.dtype), key
            gb = g.view(torch.int16).numpy() if g.dtype == torch.bfloat16 else g.numpy()
            assert gb.tobytes() == w.tobytes(), (kind, key)


# --- checkpoints ----------------------------------------------------------------------

def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"blocks.0.w": torch.randn(5, 7, generator=g),
                       "embed.table": torch.randn(9, 4, generator=g).bfloat16()},
            "opt": {"step": torch.tensor(seed, dtype=torch.int32),
                    "m": {"blocks.0.w": {"mu_q": torch.randint(-127, 128, (3, 256),
                                                               generator=g).to(torch.int8)}}},
            "step": np.asarray(seed)}


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_tree_equal(got[k], want[k])
        return
    want = want if isinstance(want, torch.Tensor) else torch.from_numpy(np.asarray(want))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8) if got.dtype == torch.bfloat16 else got,
                       want.view(torch.uint8) if want.dtype == torch.bfloat16 else want)


def test_checkpoint_round_trip_is_bit_exact_from_memory_and_disk(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_disk=False)
    tree = _tree(3)
    ckpt.save(3, tree)
    tree["params"]["blocks.0.w"].add_(1.0)       # the replica is a copy
    s, got = ckpt.restore(_tree(0))
    assert s == 3
    _assert_tree_equal(got, _tree(3))
    s, got = CheckpointManager(str(tmp_path), keep=2).restore(_tree(0))   # from disk
    assert s == 3
    _assert_tree_equal(got, _tree(3))
    manifest = json.loads((tmp_path / "ckpt_00000003.json").read_text())["leaves"]
    assert manifest["params/embed.table"]["dtype"] == "bfloat16"
    assert manifest["opt/m/blocks.0.w/mu_q"]["dtype"] == "int8"


def test_checkpoint_keeps_the_last_n_in_memory_and_on_disk(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_disk=False)
    for s in (0, 2, 4, 6):
        ckpt.save(s, _tree(s))
    assert sorted(ckpt.memory) == ckpt.disk_steps() == [4, 6]
    assert sorted(os.listdir(tmp_path)) == [f"ckpt_0000000{s}.{e}" for s in (4, 6)
                                            for e in ("json", "npz")]
    assert ckpt.save_count == 4


@pytest.mark.parametrize("damage", ["bytes flipped", "truncated"])
def test_corrupt_newest_checkpoint_falls_back_to_the_previous_valid_one(tmp_path, damage):
    CheckpointManager(str(tmp_path), keep=3, async_disk=False).save(1, _tree(1))
    CheckpointManager(str(tmp_path), keep=3, async_disk=False).save(2, _tree(2))
    path = tmp_path / "ckpt_00000002.npz"
    data = bytearray(path.read_bytes())
    if damage == "truncated":
        data = data[: len(data) // 2]
    else:
        i = data.index(np.asarray(_tree(2)["params"]["blocks.0.w"]).tobytes()[:16])
        data[i:i + 4] = bytes(4)
    path.write_bytes(bytes(data))
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    assert ckpt.disk_steps() == [1, 2]
    s, got = ckpt.restore(_tree(0))
    assert s == 1
    _assert_tree_equal(got, _tree(1))
    with pytest.raises(FileNotFoundError):
        ckpt.restore_flat(step=2)


def test_async_flush_then_wait(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=3, async_disk=True)
    for s in (5, 6):
        ckpt.save(s, _tree(s))
    ckpt.wait()
    assert ckpt.disk_steps() == [5, 6]
    _assert_tree_equal(CheckpointManager(str(tmp_path)).restore(_tree(0))[1], _tree(6))
    ckpt.close()


def test_a_failed_flush_raises_on_wait(tmp_path, monkeypatch):
    ckpt = CheckpointManager(str(tmp_path), async_disk=True)

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", boom)
    ckpt.save(1, _tree(1))
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    assert 1 in ckpt.memory


# --- Trainer and entry point --------------------------------------------------------

def _trainer_run(checkpoint_every=2):
    run = get_smoke_config("gemma2-2b")
    return run.replace(train=dataclasses.replace(run.train, checkpoint_every=checkpoint_every))


def test_trainer_restart_repeats_the_losses(tmp_path):
    """Four steps with a checkpoint every two; a new Trainer restored at step
    2 re-runs steps 2-3 with the first run's losses: the deterministic
    restart the paper relies on."""
    run = _trainer_run()
    shape = ShapeSpec("train", run.train.seq_len, run.train.global_batch, "train")
    first = Trainer(run, shape, str(tmp_path), device="cpu")
    losses = first.train(4).losses
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert first.ckpt.disk_steps() == [0, 2, 4] and first.ckpt.save_count == 3
    assert first.monitor.summary()["steps"] == 4

    again = Trainer(run, shape, str(tmp_path), device="cpu")
    assert again.restore(step=2) == 2 and again.step == 2
    assert again.train(2).losses == losses[2:]
    for n, p in again.params.items():
        assert torch.equal(p, first.params[n]), n


def test_train_cli_on_cpu_prints_the_jax_keys(tmp_path, capsys):
    train_cli.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu", "--steps", "2",
                    "--workdir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"arch", "steps_run", "restarts", "first_loss", "last_loss",
                        "detections", "step_stats", "checkpoints_saved"}
    assert out["steps_run"] == 2 and out["restarts"] == 0 and out["checkpoints_saved"] == 1
    assert np.isfinite(out["last_loss"])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_cli_trains_the_dense_and_audio_archs_on_cpu(arch, tmp_path, capsys):
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                    "--workdir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"arch", "steps_run", "restarts", "first_loss", "last_loss",
                        "detections", "step_stats", "checkpoints_saved"}
    assert out["arch"] == get_smoke_config(arch).model.name
    assert out["steps_run"] == 2 and out["restarts"] == 0
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "zamba2-7b", "xlstm-125m"])
def test_train_cli_trains_the_vision_hybrid_and_recurrent_archs_on_cpu(arch, tmp_path, capsys):
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                    "--workdir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == get_smoke_config(arch).model.name
    assert out["steps_run"] == 2 and out["restarts"] == 0
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


@pytest.mark.parametrize("argv,message", [(["--data", "2"], "must be 1")])
def test_train_cli_refuses_what_is_not_ported(argv, message, tmp_path, capsys):
    with pytest.raises(SystemExit):
        train_cli.main(["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
                        "--workdir", str(tmp_path), *argv])
    assert message in capsys.readouterr().err


def test_train_entry_points_raise_without_gpu_at_default_device(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a CUDA device")
    run = _trainer_run()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(run, ShapeSpec("t", 16, 2, "train"), str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--arch", "gemma2-2b", "--smoke", "--workdir", str(tmp_path)])
