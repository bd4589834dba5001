"""The port's MoE (``repro_torch.models.moe``) against ``repro.models.moe``, on the CPU.

The same numpy inputs and weights go through the JAX functions and the port,
in float32 at the smoke configs' sizes (arctic-smoke: 8 experts, top 2, a
dense residual; deepseek-smoke: 8 experts, top 2, a shared expert).
Tolerance 1e-5 (atol = rtol), as in test_torch_models.py; the routing and
dispatch integers must be equal. XLA and torch compute the router logits in
another order of sums, so a token whose k-th and (k+1)-th logits are closer
than twice the largest difference of the two sides' logits may take another
expert: such a near tie is the only disagreement a routing test accepts.

``repro.models.transformer.shard_activations`` and ``repro.models.moe._maybe_shard``
are patched to the identity where the JAX ``LM`` runs: on this jax they fail
without a mesh, and with no mesh they return their input unchanged.
"""
import collections
import dataclasses
import json

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
from repro_torch.configs import get_smoke_config
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import moe as torch_moe
from repro_torch.models.model import build_model, lm_loss

TOL = 1e-5
MOE_ARCHS = ["arctic-480b", "deepseek-v2-236b"]


@pytest.fixture
def no_shard(monkeypatch):
    monkeypatch.setattr(jax_transformer, "shard_activations", lambda x: x)
    monkeypatch.setattr(jax_moe, "_maybe_shard", lambda x, spec: x)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _cfgs(arch):
    return (jax_configs.get_smoke_config(arch).model, get_smoke_config(arch).model)


def _moe_pair(arch, seed=0):
    """A JAX ``init_moe`` tree (float32) and the port's ``MoE`` holding it."""
    jcfg, tcfg = _cfgs(arch)
    p = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.key(seed), jcfg, jnp.float32))
    moe = torch_moe.MoE(tcfg, torch.float32, "cpu")
    moe.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _flatten(p)})
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), moe


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _assert_same_routes(got_idx, want_idx, logits, tol_logits, k):
    """Equal expert ids, except at tokens where the JAX side's k-th and
    (k+1)-th logits are a near tie (closer than 2 x the largest difference
    of the two sides' logits)."""
    got, want = got_idx.numpy(), np.asarray(want_idx)
    differ = (got != want).any(-1)
    if not differ.any():
        return
    srt = -np.sort(-np.asarray(logits), axis=-1)
    gap = srt[..., k - 1] - srt[..., k]
    margin = 2 * tol_logits
    assert (gap[differ] < margin).all(), (gap[differ], margin)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_topk_matches_jax(arch, seed):
    jcfg, tcfg, jp, moe = _moe_pair(arch, seed)
    x = _x((2, 24, jcfg.d_model), seed + 10)
    jgates, jidx, jaux = jax_moe.route_topk(jp["router"], jnp.asarray(x), jcfg.moe)
    gates, idx, aux = torch_moe.route_topk(moe.router, torch.from_numpy(x), tcfg.moe)
    jlogits = jnp.asarray(x) @ jp["router"]
    tlogits = torch.from_numpy(x) @ moe.router
    diff = float(np.abs(tlogits.detach().numpy() - np.asarray(jlogits)).max())
    _assert_same_routes(idx, jidx, jlogits, diff, jcfg.moe.top_k)
    same = (idx.numpy() == np.asarray(jidx)).all(-1)
    _close(gates[same], np.asarray(jgates)[same])
    assert set(aux) == set(jaux) == {"moe_lb_loss", "moe_z_loss"}
    for key in jaux:
        _close(aux[key], jaux[key], msg=key)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_topk_takes_exact_ties_toward_the_lower_index_as_lax_top_k(k):
    """Experts 1, 3 and 6 share one router column and 2 and 5 another, so
    their logits (and probabilities) are bit-equal: the top k must be the
    lower indices first, as ``lax.top_k`` takes them."""
    m = dataclasses.replace(get_smoke_config("arctic-480b").model.moe, top_k=k)
    rng = np.random.default_rng(4)
    router = rng.normal(0, 0.3, (16, m.num_experts)).astype(np.float32)
    router[:, 1] += 5.0
    router[:, 3] = router[:, 6] = router[:, 1]
    router[:, 5] = router[:, 2]
    x = np.abs(rng.normal(0, 1, (1, 5, 16))).astype(np.float32)
    _, jidx, _ = jax_moe.route_topk(jnp.asarray(router), jnp.asarray(x), m)
    _, idx, _ = torch_moe.route_topk(torch.from_numpy(router), torch.from_numpy(x), m)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy()[0, :, :min(k, 3)],
                                  np.tile([1, 3, 6][:k], (5, 1)))


@pytest.mark.parametrize("capacity", [1, 3, 8, 64])
@pytest.mark.parametrize("experts,k", [(8, 2), (16, 6)])
def test_dispatch_indices_equal_jax_as_integers(capacity, experts, k):
    rng = np.random.default_rng(capacity + experts)
    # top-k picks distinct experts per token
    idx = np.stack([np.stack([rng.permutation(experts)[:k] for _ in range(40)])
                    for _ in range(3)]).astype(np.int32)
    want = jax_moe._dispatch_indices(jnp.asarray(idx), experts, capacity)
    got = torch_moe._dispatch_indices(torch.from_numpy(idx).long(), experts, capacity)
    for name, g, w in zip(("dest", "valid", "token", "kslot", "order"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # 40 tokens a group: at least 10 slots an expert on average, at most 40
    assert bool((~got[1]).any()) == (capacity < 40)


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("shape,capacity", [((2, 24), None), ((3, 1), None), ((2, 24), 2),
                                            ((1, 1), None)])
def test_apply_moe_matches_jax(arch, shape, capacity, no_shard):
    """Prefill groups (a batch entry a group), the decode fold (B > 1, S = 1:
    one group), a capacity of 2 (most slots dropped) and a single token."""
    jcfg, tcfg, jp, moe = _moe_pair(arch, 3)
    x = _x((*shape, jcfg.d_model), 5)
    jout, jaux = jax_moe.apply_moe(jp, jcfg, jnp.asarray(x), capacity)
    out, aux = torch_moe.apply_moe(moe, tcfg, torch.from_numpy(x), capacity)
    assert out.shape == x.shape
    _close(out, jout)
    for key in jaux:
        _close(aux[key], jaux[key], msg=key)


def test_apply_moe_gradients_match_jax(no_shard):
    """Through the gates, the gathers and the dump row (capacity 2 drops)."""
    jcfg, tcfg, jp, moe = _moe_pair("deepseek-v2-236b", 6)
    x = _x((2, 24, jcfg.d_model), 7)

    def jloss(p, x):
        out, aux = jax_moe.apply_moe(p, jcfg, x, 2)
        return jnp.sum(jnp.sin(out)) + aux["moe_lb_loss"] + aux["moe_z_loss"]
    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = torch_moe.apply_moe(moe, tcfg, tx, 2)
    (torch.sin(out).sum() + aux["moe_lb_loss"] + aux["moe_z_loss"]).backward()
    _close(tx.grad, jgx, 1e-4)
    for name, g in _flatten(jax.tree.map(np.asarray, jg)):
        _close(dict(moe.named_parameters())[name].grad, g, 1e-4, msg=name)


# --- the whole LM ---------------------------------------------------------------

def _lm_pair(arch, remat):
    jrun = jax_configs.get_smoke_config(arch)
    jrun = jrun.replace(parallel=dataclasses.replace(jrun.parallel, param_dtype="float32",
                                                     remat=remat))
    jm = jax_model.build_model(jrun, use_kernel=False)
    params = jm.init(jax.random.key(0))
    run = get_smoke_config(arch)
    run = run.replace(parallel=dataclasses.replace(run.parallel, param_dtype="float32",
                                                   remat=remat))
    model = build_model(run, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), run.model))
    return jrun, jm, params, run, model


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_lm_loss_aux_and_gradients_match_jax_under_each_remat(arch, remat, no_shard):
    """The loss, ``ce_loss`` and both aux losses within 1e-5; every gradient
    within 1e-4 of its leaf's norm (norm scales sum many products)."""
    jrun, jm, params, run, model = _lm_pair(arch, remat)
    jb = jax_model.synthetic_batch(jrun.model, JaxShapeSpec("t", 32, 2, "train"), seed=1)
    (_, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model.lm_loss(jm, p, b), has_aux=True))(params, jb)
    loss, metrics = lm_loss(model, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()})
    loss.backward()
    assert set(metrics) == set(jmet) == {"ce_loss", "loss", "moe_lb_loss", "moe_z_loss"}
    for key in jmet:
        np.testing.assert_allclose(metrics[key].item(), float(jmet[key]), rtol=TOL, err_msg=key)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), run.model)
    for name, p in model.named_parameters():
        rel = float(torch.linalg.vector_norm(p.grad - want[name])
                    / torch.linalg.vector_norm(want[name]))
        assert rel <= 1e-4, (name, rel)


class _OpCounts(TorchDispatchMode):
    """The aten ops dispatched while active; ``experts`` counts the
    ``aten.bmm`` calls whose batch is the experts (E is no other bmm's batch
    in the test below)."""

    def __init__(self, num_experts):
        super().__init__()
        self.n = collections.Counter()
        self.e = num_experts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[func] += 1
        if func is torch.ops.aten.bmm.default and args[0].shape[0] == self.e:
            self.n["experts"] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_remat_dots_recomputes_the_expert_products_but_no_mm(arch):
    """The experts' products are batched over E, so ``dots`` (JAX's
    ``dots_with_no_batch_dims_saveable``, the port's ``aten.mm`` policy) does
    not save them: the backward under ``dots`` runs the forward's expert
    ``bmm`` again, as ``full`` does, and no more ``aten.mm`` than ``none``."""
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    tokens = {"tokens": torch.from_numpy(
        np.random.default_rng(2).integers(0, 512, (2, 32)).astype(np.int32))}
    run = get_smoke_config(arch)
    e = 6      # the attention's bmm batches are B x heads = 8 and 4, the combine's B x S
    model_cfg = dataclasses.replace(run.model,
                                    moe=dataclasses.replace(run.model.moe, num_experts=e))
    fwd, bwd = {}, {}
    for remat in ("none", "dots", "full"):
        run = run.replace(model=model_cfg, parallel=dataclasses.replace(
            run.parallel, param_dtype="float32", remat=remat))
        model = build_model(run, device="cpu").init_weights(torch.Generator().manual_seed(0))
        with _OpCounts(e) as f:
            loss, _ = lm_loss(model, tokens)
        with _OpCounts(e) as b:
            loss.backward()
        fwd[remat], bwd[remat] = f.n, b.n
    n_moe = sum(blk.__class__.__name__ == "MoEBlock" for blk in model.blocks)
    assert fwd["dots"]["experts"] == 3 * n_moe          # gate, up, down
    assert bwd["dots"][mm] == bwd["none"][mm] < bwd["full"][mm]
    assert bwd["dots"]["experts"] == bwd["none"]["experts"] + fwd["dots"]["experts"] \
        == bwd["full"]["experts"]
    assert bwd["dots"][bmm] == bwd["none"][bmm] + fwd["dots"][bmm] == bwd["full"][bmm]


def test_moe_router_is_float32_in_a_bf16_model():
    model = build_model(get_smoke_config("arctic-480b"), device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if name.endswith("moe.router") else torch.bfloat16)
    w = model.blocks[0].moe.wi_gate.float()
    # std d^-0.5 of a normal truncated at 2 sigma (x 0.8796), not E^-0.5
    d = model.cfg.d_model
    assert abs(w.std().item() / (0.8796 * d ** -0.5) - 1) < 0.05
    wo = model.blocks[0].moe.wo.float()
    assert abs(wo.std().item() / (0.8796 * model.cfg.moe.d_ff_expert ** -0.5) - 1) < 0.05


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_and_train_clis_run_the_moe_archs_on_cpu(arch, tmp_path, capsys):
    serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--prompt-len", "20",
                    "--decode-steps", "4"])
    out = json.loads(capsys.readouterr().out)
    assert out["arch"] == get_smoke_config(arch).model.name
    toks = np.asarray(out["sampled_tokens_head"])
    assert toks.shape == (2, 5) and 0 <= toks.min() and toks.max() < 512
    assert out["kernel_launches"] == {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0}
    train_cli.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                    "--workdir", str(tmp_path)])
    out = json.loads(capsys.readouterr().out)
    assert out["steps_run"] == 2 and out["restarts"] == 0
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])
