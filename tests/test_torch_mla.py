"""The port's MLA (``repro_torch.models.attention.MLAttention``) and MoE block
against ``repro.models.attention`` / ``repro.models.transformer``, on the CPU.

The same numpy inputs and weights go through the JAX functions and the port,
in float32 at deepseek-smoke's sizes (d_model 64, 4 heads, kv_lora 32,
q_lora 48, rope 8, nope 16, v 16), and at the same sizes with full-rank
queries (q_lora 0, ``w_q``). Norm scales are made non-zero so that the
``(1 + scale)`` factors are exercised. Tolerance 1e-5 (atol = rtol), as in
test_torch_models.py. The port's absorbed decode is also held to its own
naive prefill: the decode at position p against the prefill's row p.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

import repro.configs as jax_configs
import repro.models.moe as jax_moe
import repro.models.transformer as jax_transformer
from repro.models import attention as jax_attn
from repro_torch.configs import get_smoke_config
from repro_torch.convert import _flatten
from repro_torch.models import attention as torch_attn
from repro_torch.models.transformer import LM, DenseBlock, MoEBlock

TOL = 1e-5
B, S, MAX_LEN = 2, 24, 32


@pytest.fixture
def no_shard(monkeypatch):
    monkeypatch.setattr(jax_transformer, "shard_activations", lambda x: x)
    monkeypatch.setattr(jax_moe, "_maybe_shard", lambda x, spec: x)


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _cfgs(q_lora):
    jcfg = jax_configs.get_smoke_config("deepseek-v2-236b").model
    tcfg = get_smoke_config("deepseek-v2-236b").model
    if q_lora is not None:
        jcfg = dataclasses.replace(jcfg, mla=dataclasses.replace(jcfg.mla, q_lora_rank=q_lora))
        tcfg = dataclasses.replace(tcfg, mla=dataclasses.replace(tcfg.mla, q_lora_rank=q_lora))
    return jcfg, tcfg


def _scales_nonzero(p):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * jax.random.normal(jax.random.key(7), a.shape)
        if path[-1].key == "scale" else a, p)


def _mla_pair(q_lora):
    jcfg, tcfg = _cfgs(q_lora)
    p = jax.tree.map(np.asarray, _scales_nonzero(jax_attn.init_mla(jax.random.key(2), jcfg)))
    mod = torch_attn.MLAttention(tcfg, torch.float32, "cpu")
    mod.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _flatten(p)})
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), mod


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _caches(cfg):
    m = cfg.mla
    jc = jax_attn.MLACache(jnp.zeros((B, MAX_LEN, m.kv_lora_rank)),
                           jnp.zeros((B, MAX_LEN, m.rope_head_dim)))
    tc = torch_attn.MLACache(torch.zeros(B, MAX_LEN, m.kv_lora_rank),
                             torch.zeros(B, MAX_LEN, m.rope_head_dim))
    return jc, tc


Q_LORA = [None, 0]     # deepseek-smoke's q_lora 48, and full-rank queries


@pytest.mark.parametrize("q_lora", Q_LORA)
@pytest.mark.parametrize("offset", [0, 21])
def test_mla_q_and_ckv_match_jax(q_lora, offset):
    jcfg, tcfg, jp, mod = _mla_pair(q_lora)
    x = _x((B, S, jcfg.d_model), 1)
    pos = (offset + np.arange(S))[None, :].astype(np.int32)
    jq = jax_attn._mla_q(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    tq = mod._q(torch.from_numpy(x), torch.from_numpy(pos), True)
    jc = jax_attn._mla_ckv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    tc = mod._ckv(torch.from_numpy(x), torch.from_numpy(pos), True)
    for name, got, want in zip(("q_nope", "q_rope", "c_kv", "k_rope"), (*tq, *tc), (*jq, *jc)):
        assert tuple(got.shape) == want.shape, name
        _close(got, want, msg=name)


@pytest.mark.parametrize("q_lora", Q_LORA)
def test_mla_train_matches_jax(q_lora):
    jcfg, tcfg, jp, mod = _mla_pair(q_lora)
    x = _x((B, S, jcfg.d_model), 2)
    _close(mod.forward_train(torch.from_numpy(x)), jax_attn.mla_train(jp, jcfg, jnp.asarray(x)))


def test_mla_train_matches_jax_over_several_query_chunks(monkeypatch):
    """A sequence of 40 in query chunks of 16, as a 4352-token prefill runs in
    chunks of 1024 (both packages' ``q_chunk`` set to 16)."""
    jcfg, tcfg, jp, mod = _mla_pair(None)
    for fn in (jax_attn.chunked_causal_attention, torch_attn.chunked_causal_attention):
        monkeypatch.setattr(fn, "__kwdefaults__", {**fn.__kwdefaults__, "q_chunk": 16})
    x = _x((B, 40, jcfg.d_model), 3)
    _close(mod.forward_train(torch.from_numpy(x)), jax_attn.mla_train(jp, jcfg, jnp.asarray(x)))


@pytest.mark.parametrize("q_lora", Q_LORA)
def test_mla_prefill_and_decode_match_jax(q_lora):
    """Prefill's output and both cache tensors, then three absorbed decode
    steps, each its output and the cache."""
    jcfg, tcfg, jp, mod = _mla_pair(q_lora)
    jc, tc = _caches(jcfg)
    x = _x((B, S, jcfg.d_model), 4)
    jy, jc = jax_attn.mla_prefill(jp, jcfg, jnp.asarray(x), jc)
    ty = mod.prefill(torch.from_numpy(x), tc)
    _close(ty, jy)
    _close(tc.c_kv, jc.c_kv, msg="c_kv")
    _close(tc.k_rope, jc.k_rope, msg="k_rope")
    for step in range(3):
        x1 = _x((B, 1, jcfg.d_model), 10 + step)
        jy, jc = jax_attn.mla_decode(jp, jcfg, jnp.asarray(x1), jc, S + step)
        ty = mod.decode(torch.from_numpy(x1), tc, S + step)
        _close(ty, jy, msg=f"decode {step}")
        _close(tc.c_kv, jc.c_kv, msg=f"c_kv {step}")
        _close(tc.k_rope, jc.k_rope, msg=f"k_rope {step}")


@pytest.mark.parametrize("q_lora", Q_LORA)
@pytest.mark.parametrize("p", [0, 7, S - 1])
def test_absorbed_decode_equals_naive_prefill_row(q_lora, p):
    """Prefill S tokens (naive), then prefill the first p tokens into a fresh
    cache and decode token p (absorbed): its output is the naive row p."""
    jcfg, tcfg, jp, mod = _mla_pair(q_lora)
    x = torch.from_numpy(_x((B, S, jcfg.d_model), 5))
    _, full = _caches(jcfg)
    naive = mod.prefill(x, full)
    _, cache = _caches(jcfg)
    if p:
        mod.prefill(x[:, :p], cache)
    got = mod.decode(x[:, p:p + 1], cache, p)
    torch.testing.assert_close(got[:, 0], naive[:, p], atol=TOL, rtol=TOL)
    torch.testing.assert_close(cache.c_kv[:, :p + 1], full.c_kv[:, :p + 1], atol=TOL, rtol=TOL)


# --- the blocks of deepseek-smoke: dense layer 0, MoE layers 1 and 2 --------------

def _block_pair(kind, layer):
    jcfg, tcfg = _cfgs(None)
    p = jax_transformer.init_block(jax.random.key(layer + 3), jcfg, kind, jnp.float32)
    p = jax.tree.map(np.asarray, _scales_nonzero(p))
    blk = (MoEBlock if kind == "moe" else DenseBlock)(tcfg, layer, torch.float32, "cpu")
    blk.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _flatten(p)})
    return jcfg, jax.tree.map(jnp.asarray, p), blk


@pytest.mark.parametrize("kind,layer", [("dense", 0), ("moe", 1)])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_mla_block_matches_jax(kind, layer, mode, no_shard):
    """Output, aux losses (MoE) and the MLA cache of one block in each mode."""
    jcfg, jp, blk = _block_pair(kind, layer)
    x = _x((B, S, jcfg.d_model), 6)
    if mode == "train":
        jy, jaux, _ = jax_transformer.apply_block(jp, jcfg, kind, jnp.asarray(x), mode="train",
                                                  layer_idx=layer, use_kernel=False)
        ty, aux = blk.forward_aux(torch.from_numpy(x), mode="train")
    else:
        jc, tc = _caches(jcfg)
        jy, jaux, jc = jax_transformer.apply_block(jp, jcfg, kind, jnp.asarray(x),
                                                   mode="prefill", layer_idx=layer, cache=jc,
                                                   use_kernel=False)
        ty, aux = blk.forward_aux(torch.from_numpy(x), mode="prefill", cache=tc)
        if mode == "decode":
            x1 = _x((B, 1, jcfg.d_model), 8)
            jy, jaux, jc = jax_transformer.apply_block(
                jp, jcfg, kind, jnp.asarray(x1), mode="decode", layer_idx=layer, cache=jc,
                pos=S, use_kernel=False)
            ty, aux = blk.forward_aux(torch.from_numpy(x1), mode="decode", cache=tc, pos=S)
        _close(tc.c_kv, jc.c_kv, msg="c_kv")
        _close(tc.k_rope, jc.k_rope, msg="k_rope")
    _close(ty, jy)
    assert set(aux) == set(jaux)
    for key in jaux:
        _close(aux[key], jaux[key], msg=key)


def test_layer_plan_and_mla_cache_match_jax():
    """deepseek: the first ``first_k_dense`` layers dense, then MoE, as
    ``plan_segments``; arctic all MoE; an MLA model's cache is ``MLACache``."""
    for arch in ("deepseek-v2-236b", "arctic-480b"):
        jcfg = jax_configs.get_smoke_config(arch).model
        kinds = [k for seg in jax_transformer.plan_segments(jcfg)
                 for _ in range(seg.n_units) for k in seg.kinds]
        model = LM(get_smoke_config(arch).model, torch.float32, "cpu")
        assert [("moe" if isinstance(b, MoEBlock) else "dense") for b in model.blocks] == kinds
    cache = model.init_cache(2, 16)
    assert isinstance(cache[0], torch_attn.KVCache)
    cfg = get_smoke_config("deepseek-v2-236b").model
    cache = LM(cfg, torch.float32, "cpu").init_cache(2, 16)
    assert len(cache) == cfg.n_layers and isinstance(cache[0], torch_attn.MLACache)
    assert cache[0].c_kv.shape == (2, 16, 32) and cache[0].k_rope.shape == (2, 16, 8)
    assert cache[0].c_kv.dtype == torch.bfloat16


def test_mla_norms_go_through_the_rmsnorm_entry(monkeypatch):
    """``q_norm`` (q_lora wide) and ``kv_norm`` (kv_lora wide) go through
    ``kernels.ops.rmsnorm``, so on the card they take the CUDA kernel: 4 norms
    a block, 4L + 1 a forward."""
    from repro_torch.kernels import ops
    widths = []
    real = ops.rmsnorm
    monkeypatch.setattr(ops, "rmsnorm", lambda x, s, eps, use_kernel=True:
                        widths.append(x.shape[-1]) or real(x, s, eps, use_kernel))
    cfg = get_smoke_config("deepseek-v2-236b").model
    model = LM(cfg, torch.float32, "cpu").init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(torch.zeros(2, 8, dtype=torch.int32), mode="prefill",
              cache=model.init_cache(2, 8, torch.float32))
    m = cfg.mla
    assert len(widths) == 4 * cfg.n_layers + 1
    assert widths.count(m.q_lora_rank) == widths.count(m.kv_lora_rank) == cfg.n_layers
