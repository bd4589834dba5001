"""The port's cross attention and llama-3.2-vision's plan against the JAX package.

Float32 on the CPU. The cross-attention ``gate`` and the cross block's
``ffn_gate`` are set to non-zero values drawn from a seed: the JAX init
makes them zero, and a cross block is then the identity, so a test at init
would hold nothing of the cross attention. The same numpy inputs and
weights go through ``repro.models.attention.cross_attn`` /
``repro.models.transformer.apply_block`` and ``repro_torch.models``.
Tolerance 1e-5 (atol = rtol): both sides compute in float32 and differ only
in the order of sums.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

import repro.configs as jax_configs
import repro.models.transformer as jax_transformer
from repro.models import attention as jattn
from repro_torch import configs as torch_configs
from repro_torch.configs import get_smoke_config
from repro_torch.convert import _flatten
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttransformer

ARCH = "llama-3.2-vision-11b"
TOL = 1e-5
RNG = np.random.default_rng(13)


def _arr(*shape, std=1.0):
    return RNG.normal(0, std, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _gated(p, seed):
    """``p`` with every ``gate`` / ``ffn_gate`` leaf drawn from N(0, 1)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: rng.normal(0, 1, np.shape(a)).astype(np.float32)
        if path[-1].key in ("gate", "ffn_gate") else np.asarray(a), p)


def test_cross_attention_matches_jax_with_a_nonzero_gate():
    jcfg = jax_configs.get_smoke_config(ARCH).model
    p = _gated(jax.tree.map(np.asarray, jattn.init_cross_attn(jax.random.key(1), jcfg)), 2)
    assert p["gate"] != 0
    mod = tattn.CrossAttention(get_smoke_config(ARCH).model, torch.float32, "cpu")
    mod.load_state_dict({k: _t(v) for k, v in _flatten(p)})
    x, ve = _arr(2, 9, jcfg.d_model), _arr(2, jcfg.vision_seq_len, jcfg.vision_d_model)
    want = jattn.cross_attn(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x), jnp.asarray(ve))
    _close(mod(_t(x), _t(ve)), want)
    assert float(np.abs(np.asarray(want)).max()) > 1e-2


@pytest.mark.parametrize("q_chunk", [4, 1024])
def test_query_chunks_change_nothing_forward_or_backward(q_chunk):
    """``cross_attention`` in query chunks of 4 over 10 queries (the last
    chunk short), each under a checkpoint when autograd records, against the
    JAX ``_softmax_attend`` with an all-true mask: outputs and gradients."""
    q, k, v = _arr(2, 10, 4, 8), _arr(2, 7, 4, 8), _arr(2, 7, 4, 8)
    mask = jnp.ones((10, 7), bool)

    def jfn(q, k, v):
        return jnp.sum(jnp.sin(jattn._softmax_attend(q, k, v, mask, 0.0, 8 ** -0.5)))

    want = jax.grad(jfn, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    out = tattn.cross_attention(*ts, scale=8 ** -0.5, q_chunk=q_chunk)
    _close(out, jattn._softmax_attend(*map(jnp.asarray, (q, k, v)), mask, 0.0, 8 ** -0.5))
    torch.sin(out).sum().backward()
    for t, w in zip(ts, want):
        _close(t.grad, w)


def _cross_block_pair(seed):
    jcfg = jax_configs.get_smoke_config(ARCH).model
    p = jax_transformer.init_block(jax.random.key(seed), jcfg, "cross", jnp.float32)
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * jax.random.normal(jax.random.key(seed + 1), a.shape)
        if path[-1].key == "scale" else a, p)
    p = _gated(p, seed)
    blk = ttransformer.CrossBlock(get_smoke_config(ARCH).model, torch.float32, "cpu")
    blk.load_state_dict({k: _t(v) for k, v in _flatten(p)})
    return jcfg, jax.tree.map(jnp.asarray, p), blk


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cross_block_matches_jax_and_keeps_no_cache(mode):
    """``ln1``, tanh-gated ``xattn``, ``ln2``, the MLP scaled by
    tanh(``ffn_gate``); the same in every mode, with no cache (the vision
    K/V are recomputed each step, as in the JAX package)."""
    jcfg, jp, blk = _cross_block_pair(5)
    x = _arr(2, 1 if mode == "decode" else 11, jcfg.d_model)
    ve = _arr(2, jcfg.vision_seq_len, jcfg.vision_d_model)
    jy, _, jcache = jax_transformer.apply_block(jp, jcfg, "cross", jnp.asarray(x), mode=mode,
                                                layer_idx=3, cache={}, pos=4,
                                                vision_embed=jnp.asarray(ve))
    assert jcache == {} and blk.init_cache(2, 16, torch.float32) is None
    _close(blk(_t(x), mode=mode, cache=None, pos=4, vision_embed=_t(ve)), jy)
    with pytest.raises(ValueError, match="vision_embed"):
        blk(_t(x), mode=mode)


@pytest.mark.parametrize("which", ["get_config", "get_smoke_config"])
def test_vision_layer_plan_matches_jax(which):
    """Cross blocks at position every - 2 of each unit: layers 3, 8, ..., 38
    of the published 40."""
    jcfg = getattr(jax_configs, which)(ARCH).model
    want = [k for seg in jax_transformer.plan_segments(jcfg)
            for _ in range(seg.n_units) for k in seg.kinds]
    plan = ttransformer.layer_plan(getattr(torch_configs, which)(ARCH).model)
    assert plan == want
    assert [i for i, k in enumerate(plan) if k == "cross"] == list(range(3, jcfg.n_layers, 5))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_a_model_with_cross_blocks_refuses_to_run_without_vision_embed(mode):
    """No zeros are put in its place: the forward raises, in every mode."""
    cfg = get_smoke_config(ARCH).model
    model = ttransformer.LM(cfg, torch.float32, "cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    cache = None if mode == "train" else model.init_cache(2, 8, torch.float32)
    with pytest.raises(ValueError, match="vision_embed"):
        model(torch.zeros(2, 1 if mode == "decode" else 4, dtype=torch.int32), mode=mode,
              cache=cache, pos=0 if mode == "decode" else None)
    assert cache is None or cache[cfg.cross_attn_every - 2] is None


def test_vision_embed_moves_the_logits_through_nonzero_gates():
    """With the gates drawn non-zero, another image gives other logits; at
    zero gates (the JAX init) the image cannot matter."""
    cfg = get_smoke_config(ARCH).model
    model = ttransformer.LM(cfg, torch.float32, "cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(RNG.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32))
    ve = [torch.from_numpy(_arr(2, cfg.vision_seq_len, cfg.vision_d_model)) for _ in range(2)]
    with torch.no_grad():
        same = [model(tokens, mode="train", vision_embed=v)[0] for v in ve]
        torch.testing.assert_close(same[0], same[1], atol=0, rtol=0)
        for blk in model.blocks:
            if isinstance(blk, ttransformer.CrossBlock):
                blk.xattn.gate.fill_(0.7)
                blk.ffn_gate.fill_(-0.4)
        moved = [model(tokens, mode="train", vision_embed=v)[0] for v in ve]
    assert (moved[0] - moved[1]).abs().max() > 1e-3
