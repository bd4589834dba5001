"""Port model modules vs the JAX package's functions, in float32 on the CPU.

The same numpy inputs and weights go through ``repro.models`` (jnp) and
``repro_torch.models``. Tolerance 1e-5 (atol = rtol): both sides compute in
float32 and differ only in the order of sums (einsum / matmul blocking).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

import repro.configs as jax_configs
import repro.models.transformer as jax_transformer
from repro.models import attention as jax_attn
from repro.models import layers as jl
from repro.models.model import count_params_analytic
from repro_torch import configs as torch_configs
from repro_torch.common import config as tcfg
from repro_torch.convert import _flatten, params_from_jax
from repro_torch.models import attention as torch_attn
from repro_torch.models import layers as tl
from repro_torch.models.transformer import LM, DenseBlock

TOL = 1e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(
        got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("arch", torch_configs.ARCHS)
@pytest.mark.parametrize("which", ["get_config", "get_smoke_config"])
def test_config_equals_jax_field_for_field(arch, which):
    want = getattr(jax_configs, which)(arch)
    got = getattr(torch_configs, which)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_unported_arch_is_refused():
    """Every architecture of the JAX package is ported; any other name is
    refused."""
    assert set(torch_configs.ARCHS) == set(jax_configs.ARCHS)
    with pytest.raises(ValueError, match="not ported"):
        torch_configs.get_config("gpt-j-6b")


# a config that misuses each of the plan's features: a mamba2 block without an
# SSM config, a pattern with an unknown block kind, cross attention every 3rd
# of 2 layers (the JAX plan asserts or fails on each)
UNPORTED_FEATURES = {
    "ssm": dict(block_pattern=("dense", "mamba2")),
    "block_pattern": dict(block_pattern=("dense", "mamba3")),
    "cross_attn_every": dict(cross_attn_every=3),
}


@pytest.mark.parametrize("feature", sorted(UNPORTED_FEATURES))
def test_unported_block_kinds_are_refused(feature):
    """Recurrent, pattern and cross-attention plans are ported; a
    config that misuses them is refused with a message naming the field."""
    cfg = dataclasses.replace(torch_configs.get_smoke_config("yi-34b").model, n_layers=2,
                              **UNPORTED_FEATURES[feature])
    with pytest.raises(ValueError, match=feature):
        LM(cfg, torch.float32, "cpu")


# --- layers -----------------------------------------------------------------

RNG = np.random.default_rng(0)


def _arr(*shape, std=1.0):
    return RNG.normal(0, std, shape).astype(np.float32)


def test_rmsnorm_matches_jax():
    x, s = _arr(2, 5, 48), _arr(48, std=0.3)
    _close(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           jl.apply_rmsnorm({"scale": jnp.asarray(s)}, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("offset", [0, 4093])
def test_rope_matches_jax(offset):
    x = _arr(2, 7, 3, 32)
    pos = (offset + np.arange(7))[None, :].astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), tol=1e-4)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_glu_mlp_matches_jax(act):
    x, g, u, o = _arr(2, 5, 24), _arr(24, 40, std=0.2), _arr(24, 40, std=0.2), _arr(40, 24, std=0.15)
    want = jl.apply_glu_mlp({"wi_gate": jnp.asarray(g), "wi_up": jnp.asarray(u),
                             "wo": jnp.asarray(o)}, jnp.asarray(x), act)
    got = tl.glu_mlp(*(torch.from_numpy(a) for a in (x, g, u, o)), act=act)
    _close(got, want)


def test_untied_readout_matches_jax():
    head, x = _arr(36, 50, std=0.2), _arr(3, 7, 36)
    _close(tl.logits_from_head(torch.from_numpy(head), torch.from_numpy(x)),
           jnp.asarray(x) @ jnp.asarray(head))


@pytest.mark.parametrize("scale", [False, True])
def test_embedding_and_tied_readout_match_jax(scale):
    table = _arr(50, 36, std=0.2)
    tokens = RNG.integers(0, 50, (3, 7)).astype(np.int32)
    p = {"table": jnp.asarray(table)}
    want = jl.apply_embedding(p, jnp.asarray(tokens), scale_by_sqrt_dim=scale)
    got = tl.embed(torch.from_numpy(table), torch.from_numpy(tokens), scale_by_sqrt_dim=scale)
    _close(got, want)
    _close(tl.logits_from_embedding(torch.from_numpy(table), got),
           jl.logits_from_embedding(p, want))


def test_softcap_matches_jax():
    x = _arr(4, 9, std=60.0)
    _close(tl.softcap(torch.from_numpy(x), 30.0), jl.softcap(jnp.asarray(x), 30.0))
    assert torch.equal(tl.softcap(torch.from_numpy(x), 0.0), torch.from_numpy(x))


def test_truncated_normal_stays_within_two_sigma():
    gen = torch.Generator().manual_seed(0)
    w = tl.truncated_normal((256, 256), 0.5, torch.float32, "cpu", gen)
    assert w.abs().max().item() <= 1.0 + 1e-6
    # std of a standard normal truncated at +-2 is 0.8796
    assert abs(w.std().item() / 0.5 - 0.8796) < 0.01


@pytest.mark.parametrize("arch,layer", [("gemma2-2b", 0), ("gemma2-2b", 1), ("smollm-135m", 0)])
def test_layer_window_matches_jax(arch, layer):
    cfg = torch_configs.get_config(arch).model
    want = jax_attn.layer_window(jax_configs.get_config(arch).model, layer)
    assert torch_attn.layer_window(cfg, layer) == (0 if want is None else int(want))


# --- one dense block ----------------------------------------------------------

def _block_pair(arch, layer):
    """A JAX dense block's fp32 params (norm scales made non-zero) and the
    port block loaded with the same values."""
    jcfg = jax_configs.get_smoke_config(arch).model
    tcfg = torch_configs.get_smoke_config(arch).model
    p = jax_transformer.init_block(jax.random.key(layer + 3), jcfg, "dense", jnp.float32)
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.1 * jax.random.normal(jax.random.key(7), a.shape)
        if path[-1].key == "scale" else a, p)
    p = jax.tree.map(np.asarray, p)
    blk = DenseBlock(tcfg, layer, torch.float32, "cpu")
    blk.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in _flatten(p)})
    return jcfg, jax.tree.map(jnp.asarray, p), blk


BLOCK_CASES = [("gemma2-2b", 0), ("gemma2-2b", 1), ("smollm-135m", 0), ("yi-34b", 0),
               ("stablelm-12b", 1), ("musicgen-medium", 2)]   # stablelm: qk norm


@pytest.mark.parametrize("arch,layer", BLOCK_CASES)
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_dense_block_matches_jax(arch, layer, mode):
    jcfg, jp, blk = _block_pair(arch, layer)
    b, s, max_len = 2, 24, 32            # 24 > the smoke window of 16
    hkv, hd = jcfg.n_kv_heads, jcfg.resolved_head_dim
    x = _arr(b, s, jcfg.d_model)
    jcache = jax_attn.KVCache(jnp.zeros((b, max_len, hkv, hd)), jnp.zeros((b, max_len, hkv, hd)))
    tcache = torch_attn.KVCache(torch.zeros(b, max_len, hkv, hd), torch.zeros(b, max_len, hkv, hd))
    jy, _, jcache = jax_transformer.apply_block(jp, jcfg, "dense", jnp.asarray(x), mode="prefill",
                                                layer_idx=layer, cache=jcache, use_kernel=False)
    ty = blk(torch.from_numpy(x), mode="prefill", cache=tcache)
    if mode == "decode":
        x1 = _arr(b, 1, jcfg.d_model)
        jy, _, jcache = jax_transformer.apply_block(
            jp, jcfg, "dense", jnp.asarray(x1), mode="decode", layer_idx=layer, cache=jcache,
            pos=s, use_kernel=False)
        ty = blk(torch.from_numpy(x1), mode="decode", cache=tcache, pos=s)
    _close(ty, jy)
    _close(tcache.k, jcache.k)
    _close(tcache.v, jcache.v)


@pytest.mark.parametrize("arch,layer", BLOCK_CASES)
def test_dense_block_train_mode_matches_jax(arch, layer):
    """Train mode: no cache, plain chunked attention, the norms through
    ``kernels.ops.rmsnorm`` (its CPU path)."""
    jcfg, jp, blk = _block_pair(arch, layer)
    x = _arr(2, 24, jcfg.d_model)            # 24 > the smoke window of 16
    jy, _, _ = jax_transformer.apply_block(jp, jcfg, "dense", jnp.asarray(x), mode="train",
                                           layer_idx=layer, use_kernel=False)
    _close(blk(torch.from_numpy(x), mode="train"), jy)


# --- parameters ---------------------------------------------------------------

FP32_LEAVES = ("moe.router", "cell.A_log", "cell.dt_bias", "cell.D", "cell.if_bias", "cell.b")


@pytest.mark.parametrize("arch", torch_configs.ARCHS)
def test_converted_params_load_and_count_as_in_jax(arch, monkeypatch):
    """Every JAX leaf lands, unstacked, in the one parameter of its layer and
    path, layers counted in order of application (deepseek: the dense
    segment's unit 0 is layer 0, the MoE segment's unit u is layer 1 + u;
    llama-vision: unit u's position p is layer 5u + p; zamba2: unit u's
    mamba2 position p is layer 6u + p, the tail's after them, and the shared
    block, unstacked, is ``shared_attn``); each leaf once, each parameter
    once. The float32 leaves (the MoE router, Mamba2's A_log, dt_bias and D,
    the xLSTM gate biases) stay float32 in a bf16 model."""
    monkeypatch.setattr(jax_transformer, "shard_activations", lambda x: x)
    jcfg = jax_configs.get_smoke_config(arch).model
    params = jax_transformer.LM(jcfg, param_dtype=jnp.float32).init(jax.random.key(0))
    model = LM(torch_configs.get_smoke_config(arch).model, torch.float32, "cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model.cfg))
    assert model.num_params() == count_params_analytic(jcfg)
    got = dict(model.named_parameters())
    want = {k: np.asarray(v) for k, v in _flatten(
        {k: v for k, v in params.items() if k != "segments"})}
    leaves, layer = len(want), 0
    for seg in params["segments"]:
        n_units = jax.tree.leaves(seg["unit"])[0].shape[0]
        for u in range(n_units):
            for pos in sorted(seg["unit"], key=int):
                for name, stacked in _flatten(seg["unit"][pos]):
                    assert f"blocks.{layer}.{name}" not in want
                    want[f"blocks.{layer}.{name}"] = np.asarray(stacked[u])
                layer += 1
        leaves += sum(len(list(_flatten(block))) for block in seg["unit"].values())
        for block in seg["shared"].values():
            for name, leaf in _flatten(block):
                assert f"shared_attn.{name}" not in want
                want[f"shared_attn.{name}"] = np.asarray(leaf)
                leaves += 1
    assert layer == jcfg.n_layers and leaves == len(jax.tree.leaves(params))
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(got[name].detach().numpy(), value, err_msg=name)
    bf16 = LM(model.cfg, torch.bfloat16, "cpu")
    bf16.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model.cfg))
    for name, p in bf16.named_parameters():
        assert p.dtype == (torch.float32 if name.endswith(FP32_LEAVES) else torch.bfloat16), name


@pytest.mark.parametrize("arch", torch_configs.ARCHS)
def test_logits_fn_reads_out_as_jax(arch, monkeypatch):
    """The tied table or the untied ``head`` (d_model, vocab), soft-capped in
    fp32: the same parameters and hidden states through both ``logits_fn``."""
    monkeypatch.setattr(jax_transformer, "shard_activations", lambda x: x)
    jcfg = jax_configs.get_smoke_config(arch).model
    jm = jax_transformer.LM(jcfg, param_dtype=jnp.float32)
    params = jm.init(jax.random.key(1))
    model = LM(torch_configs.get_smoke_config(arch).model, torch.float32, "cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), model.cfg))
    untied = jcfg.family == "audio" or not jcfg.tie_embeddings
    assert hasattr(model, "head") == untied == ("head" in params)
    assert hasattr(model, "embed") == (jcfg.family != "audio") == ("embed" in params)
    x = _arr(2, 5, jcfg.d_model)
    _close(model.logits_fn(torch.from_numpy(x)), jm.logits_fn(params, jnp.asarray(x)))


def test_forward_takes_exactly_one_of_tokens_and_embeddings():
    cfg = torch_configs.get_smoke_config("musicgen-medium").model
    model = LM(cfg, torch.float32, "cpu").init_weights(torch.Generator().manual_seed(0))
    emb = torch.zeros(1, 4, cfg.d_model)
    out, _ = model(embeddings=emb.bfloat16(), mode="train")
    assert out.shape == (1, 4, cfg.vocab_size) and out.dtype == torch.float32
    for kw in ({}, {"tokens": torch.zeros(1, 4, dtype=torch.int32), "embeddings": emb}):
        with pytest.raises(ValueError, match="exactly one"):
            model(mode="train", **kw)
