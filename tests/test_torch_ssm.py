"""The port's recurrent blocks against the JAX package's, in float32 on the CPU.

Mamba2 (the causal depthwise conv, the chunked SSD scan, the full-sequence
and one-token cells), mLSTM (the chunkwise-parallel scan, the one-step form)
and sLSTM (the time-step loop), then the recurrent blocks and zamba2's and
xlstm's layer plans. The same numpy inputs and weights go through
``repro.models.ssm`` / ``repro.models.transformer`` and
``repro_torch.models``; every final state is compared, not only the outputs.
The scans run at lengths that are not a multiple of the chunk (29 at chunk
8: the tail chunk is padded) and from non-zero initial states. The model
tests of the smoke configs (test_torch_models.py, test_torch_serve.py,
test_torch_train.py) never cross an mLSTM chunk (their seq of 32 is under
the fixed chunk of 256), so the chunk crossings are held here.

Tolerance 1e-5 (atol = rtol): both sides compute in float32 and differ only
in the order of sums. The chunked mLSTM against the JAX package's own
one-step loop: 1e-4 (two forms of the same recurrence, their exponentials
and sums regrouped).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

import repro.configs as jax_configs
import repro.models.transformer as jax_transformer
from repro.models import ssm as jssm
from repro_torch import configs as torch_configs
from repro_torch.configs import get_smoke_config
from repro_torch.convert import _flatten
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttransformer

TOL = 1e-5
RNG = np.random.default_rng(11)


def _arr(*shape, std=1.0, mean=0.0):
    return RNG.normal(mean, std, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=msg)


def _close_state(got, want, tol=TOL):
    assert type(got).__name__ == type(want).__name__ and got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        _close(g, w, tol, msg=name)


# --- Mamba2 -------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("length", [1, 2, 9])
def test_causal_depthwise_conv_matches_jax(with_state, length):
    """The trailing W-1 inputs come back as the state, the initial state's
    own rows among them when L < W-1."""
    x, w, b = _arr(2, length, 12), _arr(4, 12, std=0.3), _arr(12, std=0.1)
    init = _arr(2, 3, 12) if with_state else None
    jy, jstate = jssm._causal_depthwise_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                            None if init is None else jnp.asarray(init))
    ty, tstate = tssm.causal_depthwise_conv(_t(x), _t(w), _t(b),
                                            None if init is None else _t(init))
    _close(ty, jy)
    _close(tstate, jstate)


def _ssd_inputs(b=2, length=29, h=3, p=4, n=5, dt_mean=0.0):
    xh, Bm, Cm = _arr(b, length, h, p), _arr(b, length, n), _arr(b, length, n)
    dt = np.log1p(np.exp(_arr(b, length, h, mean=dt_mean))).astype(np.float32)   # softplus
    a_log = (dt * -np.exp(_arr(h, std=0.5))).astype(np.float32)
    s0 = _arr(b, h, p, n, std=0.5)
    return xh, dt, a_log, Bm, Cm, s0


@pytest.mark.parametrize("length,chunk", [(29, 8), (32, 8), (5, 8), (29, 29)])
def test_ssd_chunk_scan_matches_jax(length, chunk):
    """29 at chunk 8 pads the tail chunk by 3; from a non-zero state."""
    args = _ssd_inputs(length=length)
    jy, js = jssm._ssd_chunk_scan(*map(jnp.asarray, args), chunk)
    ty, ts = tssm.ssd_chunk_scan(*map(_t, args), chunk)
    assert ty.shape == (2, length, 3, 4) and ts.shape == (2, 3, 4, 5)
    _close(ty, jy)
    _close(ts, js)


def test_ssd_backward_stays_finite_where_the_jax_form_overflows():
    """At the configs' chunk of 256 with dt ~ softplus(N(1, 1)), a chunk's log
    decay spans > 88, so the JAX form's exp above the diagonal is inf and its
    gradient with respect to B is NaN (0 x inf). The port masks before the
    exponential: the same forward, and gradients equal to the JAX package's
    where its chunks are short enough not to overflow (chunk 8). Held by
    norm, ||got - jax|| <= 1e-5 ||jax||: at log decays of ~500 a chunk, the
    float32 cumulative sums lose ~3e-5 of each exponent on both sides
    (another chunking, or XLA's cumsum, round them otherwise)."""
    xh, dt, a_log, Bm, Cm, s0 = _ssd_inputs(b=1, length=256, h=2, p=4, n=6, dt_mean=1.0)
    assert float(np.cumsum(-a_log, axis=1).max()) > 100

    def jloss(chunk):
        return lambda xh_, Bm_: jssm._ssd_chunk_scan(
            xh_, jnp.asarray(dt), jnp.asarray(a_log), Bm_, jnp.asarray(Cm),
            jnp.asarray(s0), chunk)[0].sum()

    jgrad_256 = jax.grad(jloss(256), argnums=(0, 1))(jnp.asarray(xh), jnp.asarray(Bm))
    assert not bool(jnp.isfinite(jgrad_256[1]).all())
    jgrad_8 = jax.grad(jloss(8), argnums=(0, 1))(jnp.asarray(xh), jnp.asarray(Bm))
    txh, tBm = _t(xh).requires_grad_(), _t(Bm).requires_grad_()
    ty, _ = tssm.ssd_chunk_scan(txh, _t(dt), _t(a_log), tBm, _t(Cm), _t(s0), 256)
    jy = jssm._ssd_chunk_scan(*map(jnp.asarray, (xh, dt, a_log, Bm, Cm, s0)), 256)[0]
    ty.sum().backward()
    assert torch.isfinite(tBm.grad).all()
    for got, want in ((ty, jy), (txh.grad, jgrad_8[0]), (tBm.grad, jgrad_8[1])):
        _close_norm(got, want)


def _cell_params(kind, seed):
    """A JAX cell's fp32 params from its init, every zero or one leaf (norm
    scale, A_log, dt_bias, D, biases) moved off its initial value."""
    jcfg = jax_configs.get_smoke_config("zamba2-7b" if kind == "mamba2" else "xlstm-125m").model
    init = {"mamba2": jssm.init_mamba2, "mlstm": jssm.init_mlstm, "slstm": jssm.init_slstm}[kind]
    p = init(jax.random.key(seed), jcfg, jnp.float32)
    moved = {"scale", "A_log", "dt_bias", "D", "conv_b", "if_bias", "b"}
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.3 * jax.random.normal(jax.random.key(seed + 1), a.shape)
        if path[-1].key in moved else a, p)
    return jcfg, jax.tree.map(np.asarray, p)


def _torch_cell(kind, p):
    cfg = get_smoke_config("zamba2-7b" if kind == "mamba2" else "xlstm-125m").model
    cls = {"mamba2": tssm.Mamba2, "mlstm": tssm.MLSTM, "slstm": tssm.SLSTM}[kind]
    cell = cls(cfg, torch.float32, "cpu")
    cell.load_state_dict({k: _t(v) for k, v in _flatten(p)})
    return cell


def test_fp32_leaves_stay_fp32_in_a_bf16_model():
    cfg = get_smoke_config("zamba2-7b").model
    assert {n for n, p in tssm.Mamba2(cfg, torch.bfloat16, "cpu").named_parameters()
            if p.dtype == torch.float32} == {"A_log", "dt_bias", "D"}
    cfg = get_smoke_config("xlstm-125m").model
    assert {n for n, p in tssm.MLSTM(cfg, torch.bfloat16, "cpu").named_parameters()
            if p.dtype == torch.float32} == {"if_bias"}
    assert {n for n, p in tssm.SLSTM(cfg, torch.bfloat16, "cpu").named_parameters()
            if p.dtype == torch.float32} == {"b"}


def _mamba_state(jcfg, seed):
    s = jcfg.ssm
    d_inner, h, conv_dim = jssm._mamba_dims(jcfg)
    rng = np.random.default_rng(seed)
    return jssm.MambaCache(
        conv=rng.normal(0, 1, (2, s.conv_width - 1, conv_dim)).astype(np.float32),
        ssm=rng.normal(0, 0.5, (2, h, s.head_dim, s.state_dim)).astype(np.float32))


@pytest.mark.parametrize("length", [29, 1])
@pytest.mark.parametrize("from_state", [False, True])
def test_mamba2_forward_matches_jax(length, from_state):
    """``mamba2_forward`` at the smoke chunk of 8 (29: a padded tail chunk),
    from zeros or from a cache; output and both parts of the final state."""
    jcfg, p = _cell_params("mamba2", 3)
    cell = _torch_cell("mamba2", p)
    x = _arr(2, length, jcfg.d_model)
    state = _mamba_state(jcfg, 4) if from_state else jssm.init_mamba_cache(jcfg, 2, jnp.float32)
    jp = jax.tree.map(jnp.asarray, p)
    jy, jstate = jssm.mamba2_forward(jp, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    ty, tstate = cell(_t(x), tssm.MambaCache(*map(_t, state)))
    _close(ty, jy)
    _close_state(tstate, jstate)
    jy0, _ = jssm.mamba2_forward(jp, jcfg, jnp.asarray(x))          # train: no cache
    ty0, _ = cell(_t(x), None)
    _close(ty0, jy0)


def test_mamba2_decode_matches_jax():
    jcfg, p = _cell_params("mamba2", 5)
    cell = _torch_cell("mamba2", p)
    jp = jax.tree.map(jnp.asarray, p)
    state = _mamba_state(jcfg, 6)
    jstate, tstate = jax.tree.map(jnp.asarray, state), tssm.MambaCache(*map(_t, state))
    for step in range(3):
        x = _arr(2, 1, jcfg.d_model)
        jy, jstate = jssm.mamba2_decode(jp, jcfg, jnp.asarray(x), jstate)
        ty, tstate = cell.decode(_t(x), tstate)
        _close(ty, jy, msg=f"step {step}")
        _close_state(tstate, jstate)


# --- mLSTM --------------------------------------------------------------------

def _mlstm_inputs(b=2, length=29, h=3, p=6, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (b, length, h, p)).astype(np.float32) for _ in range(3))
    i_raw = rng.normal(0, 1, (b, length, h)).astype(np.float32)
    f_raw = rng.normal(1, 1, (b, length, h)).astype(np.float32)
    state = jssm.MLSTMCache(C=rng.normal(0, 0.3, (b, h, p, p)).astype(np.float32),
                            n=rng.normal(0, 0.3, (b, h, p)).astype(np.float32),
                            m=rng.normal(0, 1, (b, h)).astype(np.float32))
    return (q, k, v, i_raw, f_raw), state


@pytest.mark.parametrize("length,chunk", [(29, 8), (32, 8), (3, 8)])
@pytest.mark.parametrize("from_state", [False, True])
def test_mlstm_chunk_scan_matches_jax(length, chunk, from_state):
    """L 29 at chunk 8 crosses chunks and pads the tail (i = -1e9, f = +1e9)."""
    args, state = _mlstm_inputs(length=length)
    if not from_state:
        state = jssm.MLSTMCache(np.zeros_like(state.C), np.zeros_like(state.n),
                                np.full_like(state.m, -1e9))
    jy, jstate = jssm._mlstm_chunk_scan(*map(jnp.asarray, args),
                                        jax.tree.map(jnp.asarray, state), chunk)
    ty, tstate = tssm.mlstm_chunk_scan(*map(_t, args), tssm.MLSTMCache(*map(_t, state)), chunk)
    _close(ty, jy)
    _close_state(tstate, jstate)


def test_chunked_mlstm_matches_the_jax_one_step_loop():
    """The port's chunked form against ``_mlstm_step`` run step by step in the
    JAX package: outputs and the final state (C and n at the final
    stabiliser m, which both forms carry as max over the log-weights)."""
    args, state = _mlstm_inputs(length=29, seed=1)
    q, k, v, i_raw, f_raw = map(jnp.asarray, args)
    jstate = jax.tree.map(jnp.asarray, state)
    hs = []
    for t in range(q.shape[1]):
        jstate, h_t = jssm._mlstm_step(jstate, q[:, t], k[:, t], v[:, t], i_raw[:, t],
                                       f_raw[:, t])
        hs.append(h_t)
    ty, tstate = tssm.mlstm_chunk_scan(*map(_t, args), tssm.MLSTMCache(*map(_t, state)), 8)
    _close(ty, jnp.stack(hs, axis=1), tol=1e-4)
    _close_state(tstate, jstate, tol=1e-4)


def test_mlstm_step_matches_jax():
    args, state = _mlstm_inputs(length=1, seed=2)
    q, k, v, i_raw, f_raw = (a[:, 0] for a in args)
    jstate, jh = jssm._mlstm_step(jax.tree.map(jnp.asarray, state),
                                  *map(jnp.asarray, (q, k, v, i_raw, f_raw)))
    tstate, th = tssm.mlstm_step(tssm.MLSTMCache(*map(_t, state)), *map(_t, (q, k, v, i_raw,
                                                                           f_raw)))
    _close(th, jh)
    _close_state(tstate, jstate)


def _xlstm_state(kind, jcfg, seed):
    rng = np.random.default_rng(seed)
    if kind == "mlstm":
        _, h, p = jssm._mlstm_dims(jcfg)
        return jssm.MLSTMCache(C=rng.normal(0, 0.3, (2, h, p, p)).astype(np.float32),
                               n=rng.normal(0, 0.3, (2, h, p)).astype(np.float32),
                               m=rng.normal(0, 1, (2, h)).astype(np.float32))
    h = jcfg.n_heads
    shape = (2, h, jcfg.d_model // h)
    return jssm.SLSTMCache(*(rng.normal(0, 0.5, shape).astype(np.float32) for _ in range(4)))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("length", [1, 29])
@pytest.mark.parametrize("from_state", [False, True])
def test_xlstm_cells_match_jax(kind, length, from_state):
    """``mlstm_forward`` (one step at L = 1, else the chunked form) and
    ``slstm_forward``, from zeros or from a cache; the decode entry is the
    same function in both packages."""
    jcfg, p = _cell_params(kind, 7)
    cell = _torch_cell(kind, p)
    jp = jax.tree.map(jnp.asarray, p)
    fwd = {"mlstm": jssm.mlstm_forward, "slstm": jssm.slstm_forward}[kind]
    init = {"mlstm": jssm.init_mlstm_cache, "slstm": jssm.init_slstm_cache}[kind]
    state = _xlstm_state(kind, jcfg, 8) if from_state else init(jcfg, 2)
    x = _arr(2, length, jcfg.d_model)
    jy, jstate = fwd(jp, jcfg, jnp.asarray(x), jax.tree.map(jnp.asarray, state))
    tcache = type(cell.init_cache(2))(*map(_t, state))
    ty, tstate = (cell.decode if length == 1 else cell)(_t(x), tcache)
    _close(ty, jy)
    _close_state(tstate, jstate)


def _close_norm(got, want, tol=1e-5, msg=""):
    """||got - want|| <= tol ||want||: for sums over hundreds of steps, where
    a few of thousands of entries sit a little past 1e-5 elementwise."""
    want = _t(want)
    assert torch.linalg.vector_norm(got - want) <= tol * torch.linalg.vector_norm(want), msg


def test_mlstm_cell_crosses_its_fixed_chunk():
    """300 steps: one whole chunk of 256 and a padded one, from a cache,
    through the norm's kernel entry (``use_kernel``: on the CPU the wrapper's
    plain version, which takes only the rows the kernel takes: contiguous
    ones, so a padded output must be made so). Held by norm (sums over
    256 steps)."""
    jcfg, p = _cell_params("mlstm", 9)
    cell = _torch_cell("mlstm", p)
    state = _xlstm_state("mlstm", jcfg, 10)
    x = _arr(2, 300, jcfg.d_model)
    ty, tstate = cell(_t(x), tssm.MLSTMCache(*map(_t, state)), use_kernel=True)
    jy, jstate = jssm.mlstm_forward(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x),
                                    jax.tree.map(jnp.asarray, state))
    _close_norm(ty, jy)
    for name, g, w in zip(tstate._fields, tstate, jstate):
        _close_norm(g, w, msg=name)


# --- the blocks and the plans ---------------------------------------------------

def _block_pair(kind, seed):
    arch = "zamba2-7b" if kind == "mamba2" else "xlstm-125m"
    jcfg = jax_configs.get_smoke_config(arch).model
    p = jax_transformer.init_block(jax.random.key(seed), jcfg, kind, jnp.float32)
    p = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.2 * jax.random.normal(jax.random.key(seed + 1), a.shape)
        if path[-1].key in ("scale", "A_log", "dt_bias", "if_bias", "b") else a, p)
    p = jax.tree.map(np.asarray, p)
    blk = ttransformer.RECURRENT_BLOCKS[kind](get_smoke_config(arch).model, torch.float32, "cpu")
    blk.load_state_dict({k: _t(v) for k, v in _flatten(p)})
    return jcfg, jax.tree.map(jnp.asarray, p), blk


@pytest.mark.parametrize("kind", ["mamba2", "mlstm", "slstm"])
def test_recurrent_blocks_match_jax_and_write_their_cache_in_place(kind):
    """Train (no cache), prefill from the zero cache, then two decode steps:
    outputs, and the cache the port wrote in place against the JAX block's
    returned cache."""
    jcfg, jp, blk = _block_pair(kind, 21)
    x = _arr(2, 19, jcfg.d_model)
    jy, _, _ = jax_transformer.apply_block(jp, jcfg, kind, jnp.asarray(x), mode="train",
                                           layer_idx=0)
    _close(blk(_t(x), mode="train"), jy)
    jcache = jax_transformer.init_block_cache(jcfg, kind, 2, 32, jnp.float32)
    tcache = blk.init_cache(2, 32, torch.float32)
    ids = [id(t) for t in tcache]
    jy, _, jcache = jax_transformer.apply_block(jp, jcfg, kind, jnp.asarray(x), mode="prefill",
                                                layer_idx=0, cache=jcache)
    _close(blk(_t(x), mode="prefill", cache=tcache), jy)
    _close_state(tcache, jcache)
    for step in range(2):
        x1 = _arr(2, 1, jcfg.d_model)
        jy, _, jcache = jax_transformer.apply_block(jp, jcfg, kind, jnp.asarray(x1),
                                                    mode="decode", layer_idx=0, cache=jcache,
                                                    pos=19 + step)
        _close(blk(_t(x1), mode="decode", cache=tcache, pos=19 + step), jy, msg=f"step {step}")
        _close_state(tcache, jcache)
    assert [id(t) for t in tcache] == ids


@pytest.mark.parametrize("arch", ["zamba2-7b", "xlstm-125m"])
@pytest.mark.parametrize("which", ["get_config", "get_smoke_config"])
def test_layer_plan_matches_jax(arch, which):
    """zamba2: (mamba2 x 6, shared_attn) x 13, then 3 mamba2 (81 layers, 94
    applications); xlstm: (mlstm x 3, slstm) x 3."""
    jcfg = getattr(jax_configs, which)(arch).model
    want = [k for seg in jax_transformer.plan_segments(jcfg)
            for _ in range(seg.n_units) for k in seg.kinds]
    cfg = getattr(torch_configs, which)(arch).model
    assert ttransformer.layer_plan(cfg) == want
    if which == "get_config" and arch == "zamba2-7b":
        assert len(want) == 94 and want.count("shared_attn") == 13 and want[-4:] == [
            "shared_attn", "mamba2", "mamba2", "mamba2"]


def test_zamba2_shared_block_is_one_module_with_a_cache_each_application():
    """One weight set of the shared attention block, applied once a unit, full
    causal (no window), and a KV cache of its own at each application: 13
    at full size (here 2), never one cache shared by the applications."""
    cfg = get_smoke_config("zamba2-7b").model
    model = ttransformer.LM(cfg, torch.float32, "cpu")
    shared = [blk for blk in model._apps if blk is model.shared_attn]
    assert len(shared) == cfg.n_layers // cfg.shared_attn_every == 2
    assert model.shared_attn.window == 0 and len(model.blocks) == cfg.n_layers
    cache = model.init_cache(2, 16)
    kv = [c for c, k in zip(cache, model.kinds) if k == "shared_attn"]
    assert len(kv) == 2 and all(isinstance(c, ttransformer.KVCache) for c in kv)
    assert kv[0].k.data_ptr() != kv[1].k.data_ptr()
    assert isinstance(cache[0], tssm.MambaCache) and cache[0].ssm.dtype == torch.float32
    names = {n.split(".")[0] for n, _ in model.named_parameters()}
    assert names == {"embed", "final_norm", "blocks", "shared_attn"}


def test_recurrent_state_carries_from_prefill_to_decode():
    """A recurrent model's decode step after a prefill of S tokens gives the
    logits of a prefill of the S + 1 tokens at its last position (both
    smoke configs, fp32, 1e-5), and zeroing the state in between does not."""
    for arch in ("zamba2-7b", "xlstm-125m"):
        run = get_smoke_config(arch)
        model = ttransformer.LM(run.model, torch.float32, "cpu")
        model.init_weights(torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(RNG.integers(0, run.model.vocab_size, (2, 21)).astype(np.int32))
        with torch.no_grad():
            fresh, _ = model(tokens, mode="prefill", cache=model.init_cache(2, 24, torch.float32),
                             head="last")
            steps = []
            for zero_state in (False, True):
                cache = model.init_cache(2, 24, torch.float32)
                model(tokens[:, :20], mode="prefill", cache=cache)
                if zero_state:
                    for c, kind in zip(cache, model.kinds):
                        if kind in ttransformer.RECURRENT_BLOCKS:
                            for t in c:
                                t.zero_()
                steps.append(model(tokens[:, 20:], mode="decode", cache=cache, pos=20)[0])
        torch.testing.assert_close(steps[0], fresh, atol=TOL, rtol=TOL, msg=arch)
        assert (steps[1] - fresh).abs().max() > 1e-2, arch
