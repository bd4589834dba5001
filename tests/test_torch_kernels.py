"""Port kernels' plain versions vs the JAX package's oracles, on the CPU.

The same numpy inputs go to ``repro.kernels.ref`` (jnp) and to the port's
wrappers, which compute their plain PyTorch version for CPU tensors. The
cases are those of tests/test_kernels.py plus ragged lengths and a group of
3; the tolerances are that suite's: fp32 2e-5, bf16 2e-2 (atol = rtol), and
1e-5 for RMSNorm in fp32, forward and backward (``rmsnorm_bwd`` against
``jax.vjp`` of the JAX oracle). The Pallas ``rmsnorm_fwd`` cannot be imported
on this jax (it needs ``jax_compat``), so the oracle is the one the JAX suite
holds it to. The CUDA kernels themselves run only on the card (``-m gpu``,
and chip_smoke.py), held to their plain versions by the per-row limit
``ref.ROW_REL_TOL``.
"""
import ctypes
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import chunked_causal_attention as jax_chunked
from repro_torch.kernels import _build, ablate_decode, ablate_flash, ablate_rmsnorm, ops
from repro_torch.kernels import ablate_ewma, ablate_slow_fold, ablate_waterfill
from repro_torch.kernels import decode_attention as decode_mod
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import rmsnorm as rmsnorm_mod
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd, group_passes
from repro_torch.kernels.rmsnorm import RMSNormFn, rmsnorm_bwd, rmsnorm_fwd
from repro_torch.models.attention import chunked_causal_attention as torch_chunked

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jnp and a torch array of ``dtype``."""
    return jnp.asarray(a, JNP[dtype]), torch.from_numpy(a).to(TORCH[dtype])


def _close(got_torch, want_jax, dtype: str):
    tol = TOL[dtype]
    np.testing.assert_allclose(got_torch.float().numpy(), np.asarray(want_jax, np.float32),
                               atol=tol, rtol=tol)


def _qkv(rng, b, s, h, hkv, d, sk=None):
    sk = s if sk is None else sk
    return (rng.normal(0, 1, (b, s, h, d)).astype(np.float32),
            rng.normal(0, 1, (b, sk, hkv, d)).astype(np.float32),
            rng.normal(0, 1, (b, sk, hkv, d)).astype(np.float32))


FLASH_CASES = [
    # (b, s, h, hkv, d), window, cap, dtype: tests/test_kernels.py FLASH_CASES
    ((2, 256, 4, 2, 64), None, 0.0, "float32"),
    ((1, 512, 8, 4, 64), 128, 0.0, "float32"),
    ((2, 256, 4, 1, 32), None, 50.0, "float32"),
    ((1, 256, 2, 2, 128), 100, 30.0, "bfloat16"),
    ((1, 384, 6, 2, 64), 64, 0.0, "float32"),
    ((3, 128, 8, 8, 64), None, 0.0, "bfloat16"),
    # ragged S (no block of 8 divides it) and a group of 3
    ((1, 100, 9, 3, 64), None, 50.0, "float32"),
    ((2, 300, 4, 2, 32), 50, 0.0, "float32"),
    # head_dims 160 (stablelm-12b, group 4) and 112 (zamba2-7b), ragged S
    ((1, 100, 8, 2, 160), None, 0.0, "bfloat16"),
    ((2, 77, 8, 2, 160), 32, 50.0, "float32"),
    ((1, 90, 4, 1, 112), None, 30.0, "bfloat16"),
    ((2, 70, 6, 3, 112), 40, 0.0, "float32"),
]


@pytest.mark.parametrize("dims,window,cap,dtype", FLASH_CASES)
def test_flash_attention_matches_jax_oracle(dims, window, cap, dtype):
    b, s, h, hkv, d = dims
    rng = np.random.default_rng(0)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in _qkv(rng, b, s, h, hkv, d))
    scale = d ** -0.5
    got = flash_attention_fwd(qt, kt, vt, window=window, logit_cap=cap, scale=scale)
    want = jref.flash_attention(qj, kj, vj, window=window, logit_cap=cap, scale=scale)
    assert got.dtype == TORCH[dtype] and got.shape == (b, s, h, d)
    _close(got, want, dtype)


DECODE_CASES = [
    # (b, s, h, hkv, d), pos, window, cap, dtype: tests/test_kernels.py DECODE_CASES
    ((2, 1024, 8, 2, 64), 700, None, 0.0, "float32"),
    ((1, 512, 4, 4, 128), 100, 64, 50.0, "bfloat16"),
    ((2, 2048, 16, 2, 64), 2000, None, 0.0, "float32"),
    ((4, 256, 4, 1, 32), 0, None, 0.0, "float32"),      # first token
    # ragged cache lengths: 100, and the serve slice's 4384 (prompt 4352 + 32)
    ((1, 100, 9, 3, 64), 99, 30, 50.0, "float32"),
    ((1, 4384, 4, 2, 64), 4383, 4096, 50.0, "float32"),
    # head_dims 160 (stablelm-12b's group of 4) and 112, ragged caches
    ((2, 300, 8, 2, 160), 299, None, 0.0, "bfloat16"),
    ((1, 1000, 8, 2, 160), 700, 256, 50.0, "float32"),
    ((1, 201, 4, 1, 112), 130, 64, 30.0, "float32"),
]


@pytest.mark.parametrize("dims,pos,window,cap,dtype", DECODE_CASES)
def test_decode_attention_matches_jax_oracle(dims, pos, window, cap, dtype):
    b, s, h, hkv, d = dims
    rng = np.random.default_rng(1)
    q, kc, vc = _qkv(rng, b, 1, h, hkv, d, sk=s)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, kc, vc))
    scale = d ** -0.5
    got = decode_attention_fwd(qt, kt, vt, pos, window=window, logit_cap=cap, scale=scale)
    want = jref.decode_attention(qj, kj, vj, pos, window=window, logit_cap=cap, scale=scale)
    assert got.dtype == TORCH[dtype] and got.shape == (b, 1, h, d)
    _close(got, want, dtype)


def _window_lo(pos, window):
    return max(0, pos - window + 1) if window else 0


@pytest.mark.parametrize("lo,pos,b,hkv", [
    (0, 0, 2, 4), (0, 63, 2, 4), (0, 64, 2, 4), (288, 4383, 2, 4), (0, 4383, 2, 4),
    (4383, 4383, 1, 1), (100, 4383, 1, 1), (0, 4383, 8, 8), (5, 70, 1, 3), (63, 64, 1, 1)])
def test_plan_splits_cover_the_key_range_once(lo, pos, b, hkv):
    """The kernel's split plan: every key of [lo, pos] in exactly one split, in
    order, no split empty, whole 64-key tiles cut only at lo and pos, and
    min(tiles, ceil(2 * 132 / (B * Hkv))) splits on a 132-SM card."""
    ranges = tref.plan_splits(lo, pos, 132, b, hkv)
    keys = [k for k0, k1 in ranges for k in range(k0, k1 + 1)]
    assert keys == list(range(lo, pos + 1))
    assert all(k0 <= k1 for k0, k1 in ranges)
    assert all(k0 % 64 == 0 for k0, _ in ranges[1:]) and all(k1 % 64 == 63 for _, k1 in ranges[:-1])
    n_tiles = pos // 64 - lo // 64 + 1
    assert len(ranges) == min(n_tiles, -(-2 * 132 // (b * hkv)))


@pytest.mark.parametrize("kind", ["flash", "decode"])
def test_dispatch_rule_matches_the_kernel_source(kind):
    """The head_dims each .cu dispatch instantiates its bf16 tensor-core
    (flash) or TMA (decode) kernel for are the Python rule's, 112 and 160
    among them; fp32, a head_dim not listed and a group above 8 take the
    CUDA-core kernels."""
    if kind == "flash":
        src = (_build.CSRC / "flash_attention.cu").read_text()
        dims = {int(x) for x in re.findall(r"return \(int\)launch_wgmma<(\d+)>\(", src)}
        rule, listed = flash_mod.wgmma_path, flash_mod.WGMMA_HEAD_DIMS
    else:
        src = (_build.CSRC / "decode_attention.cu").read_text()
        dims = {int(x) for x in re.findall(r"return \(int\)launch_tma_g<(\d+)>\(", src)}
        gate = re.search(r"bool tma_path\(int dtype, int D, int group\) \{(.*?)\}", src, re.S)
        assert {int(x) for x in re.findall(r"D == (\d+)", gate.group(1))} == dims
        rule, listed = decode_mod.tma_path, decode_mod.TMA_HEAD_DIMS
    assert dims == set(listed) and {112, 160} <= dims
    for d in range(8, 600, 8):
        assert rule(torch.bfloat16, d, 4) == (d in dims)
        assert not rule(torch.float32, d, 4)
    assert rule(torch.bfloat16, 160, flash_mod.MAX_GROUP)
    assert not rule(torch.bfloat16, 160, flash_mod.MAX_GROUP + 1)
    assert flash_mod.pass_group(32 // 2) == 8 and flash_mod.pass_group(9) == 5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [160, 112])
@pytest.mark.parametrize("kind", ["flash", "decode"])
def test_zero_padded_head_dim_leaves_the_plain_result(kind, d, dtype):
    """The premise of the kernels' last box, whose columns past D arrive as
    TMA's zeros: q, k and v zero-padded from D to the next multiple of 64
    (160 -> 192, 112 -> 128), at the scale of the true D, give the plain
    result's first D columns, and zeros after them."""
    b, s, h, hkv = 2, 90, 8, 2
    (qj, qt), (kj, kt), (vj, vt) = _wide_inputs(kind, b, s, h, hkv, d, dtype)
    kw = dict(window=40, logit_cap=30.0, scale=d ** -0.5)
    dp = -(-d // 64) * 64
    pad = [torch.nn.functional.pad(t, (0, dp - d)) for t in (qt, kt, vt)]
    got = _attention(kind, *pad, **kw)
    assert got.shape[-1] == dp and not got[..., d:].any()
    _close(got[..., :d].contiguous(), _attention(kind, qt, kt, vt, **kw).float().numpy(), dtype)
    _close(got[..., :d].contiguous(), _jax_attention(kind, qj, kj, vj, **kw), dtype)


def test_split_plan_constants_match_the_kernel_source():
    """ref's mirror of the plan uses the kernel's tile and splits per SM."""
    src = (_build.CSRC / "decode_attention.cu").read_text()
    assert int(re.search(r"constexpr int TK = (\d+);", src).group(1)) == tref.DECODE_TILE
    assert int(re.search(r"constexpr int SPLITS_PER_SM = (\d+);", src).group(1)) == \
        tref.DECODE_SPLITS_PER_SM


@pytest.mark.parametrize("nsplit", [1, 2, 7, "max"])
@pytest.mark.parametrize("dims,pos,window,cap,dtype", DECODE_CASES)
def test_decode_split_mirror_matches_jax_oracle(dims, pos, window, cap, dtype, nsplit):
    """The split kernel's algorithm (per-split partials merged in split
    order) against the JAX oracle and the port's plain version."""
    b, s, h, hkv, d = dims
    rng = np.random.default_rng(1)
    q, kc, vc = _qkv(rng, b, 1, h, hkv, d, sk=s)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in (q, kc, vc))
    scale = d ** -0.5
    ranges = tref.split_ranges(_window_lo(pos, window), pos, 1 << 20 if nsplit == "max" else nsplit)
    got = tref.decode_attention_split(qt, kt, vt, pos, window=window, logit_cap=cap, scale=scale,
                                      ranges=ranges)
    assert got.dtype == TORCH[dtype] and got.shape == (b, 1, h, d)
    _close(got, jref.decode_attention(qj, kj, vj, pos, window=window, logit_cap=cap, scale=scale),
           dtype)
    _close(got, tref.decode_attention(qt, kt, vt, pos, window=window, logit_cap=cap, scale=scale)
           .float().numpy(), dtype)


@pytest.mark.parametrize("case", ["pos 0", "window 1", "window 64", "all-masked split"])
def test_decode_split_mirror_edges(case):
    """pos 0 and window 1 (one key), a window of one tile at a ragged lo,
    and a split whose keys all lie below a ragged lo: its partial (max
    NEG_INF, every weight exp(0) = 1) must be wiped by the merge."""
    rng = np.random.default_rng(11)
    q, kc, vc = (torch.from_numpy(a) for a in _qkv(rng, 2, 1, 6, 2, 64, sk=300))
    pos, window = {"pos 0": (0, None), "window 1": (250, 1), "window 64": (250, 64),
                   "all-masked split": (250, 100)}[case]
    kw = dict(window=window, logit_cap=30.0, scale=0.125)
    lo = _window_lo(pos, window)
    ranges = tref.split_ranges(lo, pos, 1 << 20)
    if case == "all-masked split":
        ranges = [(0, lo - 1)] + ranges     # keys 0..150, all outside the window
    got = tref.decode_attention_split(q, kc, vc, pos, ranges=ranges, **kw)
    want = tref.decode_attention(q, kc, vc, pos, **kw)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape,dtype", [
    ((4, 37, 96), "float32"), ((512, 1024), "bfloat16"), ((2, 3, 5, 256), "float32")])
def test_rmsnorm_ref_matches_jax_oracle(shape, dtype):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.normal(0, 1, shape).astype(np.float32), dtype)
    sj, st = _pair(rng.normal(0, 0.1, shape[-1:]).astype(np.float32), dtype)
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    np.testing.assert_allclose(tref.rmsnorm(xt, st).float().numpy(),
                               np.asarray(jref.rmsnorm(xj, sj), np.float32), atol=tol, rtol=tol)


RMSNORM_CASES = [((4, 37, 96), "float32"), ((512, 1024), "bfloat16"),
                 ((2, 3, 5, 256), "float32")]      # tests/test_kernels.py


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("shape,dtype", RMSNORM_CASES)
def test_ops_rmsnorm_matches_jax_oracle(shape, dtype, use_kernel):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng.normal(0, 1, shape).astype(np.float32), dtype)
    sj, st = _pair(rng.normal(0, 0.1, shape[-1:]).astype(np.float32), dtype)
    tol = 1e-5 if dtype == "float32" else TOL[dtype]
    got = ops.rmsnorm(xt, st, 1e-6, use_kernel=use_kernel)
    assert got.dtype == TORCH[dtype] and got.shape == shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jref.rmsnorm(xj, sj), np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("shape", [(4, 37, 96), (2, 3, 5, 256), (3, 37, 100)])
def test_rmsnorm_bwd_matches_jax_vjp(shape):
    rng = np.random.default_rng(6)
    x, dy = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(2))
    scale = rng.normal(0, 0.3, shape[-1:]).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b, 1e-6), jnp.asarray(x), jnp.asarray(scale))
    want_dx, want_ds = vjp(jnp.asarray(dy))
    dx, ds = rmsnorm_bwd(*(torch.from_numpy(a) for a in (x, scale, dy)), eps=1e-6)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), atol=1e-5, rtol=1e-5)


def test_rmsnorm_fn_gradients_equal_autograd_of_plain_version():
    rng = np.random.default_rng(7)
    x0 = torch.from_numpy(rng.normal(0, 1, (3, 5, 64)).astype(np.float32))
    s0 = torch.from_numpy(rng.normal(0, 0.3, (64,)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 1, (3, 5, 64)).astype(np.float32))
    grads = []
    for fn in (lambda x, s: RMSNormFn.apply(x, s, 1e-6), lambda x, s: tref.rmsnorm(x, s, 1e-6)):
        x, s = x0.clone().requires_grad_(), s0.clone().requires_grad_()
        fn(x, s).backward(dy)
        grads.append((x.grad, s.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


SPLIT_CASES = [((4, 37, 96), "float32"), ((2, 3, 5, 256), "float32"), ((64, 512), "bfloat16")]


def _split_inputs(shape, dtype, seed=11):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    scale = rng.normal(0, 0.3, shape[-1:]).astype(np.float32)
    return _pair(x, dtype), _pair(scale, dtype)


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("shape,dtype", SPLIT_CASES)
def test_rmsnorm_split_mode_matches_jax_apply_rmsnorm_on_whole_rows(shape, dtype, shards):
    """The split mode's plain version over column shards (each shard's sum
    of squares, their sum, each shard scaled by the whole row's factor),
    through the wrappers' CPU path, against the JAX package's
    ``apply_rmsnorm`` of the whole rows: 2e-5 fp32, 2e-2 bf16."""
    from repro.models.layers import apply_rmsnorm
    (xj, xt), (sj, st) = _split_inputs(shape, dtype)
    xs, ss = [c.contiguous() for c in xt.chunk(shards, -1)], list(st.chunk(shards))
    total = sum(rmsnorm_mod.rmsnorm_sumsq(x) for x in xs)
    got = torch.cat([rmsnorm_mod.rmsnorm_scale(x, total, s, shape[-1], 1e-6)
                     for x, s in zip(xs, ss)], dim=-1)
    assert got.dtype == TORCH[dtype] and got.shape == shape
    _close(got, apply_rmsnorm({"scale": sj}, xj, 1e-6), dtype)
    plain = torch.cat(tref.rmsnorm_split(xs, ss), dim=-1)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("shape", [(4, 37, 96), (2, 3, 5, 256)])
def test_rmsnorm_split_backward_matches_jax_vjp(shape, shards):
    """``rmsnorm_split_bwd`` of each shard, its row sums summed over the
    shards, against ``jax.vjp`` of ``apply_rmsnorm`` on the whole rows:
    dx by columns and the scale's gradient, 1e-5."""
    from repro.models.layers import apply_rmsnorm
    rng = np.random.default_rng(12)
    x, dy = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(2))
    scale = rng.normal(0, 0.3, shape[-1:]).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: apply_rmsnorm({"scale": b}, a, 1e-6), jnp.asarray(x),
                     jnp.asarray(scale))
    want_dx, want_ds = vjp(jnp.asarray(dy))
    xs, dys = (torch.from_numpy(a).chunk(shards, -1) for a in (x, dy))
    ss = torch.from_numpy(scale).chunk(shards)
    total = sum(tref.rmsnorm_sumsq(a) for a in xs)
    # the backward's all-reduce, over the shards in one process: each
    # shard's row sums of g * x_hat, summed, handed to every shard's call
    parts = []
    probe = rmsnorm_mod.Split(shape[-1], lambda t: parts.append(t) or t)
    for a, s, g in zip(xs, ss, dys):
        rmsnorm_mod.rmsnorm_split_bwd(a, s, g, total, probe, 1e-6)
    whole = rmsnorm_mod.Split(shape[-1], lambda t: sum(parts))
    got = [rmsnorm_mod.rmsnorm_split_bwd(a, s, g, total, whole, 1e-6)
           for a, s, g in zip(xs, ss, dys)]
    np.testing.assert_allclose(torch.cat([d for d, _ in got], -1).numpy(), np.asarray(want_dx),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(torch.cat([d for _, d in got]).numpy(), np.asarray(want_ds),
                               atol=1e-5, rtol=1e-5)


def test_rmsnorm_fn_split_of_one_shard_equals_autograd_of_the_whole_row():
    """``RMSNormFn`` with a ``Split`` whose reduce is the identity (one
    rank holds the whole row), through ``ops.rmsnorm``: output and
    gradients against autograd of the plain whole-row version, 1e-5; its
    forward without grad takes no autograd node."""
    rng = np.random.default_rng(13)
    x0 = torch.from_numpy(rng.normal(0, 1, (3, 5, 64)).astype(np.float32))
    s0 = torch.from_numpy(rng.normal(0, 0.3, (64,)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 1, (3, 5, 64)).astype(np.float32))
    split = ops.Split(64, lambda t: t)
    outs, grads = [], []
    for fn in (lambda x, s: ops.rmsnorm(x, s, 1e-6, split=split),
               lambda x, s: ops.rmsnorm(x, s, 1e-6, use_kernel=False, split=split),
               lambda x, s: tref.rmsnorm(x, s, 1e-6)):
        x, s = x0.clone().requires_grad_(), s0.clone().requires_grad_()
        out = fn(x, s)
        out.backward(dy)
        outs.append(out.detach())
        grads.append((x.grad, s.grad))
    for got in range(2):
        torch.testing.assert_close(outs[got], outs[2], atol=1e-5, rtol=1e-5)
        for a, b in zip(grads[got], grads[2]):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        assert ops.rmsnorm(x0, s0, 1e-6, split=split).grad_fn is None


def test_split_limit_sees_the_planted_split_fault():
    """A split mode that normalises each shard by its own columns reads
    above ROW_REL_TOL at zamba2-7b's gated-norm width cut into 8 shards in
    bf16, while the sound split mode reads within it."""
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.normal(0, 1, (4, 64, 7168)).astype(np.float32))
    x[..., :896] *= 3.0          # shards of unequal size, as a rank's heads can be
    x = x.bfloat16()
    scale = torch.from_numpy(rng.normal(0, 0.1, (7168,)).astype(np.float32)).bfloat16()
    xs, ss = [c.contiguous() for c in x.chunk(8, -1)], list(scale.chunk(8))
    want = tref.rmsnorm(x, scale)
    tol = tref.ROW_REL_TOL[torch.bfloat16]
    assert tref.max_row_rel_err(torch.cat(tref.rmsnorm_split(xs, ss), -1), want) <= tol
    assert tref.max_row_rel_err(torch.cat(tref.rmsnorm_split_fault(xs, ss), -1), want) > tol


@pytest.mark.parametrize("how", ["no_grad", "no input requires grad"])
def test_ops_rmsnorm_without_a_backward_skips_the_autograd_node(how):
    """Where no backward can be taken, ``ops.rmsnorm`` calls ``rmsnorm_fwd``
    directly: the plain version's output, with no ``grad_fn``."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.normal(0, 1, (3, 5, 64)).astype(np.float32))
    s = torch.from_numpy(rng.normal(0, 0.3, (64,)).astype(np.float32))
    if how == "no_grad":
        x.requires_grad_()
        with torch.no_grad():
            got = ops.rmsnorm(x, s, 1e-6)
    else:
        got = ops.rmsnorm(x, s, 1e-6)
    assert got.grad_fn is None and not got.requires_grad
    assert torch.equal(got, tref.rmsnorm(x.detach(), s, 1e-6))


def test_ops_rmsnorm_with_grad_takes_rmsnorm_fn():
    """With grad enabled and an input that requires it, ``ops.rmsnorm`` goes
    through ``RMSNormFn`` and gives its gradients."""
    rng = np.random.default_rng(9)
    x0 = torch.from_numpy(rng.normal(0, 1, (3, 5, 64)).astype(np.float32))
    s0 = torch.from_numpy(rng.normal(0, 0.3, (64,)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(0, 1, (3, 5, 64)).astype(np.float32))
    grads = []
    for fn in (lambda x, s: ops.rmsnorm(x, s, 1e-6), lambda x, s: RMSNormFn.apply(x, s, 1e-6)):
        x, s = x0.clone().requires_grad_(), s0.clone().requires_grad_()
        out = fn(x, s)
        assert type(out.grad_fn).__name__ == "RMSNormFnBackward"
        out.backward(dy)
        grads.append((x.grad, s.grad))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_rmsnorm_max_width_matches_the_kernel_source():
    """The wrapper's MAX_WIDTH is the widest row of the source's CTA: MAX_NP
    pieces for each of MAX_THREADS threads."""
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    np_ = int(re.search(r"constexpr int MAX_NP = (\d+);", src).group(1))
    threads = int(re.search(r"constexpr int MAX_THREADS = (\d+);", src).group(1))
    assert rmsnorm_mod.MAX_WIDTH == np_ * threads


@pytest.mark.parametrize("fault", sorted(tref.RMSNORM_FAULTS))
def test_row_rel_limit_sees_planted_rmsnorm_faults(fault):
    """Each planted RMSNorm fault reads above ROW_REL_TOL at the path's width
    in bf16 (the tail fault on a ragged fp32 width: in bf16 at D=2304 a
    dropped tail reads under the limit), while rounding the exact output to
    bf16 reads within it."""
    rng = np.random.default_rng(8)
    shape, dtype = ((3, 37, 100), torch.float32) if fault == "tail4" else \
        ((4, 64, 2304), torch.bfloat16)
    x = torch.from_numpy(rng.normal(1.0 if fault == "layernorm" else 0.0, 1, shape)
                         .astype(np.float32)).to(dtype)
    scale = torch.from_numpy(rng.normal(0, 0.1, shape[-1:]).astype(np.float32)).to(dtype)
    want = tref.rmsnorm(x, scale)
    tol = tref.ROW_REL_TOL[dtype]
    assert tref.max_row_rel_err(tref.rmsnorm_fault(x, scale, 1e-6, fault), want) > tol
    exact = tref.rmsnorm(x.float(), scale.float())
    assert tref.max_row_rel_err(exact.to(dtype), exact) <= tol


def test_ops_plain_flash_attention_is_the_jax_cpu_lowering():
    """``use_kernel=False`` is the query-chunked attention, as in the JAX ops
    (bf16 probabilities before PV), over several chunks."""
    rng = np.random.default_rng(9)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "bfloat16") for a in _qkv(rng, 1, 1100, 2, 1, 32))
    kw = dict(window=100, logit_cap=50.0, scale=32 ** -0.5)     # 1100 > the chunk of 1024
    _close(ops.flash_attention(qt, kt, vt, use_kernel=False, **kw),
           jops.flash_attention(qj, kj, vj, use_kernel=False, **kw), "bfloat16")


@pytest.mark.parametrize("window,cap", [(None, 0.0), (100, 30.0)])
def test_ops_cpu_matches_jax_chunked_attention(window, cap):
    """ops on CPU tensors against the JAX CPU lowering, with q_chunk < S."""
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "float32") for a in _qkv(rng, 2, 300, 4, 2, 32))
    want = jax_chunked(qj, kj, vj, window=window, logit_cap=cap, scale=0.125, q_chunk=64)
    for use_kernel in (True, False):
        got = ops.flash_attention(qt, kt, vt, window=window, logit_cap=cap, scale=0.125,
                                  use_kernel=use_kernel)
        _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_causal_attention_matches_jax(dtype):
    rng = np.random.default_rng(4)
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, dtype) for a in _qkv(rng, 2, 200, 6, 2, 32))
    kw = dict(window=48, logit_cap=50.0, scale=32 ** -0.5, q_chunk=64)
    _close(torch_chunked(qt, kt, vt, **kw), jax_chunked(qj, kj, vj, **kw), dtype)


@pytest.mark.parametrize("q_std", [1.0, 8.0])
def test_bf16_probabilities_stay_within_the_row_limit(q_std):
    """The bf16 flash kernel rounds p to bf16 before PV, as the plain chunked
    attention does. That rounding, at gemma2's head_dim, group, window and
    cap, must read within ROW_REL_TOL per row of the fp32-p plain version,
    with half the limit to spare (it reads ~5e-3), so that the on-card limit
    accepts the kernel's rounding and still sees the planted faults."""
    rng = np.random.default_rng(10)
    q, k, v = _qkv(rng, 1, 1024, 8, 4, 256)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q * q_std, k, v))
    kw = dict(window=512, logit_cap=50.0, scale=256 ** -0.5)
    want = tref.flash_attention(q, k, v, **kw)
    got = torch_chunked(q, k, v, **kw)
    assert got.dtype == torch.bfloat16
    assert tref.max_row_rel_err(got, want) <= 0.75 * tref.ROW_REL_TOL[torch.bfloat16]


# a rank's shard of a 96-position sequence: 24 query positions from q0 on,
# every key; q0 0, an unaligned middle and the last shard
OFFSETS = (0, 37, 72)


@pytest.mark.parametrize("group", [1, 2, 7])
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("window", [0, 20])
@pytest.mark.parametrize("q0", OFFSETS)
def test_flash_with_a_query_offset_matches_the_jax_rows(q0, window, cap, group):
    """q of 24 positions at global offset ``q0`` against all 96 keys (a
    window shorter than the offset, a cap, groups 1, 2 and 7): the plain
    version with ``q_offset``, the chunked attention with ``q_offset`` and
    ``ops.flash_attention`` both ways on the CPU all match rows [q0, q0 +
    24) of the JAX chunked attention over the whole sequence, fp32 2e-5."""
    rng = np.random.default_rng(20 + q0)
    b, s, sq, hkv, d = 2, 96, 24, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = (_pair(a, "float32") for a in
                                    _qkv(rng, b, s, hkv * group, hkv, d))
    kw = dict(window=window, logit_cap=cap, scale=d ** -0.5)
    want = np.asarray(jax_chunked(qj, kj, vj, q_chunk=32, **kw))[:, q0:q0 + sq]
    qs = qt[:, q0:q0 + sq].contiguous()
    got = {"ref": tref.flash_attention(qs, kt, vt, q_offset=q0, **kw),
           "chunked": torch_chunked(qs, kt, vt, q_offset=q0, q_chunk=16, **kw),
           "ops kernel": ops.flash_attention(qs, kt, vt, q_offset=q0, use_kernel=True, **kw),
           "ops plain": ops.flash_attention(qs, kt, vt, q_offset=q0, use_kernel=False, **kw)}
    for name, out in got.items():
        assert out.shape == qs.shape, name
        np.testing.assert_allclose(out.numpy(), want, atol=2e-5, rtol=2e-5, err_msg=name)


@pytest.mark.parametrize("q_offset,sk", [(-1, 96), (73, 96), (0, 23)])
def test_flash_refuses_an_offset_outside_the_keys(q_offset, sk):
    """``q_offset < 0`` and ``q_offset + Sq > Sk`` are refused by name."""
    q = torch.zeros(1, 24, 2, 16)
    kv = torch.zeros(1, sk, 1, 16)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention_fwd(q, kv, kv, q_offset=q_offset, scale=0.25)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, kv, kv, q_offset=q_offset, scale=0.25)


@pytest.mark.parametrize("pos", [40, 95])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_shard_mode_runs_a_group_of_12_in_passes(dtype, pos):
    """The decode kernel's shard mode at a group of 12 query heads a kv head
    (48 on 4): ``shard_passes`` with the plain shard as each pass (on the
    card, each pass is one launch) runs passes of 6 and 6, writes each
    pass's float32 out and lse columns, and equals the plain shard of the
    whole group, at 1e-6, for each of 4 shards of a 96-key cache (at pos 40
    the last two lie wholly past it: out 0, lse NEG_INF); the shards merged
    match the whole cache's plain decode."""
    rng = np.random.default_rng(30)
    b, s, hkv, group, d = 2, 96, 4, 12, 32
    q, k, v = (torch.from_numpy(a).to(TORCH[dtype]) for a in
               _qkv(rng, b, 1, hkv * group, hkv, d, sk=s))
    kw = dict(window=64, logit_cap=30.0, scale=d ** -0.5)
    outs, lses = [], []
    for k0 in range(0, s, 24):
        ks, vs = k[:, k0:k0 + 24].contiguous(), v[:, k0:k0 + 24].contiguous()
        passes = []

        def plain_pass(qp):
            passes.append(qp.shape[2] // hkv)
            return tref.decode_attention_shard(qp, ks, vs, pos, k0=k0, **kw)

        out, lse = decode_mod.shard_passes(plain_pass, q, hkv)
        want_out, want_lse = tref.decode_attention_shard(q, ks, vs, pos, k0=k0, **kw)
        assert passes == [6, 6] and out.dtype == lse.dtype == torch.float32
        assert out.shape == (b, 1, hkv * group, d) and lse.shape == (b, hkv * group)
        np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-6, rtol=1e-6)
        wrapped = decode_attention_fwd(q, ks, vs, pos, k0=k0, return_lse=True, **kw)
        assert all(torch.equal(a, w) for a, w in zip(wrapped, (want_out, want_lse)))
        if k0 > pos:
            assert not out.any() and bool((lse == tref.NEG_INF).all())
        outs.append(out)
        lses.append(lse)
    merged = tref.merge_shards(outs, lses)
    whole = tref.decode_attention(q.float(), k.float(), v.float(), pos, **kw)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), atol=1e-5, rtol=1e-5)


SPLIT_FAULTS = ["one split's keys dropped", "one 64-key tile counted twice"]


@pytest.mark.parametrize("fault", ["window ignored", "last 128 keys dropped", "cap ignored",
                                   *SPLIT_FAULTS])
def test_row_rel_limit_sees_planted_faults(fault):
    """The on-card limit tells a wrongly written decode kernel from a sound one:
    its plain version at a long cache reads above ROW_REL_TOL, while the same
    output rounded to bf16 reads within it. The split kernel's faults (a
    split lost in the merge, a tile loaded twice) are planted at the serve
    shape, B=2, cache 4384, 8 heads on 4, D=256, window 4096, on the plan of
    a 132-SM card."""
    if fault in SPLIT_FAULTS:
        _split_fault_reads_above_the_limit(fault)
        return
    rng = np.random.default_rng(5)
    s, pos, window, cap = 2200, 2199, 2048, 50.0
    q, kc, vc = (torch.from_numpy(a).bfloat16() for a in _qkv(rng, 2, 1, 8, 4, 64, sk=s))
    if fault == "cap ignored":
        q = (q.float() * 8).bfloat16()   # scores of std 8: the cap bends them
    kw = dict(window=window, logit_cap=cap, scale=64 ** -0.5)
    want = tref.decode_attention(q, kc, vc, pos, **kw)
    wrong = {"window ignored": dict(pos=pos, window=0),
             "last 128 keys dropped": dict(pos=pos - 128, window=window - 128),
             "cap ignored": dict(pos=pos, logit_cap=0.0)}[fault]
    bad = tref.decode_attention(q, kc, vc, **{**kw, **wrong})
    tol = tref.ROW_REL_TOL[torch.bfloat16]
    assert tref.max_row_rel_err(bad, want) > tol
    exact = tref.decode_attention(q.float(), kc.float(), vc.float(), pos, **kw)
    assert tref.max_row_rel_err(exact.bfloat16(), exact) <= tol
    assert tref.max_row_rel_err(want, want) == 0.0


def _split_fault_reads_above_the_limit(fault):
    rng = np.random.default_rng(12)
    s, pos, window, cap = 4384, 4383, 4096, 50.0
    q, kc, vc = (torch.from_numpy(a).bfloat16() for a in _qkv(rng, 2, 1, 8, 4, 256, sk=s))
    kw = dict(window=window, logit_cap=cap, scale=256 ** -0.5)
    ranges = tref.plan_splits(_window_lo(pos, window), pos, 132, 2, 4)
    mid = len(ranges) // 2
    if fault == SPLIT_FAULTS[0]:
        wrong = ranges[:mid] + ranges[mid + 1:]
    else:
        t0 = ranges[mid][0]
        wrong = ranges + [(t0, t0 + 63)]
    want = tref.decode_attention(q, kc, vc, pos, **kw)
    sound = tref.decode_attention_split(q, kc, vc, pos, ranges=ranges, **kw)
    bad = tref.decode_attention_split(q, kc, vc, pos, ranges=wrong, **kw)
    tol = tref.ROW_REL_TOL[torch.bfloat16]
    assert tref.max_row_rel_err(bad, want) > tol
    assert tref.max_row_rel_err(sound, want) <= tol


def _bad_inputs():
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 2, 16)
    return {
        "int dtype": dict(q=q.int(), k=kv.int(), v=kv.int()),
        "mixed dtype": dict(q=q, k=kv.bfloat16(), v=kv),
        "non-contiguous": dict(q=q.transpose(1, 2).contiguous().transpose(1, 2), k=kv, v=kv),
        "heads do not group": dict(q=torch.zeros(1, 8, 3, 16), k=kv, v=kv),
        "head_dim 0": dict(q=torch.zeros(1, 8, 4, 0), k=torch.zeros(1, 8, 2, 0),
                           v=torch.zeros(1, 8, 2, 0)),
        "3-d input": dict(q=q[0], k=kv, v=kv),
        "negative window": dict(q=q, k=kv, v=kv, window=-1),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    kw = _bad_inputs()[case]
    with pytest.raises((ValueError, TypeError)):
        flash_attention_fwd(**kw, scale=0.25)
    with pytest.raises((ValueError, TypeError)):
        decode_attention_fwd(kw["q"][:, :1] if kw["q"].dim() == 4 else kw["q"], kw["k"],
                             kw["v"], 3, window=kw.get("window"), scale=0.25)


@pytest.mark.parametrize("pos", [-1, 8])
def test_decode_rejects_pos_outside_cache(pos):
    with pytest.raises(ValueError):
        decode_attention_fwd(torch.zeros(1, 1, 4, 16), torch.zeros(1, 8, 2, 16),
                             torch.zeros(1, 8, 2, 16), pos, scale=0.25)


def _attention(kind, q, k, v, **kw):
    """The plain version of ``kind`` (decode: the last position's query
    against the whole cache)."""
    if kind == "flash":
        return tref.flash_attention(q, k, v, **kw)
    return tref.decode_attention(q, k, v, k.shape[1] - 1, **kw)


def _jax_attention(kind, q, k, v, **kw):
    if kind == "flash":
        return jref.flash_attention(q, k, v, **kw)
    return jref.decode_attention(q, k, v, k.shape[1] - 1, **kw)


def _wide_inputs(kind, b, s, h, hkv, d, dtype):
    rng = np.random.default_rng(13)
    arrays = _qkv(rng, b, s if kind == "flash" else 1, h, hkv, d, sk=s)
    return [_pair(a, dtype) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [9, 16])
@pytest.mark.parametrize("kind", ["flash", "decode"])
def test_group_above_8_runs_in_passes_of_at_most_8(kind, group, dtype):
    """A group above 8 query heads a kv head: ``group_passes`` with the
    plain version as each pass (on the card, each pass is one launch of
    the kernel) is held to the unsplit plain version and to the JAX
    reference, and the wrapper takes the shape."""
    b, s, hkv, d = 2, 40, 2, 32
    (qj, qt), (kj, kt), (vj, vt) = _wide_inputs(kind, b, s, hkv * group, hkv, d, dtype)
    kw = dict(window=24, logit_cap=30.0, scale=d ** -0.5)
    passes = []

    def plain_pass(qp, kp, vp):
        passes.append(qp.shape[2] // hkv)
        return _attention(kind, qp, kp, vp, **kw)

    got = group_passes(plain_pass, qt, kt, vt)
    assert passes == {9: [5, 4], 16: [8, 8]}[group]
    assert got.dtype == TORCH[dtype] and got.shape == qt.shape
    _close(got, _attention(kind, qt, kt, vt, **kw).float().numpy(), dtype)
    _close(got, _jax_attention(kind, qj, kj, vj, **kw), dtype)
    wrapper = flash_attention_fwd if kind == "flash" else (
        lambda q, k, v, **a: decode_attention_fwd(q, k, v, s - 1, **a))
    _close(wrapper(qt, kt, vt, **kw), _jax_attention(kind, qj, kj, vj, **kw), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [320, 576])
@pytest.mark.parametrize("kind", ["flash", "decode"])
def test_head_dim_above_256_runs_in_column_passes(kind, d, dtype):
    """A head_dim above 256: the wrapper takes it (on the CPU, the plain
    version), and the kernels' split of it (passes of 256 output columns,
    each with the scores over the whole head_dim: the plain version with V
    cut to the pass's columns) is held to the JAX reference."""
    b, s, h, hkv = 1, 36, 4, 2
    (qj, qt), (kj, kt), (vj, vt) = _wide_inputs(kind, b, s, h, hkv, d, dtype)
    kw = dict(window=20, logit_cap=50.0, scale=d ** -0.5)
    want = _jax_attention(kind, qj, kj, vj, **kw)
    got = (flash_attention_fwd(qt, kt, vt, **kw) if kind == "flash"
           else decode_attention_fwd(qt, kt, vt, s - 1, **kw))
    assert got.dtype == TORCH[dtype] and got.shape == qt.shape
    _close(got, want, dtype)
    cols = [_attention(kind, qt, kt, vt[..., c0:c0 + 256].contiguous(), **kw)
            for c0 in range(0, d, 256)]
    assert [c.shape[-1] for c in cols] == [256] * (d // 256) + [d % 256]
    _close(torch.cat(cols, dim=-1), want, dtype)


def test_cpu_tensors_launch_nothing_and_build_nothing():
    ops.reset_launch_counts()
    q, k, v = (torch.zeros(1, 8, h, 16) for h in (4, 2, 2))
    ops.flash_attention(q, k, v, scale=0.25)
    ops.decode_attention(q[:, :1], k, v, 5, scale=0.25)
    ops.rmsnorm(q, torch.zeros(16))
    assert ops.launch_counts() == {"flash_attention": 0, "decode_attention": 0, "rmsnorm": 0}
    assert _build._LIBS == {}


def _bad_norm_inputs():
    x, s = torch.zeros(2, 3, 16), torch.zeros(16)
    return {
        "int dtype": (x.int(), s),
        "int scale": (x, s.int()),
        "non-contiguous": (x.transpose(0, 1), s),
        "scale not (D,)": (x, torch.zeros(8)),
        "2-d scale": (x, torch.zeros(1, 16)),
        "0-d x": (torch.zeros(()), s),
        "not a tensor": (x.numpy(), s),
        "devices differ": (x.to("meta"), s),
    }


# the error each rejected input raises, and words of its message naming the rule
_NORM_REJECTIONS = {
    "int dtype": (TypeError, "dtypes"), "int scale": (TypeError, "dtypes"),
    "non-contiguous": (ValueError, "contiguous"), "scale not (D,)": (ValueError, "shapes"),
    "2-d scale": (ValueError, "shapes"), "0-d x": (ValueError, "shapes"),
    "not a tensor": (TypeError, "tensors"), "devices differ": (ValueError, "devices differ"),
}


@pytest.mark.parametrize("case", sorted(_bad_norm_inputs()))
def test_rmsnorm_rejects_what_the_kernel_does_not_take(case):
    kind, words = _NORM_REJECTIONS[case]
    with pytest.raises(kind, match=words):
        rmsnorm_fwd(*_bad_norm_inputs()[case])


@pytest.mark.parametrize("name", sorted(ablate_flash.ABLATIONS))
def test_flash_ablations_edit_the_kernel_source(name):
    """Each design choice ablate_flash.py undoes is found in the kernel
    source and changed, so that an edit of the kernel cannot leave an
    ablation timing the kernel as it is."""
    src = ablate_flash.SOURCE.read_text()
    assert ablate_flash.ABLATIONS[name][1](src) != src


@pytest.mark.parametrize("name", sorted(ablate_decode.ABLATIONS))
def test_decode_ablations_edit_the_kernel_source(name):
    """As for flash: each choice ablate_decode.py undoes is in the source."""
    src = ablate_decode.SOURCE.read_text()
    assert ablate_decode.ABLATIONS[name][1](src) != src


@pytest.mark.parametrize("module,name", [(m, n) for m in (ablate_rmsnorm, ablate_slow_fold)
                                         for n in sorted(m.ABLATIONS)])
def test_rmsnorm_and_slow_fold_ablations_edit_the_kernel_source(module, name):
    """Each design choice the two ablations undo is found in the source (the
    first designs replace it whole, from ``csrc/earlier``)."""
    src = module.SOURCE.read_text()
    edited = module.ABLATIONS[name][1](src)
    assert edited != src and "__global__" in edited


def test_an_edited_header_changes_the_build_target(monkeypatch, tmp_path):
    """A kernel is rebuilt when a csrc/ header it includes, directly or
    through another header, changes; a header it does not include does not
    matter."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "a.cuh"\nint k;\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text("int b = 1;\n")
    (csrc / "other.cuh").write_text("int c = 1;\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    before = _build._target("k")
    (csrc / "other.cuh").write_text("int c = 2;\n")
    assert _build._target("k") == before
    (csrc / "b.cuh").write_text("int b = 2;\n")
    after = _build._target("k")
    assert after != before and after.parent == before.parent
    assert [p.name for p in _build._local_includes(csrc / "k.cu")] == ["a.cuh", "b.cuh"]


def test_flash_and_decode_share_the_tma_header():
    for name in ("flash_attention", "decode_attention"):
        assert _build.CSRC / "tma.cuh" in _build._local_includes(_build.CSRC / f"{name}.cu")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()


# --- on the card only ------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


GPU_CASES = [  # bf16 flash with a head_dim of WGMMA_HEAD_DIMS takes the wgmma kernel
    ("flash", (2, 300, 9, 3, 64), 100, 50.0, "float32"),
    ("flash", (1, 520, 8, 4, 256), 128, 50.0, "bfloat16"),
    ("flash", (2, 1000, 9, 3, 64), 300, 50.0, "bfloat16"),
    ("flash", (1, 777, 6, 2, 128), 0, 30.0, "bfloat16"),
    ("flash", (1, 1, 8, 1, 64), 0, 0.0, "bfloat16"),          # S = 1, group 8
    ("flash", (3, 17, 4, 4, 128), 5, 0.0, "bfloat16"),        # S below one tile
    ("flash", (1, 600, 8, 4, 256), 64, 50.0, "bfloat16"),     # window of one key tile
    ("flash", (2, 333, 4, 2, 128), 1, 0.0, "bfloat16"),       # window 1: the diagonal only
    ("flash", (2, 1000, 8, 4, 256), 0, 50.0, "bfloat16"),     # S ragged against 64-position
    ("flash", (1, 4333, 8, 4, 256), 4096, 50.0, "bfloat16"),  # q tiles and 64-key tiles
    ("flash", (1, 900, 8, 1, 128), 200, 30.0, "bfloat16"),    # group 8 at D=128
    ("flash", (1, 1500, 3, 1, 64), 300, 50.0, "bfloat16"),    # group 3: 126-row CTAs
    ("flash", (1, 4352, 8, 4, 256), 4096, 50.0, "bfloat16"),  # the prefill shape, batch 1
    ("flash", (2, 300, 4, 2, 16), 16, 50.0, "bfloat16"),      # bf16 on the CUDA cores:
    ("flash", (1, 200, 3, 3, 24), 16, 0.0, "bfloat16"),       # the smoke configs' head_dims
    ("decode", (2, 4384, 8, 4, 256), 4096, 50.0, "bfloat16"),
    ("decode", (1, 100, 6, 2, 24), 0, 0.0, "float32"),
    ("decode", (2, 300, 6, 2, 256), 0, 30.0, "float32"),      # two 16-byte loads a lane
    ("decode", (1, 1, 8, 1, 64), 0, 0.0, "bfloat16"),         # a one-entry cache
    # a group above 8 in passes of at most 8 (the wgmma and TMA kernels at
    # 16 = 8 + 8, the CUDA cores at 9 = 5 + 4)
    ("flash", (1, 700, 32, 2, 128), 256, 50.0, "bfloat16"),
    ("flash", (2, 300, 18, 2, 64), 0, 0.0, "float32"),
    ("decode", (2, 4384, 32, 2, 128), 4096, 50.0, "bfloat16"),
    ("decode", (1, 500, 18, 2, 64), 0, 30.0, "float32"),
    # head_dim above 256 on the CUDA cores, in passes of 256 output columns
    ("flash", (1, 400, 8, 4, 320), 128, 50.0, "float32"),
    ("flash", (1, 400, 8, 4, 320), 0, 50.0, "bfloat16"),
    ("flash", (1, 300, 4, 2, 576), 100, 0.0, "bfloat16"),
    ("decode", (2, 1000, 8, 4, 320), 0, 50.0, "float32"),
    ("decode", (2, 1000, 8, 4, 320), 512, 50.0, "bfloat16"),
    ("decode", (1, 700, 4, 2, 576), 0, 0.0, "float32"),
    # head_dims 160 (stablelm-12b) and 112 (zamba2-7b): bf16 on the wgmma and
    # TMA kernels over ceil(D / 64) boxes, the last partly out of bounds;
    # group 4 and 8, a window of one key tile, S below one tile, ragged S
    ("flash", (1, 1000, 32, 8, 160), 0, 0.0, "bfloat16"),
    ("flash", (2, 700, 16, 2, 160), 64, 50.0, "bfloat16"),
    ("flash", (3, 20, 8, 2, 160), 0, 30.0, "bfloat16"),
    ("flash", (1, 4352, 32, 8, 160), 0, 0.0, "bfloat16"),     # stablelm's prefill, batch 1
    ("flash", (1, 777, 8, 2, 112), 0, 0.0, "bfloat16"),
    ("flash", (2, 500, 8, 1, 112), 64, 50.0, "bfloat16"),
    ("flash", (1, 30, 4, 1, 112), 0, 0.0, "bfloat16"),
    ("flash", (1, 300, 8, 2, 160), 100, 50.0, "float32"),      # fp32: the CUDA cores
    ("flash", (1, 300, 8, 2, 112), 0, 0.0, "float32"),
    ("decode", (2, 4384, 32, 8, 160), 0, 0.0, "bfloat16"),    # stablelm's decode shape
    ("decode", (1, 1000, 16, 2, 112), 0, 30.0, "bfloat16"),
    ("decode", (1, 500, 8, 2, 160), 0, 0.0, "float32"),
]
# the flash kernel with a query offset: (b, sq, sk, q_off, h, hkv, d), window,
# cap, dtype. The last of 8 shards of the prefill at gemma2-2b's, yi-34b's
# (group 7) and stablelm-12b's shapes; offsets that are not a multiple of a
# CTA's 128 / group positions or of a 64-key tile; the CUDA cores (fp32, a
# bf16 head_dim off the wgmma list, above 256) and a group above 8 in passes;
# offset 0 with more keys than queries (a prefix)
GPU_OFFSET_CASES = [
    ((2, 544, 4352, 3808, 8, 4, 256), 4096, 50.0, "bfloat16"),
    ((2, 544, 4352, 3808, 8, 4, 256), 0, 50.0, "bfloat16"),
    ((1, 544, 4352, 3808, 56, 8, 128), 0, 0.0, "bfloat16"),
    ((1, 544, 4352, 1000, 32, 8, 160), 0, 0.0, "bfloat16"),
    ((1, 300, 1000, 333, 9, 3, 64), 100, 50.0, "bfloat16"),
    ((1, 300, 1000, 333, 9, 3, 64), 100, 50.0, "float32"),
    ((1, 200, 700, 499, 18, 2, 64), 0, 0.0, "bfloat16"),
    ((2, 100, 700, 37, 4, 2, 320), 64, 50.0, "bfloat16"),
    ((1, 17, 4352, 4335, 8, 4, 256), 1, 0.0, "bfloat16"),
    ((2, 60, 4352, 4292, 8, 4, 256), 4096, 50.0, "bfloat16"),
    ((1, 300, 700, 0, 8, 4, 256), 0, 0.0, "bfloat16"),
    ((2, 50, 300, 250, 4, 2, 16), 16, 50.0, "bfloat16"),
]
# the bf16 split kernel (TMA_HEAD_DIMS): (b, s, h, hkv, d), pos, window, cap.
# pos at and around a tile edge, windows of one key and one tile, B * Hkv = 1
# (the most splits) and 64 (one split each), group 8 and 3, each head_dim
GPU_DECODE_CASES = [
    ((2, 4384, 8, 4, 256), 0, 4096, 50.0),
    ((2, 4384, 8, 4, 256), 63, 4096, 50.0),
    ((2, 4384, 8, 4, 256), 64, 0, 50.0),
    ((2, 4384, 8, 4, 256), 4383, 0, 50.0),
    ((2, 4384, 8, 4, 256), 4383, 1, 50.0),
    ((2, 4384, 8, 4, 256), 4000, 64, 0.0),
    ((1, 5000, 2, 1, 256), 4999, 0, 50.0),
    ((8, 700, 64, 8, 128), 650, 0, 0.0),
    ((1, 3000, 8, 1, 128), 2999, 1000, 30.0),
    ((2, 2000, 9, 3, 64), 1999, 0, 0.0),
    ((1, 4500, 4, 2, 64), 4321, 4096, 50.0),
    # head_dim 160 (PV by 4-byte words) and 112 (28 of 32 lanes a unit)
    ((2, 4384, 32, 8, 160), 4383, 0, 0.0),
    ((2, 4384, 32, 8, 160), 63, 0, 0.0),
    ((2, 4384, 32, 8, 160), 64, 64, 50.0),
    ((1, 3000, 16, 2, 160), 2999, 1, 0.0),
    ((1, 40, 4, 1, 160), 39, 0, 30.0),
    ((8, 700, 64, 8, 160), 650, 0, 0.0),
    ((2, 2000, 8, 2, 112), 1999, 0, 50.0),
    ((1, 4500, 8, 1, 112), 4095, 4096, 0.0),
    ((1, 64, 16, 2, 112), 63, 0, 0.0),
]


GPU_NORM_CASES = [  # the path's shapes, the JAX suite's, ragged, narrow, wide, mixed dtypes
    ((1, 4096, 2304), "bfloat16", "bfloat16"),
    ((2, 1, 2304), "bfloat16", "bfloat16"),
    ((4, 37, 96), "float32", "float32"),
    ((512, 1024), "bfloat16", "bfloat16"),
    ((3, 37, 100), "float32", "float32"),
    ((5, 101), "bfloat16", "bfloat16"),       # 101 bf16: not whole 16-byte pieces
    ((7, 64), "bfloat16", "float32"),
    ((3, 8192), "float32", "bfloat16"),
    ((2, 8191), "float32", "float32"),        # the widest row of element pieces
    ((3, 37, 101), "float32", "float32"),     # 101 fp32: one element a piece
    ((1, 2304), "bfloat16", "bfloat16"),      # 1 row; the prefill's 8704 rows
    ((8704, 2304), "bfloat16", "bfloat16"),
    ((2, 2304), "bfloat16", "float32"),       # 32 bytes of scale beside a piece
    ((4096, 2304), "bfloat16", "float32"),
    ((3, 4096), "float32", "float32"),        # 1024 pieces: one a thread; then two
    ((3, 4100), "float32", "float32"),
    ((5, 8192), "bfloat16", "bfloat16"),      # 1024 threads of one piece
]


@pytest.mark.gpu
def test_cuda_ops_rmsnorm_without_grad_launches_once(cuda):
    x = torch.randn((2, 1, 2304), device=cuda).bfloat16().requires_grad_()
    s = torch.zeros(2304, device=cuda).bfloat16()
    before = rmsnorm_mod.launches
    with torch.no_grad():
        got = ops.rmsnorm(x, s)
    assert rmsnorm_mod.launches == before + 1 and got.grad_fn is None


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,scale_dtype", GPU_NORM_CASES)
def test_cuda_rmsnorm_matches_plain_version(cuda, shape, dtype, scale_dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(TORCH[dtype])
    s = (0.1 * torch.randn(shape[-1:], generator=gen, device=cuda)).to(TORCH[scale_dtype])
    dy = torch.randn(shape, generator=gen, device=cuda).to(TORCH[dtype])
    got = rmsnorm_fwd(x, s)
    torch.cuda.synchronize()
    tol = tref.ROW_REL_TOL[TORCH[dtype]]
    assert got.dtype == x.dtype and torch.isfinite(got).all()
    assert tref.max_row_rel_err(got, tref.rmsnorm(x, s)) <= tol
    grads = []
    for fn in (lambda a, b: RMSNormFn.apply(a, b, 1e-6), tref.rmsnorm):
        xx, ss = x.clone().requires_grad_(), s.clone().requires_grad_()
        fn(xx, ss).backward(dy)
        grads.append((xx.grad, ss.grad))
    (dx, ds), (want_dx, want_ds) = grads
    assert tref.max_row_rel_err(dx, want_dx) <= tol
    assert tref.max_row_rel_err(ds.float()[None], want_ds.float()[None]) <= 1e-2


GPU_SPLIT_CASES = [  # zamba2-7b's gated norm in 8 shards, decode rows, shards not whole
    ((2, 4352, 7168), "bfloat16", "bfloat16", 8),  # 16-byte pieces, mixed dtypes, narrow
    ((2, 1, 7168), "bfloat16", "bfloat16", 8),
    ((4, 37, 96), "float32", "float32", 4),
    ((3, 37, 100), "float32", "float32", 4),
    ((5, 102), "bfloat16", "bfloat16", 2),
    ((7, 64), "bfloat16", "float32", 2),
    ((3, 8192), "float32", "bfloat16", 8),
    ((2, 4352, 1536), "bfloat16", "bfloat16", 16),  # xlstm-125m's mLSTM norm at model 16
    ((2, 4352, 768), "bfloat16", "bfloat16", 16),   # its sLSTM norm: 48 columns a shard
    ((2, 1, 1536), "bfloat16", "bfloat16", 16),
    ((2, 1, 768), "bfloat16", "bfloat16", 16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,scale_dtype,shards", GPU_SPLIT_CASES)
def test_cuda_rmsnorm_split_mode_matches_plain_version(cuda, shape, dtype, scale_dtype, shards):
    """The split mode's two launches over column shards, their sums added,
    against the plain whole row (``ROW_REL_TOL``) and the whole-row launch;
    the backward through ``RMSNormFn`` with a ``Split`` of one shard
    against the plain version's autograd."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(shape, generator=gen, device=cuda).to(TORCH[dtype])
    s = (0.1 * torch.randn(shape[-1:], generator=gen, device=cuda)).to(TORCH[scale_dtype])
    xs, ss = [c.contiguous() for c in x.chunk(shards, -1)], list(s.chunk(shards))
    before = rmsnorm_mod.split_launches
    total = sum(rmsnorm_mod.rmsnorm_sumsq(a) for a in xs)
    got = torch.cat([rmsnorm_mod.rmsnorm_scale(a, total, b, shape[-1]) for a, b in zip(xs, ss)],
                    -1)
    torch.cuda.synchronize()
    assert rmsnorm_mod.split_launches == before + 2 * shards
    tol = tref.ROW_REL_TOL[TORCH[dtype]]
    assert tref.max_row_rel_err(got, tref.rmsnorm(x, s)) <= tol
    assert tref.max_row_rel_err(got, rmsnorm_fwd(x, s)) <= tol
    dy = torch.randn(shape, generator=gen, device=cuda).to(TORCH[dtype])
    grads = []
    for fn in (lambda a, b: RMSNormFn.apply(a, b, 1e-6, rmsnorm_mod.Split(shape[-1], lambda t: t)),
               tref.rmsnorm):
        xx, sc = x.clone().requires_grad_(), s.clone().requires_grad_()
        fn(xx, sc).backward(dy)
        grads.append((xx.grad, sc.grad))
    (dx, ds), (want_dx, want_ds) = grads
    assert tref.max_row_rel_err(dx, want_dx) <= tol
    assert tref.max_row_rel_err(ds.float()[None], want_ds.float()[None]) <= 1e-2


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dims,window,cap,dtype", GPU_CASES)
def test_cuda_kernel_matches_plain_version(cuda, kind, dims, window, cap, dtype):
    b, s, h, hkv, d = dims
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(TORCH[dtype])

    kw = dict(window=window, logit_cap=cap, scale=d ** -0.5)
    if kind == "flash":
        q, k, v = rand(b, s, h, d), rand(b, s, hkv, d), rand(b, s, hkv, d)
        got, want = flash_attention_fwd(q, k, v, **kw), tref.flash_attention(q, k, v, **kw)
    else:
        q, k, v = rand(b, 1, h, d), rand(b, s, hkv, d), rand(b, s, hkv, d)
        got = decode_attention_fwd(q, k, v, s - 1, **kw)
        want = tref.decode_attention(q, k, v, s - 1, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert tref.max_row_rel_err(got, want) <= tref.ROW_REL_TOL[TORCH[dtype]]


@pytest.mark.gpu
@pytest.mark.parametrize("dims,window,cap,dtype", GPU_OFFSET_CASES)
def test_cuda_flash_with_a_query_offset_matches_plain_version(cuda, dims, window, cap, dtype):
    """Rows at a query offset against every key: within ROW_REL_TOL of the
    plain version with ``q_offset`` and of the whole-sequence launch's rows
    [q_off, q_off + Sq); at offset 0 the whole launch's first rows exactly."""
    b, sq, sk, q_off, h, hkv, d = dims
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(TORCH[dtype])

    kw = dict(window=window, logit_cap=cap, scale=d ** -0.5)
    q, k, v = rand(b, sk, h, d), rand(b, sk, hkv, d), rand(b, sk, hkv, d)
    qs = q[:, q_off:q_off + sq].contiguous()
    got = flash_attention_fwd(qs, k, v, q_offset=q_off, **kw)
    whole = flash_attention_fwd(q, k, v, **kw)[:, q_off:q_off + sq]
    want = tref.flash_attention(qs, k, v, q_offset=q_off, **kw)
    torch.cuda.synchronize()
    tol = tref.ROW_REL_TOL[TORCH[dtype]]
    assert torch.isfinite(got).all() and got.shape == qs.shape
    assert tref.max_row_rel_err(got, want) <= tol
    assert tref.max_row_rel_err(got, whole) <= tol
    if q_off == 0:
        assert torch.equal(got, whole)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_decode_shard_mode_runs_a_group_of_12_in_passes(cuda, dtype):
    """The shard mode at 48 query heads on 4 kv heads (two launches of 6
    a kv head each) over 8 shards of 548 keys, pos in the seventh: each
    shard's float32 out and lse against the plain shard, and the merge
    within ROW_REL_TOL[float32] of the plain shards merged."""
    from repro_torch.kernels import decode_attention as da
    b, s, h, hkv, d, pos = 2, 4384, 48, 4, 128, 3500
    gen = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(TORCH[dtype])
               for shape in ((b, 1, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    kw = dict(window=0, logit_cap=0.0, scale=d ** -0.5)
    before = da.launches
    parts, plain = [], []
    for k0 in range(0, s, 548):
        ks, vs = k[:, k0:k0 + 548].contiguous(), v[:, k0:k0 + 548].contiguous()
        parts.append(decode_attention_fwd(q, ks, vs, pos, k0=k0, return_lse=True, **kw))
        plain.append(tref.decode_attention_shard(q, ks, vs, pos, k0=k0, **kw))
    torch.cuda.synchronize()
    assert da.launches - before == 16
    got, want = tref.merge_shards(*zip(*parts)), tref.merge_shards(*zip(*plain))
    assert torch.isfinite(got).all()
    assert tref.max_row_rel_err(got, want) <= tref.ROW_REL_TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("dims,pos,window,cap", GPU_DECODE_CASES)
def test_cuda_decode_split_kernel_matches_plain_version(cuda, dims, pos, window, cap):
    """Within ROW_REL_TOL of the plain version, twice on the same inputs with
    bit-equal results (the splits merge in a fixed order), and again on a
    second cache after a launch of another shape (the counters were left 0)."""
    b, s, h, hkv, d = dims
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).bfloat16()

    kw = dict(window=window, logit_cap=cap, scale=d ** -0.5)
    tol = tref.ROW_REL_TOL[torch.bfloat16]
    q, k, v = rand(b, 1, h, d), rand(b, s, hkv, d), rand(b, s, hkv, d)
    got = decode_attention_fwd(q, k, v, pos, **kw)
    again = decode_attention_fwd(q, k, v, pos, **kw)
    decode_attention_fwd(rand(1, 1, 2, 64), rand(1, 77, 1, 64), rand(1, 77, 1, 64), 76,
                         scale=0.125)
    k2, v2 = rand(b, s, hkv, d), rand(b, s, hkv, d)
    got2 = decode_attention_fwd(q, k2, v2, pos, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got.view(torch.int16), again.view(torch.int16))
    assert tref.max_row_rel_err(got, tref.decode_attention(q, k, v, pos, **kw)) <= tol
    assert tref.max_row_rel_err(got2, tref.decode_attention(q, k2, v2, pos, **kw)) <= tol


@pytest.mark.parametrize("module,name", [(m, n) for m in (ablate_waterfill, ablate_ewma)
                                         for n in sorted(m.ABLATIONS) if n != "l2_path"])
def test_waterfill_and_ewma_ablations_edit_the_kernel_source(module, name):
    """Each design choice the two ablations undo is found in the source (the
    first designs replace it whole, from ``csrc/earlier``; the EWMA scan's
    L2 path is the source as it is, told to take that path)."""
    src = module.SOURCE.read_text()
    edited = module.ABLATIONS[name][1](src)
    assert edited != src and "__global__" in edited
