"""The port's EWMA baseline scan vs the JAX package's ``ewma_scan_kernel``.

``repro_torch.core.torchsim.kernels.ewma_scan`` on ``device="cpu"`` runs the
plain version of ``csrc/ewma_scan.cu`` (``kernels/detect_ref.ewma_scan_ref``,
through the wrapper that launches the kernel on the card). It must be within
1e-9 of the JAX package's jit kernel (run here with its ``enable_x64`` name
pointed at ``jax.enable_x64(True)``) and of ``AdaptiveBaseline.update`` (the
reference's and the port's copy), with ``count`` exactly equal: the
reference pins this scan by a tolerance, not by bits. On the card (``-m
gpu``) the kernel is held to the plain version at ``bench_jaxsim.py``'s full
size.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.jaxsim.detectors as jax_detectors
import repro.core.jaxsim.kernels as jax_kernels
import repro.core.jaxsim.waterfill as jax_waterfill
from repro.core.c4d.baseline import AdaptiveBaseline as RefBaseline
from repro_torch.core.c4d.baseline import AdaptiveBaseline
from repro_torch.core.torchsim import kernels as tk
from repro_torch.kernels import _build, detect_ref
from repro_torch.kernels import ewma_scan as ewma

TOL = 1e-9
#: benchmarks/bench_jaxsim.py's ewma_scan row: (windows, cells), quick and full
SIZES = [(16, 4096), (64, 16384)]


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's jit kernels on this jax: its ``enable_x64`` names
    call ``jax.enable_x64(True)`` (nothing in ``src/repro`` changes)."""
    scope = lambda: jax.enable_x64(True)      # noqa: E731
    for mod in (jax_kernels, jax_waterfill, jax_detectors):
        monkeypatch.setattr(mod, "enable_x64", scope)


def bench_values(windows: int, cells: int) -> np.ndarray:
    """bench_jaxsim.py's input: N(10, 1), 10 % NaN, ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    values = rng.normal(10.0, 1.0, size=(windows, cells))
    values[rng.random(values.shape) < 0.1] = np.nan
    return values


def _jit(values, mean0, dev0, count0, alpha, clip):
    with jax_kernels.enable_x64():
        out = jax_kernels.ewma_scan_kernel(values, mean0, dev0, count0, alpha, clip)
        return [np.asarray(x) for x in out]


def _port(values, mean0, dev0, count0, alpha, clip):
    return [x.numpy() for x in tk.ewma_scan(values, mean0, dev0, count0, alpha, clip,
                                            device="cpu")]


def _assert_close(got, want):
    (gm, gd, gc), (wm, wd, wc) = got, want
    assert gc.dtype == np.int64 and np.array_equal(gc, wc)
    assert np.allclose(gm, wm, atol=TOL, rtol=TOL, equal_nan=True)
    assert np.allclose(gd, wd, atol=TOL, rtol=TOL, equal_nan=True)


def _zeros(cells):
    return np.zeros(cells), np.zeros(cells), np.zeros(cells, np.int64)


@pytest.mark.parametrize("windows,cells", SIZES)
def test_scan_within_tolerance_of_jit_kernel(windows, cells, x64):
    values = bench_values(windows, cells)
    base = AdaptiveBaseline(n_ranks=2)
    args = (values, *_zeros(cells), base.alpha, base.clip_sigma)
    _assert_close(_port(*args), _jit(*args))


def test_scan_equals_adaptive_baseline_update_over_a_stream(x64):
    """tests/test_jaxsim.py's stream: 10 windows of a 6 x 6 delay matrix,
    20 % NaN, folded by the reference's and the port's ``update``."""
    n = 6
    rng = np.random.default_rng(2)
    ref, ours = RefBaseline(n_ranks=n), AdaptiveBaseline(n_ranks=n)
    windows = []
    for _ in range(10):
        m = rng.normal(10.0, 1.0, size=(n, n))
        m[rng.random((n, n)) < 0.2] = np.nan
        windows.append(m)
        ref.update("delay", m)
        ours.update("delay", m)
    args = (np.stack([m.ravel() for m in windows]), *_zeros(n * n), ref.alpha, ref.clip_sigma)
    got = _port(*args)
    for base in (ref, ours):
        _assert_close(got, [base._mean["delay"].ravel(), base._dev["delay"].ravel(),
                            base._count["delay"].ravel()])
    _assert_close(got, _jit(*args))


def _edge_values():
    """Cells 0-4 of 6 windows: column 0 first seen in window 3, column 1 never
    seen, window 2 all NaN, column 4 seeded from a carry (count 2)."""
    rng = np.random.default_rng(8)
    values = rng.normal(5.0, 2.0, size=(6, 5))
    values[:3, 0] = np.nan
    values[:, 1] = np.nan
    values[2] = np.nan
    values[4, 3] = np.inf                          # not finite: not an observation
    return values


@pytest.mark.parametrize("case", ["first observation", "all-NaN window", "column never seen",
                                  "carried counts"])
def test_scan_edges(case, x64):
    values = _edge_values()
    mean0, dev0, count0 = _zeros(5)
    if case == "carried counts":
        mean0[4], dev0[4], count0[4] = 4.0, 0.5, 2
    if case == "all-NaN window":
        values = values[2:3]
    base = AdaptiveBaseline(n_ranks=5, half_life=2.0)     # its "hb" vector: 5 cells
    base._mean["hb"], base._dev["hb"] = mean0.copy(), dev0.copy()
    base._count["hb"] = count0.copy()
    args = (values, mean0, dev0, count0, base.alpha, base.clip_sigma)
    got = _port(*args)
    _assert_close(got, _jit(*args))
    for row in values:
        base.update("hb", row)
    _assert_close(got, [base._mean["hb"], base._dev["hb"], base._count["hb"]])
    if case == "column never seen":
        assert got[2][1] == 0 and got[0][1] == 0.0 and got[1][1] == 0.0
    if case == "first observation":
        assert got[2][0] == 3 and got[2][2] == 5


def test_plain_median_takes_the_mean_of_the_middles():
    """An even count of finite values: the median is 0.5 * (lo + hi), not
    torch.median's lower middle, so the seed deviation is mean |x - 2.5|."""
    values = torch.tensor([[1.0, 2.0, 3.0, 4.0, float("nan")]], dtype=torch.float64)
    zeros = torch.zeros(5, dtype=torch.float64)
    mean, dev, count = detect_ref.ewma_scan_ref(values, zeros, zeros,
                                                torch.zeros(5, dtype=torch.int64), 0.1, 3.0)
    assert dev.tolist() == [1.0, 1.0, 1.0, 1.0, 0.0]
    assert count.tolist() == [1, 1, 1, 1, 0]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    v = torch.zeros((2, 3), dtype=torch.float64)
    z, c = torch.zeros(3, dtype=torch.float64), torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError):
        ewma.ewma_scan(v.float(), z, z, c, 0.1, 3.0)
    with pytest.raises(TypeError):
        ewma.ewma_scan(v, z, z, c.to(torch.int32), 0.1, 3.0)
    with pytest.raises(ValueError):
        ewma.ewma_scan(v, z[:2], z, c, 0.1, 3.0)


def test_build_keeps_contraction_for_the_tolerance_pinned_scan():
    assert "ewma_scan" in _build.KERNELS and "--fmad=false" not in _build.flags("ewma_scan")


@pytest.mark.gpu
@pytest.mark.parametrize("windows,cells", SIZES)
def test_kernel_within_tolerance_on_card(windows, cells):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    values = bench_values(windows, cells)
    base = AdaptiveBaseline(n_ranks=2)
    before = ewma.launches
    got = [x.cpu().numpy() for x in tk.ewma_scan(values, *_zeros(cells), base.alpha,
                                                 base.clip_sigma)]
    assert ewma.launches == before + 1
    plain = [x.numpy() for x in tk.ewma_scan(values, *_zeros(cells), base.alpha,
                                             base.clip_sigma, device="cpu")]
    _assert_close(got, plain)
