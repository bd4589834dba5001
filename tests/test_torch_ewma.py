"""The port's EWMA baseline scan vs the JAX package's ``ewma_scan_kernel``.

``repro_torch.core.torchsim.kernels.ewma_scan`` on ``device="cpu"`` runs the
plain version of ``csrc/ewma_scan.cu`` (``kernels/detect_ref.ewma_scan_ref``,
through the wrapper that launches the kernel on the card). It must be within
1e-9 of the JAX package's jit kernel (run here with its ``enable_x64`` name
pointed at ``jax.enable_x64(True)``) and of ``AdaptiveBaseline.update`` (the
reference's and the port's copy), with ``count`` exactly equal: the
reference pins this scan by a tolerance, not by bits. The kernel's median
(both middle order statistics found in one set of radix passes, over a
window cut into parts whose histograms are added) is emulated in NumPy and
held to a sort. On the card (``-m gpu``) the kernel is held to the plain
version at ``bench_jaxsim.py``'s full size, on both of its paths.
"""
import re

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


SIGN = np.uint64(1 << 63)


def order_keys(x: np.ndarray) -> np.ndarray:
    """csrc/ewma_scan.cu's order_key: float64 bits as uint64 in numeric order."""
    b = x.view(np.uint64)
    return np.where(b & SIGN, ~b, b | SIGN)


def from_order_key(u: int) -> float:
    u = np.uint64(u)
    b = (u ^ SIGN) if u & SIGN else ~u
    return float(np.array([b], np.uint64).view(np.float64)[0])


def cluster_middles(window: np.ndarray, cluster: int = 2):
    """The shared-memory path's select, step by step: the window cut into
    ``cluster`` parts (``part_of``), passes of 8-bit digits,
    each counting the digits of the candidates of both middle statistics
    (one histogram while their prefixes agree), the parts' counts added,
    the digit of each statistic found from its rank; once each statistic's
    bin holds one candidate, one look over the parts finds both. Returns
    (lower middle, upper middle) of the finite values, and the passes."""
    per = window.size // cluster
    cuts = [q * per for q in range(cluster)] + [window.size]
    parts = [window[cuts[q]:cuts[q + 1]] for q in range(cluster)]
    keys = [order_keys(part[np.isfinite(part)]).astype(object) for part in parts]
    total = sum(k.size for k in keys)
    prefix, mask, k = [0, 0], 0, [(total - 1) // 2, total // 2]
    for passes, shift in enumerate(range(56, -1, -8), 1):
        same = prefix[0] == prefix[1]
        hist = [[0] * 256 for _ in range(1 if same else 2)]
        for part in keys:
            for u in part:
                for s in range(len(hist)):
                    if u & mask == prefix[s]:
                        hist[s][(u >> shift) & 255] += 1
        count = [0, 0]
        for s in range(2):
            h = hist[0 if same else s]
            c = 0
            for digit, n in enumerate(h):
                if k[s] < c + n:
                    break
                c += n
            prefix[s] |= digit << shift
            k[s] -= c
            count[s] = h[digit]
        mask |= 0xFF << shift
        if shift > 0 and count == [1, 1]:
            found = [0, 0]
            for part in keys:
                for u in part:
                    for s in range(2):
                        if u & mask == prefix[s]:
                            found[s] |= u
            prefix = found
            break
    return from_order_key(prefix[0]), from_order_key(prefix[1]), passes


@pytest.mark.parametrize("case", ["normal, 10 % NaN", "odd count", "ties and signed zeros",
                                  "infinities", "one finite value", "three cells"])
def test_cluster_select_finds_both_middles(case):
    rng = np.random.default_rng(4)
    window = rng.normal(10.0, 1.0, size=4096)
    window[rng.random(window.size) < 0.1] = np.nan
    if case == "odd count":
        window = window[np.isfinite(window)][:1001]
    elif case == "ties and signed zeros":
        window = rng.choice([-0.0, 0.0, -1.5, 2.0, 2.0, -3e-300], size=999)
    elif case == "infinities":
        window[:50] = np.inf
        window[50:120] = -np.inf
        window[120:400] = -rng.random(280)
    elif case == "one finite value":
        window = np.full(33, np.nan)
        window[17] = -7.25
    elif case == "three cells":
        window = np.array([3.0, np.nan, -1.0])
    lo, hi, passes = cluster_middles(window)
    if case == "normal, 10 % NaN":
        assert passes == 3     # and the look; 4 at the bench input's 16,384 cells
    fin = np.sort(window[np.isfinite(window)])
    n = fin.size
    assert (lo, hi) == (fin[(n - 1) // 2], fin[n // 2])
    assert np.signbit(lo) == np.signbit(fin[(n - 1) // 2])
    assert np.signbit(hi) == np.signbit(fin[n // 2])


def test_wrapper_paths_match_the_kernel_source():
    src = (_build.CSRC / "ewma_scan.cu").read_text()
    assert "1 the shared-memory path, 2 the L2 path" in src
    assert ewma.PATHS == {"smem": 1, "l2": 2}
    assert int(re.search(r"constexpr int CLUSTER = (\d+);", src).group(1)) == 2


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
    assert ewma.path_for(cells, torch.device("cuda")) == "smem"
    plain = [x.numpy() for x in tk.ewma_scan(values, *_zeros(cells), base.alpha,
                                             base.clip_sigma, device="cpu")]
    _assert_close(got, plain)


def _scan_on_path(values, mean0, dev0, count0, alpha, clip_sigma, path):
    """The wrapper's kernel told to take ``path`` (the wrapper picks by
    size): its C entry with the path's code, as the ablation calls it."""
    w, e = values.shape
    out = torch.empty((2, e), dtype=torch.float64, device=values.device)
    count = torch.empty(e, dtype=torch.int64, device=values.device)
    pool = torch.empty(2 * w, dtype=torch.float64, device=values.device)
    err = ewma._kernel()(values.data_ptr(), w, e, mean0.data_ptr(), dev0.data_ptr(),
                         count0.data_ptr(), float(alpha), float(clip_sigma), out[0].data_ptr(),
                         out[1].data_ptr(), count.data_ptr(), pool.data_ptr(), ewma.PATHS[path],
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"ewma_scan ({path} path): CUDA error {err}")
    return out[0], out[1], count


@pytest.mark.gpu
@pytest.mark.parametrize("path", sorted(ewma.PATHS))
@pytest.mark.parametrize("case", ["bench", "odd cells", "edges", "40,000 cells"])
def test_each_path_within_tolerance_on_card(path, case):
    """Both pool paths, each named to the kernel's C entry, against the
    plain version: the bench input, an odd cell count, the edge windows,
    and a window of 40,000 cells (160 KB a part of a cluster of two); the
    wrapper itself takes the shared-memory path at each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    values = {"bench": lambda: bench_values(16, 4096),
              "odd cells": lambda: bench_values(9, 4097),
              "edges": _edge_values,
              "40,000 cells": lambda: bench_values(3, 40000)}[case]()
    cells = values.shape[1]
    base = AdaptiveBaseline(n_ranks=2)
    v = torch.from_numpy(values).cuda()
    z = torch.zeros(cells, dtype=torch.float64, device="cuda")
    c = torch.zeros(cells, dtype=torch.int64, device="cuda")
    assert ewma.path_for(cells, torch.device("cuda")) == "smem"
    got = [x.cpu().numpy() for x in _scan_on_path(v, z, z, c, base.alpha, base.clip_sigma,
                                                   path)]
    torch.cuda.synchronize()
    plain = [x.numpy() for x in detect_ref.ewma_scan_ref(v.cpu(), z.cpu(), z.cpu(), c.cpu(),
                                                          base.alpha, base.clip_sigma)]
    _assert_close(got, plain)


@pytest.mark.gpu
def test_window_above_shared_memory_takes_the_l2_path_on_card():
    """60,000 cells (240 KB a part) do not fit a CTA's shared memory: the
    wrapper's kernel takes the L2 path by size, and its C entry refuses the
    shared-memory path when asked for it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    cuda = torch.device("cuda")
    assert ewma.path_for(60000, cuda) == "l2" and ewma.path_for(16384, cuda) == "smem"
    values = bench_values(2, 60000)
    base = AdaptiveBaseline(n_ranks=2)
    v = torch.from_numpy(values).cuda()
    z = torch.zeros(60000, dtype=torch.float64, device=cuda)
    c = torch.zeros(60000, dtype=torch.int64, device=cuda)
    got = [x.cpu().numpy() for x in ewma.ewma_scan(v, z, z, c, base.alpha, base.clip_sigma)]
    plain = [x.numpy() for x in detect_ref.ewma_scan_ref(v.cpu(), z.cpu(), z.cpu(), c.cpu(),
                                                          base.alpha, base.clip_sigma)]
    _assert_close(got, plain)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _scan_on_path(v, z, z, c, base.alpha, base.clip_sigma, "smem")
