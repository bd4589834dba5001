"""The port's water-filling (``FlowSet.max_min`` at ``backend="torch"``) vs the
JAX package's.

On the CPU the torch branch runs the plain version of ``csrc/waterfill.cu``
(``kernels/waterfill.py::waterfill_ref``, reached through the wrapper that
launches the kernel on the card). Its rates, connection rates and link
utilisations must be bit-equal to the JAX package's NumPy loop and to its
jit kernel (``FlowSet.max_min(backend="jax")``, which runs here once the
``enable_x64`` name it calls is pointed at ``jax.enable_x64(True)``; jax 0.9
dropped ``jax.experimental.enable_x64``), on 40 random fabrics (links failed
in the odd ones), on the Fig. 2 fabric with and without CNP jitter and on a
10,240-GPU fabric. On the card (``-m gpu``) both variants of the kernel are
held bit-equal to the plain version and to NumPy.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core.jaxsim.detectors as jax_detectors
import repro.core.jaxsim.kernels as jax_kernels
import repro.core.jaxsim.waterfill as jax_waterfill
from repro.core.c4p.master import job_ring_requests
from repro.core.c4p.pathalloc import ecmp_allocate
from repro.core.flowset import FlowSet as RefFlowSet
from repro.core.topology import ClosTopology as RefClos
from repro_torch.core import netsim, topology, torchsim
from repro_torch.core.flowset import FlowSet
from repro_torch.kernels import _build, waterfill

N_RANDOM = 40
FIELDS = ("flow_rate", "conn_rate", "link_util", "link_touched", "flow_alive")


@pytest.fixture
def x64(monkeypatch):
    """The JAX package's jit kernels on this jax: its ``enable_x64`` names
    call ``jax.enable_x64(True)`` (nothing in ``src/repro`` changes)."""
    scope = lambda: jax.enable_x64(True)      # noqa: E731
    for mod in (jax_kernels, jax_waterfill, jax_detectors):
        monkeypatch.setattr(mod, "enable_x64", scope)


def _perf():
    """tests/test_netsim_perf.py, loaded by its path (an installed package
    named ``tests`` may shadow this directory)."""
    path = Path(__file__).with_name("test_netsim_perf.py")
    spec = importlib.util.spec_from_file_location("_waterfill_netsim_perf", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_netsim_perf = _perf()


def clos_scenario(n_hosts: int):
    """tests/test_netsim_perf.py's Fig. 2 scenario on ``n_hosts`` hosts: a ring
    job on the even hosts and a two-host tenant on each pair of the others,
    ECMP-allocated, 16 flows a host. At 128 hosts it is the Fig. 2 fabric
    (``FABRIC_1024GPU``), at 1,280 the 10,240-GPU fabric."""
    topo = RefClos(n_hosts=n_hosts, n_leaf_pairs=n_hosts // 8, n_spines=8,
                   n_host_groups=n_hosts // 8)
    hosts = [(i * 2) % n_hosts for i in range(n_hosts // 2)]
    free = sorted(set(range(n_hosts)) - set(hosts))
    flows = ecmp_allocate(topo, job_ring_requests(0, hosts, topo.nics_per_host), seed=0)
    half = len(free) // 2
    for b in range(half):
        flows += ecmp_allocate(topo, job_ring_requests(
            100 + b, [free[b], free[b + half]], topo.nics_per_host), seed=77 * b)
    for i, f in enumerate(flows):
        f.flow_id = i
    return topo, flows


_random = []


def random_scenario(i: int):
    """The i-th of 40 fabrics of tests/test_netsim_perf.py's generator
    (``default_rng(5)``), links failed in the odd ones."""
    if not _random:
        rng = np.random.default_rng(5)
        _random.extend(_netsim_perf._random_scenario(rng, fail_links=bool(k % 2))
                       for k in range(N_RANDOM))
    return _random[i]


def _port(ref_topo, ref_flows):
    init = {f.name: getattr(ref_topo, f.name)
            for f in dataclasses.fields(ref_topo) if f.init and not f.name.startswith("_")}
    init["down_links"] = set(ref_topo.down_links)
    return FlowSet(topology.ClosTopology(**init),
                   [netsim.Flow(**dataclasses.asdict(f)) for f in ref_flows])


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _assert_equal(got, want):
    for field in FIELDS:
        x, y = getattr(got, field), getattr(want, field)
        assert x.shape == y.shape and np.array_equal(_bits(x), _bits(y)), field


def _hold(ref_topo, ref_flows, **kw):
    """The port's torch branch on the CPU against the JAX package's NumPy loop
    and jit kernel, and the port's NumPy loop, all bit-equal."""
    ref = RefFlowSet(ref_topo, ref_flows)
    want = ref.max_min(**kw)
    fs = _port(ref_topo, ref_flows)
    _assert_equal(fs.max_min(backend="torch", device="cpu", **kw), want)
    _assert_equal(fs.max_min(backend="numpy", **kw), want)
    _assert_equal(ref.max_min(backend="jax", **kw), want)
    return fs


@pytest.mark.parametrize("i", range(N_RANDOM))
def test_random_fabric_bit_equal_to_numpy_and_jit(i, x64):
    _hold(*random_scenario(i))


@pytest.mark.parametrize("jitter", [0.0, 0.05])
def test_fig2_fabric_bit_equal_to_numpy_and_jit(jitter, x64):
    topo, flows = clos_scenario(128)
    assert [dataclasses.astuple(f) for f in flows] == \
        [dataclasses.astuple(f) for f in _netsim_perf._fig2_scenario()[1]]
    fs = _hold(topo, flows, cnp_jitter=jitter, seed=3)
    assert (fs.n_flows, fs.n_links, fs.pair_flow.size) == (2048, 4094, 7432)


def test_10240_gpu_fabric_bit_equal_to_numpy_and_jit(x64):
    fs = _hold(*clos_scenario(1280))
    assert (fs.n_flows, fs.n_links, fs.pair_flow.size) == (20480, 40948, 74298)
    ptr, flow = waterfill.link_csr(fs.pair_flow, fs.pair_link, fs.n_links)
    rate, remaining, rounds = waterfill.waterfill(*(torch.from_numpy(a) for a in (
        ptr, flow, np.maximum(fs.weights, 1e-9), fs.alive_mask(), fs.base_cap)))
    assert int(rounds[0]) == 57
    assert int(np.diff(ptr).max()) == 18


def test_torch_branch_goes_through_the_wrapper_numpy_through_none(monkeypatch):
    calls = []
    real = waterfill.waterfill
    monkeypatch.setattr(waterfill, "waterfill",
                        lambda *a, **kw: calls.append(a[2].device.type) or real(*a, **kw))
    monkeypatch.delenv(torchsim.BACKEND_ENV, raising=False)
    fs = _port(*random_scenario(3))
    fs.max_min(backend="numpy")
    assert calls == []
    fs.max_min(device="cpu")                       # the port's default backend: torch
    with torchsim.use_backend("numpy"):
        fs.max_min()
    assert calls == ["cpu"]
    assert waterfill.launches == 0                 # the CPU launches nothing


def test_torch_branch_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fs = _port(*random_scenario(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fs.max_min(backend="torch")
    fs.max_min(backend="numpy")                    # NumPy never resolves a device


def test_auto_backend_by_flows(monkeypatch):
    monkeypatch.setenv(torchsim.BACKEND_ENV, "auto")
    assert torchsim.effective_backend(flows=torchsim.AUTO_WATERFILL_FLOWS - 1) == "numpy"
    assert torchsim.effective_backend(flows=torchsim.AUTO_WATERFILL_FLOWS) == "torch"
    assert torchsim.effective_backend(flows=None) == "numpy"


def test_link_csr_keeps_each_links_pairs_in_pair_order():
    fs = _port(*random_scenario(5))
    ptr, flow = waterfill.link_csr(fs.pair_flow, fs.pair_link, fs.n_links)
    assert ptr[0] == 0 and ptr[-1] == fs.pair_flow.size
    for link in range(fs.n_links):
        assert flow[ptr[link]:ptr[link + 1]].tolist() == \
            fs.pair_flow[fs.pair_link == link].tolist()


def test_link_columns_list_each_links_pairs_in_order():
    ptr = torch.tensor([0, 3, 4, 4 + 5, 9 + 1])
    cols = waterfill.link_columns(ptr)
    assert cols[1] == [4, 2, 2, 1, 1]
    got = waterfill._link_sums(cols, torch.arange(10, dtype=torch.float64)[None])
    assert got[0].tolist() == [0 + 1 + 2, 3, 4 + 5 + 6 + 7 + 8, 9]
    assert waterfill.pair_links(ptr).tolist() == [0, 0, 0, 1, 2, 2, 2, 2, 2, 3]


def test_plain_version_sums_in_pair_order():
    """A link whose unfrozen weight depends on the order of its sum:
    1 + 1e-16 + 1e-16 is 1.0 left to right (np.bincount's order) and
    1.0000000000000002 right to left."""
    w = torch.tensor([1.0, 1e-16, 1e-16], dtype=torch.float64)
    rate, remaining, rounds = waterfill.waterfill_ref(
        torch.tensor([0, 3]), torch.tensor([0, 1, 2]), w, torch.ones(3, dtype=torch.bool),
        torch.tensor([3.0], dtype=torch.float64))
    in_order = np.bincount([0, 0, 0], weights=w.numpy())[0]
    assert in_order == 1.0 != (1e-16 + 1e-16) + 1.0
    assert rate.tolist() == (3.0 / in_order * w).tolist()
    assert remaining.tolist() == [0.0] and rounds.tolist() == [1]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    ptr, flow = torch.tensor([0, 1]), torch.tensor([0])
    w, alive, cap = (torch.ones(1, dtype=torch.float64), torch.ones(1, dtype=torch.bool),
                     torch.ones(1, dtype=torch.float64))
    with pytest.raises(TypeError):
        waterfill.waterfill(ptr, flow, w.float(), alive, cap)
    with pytest.raises(TypeError):
        waterfill.waterfill(ptr, flow, w, alive.to(torch.uint8), cap)
    with pytest.raises(ValueError):
        waterfill.waterfill(ptr, flow, w, alive, torch.ones(2, dtype=torch.float64))


def test_build_flags_hold_waterfill_exact():
    assert "waterfill" in _build.KERNELS and "--fmad=false" in _build.flags("waterfill")
    src = (_build.CSRC / "waterfill.cu").read_text()
    assert f"MAX_BLOCKS = {waterfill.MAX_BLOCKS};" in src


# --- on the card only ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "fig2", "fig2 jitter", "10240"])
def test_kernel_bit_equal_on_card(cuda, case):
    if case == "random":
        cases = [(random_scenario(i), {}) for i in range(N_RANDOM)]
    elif case == "10240":
        cases = [(clos_scenario(1280), {})]
    else:
        cases = [(clos_scenario(128), dict(cnp_jitter=0.05 if "jitter" in case else 0.0,
                                           seed=3))]
    for (topo, flows), kw in cases:
        fs = _port(topo, flows)
        want = RefFlowSet(topo, flows).max_min(**kw)
        before = waterfill.launches
        _assert_equal(fs.max_min(backend="torch", device=cuda, **kw), want)
        assert waterfill.launches == before + 1
        ptr, flow = waterfill.link_csr(fs.pair_flow, fs.pair_link, fs.n_links)
        args = [torch.from_numpy(a).to(cuda) for a in (
            ptr, flow, np.maximum(fs.weights, 1e-9), fs.alive_mask(), fs.base_cap)]
        plain = waterfill.waterfill_ref(*args)
        for grid in (False, True):
            got = waterfill.waterfill(*args, grid=grid)
            for g, p in zip(got, plain):
                assert torch.equal(g.view(torch.int64) if g.is_floating_point() else g,
                                   p.view(torch.int64) if p.is_floating_point() else p)
