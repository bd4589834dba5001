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
10,240-GPU fabric. The kernel's schedule (a round refreshes only the links
of the flows it froze, and re-reduces only their chunks' minimums) is
emulated step by step in NumPy and held bit-equal to the NumPy loop on the
same 43 fabrics, and a planted fault of it (only the first link of each
frozen flow marked) must differ. On the card (``-m gpu``) every variant of
the kernel is held bit-equal to the plain version and to NumPy.
"""
import math
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


CHUNK = 32       # csrc/waterfill.cu: links a chunk


def dirty_link_waterfill(fs, w, alive, cap, fault=False):
    """csrc/waterfill.cu's schedule, step by step in NumPy: round 0 computes
    every link's share and each chunk's least share; then a round takes the
    least of the chunk minimums, freezes the unfrozen flows of every link
    at that share (only chunks whose minimum equals it are looked at), marks
    the links of each newly frozen flow dirty (``fault``: only its first
    link), recomputes dec, remaining, load and share for the dirty links
    alone (each sum serial in pair order) and re-reduces only their chunks.
    Returns (rate, remaining, rounds)."""
    link_ptr, link_flow = (a.tolist() for a in waterfill.link_csr(
        fs.pair_flow, fs.pair_link, fs.n_links))
    flow_ptr, flow_link = (a.tolist() for a in waterfill.flow_csr(
        fs.pair_flow, fs.pair_link, fs.n_flows))
    n_flows, n_links = fs.n_flows, fs.n_links
    w, cap = w.tolist(), cap.tolist()
    stamp = [-1 if a else -2 for a in alive]
    rate, rem, share = [0.0] * n_flows, list(cap), [math.inf] * n_links

    def refresh(link, r, m, first):
        dec = load = 0.0
        for f in link_flow[link_ptr[link]:link_ptr[link + 1]]:
            if stamp[f] == r:
                dec += m * w[f]
            elif stamp[f] == -1:
                load += w[f]
        if not first:
            x = rem[link] - dec
            rem[link] = x if x > 0.0 else 0.0
        share[link] = rem[link] / load if load > 0.0 else math.inf

    def chunk_min(c):
        return min(share[c * CHUNK:(c + 1) * CHUNK])

    for link in range(n_links):
        refresh(link, -3, 0.0, True)
    cmin = [chunk_min(c) for c in range(-(-n_links // CHUNK))]
    r = 0
    while True:
        m = min(cmin, default=math.inf)
        if not math.isfinite(m) or r > n_flows:
            break
        dirty = set()
        for c in (c for c, x in enumerate(cmin) if x == m):
            for link in range(c * CHUNK, min((c + 1) * CHUNK, n_links)):
                if share[link] != m:
                    continue
                for f in link_flow[link_ptr[link]:link_ptr[link + 1]]:
                    if stamp[f] == -1:
                        stamp[f], rate[f] = r, m * w[f]
                        links = flow_link[flow_ptr[f]:flow_ptr[f + 1]]
                        dirty.update(links[:1] if fault else links)
        for link in dirty:
            refresh(link, r, m, False)
        for c in {link // CHUNK for link in dirty}:
            cmin[c] = chunk_min(c)
        r += 1
    return np.array(rate), np.array(rem), r


def _numpy_inputs(fs, jitter=0.0, seed=0):
    """``max_min``'s inputs to the filling loop: floored weights, aliveness,
    capacity after the jitter draw, and the links a live flow touches."""
    cap = fs.base_cap.copy()
    if jitter:
        cap *= 1.0 - jitter * np.random.default_rng(seed).uniform(0.0, 1.0, size=fs.n_links)
    alive = fs.alive_mask()
    touched = np.zeros(fs.n_links, dtype=bool)
    touched[fs.pair_link[alive[fs.pair_flow]]] = True
    return np.maximum(fs.weights, 1e-9), alive, cap, touched


FABRICS = [f"random {i}" for i in range(N_RANDOM)] + ["fig2", "fig2 jitter 0.05", "10240"]


def _fabric(label):
    """(the port's FlowSet, jitter, seed) of one of the 43 fabrics."""
    if label.startswith("random"):
        return _port(*random_scenario(int(label.split()[1]))), 0.0, 0
    if label == "10240":
        return _port(*clos_scenario(1280)), 0.0, 0
    return _port(*clos_scenario(128)), (0.05 if "jitter" in label else 0.0), 3


@pytest.mark.parametrize("label", FABRICS)
def test_dirty_link_schedule_bit_equal_to_numpy_loop(label):
    fs, jitter, seed = _fabric(label)
    w, alive, cap, touched = _numpy_inputs(fs, jitter, seed)
    rate, remaining, rounds = dirty_link_waterfill(fs, w, alive, cap)
    _assert_equal(fs._finish(rate, remaining, cap, touched, alive),
                  fs.max_min(backend="numpy", cnp_jitter=jitter, seed=seed))
    if label == "10240":
        assert rounds == 57


def test_dirty_link_schedule_planted_fault_differs():
    """Only the first link of each frozen flow marked dirty: the links it
    leaves stale must show on at least one of the 43 fabrics."""
    differ = []
    for label in FABRICS:
        fs, jitter, seed = _fabric(label)
        w, alive, cap, _ = _numpy_inputs(fs, jitter, seed)
        sound = dirty_link_waterfill(fs, w, alive, cap)
        wrong = dirty_link_waterfill(fs, w, alive, cap, fault=True)
        if not (np.array_equal(_bits(sound[0]), _bits(wrong[0]))
                and np.array_equal(_bits(sound[1]), _bits(wrong[1]))):
            differ.append(label)
    assert differ, "the planted fault reads equal on every fabric"


def test_flow_csr_lists_each_flows_links():
    fs = _port(*clos_scenario(128))
    ptr, link = waterfill.flow_csr(fs.pair_flow, fs.pair_link, fs.n_flows)
    assert ptr.dtype == link.dtype == np.int64
    assert ptr[0] == 0 and ptr[-1] == fs.pair_flow.size and ptr.size == fs.n_flows + 1
    for f in range(fs.n_flows):
        assert link[ptr[f]:ptr[f + 1]].tolist() == fs.pair_link[fs.pair_flow == f].tolist()
        assert [fs.links[k] for k in link[ptr[f]:ptr[f + 1]]] == list(fs.flow_links[f])


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


@pytest.mark.parametrize("hosts", [16, 128])
def test_c4p_fabrics_give_the_timed_fabrics(hosts):
    """``scenarios/c4p_fabrics.py`` builds the fabrics that chip_smoke.py and
    the ablation time: the reference's Fig. 2 scenario (at 128 hosts the
    Fig. 2 fabric, 2,048 flows on 4,094 links, 17 rounds), and kernel inputs
    whose plain water-fill gives the NumPy loop's bits."""
    from repro_torch.scenarios.c4p_fabrics import FIG2_HOSTS, clos_fabric, waterfill_inputs
    fs = clos_fabric(hosts)
    ref = RefFlowSet(*clos_scenario(hosts))
    assert (fs.n_flows, fs.n_links) == (ref.n_flows, ref.n_links)
    assert np.array_equal(fs.pair_flow, ref.pair_flow)
    assert np.array_equal(fs.pair_link, ref.pair_link)
    if hosts == FIG2_HOSTS:
        assert (fs.n_flows, fs.n_links) == (2048, 4094)
    args, by_flow = waterfill_inputs(fs, "cpu")
    rate, remaining, rounds = waterfill.waterfill_ref(*args)
    want = ref.max_min()
    ptr, flow = waterfill.flow_csr(fs.pair_flow, fs.pair_link, fs.n_flows)
    assert torch.equal(by_flow[0], torch.from_numpy(ptr))
    assert torch.equal(by_flow[1], torch.from_numpy(flow))
    assert np.array_equal(_bits(rate.numpy()), _bits(want.flow_rate))
    if hosts == FIG2_HOSTS:
        assert int(rounds[0]) == 17


def test_build_flags_hold_waterfill_exact():
    assert "waterfill" in _build.KERNELS and "--fmad=false" in _build.flags("waterfill")
    src = (_build.CSRC / "waterfill.cu").read_text()
    assert f"MAX_BLOCKS = {waterfill.MAX_BLOCKS};" in src
    assert f"CHUNK = {CHUNK};" in src
    assert "enum Variant { " + ", ".join(f"{k.upper()} = {v}" for k, v in sorted(
        waterfill.VARIANTS.items(), key=lambda kv: kv[1])) + " };" in src


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
        by_flow = [torch.from_numpy(a).to(cuda) for a in waterfill.flow_csr(
            fs.pair_flow, fs.pair_link, fs.n_flows)]
        plain = waterfill.waterfill_ref(*args)
        for variant in waterfill.VARIANTS:
            if variant == "smem" and not waterfill._kernel("waterfill_smem_bytes")(
                    fs.n_flows, fs.n_links, fs.pair_flow.size):
                continue        # the 10,240-GPU fabric's state does not fit
            got = waterfill.waterfill(*args, flow_csr=by_flow, variant=variant)
            for g, p in zip(got, plain):
                assert torch.equal(g.view(torch.int64) if g.is_floating_point() else g,
                                   p.view(torch.int64) if p.is_floating_point() else p)
