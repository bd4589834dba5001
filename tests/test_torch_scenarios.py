"""The port's copies of the scenario substrate vs the JAX package's originals.

``repro_torch.runtime``, ``core.topology``/``flowset``/``netsim``,
``core.c4p``, ``core.cluster``/``phases``/``downtime`` and ``scenarios`` (spec,
library, detection, fabric, services, engine, stats, report, montecarlo,
precision, fleet, the CLI) are copies of
``repro``'s NumPy modules. Held here on the CPU: the event bus's trace of a
scripted run and of whole engine runs, water-filling rates and C4P
allocations bit-equal, and every shipped spec and copied dataclass
field-equal. The drills themselves are held to the reference report by
``tests/test_torch_drills.py``.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.c4p.master import C4PMaster as RefC4PMaster
from repro.core.flowset import FlowSet as RefFlowSet
from repro.runtime import EventBus as RefEventBus
from repro.runtime import Service as RefService
from repro.scenarios import library as ref_library
from repro.scenarios import run as ref_run
from repro.scenarios.engine import CampaignEngine as RefCampaignEngine
from repro_torch.core import netsim, topology
from repro_torch.core.c4p.master import C4PMaster
from repro_torch.core.flowset import FlowSet
from repro_torch.runtime import EventBus, Service
from repro_torch.scenarios import library, run
from repro_torch.scenarios.engine import CampaignEngine, run_scenario
from repro_torch.scenarios.spec import Assertions

from tests.test_netsim_perf import FABRIC_1024GPU, _fig2_scenario, _random_scenario

# every copied module holding dataclasses, by its path under either package
COPIED = ["runtime.clock", "core.topology", "core.flowset", "core.netsim",
          "core.c4p.probing", "core.c4p.pathalloc", "core.c4p.loadbalance",
          "core.c4p.master", "core.cluster", "scenarios.spec", "scenarios.detection",
          "scenarios.services.events", "scenarios.services.context",
          "scenarios.services.c4d_service", "scenarios.services.fleet_service",
          "scenarios.stats", "scenarios.report", "scenarios.montecarlo",
          "scenarios.precision", "scenarios.fleet", "core.downtime"]
# the fields a copy adds: the harness carries the torch backend's device
ADDED_FIELDS = {("scenarios.detection", "DetectionHarness"): ["device"]}


# --- the runtime kernel ----------------------------------------------------------

def _scripted_trace(bus_cls, service_cls):
    """A scripted run: timed events, a ticking service that publishes a
    cascade and schedules follow-ups from the bus's seeded RNG."""

    class Echo(service_cls):
        name, priority, tick_period_s = "echo", 5, 7.0

        def on_event(self, event):
            if isinstance(event, tuple) and event[0] == "ping":
                self.kernel.publish(("pong", event[1]))

        def on_tick(self, t):
            draw = int(self.kernel.rng.integers(0, 1000))
            self.kernel.schedule(t + 3.5, ("late", draw))

    class Watch(service_cls):
        name, priority = "watch", 0

    bus = bus_cls(seed=11)
    bus.register(Watch())
    bus.register(Echo())
    bus.start(60.0)
    for i, t in enumerate((0.0, 5.0, 5.0, 21.0, 42.5)):
        bus.schedule(t, ("ping", i))
    bus.drain()
    bus.stop()
    return bus.trace_lines()


def test_event_bus_trace_equal_on_a_scripted_run():
    want = _scripted_trace(RefEventBus, RefService)
    got = _scripted_trace(EventBus, Service)
    assert len(want) > 20
    assert got == want


@pytest.mark.parametrize("name", ["cascading_spine_flaps", "fault_during_restart",
                                  "multijob_contention"])
def test_engine_trace_and_report_equal(name):
    spec = dataclasses.replace(library.get(name), backend="numpy")
    ref = RefCampaignEngine(ref_library.get(name))
    port = CampaignEngine(spec)
    want, got = ref.run(), port.run()
    assert got == want
    assert port.kernel.trace_lines() == ref.kernel.trace_lines()


# --- water-filling and C4P -------------------------------------------------------

def _port_topology(ref_topo):
    init = {f.name: getattr(ref_topo, f.name)
            for f in dataclasses.fields(ref_topo) if f.init and not f.name.startswith("_")}
    init["down_links"] = set(ref_topo.down_links)
    return topology.ClosTopology(**init)


def _port_flows(ref_flows):
    return [netsim.Flow(**dataclasses.asdict(f)) for f in ref_flows]


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype == np.float64:
        a, b = a.view(np.int64), b.view(np.int64)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _assert_rates_bit_equal(ref_fs, fs, **kw):
    want, got = ref_fs.max_min(**kw), fs.max_min(**kw)
    for field in ("flow_rate", "conn_rate", "link_util", "link_touched", "flow_alive"):
        assert _same_bits(getattr(got, field), getattr(want, field)), field


def _scenarios():
    rng = np.random.default_rng(5)
    out = [_random_scenario(rng, fail_links=bool(i % 2)) for i in range(8)]
    return out + [_fig2_scenario()]


@pytest.mark.parametrize("jitter", [0.0, 0.05])
def test_flowset_max_min_bit_equal(jitter):
    for i, (ref_topo, ref_flows) in enumerate(_scenarios()):
        fs = FlowSet(_port_topology(ref_topo), _port_flows(ref_flows))
        _assert_rates_bit_equal(RefFlowSet(ref_topo, ref_flows), fs,
                                cnp_jitter=jitter, seed=i)
    assert "backend" not in FlowSet.max_min.__code__.co_varnames


def _flow_rows(flows):
    return [(f.flow_id, f.job_id, f.conn_id, tuple(f.links), f.weight.hex(),
             f.demand_gbps.hex()) for f in flows]


def _drive_c4p(master_cls, topo, host_sets, fail):
    """Allocate ring jobs, evaluate with and without dynamic LB, fail a link,
    re-probe, allocate one more job and evaluate again."""
    m = master_cls(topo, qps_per_port=2)
    m.startup_probe()
    for j, hosts in enumerate(host_sets[:-1]):
        m.register_job(j, hosts)
    out = [_flow_rows(m.all_flows()),
           m.evaluate(dynamic_lb=True, cnp_jitter=0.05, seed=3),
           m.evaluate(dynamic_lb=False, seed=4)]
    topo.fail_link(fail)
    m.health.update_from_probe(m.prober.probe())
    m.register_job(len(host_sets) - 1, host_sets[-1])
    out += [_flow_rows(m.all_flows()), m.evaluate(dynamic_lb=True, seed=5),
            m.evaluate(dynamic_lb=False, seed=6), m.job_busbw(out[1], 0)]
    return out


def _c4p_cases():
    rng = np.random.default_rng(9)
    cases = []
    for _ in range(4):
        topo, _ = _random_scenario(rng)
        hosts = list(range(topo.n_hosts))
        cases.append((topo, [hosts[: max(2, len(hosts) // 2)], hosts[len(hosts) // 2:][:2]]))
    from repro.core.topology import ClosTopology as RefClos
    big = RefClos(**FABRIC_1024GPU)
    cases.append((big, [[(i * 2) % big.n_hosts for i in range(64)]]
                  + [[b, b + 32] for b in range(1, 17, 2)]))
    return cases


@pytest.mark.parametrize("case", range(5), ids=lambda i: "1024gpu" if i == 4 else f"random{i}")
def test_c4p_master_allocations_and_rates_bit_equal(case):
    ref_topo, host_sets = _c4p_cases()[case]
    port_topo = _port_topology(ref_topo)
    used = sorted({l for hs in host_sets[:1] for l in
                   ref_topo.path_links(hs[0], hs[1], 0, 0, 0, 0) if l[0] == "ls"})
    fail = used[0] if used else ("ls", 0, 0)
    want = _drive_c4p(RefC4PMaster, ref_topo, host_sets, fail)
    got = _drive_c4p(C4PMaster, port_topo, host_sets, fail)
    for w, g in zip(want, got):
        if hasattr(w, "flow_rate"):
            for field in ("flow_rate", "conn_rate", "link_util"):
                wd, gd = getattr(w, field), getattr(g, field)
                assert list(gd) == list(wd), field
                assert [v.hex() for v in gd.values()] == [v.hex() for v in wd.values()]
        else:
            assert g == w
    assert len(want[0]) > 0


# --- specs and dataclasses -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5])
def test_library_specs_field_equal(seed):
    assert library.names() == ref_library.names()
    assert len(library.names()) == 11
    for name in library.names():
        spec, ref = library.get(name, seed=seed), ref_library.get(name, seed=seed)
        assert dataclasses.asdict(spec) == dataclasses.asdict(ref), name
        assert spec.to_dict() == ref.to_dict(), name
        assert [type(e).__name__ for e in spec.events] == \
            [type(e).__name__ for e in ref.events]


def _field_sig(f):
    if f.default is not dataclasses.MISSING:
        default = f.default
    elif f.default_factory is not dataclasses.MISSING:
        default = f.default_factory()
    else:
        default = dataclasses.MISSING
    if dataclasses.is_dataclass(default):
        default = (type(default).__name__, dataclasses.asdict(default))
    return (f.name, str(f.type), repr(default), f.init, f.compare)


@pytest.mark.parametrize("mod", COPIED)
def test_copied_dataclasses_have_the_reference_fields(mod):
    ref = importlib.import_module(f"repro.{mod}")
    port = importlib.import_module(f"repro_torch.{mod}")
    classes = [n for n, c in vars(ref).items() if isinstance(c, type)
               and dataclasses.is_dataclass(c) and c.__module__ == ref.__name__]
    for name in classes:
        want = [_field_sig(f) for f in dataclasses.fields(getattr(ref, name))]
        got = [_field_sig(f) for f in dataclasses.fields(getattr(port, name))]
        added = ADDED_FIELDS.get((mod, name), [])
        assert [g for g in got if g[0] not in added] == want, name
        assert [g[0] for g in got if g[0] in added] == added, name


# --- the CLI ---------------------------------------------------------------------

def test_cli_prints_the_reference_summary_and_fails_on_assertions(capsys, monkeypatch):
    argv = ["--scenario", "straggler_gpu", "--scenario", "single_nic_down"]
    assert ref_run.main(argv) == 0
    want = capsys.readouterr().out
    assert run.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert ref_run.main(["--list"]) == 0
    want = capsys.readouterr().out.splitlines()
    assert run.main(["--list"]) == 0
    assert capsys.readouterr().out.splitlines() == want
    assert [line.split()[0] for line in want[:11]] == library.names()

    real_get = library.get
    monkeypatch.setattr(library, "get", lambda name, seed=0: dataclasses.replace(
        real_get(name, seed), assertions=Assertions(max_detection_s=0.0)))
    assert run.main(["--scenario", "straggler_gpu", "--backend", "numpy"]) == 1
    assert "assertions failed: ['straggler_gpu']" in capsys.readouterr().err
    assert run.main(["--scenario", "straggler_gpu", "--backend", "numpy",
                     "--no-assert"]) == 0


def test_run_scenario_numpy_needs_no_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rep = run_scenario(dataclasses.replace(library.get("single_nic_down"), backend="numpy"))
    assert rep["passed"]
