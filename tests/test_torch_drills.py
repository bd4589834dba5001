"""The 11 shipped fault drills through the port's scenario engine.

``repro_torch.scenarios.engine.run_scenario`` runs each drill of
``scenarios/library.py`` at ``backend="numpy"`` (no torch, no device) and at
``backend="torch", device="cpu"`` (the detection kernels' plain versions,
reached through the same wrappers that launch the CUDA kernels on the card).
Each report must be dict-equal to the JAX package's ``run_scenario`` report
and hash to ``tests/test_fleet.py``'s ``DRILL_GOLDENS``. The torch runs must
go through ``window_score``, ``row_select`` and ``slow_fold``, and every
water-filling of C4P and ECMP through ``waterfill``; the NumPy runs through
none of them. On the card (``-m gpu``) the torch runs launch the CUDA kernels
and give the same hashes.
"""
import dataclasses
import importlib.util
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.scenarios import library as ref_library
from repro.scenarios import run as ref_run
from repro.core.flowset import FlowSet as RefFlowSet
from repro.scenarios.engine import run_scenario as ref_run_scenario
from repro_torch.core.torchsim import BACKEND_ENV
from repro_torch.core.torchsim import detectors
from repro_torch.kernels import slow_fold, waterfill, window_score
from repro_torch.scenarios import library, run
from repro_torch.scenarios.engine import run_scenario


def _test_fleet():
    """tests/test_fleet.py, loaded by its path: where an installed package
    named ``tests`` comes first on ``sys.path``, ``tests.test_fleet`` does
    not resolve to this directory."""
    path = Path(__file__).with_name("test_fleet.py")
    spec = importlib.util.spec_from_file_location("_drills_test_fleet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_fleet = _test_fleet()
DRILL_GOLDENS, _hash = _fleet.DRILL_GOLDENS, _fleet._hash
DRILLS = sorted(DRILL_GOLDENS)
KERNELS = ("window_score", "row_select", "slow_fold")
#: every drill's torch run on the CPU: the detection wrappers and water-filling's
TORCH_CPU = {(k, "cpu") for k in KERNELS + ("waterfill",)}
#: the C4P drills, whose water-fills are the dynamic load balancer's rounds
C4P_DRILLS = ["cascading_spine_flaps", "ecmp_vs_c4p_ab", "multijob_contention"]
_reference = {}


def _reference_report(name: str) -> dict:
    if name not in _reference:
        _reference[name] = ref_run_scenario(ref_library.get(name))
    return _reference[name]


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Calls of each detection kernel's wrapper, by the device of its input."""
    calls = Counter()

    def counted(mod, entry, name, arg):
        real = getattr(mod, entry)

        def wrapper(*args, **kw):
            calls[(name, args[arg].device.type)] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, entry, wrapper)

    counted(window_score, "window_score", "window_score", 0)
    counted(window_score, "row_select", "row_select", 0)
    counted(slow_fold, "slow_fold", "slow_fold", 0)
    counted(waterfill, "waterfill", "waterfill", 2)
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    return calls


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("name", DRILLS)
def test_drill_equals_reference_and_golden(name, backend, wrapper_calls):
    spec = dataclasses.replace(library.get(name), backend=backend)
    rep = run_scenario(spec, device="cpu" if backend == "torch" else None)
    want = _reference_report(name)
    assert rep == want
    assert _hash(rep) == DRILL_GOLDENS[name]
    assert rep["passed"]
    assert run._summary_lines(rep) == ref_run._summary_lines(want)
    if backend == "numpy":
        assert not wrapper_calls
    else:
        assert set(wrapper_calls) == TORCH_CPU, wrapper_calls


@pytest.mark.parametrize("name", C4P_DRILLS)
def test_c4p_drill_water_fills_through_the_kernel_path(name, wrapper_calls, monkeypatch):
    """At torch on the CPU, each of the drill's water-fills goes through the
    kernel's wrapper: as many as the reference's ``FlowSet.max_min`` calls
    in its NumPy run, and the report still hashes to the golden."""
    ref_calls = []
    real = RefFlowSet.max_min
    monkeypatch.setattr(RefFlowSet, "max_min",
                        lambda self, *a, **kw: ref_calls.append(1) or real(self, *a, **kw))
    ref_run_scenario(ref_library.get(name))
    rep = run_scenario(dataclasses.replace(library.get(name), backend="torch"), device="cpu")
    assert _hash(rep) == DRILL_GOLDENS[name]
    assert wrapper_calls[("waterfill", "cpu")] == len(ref_calls) > 2, wrapper_calls


def test_default_backend_is_torch_and_reaches_every_per_fault_master(wrapper_calls):
    """``backend=None`` takes the port's default (torch). With the streaming
    path off, only the per-fault harness runs: each of its fresh masters
    must take the torch backend on the run's device."""
    spec = library.get("straggler_gpu")
    assert spec.backend is None
    assert _hash(run_scenario(spec, device="cpu")) == DRILL_GOLDENS["straggler_gpu"]
    assert set(wrapper_calls) == TORCH_CPU
    wrapper_calls.clear()
    quiet = dataclasses.replace(spec, streaming_tick_s=0.0)
    rep = run_scenario(quiet, device="cpu")
    assert rep == ref_run_scenario(dataclasses.replace(ref_library.get("straggler_gpu"),
                                                       streaming_tick_s=0.0))
    assert rep["detection"]["n_faults"] > 0
    assert set(wrapper_calls) == TORCH_CPU


def test_run_scenario_on_the_card_raises_without_one(monkeypatch, wrapper_calls):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario(library.get("straggler_gpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario(dataclasses.replace(library.get("straggler_gpu"), backend="torch"))
    assert not wrapper_calls


@pytest.mark.gpu
def test_drills_on_the_card_equal_golden():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    for name in DRILLS:
        detectors.reset_launch_counts()
        before = waterfill.launches
        rep = run_scenario(dataclasses.replace(library.get(name), backend="torch"))
        counts = detectors.launch_counts()
        assert _hash(rep) == DRILL_GOLDENS[name], name
        assert all(counts[k] > 0 for k in KERNELS), (name, counts)
        assert waterfill.launches > before, name
