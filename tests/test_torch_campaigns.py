"""Monte Carlo campaigns, ROC sweeps and continuous fleets on the port.

``repro_torch.scenarios.montecarlo``, ``precision``, ``fleet`` (with
``stats``, ``report``, ``services/fleet_service`` and ``core/downtime``) are
copies of the JAX package's NumPy modules; every detection window of a
trial, a sweep point or a fleet tick goes through the port's C4D master at
its default backend (``torch``: on the CPU the detection kernels' plain
versions, reached through the wrappers that launch the CUDA kernels on the
card). Held here on the CPU:

  * the 2-trial ``fleet_smoke`` and ``fleet_mixed`` reports hash to
    ``tests/test_fleet.py``'s ``CAMPAIGN_GOLDENS`` at ``numpy`` and at
    ``torch``, with 1 and 2 workers (the pool spawns its workers);
  * ``fleet_hour``'s report equals the JAX package's ``run_fleet``'s, and
    Table 3's downtime reports ``table3``'s (the whole ``roc_smoke`` sweep
    is held to ``run_sweep`` in ``tests/test_torch_sweeps.py``);
  * the shipped registries equal the reference's, and the CLI's
    ``--campaign``/``--sweep``/``--fleet`` JSON and markdown equal the
    reference CLI's;
  * a CPU run needs no card (``torch.cuda.is_available`` patched to False).

On the card (``-m gpu``) the campaigns launch the CUDA kernels and give the
same hashes.
"""
import dataclasses
import importlib.util
import json
from collections import Counter
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.scenarios import fleet as ref_fleet
from repro.scenarios import montecarlo as ref_montecarlo
from repro.scenarios import precision as ref_precision
from repro.scenarios import run as ref_run
from repro_torch.core import downtime
from repro_torch.core.torchsim import BACKEND_ENV, detectors, use_backend
from repro_torch.kernels import slow_fold, window_score
from repro_torch.scenarios import fleet, montecarlo, precision, run


def _test_fleet():
    """tests/test_fleet.py, loaded by its path: where an installed package
    named ``tests`` comes first on ``sys.path``, ``tests.test_fleet`` does
    not resolve to this directory."""
    path = Path(__file__).with_name("test_fleet.py")
    spec = importlib.util.spec_from_file_location("_campaigns_test_fleet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_fleet = _test_fleet()
CAMPAIGN_GOLDENS, _hash = _fleet.CAMPAIGN_GOLDENS, _fleet._hash
KERNELS = ("window_score", "row_select", "slow_fold")


@pytest.fixture
def wrapper_calls(monkeypatch):
    """Calls of each detection kernel's wrapper in this process, by the
    device of its input."""
    calls = Counter()

    def counted(mod, entry, name):
        real = getattr(mod, entry)

        def wrapper(*args, **kw):
            calls[(name, args[0].device.type)] += 1
            return real(*args, **kw)
        monkeypatch.setattr(mod, entry, wrapper)

    counted(window_score, "window_score", "window_score")
    counted(window_score, "row_select", "row_select")
    counted(slow_fold, "slow_fold", "slow_fold")
    monkeypatch.delenv(BACKEND_ENV, raising=False)
    return calls


# --- campaigns ----------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("name", sorted(CAMPAIGN_GOLDENS))
def test_campaign_hashes_to_the_golden(name, backend, workers, wrapper_calls):
    """``backend`` is the default the trials inherit (``CampaignSpec.backend``
    stays None, as in the goldens); with 2 workers it reaches the spawned
    workers as a plain value."""
    with use_backend(backend):
        rep = montecarlo.run_campaign(montecarlo.get(name, n_trials=2), workers=workers,
                                      device="cpu")
    assert rep.campaign["backend"] is None
    assert _hash(rep.to_json()) == CAMPAIGN_GOLDENS[name]
    if backend == "numpy" or workers > 1:      # the workers' calls are not seen here
        assert not wrapper_calls
    else:
        assert set(wrapper_calls) == {(k, "cpu") for k in KERNELS}, wrapper_calls


def test_campaign_markdown_and_summary_equal_the_reference():
    cam = montecarlo.get("fleet_mixed", n_trials=1)
    want = ref_montecarlo.run_campaign(ref_montecarlo.get("fleet_mixed", n_trials=1))
    got = montecarlo.run_campaign(cam, device="cpu")
    assert got.to_json() == want.to_json()
    assert got.to_markdown() == want.to_markdown()
    assert got.summary_lines() == want.summary_lines()


# --- fleets and sweeps ---------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_hour():
    return ref_fleet.run_fleet(ref_fleet.get("fleet_hour")).to_json()


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_fleet_hour_equals_the_reference(backend, reference_hour, wrapper_calls):
    with use_backend(backend):
        rep = fleet.run_fleet(fleet.get("fleet_hour"), workers=2, device="cpu")
    assert rep.to_json() == reference_hour
    assert _hash(rep.to_json()) == _hash(reference_hour)
    if backend == "numpy":
        assert not wrapper_calls
    else:
        assert {dev for _, dev in wrapper_calls} == {"cpu"}
        assert wrapper_calls[("window_score", "cpu")] > 0


def test_table3_downtime_equals_the_reference():
    from repro.core import downtime as ref_downtime
    want = ref_downtime.table3(seed=3, n_nodes=64)
    with use_backend("numpy"):
        got_np = downtime.table3(seed=3, n_nodes=64)
    got = downtime.table3(seed=3, n_nodes=64, device="cpu")
    for key, rep in want.items():
        assert dataclasses.asdict(got_np[key]) == dataclasses.asdict(rep), key
        assert dataclasses.asdict(got[key]) == dataclasses.asdict(rep), key


# --- registries and the CLI -----------------------------------------------------------

@pytest.mark.parametrize("kind,name", [
    *(("campaign", n) for n in ref_montecarlo.names()),
    *(("sweep", n) for n in ref_precision.names()),
    *(("fleet", n) for n in ref_fleet.names())])
def test_shipped_registries_equal_the_reference(kind, name):
    port, ref = {"campaign": (montecarlo, ref_montecarlo), "sweep": (precision, ref_precision),
                 "fleet": (fleet, ref_fleet)}[kind]
    assert port.names() == ref.names()
    assert json.dumps(port.get(name).to_dict(), sort_keys=True, default=str) == \
        json.dumps(ref.get(name).to_dict(), sort_keys=True, default=str)


@pytest.mark.parametrize("argv", [
    ["--campaign", "fleet_smoke", "--trials", "2"],
    ["--campaign", "fleet_smoke", "--trials", "1", "--operating-point", "mad=6,streak=3,hl=16"],
    ["--fleet", "fleet_hour"],
    ["--sweep", "roc_smoke", "--trials", "1"]], ids=["campaign", "operating-point", "fleet",
                                                     "sweep"])
def test_cli_writes_the_reference_json_and_markdown(argv, tmp_path, capsys):
    assert ref_run.main(argv + ["--json", str(tmp_path / "ref"), "--md",
                                str(tmp_path / "ref")]) == 0
    ref_lines = capsys.readouterr().out.splitlines()
    assert run.main(argv + ["--json", str(tmp_path / "port"), "--md", str(tmp_path / "port"),
                            "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    ref_files = sorted(p.name for p in (tmp_path / "ref").iterdir())
    assert ref_files and sorted(p.name for p in (tmp_path / "port").iterdir()) == ref_files
    for f in ref_files:
        assert (tmp_path / "port" / f).read_text() == (tmp_path / "ref" / f).read_text(), f
    # the console summary equals the reference's but for the wall seconds
    strip = [line for line in ref_lines if not line.startswith("wall")]
    assert [line for line in lines if not line.startswith("wall")] == strip


def test_cli_json_to_stdout_equals_the_reference(capsys):
    argv = ["--campaign", "fleet_mixed", "--trials", "1", "--backend", "numpy", "--json", "-"]
    assert ref_run.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert run.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert got == want and got["campaign"]["backend"] == "numpy"


# --- the device of every master --------------------------------------------------------

def _tiny_sweep():
    return dataclasses.replace(precision.get("roc_smoke"), n_trials=1, windows=24,
                               mad_thresholds=(6.0,), confirm_streaks=(2,), half_lives=(0.0,))


@pytest.mark.parametrize("entry", ["campaign", "sweep", "fleet", "table3"])
def test_cpu_runs_need_no_card(entry, monkeypatch, wrapper_calls):
    """Each entry point's masters take the caller's device: with no card
    they run at ``device="cpu"`` and raise at the default (the card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"campaign": lambda **kw: montecarlo.run_campaign(
                montecarlo.get("fleet_smoke", n_trials=1), **kw),
            "sweep": lambda **kw: precision.run_sweep(_tiny_sweep(), **kw),
            "fleet": lambda **kw: fleet.run_fleet(
                dataclasses.replace(fleet.get("fleet_hour"), duration_s=1800.0), **kw),
            "table3": lambda **kw: downtime.table3(n_nodes=16, **kw)}[entry]
    call(device="cpu")
    assert {dev for _, dev in wrapper_calls} == {"cpu"}
    assert wrapper_calls[("window_score", "cpu")] > 0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


# --- on the card ----------------------------------------------------------------------

@pytest.mark.gpu
def test_campaigns_on_the_card_equal_golden():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    for name in sorted(CAMPAIGN_GOLDENS):
        detectors.reset_launch_counts()
        rep = montecarlo.run_campaign(montecarlo.get(name, n_trials=2))
        counts = detectors.launch_counts()
        assert _hash(rep.to_json()) == CAMPAIGN_GOLDENS[name], name
        assert counts["window_score"] > 0 and counts["slow_fold"] > 0, (name, counts)
