"""Scenario drills of the port — end-to-end C4 fault drills (docs/scenarios.md).

Copy of the drill half of ``repro.scenarios``.  It composes the full paper
loop on one shared virtual clock:

    telemetry synthesis (core/faults)  ->  C4D detection (core/c4d)
      ->  isolation (core/cluster)     ->  C4P re-planning (core/c4p, netsim)
      ->  checkpoint-restart accounting (Table 3 phases)

with the detection windows on the torch backend (``core/torchsim``: the
``window_score`` and ``slow_fold`` kernels on the card) unless a spec asks
for ``backend="numpy"``.

Entry points:

  * ``repro_torch.scenarios.library.get(name)``  — a shipped ``ScenarioSpec``
  * ``repro_torch.scenarios.engine.run_scenario(spec, device=None)`` — one drill
  * ``repro_torch.scenarios.montecarlo.run_campaign(spec, device=None)`` — a
    Monte Carlo fleet campaign (docs/campaigns.md); ``precision.run_sweep``
    an ROC sweep; ``fleet.run_fleet`` a continuous fleet (docs/fleet.md)
  * ``repro_torch.scenarios.live.drive(spec, workdir, device=None)`` — the
    drill's fault script replayed on the real Trainer
  * ``python -m repro_torch.scenarios.run --list``  — the CLI

(``montecarlo`` / ``stats`` / ``report`` are imported as modules, not
re-exported here: ``core/downtime.py`` sits both upstream of the campaign
statistics and downstream of ``scenarios.detection``, so the package
``__init__`` stays light to keep that import graph acyclic.)
"""
from repro_torch.scenarios.engine import CampaignEngine, run_scenario
from repro_torch.scenarios.spec import (Assertions, FailLink, InjectFault, JobSpec,
                                        RestoreLink, ScenarioSpec, StartJob, StopJob)

__all__ = [
    "Assertions", "CampaignEngine", "FailLink", "InjectFault", "JobSpec",
    "RestoreLink", "ScenarioSpec", "StartJob", "StopJob", "run_scenario",
]
