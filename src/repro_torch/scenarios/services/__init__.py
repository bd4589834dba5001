"""Scenario services on the runtime kernel (docs/runtime.md).

The campaign engine's layers, re-homed as independent services sharing a
``RunContext`` and a deterministic ``repro_torch.runtime.EventBus``:

  * ``DowntimeService`` (priority 0) — goodput integral + Table-3 phase
    accounting + restart scheduling;
  * ``FabricService`` (priority 10) — live fabric, probe-driven
    re-planning, busbw-changed events;
  * ``C4DService`` (priority 20) — per-fault reference detection and the
    always-on streaming detector;
  * ``TrainerService`` (priority 30) — the real-Trainer replay wiring;
  * ``FleetService`` (priority 5) — the continuous multi-tenant control
    plane: live tenant/fault/flap processes, per-tenant SLO accounting,
    rolling reports (docs/fleet.md).

Copy of ``repro.scenarios.services`` for the port.
"""
from repro_torch.scenarios.services.c4d_service import C4DService
from repro_torch.scenarios.services.context import JobRun, RunContext
from repro_torch.scenarios.services.downtime_service import DowntimeService
from repro_torch.scenarios.services.fleet_service import FleetService, ProcessDue
from repro_torch.scenarios.services.events import (BusbwChanged, FabricTransient,
                                                   FaultDetected, JobAdmitted,
                                                   JobResumed, LinkObserved,
                                                   RestartComplete, admitted_spec)
from repro_torch.scenarios.services.fabric_service import FabricService
from repro_torch.scenarios.services.trainer_service import TrainerService

__all__ = [
    "RunContext", "JobRun",
    "DowntimeService", "FabricService", "C4DService", "TrainerService",
    "FleetService", "ProcessDue",
    "JobAdmitted", "RestartComplete", "JobResumed", "FaultDetected",
    "FabricTransient", "LinkObserved", "BusbwChanged", "admitted_spec",
]
