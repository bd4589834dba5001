"""Scenario services on the runtime kernel (docs/runtime.md).

The campaign engine's layers, re-homed as independent services sharing a
``RunContext`` and a deterministic ``repro_torch.runtime.EventBus``:

  * ``DowntimeService`` (priority 0) — goodput integral + Table-3 phase
    accounting + restart scheduling;
  * ``FabricService`` (priority 10) — live fabric, probe-driven
    re-planning, busbw-changed events;
  * ``C4DService`` (priority 20) — per-fault reference detection and the
    always-on streaming detector.

Copy of ``repro.scenarios.services`` for the port, without the trainer and
fleet services, which are not ported yet.
"""
from repro_torch.scenarios.services.c4d_service import C4DService
from repro_torch.scenarios.services.context import JobRun, RunContext
from repro_torch.scenarios.services.downtime_service import DowntimeService
from repro_torch.scenarios.services.events import (BusbwChanged, FabricTransient,
                                                   FaultDetected, JobAdmitted,
                                                   JobResumed, LinkObserved,
                                                   RestartComplete, admitted_spec)
from repro_torch.scenarios.services.fabric_service import FabricService

__all__ = [
    "RunContext", "JobRun",
    "DowntimeService", "FabricService", "C4DService",
    "JobAdmitted", "RestartComplete", "JobResumed", "FaultDetected",
    "FabricTransient", "LinkObserved", "BusbwChanged", "admitted_spec",
]
