"""Live-trainer scenario driver: replay a spec's fault script on the REAL
training stack (train steps, CheckpointManager, elastic restart).

Copy of ``repro.scenarios.live`` for the port, with a ``device`` for the
Trainer and its C4D master (``None``: the card; ``"cpu"`` when asked).

The virtual-clock engine models restart cost in seconds; this driver
cross-checks the same drill on the actual ``repro_torch.train.trainer.Trainer``.  The
wiring lives in ``scenarios.services.trainer_service.TrainerService`` —
just another service on the runtime kernel: it collects the spec's
``InjectFault`` events as they are delivered on the virtual clock and
replays them as ``FaultInjector`` entries at steps derived from the event
times.  ``drive`` composes a one-service kernel around it (the CLI's
``--live`` path); registering the same service next to the simulation
services on a shared kernel gives a combined run.

The model stack is imported inside the replay; ``--live`` is the opt-in.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.faults import Fault
from repro_torch.runtime import EventBus
from repro_torch.scenarios.services.trainer_service import TrainerService
from repro_torch.scenarios.services.trainer_service import \
    fault_schedule as _service_schedule
from repro_torch.scenarios.spec import InjectFault, ScenarioSpec


def fault_schedule(spec: ScenarioSpec, n_steps: int) -> Dict[int, Fault]:
    """Map the spec's InjectFault events onto trainer step indices,
    proportionally: event time t -> step round(t / duration * n_steps)
    (clamped to [1, n_steps - 1]; step 0 is the baseline checkpoint)."""
    events = [ev for ev in spec.sorted_events() if isinstance(ev, InjectFault)]
    return _service_schedule(events, spec.duration_s, n_steps)


def drive(spec: ScenarioSpec, workdir: str, n_steps: int = 14,
          config_name: str = "smollm-135m",
          sim_nodes: Optional[int] = None, device=None) -> dict:
    """Run the drill on a real Trainer; returns the cross-check report.

    The returned dict mirrors the engine report's shape where the concepts
    overlap (restarts, detections, downtime in *steps* instead of seconds).
    """
    kernel = EventBus(seed=spec.seed)
    svc = TrainerService(spec, workdir=workdir, n_steps=n_steps,
                         config_name=config_name, sim_nodes=sim_nodes,
                         device=device)
    kernel.register(svc)
    kernel.start(spec.duration_s)
    for ev in spec.sorted_events():
        kernel.schedule(ev.t, ev)
    kernel.drain()
    kernel.stop()                 # on_stop performs the real-Trainer replay
    assert svc.report is not None
    return svc.report
