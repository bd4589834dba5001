"""TrainerService: the real training stack as just another bus service.

Rides the same kernel as the simulation services: it collects the
``InjectFault`` events delivered on the virtual clock and, at ``on_stop``,
replays them on an actual ``repro_torch.train.trainer.Trainer`` — train
steps, ``CheckpointManager`` restore, elastic restart — with the
control-plane pieces (cluster, steering, telemetry) injected so isolation
decisions land on the same simulated cluster the drill describes.

Copy of ``repro.scenarios.services.trainer_service`` for the port, with a
``device`` for the Trainer and its C4D master (``None``: the card). The
model stack is imported inside the replay, so registering the service
costs nothing until ``on_stop``; ``scenarios.live.drive`` is the standalone
composition (a one-service kernel) behind the CLI's ``--live`` flag.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.cluster import SimCluster, SteeringService
from repro_torch.core.faults import Fault, RingJobTelemetry
from repro_torch.runtime import Service
from repro_torch.scenarios.spec import InjectFault, ScenarioSpec


def fault_schedule(events: List[InjectFault], duration_s: float,
                   n_steps: int) -> Dict[int, Fault]:
    """Map InjectFault events onto trainer step indices, proportionally:
    event time t -> step round(t / duration * n_steps) (clamped to
    [1, n_steps - 1]; step 0 is the baseline checkpoint)."""
    sched: Dict[int, Fault] = {}
    for ev in sorted(events, key=lambda e: e.t):
        step = int(round(ev.t / duration_s * n_steps))
        step = min(max(step, 1), n_steps - 1)
        while step in sched and step < n_steps - 1:
            step += 1                      # keep cascading faults distinct
        kind = ev.kind or "crash"
        rank = ev.rank if ev.rank is not None else 0
        sched[step] = Fault(kind, rank=rank,
                            severity=ev.severity if ev.severity is not None else 8.0)
    return sched


class TrainerService(Service):
    name = "trainer"
    priority = 30                 # after detection/accounting have reacted

    def __init__(self, spec: ScenarioSpec, workdir: str, n_steps: int = 14,
                 config_name: str = "smollm-135m",
                 sim_nodes: Optional[int] = None, device=None):
        self.spec = spec
        self.workdir = workdir
        self.n_steps = n_steps
        self.config_name = config_name
        self.sim_nodes = sim_nodes
        self.device = device
        self.collected: List[InjectFault] = []
        self.report: Optional[dict] = None

    def on_event(self, event) -> None:
        # a fault queued during a restart is re-published when the job
        # resumes — same object, so identity-dedupe keeps the script exact
        if isinstance(event, InjectFault) and \
                not any(c is event for c in self.collected):
            self.collected.append(event)

    def on_stop(self) -> None:
        self.report = self._drive()

    # ------------------------------------------------------------------
    def _drive(self) -> dict:
        """Replay the collected fault script on a real Trainer."""
        from repro_torch.common.config import ShapeSpec
        from repro_torch.configs import get_smoke_config
        from repro_torch.train.trainer import FaultInjector, Trainer

        spec = self.spec
        run = get_smoke_config(self.config_name)
        shape = ShapeSpec("t", run.train.seq_len, run.train.global_batch,
                          "train")
        nodes = self.sim_nodes or max(4, spec.telemetry_ranks
                                      // spec.ranks_per_node)
        cluster = SimCluster(n_active=nodes, n_backup=max(2, nodes // 8))
        steering = SteeringService(cluster)
        telemetry = RingJobTelemetry(n_ranks=nodes * spec.ranks_per_node,
                                     seed=spec.seed + 1)
        trainer = Trainer(run, shape, workdir=self.workdir, device=self.device,
                          checkpoint_async=False, cluster=cluster,
                          steering=steering, telemetry=telemetry)
        sched = fault_schedule(self.collected, spec.duration_s, self.n_steps)
        report = trainer.train(self.n_steps, injector=FaultInjector(dict(sched)))
        return {
            "scenario": spec.name,
            "mode": "live_trainer",
            "n_steps": self.n_steps,
            "scheduled_faults": {str(k): v.kind for k, v in sched.items()},
            "restarts": report.restarts,
            "detections": report.detections,
            "downtime_steps": report.downtime_steps,
            "steps_run": report.steps_run,
            "final_loss": report.losses[-1] if report.losses else None,
            "isolated_nodes": [n.node_id for n in cluster.nodes.values()
                               if n.state == "isolated"],
        }
