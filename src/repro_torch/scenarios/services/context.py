"""Shared run state for the scenario services.

Services communicate *triggers* over the kernel's event bus and share
*state* through one ``RunContext``: the live fabric, the simulated cluster,
the telemetry/harness pair, and the per-job runs.  Each field has a single
writing service (noted below); everyone else reads.

The construction order is part of the determinism contract — seeded
components are built in the exact sequence the monolithic engine used, so
every historical report stays bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.c4d.attribution import AttributionConfig
from repro_torch.core.cluster import SimCluster, SteeringService
from repro_torch.core.faults import Fault, RingJobTelemetry
from repro_torch.core.topology import ClosTopology
from repro_torch.scenarios.detection import DetectionHarness, bridge_faults
from repro_torch.scenarios.fabric import FabricState
from repro_torch.scenarios.spec import JobSpec, ScenarioSpec


@dataclass
class JobRun:
    """Mutable per-job campaign state.

    Lifecycle/progress fields (``up``, ``progress_gb``, checkpoints,
    ``pending``) are written by ``DowntimeService``; fabric-derived fields
    (``busbw``, baselines, ``host_to_rank``) by ``FabricService``."""
    spec: JobSpec
    start_t: float
    up: bool = True
    busbw: float = 0.0
    healthy_busbw: float = 0.0
    baseline_conn: Dict[Tuple, float] = field(default_factory=dict)
    host_to_rank: Dict[int, int] = field(default_factory=dict)
    progress_gb: float = 0.0
    ckpt_progress_gb: float = 0.0
    last_ckpt_t: float = 0.0
    end_t: Optional[float] = None
    pending: List = field(default_factory=list)
    # while a fault is being detected/diagnosed the job is stalled but its
    # telemetry still flows; past this instant the node is swapped and the
    # job re-initialises (streaming detection sees nothing) — written by
    # DowntimeService, read by C4DService ticks
    isolating_until: float = 0.0


class RunContext:
    """Everything the services share for one engine run."""

    def __init__(self, spec: ScenarioSpec, mode: str,
                 rng: np.random.Generator, device=None):
        self.spec = spec
        self.mode = mode
        self.rng = rng                      # the kernel's seeded stream
        self.device = device                # torch backend's; None = the card
        topo = ClosTopology(n_hosts=spec.n_hosts,
                            oversubscription=spec.oversubscription)
        self.fabric = FabricState(topo, mode=mode,
                                  qps_per_port=spec.qps_per_port,
                                  seed=spec.seed)
        self.cluster = SimCluster(n_active=spec.n_nodes,
                                  n_backup=max(2, spec.n_nodes // 8))
        self.steering = SteeringService(self.cluster)
        self.telemetry = RingJobTelemetry(n_ranks=spec.telemetry_ranks,
                                          seed=spec.seed + 1)
        self.harness = DetectionHarness(
            self.telemetry, ranks_per_node=spec.ranks_per_node,
            backend=spec.backend, device=device,
            attribution=AttributionConfig() if spec.attribution else None)
        self.jobs: Dict[int, JobRun] = {}
        self.finished: List[JobRun] = []
        self.last_result = None             # latest steady-state RateResult
        # precision pipeline bookkeeping (written by FabricService): how
        # many fabric re-plans were triggered by suspect escalations —
        # the measured cost of a streaming false positive short of restart
        self.suspect_replans = 0

    # ------------------------------------------------------------------
    def bridge_for(self, run: JobRun,
                   result=None) -> Tuple[List[Fault], List[Tuple[int, int]]]:
        """Translate one job's live conn-rate drops (vs its healthy
        baseline) into enhanced-CCL slow-link signatures."""
        res = result if result is not None else self.last_result
        current = {k: v for k, v in res.conn_rate.items()
                   if k[0] == run.spec.job_id}
        return bridge_faults(run.baseline_conn, current, run.host_to_rank,
                             self.telemetry.n,
                             threshold=self.spec.bridge_threshold)

    def focus_runs(self) -> List[JobRun]:
        return [r for r in self.jobs.values() if r.spec.focus]
