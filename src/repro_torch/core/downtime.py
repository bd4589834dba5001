"""Month-scale downtime accounting — reproduces the paper's Table 3.

Two policies over the same fault sequence:

  * BASELINE (June 2023): no C4D. Hangs burn the PyTorch elastic-agent
    timeout (~30 min) before anyone notices; diagnosis is manual
    (hours-to-days, log-spelunking across generic "NCCL Error"s);
    checkpoints are infrequent.
  * C4D (December 2023): the detection pipeline *actually runs* — for every
    injected fault the shared ``repro_torch.scenarios.detection.DetectionHarness``
    synthesises enhanced-CCL telemetry, feeds it through the C4a agents and
    the C4D master, and this simulator acts on the verdict. Localised
    faults are isolated + restarted in minutes; non-localised ones (Table 1
    localization rates) fall back to assisted manual diagnosis. Checkpoints
    are frequent (10 min, Gemini-style in-memory).

Downtime components per error (paper Fig. 1): detection, diagnosis &
isolation, post-checkpoint (lost work), re-initialisation.

This module is a thin consumer of the scenario campaign engine's building
blocks (see docs/architecture.md); event-scripted drills over the same
pipeline live in ``repro_torch.scenarios``.  The Table-3 output is regression
pinned (tests/test_downtime_regression.py) — RNG draw order is part of the
contract.

Copy of ``repro.core.downtime`` for the port. ``device`` is where the
harness's masters run the torch backend (``None``: the card); at
``backend="numpy"`` (``core/torchsim.use_backend``) no device is needed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

from repro_torch.core.cluster import SimCluster, SteeringService
from repro_torch.core.faults import RingJobTelemetry, sample_error_class
from repro_torch.core.phases import DAYS, HOURS, PHASE_LABELS
from repro_torch.scenarios.detection import DetectionHarness


@dataclass
class Policy:
    name: str
    errors_per_month: float
    checkpoint_period_s: float
    use_c4d: bool
    # baseline-only knobs
    hang_timeout_s: float = 30 * 60          # elastic agent
    # a crashed rank blocks its peers inside collectives, so even crashes
    # mostly burn a large fraction of the elastic-agent timeout before the
    # job is torn down (paper: "PyTorch jobs might hang for up to 30 min")
    crash_notice_s: float = 20 * 60
    manual_diag_median_s: float = 2.2 * HOURS
    manual_diag_sigma: float = 1.0           # lognormal sigma
    manual_diag_cap_s: float = 36 * HOURS
    # c4d-only knobs
    assisted_diag_median_s: float = 45 * 60  # non-localised fallback
    reinit_s: float = 6 * 60


BASELINE_JUN23 = Policy("baseline_jun23", errors_per_month=40,
                        checkpoint_period_s=2.7 * HOURS, use_c4d=False)
C4D_DEC23 = Policy("c4d_dec23", errors_per_month=12,
                   checkpoint_period_s=10 * 60, use_c4d=True,
                   reinit_s=5.5 * 60)


@dataclass
class DowntimeReport:
    policy: str
    month_s: float
    n_errors: int
    detection_s: float = 0.0
    diagnosis_s: float = 0.0
    post_checkpoint_s: float = 0.0
    reinit_s: float = 0.0
    per_class_diag_s: Dict[str, float] = field(default_factory=dict)
    localized: int = 0

    @property
    def total_s(self) -> float:
        return self.detection_s + self.diagnosis_s + self.post_checkpoint_s + self.reinit_s

    def fractions(self) -> Dict[str, float]:
        m = self.month_s
        return {
            PHASE_LABELS["post_checkpoint_s"]: self.post_checkpoint_s / m,
            PHASE_LABELS["detection_s"]: self.detection_s / m,
            PHASE_LABELS["diagnosis_isolation_s"]: self.diagnosis_s / m,
            PHASE_LABELS["re_initialization_s"]: self.reinit_s / m,
            "total": self.total_s / m,
        }


class DowntimeSimulator:
    """Discrete-event month of one large training job."""

    def __init__(self, n_nodes: int = 300, ranks_per_node: int = 8, seed: int = 0,
                 device=None):
        # paper's reference job: 2400 GPUs = 300 nodes
        self.n_nodes = n_nodes
        self.ranks_per_node = ranks_per_node
        self.seed = seed
        self.device = device

    def run(self, policy: Policy, month_days: float = 30.0) -> DowntimeReport:
        rng = np.random.default_rng(self.seed)
        month = month_days * DAYS
        n_errors = int(rng.poisson(policy.errors_per_month * month_days / 30.0))
        report = DowntimeReport(policy.name, month, n_errors)
        cluster = SimCluster(n_active=self.n_nodes,
                             n_backup=max(2, self.n_nodes // 16))
        steering = SteeringService(cluster)
        # modest telemetry job standing in for the 2400-GPU job (detector
        # behaviour is rank-count independent; 64 ranks keeps the sim fast)
        telemetry = RingJobTelemetry(n_ranks=64, seed=self.seed + 1)
        # the same harness the scenario campaign engine drives: telemetry
        # synthesis -> C4a agents -> C4D master, fresh master per error
        harness = DetectionHarness(telemetry, ranks_per_node=8, device=self.device)

        for e in range(n_errors):
            cls = sample_error_class(rng)
            # --- post-checkpoint loss: work since the last checkpoint
            lost = rng.uniform(0, policy.checkpoint_period_s)
            report.post_checkpoint_s += lost
            if policy.use_c4d:
                out = harness.detect_class(cls, rng)
                report.detection_s += out.detection_s
                if out.localized:
                    report.localized += 1
                    _, steer_s = steering.execute(out.node % self.n_nodes,
                                                  t=0.0, reason=cls.name)
                    diag = steer_s + rng.uniform(2 * 60, 8 * 60)  # verdict->action
                else:
                    diag = float(np.clip(
                        rng.lognormal(np.log(policy.assisted_diag_median_s), 0.6),
                        5 * 60, 4 * HOURS))
                report.diagnosis_s += diag
            else:
                hang = cls.syndrome in ("comm_hang",)
                det = policy.hang_timeout_s if hang else policy.crash_notice_s
                report.detection_s += det
                diag = float(np.clip(
                    rng.lognormal(np.log(policy.manual_diag_median_s),
                                  policy.manual_diag_sigma),
                    10 * 60, policy.manual_diag_cap_s))
                report.diagnosis_s += diag
            report.per_class_diag_s[cls.name] = \
                report.per_class_diag_s.get(cls.name, 0.0) + diag
            report.reinit_s += policy.reinit_s
        return report


def table3(seed: int = 0, n_nodes: int = 300, device=None) -> Dict[str, DowntimeReport]:
    sim = DowntimeSimulator(n_nodes=n_nodes, seed=seed, device=device)
    return {
        "jun_2023_baseline": sim.run(BASELINE_JUN23),
        "dec_2023_c4d": sim.run(C4D_DEC23),
    }
