"""Service-to-service events of the scenario runtime (docs/runtime.md).

The *external* vocabulary — ``InjectFault``, ``FailLink``, ``RestoreLink``,
``StartJob``, ``StopJob`` — lives in ``scenarios.spec`` and is scheduled
onto the kernel verbatim by the composition root.  This module defines the
*internal* events services publish at each other while reacting:

    JobAdmitted      root/fabric lifecycle: a job joins the fabric
    RestartComplete  downtime: a checkpoint-restart cycle finished (timed)
    JobResumed       downtime: job back up; streaming state may reset
    FaultDetected    c4d: the per-fault reference pipeline's verdict
    FabricTransient  fabric: post-flap rates before the control plane reacts
    LinkObserved     c4d: did detection observe a fabric degradation?
    BusbwChanged     fabric: fresh per-job busbw after a re-plan
    NodeSuspected    c4d: precision state machine escalated a node to
                     *suspect* — fabric deprioritizes it (re-plan, not restart)
    NodeCleared      c4d: a suspect node de-escalated back to healthy

Events are plain frozen dataclasses; bulky payloads define ``trace_label``
so the kernel's determinism trace stays compact but bit-stable.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.scenarios.spec import InjectFault, JobSpec, StartJob


@dataclass(frozen=True)
class JobAdmitted:
    """A job joins the run: initial jobs (published by the composition root
    at t=0) and tenant churn (``StartJob`` script events) both land here."""
    jspec: JobSpec


def admitted_spec(ev: StartJob) -> JobSpec:
    """Tenant churn arrivals are background jobs (not goodput-accounted)."""
    return JobSpec(ev.job_id, tuple(ev.hosts), focus=False)


@dataclass(frozen=True)
class RestartComplete:
    """Scheduled by the downtime accountant when a fault's full Table-3
    cycle (detection + diagnosis/isolation + re-init) elapses."""
    job_id: int


@dataclass(frozen=True)
class JobResumed:
    """The job is back up from its checkpoint; published *before* any
    pending (queued-during-restart) faults are replayed, so observers can
    reset per-incident state without clobbering the replays."""
    job_id: int


@dataclass(frozen=True)
class FaultDetected:
    """The per-fault reference pipeline ran for an ``InjectFault``.

    ``outcome`` is the ``scenarios.detection.DetectionOutcome`` (with the
    Table-1 localisation ceiling already applied); consumed by the downtime
    accountant to drive isolation and checkpoint-restart accounting."""
    event: InjectFault
    fault: Any                       # core.faults.Fault
    outcome: Any                     # scenarios.detection.DetectionOutcome
    expected_node: int

    @property
    def trace_label(self) -> str:
        o = self.outcome
        return (f"FaultDetected(job={self.event.job_id}, kind={self.fault.kind},"
                f" acted={o.acted}, localized={o.localized},"
                f" windows={o.windows}, node={self.expected_node})")


@dataclass(frozen=True)
class FabricTransient:
    """Rates right after a link failure, before C4P re-plans (dead QPs
    stall their connections — what the enhanced CCL sees during the first
    monitoring window).  ``result`` is a ``core.netsim.RateResult``."""
    link: Tuple
    result: Any = field(compare=False)

    @property
    def trace_label(self) -> str:
        return f"FabricTransient(link={tuple(self.link)})"


@dataclass(frozen=True)
class LinkObserved:
    """Detection's verdict on one fabric degradation sweep: when ``acted``
    the fabric blacklists the link for re-planning (detect->avoid)."""
    link: Tuple
    job_id: int
    acted: bool
    edge_hit: bool


@dataclass(frozen=True)
class NodeSuspected:
    """The streaming C4D precision state machine (``OperatingPoint``)
    escalated a telemetry node to *suspect*: graceful degradation — the
    fabric steers traffic away from the node's host before any isolation
    decision, so a false positive costs a re-plan, not a restart."""
    node: int
    score: float = 0.0               # strongest verdict z behind the streak


@dataclass(frozen=True)
class NodeCleared:
    """A suspect node's streak decayed back to zero: recovered — the
    fabric restores it for traffic planning."""
    node: int


@dataclass(frozen=True)
class BusbwChanged:
    """Per-job busbw after a fabric re-evaluation (re-plan, churn, flap)."""
    busbw: Dict[int, float] = field(compare=False)
    first_for: Optional[int] = None

    @property
    def trace_label(self) -> str:
        bw = ", ".join(f"{j}:{v:.6g}" for j, v in sorted(self.busbw.items()))
        return f"BusbwChanged(first_for={self.first_for}, busbw={{{bw}}})"
