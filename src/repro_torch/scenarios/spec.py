"""Declarative scenario specs: topology, job mix, timed event script, assertions.

A ``ScenarioSpec`` is a plain dataclass (JSON-serialisable via ``to_dict``)
describing one end-to-end fault drill.  The engine interprets it; the spec
itself never touches simulator state, so the same spec can drive the
virtual-clock engine, the live-trainer driver (``scenarios.live``), or a
future hardware harness.  See docs/scenarios.md for the authoring guide.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.c4d.master import OperatingPoint

# ---------------------------------------------------------------------------
# Timed events
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Event:
    """Base timed event; ``t`` is seconds on the campaign's virtual clock."""
    t: float

    def to_dict(self) -> dict:
        d = asdict(self)
        d["type"] = type(self).__name__
        return d


@dataclass(frozen=True)
class InjectFault(Event):
    """A node-level hardware fault surfacing through enhanced-CCL telemetry.

    Either ``error_class`` (a Table-1 name: cuda_error, ecc_nvlink,
    nccl_timeout, ack_timeout, network_other — or a divergence-family name:
    silent_data_corruption, loss_spike, nan_rank) or an explicit telemetry
    ``kind`` (crash, comm_hang, noncomm_hang, slow_src, slow_dst, slow_link,
    straggler, sdc, loss_spike, nan_rank).  ``rank`` is a telemetry rank;
    drawn from the spec RNG when omitted.  Drives the real C4D pipeline:
    detection -> isolation -> checkpoint-restart, accounted in Table-3
    phases.
    """
    job_id: int = 0
    error_class: Optional[str] = None
    kind: Optional[str] = None
    rank: Optional[int] = None
    severity: Optional[float] = None


@dataclass(frozen=True)
class FailLink(Event):
    """A fabric link goes down (leaf-spine flap, NIC port).  Visible to C4D
    only through the live netsim: conn rates drop, the telemetry bridge
    synthesises the matching slow-link signatures, and — if detection
    confirms — the link is blacklisted for C4P re-planning."""
    link: Tuple = ()


@dataclass(frozen=True)
class RestoreLink(Event):
    link: Tuple = ()


@dataclass(frozen=True)
class StartJob(Event):
    """A tenant job arrives (bandwidth contention)."""
    job_id: int = 0
    hosts: Tuple[int, ...] = ()


@dataclass(frozen=True)
class StopJob(Event):
    job_id: int = 0


EVENT_TYPES = {c.__name__: c for c in
               (InjectFault, FailLink, RestoreLink, StartJob, StopJob)}


def event_from_dict(d: dict) -> Event:
    d = dict(d)
    cls = EVENT_TYPES[d.pop("type")]
    if "link" in d and d["link"] is not None:
        d["link"] = tuple(d["link"])
    if "hosts" in d:
        d["hosts"] = tuple(d["hosts"])
    return cls(**d)


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class JobSpec:
    """One tenant job: a ring-allreduce over ``hosts`` (testbed host ids)."""
    job_id: int
    hosts: Tuple[int, ...]
    focus: bool = True          # counted in goodput / downtime accounting


@dataclass(frozen=True)
class Assertions:
    """Pass/fail gates evaluated into the report (CLI exits non-zero on fail)."""
    max_detection_s: Optional[float] = None
    min_localization: Optional[float] = None       # hits / faults
    min_attribution: Optional[float] = None        # culprit hits / attempts
    max_downtime_frac: Optional[float] = None      # Table-3 total / duration
    min_goodput_frac: Optional[float] = None       # focus-job progress / ideal
    min_restarts: Optional[int] = None
    c4p_ge_ecmp: bool = False                      # A/B only: goodput ordering


@dataclass(frozen=True)
class ScenarioSpec:
    name: str
    description: str
    paper_ref: str = ""                       # figure/table reproduced
    seed: int = 0
    duration_s: float = 3600.0

    # fabric (core/topology + core/netsim via scenarios.fabric)
    n_hosts: int = 16
    oversubscription: float = 1.0
    fabric: str = "c4p"                       # "c4p" | "ecmp"
    qps_per_port: int = 2
    compare_fabrics: bool = False             # run both, report variants + A/B

    # cluster / detection (core/cluster + core/c4d via scenarios.detection)
    n_nodes: int = 16                         # SimCluster active nodes
    telemetry_ranks: int = 32
    ranks_per_node: int = 8
    checkpoint_period_s: float = 600.0        # Gemini-style frequent ckpt
    reinit_s: float = 330.0                   # C4D_DEC23 policy
    assisted_diag_median_s: float = 2700.0    # non-localised fallback
    apply_localization_ceiling: bool = False  # Table-1 ambiguity draw
    bridge_threshold: float = 1.8             # conn-rate ratio -> telemetry fault
    streaming_tick_s: float = 30.0            # always-on C4D sampling period
    #                                           (0 disables the streaming path)
    # precision pipeline for the streaming master (adaptive baselines +
    # suspect/confirm state machine); None keeps the pinned PR 5 behaviour
    operating_point: Optional[OperatingPoint] = None
    # detection backend of the port ("numpy" | "torch" | "auto"); None
    # inherits the port's module default (REPRO_TORCH_SIM_BACKEND env var or
    # "torch", core/torchsim); every value gives the reference's report
    backend: Optional[str] = None
    # root-cause attribution: the Mycroft-style dependency cover narrows
    # ring-level verdicts to culprit ranks/links (False keeps the pinned
    # verdict->node fold and byte-identical pre-PR-8 reports)
    attribution: bool = False
    # divergence channel: export per-rank train signals and run the
    # Flare-style detector next to the comm syndromes (False: no train
    # telemetry is synthesised at all)
    divergence: bool = False

    jobs: Tuple[JobSpec, ...] = ()
    events: Tuple[Event, ...] = ()
    assertions: Assertions = field(default_factory=Assertions)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["jobs"] = [asdict(j) for j in self.jobs]
        d["events"] = [e.to_dict() for e in self.events]
        return d

    def sorted_events(self) -> List[Event]:
        return sorted(self.events, key=lambda e: e.t)

    def focus_jobs(self) -> List[JobSpec]:
        return [j for j in self.jobs if j.focus]


# ---------------------------------------------------------------------------
# Continuous fleet
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FleetSpec:
    """One continuous multi-tenant fleet simulation (docs/fleet.md).

    Where a ``CampaignSpec`` freezes its tenant count per trial, a fleet
    runs *one* long-horizon kernel with tenant arrival/departure as a live
    seeded Poisson process, faults and link flaps as live processes on the
    same clock, one persistent global C4P master doing admission +
    placement, per-tenant SLO accounting, and rolling campaign reports
    emitted every ``report_period_s`` while the fleet runs
    (``repro_torch.scenarios.fleet``).
    """
    name: str
    description: str = ""
    paper_ref: str = ""
    seed: int = 0
    duration_s: float = 86400.0               # the "month in a day" horizon

    # fleet scale: the anchor job is the flagship tenant — one ring over
    # every host, one telemetry rank per simulated GPU (paper §3.1)
    gpus: int = 10240
    ranks_per_node: int = 8
    n_hosts: int = 64
    oversubscription: float = 1.0
    fabric: str = "c4p"
    qps_per_port: int = 2

    # live tenant process: Poisson arrivals, uniform lifetimes, small jobs
    # placed on the least-loaded hosts by the persistent C4P master
    tenant_arrivals_per_hour: float = 1.0
    tenant_lifetime_s: Tuple[float, float] = (1800.0, 14400.0)
    tenant_hosts_choices: Tuple[int, ...] = (2, 4)
    max_jobs_per_host: int = 3                # admission control ceiling

    # live fault/flap populations (Table-1 mix; Fig. 11 fabric events)
    faults_per_hour: float = 0.5
    divergence_faults_per_hour: float = 0.0
    tenant_fault_fraction: float = 0.25       # faults landing on tenants
    link_flaps_per_hour: float = 0.25
    flap_outage_s: Tuple[float, float] = (300.0, 1800.0)

    # detection / accounting knobs forwarded to the anchor scenario
    checkpoint_period_s: float = 600.0
    apply_localization_ceiling: bool = True
    streaming_tick_s: float = 900.0
    operating_point: Optional[OperatingPoint] = None
    backend: Optional[str] = None
    attribution: bool = False

    # per-tenant SLO accounting (docs/fleet.md "SLO semantics")
    slo_goodput_floor_frac: float = 0.5       # busbw >= floor * healthy
    slo_mttr_budget_s: float = 1800.0         # per-fault repair budget

    # rolling report cadence (also the fleet service's tick period)
    report_period_s: float = 7200.0

    def to_dict(self) -> dict:
        return asdict(self)

    def scenario_spec(self) -> "ScenarioSpec":
        """The anchor ``ScenarioSpec`` the fleet kernel is built from: the
        flagship job over every host, an *empty* event script — every
        fault, flap, and tenant is generated live by ``FleetService``."""
        return ScenarioSpec(
            name=f"{self.name}_anchor",
            description=f"continuous fleet anchor for {self.name}",
            paper_ref=self.paper_ref,
            seed=self.seed,
            duration_s=self.duration_s,
            n_hosts=self.n_hosts,
            oversubscription=self.oversubscription,
            fabric=self.fabric,
            qps_per_port=self.qps_per_port,
            n_nodes=max(self.gpus // self.ranks_per_node, 2),
            telemetry_ranks=self.gpus,
            ranks_per_node=self.ranks_per_node,
            checkpoint_period_s=self.checkpoint_period_s,
            apply_localization_ceiling=self.apply_localization_ceiling,
            streaming_tick_s=self.streaming_tick_s,
            operating_point=self.operating_point,
            backend=self.backend,
            attribution=self.attribution,
            divergence=self.divergence_faults_per_hour > 0,
            jobs=(JobSpec(0, tuple(range(self.n_hosts))),),
            events=(),
        )


def two_host_jobs(n_jobs: int = 8, stride: int = 8) -> Tuple[JobSpec, ...]:
    """The paper's Fig. 9/11 layout: 8 concurrent 2-server jobs crossing the
    spines (job j on hosts [j, j+stride])."""
    return tuple(JobSpec(j, (j, j + stride)) for j in range(n_jobs))


def check(name: str, ok: bool, value, limit) -> Dict[str, object]:
    return {"name": name, "ok": bool(ok), "value": value, "limit": limit}


def evaluate_assertions(a: Assertions, report: dict,
                        variants: Optional[dict] = None) -> List[dict]:
    """Fold a report dict against the spec's assertion gates."""
    checks: List[dict] = []
    det = report["detection"]
    if a.max_detection_s is not None and det["latencies_s"]:
        worst = max(det["latencies_s"])
        checks.append(check("max_detection_s", worst <= a.max_detection_s,
                            worst, a.max_detection_s))
    if a.min_localization is not None and det["n_faults"]:
        acc = det["localization_accuracy"]
        checks.append(check("min_localization", acc >= a.min_localization,
                            acc, a.min_localization))
    if a.min_attribution is not None and det.get("attribution_attempts"):
        rate = det["attribution_hits"] / det["attribution_attempts"]
        checks.append(check("min_attribution", rate >= a.min_attribution,
                            rate, a.min_attribution))
    if a.max_downtime_frac is not None:
        frac = report["downtime"]["fraction_of_duration"]
        checks.append(check("max_downtime_frac", frac <= a.max_downtime_frac,
                            frac, a.max_downtime_frac))
    if a.min_goodput_frac is not None:
        frac = report["goodput"]["fraction"]
        checks.append(check("min_goodput_frac", frac >= a.min_goodput_frac,
                            frac, a.min_goodput_frac))
    if a.min_restarts is not None:
        n = report["restarts"]
        checks.append(check("min_restarts", n >= a.min_restarts,
                            n, a.min_restarts))
    if a.c4p_ge_ecmp and variants:
        c4p = variants["c4p"]["goodput"]["effective_gbps"]
        ecmp = variants["ecmp"]["goodput"]["effective_gbps"]
        checks.append(check("c4p_ge_ecmp", c4p >= ecmp, c4p, ecmp))
    return checks
