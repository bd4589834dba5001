"""Monte Carlo fleet campaigns: randomized populations of fault drills.

One hand-scripted scenario answers "what happens in *this* incident"; the
paper's evaluation (§5, Table 3) and the related diagnostic systems
(CCL-D, Mycroft) instead report *fleet* statistics — detection
precision/recall, MTTR, and efficiency over large randomized fault
populations.  A campaign closes that gap: seeded samplers draw topology,
job mix, and a timed fault/contention population from the Table-1 error
taxonomy, compose each draw into an ordinary ``ScenarioSpec``, run every
trial through the unmodified scenario engine (optionally on both fabrics
for the C4P-vs-ECMP A/B), and aggregate the reports into the statistical
claims of ``repro_torch.scenarios.stats``.

Determinism contract: a campaign's output is a pure function of
``CampaignSpec`` (including ``seed``).  Trial ``i`` draws from
``default_rng([seed, i])`` and hands the engine an independently derived
trial seed, so reports are bit-identical across runs *and* across worker
counts (the process pool only changes wall time).

CLI: ``python -m repro_torch.scenarios.run --campaign fleet_smoke`` (see
docs/campaigns.md for the walkthrough).

Copy of ``repro.scenarios.montecarlo`` for the port. ``run_campaign`` takes
the ``device`` every trial's detection runs on (``None``: the card); the
process pool spawns its workers (a child forked after the parent touched
CUDA cannot use it) and hands each one the device and the parent's default
backend as plain values.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.c4d.master import OperatingPoint
from repro_torch.core.faults import sample_divergence_class, sample_error_class
from repro_torch.core.phases import HOURS
from repro_torch.core.torchsim import get_default_backend, use_backend
from repro_torch.scenarios.engine import run_scenario
from repro_torch.scenarios.report import CampaignReport
from repro_torch.scenarios.spec import (FailLink, InjectFault, JobSpec, RestoreLink,
                                  ScenarioSpec, StartJob, StopJob)
from repro_torch.scenarios.stats import aggregate, trial_metrics


@dataclass(frozen=True)
class CampaignSpec:
    """A Monte Carlo campaign: the distribution trials are drawn from.

    Everything the samplers may randomize is declared here, so the spec —
    like ``ScenarioSpec`` — is a plain JSON-serialisable value and the
    campaign report can embed the exact distribution it measured.

    Scale knobs: ``gpus`` is the simulated fleet size per trial (telemetry
    ranks, i.e. one rank per GPU as in the paper's enhanced CCL, §3.1);
    ``n_hosts`` sizes the Clos fabric (§4.1 testbed shape).  Fault knobs
    mirror Table 1: ``faults_per_hour`` drives a Poisson population whose
    classes follow the Table-1 error mix, ``link_flaps_per_hour`` adds the
    fabric events of Fig. 11, and ``tenant_range`` the Fig. 9 contention
    mix.  With ``compare_fabrics`` every trial runs the identical event
    script on C4P and ECMP, which is what feeds the paper's
    communication-cost and efficiency-gain claims (§5).
    """
    name: str
    description: str = ""
    paper_ref: str = ""
    seed: int = 0
    n_trials: int = 32
    gpus: int = 256                   # simulated GPUs (telemetry ranks)/trial
    ranks_per_node: int = 8
    duration_s: float = 4 * HOURS
    # fabric sampling
    n_hosts: int = 16
    oversubscription_choices: Tuple[float, ...] = (1.0, 2.0)
    qps_per_port: int = 2
    compare_fabrics: bool = True
    # job-mix sampling (Fig. 9 contention)
    tenant_range: Tuple[int, int] = (0, 6)
    # fault population (Table 1 mix)
    faults_per_hour: float = 0.75
    link_flaps_per_hour: float = 0.25
    # divergence-family population (Flare mix: SDC / loss spike / NaN).
    # 0.0 (the default) draws nothing and leaves every pre-existing
    # campaign's RNG stream and report bit-identical.
    divergence_faults_per_hour: float = 0.0
    # root-cause attribution per trial (Mycroft dependency cover)
    attribution: bool = False
    flap_outage_s: Tuple[float, float] = (300.0, 1800.0)
    apply_localization_ceiling: bool = True
    checkpoint_period_s: float = 600.0
    # always-on streaming C4D sampling period per trial.  30 s (the C4D
    # window) is the faithful setting; large-GPU campaigns may coarsen it —
    # a streaming window at 1024 ranks costs ~100 ms of wall time (see
    # benchmarks/bench_runtime.py), so 480 ticks/trial adds up.
    streaming_tick_s: float = 30.0
    # streaming precision pipeline (adaptive baselines + suspect/confirm
    # state machine) applied to every trial; None keeps the PR 5 behaviour.
    # The cost-optimal point comes from the ROC sweep
    # (``scenarios.precision``; CLI ``--sweep`` / ``--operating-point``).
    operating_point: Optional[OperatingPoint] = None
    # detection backend per trial ("numpy" | "torch" | "auto" — size-based
    # dispatch); None inherits the port's module default (torch), and every
    # value gives the reference's report
    backend: Optional[str] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def trial_rng(spec: CampaignSpec, trial: int) -> np.random.Generator:
    """The sampling stream for one trial: seeded by (campaign seed, index),
    so ``--seed`` fully determines every draw of every trial."""
    return np.random.default_rng([spec.seed, trial])


def sample_trial(spec: CampaignSpec, trial: int) -> ScenarioSpec:
    """Draw one trial's ``ScenarioSpec`` from the campaign distribution.

    The sampled spec is self-contained: ground-truth fault ranks/classes
    live in its event script, and its engine seed is an independent draw
    from the same stream — re-running the spec alone reproduces the trial.
    """
    rng = trial_rng(spec, trial)
    engine_seed = int(rng.integers(0, 2**31 - 1))
    oversub = float(rng.choice(np.asarray(spec.oversubscription_choices)))

    events: List = []
    # Table-1 fault population on the focus job (the same weighted draw
    # the Table-3 month simulation uses)
    n_faults = int(rng.poisson(spec.faults_per_hour * spec.duration_s / HOURS))
    for t in np.sort(rng.uniform(0.0, spec.duration_s, n_faults)):
        cls = sample_error_class(rng)
        events.append(InjectFault(t=float(t), job_id=0,
                                  error_class=cls.name,
                                  rank=int(rng.integers(0, spec.gpus))))
    # fabric flaps (Fig. 11): fail a leaf-spine link, restore after an outage
    n_flaps = int(rng.poisson(spec.link_flaps_per_hour
                              * spec.duration_s / HOURS))
    for _ in range(n_flaps):
        t = float(rng.uniform(0.0, 0.9 * spec.duration_s))
        link = ("ls", int(rng.integers(0, 8)), int(rng.integers(0, 8)))
        outage = float(rng.uniform(*spec.flap_outage_s))
        events.append(FailLink(t=t, link=link))
        events.append(RestoreLink(t=min(t + outage, spec.duration_s), link=link))
    # tenant churn (Fig. 9): 2-host jobs crossing the spines
    n_tenants = int(rng.integers(spec.tenant_range[0],
                                 spec.tenant_range[1] + 1))
    half = max(spec.n_hosts // 2, 1)
    for j in range(1, n_tenants + 1):
        h = int(rng.integers(0, half))
        start = float(rng.uniform(0.0, 0.5 * spec.duration_s))
        stop = start + float(rng.uniform(0.25 * spec.duration_s,
                                         0.5 * spec.duration_s))
        events.append(StartJob(t=start, job_id=j, hosts=(h, h + half)))
        if stop < spec.duration_s:
            events.append(StopJob(t=stop, job_id=j))
    # divergence-family population (guarded: a poisson draw at rate 0 would
    # still consume RNG state and shift every pre-existing campaign golden)
    if spec.divergence_faults_per_hour > 0:
        n_div = int(rng.poisson(spec.divergence_faults_per_hour
                                * spec.duration_s / HOURS))
        for t in np.sort(rng.uniform(0.0, spec.duration_s, n_div)):
            cls = sample_divergence_class(rng)
            events.append(InjectFault(t=float(t), job_id=0,
                                      error_class=cls.name,
                                      rank=int(rng.integers(0, spec.gpus))))

    return ScenarioSpec(
        name=f"{spec.name}_trial{trial:03d}",
        description=f"Monte Carlo trial {trial} of campaign {spec.name}",
        paper_ref=spec.paper_ref,
        seed=engine_seed,
        duration_s=spec.duration_s,
        n_hosts=spec.n_hosts,
        oversubscription=oversub,
        qps_per_port=spec.qps_per_port,
        compare_fabrics=spec.compare_fabrics,
        n_nodes=max(spec.gpus // spec.ranks_per_node, 2),
        telemetry_ranks=spec.gpus,
        ranks_per_node=spec.ranks_per_node,
        checkpoint_period_s=spec.checkpoint_period_s,
        apply_localization_ceiling=spec.apply_localization_ceiling,
        streaming_tick_s=spec.streaming_tick_s,
        operating_point=spec.operating_point,
        backend=spec.backend,
        attribution=spec.attribution,
        divergence=spec.divergence_faults_per_hour > 0,
        jobs=(JobSpec(0, tuple(range(spec.n_hosts))),),
        events=tuple(events),
    )


def _run_trial(spec: ScenarioSpec, device=None, backend: Optional[str] = None) -> dict:
    """Process-pool worker: one engine run, reduced to its trial record.
    ``backend`` is the caller's default backend, restored in the worker."""
    with use_backend(backend):
        return trial_metrics(run_scenario(spec, device=device))


def run_campaign(spec: CampaignSpec, workers: int = 1,
                 progress: Optional[Callable[[int, int], None]] = None,
                 device=None) -> CampaignReport:
    """Sample and execute every trial; aggregate into a ``CampaignReport``.

    ``workers > 1`` fans trials over a process pool; results are collected
    in trial order, so the report is identical for any worker count.
    ``device``: where the trials' torch backend runs (``None``: the card)."""
    specs = [sample_trial(spec, i) for i in range(spec.n_trials)]
    trials: List[dict] = []
    if workers > 1 and spec.n_trials > 1:
        dev = None if device is None else str(device)
        backend = get_default_backend()
        with ProcessPoolExecutor(max_workers=workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            for i, rec in enumerate(pool.map(_run_trial, specs, [dev] * len(specs),
                                             [backend] * len(specs))):
                trials.append(rec)
                if progress:
                    progress(i + 1, spec.n_trials)
    else:
        for i, s in enumerate(specs):
            trials.append(_run_trial(s, device))
            if progress:
                progress(i + 1, spec.n_trials)
    return CampaignReport(campaign=spec.to_dict(), trials=trials,
                          aggregates=aggregate(trials))


# ---------------------------------------------------------------------------
# Shipped campaigns
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], CampaignSpec]] = {}


def register(fn: Callable[[], CampaignSpec]) -> Callable[[], CampaignSpec]:
    spec = fn()
    _REGISTRY[spec.name] = fn
    return fn


def names() -> List[str]:
    return sorted(_REGISTRY)


def get(name: str, seed: Optional[int] = None, n_trials: Optional[int] = None,
        gpus: Optional[int] = None,
        operating_point: Optional[OperatingPoint] = None,
        backend: Optional[str] = None,
        attribution: Optional[bool] = None) -> CampaignSpec:
    """Look up a shipped campaign, with CLI-style overrides applied."""
    try:
        spec = _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown campaign {name!r}; choose from {names()}")
    over = {k: v for k, v in
            (("seed", seed), ("n_trials", n_trials), ("gpus", gpus),
             ("operating_point", operating_point), ("backend", backend),
             ("attribution", attribution))
            if v is not None}
    return dataclasses.replace(spec, **over) if over else spec


@register
def fleet_smoke() -> CampaignSpec:
    """CI-sized fleet: small enough for the campaign-smoke job, still
    exercising every sampler (faults, flaps, tenants, A/B arms)."""
    return CampaignSpec(
        name="fleet_smoke",
        description="8 seeded trials at 64 GPUs: Table-1 fault mix, link "
                    "flaps, tenant churn, C4P-vs-ECMP A/B.",
        paper_ref="Table 1 mix, Fig. 9/11 events, Table 3 phases",
        n_trials=8, gpus=64, duration_s=2 * HOURS,
        faults_per_hour=1.0)


@register
def fleet_1024() -> CampaignSpec:
    """The scale target: 64 trials at 1024 simulated GPUs (the regime the
    vectorized C4D path exists for).  Streaming detection samples every
    120 s here — a 1024-rank streaming window costs ~100 ms of wall time,
    so the faithful 30 s tick would dominate the campaign."""
    return CampaignSpec(
        name="fleet_1024",
        description="64 trials at 1024 GPUs each: randomized Table-1 fault "
                    "populations with contention and flaps, statistical "
                    "paper-claim report with CIs.",
        paper_ref="§5 fleet statistics, Table 3, Fig. 9/11",
        n_trials=64, gpus=1024, duration_s=4 * HOURS,
        streaming_tick_s=120.0)


@register
def paper_claims() -> CampaignSpec:
    """The claim-bracketing campaign: enough trials for tight CIs on the
    30 %-overhead-cut / 15 %-comm-cut / 30-45 %-efficiency-gain triplet."""
    return CampaignSpec(
        name="paper_claims",
        description="32 trials at 256 GPUs, mixed 1:1 / 2:1 fabrics, "
                    "Table-1 localization ceilings applied — the abstract's "
                    "three claims with 95 % CIs.",
        paper_ref="abstract (30 %/15 %/30-45 %), Table 1, Table 3",
        n_trials=32, gpus=256, duration_s=6 * HOURS,
        faults_per_hour=0.5)


@register
def fleet_mixed() -> CampaignSpec:
    """Mixed-family campaign: the Table-1 comm population *and* the
    Flare divergence population in the same trials, attribution on — the
    per-family precision/recall report this campaign exists to feed."""
    return CampaignSpec(
        name="fleet_mixed",
        description="8 trials at 64 GPUs mixing Table-1 comm faults with "
                    "divergence faults (SDC / loss spike / NaN) at equal "
                    "rates, root-cause attribution on: per-family "
                    "precision/recall + attribution hit rate.",
        paper_ref="Table 1 mix + Flare divergence families; Mycroft "
                  "attribution",
        n_trials=8, gpus=64, duration_s=2 * HOURS,
        faults_per_hour=0.75, divergence_faults_per_hour=0.75,
        attribution=True)


@register
def detector_stress() -> CampaignSpec:
    """Detector-quality campaign: dense fault population, no localization
    ceiling, single fabric — raw precision/recall and MTTR percentiles."""
    return CampaignSpec(
        name="detector_stress",
        description="24 trials at 512 GPUs with a dense fault population "
                    "and no Table-1 ambiguity ceiling: pure detector "
                    "precision/recall + detection-latency percentiles.",
        paper_ref="§3.1 detection, Table 1 syndromes",
        n_trials=24, gpus=512, duration_s=3 * HOURS,
        faults_per_hour=2.0, link_flaps_per_hour=0.0,
        tenant_range=(0, 2), compare_fabrics=False,
        apply_localization_ceiling=False)
