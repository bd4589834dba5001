"""Continuous fleet simulation: fleet-as-a-service over the runtime kernel.

Where ``montecarlo.run_campaign`` runs many independent short trials, a
fleet run is *one* long-horizon kernel that never restarts: tenants
arrive and depart as a live Poisson process, faults and link flaps fire
as live processes on the same virtual clock, one persistent global C4P
master admits and places every job, and rolling campaign reports are
emitted at a configurable cadence while the fleet runs (docs/fleet.md).

``FleetRun`` exposes the incremental stepping the continuous layer is
built on (``start`` / ``run_to`` / ``finish``): because the kernel's
horizon-splitting contract makes ``run_to`` bit-identical to a straight
run, a ``FleetRun`` can be snapshotted (``copy.deepcopy``) mid-run and
resumed — the resumed report equals the uninterrupted one, which the
snapshot/resume regression test pins.

The registry mirrors ``montecarlo``'s: ``fleet_hour`` (CI-sized smoke),
``fleet_day`` (the acceptance run: >= 10k simulated GPUs for a simulated
day), ``fleet_month`` (the paper's billing horizon).

Copy of ``repro.scenarios.fleet`` for the port: ``FleetRun`` and
``run_fleet`` take the ``device`` the fleet's detection runs on (``None``:
the card), and ``use_backend`` is the port's (``core/torchsim``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.core.torchsim import use_backend
from repro_torch.runtime import EventBus
from repro_torch.scenarios.engine import build_services
from repro_torch.scenarios.report import _ci, _fmt
from repro_torch.scenarios.services import FleetService, JobAdmitted, RunContext
from repro_torch.scenarios.spec import FleetSpec


@dataclass
class FleetReport:
    """Deterministic result of one continuous fleet run.

    ``rolling`` carries every mid-run report segment exactly as it was
    emitted (each with the cumulative SLO totals and aggregates *at that
    boundary*); ``aggregates`` / ``slo`` are the final state.  The
    zero-drift contract: folding the ``slo_segment`` values of ``rolling``
    in order reproduces ``slo``'s totals bit-exactly, and ``aggregates``
    equals ``stats.aggregate`` over the segment records."""
    fleet: dict
    rolling: List[dict] = field(default_factory=list)
    aggregates: dict = field(default_factory=dict)
    slo: dict = field(default_factory=dict)
    tenants: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"fleet": self.fleet,
                "name": self.fleet.get("name"),
                "seed": self.fleet.get("seed"),
                "n_segments": len(self.rolling),
                "rolling": self.rolling,
                "aggregates": self.aggregates,
                "slo": self.slo,
                "tenants": self.tenants}

    def to_markdown(self) -> str:
        return render_fleet_markdown(self.to_json())

    def summary_lines(self) -> List[str]:
        """Console summary (the CLI's non-JSON output)."""
        f = self.fleet
        agg = self.aggregates
        det = agg["detection"]
        slo = self.slo
        ten = self.tenants
        lines = [
            f"fleet         : {f['name']}  seed={f['seed']}  "
            f"gpus={f['gpus']}  horizon={f['duration_s'] / 3600.0:.1f} h",
            f"segments      : {len(self.rolling)} rolling reports every "
            f"{f['report_period_s'] / 3600.0:.1f} h",
            f"tenants       : {ten['arrived']} arrived | "
            f"{ten['departed']} departed | {ten['rejected']} rejected | "
            f"peak {ten['peak_concurrent']} concurrent",
            f"faults        : {det['n_faults']} injected | "
            f"precision {det['precision']:.3f} | recall {det['recall']:.3f}",
            f"SLO           : {slo['violation_minutes']:.1f} violation min "
            f"({_fmt(100.0 * slo['violation_frac'], 2)} % of tenant time) | "
            f"MTTR budget {slo['mttr_violations']}/{slo['mttr_events']} "
            f"blown",
            f"goodput       : {_ci(agg['efficiency']['goodput_frac'], 3)} "
            f"of ideal per segment",
        ]
        return lines


def render_fleet_markdown(rep: dict) -> str:
    """Markdown for a fleet-report JSON dict."""
    f = rep["fleet"]
    agg = rep["aggregates"]
    det = agg["detection"]
    ov = agg["overhead"]
    slo = rep["slo"]
    ten = rep["tenants"]
    out = [
        f"# Fleet `{f['name']}`",
        "",
        f"{f.get('description', '')}",
        "",
        f"*{f['gpus']} simulated GPUs · {f['duration_s'] / 3600.0:.1f} h "
        f"horizon · seed {f['seed']} · {rep['n_segments']} rolling segments "
        f"every {f['report_period_s'] / 3600.0:.1f} h*",
        "",
        "## Tenant process",
        "",
        "| metric | value |",
        "|---|---|",
        f"| arrived / departed / rejected | {ten['arrived']} / "
        f"{ten['departed']} / {ten['rejected']} |",
        f"| peak concurrent jobs | {ten['peak_concurrent']} |",
        f"| link flaps (skipped) | {ten['flaps']} ({ten['flaps_skipped']}) |",
        "",
        "## SLO accounting",
        "",
        "| metric | value |",
        "|---|---|",
        f"| goodput floor | {slo['goodput_floor_frac']:.2f} of healthy "
        f"busbw |",
        f"| MTTR budget | {slo['mttr_budget_s']:.0f} s |",
        f"| tenant time | {slo['tenant_s'] / 3600.0:.1f} h |",
        f"| violation minutes | {slo['violation_minutes']:.1f} "
        f"({100.0 * slo['violation_frac']:.2f} % of tenant time) |",
        f"| downtime hours | {slo['downtime_s'] / 3600.0:.2f} |",
        f"| MTTR budget violations | {slo['mttr_violations']}/"
        f"{slo['mttr_events']} (excess {slo['mttr_excess_s']:.0f} s) |",
        "",
        "## Detection (cumulative, vs injected ground truth)",
        "",
        "| metric | value |",
        "|---|---|",
        f"| injected faults | {det['n_faults']} |",
        f"| precision / recall | {det['precision']:.3f} / "
        f"{det['recall']:.3f} |",
        f"| MTTR p50 / p99 | {_fmt(ov['mttr_s']['p50'], 0)} / "
        f"{_fmt(ov['mttr_s']['p99'], 0)} s |",
        "",
        "## Rolling segments",
        "",
        "| segment | t (h) | faults | violation (min) | goodput |",
        "|---|---|---|---|---|",
    ]
    for r in rep["rolling"]:
        seg = r["segment"]
        out.append(
            f"| {r['segment_index']} | {r['t'] / 3600.0:.1f} "
            f"| {seg['n_faults']} "
            f"| {r['slo_segment']['violation_minutes']:.1f} "
            f"| {seg['goodput_frac']:.3f} |")
    out.append("")
    return "\n".join(out)


class FleetRun:
    """One continuous fleet kernel, steppable between rolling reports.

    ``run_fleet`` is the batch facade; tests and the snapshot/resume path
    drive the three-phase API directly:

        run = FleetRun(fspec); run.start()
        run.run_to(t)                      # any number of times
        report = run.finish()
    """

    def __init__(self, fspec: FleetSpec, device=None):
        self.fspec = fspec
        spec = fspec.scenario_spec()
        self.kernel = EventBus(seed=spec.seed)
        self.ctx = RunContext(spec, spec.fabric, self.kernel.rng, device=device)
        for svc in build_services(self.ctx):
            self.kernel.register(svc)
        self.fleet: FleetService = self.kernel.register(
            FleetService(self.ctx, fspec))

    def start(self) -> None:
        """Open the kernel at horizon 0 and admit the anchor job; the live
        processes arm themselves in ``FleetService.on_start``."""
        self.kernel.start(0.0)
        for js in self.ctx.spec.jobs:
            self.kernel.publish(JobAdmitted(js))

    def run_to(self, t: float) -> None:
        self.kernel.run_to(t)

    def finish(self) -> FleetReport:
        """Run to the configured horizon, stop the services, close the
        terminal segment, and assemble the report."""
        self.kernel.run_to(self.fspec.duration_s)
        self.kernel.stop()
        # after stop: C4DService (priority 20) has flushed still-active
        # faults, so the terminal segment can account for them
        self.fleet.finalize()
        return FleetReport(
            fleet=self.fspec.to_dict(),
            rolling=self.fleet.rolling,
            aggregates=self.fleet.aggregates(),
            slo=self.fleet.slo_report(),
            tenants=self.fleet.tenants_report(),
        )


def run_fleet(fspec: FleetSpec, workers: int = 1, device=None) -> FleetReport:
    """Run one continuous fleet end to end.

    ``workers`` is accepted for CLI symmetry with ``run_campaign`` and
    deliberately ignored: a continuous fleet is one causally-coupled
    kernel, so there is nothing embarrassingly parallel to shard — and the
    determinism contract (same seed -> bit-identical report for *any*
    worker count) is trivially satisfied by construction.  ``device``:
    where the torch backend runs (``None``: the card)."""
    del workers
    with use_backend(fspec.backend):
        run = FleetRun(fspec, device=device)
        run.start()
        return run.finish()


# ---------------------------------------------------------------------------
# Shipped fleets (mirrors ``montecarlo``'s campaign registry)
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, FleetSpec] = {}


def register(fspec: FleetSpec) -> FleetSpec:
    _REGISTRY[fspec.name] = fspec
    return fspec


def names() -> List[str]:
    return sorted(_REGISTRY)


def get(name: str, **overrides) -> FleetSpec:
    """Look up a shipped fleet; ``None`` overrides are dropped so CLI
    passthrough (``seed=args.seed`` etc.) keeps the spec's own default."""
    fspec = _REGISTRY[name]
    overrides = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(fspec, **overrides) if overrides else fspec


register(FleetSpec(
    name="fleet_hour",
    description="CI-sized continuous fleet: two simulated hours of live "
                "tenant churn, faults and flaps on a 16-host testbed with "
                "half-hourly rolling reports.",
    paper_ref="§5 fleet statistics (smoke horizon)",
    seed=20260808,
    duration_s=2 * 3600.0,
    gpus=64,
    ranks_per_node=4,
    n_hosts=16,
    tenant_arrivals_per_hour=2.0,
    tenant_lifetime_s=(600.0, 3600.0),
    faults_per_hour=2.0,
    link_flaps_per_hour=1.0,
    flap_outage_s=(120.0, 600.0),
    checkpoint_period_s=300.0,
    streaming_tick_s=60.0,
    report_period_s=1800.0,
))

register(FleetSpec(
    name="fleet_day",
    description="The acceptance fleet: one simulated day at 10,240 GPUs "
                "(1,280 nodes / 64 hosts) with Poisson tenant churn, the "
                "Table-1 fault mix and Fig. 11 leaf-spine flaps live, "
                "2-hourly rolling reports from one persistent C4P master.",
    paper_ref="§5 fleet statistics over a simulated day",
    seed=20260808,
    # fleet-scale streaming cadence: with backend="auto" the 10,240-rank
    # ingest routes to the torch backend on the card (above the 128-rank
    # crossover), so the fleet affords the 15-min cadence (96 windows/day)
    # the testbed-sized fleets run, instead of the 30-min cap the NumPy
    # ingest forced
    streaming_tick_s=900.0,
    backend="auto",
))

register(FleetSpec(
    name="fleet_month",
    description="The paper's billing horizon: thirty simulated days of "
                "continuous multi-tenant operation, daily rolling reports.",
    paper_ref="abstract / Table 3 (month of production jobs)",
    seed=20260808,
    duration_s=30 * 86400.0,
    tenant_arrivals_per_hour=0.5,
    faults_per_hour=0.25,
    link_flaps_per_hour=0.125,
    report_period_s=86400.0,
))
