"""FleetService: the continuous multi-tenant control plane (docs/fleet.md).

Where the Monte Carlo layer samples a *constant* tenant count per trial
(``montecarlo.sample_trial``) and replays a pre-drawn event script, this
service turns the runtime kernel into a forever-running fleet:

  * **live tenant process** — arrivals are a seeded Poisson process *on
    the event bus* (each due-event draws the next gap from the service's
    own RNG stream), lifetimes are uniform draws, and each arriving job
    is admitted and placed on the least-loaded hosts by the one
    persistent global C4P master (``FabricState.master``) — or rejected
    when the placement would exceed ``max_jobs_per_host``;
  * **live fault/flap processes** — the Table-1 comm mix, the optional
    divergence mix, and Fig. 11 leaf-spine flaps, each its own Poisson
    process, targeting the anchor job or (with ``tenant_fault_fraction``)
    a live tenant;
  * **per-tenant SLO accounting** — integrated piecewise on the virtual
    clock exactly like ``DowntimeService``'s goodput integral: between
    state-changing events a job's busbw is constant, so on every event the
    elapsed interval is classified as healthy or in violation (job down,
    or busbw below ``slo_goodput_floor_frac`` of its healthy baseline);
    MTTR-budget violations are scored per fault record at segment close;
  * **rolling reports** — every ``report_period_s`` tick closes a
    *segment*: the delta of every service counter since the previous
    boundary is folded through ``stats.trial_metrics`` into a trial-shaped
    record and fed to one ``stats.RollingAggregator``, so the cumulative
    aggregates mid-run and the final report share the batch code path.

Priority 5: after ``DowntimeService`` (0) has integrated goodput for the
interval ending at the current event, before ``FabricService`` (10)
mutates busbw for the next interval — the same piecewise-exact slot the
goodput integral occupies.

Zero-drift contract: the *segment* is the accounting primitive.  Every
cumulative SLO total is a running sum over closed segments, so folding
the per-segment values from the rolling reports (in order) reproduces
the final totals bit-exactly — the CI fleet-smoke job asserts drift is
literally ``0.0``.

Copy of ``repro.scenarios.services.fleet_service`` for the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from repro_torch.core.faults import sample_divergence_class, sample_error_class
from repro_torch.core.phases import HOURS
from repro_torch.runtime import Service
from repro_torch.scenarios.services.context import RunContext
from repro_torch.scenarios.services.events import JobAdmitted
from repro_torch.scenarios.spec import (FailLink, FleetSpec, InjectFault,
                                  RestoreLink, StartJob, StopJob)

# NOTE: repro_torch.scenarios.stats is imported lazily (in __init__ /
# _close_segment).  stats pulls repro_torch.core.downtime, which itself imports
# the scenarios package for the detection harness — a module-level import
# here would close that cycle and break ``import repro_torch.core.downtime``.

# the fleet service's private RNG stream: [seed, _FLEET_STREAM] — disjoint
# from the kernel stream (seed), telemetry (seed+1, seed+2) and every
# campaign trial stream ([seed, trial])
_FLEET_STREAM = 0x0F1EE7


@dataclass(frozen=True)
class ProcessDue:
    """Self-scheduling timer of one live fleet process: handling the event
    draws the process's next gap and schedules the next ``ProcessDue``."""
    t: float
    process: str          # "tenant" | "fault" | "divergence" | "flap"


class FleetService(Service):
    name = "fleet"
    priority = 5          # after downtime integration, before fabric mutation

    def __init__(self, ctx: RunContext, fspec: FleetSpec):
        self.ctx = ctx
        self.fspec = fspec
        self.tick_period_s = float(fspec.report_period_s)
        # tenant process bookkeeping
        self.jobs_slo: Dict[int, dict] = {}   # job_id -> SLO record (all jobs)
        self.arrived = 0
        self.departed = 0
        self.rejected = 0
        self.flaps = 0
        self.flaps_skipped = 0
        self.peak_concurrent = 0
        self._next_job_id = 0
        from repro_torch.scenarios.stats import RollingAggregator
        # rolling aggregation state
        self.rolling: List[dict] = []
        self._agg = RollingAggregator()
        self._seg_start_t = 0.0
        self._seg_index = 0
        self._slo_last_t = 0.0
        self._seg_slo = {"tenant_s": 0.0, "violation_s": 0.0,
                         "downtime_s": 0.0, "mttr_events": 0,
                         "mttr_violations": 0, "mttr_excess_s": 0.0}
        self._cum_slo = dict(self._seg_slo)
        # service-counter cursors/snapshots (delta per segment)
        self._fault_cursor = 0
        self._net_cursor = 0
        self._closed_cursor = 0
        self._restarts_snap = 0
        self._phases_snap = 0.0
        self._stream_snap = {"fault_free_windows": 0, "fp_windows": 0,
                             "suspect_windows": 0,
                             "false_suspect_windows": 0,
                             "suspect_replans": 0}
        self._progress_snap: Dict[int, float] = {}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def on_start(self, kernel) -> None:
        super().on_start(kernel)
        self.rng = np.random.default_rng([self.fspec.seed, _FLEET_STREAM])
        # arm every live process in a fixed order (determinism: the draw
        # sequence is part of the contract)
        self._arm("tenant", self.fspec.tenant_arrivals_per_hour)
        self._arm("fault", self.fspec.faults_per_hour)
        self._arm("divergence", self.fspec.divergence_faults_per_hour)
        self._arm("flap", self.fspec.link_flaps_per_hour)

    def on_event(self, event) -> None:
        now = self.kernel.clock.now
        self._integrate(now)
        if isinstance(event, ProcessDue):
            if event.process == "tenant":
                self._arrive(now)
            elif event.process == "fault":
                self._inject(now, divergence=False)
            elif event.process == "divergence":
                self._inject(now, divergence=True)
            elif event.process == "flap":
                self._flap(now)
            self._arm(event.process, self._rate_of(event.process))
        elif isinstance(event, JobAdmitted):
            self._register(event.jspec.job_id, tuple(event.jspec.hosts), now)
        elif isinstance(event, StartJob):
            self._register(event.job_id, tuple(event.hosts), now)
        elif isinstance(event, StopJob):
            rec = self.jobs_slo.get(event.job_id)
            if rec is not None and rec["departed_t"] is None:
                rec["departed_t"] = now
                self.departed += 1

    def on_tick(self, t: float) -> None:
        """Rolling-report boundary: bring every integral exactly to ``t``
        and close the segment.  Ticks at time t run after all events at t,
        so the boundary never splits a publish cascade."""
        down = self.kernel.service("downtime")
        down.integrate_to(t)
        self._integrate(t)
        self._close_segment(t)

    def on_stop(self) -> None:
        # the clock is at the horizon; DowntimeService (priority 0) has
        # already integrated goodput up to it
        self._integrate(self.kernel.clock.now)

    def finalize(self) -> None:
        """Close the terminal segment.  Called by ``FleetRun`` *after*
        ``kernel.stop()`` — ``C4DService.on_stop`` (priority 20, after this
        service) flushes still-active faults into its closed list, and the
        terminal segment must account for them."""
        t = self.kernel.clock.now
        down = self.kernel.service("downtime")
        c4d = self.kernel.service("c4d")
        residuals = (self._fault_cursor < len(down.fault_records)
                     or self._closed_cursor < len(c4d.closed)
                     or self._net_cursor < len(c4d.network_records))
        if t > self._seg_start_t or residuals:
            self._close_segment(t)

    # ------------------------------------------------------------------
    # live processes
    # ------------------------------------------------------------------
    def _rate_of(self, process: str) -> float:
        return {"tenant": self.fspec.tenant_arrivals_per_hour,
                "fault": self.fspec.faults_per_hour,
                "divergence": self.fspec.divergence_faults_per_hour,
                "flap": self.fspec.link_flaps_per_hour}[process]

    def _arm(self, process: str, rate_per_hour: float) -> None:
        """Draw the next exponential gap and schedule the due-event; a due
        time past the horizon stays queued and simply never fires."""
        if rate_per_hour <= 0:
            return
        gap = float(self.rng.exponential(HOURS / rate_per_hour))
        t = self.kernel.clock.now + gap
        self.kernel.schedule(t, ProcessDue(t=t, process=process))

    def _live_tenants(self) -> List[int]:
        return [jid for jid, rec in self.jobs_slo.items()
                if rec["departed_t"] is None and jid != 0]

    def _arrive(self, t: float) -> None:
        """One tenant arrival: size + lifetime draws, then least-loaded
        placement over the persistent C4P master's admission view
        (``fabric.job_hosts``) with a per-host job ceiling."""
        fspec = self.fspec
        rng = self.rng
        k = int(rng.choice(np.asarray(fspec.tenant_hosts_choices)))
        lifetime = float(rng.uniform(*fspec.tenant_lifetime_s))
        load = {h: 0 for h in range(fspec.n_hosts)}
        for hosts in self.ctx.fabric.job_hosts.values():
            for h in hosts:
                load[h] += 1
        order = sorted(load, key=lambda h: (load[h], h))
        hosts = tuple(order[:k])
        if any(load[h] >= fspec.max_jobs_per_host for h in hosts):
            self.rejected += 1
            return
        self._next_job_id += 1
        jid = self._next_job_id
        self.arrived += 1
        # external vocabulary: downtime creates the run, the fabric admits
        # it through the persistent C4P master, and this service registers
        # the SLO record when the StartJob comes back around
        self.kernel.publish(StartJob(t=t, job_id=jid, hosts=hosts))
        self.kernel.schedule(t + lifetime,
                             StopJob(t=t + lifetime, job_id=jid))

    def _inject(self, t: float, divergence: bool) -> None:
        rng = self.rng
        tenants = self._live_tenants()
        job_id = 0
        if tenants and float(rng.random()) < self.fspec.tenant_fault_fraction:
            job_id = tenants[int(rng.integers(0, len(tenants)))]
        cls = (sample_divergence_class(rng) if divergence
               else sample_error_class(rng))
        rank = int(rng.integers(0, self.fspec.gpus))
        self.kernel.publish(InjectFault(t=t, job_id=job_id,
                                        error_class=cls.name, rank=rank))

    def _flap(self, t: float) -> None:
        rng = self.rng
        topo = self.ctx.fabric.topo
        link = ("ls", int(rng.integers(0, topo.n_leaves)),
                int(rng.integers(0, topo.n_spines)))
        outage = float(rng.uniform(*self.fspec.flap_outage_s))
        if link in topo.down_links:
            self.flaps_skipped += 1       # already mid-outage: draw consumed
            return
        self.flaps += 1
        self.kernel.publish(FailLink(t=t, link=link))
        self.kernel.schedule(t + outage,
                             RestoreLink(t=t + outage, link=link))

    # ------------------------------------------------------------------
    # per-tenant SLO accounting (piecewise on the virtual clock)
    # ------------------------------------------------------------------
    def _register(self, job_id: int, hosts: tuple, t: float) -> None:
        if job_id in self.jobs_slo:
            return
        self.jobs_slo[job_id] = {
            "job_id": job_id, "hosts": list(hosts),
            "arrived_t": t, "departed_t": None,
            "active_s": 0.0, "violation_s": 0.0, "downtime_s": 0.0,
            "mttr_events": 0, "mttr_violations": 0, "mttr_excess_s": 0.0,
        }
        live = sum(1 for r in self.jobs_slo.values()
                   if r["departed_t"] is None)
        self.peak_concurrent = max(self.peak_concurrent, live)

    def _integrate(self, to_t: float) -> None:
        """Classify the interval since the last event for every live job:
        healthy, goodput-floor violation, or downtime.  Runs before this
        service reacts to anything (and before FabricService mutates
        busbw), so each interval is scored against the state that actually
        held during it."""
        dt = to_t - self._slo_last_t
        if dt <= 0.0:
            return
        floor = self.fspec.slo_goodput_floor_frac
        seg = self._seg_slo
        for jid, rec in self.jobs_slo.items():
            if rec["departed_t"] is not None:
                continue
            run = self.ctx.jobs.get(jid)
            if run is None:
                # the StopJob delivering right now popped the run (downtime
                # runs first); score its final interval from the finished
                # record so no tenant-second is lost
                run = next((r for r in reversed(self.ctx.finished)
                            if r.spec.job_id == jid), None)
            if run is None:
                continue
            rec["active_s"] += dt
            seg["tenant_s"] += dt
            if not run.up:
                rec["downtime_s"] += dt
                rec["violation_s"] += dt
                seg["downtime_s"] += dt
                seg["violation_s"] += dt
            elif (run.healthy_busbw > 0.0
                  and run.busbw < floor * run.healthy_busbw):
                rec["violation_s"] += dt
                seg["violation_s"] += dt
        self._slo_last_t = to_t

    # ------------------------------------------------------------------
    # rolling segments
    # ------------------------------------------------------------------
    def _stream_counters(self, c4d) -> dict:
        return {"fault_free_windows": c4d.fault_free_windows,
                "fp_windows": c4d.fp_windows,
                "suspect_windows": c4d.suspect_windows,
                "false_suspect_windows": c4d.false_suspect_windows,
                "suspect_replans": self.ctx.suspect_replans}

    def _close_segment(self, t: float) -> None:
        """Fold everything since the previous boundary into one
        trial-shaped record (via ``stats.trial_metrics`` — the same code
        path batch campaigns use), add it to the rolling aggregator, score
        MTTR budgets, and append the rolling report entry."""
        from repro_torch.scenarios.stats import trial_metrics
        fspec = self.fspec
        down = self.kernel.service("downtime")
        c4d = self.kernel.service("c4d")
        seg_dt = t - self._seg_start_t

        frs = down.fault_records[self._fault_cursor:]
        self._fault_cursor = len(down.fault_records)
        net = c4d.network_records[self._net_cursor:]
        self._net_cursor = len(c4d.network_records)
        closed = [af.record() for af in c4d.closed[self._closed_cursor:]]
        self._closed_cursor = len(c4d.closed)
        restarts = down.restarts - self._restarts_snap
        self._restarts_snap = down.restarts
        phase_total = float(sum(down.phases.values()))
        phases_delta = phase_total - self._phases_snap
        self._phases_snap = phase_total
        stream_now = self._stream_counters(c4d)
        stream_delta = {k: stream_now[k] - self._stream_snap[k]
                        for k in stream_now}
        self._stream_snap = stream_now

        # focus-job goodput over the segment: progress delta vs the ideal
        # at the healthy baseline (DowntimeService integrated to exactly t)
        progress = ideal = active = 0.0
        for run in self.ctx.focus_runs():
            prev = self._progress_snap.get(run.spec.job_id, 0.0)
            progress += run.progress_gb - prev
            self._progress_snap[run.spec.job_id] = run.progress_gb
            ideal += run.healthy_busbw * seg_dt
            active += seg_dt

        lat = [r["latency_s"] for r in closed if r["latency_s"] is not None]
        missed = sum(1 for r in closed if r["detected_t"] is None)
        pseudo = {
            "scenario": f"{fspec.name}_seg{self._seg_index:04d}",
            "seed": fspec.seed,
            "fabric": fspec.fabric,
            "duration_s": seg_dt,
            "restarts": restarts,
            "detection": {
                "n_faults": len(frs),
                "faults": frs,
                "attribution_attempts":
                    sum(1 for f in frs if f.get("culprit_hit") is not None),
                "attribution_hits":
                    sum(1 for f in frs if f.get("culprit_hit")),
            },
            "network": {"n_events": len(net), "detections": net},
            "streaming": {
                "latencies_s": lat,
                "detected": len(lat),
                "missed": missed,
                "fault_free_windows": stream_delta["fault_free_windows"],
                "false_positive_windows": stream_delta["fp_windows"],
                "suspect_windows": stream_delta["suspect_windows"],
                "false_suspect_windows":
                    stream_delta["false_suspect_windows"],
                "suspect_replans": stream_delta["suspect_replans"],
            },
            "downtime": {"fraction_of_duration":
                         phases_delta / active if active else 0.0},
            "goodput": {"fraction": progress / ideal if ideal else 0.0},
        }
        segment = trial_metrics(pseudo)
        self._agg.add(segment)

        # MTTR budget per fault record of the segment
        seg = self._seg_slo
        for f in frs:
            mttr = float(sum(f["phases"].values()))
            rec = self.jobs_slo.get(f["job_id"])
            seg["mttr_events"] += 1
            if rec is not None:
                rec["mttr_events"] += 1
            if mttr > fspec.slo_mttr_budget_s:
                excess = mttr - fspec.slo_mttr_budget_s
                seg["mttr_violations"] += 1
                seg["mttr_excess_s"] += excess
                if rec is not None:
                    rec["mttr_violations"] += 1
                    rec["mttr_excess_s"] += excess

        # cumulative totals are running sums over closed segments — the
        # zero-drift primitive the fleet-smoke CI job asserts against
        for k, v in seg.items():
            self._cum_slo[k] += v
        slo_segment = {**seg,
                       "violation_minutes": seg["violation_s"] / 60.0}
        self.rolling.append({
            "t": t,
            "segment_index": self._seg_index,
            "segment": segment,
            "slo_segment": slo_segment,
            "slo": self.slo_totals(),
            "aggregates": self._agg.result(),
        })
        self._seg_index += 1
        self._seg_start_t = t
        self._seg_slo = {k: 0 if isinstance(v, int) else 0.0
                         for k, v in seg.items()}

    # ------------------------------------------------------------------
    # report fragments
    # ------------------------------------------------------------------
    def slo_totals(self) -> dict:
        c = self._cum_slo
        return {
            "goodput_floor_frac": self.fspec.slo_goodput_floor_frac,
            "mttr_budget_s": self.fspec.slo_mttr_budget_s,
            **c,
            "violation_minutes": c["violation_s"] / 60.0,
            "violation_frac":
                c["violation_s"] / c["tenant_s"] if c["tenant_s"] else 0.0,
        }

    def slo_report(self) -> dict:
        return {**self.slo_totals(),
                "per_tenant": [self.jobs_slo[j]
                               for j in sorted(self.jobs_slo)]}

    def tenants_report(self) -> dict:
        return {"arrived": self.arrived, "departed": self.departed,
                "rejected": self.rejected,
                "peak_concurrent": self.peak_concurrent,
                "flaps": self.flaps, "flaps_skipped": self.flaps_skipped}

    def aggregates(self) -> dict:
        return self._agg.result()
