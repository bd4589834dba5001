"""FabricService: the live fabric as a service on the runtime kernel.

Owns ``scenarios.fabric.FabricState`` (C4P control plane or ECMP baseline)
and reacts to job churn and link health events.  Re-planning is triggered
through the probing layer — every flap runs a ``PathProber`` full-mesh
sweep whose report marks links down/up in the ``LinkHealthMonitor``
(paper §3.2) — and every re-evaluation publishes ``BusbwChanged`` so
observers (goodput accounting, future autoscalers) see fresh per-job
bandwidth without polling.

On a link failure it also publishes the *transient* rate state (before the
control plane reacts) as ``FabricTransient`` — the signal the streaming
and per-fault detectors observe through the netsim->telemetry bridge.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.runtime import Service
from repro_torch.scenarios.services.context import RunContext
from repro_torch.scenarios.services.events import (BusbwChanged, FabricTransient,
                                             JobAdmitted, LinkObserved,
                                             NodeCleared, NodeSuspected,
                                             admitted_spec)
from repro_torch.scenarios.spec import (FailLink, JobSpec, RestoreLink, StartJob,
                                  StopJob)


class FabricService(Service):
    name = "fabric"
    priority = 10

    def __init__(self, ctx: RunContext):
        self.ctx = ctx

    # ------------------------------------------------------------------
    def on_event(self, event) -> None:
        if isinstance(event, JobAdmitted):
            self._admit(event.jspec)
        elif isinstance(event, StartJob):
            self._admit(admitted_spec(event))
        elif isinstance(event, StopJob):
            self._remove(event.job_id)
        elif isinstance(event, FailLink):
            self._on_fail(event)
        elif isinstance(event, RestoreLink):
            self._on_restore(event)
        elif isinstance(event, LinkObserved) and event.acted:
            # C4D verdict -> C4P link blacklist (the detect->avoid
            # composition; a no-op under ECMP)
            self.ctx.fabric.blacklist_link(event.link)
        elif isinstance(event, NodeSuspected):
            self._deprioritize(event.node)
        elif isinstance(event, NodeCleared):
            self._reprioritize(event.node)

    # ---- job churn ---------------------------------------------------
    def _admit(self, jspec: JobSpec) -> None:
        ctx = self.ctx
        ctx.fabric.add_job(jspec.job_id, list(jspec.hosts))
        run = ctx.jobs[jspec.job_id]          # created by DowntimeService
        n_hosts = max(len(jspec.hosts), 1)
        step = max(ctx.spec.telemetry_ranks // n_hosts, 1)
        run.host_to_rank = {h: i * step for i, h in enumerate(jspec.hosts)}
        self.reevaluate(first_for=jspec.job_id)

    def _remove(self, job_id: int) -> None:
        if job_id not in self.ctx.fabric.job_hosts:
            return                        # StopJob for a job never admitted
        self.ctx.fabric.remove_job(job_id)
        self.reevaluate()

    # ---- link health -------------------------------------------------
    def _on_fail(self, ev: FailLink) -> None:
        ctx = self.ctx
        ctx.fabric.fail_link(ev.link)
        ctx.fabric.probe_refresh()            # mark-down via probe report
        # transient state, before the control plane reacts: dead QPs stall
        # their connections — what the enhanced CCL sees during the first
        # monitoring window(s)
        if ctx.mode == "c4p":
            transient = ctx.fabric.evaluate(dynamic_lb=False,
                                            static_failover=False,
                                            seed=ctx.spec.seed)
        else:
            transient = ctx.fabric.evaluate(seed=ctx.spec.seed)
        self.kernel.publish(FabricTransient(tuple(ev.link), transient))
        # steady state after C4P re-planning (ECMP: rates stay degraded)
        self.reevaluate()

    def _on_restore(self, ev: RestoreLink) -> None:
        self.ctx.fabric.restore_link(ev.link)
        self.ctx.fabric.probe_refresh()       # mark-up via probe report
        self.reevaluate()

    # ---- graceful degradation (precision pipeline) -------------------
    def _host_of_node(self, node: int) -> Optional[int]:
        """Map a streaming telemetry node back to the testbed host that
        carries its ranks (inverse of ``_admit``'s host_to_rank layout)."""
        ctx = self.ctx
        lead_rank = node * ctx.spec.ranks_per_node
        for run in ctx.focus_runs():
            if not run.host_to_rank:
                continue
            step = max(ctx.spec.telemetry_ranks // len(run.host_to_rank), 1)
            for h, r0 in run.host_to_rank.items():
                if r0 <= lead_rank < r0 + step:
                    return h
        return None

    def _deprioritize(self, node: int) -> None:
        """A suspect node is steered around, not restarted: probe sweep +
        immediate re-plan.  A genuinely degrading NIC gets marked down by
        the probe report and traffic moves off it; for a false positive the
        re-plan is a no-op on rates — the whole cost of the false alarm."""
        host = self._host_of_node(node)
        if host is None or not self.ctx.fabric.deprioritize_host(host):
            return
        self.ctx.fabric.probe_refresh()
        self.reevaluate()
        self.ctx.suspect_replans += 1

    def _reprioritize(self, node: int) -> None:
        host = self._host_of_node(node)
        if host is None or not self.ctx.fabric.reprioritize_host(host):
            return
        self.ctx.fabric.probe_refresh()       # mark-up pass before re-plan
        self.reevaluate()
        self.ctx.suspect_replans += 1

    # ---- evaluation --------------------------------------------------
    def reevaluate(self, first_for: Optional[int] = None) -> None:
        """Refresh every job's busbw from the live fabric; on a job's first
        evaluation, snapshot its healthy baseline (the reference the
        telemetry bridge and goodput ideal are measured against)."""
        ctx = self.ctx
        if not ctx.jobs:
            return
        res = ctx.fabric.evaluate(seed=ctx.spec.seed)
        for j, run in ctx.jobs.items():
            run.busbw = ctx.fabric.job_busbw(res, j)
            if j == first_for or not run.baseline_conn:
                run.healthy_busbw = run.busbw
                run.baseline_conn = {k: v for k, v in res.conn_rate.items()
                                     if k[0] == j}
        ctx.last_result = res
        self.kernel.publish(BusbwChanged(
            {j: r.busbw for j, r in ctx.jobs.items()}, first_for=first_for))
