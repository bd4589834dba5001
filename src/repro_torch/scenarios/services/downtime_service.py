"""DowntimeService: the single Table-3 phase/goodput observer.

The checkpoint-restart accounting that used to be duplicated between
``core/downtime.py`` and the campaign engine now lives in one service keyed
off the shared ``core.phases`` constants: it integrates goodput
(``busbw x dt`` with Gemini-style periodic checkpoints) between
state-changing events, reacts to ``FaultDetected`` verdicts with the
paper's four-phase downtime cycle (detection / diagnosis&isolation /
post-checkpoint lost work / re-initialisation), and schedules the
``RestartComplete`` that brings the job back from its checkpoint.

Goodput integration is *piecewise between events*, never on ticks: busbw
is constant between state changes, so deferring the integral to the next
event is exact — and keeps every historical report bit-identical no matter
how many observation ticks other services add to the clock.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.faults import fault_family
from repro_torch.core.phases import HOURS, zero_phases
from repro_torch.runtime import Service
from repro_torch.scenarios.services.context import JobRun, RunContext
from repro_torch.scenarios.services.events import (FaultDetected, JobAdmitted,
                                             JobResumed, RestartComplete,
                                             admitted_spec)
from repro_torch.scenarios.spec import InjectFault, JobSpec, StartJob, StopJob


class DowntimeService(Service):
    name = "downtime"
    priority = 0          # integrates time before anyone reacts to an event

    def __init__(self, ctx: RunContext):
        self.ctx = ctx
        self.phases = zero_phases()
        self.fault_records = []
        self.restarts = 0
        self.last_t = 0.0

    # ------------------------------------------------------------------
    def on_event(self, event) -> None:
        self._integrate(self.kernel.clock.now)
        if isinstance(event, JobAdmitted):
            self._create_run(event.jspec)
        elif isinstance(event, StartJob):
            self._create_run(admitted_spec(event))
        elif isinstance(event, StopJob):
            self._end_run(event.job_id)
        elif isinstance(event, InjectFault):
            run = self.ctx.jobs.get(event.job_id)
            if run is not None and not run.up:
                # fault during restart: manifests when the job is back
                run.pending.append(event)
        elif isinstance(event, FaultDetected):
            self._account(event)
        elif isinstance(event, RestartComplete):
            self._resume(event.job_id)

    def on_stop(self) -> None:
        self._integrate(self.kernel.clock.now)       # horizon

    def integrate_to(self, to_t: float) -> None:
        """Public piecewise-integration hook for observers that need exact
        progress at a non-event instant.  The fleet's rolling-report tick
        calls this so segment goodput is measured *at* the boundary;
        splitting an interval is deterministic, and the batch engine never
        calls it — historical reports stay bit-identical."""
        self._integrate(to_t)

    # ------------------------------------------------------------------
    # goodput integral (piecewise between events; exact, tick-free)
    # ------------------------------------------------------------------
    def _integrate(self, to_t: float) -> None:
        period = self.ctx.spec.checkpoint_period_s
        for run in self.ctx.jobs.values():
            t0 = self.last_t
            if not run.up:
                continue
            cur = t0
            while run.last_ckpt_t + period <= to_t:
                c = run.last_ckpt_t + period
                run.progress_gb += run.busbw * (c - cur)
                run.ckpt_progress_gb = run.progress_gb
                run.last_ckpt_t = c
                cur = c
            run.progress_gb += run.busbw * (to_t - cur)
        self.last_t = to_t

    # ------------------------------------------------------------------
    # job lifecycle
    # ------------------------------------------------------------------
    def _create_run(self, jspec: JobSpec) -> None:
        t = self.kernel.clock.now
        self.ctx.jobs[jspec.job_id] = JobRun(jspec, start_t=t, last_ckpt_t=t)

    def _end_run(self, job_id: int) -> None:
        run = self.ctx.jobs.pop(job_id, None)
        if run is None:
            return
        run.end_t = self.kernel.clock.now
        self.ctx.finished.append(run)

    def _resume(self, job_id: int) -> None:
        run = self.ctx.jobs.get(job_id)
        if run is None:
            return
        run.up = True
        run.last_ckpt_t = self.kernel.clock.now  # restored == fresh ckpt
        run.ckpt_progress_gb = run.progress_gb
        run.isolating_until = 0.0
        self.kernel.publish(JobResumed(job_id))
        pending, run.pending = run.pending, []
        for ev in pending:
            self.kernel.publish(ev)

    # ------------------------------------------------------------------
    # Table-3 cycle per detected fault
    # ------------------------------------------------------------------
    def _account(self, fd: FaultDetected) -> None:
        ctx = self.ctx
        spec = ctx.spec
        run = ctx.jobs.get(fd.event.job_id)
        if run is None:
            return
        t = self.kernel.clock.now
        out = fd.outcome
        det_s = out.detection_s
        if out.localized:
            node = out.node % spec.n_nodes
            if out.culprit_ranks:
                # attribution on: isolate the *attributed* culprit's host
                # rather than the ring-level node (they agree whenever the
                # attribution hit, which the drills assert at >= 90%)
                node = (out.culprit_ranks[0]
                        // spec.ranks_per_node) % spec.n_nodes
            _, steer_s = ctx.steering.execute(node, t=t, reason=fd.fault.kind)
            diag_s = steer_s + float(ctx.rng.uniform(2 * 60, 8 * 60))
        else:
            diag_s = float(np.clip(
                ctx.rng.lognormal(np.log(spec.assisted_diag_median_s), 0.6),
                5 * 60, 4 * HOURS))
        post_ckpt_s = t - run.last_ckpt_t
        reinit_s = spec.reinit_s

        self.phases["detection_s"] += det_s
        self.phases["diagnosis_isolation_s"] += diag_s
        self.phases["post_checkpoint_s"] += post_ckpt_s
        self.phases["re_initialization_s"] += reinit_s

        run.progress_gb = run.ckpt_progress_gb       # lost work rolls back
        run.up = False
        run.isolating_until = t + det_s + diag_s
        down_until = t + det_s + diag_s + reinit_s
        self.kernel.schedule(down_until, RestartComplete(fd.event.job_id))
        self.restarts += 1
        fault = fd.fault
        ev = fd.event
        self.fault_records.append({
            "t": t, "job_id": ev.job_id,
            "error_class": ev.error_class, "kind": fault.kind,
            "family": fault_family(fault.kind),
            "rank": fault.rank if fault.rank is not None else list(fault.link or ()),
            "acted": out.acted, "localized": out.localized,
            "windows": out.windows, "detection_s": det_s,
            "syndromes": list(out.syndromes),
            "culprit_ranks": list(out.culprit_ranks),
            "culprit_hit": out.culprit_hit,
            "expected_node": fd.expected_node,
            "phases": {"detection_s": det_s, "diagnosis_isolation_s": diag_s,
                       "post_checkpoint_s": post_ckpt_s,
                       "re_initialization_s": reinit_s},
            "resume_t": down_until,
        })

    # ------------------------------------------------------------------
    # report fragments (same math/layout as the historical engine)
    # ------------------------------------------------------------------
    def accounting_report(self) -> dict:
        """The ``downtime`` + ``goodput`` report blocks."""
        spec = self.ctx.spec
        runs = list(self.ctx.jobs.values()) + self.ctx.finished
        focus = [r for r in runs if r.spec.focus]
        per_job = {}
        progress = ideal = active = 0.0
        for r in focus:
            end = r.end_t if r.end_t is not None else spec.duration_s
            span = max(end - r.start_t, 1e-9)
            job_ideal = r.healthy_busbw * span
            per_job[str(r.spec.job_id)] = {
                "healthy_busbw_gbps": r.healthy_busbw,
                "final_busbw_gbps": r.busbw,
                "progress_gb": r.progress_gb,
                "ideal_gb": job_ideal,
                "goodput_frac": r.progress_gb / job_ideal if job_ideal else 0.0,
            }
            progress += r.progress_gb
            ideal += job_ideal
            active += span
        total_down = sum(self.phases.values())
        downtime = {
            **{k: float(v) for k, v in self.phases.items()},
            "total_s": float(total_down),
            "fraction_of_duration":
                float(total_down / active) if active else 0.0,
        }
        goodput = {
            "per_job": per_job,
            "effective_gbps": float(progress / active) if active else 0.0,
            "ideal_gbps": float(ideal / active) if active else 0.0,
            "fraction": float(progress / ideal) if ideal else 0.0,
        }
        return {"downtime": downtime, "goodput": goodput}
