"""C4DService: detection as an always-on service (paper §3.1, Figs. 3-6).

Two detection paths run side by side:

**Per-fault reference** — for every ``InjectFault`` the service runs the
same ``DetectionHarness`` pipeline the Table-3 month simulation uses
(telemetry synthesis -> C4a agents -> fresh C4D master) and publishes the
verdict as ``FaultDetected`` for the downtime accountant.  This path is
bit-compatible with the historical engine: RNG draw order, harness
telemetry stream, and record layout are unchanged.

**Always-on streaming** — a persistent ``C4DMaster`` fed one telemetry
window per kernel tick (its own ``RingJobTelemetry`` stream, so the
reference path's reproducibility is untouched).  The master inherits
``spec.backend`` and the run's ``device``: the port's default backend is
``torch``, so every window goes through the detection kernels on the card
(``core/torchsim``), while ``backend="auto"`` keeps testbed-sized jobs on
NumPy.  The window synthesised at
tick *t* carries the signatures of every fault active at *t*: injected
node faults (visible from onset until the isolation completes and the node
is swapped), the transient stall right after a link flap, and any steady
fabric degradation the netsim->telemetry bridge still sees.  Because the
master streak state persists across windows, two quantities the per-fault
harness structurally cannot produce are *measured on the clock*:

  * online detection latency — action time minus fault onset, including
    the onset-to-window-boundary phase the batch path never sees;
  * fault-free false-positive rate — the fraction of healthy windows in
    which the master acted (CCL-D / Mycroft evaluate always-on monitors
    exactly this way).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.c4d.attribution import AttributionConfig
from repro_torch.core.c4d.divergence import DivergenceDetector
from repro_torch.core.c4d.master import (ACTION_DEPRIORITIZE, ACTION_ISOLATE,
                                   ACTION_REPRIORITIZE, C4DMaster)
from repro_torch.core.faults import (DIVERGENCE_KINDS, DIVERGENCE_TABLE, TABLE1,
                               Fault, RingJobTelemetry, fault_family,
                               fault_for_class)
from repro_torch.runtime import Service
from repro_torch.scenarios.services.context import RunContext
from repro_torch.scenarios.services.events import (FabricTransient, FaultDetected,
                                             JobResumed, LinkObserved,
                                             NodeCleared, NodeSuspected)
from repro_torch.scenarios.spec import InjectFault, StopJob

ERROR_CLASSES = {c.name: c for c in TABLE1 + DIVERGENCE_TABLE}
_DEFAULT_SEVERITY = {"slow_src": 8.0, "slow_dst": 8.0, "slow_link": 8.0,
                     "straggler": 20.0,
                     "sdc": 4.0, "loss_spike": 10.0, "nan_rank": 2.0}


@dataclass
class ActiveFault:
    """One injected node fault the streaming detector should observe."""
    job_id: int
    fault: Fault
    expected_node: int
    onset_t: float
    kind: str
    error_class: Optional[str]
    detected_t: Optional[float] = None
    suspected_t: Optional[float] = None      # precision pipeline only
    family: str = "comm"                     # detector vertical

    def record(self) -> dict:
        det = self.detected_t
        return {"job_id": self.job_id, "kind": self.kind,
                "error_class": self.error_class,
                "family": self.family,
                "rank": self.fault.rank if self.fault.rank is not None
                else list(self.fault.link or ()),
                "expected_node": self.expected_node,
                "onset_t": self.onset_t, "detected_t": det,
                "suspected_t": self.suspected_t,
                "latency_s": None if det is None else det - self.onset_t}


class C4DService(Service):
    name = "c4d"
    priority = 20

    def __init__(self, ctx: RunContext):
        self.ctx = ctx
        spec = ctx.spec
        self.network_records: List[dict] = []
        # ---- streaming state (own telemetry stream + persistent master)
        self.tick_period_s = float(spec.streaming_tick_s)
        self.operating_point = spec.operating_point
        if self.tick_period_s > 0:
            self.stream_tel = RingJobTelemetry(n_ranks=spec.telemetry_ranks,
                                               seed=spec.seed + 2)
            if self.operating_point is not None:
                self.stream_master = C4DMaster.from_operating_point(
                    self.operating_point, n_ranks=spec.telemetry_ranks,
                    ranks_per_node=spec.ranks_per_node,
                    backend=spec.backend, device=ctx.device)
            else:
                self.stream_master = C4DMaster(
                    n_ranks=spec.telemetry_ranks,
                    ranks_per_node=spec.ranks_per_node,
                    backend=spec.backend, device=ctx.device)
            # opt-in verticals on the persistent master; False leaves the
            # pinned streaming traces untouched
            if spec.divergence:
                self.stream_master.divergence = DivergenceDetector()
            if spec.attribution:
                self.stream_master.attribution = AttributionConfig()
        self.active: List[ActiveFault] = []
        self.closed: List[ActiveFault] = []
        self.pending_transients: List[Fault] = []
        self.windows = 0
        self.fault_windows = 0
        self.fault_free_windows = 0
        self.down_windows = 0
        self.fp_windows = 0
        self.link_windows = 0        # windows with a matching link verdict
        # precision pipeline (suspect stage) bookkeeping
        self.suspect_windows = 0
        self.false_suspect_windows = 0

    # ------------------------------------------------------------------
    # per-fault reference path (bit-compatible with the legacy engine)
    # ------------------------------------------------------------------
    def on_event(self, event) -> None:
        if isinstance(event, InjectFault):
            self._handle_fault(event)
        elif isinstance(event, FabricTransient):
            self._transient_sweep(event)
        elif isinstance(event, JobResumed):
            self._close_job(event.job_id)
        elif isinstance(event, StopJob):
            # a job leaving mid-incident takes its signatures with it;
            # undetected faults count as streaming misses
            self._close_job(event.job_id)

    def _telemetry_fault(self, ev: InjectFault):
        """Instantiate the enhanced-CCL signature for an InjectFault event.
        Returns (fault, expected_node) with ground truth for localisation."""
        ctx = self.ctx
        n = ctx.telemetry.n
        rank = ev.rank if ev.rank is not None else int(ctx.rng.integers(0, n))
        if ev.error_class is not None:
            cls = ERROR_CLASSES[ev.error_class]
            fault = fault_for_class(cls, rank, n, ctx.rng)
        else:
            kind = ev.kind or "crash"
            sev = ev.severity if ev.severity is not None \
                else _DEFAULT_SEVERITY.get(kind, 8.0)
            if kind == "slow_link":
                fault = Fault(kind, link=(rank, (rank + 1) % n), severity=sev)
            else:
                fault = Fault(kind, rank=rank, severity=sev)
        return fault, rank // ctx.spec.ranks_per_node

    def _handle_fault(self, ev: InjectFault) -> None:
        ctx = self.ctx
        run = ctx.jobs.get(ev.job_id)
        if run is None or not run.up:
            return           # unknown job, or queued by DowntimeService
        spec = ctx.spec
        fault, expected_node = self._telemetry_fault(ev)
        extra, _ = ctx.bridge_for(run)        # live fabric context, if any
        # ground-truth culprit rank for attribution scoring: a link fault's
        # root cause sits at the source endpoint (the drawn victim rank)
        expected_rank = (fault.rank if fault.rank is not None
                         else (fault.link[0] if fault.link else None))
        out = ctx.harness.detect_faults([fault] + extra,
                                        expected_node=expected_node,
                                        expected_rank=expected_rank)
        if (out.acted and spec.apply_localization_ceiling
                and ev.error_class is not None
                and ctx.rng.random() > ERROR_CLASSES[ev.error_class].localization_rate):
            out.localized = False
        self.kernel.publish(FaultDetected(ev, fault, out, expected_node))
        if self.tick_period_s > 0:
            self.active.append(ActiveFault(
                ev.job_id, fault, expected_node,
                onset_t=self.kernel.clock.now, kind=fault.kind,
                error_class=ev.error_class,
                family=fault_family(fault.kind)))

    def _transient_sweep(self, tr: FabricTransient) -> None:
        """Run the reference pipeline over the bridge for every focus job,
        so the report records whether the degradation was *observed*
        (network faults are healed by C4P re-routing / blacklist, not by
        node isolation — paper §3.2)."""
        ctx = self.ctx
        for run in ctx.jobs.values():
            if not run.spec.focus or not run.up:
                continue
            faults, truth = ctx.bridge_for(run, tr.result)
            if not faults:
                continue
            out = ctx.harness.detect_faults(faults)
            hit = bool(set(out.links) & set(truth)) if out.acted else False
            self.kernel.publish(LinkObserved(tr.link, run.spec.job_id,
                                             out.acted, hit))
            self.network_records.append({
                "t": self.kernel.clock.now, "job_id": run.spec.job_id,
                "event": "FailLink", "link": list(tr.link),
                "observed": out.acted, "edge_hit": hit,
                "detection_s": out.detection_s, "windows": out.windows,
                "syndromes": list(out.syndromes),
                "transient_busbw_gbps":
                    ctx.fabric.job_busbw(tr.result, run.spec.job_id),
            })
            if self.tick_period_s > 0:
                # the stall is visible to the streaming detector for the
                # first monitoring window after the flap (C4P re-plans
                # within the event; ECMP's lasting degradation keeps
                # flowing through the steady-state bridge each tick)
                self.pending_transients.extend(faults)

    def _close_job(self, job_id: int) -> None:
        """Job resumed from checkpoint: its pre-restart faults are gone
        (node swapped); undetected ones count as streaming misses."""
        keep, gone = [], []
        for af in self.active:
            (gone if af.job_id == job_id else keep).append(af)
        self.active = keep
        self.closed.extend(gone)

    # ------------------------------------------------------------------
    # always-on streaming path
    # ------------------------------------------------------------------
    def _visible(self, run) -> bool:
        """Telemetry flows while the job runs — including the stalled
        detection/diagnosis span — and stops once isolation executes and
        the job re-initialises from its checkpoint."""
        return run.up or self.kernel.clock.now <= run.isolating_until

    def on_tick(self, t: float) -> None:
        ctx = self.ctx
        focus = ctx.focus_runs()
        self.windows += 1
        if focus and not any(self._visible(r) for r in focus):
            self.down_windows += 1       # mid-restart: no telemetry at all
            self.pending_transients = []
            return
        active_runs = ((af, ctx.jobs.get(af.job_id)) for af in self.active)
        faults: List[Fault] = [af.fault for af, run in active_runs
                               if run is not None and self._visible(run)]
        faults += self.pending_transients
        self.pending_transients = []
        if ctx.last_result is not None:  # steady fabric degradation, if any
            for run in focus:
                if not run.up:
                    continue
                bf, _ = ctx.bridge_for(run)
                faults += bf
        win = self.stream_tel.window_arrays(window_id=self.windows,
                                            faults=faults)
        if self.ctx.spec.divergence:
            # train-signal channel rides the same window; only divergence
            # kinds perturb it, comm faults leave the signals healthy
            win.train = self.stream_tel.train_signals(
                window_id=self.windows,
                faults=[f for f in faults if f.kind in DIVERGENCE_KINDS])
        actions = self.stream_master.ingest(win)
        # graded actions (precision branch only; the legacy master emits
        # isolate_restart exclusively, so these lists stay empty and no
        # extra events perturb the pinned PR 5 traces)
        isolates = [a for a in actions if a.action == ACTION_ISOLATE]
        suspects = [a for a in actions if a.action == ACTION_DEPRIORITIZE]
        for a in suspects:
            score = max((v.score for v in a.verdicts), default=0.0)
            self.kernel.publish(NodeSuspected(a.node_id, score=score))
        for a in actions:
            if a.action == ACTION_REPRIORITIZE:
                self.kernel.publish(NodeCleared(a.node_id))
        if suspects:
            self.suspect_windows += 1
        if not faults:
            self.fault_free_windows += 1
            if isolates:
                self.fp_windows += 1
            elif suspects:
                self.false_suspect_windows += 1
            return
        self.fault_windows += 1
        acted_nodes = {a.node_id for a in isolates}
        suspect_nodes = {a.node_id for a in suspects}
        for af in self.active:
            if af.detected_t is None and af.expected_node in acted_nodes:
                af.detected_t = t
            if af.suspected_t is None and af.expected_node in suspect_nodes:
                af.suspected_t = t
        verdict_links = {v.link for a in actions for v in a.verdicts
                         if v.link is not None}
        fault_links = {f.link for f in faults if f.link is not None}
        if verdict_links & fault_links:
            self.link_windows += 1

    # ------------------------------------------------------------------
    # report fragments
    # ------------------------------------------------------------------
    def on_stop(self) -> None:
        self.closed.extend(self.active)
        self.active = []

    def streaming_report(self) -> dict:
        recs = [af.record() for af in self.closed]
        lat = [r["latency_s"] for r in recs if r["latency_s"] is not None]
        missed = sum(1 for r in recs if r["detected_t"] is None)
        by_family: dict = {}
        for r in recs:
            fam = by_family.setdefault(r["family"],
                                       {"n_faults": 0, "detected": 0,
                                        "missed": 0})
            fam["n_faults"] += 1
            fam["detected" if r["detected_t"] is not None
                else "missed"] += 1
        return {
            "tick_s": self.tick_period_s,
            "windows": self.windows,
            "fault_windows": self.fault_windows,
            "fault_free_windows": self.fault_free_windows,
            "down_windows": self.down_windows,
            "false_positive_windows": self.fp_windows,
            "fault_free_fp_rate":
                self.fp_windows / self.fault_free_windows
                if self.fault_free_windows else None,
            "detected": len(lat),
            "missed": missed,
            "latencies_s": lat,
            "by_family": {k: by_family[k] for k in sorted(by_family)},
            "link_observation_windows": self.link_windows,
            # precision pipeline (all-zero/None under the legacy master)
            "operating_point":
                self.operating_point.to_dict()
                if self.operating_point is not None else None,
            "suspect_windows": self.suspect_windows,
            "false_suspect_windows": self.false_suspect_windows,
            "suspect_replans": self.ctx.suspect_replans,
            "faults": recs,
        }

    def network_report(self) -> dict:
        return {"n_events": len(self.network_records),
                "detections": self.network_records}
