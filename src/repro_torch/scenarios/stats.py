"""Campaign statistics: per-trial metric extraction + fleet aggregation.

The paper's headline numbers are *fleet* statistics — a 30 % cut in
error-induced overhead, a 15 % cut in communication cost, and a 30-45 %
system-efficiency gain over a month of production jobs (abstract, §5,
Table 3).  This module turns a population of scenario-engine reports into
exactly those aggregates, with confidence intervals:

  * **MTTR** — per-fault downtime (the four Table-3 phases summed:
    detection + diagnosis&isolation + post-checkpoint + re-initialisation),
    reported as p50/p90/p99 percentiles over every fault in the campaign.
  * **Detection precision / recall** — scored against injected ground
    truth.  Every ``InjectFault`` is a real positive; an outcome is a true
    positive when the C4D pipeline acted *and* implicated the right node, a
    false positive when it acted on the wrong component, and a false
    negative when no action landed within the harness window budget.
  * **Goodput / efficiency CIs** — normal-approximation confidence
    intervals over per-trial goodput fractions and the C4P-vs-ECMP A/B
    gain, composed into the C4-vs-baseline efficiency-gain bracket the
    paper claims.
  * **Streaming detection** — the always-on ``C4DService`` path: online
    detection latency measured on the virtual clock (p50/p90/p99) and the
    fault-free false-positive rate of the persistent detector, quantities
    the per-fault batch harness structurally cannot produce.

The no-C4D counterfactual uses the Table-3 ``BASELINE_JUN23`` policy's
expected values (30-min elastic-agent hang timeout, median manual
diagnosis, infrequent checkpoints) so the "error-induced overhead" cut is
computed against the same baseline the paper measures (Table 3, Jun 2023
column).

Copy of ``repro.scenarios.stats`` for the port.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.core.downtime import BASELINE_JUN23, C4D_DEC23
from repro_torch.core.phases import DAYS

_HANG_KINDS = ("crash", "comm_hang", "noncomm_hang")
MONTH_S = 30.0 * DAYS

# paper targets the aggregates are bracketed against (abstract / Table 3)
PAPER_ERROR_OVERHEAD_CUT_PCT_POINTS = 30.0
PAPER_COMM_COST_CUT_PCT = 15.0
PAPER_EFFICIENCY_GAIN_PCT = (30.0, 45.0)

# Fraction of iteration time spent in communication for the paper's
# large-scale jobs (§1/§2 motivation: "about 30 %" at the trailing end of
# scaling).  The engine measures *busbw* gains; multiplying the comm-time
# cut by this fraction converts it into the step-time cost cut the
# abstract's "15 % reduction in communication costs" refers to.
COMM_TIME_FRACTION = 0.3


def comm_cut_pct(gain_pct: float) -> float:
    """Step-time cost cut (in % points) implied by one A/B busbw gain.

    The busbw gain g shortens the communication phase by g/(1+g/100),
    scaled by the comm share of iteration time.  The ratio has a pole at
    g = -100 (an arm that made no progress), and near-degenerate arms
    would contribute thousands of points and silently own the campaign
    mean — so the per-trial value is clipped to one full step time either
    way: beyond that the trial is a goodput degeneracy, not a
    communication-cost measurement."""
    if gain_pct <= -100.0:
        return -100.0
    cut = 100.0 * COMM_TIME_FRACTION * (gain_pct / (100.0 + gain_pct))
    return float(np.clip(cut, -100.0, 100.0))


def baseline_fault_downtime_s(fault: dict,
                              policy=BASELINE_JUN23) -> float:
    """Deterministic no-C4D counterfactual downtime for one fault record.

    Expected-value version of ``core/downtime.py``'s baseline policy: a
    hang burns the elastic-agent timeout, anything else the crash-notice
    window; diagnosis is the manual median; lost work is half the
    infrequent checkpoint period (uniform expectation); re-initialisation
    matches the drill's own cost."""
    hang = fault["kind"] in _HANG_KINDS
    det = policy.hang_timeout_s if hang else policy.crash_notice_s
    return (det + policy.manual_diag_median_s
            + 0.5 * policy.checkpoint_period_s
            + fault["phases"]["re_initialization_s"])


@dataclass(frozen=True)
class DetectionCostModel:
    """GPU-hour pricing of one streaming operating point (docs/detection.md
    "Precision").

    The ROC sweep trades three failure costs measured in fleet GPU-hours
    per month, all derived from the repo's existing accounting constants
    rather than fresh literals:

      * **false isolation** — the detector restarts a healthy node: the
        fleet pays the isolate -> swap -> re-init tail of the Table-3 cycle
        (``core/phases.py`` keys ``diagnosis_isolation_s`` +
        ``lost_progress_s`` + ``re_initialization_s`` under the
        ``C4D_DEC23`` policy).
      * **missed fault** — the fault falls back to the no-C4D path: the
        ``BASELINE_JUN23`` MTTR counterfactual (elastic-agent timeout or
        crash notice, manual diagnosis, infrequent-checkpoint loss, legacy
        re-init) minus what C4D handling would have cost.
      * **deliberation** — each extra confirmation window delays every
        *true* isolation by one monitoring period.
    """
    fleet_gpus: int = 1024
    window_period_s: float = 30.0
    faults_per_month: float = C4D_DEC23.errors_per_month
    hang_fraction: float = 0.2          # TABLE1: nccl_timeout probability
    steering_s: float = 120.0           # isolate + backup swap orchestration
    isolation_diag_s: float = 300.0     # E[U(2, 8) min] assisted isolation

    def false_isolation_s(self) -> float:
        """Downtime one false isolation inflicts on the job (seconds)."""
        return (self.steering_s + self.isolation_diag_s
                + 0.5 * C4D_DEC23.checkpoint_period_s + C4D_DEC23.reinit_s)

    def missed_fault_s(self) -> float:
        """Marginal downtime of a fault the streaming detector misses:
        baseline (manual) MTTR expectation minus the C4D handling it
        forfeited."""
        b = BASELINE_JUN23
        baseline = (self.hang_fraction * b.hang_timeout_s
                    + (1.0 - self.hang_fraction) * b.crash_notice_s
                    + b.manual_diag_median_s + 0.5 * b.checkpoint_period_s
                    + b.reinit_s)
        c4d = 2.0 * self.window_period_s + self.false_isolation_s()
        return baseline - c4d

    def monthly_cost_gpu_h(self, fp_rate: float, recall: float,
                           mean_latency_s: float) -> float:
        """Expected fleet GPU-hours burned per month at one operating point.

        False-positive events are capped at one per restart cycle — a job
        mid-restart produces no healthy windows to false-positive on."""
        windows_per_month = MONTH_S / self.window_period_s
        fp_events = min(fp_rate * windows_per_month,
                        MONTH_S / self.false_isolation_s())
        misses = (1.0 - recall) * self.faults_per_month
        detected = recall * self.faults_per_month
        downtime_s = (fp_events * self.false_isolation_s()
                      + misses * self.missed_fault_s()
                      + detected * mean_latency_s)
        return self.fleet_gpus * downtime_s / 3600.0

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d["false_isolation_s"] = self.false_isolation_s()
        d["missed_fault_s"] = self.missed_fault_s()
        return d


def trial_metrics(report: dict) -> dict:
    """Flatten one scenario-engine report into a compact per-trial record.

    Keeps everything ``aggregate`` needs (and the trial's seed, so every
    row of a campaign report is independently reproducible) and drops the
    heavyweight timeline/per-record payloads."""
    det = report["detection"]
    faults = det["faults"]
    acted = [f for f in faults if f["acted"]]
    tp = sum(1 for f in acted if f["localized"])
    net = report["network"]["detections"]
    streaming = report.get("streaming", {})
    # per-family detection quality (comm vs divergence verticals)
    by_family: dict = {}
    for f in faults:
        fam = by_family.setdefault(f.get("family", "comm"),
                                   {"n_faults": 0, "true_positives": 0,
                                    "false_positives": 0,
                                    "false_negatives": 0})
        fam["n_faults"] += 1
        if not f["acted"]:
            fam["false_negatives"] += 1
        elif f["localized"]:
            fam["true_positives"] += 1
        else:
            fam["false_positives"] += 1
    out = {
        "scenario": report["scenario"],
        "seed": report["seed"],
        "fabric": report["fabric"],
        "duration_s": report["duration_s"],
        "n_faults": det["n_faults"],
        "acted": len(acted),
        "true_positives": tp,
        "false_positives": len(acted) - tp,
        "false_negatives": det["n_faults"] - len(acted),
        "by_family": {k: by_family[k] for k in sorted(by_family)},
        "attribution_attempts": det.get("attribution_attempts", 0),
        "attribution_hits": det.get("attribution_hits", 0),
        "detection_latencies_s": [f["detection_s"] for f in acted],
        "mttr_s": [sum(f["phases"].values()) for f in faults],
        "baseline_mttr_s": [baseline_fault_downtime_s(f) for f in faults],
        "downtime_frac": report["downtime"]["fraction_of_duration"],
        "goodput_frac": report["goodput"]["fraction"],
        "restarts": report["restarts"],
        "network_events": report["network"]["n_events"],
        "network_observed": sum(1 for d in net if d["observed"]),
        "network_edge_hits": sum(1 for d in net if d["edge_hit"]),
        # always-on streaming C4D (measured on the clock; engine "streaming")
        "streaming_latencies_s": streaming.get("latencies_s", []),
        "streaming_detected": streaming.get("detected", 0),
        "streaming_missed": streaming.get("missed", 0),
        "streaming_fault_free_windows": streaming.get("fault_free_windows", 0),
        "streaming_fp_windows": streaming.get("false_positive_windows", 0),
        # precision pipeline (zero under the legacy streaming master)
        "streaming_suspect_windows": streaming.get("suspect_windows", 0),
        "streaming_false_suspect_windows":
            streaming.get("false_suspect_windows", 0),
        "streaming_suspect_replans": streaming.get("suspect_replans", 0),
    }
    if "ab" in report:
        out["ab_gain_pct"] = report["ab"]["gain_pct"]
        out["c4p_effective_gbps"] = report["ab"]["c4p_effective_gbps"]
        out["ecmp_effective_gbps"] = report["ab"]["ecmp_effective_gbps"]
    return out


def mean_ci(values: List[float], confidence_z: float = 1.96) -> dict:
    """Normal-approximation mean +- z * s/sqrt(n) (95 % by default)."""
    xs = np.asarray(values, float)
    if xs.size == 0:
        return {"n": 0, "mean": None, "ci_lo": None, "ci_hi": None}
    mean = float(xs.mean())
    half = (float(confidence_z * xs.std(ddof=1) / np.sqrt(xs.size))
            if xs.size > 1 else 0.0)
    return {"n": int(xs.size), "mean": mean,
            "ci_lo": mean - half, "ci_hi": mean + half}


def percentiles(values: List[float]) -> dict:
    xs = np.asarray(values, float)
    if xs.size == 0:
        return {"n": 0, "mean": None, "p50": None, "p90": None, "p99": None}
    return {"n": int(xs.size), "mean": float(xs.mean()),
            "p50": float(np.percentile(xs, 50)),
            "p90": float(np.percentile(xs, 90)),
            "p99": float(np.percentile(xs, 99))}


def _claim(measured: dict, paper_lo: float, paper_hi: float) -> dict:
    """Attach a paper target to a measured CI and say whether they overlap."""
    ok = (measured["n"] > 0
          and measured["ci_lo"] is not None
          and measured["ci_hi"] >= paper_lo and measured["ci_lo"] <= paper_hi)
    return {**measured, "paper_lo": paper_lo, "paper_hi": paper_hi,
            "brackets_paper": bool(ok)}


class RollingAggregator:
    """Incremental campaign aggregation: feed trial records one at a time.

    ``add`` folds one per-trial record (a ``trial_metrics`` dict — or a
    fleet *segment* record, which has the same shape) into running
    counters and value lists; ``result`` renders the same aggregate dict
    at any point.  ``aggregate(trials)`` is implemented on top of this
    class, so the rolling reports the continuous fleet emits mid-run and
    the batch campaign reports share one code path by construction:
    feeding the same records in the same order yields bit-identical
    aggregates, whether ``result`` is called once at the end or after
    every ``add``.
    """

    def __init__(self):
        self.n_trials = 0
        # detection counters
        self._tp = self._fp = self._fn = self._n_faults = 0
        self._net_ev = self._net_obs = self._net_hit = 0
        self._att_attempts = self._att_hits = 0
        self._fam_totals: dict = {}
        # streaming counters
        self._s_det = self._s_miss = self._s_ffw = self._s_fpw = 0
        self._s_susp = self._s_fsusp = self._s_replans = 0
        # value lists (appended in add-order, so percentiles/CIs match a
        # batch fold over the same records exactly)
        self._lat: List[float] = []
        self._mttr: List[float] = []
        self._base_mttr: List[float] = []
        self._s_lat: List[float] = []
        self._trial_cuts: List = []       # aligned with adds; None = no faults
        self._gains: List[float] = []
        self._eff_gains: List[float] = []
        self._goodput_fracs: List[float] = []
        self._downtime_fracs: List[float] = []

    def add(self, t: dict) -> None:
        """Fold one trial (or fleet-segment) record into the aggregate."""
        self.n_trials += 1
        self._tp += t["true_positives"]
        self._fp += t["false_positives"]
        self._fn += t["false_negatives"]
        self._n_faults += t["n_faults"]
        self._lat.extend(t["detection_latencies_s"])
        self._mttr.extend(t["mttr_s"])
        self._base_mttr.extend(t["baseline_mttr_s"])
        self._net_ev += t["network_events"]
        self._net_obs += t["network_observed"]
        self._net_hit += t["network_edge_hits"]

        # per-family P/R: the same TP/FP/FN convention, split by detector
        # vertical (comm vs divergence), summed across trials
        for fam, c in t.get("by_family", {}).items():
            agg = self._fam_totals.setdefault(fam, {"n_faults": 0,
                                                    "true_positives": 0,
                                                    "false_positives": 0,
                                                    "false_negatives": 0})
            for k in agg:
                agg[k] += c[k]
        self._att_attempts += t.get("attribution_attempts", 0)
        self._att_hits += t.get("attribution_hits", 0)

        self._s_lat.extend(t.get("streaming_latencies_s", []))
        self._s_det += t.get("streaming_detected", 0)
        self._s_miss += t.get("streaming_missed", 0)
        self._s_ffw += t.get("streaming_fault_free_windows", 0)
        self._s_fpw += t.get("streaming_fp_windows", 0)
        self._s_susp += t.get("streaming_suspect_windows", 0)
        self._s_fsusp += t.get("streaming_false_suspect_windows", 0)
        self._s_replans += t.get("streaming_suspect_replans", 0)

        # per-trial overhead cut (None when the trial saw no faults) and,
        # for A/B trials, the composite efficiency contribution
        if t["mttr_s"]:
            c = (C4D_DEC23.errors_per_month
                 * float(np.mean(t["mttr_s"])) / MONTH_S)
            b = (BASELINE_JUN23.errors_per_month
                 * float(np.mean(t["baseline_mttr_s"])) / MONTH_S)
            cut = 100.0 * (min(b, 1.0) - min(c, 1.0))
        else:
            cut = None
        self._trial_cuts.append(cut)
        if "ab_gain_pct" in t:
            self._gains.append(t["ab_gain_pct"])
            self._eff_gains.append((cut or 0.0) + comm_cut_pct(t["ab_gain_pct"]))

        self._goodput_fracs.append(t["goodput_frac"])
        self._downtime_fracs.append(t["downtime_frac"])

    def result(self) -> dict:
        """Render the aggregate dict from everything added so far.

        Returns the detection-quality block (precision/recall/latency),
        the MTTR distributions, goodput/downtime CIs, and the three
        paper-claim brackets (error-overhead cut in percentage points of
        wall time, comm cost cut, composite efficiency gain)."""
        tp, fp, fn = self._tp, self._fp, self._fn
        n_faults = self._n_faults
        per_family = {}
        for fam in sorted(self._fam_totals):
            c = self._fam_totals[fam]
            ftp, ffp = c["true_positives"], c["false_positives"]
            per_family[fam] = {
                **c,
                "precision": ftp / (ftp + ffp) if (ftp + ffp) else 1.0,
                "recall": ftp / c["n_faults"] if c["n_faults"] else 1.0,
            }

        # precision = TP/(TP+FP); recall = TP/(TP+FP+FN).  A mislocalized
        # action is an FP *and* a miss of the true fault, so it sits in the
        # denominator of both; TP+FP+FN always equals the injected-fault
        # count.
        detection = {
            "n_faults": n_faults,
            "true_positives": tp, "false_positives": fp,
            "false_negatives": fn,
            "precision": tp / (tp + fp) if (tp + fp) else 1.0,
            "recall": tp / (tp + fp + fn) if n_faults else 1.0,
            "per_family": per_family,
            "attribution": {
                "attempts": self._att_attempts,
                "hits": self._att_hits,
                "hit_rate": (self._att_hits / self._att_attempts
                             if self._att_attempts else None),
            },
            "latency_s": percentiles(self._lat),
            "network_events": self._net_ev,
            "network_observed_rate":
                self._net_obs / self._net_ev if self._net_ev else None,
            "network_edge_hit_rate":
                self._net_hit / self._net_ev if self._net_ev else None,
        }

        # -- always-on streaming C4D: latency *measured on the clock* (fault
        #    onset -> master action, including the onset-to-window-boundary
        #    phase the per-fault harness cannot see) and the fault-free
        #    false-positive rate of the persistent detector
        s_det, s_miss, s_ffw = self._s_det, self._s_miss, self._s_ffw
        streaming = {
            "latency_s": percentiles(self._s_lat),
            "detected": s_det, "missed": s_miss,
            "online_recall":
                s_det / (s_det + s_miss) if (s_det + s_miss) else None,
            "fault_free_windows": s_ffw,
            "false_positive_windows": self._s_fpw,
            "fault_free_fp_rate": self._s_fpw / s_ffw if s_ffw else None,
            "suspect_windows": self._s_susp,
            "false_suspect_windows": self._s_fsusp,
            "false_suspect_rate": self._s_fsusp / s_ffw if s_ffw else None,
            "suspect_replans": self._s_replans,
        }

        # -- error-induced overhead: measured C4D downtime vs the no-C4D
        #    counterfactual, extrapolated to the paper's month at Table-3
        #    rates
        mttr, base_mttr = self._mttr, self._base_mttr
        mttr_mean = float(np.mean(mttr)) if mttr else 0.0
        base_mean = float(np.mean(base_mttr)) if base_mttr else 0.0
        overhead_cuts = [c for c in self._trial_cuts if c is not None]
        overhead = {
            "mttr_s": percentiles(mttr),
            "baseline_mttr_s": percentiles(base_mttr),
            "per_fault_cut_frac":
                1.0 - mttr_mean / base_mean if base_mean else None,
            "c4d_month_overhead_frac":
                C4D_DEC23.errors_per_month * mttr_mean / MONTH_S,
            "baseline_month_overhead_frac":
                BASELINE_JUN23.errors_per_month * base_mean / MONTH_S,
            "cut_pct_points": _claim(mean_ci(overhead_cuts),
                                     PAPER_ERROR_OVERHEAD_CUT_PCT_POINTS * 0.5,
                                     PAPER_ERROR_OVERHEAD_CUT_PCT_POINTS * 1.5),
        }

        # -- communication cost: C4P-vs-ECMP A/B arms (identical drills).
        #    The busbw gain g shortens the communication phase by g/(1+g);
        #    scaled by the comm share of iteration time it becomes the
        #    step-time cost cut the abstract quotes as "15 %".
        comm = {
            "ab_gain_pct": mean_ci(self._gains),
            "comm_time_fraction": COMM_TIME_FRACTION,
            "cost_cut_pct": _claim(
                mean_ci([comm_cut_pct(g) for g in self._gains]),
                PAPER_COMM_COST_CUT_PCT * 0.5,
                PAPER_COMM_COST_CUT_PCT * 1.5),
        }

        # -- composite efficiency, the abstract's additive framing:
        #    percentage points of wall time recovered from error overhead
        #    plus percentage points of step time recovered from
        #    communication
        efficiency = {
            "goodput_frac": mean_ci(self._goodput_fracs),
            "downtime_frac": mean_ci(self._downtime_fracs),
            "gain_pct": _claim(mean_ci(self._eff_gains),
                               *PAPER_EFFICIENCY_GAIN_PCT),
        }
        return {"detection": detection, "streaming": streaming,
                "overhead": overhead, "communication": comm,
                "efficiency": efficiency}


def aggregate(trials: List[dict]) -> dict:
    """Fold per-trial records into the campaign's fleet statistics.

    Batch entry point, implemented on ``RollingAggregator`` so the
    incremental path the continuous fleet uses and this one cannot
    diverge."""
    agg = RollingAggregator()
    for t in trials:
        agg.add(t)
    return agg.result()
