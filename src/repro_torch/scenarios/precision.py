"""ROC sweep for the streaming detector: pick the cost-optimal operating point.

PR 5's always-on streaming path measured a 4-7 % fault-free false-positive
rate on healthy 32-64-rank windows — at fleet scale the detector itself
would be the dominant fault injector.  This module extends the
``detector_stress`` campaign idea into a *paired* seeded sweep over the
precision knobs (``mad_threshold``, confirmation streak length, adaptive
baseline half-life):

  1. each trial's telemetry window stream — healthy jitter plus a schedule
     of fault episodes spanning the Table-1 mix *and* deliberately marginal
     severities near the detection threshold — is synthesised ONCE;
  2. the identical stream is replayed through a fresh ``C4DMaster`` per
     grid point (and through the legacy PR 5 master as the reference), so
     every point is scored on exactly the same windows;
  3. each point reports precision / recall / fault-free FP rate / detection
     latency, and a GPU-hour cost model (``stats.DetectionCostModel``:
     false isolation = the Table-3 restart tail, missed fault = the
     ``BASELINE_JUN23`` MTTR counterfactual) prices the operating point;
  4. the selected point is the cheapest one meeting the FP target with
     recall >= the reference and latency p99 within the budget.

Everything is a pure function of ``SweepSpec`` — same spec, same report,
byte for byte (the determinism contract of ``scenarios.montecarlo``).

CLI: ``python -m repro_torch.scenarios.run --sweep roc_smoke`` (exits non-zero
if the selected point misses the FP target); apply the winner to drills
and campaigns with ``--operating-point "mad=...,streak=...,hl=..."``.

Copy of ``repro.scenarios.precision`` for the port: every replay master
takes the port's default backend (torch) on ``run_sweep``'s ``device``
(``None``: the card).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.c4d.master import ACTION_ISOLATE, C4DMaster, OperatingPoint
from repro_torch.core.faults import Fault, RingJobTelemetry, sample_error_class
from repro_torch.scenarios.stats import DetectionCostModel, percentiles


@dataclass(frozen=True)
class Episode:
    """One ground-truth fault episode inside a trial's window stream."""
    onset: int                       # first window the fault is active
    length: int                      # windows the fault stays active
    fault: Fault
    expected_node: int
    marginal: bool                   # near-threshold severity draw

    @property
    def end(self) -> int:
        return self.onset + self.length


@dataclass(frozen=True)
class SweepSpec:
    """The ROC sweep distribution: trial synthesis + grid + selection rule."""
    name: str
    description: str = ""
    paper_ref: str = ""
    seed: int = 0
    # trial synthesis
    n_trials: int = 4
    ranks_choices: Tuple[int, ...] = (32, 64)   # healthy 32-64-rank windows
    ranks_per_node: int = 8
    windows: int = 150                          # stream length per trial
    episodes_per_trial: int = 3
    episode_len: Tuple[int, int] = (5, 9)       # windows, inclusive draw lo/hi
    # persistently slow-but-HEALTHY ranks (topology distance, PCIe gen,
    # thermal throttling): the heterogeneity a cross-sectional detector
    # keeps firing on — a streak cannot save it, the outlier never goes
    # away — and the reason adaptive per-rank baselines exist
    skewed_ranks: int = 2
    skew_severity: Tuple[float, float] = (1.03, 1.07)
    marginal_fraction: float = 0.4              # near-threshold episodes
    # the empirical discrimination band of the ring-jitter floor: below
    # ~1.03x nothing fires, above ~1.08x every threshold fires; inside,
    # the grid points genuinely disagree and the ROC frontier is real
    marginal_severity: Tuple[float, float] = (1.03, 1.10)
    window_period_s: float = 30.0
    # grid
    mad_thresholds: Tuple[float, ...] = (5.0, 6.0, 8.0)
    confirm_streaks: Tuple[int, ...] = (2, 3, 4)
    half_lives: Tuple[float, ...] = (0.0, 16.0)
    # selection: FP target (ROADMAP "production-grade"), latency budget
    # relative to the PR 5 reference, cost model for tie-breaking
    fp_target: float = 0.007
    latency_margin_windows: int = 2
    cost: DetectionCostModel = field(default_factory=DetectionCostModel)

    def grid(self) -> List[OperatingPoint]:
        return [OperatingPoint(mad_threshold=m, confirm_streak=s,
                               baseline_half_life=hl)
                for m in self.mad_thresholds
                for s in self.confirm_streaks
                for hl in self.half_lives]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["cost"] = self.cost.to_dict()
        return d


@dataclass
class TrialStream:
    """One synthesised trial: windows, episodes, per-window ground truth."""
    n_ranks: int
    windows: List                    # TelemetryArrays per window
    episodes: List[Episode]
    truth: List[Optional[int]]       # expected node per window (None=healthy)


def synthesize_trial(spec: SweepSpec, trial: int) -> TrialStream:
    """Build one trial's window stream (independent of any grid point).

    Episodes are placed in disjoint slots so ground truth is unambiguous;
    severities mix the Table-1 draw (5-15x, trivially separable) with the
    marginal band just above the jitter floor, where the grid points
    genuinely disagree — without the marginal band every point scores
    recall 1.0 and the ROC frontier degenerates.  A few ranks carry a
    *persistent* sub-fault skew for the whole stream: they are healthy
    (ground truth None), so every isolation they provoke is a false
    positive the detector has to engineer away."""
    rng = np.random.default_rng([spec.seed, trial])
    n = int(rng.choice(np.asarray(spec.ranks_choices)))
    tel = RingJobTelemetry(n_ranks=n, seed=int(rng.integers(0, 2**31 - 1)))

    n_skew = min(spec.skewed_ranks, n)
    skew_ranks = rng.choice(n, size=n_skew, replace=False)
    skew_faults = [Fault("slow_src", rank=int(r),
                         severity=float(rng.uniform(*spec.skew_severity)))
                   for r in skew_ranks]
    fault_pool = np.setdiff1d(np.arange(n), skew_ranks)

    episodes: List[Episode] = []
    slot = spec.windows // max(spec.episodes_per_trial, 1)
    lo, hi = spec.episode_len
    for e in range(spec.episodes_per_trial):
        length = int(rng.integers(lo, hi + 1))
        start = e * slot
        onset = start + int(rng.integers(1, max(slot - length, 2)))
        rank = int(rng.choice(fault_pool))
        if rng.random() < spec.marginal_fraction:
            sev = float(rng.uniform(*spec.marginal_severity))
            fault = Fault("slow_src", rank=rank, severity=sev)
            marginal = True
        else:
            cls = sample_error_class(rng)
            fault = _class_fault(cls, rank, n, rng)
            marginal = False
        episodes.append(Episode(onset, length, fault,
                                rank // spec.ranks_per_node, marginal))

    truth: List[Optional[int]] = [None] * spec.windows
    windows = []
    for i in range(spec.windows):
        active = [ep for ep in episodes if ep.onset <= i < ep.end]
        if active:
            truth[i] = active[0].expected_node
        windows.append(tel.window_arrays(
            window_id=i,
            faults=skew_faults + [ep.fault for ep in active]))
    return TrialStream(n, windows, episodes, truth)


def _class_fault(cls, rank: int, n: int, rng: np.random.Generator) -> Fault:
    """Table-1 severity draw (``core.faults.fault_for_class`` semantics),
    inlined so the sweep's RNG stream is explicit in one place."""
    from repro_torch.core.faults import fault_for_class
    return fault_for_class(cls, rank, n, rng)


# ---------------------------------------------------------------------------
# replay + scoring
# ---------------------------------------------------------------------------

def _master_for(op: Optional[OperatingPoint], stream: TrialStream,
                spec: SweepSpec, device=None) -> C4DMaster:
    if op is None:                   # the pinned PR 5 reference behaviour
        return C4DMaster(n_ranks=stream.n_ranks,
                         ranks_per_node=spec.ranks_per_node,
                         window_period_s=spec.window_period_s,
                         device=device)
    return C4DMaster.from_operating_point(
        op, n_ranks=stream.n_ranks, ranks_per_node=spec.ranks_per_node,
        window_period_s=spec.window_period_s, device=device)


def evaluate_point(streams: List[TrialStream],
                   op: Optional[OperatingPoint],
                   spec: SweepSpec, device=None) -> dict:
    """Replay every trial stream through one operating point and score it.

    A healthy window with an isolate action is a false positive; an isolate
    on the wrong node during an episode also counts against precision.  An
    episode is recalled if its expected node is isolated while the fault is
    active; latency is windows from onset to that isolation."""
    healthy = fp_healthy = fp_wrong = 0
    detected = 0
    episodes = 0
    latencies_w: List[int] = []
    marginal_total = marginal_hit = 0
    clean_total = clean_hit = 0
    for stream in streams:
        master = _master_for(op, stream, spec, device)
        found: Dict[int, int] = {}          # episode index -> detection window
        for i, win in enumerate(stream.windows):
            actions = master.ingest(win)
            isolated = {a.node_id for a in actions
                        if a.action == ACTION_ISOLATE}
            if stream.truth[i] is None:
                healthy += 1
                if isolated:
                    fp_healthy += 1
                continue
            hit = False
            for k, ep in enumerate(stream.episodes):
                if ep.onset <= i < ep.end and ep.expected_node in isolated:
                    found.setdefault(k, i)
                    hit = True
            if isolated and not hit:
                fp_wrong += 1
        episodes += len(stream.episodes)
        detected += len(found)
        marginal_total += sum(ep.marginal for ep in stream.episodes)
        marginal_hit += sum(stream.episodes[k].marginal for k in found)
        clean_total += sum(not ep.marginal for ep in stream.episodes)
        clean_hit += sum(not stream.episodes[k].marginal for k in found)
        latencies_w += [i - stream.episodes[k].onset + 1
                        for k, i in found.items()]
    fp_rate = fp_healthy / healthy if healthy else 0.0
    recall = detected / episodes if episodes else 1.0
    fp_total = fp_healthy + fp_wrong
    lat_s = [w * spec.window_period_s for w in latencies_w]
    mean_lat = float(np.mean(lat_s)) if lat_s else 0.0
    return {
        "operating_point": op.to_dict() if op is not None else None,
        "label": op.label() if op is not None else "pr5_reference",
        "healthy_windows": healthy,
        "false_positive_windows": fp_healthy,
        "wrong_node_windows": fp_wrong,
        "fault_free_fp_rate": fp_rate,
        "episodes": episodes,
        "detected": detected,
        "recall": recall,
        "marginal_episodes": marginal_total,
        "marginal_detected": marginal_hit,
        "clean_episodes": clean_total,
        "clean_detected": clean_hit,
        "clean_recall": clean_hit / clean_total if clean_total else 1.0,
        "precision": detected / (detected + fp_total)
            if (detected + fp_total) else 1.0,
        "latency_windows": percentiles([float(w) for w in latencies_w]),
        "latency_s": percentiles(lat_s),
        "monthly_cost_gpu_h":
            spec.cost.monthly_cost_gpu_h(fp_rate, recall, mean_lat),
    }


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

@dataclass
class SweepReport:
    """Deterministic output of ``run_sweep`` (JSON is byte-stable)."""
    sweep: dict
    reference: dict
    points: List[dict]
    selected: dict
    meets_targets: bool

    def to_json(self) -> dict:
        return {"sweep": self.sweep, "name": self.sweep.get("name"),
                "seed": self.sweep.get("seed"),
                "reference": self.reference, "points": self.points,
                "selected": self.selected,
                "meets_targets": self.meets_targets}

    def summary_lines(self) -> List[str]:
        sel, ref = self.selected, self.reference
        sw = self.sweep
        return [
            f"sweep         : {sw['name']}  seed={sw['seed']}  "
            f"trials={sw['n_trials']}  grid={len(self.points)} points",
            f"reference     : FP {ref['fault_free_fp_rate']:.4f} | "
            f"recall {ref['recall']:.3f} "
            f"(clean {ref['clean_recall']:.3f}) | "
            f"latency p99 {ref['latency_windows']['p99'] or 0:.0f} w | "
            f"cost {ref['monthly_cost_gpu_h']:.0f} GPU-h/mo",
            f"selected      : {sel['label']} | "
            f"FP {sel['fault_free_fp_rate']:.4f} (target "
            f"<= {sw['fp_target']}) | recall {sel['recall']:.3f} "
            f"(clean {sel['clean_recall']:.3f}) | "
            f"latency p99 {sel['latency_windows']['p99'] or 0:.0f} w | "
            f"cost {sel['monthly_cost_gpu_h']:.0f} GPU-h/mo",
            f"targets met   : {self.meets_targets}",
        ]


def eligible(point: dict, reference: dict, spec: SweepSpec) -> bool:
    """The selection constraints: FP target, clean-recall floor, latency.

    The recall floor is on the *clean* (Table-1 severity) episodes: a real
    fault must never be traded away for precision.  Marginal near-floor
    episodes are what the ROC frontier exists to trade — the reference
    "detects" them largely by firing indiscriminately (its healthy-window
    FP rate shows the price), so misses there are charged through the
    cost model rather than hard-gated."""
    ref_p99 = reference["latency_windows"]["p99"] or 0.0
    p99 = point["latency_windows"]["p99"] or 0.0
    return (point["fault_free_fp_rate"] <= spec.fp_target
            and point["clean_recall"] >= reference["clean_recall"]
            and p99 <= ref_p99 + spec.latency_margin_windows)


def run_sweep(spec: SweepSpec,
              progress: Optional[Callable[[int, int], None]] = None,
              device=None) -> SweepReport:
    """Synthesise the trial streams once, replay them through the PR 5
    reference and every grid point, select the cost-optimal point.
    ``device``: where the masters' torch backend runs (``None``: the card)."""
    streams = [synthesize_trial(spec, i) for i in range(spec.n_trials)]
    reference = evaluate_point(streams, None, spec, device)
    grid = spec.grid()
    points: List[dict] = []
    for i, op in enumerate(grid):
        points.append(evaluate_point(streams, op, spec, device))
        if progress:
            progress(i + 1, len(grid))
    ok = [p for p in points if eligible(p, reference, spec)]
    pool = ok if ok else points
    selected = min(pool, key=lambda p: (p["monthly_cost_gpu_h"], p["label"]))
    return SweepReport(sweep=spec.to_dict(), reference=reference,
                       points=points, selected=selected,
                       meets_targets=bool(ok))


def selected_operating_point(report: SweepReport) -> OperatingPoint:
    """Reconstruct the winner as an ``OperatingPoint`` value."""
    return OperatingPoint(**report.selected["operating_point"])


# ---------------------------------------------------------------------------
# shipped sweeps
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], SweepSpec]] = {}


def register(fn: Callable[[], SweepSpec]) -> Callable[[], SweepSpec]:
    spec = fn()
    _REGISTRY[spec.name] = fn
    return fn


def names() -> List[str]:
    return sorted(_REGISTRY)


def get(name: str, seed: Optional[int] = None,
        n_trials: Optional[int] = None) -> SweepSpec:
    try:
        spec = _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown sweep {name!r}; choose from {names()}")
    over = {k: v for k, v in (("seed", seed), ("n_trials", n_trials))
            if v is not None}
    return dataclasses.replace(spec, **over) if over else spec


@register
def roc_smoke() -> SweepSpec:
    """CI-sized ROC sweep: small grid, enough healthy windows (~400) for
    the 0.7 % FP target to be a meaningful assertion."""
    return SweepSpec(
        name="roc_smoke",
        description="Seeded paired sweep over (mad_threshold, streak, "
                    "baseline half-life) on 32/64-rank streams with "
                    "marginal-severity episodes; selects the cost-optimal "
                    "operating point.",
        paper_ref="§3.1 detection; ROADMAP false-positive item",
        n_trials=4, windows=130)


@register
def detector_stress_roc() -> SweepSpec:
    """The full frontier: the ``detector_stress`` campaign's detector-
    quality question asked as an ROC sweep — denser grid, longer streams.
    Cross-check the winner on the full engine with
    ``--campaign detector_stress --operating-point <label>``."""
    return SweepSpec(
        name="detector_stress_roc",
        description="Dense ROC sweep (4 thresholds x 3 streaks x 3 "
                    "half-lives) over long 32/64-rank streams with a 50 % "
                    "marginal-severity episode mix.",
        paper_ref="§3.1 detection, Table 1 syndromes",
        n_trials=8, windows=240, episodes_per_trial=4,
        marginal_fraction=0.5,
        mad_thresholds=(4.0, 5.0, 6.0, 8.0),
        confirm_streaks=(2, 3, 4),
        half_lives=(0.0, 8.0, 16.0))
