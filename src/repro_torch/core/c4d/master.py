"""C4D master — per-job aggregation, detection, and steering (paper Fig. 3/4).

Pipeline per monitoring window:
  1. C4a agents batch their node's telemetry into reports,
  2. the master reassembles them and runs the composite detector,
  3. rank-level verdicts are folded to node-level actions (the scheduler
     isolates whole nodes),
  4. the steering service isolates the node, swaps in a backup, and restarts
     the job from the last checkpoint.

Everything the master sees is also appended to an offline log — the paper's
"C4D also collects the data from other system monitors ... and conducts
offline analysis accordingly".

Copy of ``repro.core.c4d.master`` for the port.  The master also carries the
torch backend's ``device``, which its default-constructed detector and the
prefilter's grouped medians use; ``ingest_batch`` batches through
``torchsim.detectors.score_windows_batched`` where the reference batched
under jax.
"""
from __future__ import annotations

from dataclasses import dataclass, field, fields
from typing import Dict, List, Optional

from repro_torch.core.c4d.agent import C4Agent, prefilter_arrays, reports_to_window
from repro_torch.core.c4d.attribution import (Attribution, AttributionConfig,
                                        Culprit, attribute_window)
from repro_torch.core.c4d.baseline import AdaptiveBaseline
from repro_torch.core.c4d.detector import (C4DDetector, DetectorConfig, Verdict,
                                     COMM_HANG, NONCOMM_HANG)
from repro_torch.core.c4d.divergence import (DIVERGENCE_OVERFLOW,
                                       DivergenceDetector)
from repro_torch.core.c4d.telemetry import AnyWindow, TelemetryArrays

#: graded actions of the precision state machine (docs/runtime.md).
ACTION_ISOLATE = "isolate_restart"
ACTION_DEPRIORITIZE = "deprioritize"    # suspect: steer traffic away, keep up
ACTION_REPRIORITIZE = "reprioritize"    # suspect recovered: restore planning

#: syndromes that act without waiting for confirmation streaks: hangs stop
#: the job outright, and an overflowing rank's corrupt values allreduce
#: into every replica the moment the next sync completes.
_IMMEDIATE = (COMM_HANG, NONCOMM_HANG, DIVERGENCE_OVERFLOW)


@dataclass
class NodeAction:
    node_id: int
    verdicts: List[Verdict]
    action: str = ACTION_ISOLATE
    #: attribution culprits targeting this node (empty unless the master
    #: runs with an AttributionConfig)
    culprits: tuple = ()


@dataclass(frozen=True)
class OperatingPoint:
    """One point on the precision/recall frontier of the streaming detector.

    ``None`` (the default everywhere) keeps the pinned legacy behaviour:
    single-window cross-sectional z, 2-window confirmation, no suspect
    stage.  A concrete operating point turns on the precision pipeline —
    adaptive per-rank baselines plus the healthy -> suspect -> confirmed ->
    isolate state machine — and is what the ROC sweep
    (``scenarios.precision``) selects by GPU-hour cost.

    Streak semantics (per node, per monitoring window):

      * a window with evidence raises the node's streak by 1;
      * ``suspect_streak`` windows => the node is *suspect*: a
        ``deprioritize`` action asks the fabric to re-plan around it
        (a false positive costs a re-plan, not a restart);
      * ``confirm_streak`` windows (``hang_streak`` for hang syndromes —
        the job is already stopped) => ``isolate_restart``;
      * a clean window lowers the streak by ``decay``; at zero a suspect
        node is cleared with ``reprioritize``.
    """
    mad_threshold: float = 5.0
    suspect_streak: int = 1
    confirm_streak: int = 3
    hang_streak: int = 1
    decay: int = 1
    baseline_half_life: float = 16.0   # windows; 0 = cross-sectional only
    baseline_warm_windows: int = 3

    #: CLI shorthand (``--operating-point "mad=6,streak=3,hl=16"``).
    ALIASES = {"mad": "mad_threshold", "streak": "confirm_streak",
               "suspect": "suspect_streak", "hang": "hang_streak",
               "hl": "baseline_half_life", "half_life": "baseline_half_life",
               "warm": "baseline_warm_windows"}

    @classmethod
    def parse(cls, text: str) -> "OperatingPoint":
        """Parse ``k=v`` pairs (comma-separated, aliases allowed)."""
        types = {f.name: f.type for f in fields(cls)}
        kwargs = {}
        for part in filter(None, (p.strip() for p in text.split(","))):
            if "=" not in part:
                raise ValueError(f"expected k=v, got {part!r}")
            key, val = (s.strip() for s in part.split("=", 1))
            name = cls.ALIASES.get(key, key)
            if name not in types:
                raise ValueError(f"unknown operating-point field {key!r}")
            kwargs[name] = (int(val) if types[name] == "int" else float(val))
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, float]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def label(self) -> str:
        return (f"mad={self.mad_threshold:g},streak={self.confirm_streak},"
                f"hl={self.baseline_half_life:g}")

    def detector_config(self) -> DetectorConfig:
        return DetectorConfig(mad_threshold=self.mad_threshold)


#: node states of the precision confirmation machine.
HEALTHY, SUSPECT = "healthy", "suspect"


@dataclass
class _NodeTrack:
    """Per-node confirmation state (precision branch only)."""
    streak: int = 0
    state: str = HEALTHY


@dataclass
class C4DMaster:
    """Per-job detection master (paper §3.1, Fig. 3/4).

    ``window_period_s`` realises the paper's "detection in tens of seconds";
    slow syndromes additionally wait ``confirm_windows`` consecutive
    confirmations before a node is isolated (transients clear the streak),
    while hangs act immediately — the job is already stopped.  Three
    consumers drive it: ``scenarios.detection.DetectionHarness`` builds a
    fresh master per fault (campaign reference path, Table-3 simulation),
    ``scenarios.services.C4DService`` keeps ONE master ingesting a window
    per kernel tick (the always-on streaming path — the per-node
    ``_pending`` confirmation streaks then persist across the whole run,
    which is the intended always-on semantics), and the Trainer's
    ``_handle_fault`` loop feeds it on live runs."""
    n_ranks: int
    ranks_per_node: int = 8
    detector: C4DDetector = field(default_factory=C4DDetector)
    window_period_s: float = 30.0     # paper: detection in "tens of seconds"
    confirm_windows: int = 2          # consecutive windows before acting
    offline_log: List = field(default_factory=list)
    _pending: Dict[int, int] = field(default_factory=dict)  # node -> streak
    # precision pipeline (opt-in; None keeps the pinned legacy behaviour)
    operating_point: Optional[OperatingPoint] = None
    baseline: Optional[AdaptiveBaseline] = None
    _tracks: Dict[int, _NodeTrack] = field(default_factory=dict)
    #: detector backend ("numpy"/"torch"/"auto"/None = module default).
    #: Applied to the default-constructed detector only — an explicitly
    #: supplied detector keeps whatever backend it was built with.
    backend: Optional[str] = None
    #: torch-backend device (None = the card), applied like ``backend``.
    device: Optional[object] = None
    #: root-cause attribution (opt-in): a config turns on the Mycroft-style
    #: dependency cover; None keeps the pinned verdict->node fold.
    attribution: Optional[AttributionConfig] = None
    #: divergence channel (opt-in): a detector makes the master analyse the
    #: window's TrainSignals next to the comm verdicts; None ignores them.
    divergence: Optional[DivergenceDetector] = None
    last_attribution: Optional[Attribution] = None
    attribution_log: List = field(default_factory=list)

    def __post_init__(self):
        if self.backend is not None and self.detector.backend is None:
            self.detector.backend = self.backend
        if self.device is not None and self.detector.device is None:
            self.detector.device = self.device
        self.agents = [
            C4Agent(nid, range(nid * self.ranks_per_node,
                               (nid + 1) * self.ranks_per_node))
            for nid in range((self.n_ranks + self.ranks_per_node - 1)
                             // self.ranks_per_node)]
        op = self.operating_point
        if op is not None and op.baseline_half_life > 0 and self.baseline is None:
            self.baseline = AdaptiveBaseline(
                self.n_ranks, half_life=op.baseline_half_life,
                warm_windows=op.baseline_warm_windows)

    @classmethod
    def from_operating_point(cls, op: OperatingPoint, n_ranks: int,
                             ranks_per_node: int = 8,
                             window_period_s: float = 30.0,
                             backend: Optional[str] = None,
                             device=None) -> "C4DMaster":
        """A streaming master tuned to one ROC-sweep operating point."""
        return cls(n_ranks=n_ranks, ranks_per_node=ranks_per_node,
                   detector=C4DDetector(op.detector_config(),
                                        backend=backend, device=device),
                   window_period_s=window_period_s,
                   confirm_windows=op.confirm_streak,
                   operating_point=op, backend=backend, device=device)

    def node_of(self, rank: int) -> int:
        return rank // self.ranks_per_node

    # ------------------------------------------------------------------
    def ingest(self, window: AnyWindow) -> List[NodeAction]:
        """One monitoring cycle: agents -> reassembly -> detect -> act.

        A ``TelemetryArrays`` window takes the vectorized fleet path (all
        agents prefiltered in one pass); a scalar ``TelemetryWindow`` runs
        the per-agent reference path.  Both produce identical verdicts."""
        merged = self._merge(window)
        verdicts = self.detector.analyze(merged, n_ranks=self.n_ranks,
                                         baseline=self.baseline)
        return self._act(window, merged, verdicts)

    def ingest_batch(self, windows: List[AnyWindow]) -> List[List[NodeAction]]:
        """Ingest several monitoring windows, batching the detector.

        Bit-identical to ``[self.ingest(w) for w in windows]``: the
        confirmation/track state advances per window, in order.  When the
        detector resolves to the torch backend and the master is
        baseline-free (the legacy default — an adaptive baseline makes
        window i+1 depend on window i, so those masters stay sequential),
        all hang-free windows share batched window-score/fold launches via
        ``score_windows_batched`` instead of one launch per window."""
        from repro_torch.core.torchsim import effective_backend
        merged = [self._merge(w) for w in windows]
        batchable = (len(windows) > 1 and self.baseline is None
                     and all(isinstance(m, TelemetryArrays) for m in merged)
                     and effective_backend(self.detector.backend,
                                           ranks=self.n_ranks) == "torch")
        if batchable:
            from repro_torch.core.torchsim.detectors import (
                score_windows_batched)
            scored = score_windows_batched(merged, self.detector.cfg,
                                           n_ranks=self.n_ranks,
                                           device=self.detector.device)
        else:
            scored = [self.detector.analyze(m, n_ranks=self.n_ranks,
                                            baseline=self.baseline)
                      for m in merged]
        return [self._act(w, m, v)
                for w, m, v in zip(windows, merged, scored)]

    def _merge(self, window: AnyWindow) -> AnyWindow:
        if isinstance(window, TelemetryArrays):
            return prefilter_arrays(window, self.ranks_per_node,
                                    suspect_z=self.agents[0].suspect_z,
                                    n_ranks=self.n_ranks,
                                    backend=self.detector.backend,
                                    device=self.detector.device)
        reports = [a.collect(window) for a in self.agents]
        return reports_to_window(reports, window)

    def _act(self, window: AnyWindow, merged: AnyWindow,
             verdicts: List[Verdict]) -> List[NodeAction]:
        """Post-detection half of a cycle: divergence, offline log,
        attribution, node fold, confirmation streaks."""
        if self.divergence is not None and merged.train is not None:
            verdicts = list(verdicts) + self.divergence.analyze(merged.train)
        self.offline_log.append((window.window_id, verdicts))

        culprits_by_node: Dict[int, List[Culprit]] = {}
        if self.attribution is not None:
            self.last_attribution = None
            if verdicts:
                att = attribute_window(verdicts, window=merged,
                                       n_ranks=self.n_ranks,
                                       cfg=self.attribution,
                                       backend=self.backend,
                                       device=self.device)
                self.last_attribution = att
                self.attribution_log.append((window.window_id, att))
                verdicts = self._filter_attributed(verdicts, att)
                for c in att.culprits:
                    target = (c.rank if c.kind == "rank" else c.link[0])
                    culprits_by_node.setdefault(self.node_of(target),
                                                []).append(c)

        by_node: Dict[int, List[Verdict]] = {}
        for v in verdicts:
            if v.rank is not None:
                by_node.setdefault(self.node_of(v.rank), []).append(v)
            elif v.link is not None:
                # link faults implicate the source side's NIC first
                by_node.setdefault(self.node_of(v.link[0]), []).append(v)

        if self.operating_point is not None:
            return self._confirm_graded(by_node, culprits_by_node)

        actions: List[NodeAction] = []
        seen = set(by_node)
        for node, vs in by_node.items():
            streak = self._pending.get(node, 0) + 1
            hang = any(v.syndrome in _IMMEDIATE for v in vs)
            # hangs act immediately (the job is already stopped); slow
            # syndromes wait for confirm_windows consecutive confirmations
            if hang or streak >= self.confirm_windows:
                actions.append(NodeAction(
                    node, vs,
                    culprits=tuple(culprits_by_node.get(node, ()))))
                self._pending.pop(node, None)
            else:
                self._pending[node] = streak
        for node in list(self._pending):
            if node not in seen:
                self._pending.pop(node)
        return actions

    def _filter_attributed(self, verdicts: List[Verdict],
                           att: Attribution) -> List[Verdict]:
        """Keep only verdicts the culprit set explains.

        This is the 'act on the culprit host, not the ring' step: a
        comm_slow_link verdict on an edge that merely carries a culprit
        rank's traffic is dropped, so no healthy node is isolated for it.
        An empty cover (no culprit cleared the bar) falls back to the
        unfiltered verdicts — attribution narrows actions, never mutes a
        detection outright."""
        allowed_ranks = att.rank_set()
        allowed_links = {c.link for c in att.culprits if c.kind == "link"}
        kept = [v for v in verdicts
                if (v.rank is not None and v.rank in allowed_ranks)
                or (v.link is not None and (v.link in allowed_links
                                            or v.link[0] in allowed_ranks
                                            or v.link[1] in allowed_ranks))]
        return kept or list(verdicts)

    # ------------------------------------------------------------------
    def _confirm_graded(self, by_node: Dict[int, List[Verdict]],
                        culprits_by_node: Optional[Dict[int, List[Culprit]]]
                        = None) -> List[NodeAction]:
        """Precision branch: healthy -> suspect -> confirmed -> isolate.

        Escalation is per node; hang syndromes use their own (short)
        streak because a hung job makes no progress while we deliberate.
        Clean windows de-escalate by ``decay`` instead of wiping the
        streak, so an intermittent fault flickering at 50 % duty cycle
        still accumulates evidence."""
        op = self.operating_point
        culprits_by_node = culprits_by_node or {}
        actions: List[NodeAction] = []
        for node in sorted(by_node):
            vs = by_node[node]
            culprits = tuple(culprits_by_node.get(node, ()))
            tr = self._tracks.setdefault(node, _NodeTrack())
            tr.streak += 1
            hang = any(v.syndrome in _IMMEDIATE for v in vs)
            confirmed = tr.streak >= (op.hang_streak if hang
                                      else op.confirm_streak)
            if confirmed:
                actions.append(NodeAction(node, vs, action=ACTION_ISOLATE,
                                          culprits=culprits))
                self._tracks.pop(node)
            elif tr.state == HEALTHY and tr.streak >= op.suspect_streak:
                tr.state = SUSPECT
                actions.append(NodeAction(node, vs,
                                          action=ACTION_DEPRIORITIZE,
                                          culprits=culprits))
        for node in sorted(self._tracks):
            if node in by_node:
                continue
            tr = self._tracks[node]
            tr.streak -= op.decay
            if tr.streak <= 0:
                if tr.state == SUSPECT:
                    actions.append(NodeAction(node, [],
                                              action=ACTION_REPRIORITIZE))
                self._tracks.pop(node)
        return actions

    def node_states(self) -> Dict[int, str]:
        """Current confirmation state per tracked node (precision branch)."""
        return {node: tr.state for node, tr in sorted(self._tracks.items())}

    def detection_latency_s(self, hang: bool) -> float:
        """Expected time from fault onset to action."""
        w = self.window_period_s
        return w if hang else w * self.confirm_windows
