"""Per-fault C4D detection harness + the netsim -> telemetry bridge.

``DetectionHarness`` runs the *real* detection pipeline (telemetry window
synthesis -> C4a agents -> C4D master) for one injected fault and returns
the measured latency and localisation verdict.  It is the single
per-fault reference path shared by

  * ``scenarios.services.C4DService`` — the campaign engine's detection
    service, against the live fabric (its *always-on streaming* sibling
    runs a persistent master on the kernel clock; the harness stays the
    agreeing reference that drives isolation and pins the goldens),
  * the Table-3 month simulation (``core/downtime.py``) — per sampled error.

``bridge_faults`` translates live netsim state (per-connection rate drops
relative to a healthy baseline) into enhanced-CCL telemetry signatures, so
fabric events (FailLink, contention) become visible to C4D through the same
delay-matrix analysis the paper describes (§3.1, Fig. 6) instead of through
sampled constants.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.c4d.attribution import AttributionConfig
from repro_torch.core.c4d.divergence import DivergenceDetector
from repro_torch.core.c4d.master import C4DMaster, NodeAction
from repro_torch.core.faults import (DIVERGENCE_KINDS, ErrorClass, Fault,
                               RingJobTelemetry, fault_family,
                               fault_for_class)


@dataclass
class DetectionOutcome:
    """Result of running the pipeline for one fault instance."""
    localized: bool                 # correct component implicated
    detection_s: float              # windows consumed * window period
    node: int                       # implicated telemetry node (-1: none)
    windows: int = 0
    acted: bool = False             # master issued any action at all
    syndromes: Tuple[str, ...] = ()
    links: Tuple[Tuple[int, int], ...] = ()   # implicated telemetry links
    family: str = "comm"            # detector vertical ("comm"/"divergence")
    culprit_ranks: Tuple[int, ...] = ()       # attributed root-cause ranks
    culprit_hit: Optional[bool] = None        # injected rank in culprit set
                                              # (None: attribution off / no
                                              #  ground-truth rank)


@dataclass
class DetectionHarness:
    """Runs telemetry -> agents -> master for injected faults.

    A fresh ``C4DMaster`` is built per fault (each drill starts from a clean
    confirmation state, matching the paper's per-incident analysis); the
    ``RingJobTelemetry`` instance persists so its jitter stream — and hence
    any caller's reproducibility guarantees — is preserved across faults.

    Windows are synthesised and analysed on the vectorized
    struct-of-arrays path (``RingJobTelemetry.window_arrays`` ->
    ``C4DMaster.ingest``), which consumes the identical RNG stream and
    produces identical verdicts to the scalar path — the Table-3 goldens
    (tests/test_downtime_regression.py) pin this — while staying fast
    enough for Monte Carlo campaigns at 1024+ ranks
    (``vectorized=False`` keeps the scalar reference path available).
    """
    telemetry: RingJobTelemetry
    ranks_per_node: int = 8
    max_windows: int = 4
    window_period_s: Optional[float] = None   # default: master's 30 s
    vectorized: bool = True
    backend: Optional[str] = None             # detector kernels; None = default
    device: Optional[object] = None           # torch backend's; None = the card
    #: root-cause attribution (opt-in): a config makes every per-fault
    #: master run the dependency cover and the outcome carry culprit ranks
    attribution: Optional[AttributionConfig] = None

    def _master(self, divergence: bool = False) -> C4DMaster:
        m = C4DMaster(n_ranks=self.telemetry.n,
                      ranks_per_node=self.ranks_per_node,
                      backend=self.backend,
                      device=self.device,
                      attribution=self.attribution,
                      divergence=DivergenceDetector() if divergence else None)
        if self.window_period_s is not None:
            m.window_period_s = self.window_period_s
        return m

    # ------------------------------------------------------------------
    def detect_faults(self, faults: Sequence[Fault],
                      expected_node: Optional[int] = None,
                      expected_rank: Optional[int] = None) -> DetectionOutcome:
        """Feed windows until the master acts (or ``max_windows`` pass).

        ``expected_node``: ground-truth node; the outcome is ``localized``
        iff some action lands on it.  With no ground truth, any action
        counts as localised.  ``expected_rank`` (attribution only): the
        ground-truth culprit; the outcome's ``culprit_hit`` records whether
        the attributed set contains it.  A divergence-family fault in the
        list turns on the train-signal channel for this run."""
        divergence = any(f.kind in DIVERGENCE_KINDS for f in faults)
        master = self._master(divergence=divergence)
        latency = 0.0
        actions: List[NodeAction] = []
        windows = 0
        synth = (self.telemetry.window_arrays if self.vectorized
                 else self.telemetry.window)
        for w in range(self.max_windows):
            win = synth(window_id=w, faults=list(faults))
            if divergence:
                win.train = self.telemetry.train_signals(
                    window_id=w, faults=list(faults))
            actions = master.ingest(win)
            latency += master.window_period_s
            windows = w + 1
            if actions:
                break
        family = fault_family(faults[0].kind) if faults else "comm"
        if not actions:
            return DetectionOutcome(False, latency, -1, windows,
                                    family=family)
        syndromes = tuple(v.syndrome for a in actions for v in a.verdicts)
        links = tuple(v.link for a in actions for v in a.verdicts
                      if v.link is not None)
        culprit_ranks: Tuple[int, ...] = ()
        culprit_hit: Optional[bool] = None
        if self.attribution is not None and master.last_attribution is not None:
            culprit_ranks = tuple(sorted(master.last_attribution.rank_set()))
            if expected_rank is not None:
                culprit_hit = expected_rank in set(culprit_ranks)
        if expected_node is None:
            hit, node = True, actions[0].node_id
        else:
            hit = any(a.node_id == expected_node for a in actions)
            node = expected_node
        return DetectionOutcome(hit, latency, node, windows, acted=True,
                                syndromes=syndromes, links=links,
                                family=family, culprit_ranks=culprit_ranks,
                                culprit_hit=culprit_hit)

    def detect_class(self, cls: ErrorClass,
                     rng: np.random.Generator) -> DetectionOutcome:
        """One Table-1 error: draw a victim rank, instantiate its telemetry
        signature, run the pipeline, and apply the Table-1 localisation
        ceiling (some classes are inherently ambiguous).

        RNG draw order (rank, fault parameters, ceiling) is part of the
        contract: ``core/downtime.py`` Table-3 numbers are regression-pinned
        on it."""
        n_ranks = self.telemetry.n
        rank = int(rng.integers(0, n_ranks))
        fault = fault_for_class(cls, rank, n_ranks, rng)
        expected = rank // self.ranks_per_node
        out = self.detect_faults([fault], expected_node=expected,
                                 expected_rank=rank)
        if not out.acted:
            return out
        if rng.random() > cls.localization_rate:
            out.localized = False
        return out


# ---------------------------------------------------------------------------
# netsim -> telemetry bridge
# ---------------------------------------------------------------------------

def bridge_faults(baseline_conn: Dict[Tuple, float],
                  current_conn: Dict[Tuple, float],
                  host_to_rank: Dict[int, int],
                  n_ranks: int,
                  threshold: float = 1.8,
                  severity_cap: float = 50.0) -> Tuple[List[Fault], List[Tuple[int, int]]]:
    """Synthesise slow-link telemetry from live fabric degradation.

    For every connection whose max-min rate fell below ``baseline /
    threshold``, emit a ``slow_link`` fault with severity equal to the
    observed slowdown ratio (capped — a fully dead path would otherwise be
    an infinite multiplier).  Connection keys follow the C4P convention
    ``(job, (src_host, dst_host), nic, ...)``; ``host_to_rank`` maps testbed
    hosts onto the telemetry ring.

    The fault lands on the *canonical ring edge of the connection's source
    host*: ``(r, r+1)`` for ``r = host_to_rank[src]``.  The synthetic
    telemetry ring only carries traffic on its channel-stride edges, and
    stride 1 always exists, so this is the edge where the degradation is
    guaranteed to be emitted — and hence observable by the delay-matrix
    point/row analysis.  The detector must implicate exactly this edge for
    the verdict to count as a hit.

    Returns (faults, affected_edges) where ``affected_edges`` is the
    ground-truth set of telemetry edges a correct detector should implicate.
    """
    worst: Dict[Tuple[int, int], float] = {}
    for cid, base in baseline_conn.items():
        if base <= 1e-9:
            continue
        cur = current_conn.get(cid, 0.0)
        ratio = severity_cap if cur <= base / severity_cap else base / cur
        if ratio < threshold:
            continue
        src, _dst = cid[1]
        if src not in host_to_rank:
            continue
        r = host_to_rank[src] % n_ranks
        e = (r, (r + 1) % n_ranks)
        if e[0] == e[1]:
            continue
        worst[e] = max(worst.get(e, 0.0), min(ratio, severity_cap))
    faults = [Fault("slow_link", link=e, severity=s)
              for e, s in sorted(worst.items())]
    return faults, sorted(worst)
