"""C4D detection analytics (paper section 3.1, Fig. 6 and Cases 1/2).

Copy of ``repro.core.c4d.detector`` for the port.  The NumPy detectors are
unchanged (their matrix folds are pinned to ``backend="numpy"``, so the
composite stays the NumPy oracle); ``C4DDetector.analyze`` routes the
``torch`` backend, the default, to ``core.torchsim.detectors``.

Four syndromes over one telemetry window:

  * communication slow      — delay-matrix analysis: a row of high values
                              implicates the source rank, a column the
                              destination rank, an isolated cell the link.
  * non-communication slow  — receiver-driven ring scheduling: a long
                              receiver wait on an edge whose transfer
                              bandwidth is healthy implicates the *sender's*
                              compute/data path.
  * communication hang      — a rank stops progressing while peers advance,
                              and its last completed event is a transport op.
  * non-communication hang  — same, but the rank never reached the collective
                              (stuck in compute/data loading).

All statistics are robust (median/MAD) because exactly one-or-few entries
are anomalous by construction — the paper's key insight is that BSP traffic
is homogeneous, so *any* deviation is a hardware symptom.

The production detectors are NumPy-vectorized (whole-matrix masks instead
of per-cell Python loops) so one analysis pass stays sub-second at
1024-4096 ranks — the regime the Monte Carlo fleet campaigns sweep.  The
original per-cell loops are kept verbatim as ``*_verdicts_reference``
functions; tests/test_c4d_vectorized.py pins the vectorized detectors to
them verdict-for-verdict on golden fault windows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.c4d.telemetry import (AnyWindow, TelemetryArrays,
                                      TelemetryWindow, delay_matrix,
                                      wait_matrix)

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids an import cycle
    from repro_torch.core.c4d.baseline import AdaptiveBaseline

# syndrome kinds
COMM_SLOW_SRC = "comm_slow_source"
COMM_SLOW_DST = "comm_slow_destination"
COMM_SLOW_LINK = "comm_slow_link"
NONCOMM_SLOW = "noncomm_slow"
COMM_HANG = "comm_hang"
NONCOMM_HANG = "noncomm_hang"


@dataclass(frozen=True)
class Verdict:
    syndrome: str
    rank: Optional[int] = None                 # implicated rank (if rank-level)
    link: Optional[Tuple[int, int]] = None     # implicated (src, dst)
    score: float = 0.0                         # robust z-score / evidence
    detail: str = ""


@dataclass
class DetectorConfig:
    """Detector thresholds (paper §3.1; Fig. 6 outlier analysis).

    The robust z-scores come from median/MAD normalisation — BSP traffic is
    homogeneous, so anything ``mad_threshold`` deviations out is a hardware
    symptom, not load imbalance.  ``row_col_fraction`` decides when a hot
    row/column of the delay matrix folds to a rank-level (vs link-level)
    verdict; ``hang_grace`` is the heartbeat-progress slack before a rank is
    declared hung."""
    mad_threshold: float = 5.0         # z-score threshold on MAD-normalised stats
    row_col_fraction: float = 0.6      # fraction of a row/col anomalous => rank fault
    hang_grace: float = 3.0            # multiples of median op period before hang
    min_observations: int = 1


def _own_cfg(cfg: Optional[DetectorConfig]) -> DetectorConfig:
    """None-sentinel for detector constructors: a fresh config per instance.

    The constructors used to say ``cfg: DetectorConfig = DetectorConfig()``,
    which Python evaluates ONCE at class-definition time — every detector in
    the process then shared (and could mutate) the same thresholds object."""
    return cfg if cfg is not None else DetectorConfig()


def _robust_z(values: np.ndarray) -> np.ndarray:
    """Median/MAD z-scores over finite entries (NaN-safe)."""
    finite = values[np.isfinite(values)]
    if finite.size == 0:
        return np.full_like(values, np.nan)
    med = np.median(finite)
    mad = np.median(np.abs(finite - med))
    scale = 1.4826 * mad + 1e-12 * max(abs(med), 1e-12) + 1e-30
    return (values - med) / scale


def _last_heartbeat_seqs(window: AnyWindow) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted ranks, last completed seq per rank) from either window form."""
    if isinstance(window, TelemetryArrays):
        hb_rank, hb_seq = window.hb_rank, window.hb_seq
    else:
        hb = window.heartbeats
        hb_rank = np.fromiter((h.rank for h in hb), np.int64, len(hb))
        hb_seq = np.fromiter((h.seq for h in hb), np.int64, len(hb))
    ranks, inv = np.unique(hb_rank, return_inverse=True)
    seqs = np.full(ranks.size, np.iinfo(np.int64).min)
    np.maximum.at(seqs, inv, hb_seq)
    return ranks, seqs


def _transport_sources(window: AnyWindow) -> np.ndarray:
    if isinstance(window, TelemetryArrays):
        return np.unique(window.tr_src)
    return np.unique(np.fromiter((t.src_rank for t in window.transports),
                                 np.int64, len(window.transports)))


class DelayMatrixDetector:
    """Paper Fig. 6: point / row / column outliers in D[src, dst].

    Vectorized: rows/columns are folded with whole-matrix reductions and
    point outliers come from one boolean mask, so the cost is a handful of
    O(n^2) array ops instead of n^2 Python iterations.  Pinned against
    ``delay_verdicts_reference`` (the original per-cell loop).

    With a ``baseline`` the z-scores are normalised per cell against that
    cell's own EWMA history where warm (docs/detection.md "Precision");
    without one, the pinned single-window cross-section is used."""

    def __init__(self, cfg: Optional[DetectorConfig] = None):
        self.cfg = _own_cfg(cfg)

    def analyze(self, d: np.ndarray,
                baseline: Optional["AdaptiveBaseline"] = None) -> List[Verdict]:
        cfg = self.cfg
        z = _robust_z(d)
        if baseline is not None:
            z = baseline.z("delay", d, fallback=z)
        hot = (z > cfg.mad_threshold) & np.isfinite(d)
        obs = np.isfinite(d)
        verdicts: List[Verdict] = []

        def axis_verdicts(axis: int) -> np.ndarray:
            hot_n = hot.sum(axis=1 - axis)
            obs_n = obs.sum(axis=1 - axis)
            return ((obs_n >= cfg.min_observations)
                    & (hot_n >= np.maximum(1, cfg.row_col_fraction * obs_n))
                    & (hot_n >= 2))

        row_sel = axis_verdicts(0)
        col_sel = axis_verdicts(1)
        for i in np.flatnonzero(row_sel):
            verdicts.append(Verdict(
                COMM_SLOW_SRC, rank=int(i), score=float(np.nanmax(z[i, :])),
                detail=f"row {i}: {int(hot[i].sum())}/{int(obs[i].sum())} hot"))
        for j in np.flatnonzero(col_sel):
            verdicts.append(Verdict(
                COMM_SLOW_DST, rank=int(j), score=float(np.nanmax(z[:, j])),
                detail=f"col {j}: {int(hot[:, j].sum())}/{int(obs[:, j].sum())} hot"))
        points = hot & ~row_sel[:, None] & ~col_sel[None, :]
        for i, j in np.argwhere(points):
            verdicts.append(Verdict(COMM_SLOW_LINK, link=(int(i), int(j)),
                                    score=float(z[i, j]),
                                    detail=f"point ({i},{j})"))
        return verdicts


class RingWaitDetector:
    """Paper Case 2. For ring edge (i -> j): the receiver j posts its buffer
    and waits. If the edge's *transfer* is healthy but j's wait is anomalously
    long, the sender i was late into the collective => i is non-communication
    slow (compute or data loading).

    Vectorized: one masked row-max over the wait z-score matrix; pinned
    against ``ring_wait_verdicts_reference``.  ``d``/``w`` accept
    precomputed matrices so the composite detector builds each once per
    window; a ``baseline`` swaps in per-cell EWMA normalisation where warm."""

    def __init__(self, cfg: Optional[DetectorConfig] = None):
        self.cfg = _own_cfg(cfg)

    def analyze(self, window: Optional[AnyWindow] = None,
                n_ranks: Optional[int] = None, *,
                d: Optional[np.ndarray] = None,
                w: Optional[np.ndarray] = None,
                baseline: Optional["AdaptiveBaseline"] = None) -> List[Verdict]:
        if d is None:
            d = delay_matrix(window, n_ranks, backend="numpy")
        if w is None:
            w = wait_matrix(window, n_ranks, backend="numpy")
        zd = _robust_z(d)
        zw = _robust_z(w)
        if baseline is not None:
            zd = baseline.z("delay", d, fallback=zd)
            zw = baseline.z("wait", w, fallback=zw)
        hot_wait = (zw > self.cfg.mad_threshold) & np.isfinite(w)
        healthy_link = ~((zd > self.cfg.mad_threshold) & np.isfinite(d))
        # receiver j waited on sender i over a healthy link => i implicated
        mask = hot_wait & healthy_link
        scores = np.where(mask, zw, -np.inf).max(axis=1)
        return [Verdict(NONCOMM_SLOW, rank=int(i), score=float(scores[i]),
                        detail="receiver wait w/ healthy transfer")
                for i in np.flatnonzero(mask.any(axis=1))]


class HangDetector:
    """Progress-based hang detection from per-rank heartbeats.

    Vectorized: last-seq per rank via one ``np.maximum.at`` scatter; pinned
    against ``hang_verdicts_reference``.  A ``baseline`` subtracts each
    rank's learned heartbeat deficit before the grace comparison, so a rank
    that always trails the median by half a beat is its own normal."""

    def __init__(self, cfg: Optional[DetectorConfig] = None):
        self.cfg = _own_cfg(cfg)

    def analyze(self, window: AnyWindow,
                baseline: Optional["AdaptiveBaseline"] = None) -> List[Verdict]:
        ranks, seqs = _last_heartbeat_seqs(window)
        if ranks.size == 0:
            return []
        med = np.median(seqs)
        deficit = med - seqs
        if baseline is not None:
            deficit = deficit - baseline.deficit_offset(ranks)
        hung = np.flatnonzero(deficit >= self.cfg.hang_grace)
        if hung.size == 0:
            return []
        # did the rank itself start any transport before stalling?
        # yes -> it died inside the collective (communication hang);
        # no  -> it never reached it (compute / data-loading hang)
        had_transport = np.isin(ranks[hung], _transport_sources(window))
        return [Verdict(COMM_HANG if had else NONCOMM_HANG, rank=int(r),
                        score=float(med - s),
                        detail=f"seq {int(s)} vs median {med:.0f}")
                for r, s, had in zip(ranks[hung], seqs[hung], had_transport)]


# ---------------------------------------------------------------------------
# Scalar references — the original per-cell loops, pinned verbatim.  The
# vectorized detectors above must reproduce these verdict-for-verdict
# (tests/test_c4d_vectorized.py); treat any divergence as a bug in the
# vectorized path.
# ---------------------------------------------------------------------------

def delay_verdicts_reference(d: np.ndarray,
                             cfg: Optional[DetectorConfig] = None) -> List[Verdict]:
    """Reference implementation of ``DelayMatrixDetector.analyze``."""
    cfg = _own_cfg(cfg)
    z = _robust_z(d)
    hot = (z > cfg.mad_threshold) & np.isfinite(d)
    verdicts: List[Verdict] = []
    n = d.shape[0]
    used_rows, used_cols = set(), set()
    for i in range(n):
        row = hot[i, :]
        obs = np.isfinite(d[i, :])
        if obs.sum() >= cfg.min_observations and row.sum() >= max(
                1, cfg.row_col_fraction * obs.sum()) and row.sum() >= 2:
            verdicts.append(Verdict(COMM_SLOW_SRC, rank=i,
                                    score=float(np.nanmax(z[i, :])),
                                    detail=f"row {i}: {int(row.sum())}/{int(obs.sum())} hot"))
            used_rows.add(i)
    for j in range(n):
        col = hot[:, j]
        obs = np.isfinite(d[:, j])
        if obs.sum() >= cfg.min_observations and col.sum() >= max(
                1, cfg.row_col_fraction * obs.sum()) and col.sum() >= 2:
            verdicts.append(Verdict(COMM_SLOW_DST, rank=j,
                                    score=float(np.nanmax(z[:, j])),
                                    detail=f"col {j}: {int(col.sum())}/{int(obs.sum())} hot"))
            used_cols.add(j)
    for i in range(n):
        for j in range(n):
            if hot[i, j] and i not in used_rows and j not in used_cols:
                verdicts.append(Verdict(COMM_SLOW_LINK, link=(i, j),
                                        score=float(z[i, j]),
                                        detail=f"point ({i},{j})"))
    return verdicts


def ring_wait_verdicts_reference(window: TelemetryWindow,
                                 cfg: Optional[DetectorConfig] = None,
                                 n_ranks: Optional[int] = None) -> List[Verdict]:
    """Reference implementation of ``RingWaitDetector.analyze``."""
    cfg = _own_cfg(cfg)
    d = delay_matrix(window, n_ranks, backend="numpy")
    w = wait_matrix(window, n_ranks, backend="numpy")
    zd = _robust_z(d)
    zw = _robust_z(w)
    verdicts: List[Verdict] = []
    hot_wait = (zw > cfg.mad_threshold) & np.isfinite(w)
    healthy_link = ~((zd > cfg.mad_threshold) & np.isfinite(d))
    n = w.shape[0]
    scores: Dict[int, float] = {}
    for i in range(n):
        for j in range(n):
            if hot_wait[i, j] and healthy_link[i, j]:
                scores[i] = max(scores.get(i, 0.0), float(zw[i, j]))
    for rank, score in sorted(scores.items()):
        verdicts.append(Verdict(NONCOMM_SLOW, rank=rank, score=score,
                                detail="receiver wait w/ healthy transfer"))
    return verdicts


def hang_verdicts_reference(window: TelemetryWindow,
                            cfg: Optional[DetectorConfig] = None) -> List[Verdict]:
    """Reference implementation of ``HangDetector.analyze``."""
    cfg = _own_cfg(cfg)
    if not window.heartbeats:
        return []
    last: Dict[int, Tuple[int, float]] = {}
    for h in window.heartbeats:
        if h.rank not in last or h.seq > last[h.rank][0]:
            last[h.rank] = (h.seq, h.t)
    seqs = np.array([last[r][0] for r in sorted(last)])
    ranks = np.array(sorted(last))
    med = np.median(seqs)
    verdicts: List[Verdict] = []
    for r, s in zip(ranks, seqs):
        if med - s >= cfg.hang_grace:
            had_transport = any(t.src_rank == r for t in window.transports)
            syndrome = COMM_HANG if had_transport else NONCOMM_HANG
            verdicts.append(Verdict(syndrome, rank=int(r),
                                    score=float(med - s),
                                    detail=f"seq {int(s)} vs median {med:.0f}"))
    return verdicts


class C4DDetector:
    """Composite: the full analysis the C4D master runs per window (§3.1).

    Hang analysis pre-empts slow analysis — a hung job emits no useful
    delay statistics, and the paper's steering acts on hangs immediately.
    Consumed per monitoring window by ``c4d.master.C4DMaster`` and, through
    it, by every composition layer (trainer drills, Table-3 downtime,
    scenario campaigns — see docs/architecture.md).

    ``backend`` selects the implementation per *call*: ``"torch"`` (the
    port's default; ``core.torchsim`` — the sparse pipeline over the CUDA
    kernels ``window_score`` and ``slow_fold`` on ``device``, verdict-
    identical; the 100k-rank path), ``"numpy"`` (the pinned reference
    composite, the oracle), ``"auto"`` (by size), or ``None`` to follow the
    process default (``torchsim.use_backend`` / ``REPRO_TORCH_SIM_BACKEND``).
    ``device`` is where the torch backend runs: ``None`` is the card (and
    raises without one), ``"cpu"`` runs the kernels' plain versions."""

    def __init__(self, cfg: Optional[DetectorConfig] = None,
                 backend: Optional[str] = None, device=None):
        self.cfg = _own_cfg(cfg)
        self.backend = backend
        self.device = device
        self.delay = DelayMatrixDetector(self.cfg)
        self.wait = RingWaitDetector(self.cfg)
        self.hang = HangDetector(self.cfg)

    def analyze(self, window: AnyWindow,
                n_ranks: Optional[int] = None,
                baseline: Optional["AdaptiveBaseline"] = None) -> List[Verdict]:
        from repro_torch.core.torchsim import effective_backend
        n = n_ranks or window.n_ranks()
        if effective_backend(self.backend, ranks=n) == "torch":
            from repro_torch.core.torchsim.detectors import analyze_arrays
            arrays = (window if isinstance(window, TelemetryArrays)
                      else TelemetryArrays.from_window(window))
            return analyze_arrays(arrays, self.cfg, n_ranks=n,
                                  baseline=baseline, device=self.device)
        verdicts = self.hang.analyze(window, baseline=baseline)
        if verdicts:
            # hangs pre-empt slow analysis (job is stopped); the delay/wait
            # baselines are not advanced either — a hung window's matrices
            # carry no comm statistics worth learning from
            return verdicts
        d = delay_matrix(window, n_ranks, backend="numpy")
        w = wait_matrix(window, n_ranks, backend="numpy")
        verdicts = self.delay.analyze(d, baseline=baseline)
        verdicts += self.wait.analyze(window, n_ranks, d=d, w=w,
                                      baseline=baseline)
        if baseline is not None:
            self._advance_baseline(baseline, window, d, w)
        return verdicts

    def _advance_baseline(self, baseline: "AdaptiveBaseline",
                          window: AnyWindow, d: np.ndarray,
                          w: np.ndarray) -> None:
        """Fold this window into the EWMA history.  The matrix updates are
        winsorized inside ``AdaptiveBaseline.update`` (bounded per-window
        drift), so no z-gate is needed here — every cell updates and a live
        fault cannot erase itself before the streak confirms.  Heartbeat
        deficits of ranks already past the hang grace *are* excluded:
        a stalled counter is an outage, not a statistic."""
        baseline.update("delay", d)
        baseline.update("wait", w)
        ranks, seqs = _last_heartbeat_seqs(window)
        if ranks.size:
            deficit = np.median(seqs) - seqs
            adj = deficit - baseline.deficit_offset(ranks)
            baseline.update_deficit(ranks, deficit.astype(float),
                                    exclude=adj >= self.cfg.hang_grace)
