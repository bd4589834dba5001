"""Root-cause attribution: from syndrome verdicts to a ranked culprit set.

The base detectors (``c4d.detector``) answer *what* is wrong — a slow
source, a slow link, a hang — but a window with one degraded host often
yields several verdicts at once: the host's own ``comm_slow_source`` plus
``comm_slow_link`` verdicts on edges that merely *carry* its traffic.
Acting on each verdict independently blames whole neighbourhoods ("ring R
is slow") and can isolate healthy hosts whose only fault is sharing a ring
with the culprit.

Mycroft (arXiv 2509.03018) resolves this by tracing dependencies through
the collective: in a ring, a rank is an endpoint of every channel edge it
sends on or receives on, so a single bad rank *explains* an entire hot row
(its sends), a hot column (its receives), and the receiver-side waits it
induces downstream.  A bad cable explains exactly one cell.  Attribution
is therefore a weighted set-cover over the hot cells of the delay and
wait matrices: candidate explanations are ranks (covering their row +
column) and links (covering one cell), and a greedy cover picks the
smallest explanation set, most-explanatory first.

The cover is deliberately greedy and bounded (``max_culprits``): under the
BSP traffic model one window has at most a couple of simultaneous root
causes, and the marginal-coverage stop rule (``min_coverage``) keeps noise
cells from dragging in spurious culprits.  Rank candidates must explain at
least two cells — a rank that only explains one cell is indistinguishable
from a bad cable, and the link is the cheaper (more precise) explanation.

Hang and divergence verdicts skip the matrices entirely: they already name
a rank, so they map to direct rank culprits ranked by score.

Everything here is opt-in: ``C4DMaster`` only runs attribution when given
an ``AttributionConfig``, so the default pipeline (and every pre-existing
golden) is bit-identical with this module unimported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.c4d.detector import (COMM_HANG, NONCOMM_HANG, NONCOMM_SLOW,
                                     Verdict, _robust_z)
from repro_torch.core.c4d.divergence import DIVERGENCE_SYNDROMES
from repro_torch.core.c4d.telemetry import delay_matrix, wait_matrix

# syndromes that already carry a root-cause rank — no matrix cover needed
_DIRECT_SYNDROMES = (COMM_HANG, NONCOMM_HANG, NONCOMM_SLOW,
                     *DIVERGENCE_SYNDROMES)


@dataclass(frozen=True)
class Culprit:
    """One attributed root cause: a rank (host/GPU) or a physical link."""
    kind: str                               # "rank" | "link"
    rank: Optional[int] = None
    link: Optional[Tuple[int, int]] = None
    score: float = 0.0                      # summed z-weight it explains
    cells: int = 0                          # hot cells it covers
    coverage: float = 0.0                   # fraction of total hot weight

    def ranks(self) -> Tuple[int, ...]:
        """Ranks this culprit implicates (link -> both endpoints)."""
        if self.kind == "rank":
            return (self.rank,)
        return tuple(sorted(self.link))


@dataclass
class Attribution:
    """Result of one window's attribution pass."""
    window_id: int
    culprits: List[Culprit] = field(default_factory=list)
    hot_cells: int = 0
    explained_cells: int = 0
    total_weight: float = 0.0

    def rank_set(self) -> Set[int]:
        """Union of ranks implicated by any culprit."""
        out: Set[int] = set()
        for c in self.culprits:
            out.update(c.ranks())
        return out

    def to_dict(self) -> Dict:
        return {
            "window_id": self.window_id,
            "hot_cells": self.hot_cells,
            "explained_cells": self.explained_cells,
            "culprits": [
                {"kind": c.kind, "rank": c.rank,
                 "link": list(c.link) if c.link else None,
                 "score": c.score, "cells": c.cells,
                 "coverage": c.coverage}
                for c in self.culprits],
        }


@dataclass
class AttributionConfig:
    """Knobs of the greedy dependency cover.

    ``mad_threshold`` marks matrix cells hot (same median/MAD convention
    as the detectors); ``max_culprits`` bounds the explanation set — the
    precision guarantee the property tests pin; ``min_coverage`` stops the
    cover once a candidate's marginal gain falls below that fraction of
    the total hot weight (the first matrix pick is exempt, so a genuine
    single-cell link fault is still attributed)."""
    mad_threshold: float = 5.0
    max_culprits: int = 3
    min_coverage: float = 0.05


def _hot_cells(d: np.ndarray, w: np.ndarray,
               thr: float) -> Dict[Tuple[int, int, str], float]:
    """Hot (src, dst) cells -> z-weight, over both matrices.

    Delay heat on a cell subsumes wait heat (a slow transfer also shows
    up as receiver wait), so a cell only contributes its wait weight when
    its delay is cool; wait heat implicates the *sender* (late into the
    collective), which the rank-candidate pass accounts for."""
    zd = _robust_z(d)
    zw = _robust_z(w)
    hot: Dict[Tuple[int, int, str], float] = {}
    hot_d = np.isfinite(zd) & (zd > thr)
    hot_w = np.isfinite(zw) & (zw > thr) & ~hot_d
    for i, j in zip(*np.nonzero(hot_d)):
        hot[(int(i), int(j), "d")] = float(zd[i, j])
    for i, j in zip(*np.nonzero(hot_w)):
        hot[(int(i), int(j), "w")] = float(zw[i, j])
    return hot


def _candidate_cells(n_ranks: int, hot: Dict[Tuple[int, int, str], float]):
    """Candidate -> set of hot cells it explains.

    A rank r explains delay cells on its row (sends) and column
    (receives) and wait cells on its row (its lateness stalls the
    receiver).  A link (i, j) explains its own cell only.  Rank
    candidates need >= 2 cells: a one-cell rank explanation is strictly
    dominated by the link explanation for that cell."""
    rank_cells: Dict[int, Set[Tuple[int, int, str]]] = {}
    link_cells: Dict[Tuple[int, int], Set[Tuple[int, int, str]]] = {}
    for (i, j, kind) in hot:
        cell = (i, j, kind)
        link_cells.setdefault((i, j), set()).add(cell)
        rank_cells.setdefault(i, set()).add(cell)
        if kind == "d":
            rank_cells.setdefault(j, set()).add(cell)
    candidates = []
    for r in sorted(rank_cells):
        if 0 <= r < n_ranks and len(rank_cells[r]) >= 2:
            candidates.append((("rank", r), rank_cells[r]))
    for link in sorted(link_cells):
        candidates.append((("link", link), link_cells[link]))
    return candidates


def attribute_window(verdicts: Sequence[Verdict],
                     window=None, n_ranks: Optional[int] = None,
                     cfg: Optional[AttributionConfig] = None,
                     backend: Optional[str] = None,
                     device=None,
                     d: Optional[np.ndarray] = None,
                     w: Optional[np.ndarray] = None) -> Attribution:
    """Attribute one window's verdicts to a ranked culprit set.

    Direct verdicts (hang / non-comm slow / divergence) become rank
    culprits immediately.  Comm-slow verdicts trigger the matrix cover:
    ``d``/``w`` may be passed pre-computed, else they are derived from
    ``window`` — and only when slow verdicts actually exist, so enabling
    attribution costs nothing on clean or hang-only windows.
    """
    cfg = cfg if cfg is not None else AttributionConfig()
    window_id = getattr(window, "window_id", 0) if window is not None else 0
    att = Attribution(window_id=window_id)

    direct: Dict[int, float] = {}
    slow = []
    for v in verdicts:
        if v.syndrome in _DIRECT_SYNDROMES and v.rank is not None:
            direct[v.rank] = max(direct.get(v.rank, 0.0), float(v.score))
        elif v.syndrome not in _DIRECT_SYNDROMES:
            slow.append(v)
    for r, score in sorted(direct.items(), key=lambda kv: (-kv[1], kv[0])):
        att.culprits.append(Culprit("rank", rank=r, score=score))

    if not slow:
        return att
    if d is None or w is None:
        if window is None:
            return att
        n = n_ranks or window.n_ranks()
        d = (delay_matrix(window, n, backend=backend, device=device)
             if d is None else d)
        w = (wait_matrix(window, n, backend=backend, device=device)
             if w is None else w)
    n = n_ranks or d.shape[0]

    hot = _hot_cells(d, w, cfg.mad_threshold)
    att.hot_cells = len(hot)
    att.total_weight = sum(hot.values())
    if not hot:
        return att

    candidates = _candidate_cells(n, hot)
    uncovered = set(hot)
    matrix_picks = 0
    while uncovered and len(att.culprits) < cfg.max_culprits:
        best = None
        best_key = None
        for ident, cells in candidates:
            gain_cells = cells & uncovered
            if not gain_cells:
                continue
            gain = sum(hot[c] for c in gain_cells)
            # deterministic preference: weight, then rank-over-link
            # (ranks are the actionable unit), then smallest id
            key = (-gain, 0 if ident[0] == "rank" else 1, ident[1])
            if best_key is None or key < best_key:
                best, best_key = (ident, gain_cells, gain), key
        if best is None:
            break
        (kind, ident), gain_cells, gain = best
        if matrix_picks > 0 and gain < cfg.min_coverage * att.total_weight:
            break
        if kind == "rank":
            att.culprits.append(Culprit(
                "rank", rank=ident, score=gain, cells=len(gain_cells),
                coverage=gain / att.total_weight))
        else:
            att.culprits.append(Culprit(
                "link", link=ident, score=gain, cells=len(gain_cells),
                coverage=gain / att.total_weight))
        uncovered -= gain_cells
        matrix_picks += 1
    att.explained_cells = att.hot_cells - len(uncovered)
    return att
