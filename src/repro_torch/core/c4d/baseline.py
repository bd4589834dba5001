"""Adaptive per-rank/per-link baselines for the C4D detectors.

Copy of ``repro.core.c4d.baseline``; the port's detector backend reads it
through ``cell_stats`` and ``update_cells``.

The streaming runs measured what the paper never reports: the pure
cross-sectional robust-z (one window, median/MAD across ranks) fires on
jitter in ~4-7 % of healthy 32-64-rank windows.  The fix is the classic
production-detector move: normalise every cell of the delay/wait matrices
(and every rank's heartbeat deficit) against *its own history* instead of
the single-window cross-section.

Each tracked quantity keeps an exponentially-weighted mean and an
exponentially-weighted mean-absolute-deviation per cell:

    alpha  = 1 - 2^(-1 / half_life)          (half_life in windows)
    dev_t  = (1-alpha) * dev_{t-1} + alpha * |x_t - mean_{t-1}|
    mean_t = (1-alpha) * mean_{t-1} + alpha * x_t
    z_t    = (x_t - mean_{t-1}) / (1.2533 * dev_{t-1} + eps)

1.2533 (= sqrt(pi/2)) converts a mean absolute deviation to a normal
sigma, mirroring the 1.4826 MAD factor of the cross-sectional path.

Two guards keep the estimator honest:

  * **warm-up** — a cell's adaptive z is only trusted after
    ``warm_windows`` observations; before that the caller's cross-sectional
    z is used as the fallback.  The very first observation seeds ``dev``
    with the window's *population* scatter (mean |x - median| over the
    finite cells), so a lucky pair of near-identical early samples cannot
    collapse the scale and manufacture false positives.
  * **winsorized updates** — each window's contribution to a cell is
    clipped at ``clip_sigma`` scale units.  Excluding hot cells outright
    would truncation-bias the healthy estimate low (the high jitter tail
    never enters, so the scale shrinks and manufactures false positives);
    clipping instead lets every cell update while a live fault bleeds into
    its own baseline at a bounded ~``alpha * clip_sigma`` sigma per window
    — slow enough that the confirmation streak fires long before the
    fault "heals" itself.

``AdaptiveBaseline`` is owned by ``c4d.master.C4DMaster`` (one per
streaming master, living exactly as long as its confirmation streaks) and
threaded through ``C4DDetector.analyze``; the cross-sectional single-window
path stays pinned and byte-identical when no baseline is supplied.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

#: mean-absolute-deviation -> sigma for a normal distribution, sqrt(pi/2).
MEANAD_TO_SIGMA = 1.2533


class AdaptiveBaseline:
    """EWMA mean / EWMA mean-abs-deviation per delay cell, wait cell and
    per-rank heartbeat deficit."""

    #: tracked matrix quantities (shape (n, n)); heartbeat deficits are the
    #: separate per-rank vector ``"hb"``.
    MATRIX_KINDS = ("delay", "wait")

    def __init__(self, n_ranks: int, half_life: float = 16.0,
                 warm_windows: int = 3, clip_sigma: float = 3.0):
        if half_life <= 0:
            raise ValueError("half_life must be positive (use "
                             "operating_point.baseline_half_life = 0 to "
                             "disable adaptive baselines)")
        self.n = int(n_ranks)
        self.half_life = float(half_life)
        self.alpha = 1.0 - 2.0 ** (-1.0 / self.half_life)
        self.warm_windows = int(warm_windows)
        self.clip_sigma = float(clip_sigma)
        shapes = {"delay": (self.n, self.n), "wait": (self.n, self.n),
                  "hb": (self.n,)}
        self._mean: Dict[str, np.ndarray] = {
            k: np.zeros(s) for k, s in shapes.items()}
        self._dev: Dict[str, np.ndarray] = {
            k: np.zeros(s) for k, s in shapes.items()}
        self._count: Dict[str, np.ndarray] = {
            k: np.zeros(s, dtype=np.int64) for k, s in shapes.items()}

    # ------------------------------------------------------------------
    def warm(self, kind: str) -> np.ndarray:
        """Cells with enough history for the adaptive z to be trusted."""
        return self._count[kind] >= self.warm_windows

    def z(self, kind: str, values: np.ndarray,
          fallback: Optional[np.ndarray] = None) -> np.ndarray:
        """Adaptive z where warm, ``fallback`` (the caller's cross-sectional
        z) elsewhere.  NaN inputs stay NaN."""
        mean, dev = self._mean[kind], self._dev[kind]
        scale = (MEANAD_TO_SIGMA * dev
                 + 1e-12 * np.maximum(np.abs(mean), 1e-12) + 1e-30)
        z = (values - mean) / scale
        use = self.warm(kind) & np.isfinite(values)
        if fallback is None:
            fallback = np.full_like(z, np.nan)
        return np.where(use, z, fallback)

    def deficit_offset(self, ranks: np.ndarray) -> np.ndarray:
        """Learned per-rank heartbeat deficit (0 where not yet warm) — a
        rank that is always half a heartbeat behind is its own normal."""
        mean = self._mean["hb"][ranks]
        return np.where(self.warm("hb")[ranks], mean, 0.0)

    def cell_stats(self, kind: str, rows: np.ndarray, cols: np.ndarray
                   ) -> tuple:
        """(mean, dev, count) gathered at individual matrix cells.

        The sparse access path of the torch detector backend
        (``torchsim.detectors``): at fleet scale the window only touches
        O(pairs) cells, so the backend gathers those instead of shipping
        the dense matrices to the device."""
        return (self._mean[kind][rows, cols], self._dev[kind][rows, cols],
                self._count[kind][rows, cols])

    # ------------------------------------------------------------------
    def update(self, kind: str, values: np.ndarray,
               exclude: Optional[np.ndarray] = None) -> None:
        """Fold one window into ``kind``'s baseline (winsorized EWMA).

        ``exclude`` skips cells outright (used for confirmed-hung ranks,
        whose deficits are not a statistic at all); ordinary anomaly
        robustness comes from the ``clip_sigma`` winsorization instead."""
        finite = np.isfinite(values)
        ok = finite if exclude is None else finite & ~exclude
        if not ok.any():
            return
        mean, dev, count = self._mean[kind], self._dev[kind], self._count[kind]
        first = ok & (count == 0)
        if first.any():
            pool = values[finite]
            seed_dev = float(np.mean(np.abs(pool - np.median(pool))))
            mean[first] = values[first]
            dev[first] = seed_dev
        rest = ok & (count > 0)
        if rest.any():
            a = self.alpha
            lim = self.clip_sigma * (MEANAD_TO_SIGMA * dev
                                     + 1e-12 * np.maximum(np.abs(mean), 1e-12)
                                     + 1e-30)
            delta = np.clip(values - mean, -lim, lim)
            err = np.abs(delta)
            dev[rest] = (1.0 - a) * dev[rest] + a * err[rest]
            mean[rest] = mean[rest] + a * delta[rest]
        count[ok] += 1

    def update_cells(self, kind: str, rows: np.ndarray, cols: np.ndarray,
                     values: np.ndarray) -> None:
        """Sparse twin of ``update``: fold one window whose observed cells
        are exactly ``(rows, cols)`` (each cell at most once, ``values``
        all finite, cells in row-major order).

        Bit-identical to calling ``update(kind, dense)`` with a matrix
        that is NaN everywhere else: the first-observation seed pool is
        the same row-major value vector, and the winsorized EWMA step is
        elementwise.  Used by the torch detector backend, where the dense
        (n, n) window matrix is never materialised."""
        if rows.size == 0:
            return
        mean, dev, count = self._mean[kind], self._dev[kind], self._count[kind]
        c = count[rows, cols]
        first = c == 0
        if first.any():
            seed_dev = float(np.mean(np.abs(values - np.median(values))))
            mean[rows[first], cols[first]] = values[first]
            dev[rows[first], cols[first]] = seed_dev
        rest = ~first
        if rest.any():
            a = self.alpha
            rr, cc = rows[rest], cols[rest]
            m, dv = mean[rr, cc], dev[rr, cc]
            lim = self.clip_sigma * (MEANAD_TO_SIGMA * dv
                                     + 1e-12 * np.maximum(np.abs(m), 1e-12)
                                     + 1e-30)
            delta = np.clip(values[rest] - m, -lim, lim)
            dev[rr, cc] = (1.0 - a) * dv + a * np.abs(delta)
            mean[rr, cc] = m + a * delta
        count[rows, cols] = c + 1

    def update_deficit(self, ranks: np.ndarray, deficits: np.ndarray,
                       exclude: Optional[np.ndarray] = None) -> None:
        """Scatter per-rank heartbeat deficits into the ``"hb"`` vector."""
        values = np.full(self.n, np.nan)
        keep = ranks < self.n
        values[ranks[keep]] = deficits[keep]
        mask = None
        if exclude is not None:
            mask = np.zeros(self.n, dtype=bool)
            mask[ranks[keep & exclude]] = True
        self.update("hb", values, exclude=mask)
