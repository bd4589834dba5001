"""Divergence detection over training-side signals (Flare-style channel).

The comm-syndrome detectors (``c4d.detector``) see *slow* and *hang* on the
transport layer; they are structurally blind to anomalies that never touch
the network.  Flare (arXiv 2502.05413) catches exactly those by watching
the training signals themselves: a rank whose gradient norm drifts away
from its peers (silent data corruption), a rank whose loss spikes while
the others keep descending, and a rank producing NaN/Inf (overflow events
under mixed precision).  This module is the C4D adaptation: per-window
cross-sectional analysis of the ``TrainSignals`` channel exported next to
the enhanced-CCL telemetry (``telemetry.TrainSignals``).

Three new syndromes, analysed per rank per window:

  * ``divergence_overflow`` — any rank reporting >= ``overflow_events``
    NaN/Inf events.  Unrecoverable under BSP (the corrupt value allreduces
    into every replica), so the master acts on it immediately, like a hang.
  * ``divergence_grad``     — robust z of the *log* gradient norm above
    ``grad_z`` (multiplicative drift is additive in log space), gated by a
    minimum ratio to the cross-rank median.
  * ``divergence_loss``     — robust z of the per-rank loss above
    ``loss_z``, with the analogous ratio gate.

The ratio gates are the precision mechanism: a hard batch raises *every*
rank's loss together (the z-scores stay small), and ordinary data jitter
moves a rank a few percent off the median — far below the 1.5-2x gates —
so a fault-free stream confirms nothing, by construction, at the shipped
thresholds (pinned over 240+ healthy windows in tests/test_divergence.py).
BSP homogeneity is doing the same work it does for the comm matrices: all
data-parallel ranks process statistically identical shards, so a sustained
one-rank deviation is a hardware/data symptom, not load imbalance.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.c4d.detector import Verdict, _robust_z
from repro_torch.core.c4d.telemetry import TrainSignals

# divergence syndrome kinds (extend detector's comm syndromes)
DIVERGENCE_LOSS = "divergence_loss"
DIVERGENCE_GRAD = "divergence_grad"
DIVERGENCE_OVERFLOW = "divergence_overflow"
DIVERGENCE_SYNDROMES = (DIVERGENCE_LOSS, DIVERGENCE_GRAD,
                        DIVERGENCE_OVERFLOW)


@dataclass
class DivergenceConfig:
    """Shipped operating point of the divergence detector.

    ``loss_z``/``grad_z`` are robust (median/MAD) z thresholds, matching
    the comm detectors' ``mad_threshold`` convention; ``min_loss_ratio``/
    ``min_grad_ratio`` additionally require the rank to sit that far above
    the cross-rank *median* — the gate that keeps whole-fleet shifts (a
    hard batch) and small-sample MAD blowups from ever confirming on a
    healthy stream."""
    loss_z: float = 6.0
    grad_z: float = 6.0
    min_loss_ratio: float = 1.5
    min_grad_ratio: float = 2.0
    overflow_events: int = 1


def _own_cfg(cfg: Optional[DivergenceConfig]) -> DivergenceConfig:
    return cfg if cfg is not None else DivergenceConfig()


class DivergenceDetector:
    """Per-window divergence analysis; one verdict max per rank, with
    overflow > grad > loss severity precedence (an overflowing rank's grad
    norm is garbage — report the cause, not the symptom)."""

    def __init__(self, cfg: Optional[DivergenceConfig] = None):
        self.cfg = _own_cfg(cfg)

    def analyze(self, train: Optional[TrainSignals]) -> List[Verdict]:
        if train is None or train.rank.size == 0:
            return []
        cfg = self.cfg
        loss = np.asarray(train.loss, float)
        grad = np.asarray(train.grad_norm, float)
        finite_l = loss[np.isfinite(loss)]
        finite_g = grad[np.isfinite(grad)]
        med_l = float(np.median(finite_l)) if finite_l.size else np.nan
        med_g = float(np.median(finite_g)) if finite_g.size else np.nan
        zl = _robust_z(loss)
        zg = _robust_z(np.log(np.maximum(grad, 1e-30)))

        overflow = np.asarray(train.overflow) >= cfg.overflow_events
        grad_hot = ((zg > cfg.grad_z) & np.isfinite(grad)
                    & (grad > cfg.min_grad_ratio * med_g))
        loss_hot = ((zl > cfg.loss_z) & np.isfinite(loss)
                    & (loss > cfg.min_loss_ratio * med_l))

        verdicts: List[Verdict] = []
        for i in range(train.rank.size):
            r = int(train.rank[i])
            if overflow[i]:
                verdicts.append(Verdict(
                    DIVERGENCE_OVERFLOW, rank=r,
                    score=float(train.overflow[i]),
                    detail=f"{int(train.overflow[i])} overflow/NaN events"))
            elif grad_hot[i]:
                verdicts.append(Verdict(
                    DIVERGENCE_GRAD, rank=r, score=float(zg[i]),
                    detail=f"grad {grad[i]:.3g} vs median {med_g:.3g}"))
            elif loss_hot[i]:
                verdicts.append(Verdict(
                    DIVERGENCE_LOSS, rank=r, score=float(zl[i]),
                    detail=f"loss {loss[i]:.3g} vs median {med_l:.3g}"))
        return verdicts
