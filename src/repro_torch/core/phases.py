"""Shared time units and the paper's Table-3 downtime phase taxonomy.

One place for the constants that were historically duplicated between the
month-scale downtime simulation (``core/downtime.py``) and the scenario
campaign engine (``scenarios/engine.py``): every consumer — downtime
accounting, the runtime ``DowntimeService``, campaign statistics — keys its
phase breakdown off ``PHASE_KEYS`` so the four phases cannot drift apart.

Paper Fig. 1 / Table 3: downtime per error decomposes into detection,
diagnosis & isolation, post-checkpoint lost work, and re-initialisation.
"""
from __future__ import annotations

MINUTES = 60.0
HOURS = 3600.0
DAYS = 24 * HOURS

# report-dict keys, in the paper's presentation order (suffixed _s: seconds)
PHASE_KEYS = ("detection_s", "diagnosis_isolation_s",
              "post_checkpoint_s", "re_initialization_s")

# human-readable labels (used by fraction breakdowns and rendered tables)
PHASE_LABELS = {
    "detection_s": "detection",
    "diagnosis_isolation_s": "diagnosis_isolation",
    "post_checkpoint_s": "post_checkpoint",
    "re_initialization_s": "re_initialization",
}


def zero_phases() -> dict:
    """A fresh phase accumulator: every Table-3 phase at 0.0 seconds."""
    return {k: 0.0 for k in PHASE_KEYS}
