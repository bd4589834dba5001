"""Trainer-side C4D hooks: BSP step-time telemetry.

The port's own copy of ``repro.train.hooks``. The per-step wall clock at the
step boundary is the BSP anchor the paper uses ("synchronization points are
used as anchors for measuring anomalies"). The monitor keeps robust rolling
statistics and flags steps whose duration deviates: the median/MAD rule of
the C4D detectors, at step granularity. The caller stops the clock after the
step's result has reached the host (the Trainer reads the loss first), so on
a CUDA device the duration is the device's, not the time to enqueue.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class StepStat:
    step: int
    duration_s: float
    z: float
    anomalous: bool


class StepMonitor:
    def __init__(self, window: int = 64, mad_threshold: float = 6.0,
                 warmup_steps: int = 3):
        self.window = window
        self.mad_threshold = mad_threshold
        self.warmup = warmup_steps
        self.durations: List[float] = []
        self.stats: List[StepStat] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> StepStat:
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        hist = np.array(self.durations[-self.window:]) if self.durations else np.array([dt])
        med = float(np.median(hist))
        mad = float(np.median(np.abs(hist - med))) * 1.4826 + 1e-9
        z = (dt - med) / mad
        anomalous = len(self.durations) >= self.warmup and z > self.mad_threshold
        self.durations.append(dt)
        st = StepStat(step, dt, z, anomalous)
        self.stats.append(st)
        return st

    def summary(self) -> dict:
        d = np.array(self.durations)
        if d.size == 0:
            return {}
        return {"steps": int(d.size), "median_s": float(np.median(d)),
                "p95_s": float(np.percentile(d, 95)),
                "anomalies": int(sum(s.anomalous for s in self.stats))}
