"""Deterministic, seed-addressable synthetic data pipeline.

The port's own copy of ``repro.data.pipeline`` (numpy only): token ids,
codebook labels, the audio family's frame embeddings and the vlm family's
``vision_embed`` (floats are float32 here; the model casts them to its
``param_dtype``). ``batch(step)`` is a pure function of (seed, step): a
counter-based Philox generator keyed ``(step << 8) + salt``, the salt the
input's place in name order (``tokens`` 0, ``vision_embed`` 1), so a job
restarted from checkpoint step k consumes the exact same
stream from k on, and a seed gives the same bytes as the JAX package's
pipeline. ``host_batch`` is the slice of the global batch that one host
loads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from repro_torch.common.config import ModelConfig, ShapeSpec
from repro_torch.models.model import batch_shapes


@dataclass
class PipelineConfig:
    seed: int = 0
    n_hosts: int = 1


class TokenPipeline:
    """step -> batch dict of numpy arrays (tokens / labels / embeddings)."""

    def __init__(self, model: ModelConfig, shape: ShapeSpec,
                 cfg: Optional[PipelineConfig] = None):
        self.model = model
        self.shape = shape
        self.cfg = cfg or PipelineConfig()
        self.spec = batch_shapes(model, shape)

    def _rng(self, step: int, salt: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            np.random.Philox(key=self.cfg.seed, counter=(step << 8) + salt))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        out = {}
        for i, (name, (shp, dt)) in enumerate(sorted(self.spec.items())):
            rng = self._rng(step, salt=i)
            if "int" in str(dt):
                out[name] = rng.integers(
                    0, self.model.vocab_size, size=shp).astype(np.int32)
            else:
                out[name] = rng.normal(0, 1, size=shp).astype(np.float32)
        return out

    def host_batch(self, step: int, host: int) -> Dict[str, np.ndarray]:
        """The slice of the global batch that ``host`` loads (sharded I/O)."""
        full = self.batch(step)
        n = self.cfg.n_hosts
        out = {}
        for k, v in full.items():
            b = v.shape[0]
            if b % n:
                raise ValueError(f"{k}: batch {b} does not split over {n} hosts")
            sl = b // n
            out[k] = v[host * sl: (host + 1) * sl]
        return out
