"""Model facade: build the LM, and the shapes and values of its inputs.

Port of the serving part of ``repro.models.model``. ``synthetic_batch`` draws
token ids with numpy's ``default_rng`` exactly as the JAX package does, so a
seed gives both packages the same ids.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.common.config import ModelConfig, RunConfig, ShapeSpec
from repro_torch.models.transformer import LM

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_model(run: RunConfig, device=None, use_kernel: bool = True) -> LM:
    """An ``LM`` with uninitialised weights: call ``init_weights`` or load a
    state dict (``repro_torch.convert``)."""
    return LM(run.model, param_dtype=DTYPES[run.parallel.param_dtype], device=device,
              use_kernel=use_kernel)


def batch_shapes(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Shapes/dtypes for one step's inputs, as (shape, dtype) tuples. Only
    token inputs: the audio and vision front ends are not ported yet."""
    s_in = 1 if shape.kind == "decode" else shape.seq_len
    return {"tokens": ((shape.global_batch, s_in), torch.int32)}


def synthetic_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0, device=None):
    """Concrete random batch (for smoke tests / examples)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dt) in batch_shapes(cfg, shape).items():
        ids = rng.integers(0, cfg.vocab_size, size=shp).astype(np.int32)
        out[k] = torch.from_numpy(ids).to(device=dev, dtype=dt)
    return out
