"""Argument checks and the launch stream shared by the detection kernels'
wrappers (``window_score.py``, ``slow_fold.py``)."""
from __future__ import annotations

import torch


def require(name: str, t, dtype: torch.dtype, dim: int, device: torch.device) -> None:
    """``t`` is a contiguous tensor of ``dtype`` with ``dim`` dims on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype or t.dim() != dim:
        raise TypeError(f"{name}: {t.dtype} of {t.dim()} dims; expected {dtype} of {dim}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the other inputs on {device}")


def stream_of(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
