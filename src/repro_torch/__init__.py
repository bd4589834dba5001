"""PyTorch + CUDA port of the ``repro`` package, for one NVIDIA H100.

Module names mirror ``repro`` so each counterpart is easy to find. The port
imports ``torch`` only; it never imports ``jax`` or ``repro``.

Every entry point takes a ``device`` argument. Left at ``None`` it means
``cuda``: without a GPU the call raises, it never drops to the CPU on its own.
The CPU is used only when the caller asks for it (``device="cpu"``), which is
what the CPU tests do. ``device="meta"`` (shapes and dtypes, no storage) builds
a model to count it without weights, as the dry run does
(``repro_torch.launch.dryrun``); nothing falls back to it either.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``. Raises when CUDA is asked for and absent.
    ``cpu`` and ``meta`` only when named."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
