"""The torch backend of the detection loop, and the backend switch.

Counterpart of ``repro.core.jaxsim``'s registry. The grouped medians, the
composite detector and the water-filling of ``FlowSet.max_min`` exist twice:

  * the NumPy implementations in ``core/c4d`` and ``core/flowset`` (copies
    of the reference's) — the oracle every parity test is written against;
  * the torch paths: the detection pipeline in this package (``detectors``)
    over ``kernels/csrc/window_score.cu`` and ``kernels/csrc/slow_fold.cu``,
    and the filling loop over ``kernels/csrc/waterfill.cu``; the plain
    float64/int64 versions are re-exported by ``kernels`` here, beside the
    EWMA baseline scan (``kernels/csrc/ewma_scan.cu``).

This module resolves which backend a call uses, without importing torch.

Resolution order for ``resolve_backend(None)``:

  1. an explicit ``use_backend(...)`` / ``set_default_backend(...)`` scope,
  2. the ``REPRO_TORCH_SIM_BACKEND`` environment variable,
  3. ``"torch"`` — the port runs its own path unless the caller asks for the
     NumPy oracle.
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional, Tuple

#: the selectable backends. ``"auto"`` picks per call site by problem size:
#: NumPy below the measured crossover, torch from it up.
BACKENDS: Tuple[str, ...] = ("numpy", "torch", "auto")

#: environment override consulted when no explicit scope is active.
BACKEND_ENV = "REPRO_TORCH_SIM_BACKEND"

_default_backend: Optional[str] = None       # set_default_backend / use_backend


class BackendError(ValueError):
    """Unknown simulator backend."""


def _validate(name: str) -> str:
    name = name.strip().lower()
    if name not in BACKENDS:
        raise BackendError(
            f"unknown simulator backend {name!r}; choose from {BACKENDS}")
    return name


def get_default_backend() -> str:
    """The backend used when a call site passes ``backend=None``."""
    if _default_backend is not None:
        return _default_backend
    env = os.environ.get(BACKEND_ENV)
    if env:
        return _validate(env)
    return "torch"


def set_default_backend(name: Optional[str]) -> None:
    """Set (or with ``None`` clear) the process-wide default backend."""
    global _default_backend
    _default_backend = _validate(name) if name is not None else None


@contextlib.contextmanager
def use_backend(name: Optional[str]) -> Iterator[str]:
    """Scoped default backend; ``None`` leaves the current default as it is."""
    global _default_backend
    if name is None:
        yield get_default_backend()
        return
    prev = _default_backend
    _default_backend = _validate(name)
    try:
        yield _default_backend
    finally:
        _default_backend = prev


def resolve_backend(name: Optional[str] = None) -> str:
    """Fold an optional per-call ``backend=`` argument against the default."""
    return get_default_backend() if name is None else _validate(name)


# Size thresholds of backend="auto", from the crossovers that
# ``chip_smoke.py``'s ``[detect]`` phase measures on an H100 host (warm
# layouts, as in a steady stream; PERF.md): NumPy's composite beat the card
# at 64 ranks and lost from 128 up; the card's grouped median won at every
# size measured, from 4,096 elements up (smaller sizes not measured).

#: detector windows: NumPy below, torch from this many ranks up.
AUTO_DETECT_RANKS = 128

#: grouped-median calls keyed by element count (telemetry prefilter).
AUTO_MEDIAN_ELEMENTS = 1 << 12

#: water-filling (``FlowSet.max_min``) keyed by flow count: from
#: ``chip_smoke.py``'s ``[fabric]`` crossover of the card's whole call
#: (copies and the NumPy epilogue included) against the NumPy loop, on the
#: Fig. 2 scenario from 128 to 20,480 flows: NumPy won at 128; at 256 and
#: 512 the two were within the host clock's spread, the card ahead by the
#: median of four calls; from 1,024 the card won every call, 2.6–4.4x at
#: 2,048 and 25–30x at 20,480.
AUTO_WATERFILL_FLOWS = 256


def effective_backend(name: Optional[str] = None, *,
                      ranks: Optional[int] = None,
                      elements: Optional[int] = None,
                      flows: Optional[int] = None) -> str:
    """Resolve ``name`` to a concrete backend (``"numpy"``/``"torch"``).

    Non-auto names resolve exactly like ``resolve_backend``. ``"auto"``
    compares whichever size hint the call site supplies against that call
    site's threshold."""
    resolved = resolve_backend(name)
    if resolved != "auto":
        return resolved
    if ranks is not None and ranks >= AUTO_DETECT_RANKS:
        return "torch"
    if elements is not None and elements >= AUTO_MEDIAN_ELEMENTS:
        return "torch"
    if flows is not None and flows >= AUTO_WATERFILL_FLOWS:
        return "torch"
    return "numpy"
