"""The simulator kernels' plain PyTorch versions, and the EWMA scan's entry.

Counterpart of ``repro.core.jaxsim.kernels``. The functions live in the
kernel package (``repro_torch.kernels.detect_ref``), beside the CUDA
kernels' wrappers that compute them on CPU tensors; this module re-exports
them so that each has its counterpart where the JAX package keeps it.
``ewma_scan`` is the entry of ``ewma_scan_kernel``'s port: it puts its
inputs on a device and runs ``kernels/csrc/ewma_scan.cu`` there.
"""
import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels import ewma_scan as _ewma
from repro_torch.kernels.detect_ref import (PAD_KEY, batched_hang,  # noqa: F401
                                            batched_pair_median, ewma_scan_ref,
                                            fused_window_kernel, grouped_median_kernel, hang,
                                            padded_rows, pair_median, row_median,
                                            slow_fold_kernel)


_NUMPY = {torch.float64: np.float64, torch.int64: np.int64}


def _on(dev: torch.device, x, dtype: torch.dtype) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=_NUMPY[dtype]))
    return x.to(device=dev, dtype=dtype).contiguous()


def ewma_scan(values, mean0, dev0, count0, alpha: float, clip_sigma: float, device=None):
    """``AdaptiveBaseline.update`` scanned over the W windows of ``values``
    (W, E), NaN where a cell was not seen, from the carry ``mean0``,
    ``dev0``, ``count0`` (E): arrays or tensors. Returns (mean, dev, count)
    as tensors on ``device`` (``None``: the card, raising without one;
    ``"cpu"``: the plain version). Within 1e-9 of the NumPy class, with
    ``count`` exact."""
    dev = resolve_device(device)
    return _ewma.ewma_scan(_on(dev, values, torch.float64), _on(dev, mean0, torch.float64),
                           _on(dev, dev0, torch.float64), _on(dev, count0, torch.int64),
                           alpha, clip_sigma)
