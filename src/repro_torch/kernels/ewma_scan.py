"""The EWMA baseline scan: the wrapper of ``csrc/ewma_scan.cu``.

Port of the XLA jit kernel ``repro.core.jaxsim.kernels.ewma_scan_kernel``.
On CUDA tensors ``ewma_scan`` launches the kernel (two launches on the
stream, or raises, never falling back); on CPU tensors it computes the plain
version ``detect_ref.ewma_scan_ref``. ``launches`` counts the calls that
launched. The windows' medians take one of two paths (``PATHS``): the
window in shared memory, a cluster of CTAs a window, or, where a window
does not fit there, read from L2 by a CTA a window; the kernel picks by the
number of cells (``path_for``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import detect_ref as plain
from repro_torch.kernels.checks import launch_on, require, stream_of

launches = 0
#: the pool's paths (csrc/ewma_scan.cu: path; 0 picks by the cells)
PATHS = {"smem": 1, "l2": 2}

_fn = None
_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("ewma_scan").ewma_scan
        fn.argtypes = [_P, _I, _I, _P, _P, _P, _D, _D, _P, _P, _P, _P, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def path_for(n_cells: int, device) -> str:
    """The path the kernel takes for windows of ``n_cells`` on ``device``."""
    fn = _build.load("ewma_scan").ewma_scan_path
    fn.argtypes, fn.restype = [_I], ctypes.c_int
    with torch.cuda.device(device):
        code = fn(n_cells)
    if code < 0:
        raise RuntimeError(f"ewma_scan: the card could not be asked (CUDA error {-code})")
    return {v: k for k, v in PATHS.items()}[code]


def ewma_scan(values, mean0, dev0, count0, alpha: float, clip_sigma: float):
    """values (W, E) float64 (NaN: not seen); mean0, dev0 (E) float64;
    count0 (E) int64. Returns (mean, dev, count) after the W windows."""
    global launches
    if not isinstance(values, torch.Tensor) or values.dtype != torch.float64 \
            or values.dim() != 2:
        raise TypeError("values must be a float64 tensor (W, E)")
    dev = values.device
    require("values", values, torch.float64, 2, dev)
    require("mean0", mean0, torch.float64, 1, dev)
    require("dev0", dev0, torch.float64, 1, dev)
    require("count0", count0, torch.int64, 1, dev)
    w, e = values.shape
    if not mean0.shape == dev0.shape == count0.shape == (e,):
        raise ValueError(f"carry shapes {tuple(mean0.shape)}, {tuple(dev0.shape)}, "
                         f"{tuple(count0.shape)} for {e} cells")
    if dev.type == "cpu":
        return plain.ewma_scan_ref(values, mean0, dev0, count0, alpha, clip_sigma)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty((2, e), dtype=torch.float64, device=dev)
    count = torch.empty(e, dtype=torch.int64, device=dev)
    pool = torch.empty(2 * w, dtype=torch.float64, device=dev)
    err = launch_on(values, _fn or _kernel(), values.data_ptr(), w, e, mean0.data_ptr(),
                    dev0.data_ptr(), count0.data_ptr(), float(alpha), float(clip_sigma),
                    out[0].data_ptr(), out[1].data_ptr(), count.data_ptr(), pool.data_ptr(),
                    0, stream_of(values))
    if err != 0:
        raise RuntimeError(f"ewma_scan launch failed: CUDA error {err}")
    launches += 1
    return out[0], out[1], count
