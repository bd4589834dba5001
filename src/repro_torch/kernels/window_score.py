"""Window scoring and grouped medians: the wrappers of ``csrc/window_score.cu``.

Port of the XLA jit kernels ``repro.core.jaxsim.kernels.fused_window_kernel``
(``window_score``) and ``grouped_median_kernel`` (``row_select``, the
prefilter's medians). On CUDA tensors each entry launches the kernel (or
raises, never falling back); on CPU tensors it computes the plain version
(``detect_ref``). ``launches`` counts, by entry, the calls that launched.

The layout (``order``, ``starts``, ``counts``, and for a window ``gkey``) is
the host-made grouping of the transport keys
(``core.torchsim.detectors._WindowLayout``): a batch of size 1 is shared by
every window. ``large`` lists the groups of more than ``SMALL_GROUP`` samples
and ``max_count`` is the largest group (or any bound above it: it picks the
kernel's tiers); both come from the layout on the host, so the wrapper needs no
device reduction for them. Values are any float64 (negative, signed zeros,
infinities, NaN), groups of any size, and a call any number of windows.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import detect_ref as plain
from repro_torch.kernels.checks import require, stream_of

launches = {"window_score": 0, "row_select": 0}
SMALL_GROUP = 16     # csrc/window_score.cu: ws_small_group(), groups a thread takes
WARP_GROUP = 512     # csrc/window_score.cu: ws_warp_group(), groups a warp takes; larger: a CTA

_fns: Dict[str, object] = {}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
_ARGTYPES = {
    "ws_row_select": [_P, _I, _I, _I, _P, _I, _P, _P, _I, _I, _P, _I, _I, _P, _P],
    "ws_window": [_P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _I, _P, _D, _I,
                  _P, _P, _P, _P, _P, _P, _P, _P, _P],
}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("window_score"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check_layout(values, order, starts, counts, large) -> None:
    if not isinstance(values, torch.Tensor) or values.dtype != torch.float64 \
            or values.dim() != 3:
        raise TypeError("values must be a float64 tensor (B, V, T)")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {values.device}")
    if not values.is_contiguous():
        raise ValueError("values must be contiguous")
    b, _, t = values.shape
    dev = values.device
    for name, x in (("order", order), ("starts", starts), ("counts", counts)):
        require(name, x, torch.int64, 2, dev)
        if x.shape[0] not in (1, b):
            raise ValueError(f"{name} has batch {x.shape[0]} for {b} windows")
    if order.shape[1] != t or starts.shape != counts.shape:
        raise ValueError(f"layout shapes order {tuple(order.shape)}, starts "
                         f"{tuple(starts.shape)}, counts {tuple(counts.shape)} for T={t}")
    require("large", large, torch.int64, 1, dev)


def _bstride(x: torch.Tensor) -> int:
    return 0 if x.shape[0] == 1 else x.shape[1]


def row_select(values, order, starts, counts, *, large, max_count: int) -> torch.Tensor:
    """Per-group medians of each of V value arrays: values (B, V, T) float64
    -> (V, B, G) float64 (+inf for an empty group), bit-equal to NumPy's
    stable lexsort fold."""
    _check_layout(values, order, starts, counts, large)
    if values.device.type == "cpu":
        return plain.row_median(values, order, starts, counts)
    b, v, t = values.shape
    g = starts.shape[1]
    out = torch.empty((v, b, g), dtype=torch.float64, device=values.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(values.device):
        err = _kernel("ws_row_select")(
            values.data_ptr(), b, v, t, order.data_ptr(), _bstride(order), starts.data_ptr(),
            counts.data_ptr(), _bstride(starts), g, large.data_ptr(), large.numel(), max_count,
            out.data_ptr(), stream_of(values))
    if err != 0:
        raise RuntimeError(f"window_score row select launch failed: CUDA error {err}")
    launches["row_select"] += 1
    return out


def window_score(values, order, starts, counts, gkey, hb_rank, hb_seq, offsets,
                 hang_grace: float, *, n: int, large, max_count: int) -> Dict[str, torch.Tensor]:
    """A batch of windows: values (B, 2, T) delay and wait; heartbeats (B, H);
    offsets (B, n). Returns dmed, wmed (B, G); present, seqs, deficit, hung,
    is_src (B, n); med (B,)."""
    _check_layout(values, order, starts, counts, large)
    b, v, t = values.shape
    dev = values.device
    if v != 2:
        raise ValueError(f"values must hold delay and wait (B, 2, T), not V={v}")
    g = starts.shape[1]
    require("gkey", gkey, torch.int64, 2, dev)
    if gkey.shape != starts.shape:
        raise ValueError("gkey must have the layout's group shape")
    for name, x in (("hb_rank", hb_rank), ("hb_seq", hb_seq)):
        require(name, x, torch.int64, 2, dev)
    if hb_rank.shape != hb_seq.shape or hb_rank.shape[0] != b:
        raise ValueError("heartbeat arrays must be (B, H) alike")
    require("offsets", offsets, torch.float64, 2, dev)
    if n <= 0 or offsets.shape != (b, n):
        raise ValueError(f"offsets {tuple(offsets.shape)}, expected {(b, n)}")
    if dev.type == "cpu":
        return plain.fused_window_kernel(values, order, starts, counts, gkey, hb_rank, hb_seq,
                                         offsets, hang_grace, n=n)
    medians = torch.empty((2, b, g), dtype=torch.float64, device=dev)
    present = torch.empty((b, n), dtype=torch.bool, device=dev)
    seqs = torch.empty((b, n), dtype=torch.int64, device=dev)
    med = torch.empty((b,), dtype=torch.float64, device=dev)
    deficit = torch.empty((b, n), dtype=torch.float64, device=dev)
    hung = torch.empty((b, n), dtype=torch.bool, device=dev)
    is_src = torch.empty((b, n), dtype=torch.bool, device=dev)
    stats = torch.empty((b, 3), dtype=torch.int64, device=dev)      # scratch
    with torch.cuda.device(dev):
        err = _kernel("ws_window")(
            values.data_ptr(), b, t, order.data_ptr(), _bstride(order), starts.data_ptr(),
            counts.data_ptr(), gkey.data_ptr(), _bstride(starts), g, large.data_ptr(),
            large.numel(), max_count, hb_rank.data_ptr(), hb_seq.data_ptr(), hb_rank.shape[1],
            offsets.data_ptr(), float(hang_grace), n, medians.data_ptr(), present.data_ptr(),
            seqs.data_ptr(), med.data_ptr(), deficit.data_ptr(), hung.data_ptr(),
            is_src.data_ptr(), stats.data_ptr(), stream_of(values))
    if err != 0:
        raise RuntimeError(f"window_score launch failed: CUDA error {err}")
    launches["window_score"] += 1
    return dict(dmed=medians[0], wmed=medians[1], present=present, seqs=seqs, med=med,
                deficit=deficit, hung=hung, is_src=is_src)
