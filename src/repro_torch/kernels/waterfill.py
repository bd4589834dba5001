"""Max-min water-filling: the wrapper of ``csrc/waterfill.cu`` and its plain version.

Port of the XLA jit kernel ``repro.core.jaxsim.kernels.waterfill_kernel``
(with ``core/jaxsim/waterfill.py::waterfill_rates``), the filling loop of
``FlowSet.max_min``. On CUDA tensors ``waterfill`` launches the kernel (or
raises, never falling back); on CPU tensors it computes ``waterfill_ref``.
``launches`` counts the calls that launched. Both give the bits of the NumPy
loop in ``core/flowset.py``.

The incidence comes by link (``link_csr``): ``link_ptr`` (L + 1) offsets into
``link_flow`` (P), the flow of each (flow, link) pair, each link's pairs in
pair order, so that a link's sums run in ``np.bincount``'s order. Sizes are
the fabric's own, nothing padded.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.checks import launch_on, require, stream_of

launches = 0

#: the grid variant's CTAs at most (csrc/waterfill.cu: MAX_BLOCKS), part of
#: the scratch the wrapper allocates
MAX_BLOCKS = 1024
#: links from which ``waterfill(grid=None)`` takes the cooperative grid
#: rather than one CTA: on an H100 (chip_smoke.py's [fabric] crossover) one
#: CTA was faster up to 1,029 links and level at 2,055, the grid faster from
#: 4,094 (the Fig. 2 fabric) to 40,948 links
GRID_LINKS = 3072

_fns = {}
_P, _I = ctypes.c_void_p, ctypes.c_int64


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("waterfill"), name)
        fn.argtypes = ([_P] * 5 + [_I, _I] + [_P] * 4 + [ctypes.c_int, _P]
                       if name == "waterfill" else [_I, _I, ctypes.c_int, _P, _P])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def link_csr(pair_flow: np.ndarray, pair_link: np.ndarray,
             n_links: int) -> Tuple[np.ndarray, np.ndarray]:
    """(link_ptr (L + 1), link_flow (P)) int64: the COO incidence sorted by
    link, stably, so that a link's pairs keep their pair order."""
    order = np.argsort(pair_link, kind="stable")
    ptr = np.zeros(n_links + 1, np.int64)
    np.cumsum(np.bincount(pair_link, minlength=n_links), out=ptr[1:])
    return ptr, pair_flow[order].astype(np.int64)


def _check(link_ptr, link_flow, w, alive, cap):
    if not isinstance(w, torch.Tensor) or w.dtype != torch.float64 or w.dim() != 1:
        raise TypeError("w must be a float64 tensor (F,)")
    dev = w.device
    require("link_ptr", link_ptr, torch.int64, 1, dev)
    require("link_flow", link_flow, torch.int64, 1, dev)
    require("w", w, torch.float64, 1, dev)
    require("alive", alive, torch.bool, 1, dev)
    require("cap", cap, torch.float64, 1, dev)
    if alive.shape != w.shape or link_ptr.shape[0] != cap.shape[0] + 1:
        raise ValueError(f"alive {tuple(alive.shape)} for w {tuple(w.shape)}; link_ptr "
                         f"{tuple(link_ptr.shape)} for cap {tuple(cap.shape)}")
    return dev


def waterfill(link_ptr, link_flow, w, alive, cap, *, grid=None):
    """Weighted progressive filling. ``w`` (F) float64, floored at 1e-9 as
    the NumPy loop floors it; ``alive`` (F) bool; ``cap`` (L) float64 after
    any jitter. Returns (rate (F), remaining (L)) float64 and the number of
    rounds that froze a flow, an int64 tensor (1,). ``grid``: the kernel's
    variant (False one CTA, True the cooperative grid, None by
    ``GRID_LINKS``); the bits do not depend on it."""
    global launches
    dev = _check(link_ptr, link_flow, w, alive, cap)
    if dev.type == "cpu":
        return waterfill_ref(link_ptr, link_flow, w, alive, cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    f, l = w.shape[0], cap.shape[0]
    out = torch.empty(f + l, dtype=torch.float64, device=dev)
    rounds = torch.empty(1, dtype=torch.int64, device=dev)
    scratch = torch.empty(l + MAX_BLOCKS + (f + 1) // 2, dtype=torch.float64, device=dev)
    use_grid = l >= GRID_LINKS if grid is None else bool(grid)
    err = launch_on(w, _fns.get("waterfill") or _kernel("waterfill"), link_ptr.data_ptr(),
                    link_flow.data_ptr(), w.data_ptr(), alive.data_ptr(), cap.data_ptr(), f, l,
                    out.data_ptr(), out.data_ptr() + 8 * f, rounds.data_ptr(),
                    scratch.data_ptr(), int(use_grid), stream_of(w))
    if err != 0:
        raise RuntimeError(f"waterfill launch failed: CUDA error {err}")
    launches += 1
    return out[:f], out[f:], rounds


def sync_probe(n_links: int, rounds: int, grid: bool, device) -> torch.Tensor:
    """Launch the barriers of ``rounds`` rounds of a variant, with no work
    between them (the floor of a round; chip_smoke.py times it)."""
    sink = torch.empty(1, dtype=torch.float64, device=device)
    err = launch_on(sink, _kernel("waterfill_sync_probe"), n_links, rounds, int(grid),
                    sink.data_ptr(), stream_of(sink))
    if err != 0:
        raise RuntimeError(f"waterfill sync probe launch failed: CUDA error {err}")
    return sink


def link_columns(link_ptr: torch.Tensor):
    """The (L, D) matrix of each link's pairs in pair order (D the largest
    degree), column by column without its padding: links sorted by degree,
    largest first (stably), so that column j's pairs belong to the first
    ``n[j]`` links. Returns (the inverse of that sort (L,), n (D ints), the
    pair indices of columns 0..D-1 one after another (P,))."""
    deg = link_ptr[1:] - link_ptr[:-1]
    perm = torch.sort(deg, descending=True, stable=True).indices
    d = int(deg.max()) if deg.numel() else 0
    n = [int(x) for x in (deg[:, None] > torch.arange(d, device=deg.device)).sum(0)]
    first = link_ptr[:-1].index_select(0, perm)
    pos = torch.cat([first[:k] + j for j, k in enumerate(n)]) if d else first[:0]
    return torch.argsort(perm), n, pos


def pair_links(link_ptr: torch.Tensor) -> torch.Tensor:
    """The link of each pair of the CSR (P,)."""
    deg = link_ptr[1:] - link_ptr[:-1]
    return torch.repeat_interleave(torch.arange(deg.numel(), device=deg.device), deg)


def _link_sums(cols, per_pair: torch.Tensor) -> torch.Tensor:
    """Each link's sums of the rows of ``per_pair`` (K, P), each taken
    serially in pair order from 0.0 (``np.bincount``'s order), a column of
    ``link_columns`` at a time. (K, L)."""
    inverse, n, pos = cols
    vals = per_pair.index_select(1, pos)
    acc = per_pair.new_zeros(per_pair.shape[0], inverse.shape[0])
    at = 0
    for k in n:
        acc[:, :k] += vals[:, at:at + k]
        at += k
    return acc.index_select(1, inverse)


def waterfill_ref(link_ptr, link_flow, w, alive, cap):
    """The plain PyTorch version of ``waterfill``, on any device, bit-equal
    to the NumPy loop: the same steps in the same order, each link's sums
    taken serially in pair order (``_link_sums``; never ``index_add_``, whose
    CUDA path adds in no fixed order). A round's returned capacity and the
    next round's unfrozen weight are summed in one pass, as the kernel does;
    the next load is NumPy's, since nothing freezes between the two."""
    cols = link_columns(link_ptr)
    pair_link = pair_links(link_ptr)
    f, dev = w.shape[0], w.device
    pick = lambda x: x.index_select(0, link_flow)      # noqa: E731 (per pair, from per flow)
    pair_w = pick(w)
    unfrozen = alive.clone()
    rate = torch.zeros(f, dtype=torch.float64, device=dev)
    remaining = cap.clone()
    inf = torch.full_like(remaining, float("inf"))
    load = _link_sums(cols, torch.where(pick(unfrozen), pair_w, 0.0)[None])[0]
    rounds = 0
    while bool(unfrozen.any()):
        share = torch.where(load > 0.0, remaining / load, inf)
        m = share.min()
        if not bool(torch.isfinite(m)):
            break
        sel = (share.index_select(0, pair_link) == m) & pick(unfrozen)
        newly = torch.zeros(f, dtype=torch.bool, device=dev)
        newly[link_flow[sel]] = True
        rate = torch.where(newly, m * w, rate)
        unfrozen &= ~newly
        dec, load = _link_sums(cols, torch.stack([
            torch.where(pick(newly), pick(rate), 0.0), torch.where(pick(unfrozen), pair_w, 0.0)]))
        remaining = torch.clamp_min(remaining - dec, 0.0)
        rounds += 1
    return rate, remaining, torch.tensor([rounds], dtype=torch.int64, device=dev)
