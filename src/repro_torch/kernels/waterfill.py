"""Max-min water-filling: the wrapper of ``csrc/waterfill.cu`` and its plain version.

Port of the XLA jit kernel ``repro.core.jaxsim.kernels.waterfill_kernel``
(with ``core/jaxsim/waterfill.py::waterfill_rates``), the filling loop of
``FlowSet.max_min``. On CUDA tensors ``waterfill`` launches the kernel (or
raises, never falling back); on CPU tensors it computes ``waterfill_ref``.
``launches`` counts the calls that launched. Both give the bits of the NumPy
loop in ``core/flowset.py``.

The incidence comes by link (``link_csr``): ``link_ptr`` (L + 1) offsets into
``link_flow`` (P), the flow of each (flow, link) pair, each link's pairs in
pair order, so that a link's sums run in ``np.bincount``'s order. The kernel
also takes it by flow (``flow_csr``), so that a frozen flow can mark its
links for the next round. Sizes are the fabric's own, nothing padded.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.checks import launch_on, require, stream_of

launches = 0

#: the grid variant's CTAs at most (csrc/waterfill.cu: MAX_BLOCKS)
MAX_BLOCKS = 1024
#: the kernel's variants (csrc/waterfill.cu: Variant): the state in device
#: memory on a cooperative grid, or in one CTA's shared memory
VARIANTS = {"grid": 0, "smem": 1}

_fns = {}
_P, _I = ctypes.c_void_p, ctypes.c_int64
_ARGTYPES = {"waterfill": [_P] * 7 + [_I] * 3 + [_P] * 4 + [_I, ctypes.c_int, _P],
             "waterfill_smem_bytes": [_I, _I, _I],
             "waterfill_scratch_bytes": [_I, _I],
             "waterfill_sync_probe": [_I, _I, ctypes.c_int, _P, _P]}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load("waterfill"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int if name in ("waterfill", "waterfill_sync_probe") \
            else ctypes.c_longlong
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


def flow_csr(pair_flow: np.ndarray, pair_link: np.ndarray,
             n_flows: int) -> Tuple[np.ndarray, np.ndarray]:
    """(flow_ptr (F + 1), flow_link (P)) int64: the incidence by flow, each
    flow's links in pair order."""
    return link_csr(pair_link, pair_flow, n_flows)


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


def pick_variant(n_flows: int, n_links: int, n_pairs: int) -> str:
    """The variant for a fabric on the current device, by its size alone:
    ``smem`` where the state fits in one CTA's shared memory, else ``grid``."""
    fits = _kernel("waterfill_smem_bytes")(n_flows, n_links, n_pairs)
    if fits < 0:
        raise RuntimeError(f"waterfill: the card could not be asked (CUDA error {-fits})")
    return "smem" if fits else "grid"


def waterfill(link_ptr, link_flow, w, alive, cap, *, flow_csr=None, variant=None):
    """Weighted progressive filling. ``w`` (F) float64, floored at 1e-9 as
    the NumPy loop floors it; ``alive`` (F) bool; ``cap`` (L) float64 after
    any jitter. Returns (rate (F), remaining (L)) float64 and the number of
    rounds that froze a flow, an int64 tensor (1,). ``flow_csr``: (flow_ptr,
    flow_link), the incidence by flow, which the kernel needs (the plain
    version does not). ``variant``: one of ``VARIANTS`` (None: by size,
    ``pick_variant``); the bits do not depend on it."""
    global launches
    dev = _check(link_ptr, link_flow, w, alive, cap)
    if dev.type == "cpu":
        return waterfill_ref(link_ptr, link_flow, w, alive, cap)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if flow_csr is None:
        raise ValueError("the CUDA kernel needs the incidence by flow (flow_csr)")
    flow_ptr, flow_link = flow_csr
    require("flow_ptr", flow_ptr, torch.int64, 1, dev)
    require("flow_link", flow_link, torch.int64, 1, dev)
    f, l, p = w.shape[0], cap.shape[0], link_flow.shape[0]
    if flow_ptr.shape[0] != f + 1 or flow_link.shape[0] != p:
        raise ValueError(f"flow_ptr {tuple(flow_ptr.shape)}, flow_link {tuple(flow_link.shape)} "
                         f"for {f} flows and {p} pairs")
    if variant is not None and variant not in VARIANTS:
        raise ValueError(f"variant {variant!r}: one of {sorted(VARIANTS)}")
    out = torch.empty(f + l, dtype=torch.float64, device=dev)
    rounds = torch.empty(1, dtype=torch.int64, device=dev)

    def launch():
        name = variant or pick_variant(f, l, p)
        nbytes = 0 if name == "smem" else _kernel("waterfill_scratch_bytes")(f, l)
        scratch = torch.empty(-(-nbytes // 8), dtype=torch.float64, device=dev)
        return _kernel("waterfill")(
            link_ptr.data_ptr(), link_flow.data_ptr(), flow_ptr.data_ptr(), flow_link.data_ptr(),
            w.data_ptr(), alive.data_ptr(), cap.data_ptr(), f, l, p, out.data_ptr(),
            out.data_ptr() + 8 * f, rounds.data_ptr(), scratch.data_ptr(), 8 * scratch.numel(),
            VARIANTS[name], stream_of(w))

    err = launch_on(w, launch)
    if err != 0:
        raise RuntimeError(f"waterfill launch failed: CUDA error {err}")
    launches += 1
    return out[:f], out[f:], rounds


def sync_probe(n_links: int, rounds: int, variant: str, device) -> torch.Tensor:
    """Launch the barriers of ``rounds`` rounds of ``variant``, with no work
    between them: one CTA's (``smem``), or the cooperative grid's for
    ``n_links`` links (the floor of a round; chip_smoke.py times it)."""
    slots = torch.empty(MAX_BLOCKS + 1, dtype=torch.float64, device=device)
    err = launch_on(slots, _kernel("waterfill_sync_probe"), n_links, rounds, VARIANTS[variant],
                    slots.data_ptr(), stream_of(slots))
    if err != 0:
        raise RuntimeError(f"waterfill sync probe launch failed: CUDA error {err}")
    return slots


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
