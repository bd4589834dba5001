"""Plain PyTorch versions of the detection kernels, in float64 and int64.

Counterparts of the XLA jit kernels of ``repro.core.jaxsim.kernels``:

  * ``row_median`` and ``fused_window_kernel`` — what
    ``csrc/window_score.cu`` computes (per-group medians through a cached
    layout, then the heartbeat fold);
  * ``slow_fold_kernel`` — what ``csrc/slow_fold.cu`` computes;
  * ``grouped_median_kernel`` — the per-key median from raw keys (sort
    included), the reference's own formulation, kept as an oracle;
  * ``ewma_scan_ref`` — what ``csrc/ewma_scan.cu`` computes (the winsorized
    EWMA baseline update scanned over windows; pinned by a tolerance);
  * ``pair_median`` and ``hang`` (and ``batched_*``) — the reference's
    per-kernel twins (a global two-key sort; the heartbeat fold), which
    ``core.torchsim.detectors.analyze_arrays_reference`` runs as a second,
    independent path; plain torch only, no kernel.

They are the CPU path of the kernel wrappers (``window_score.py``,
``slow_fold.py``), the oracles the tests and ``chip_smoke.py`` hold the CUDA
kernels to, and they run on any device. Every function takes a leading batch
dimension B (the reference's ``vmap``); layout arrays of batch size 1 are
shared by all windows. Shapes are the window's own: G groups, H heartbeats
and n ranks, with no padding (the reference padded to power-of-two buckets
for its jit cache; a runtime-shaped kernel has none).

The exact-path rules of the reference carry over: float64 throughout, no
``a*b + c`` (the MAD centers and scales come from NumPy on the host), values
in the order of NumPy's stable sort (``order_key``, ties by position),
medians as ``0.5 * (lo + hi)`` of the two middle samples' own bits — never
``torch.median``, which takes the lower middle — and every max started at
its identity (-inf, int64-min); the z fold's float maxima are taken on
integer keys (``fold_key``), so that they do not depend on the order of a
scatter.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

#: sentinel key for padding slots; int64-max sorts after any real
#: ``src * n + dst`` key and after every value's ``order_key``.
PAD_KEY = int(np.iinfo(np.int64).max)

_I64_MIN = int(np.iinfo(np.int64).min)
_FLIP = int(np.iinfo(np.int64).max)
#: every NaN's sort key: above +inf's (its bits), below PAD_KEY
NAN_KEY = 0x7FF8000000000000


def order_key(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 keys in the order of NumPy's sort: -0.0 as +0.0,
    every NaN (any sign or payload) as NAN_KEY above +inf, negatives below
    by flipping all bits but the sign (``csrc/window_score.cu``'s
    ``order_key``). Equal keys keep their positions in a stable sort."""
    b = x.view(torch.int64)
    k = torch.where(b < 0, b ^ _FLIP, b)
    k = torch.where(x == 0, torch.zeros_like(k), k)
    return torch.where(torch.isnan(x), torch.full_like(k, NAN_KEY), k)


def padded_rows(values: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
                counts: torch.Tensor, fill: float) -> torch.Tensor:
    """Each group's samples as one row, padded with ``fill`` to the largest
    group: (B, V, G, M). ``values`` (B, V, T) float64 in the windows' own
    order; ``order`` (B|1, T) the layout's sort of the keys; ``starts`` and
    ``counts`` (B|1, G) each group's run in that order."""
    b, v, t = values.shape
    g = starts.shape[-1]
    order, starts, counts = (x.expand(b, x.shape[-1]) for x in (order, starts, counts))
    m = max(int(counts.max()) if counts.numel() else 0, 1)
    pad = torch.full((b, v, 1), fill, dtype=torch.float64, device=values.device)
    srt = torch.cat([values.gather(2, order[:, None, :].expand(b, v, t)), pad], dim=2)
    col = torch.arange(m, device=values.device)
    idx = torch.where(col < counts[:, :, None], starts[:, :, None] + col,
                      torch.full((b, g, m), t, dtype=torch.int64, device=values.device))
    return srt.gather(2, idx.reshape(b, 1, g * m).expand(b, v, g * m)).reshape(b, v, g, m)


def row_median(values: torch.Tensor, order: torch.Tensor, starts: torch.Tensor,
               counts: torch.Tensor) -> torch.Tensor:
    """Per-group medians, layout as for ``padded_rows``. Returns (V, B, G):
    the lo = max((c-1)//2, 0) and hi = min(c//2, M-1) order statistics of
    each group's row by (``order_key``, position), averaged; the row is
    padded to M with PAD_KEY, above every sample's key (NaN's too), and
    +inf values, so an empty group reads +inf."""
    rows = padded_rows(values, order, starts, counts, float("inf"))
    b, v, g, m = rows.shape
    counts = counts.expand(b, g)
    pad = torch.arange(m, device=values.device) >= counts[:, :, None]
    keys = torch.where(pad[:, None], torch.full_like(rows, PAD_KEY, dtype=torch.int64),
                       order_key(rows))
    perm = torch.sort(keys, dim=-1, stable=True).indices
    lo_i = torch.clamp((counts - 1) // 2, min=0)[:, None, :, None].expand(b, v, g, 1)
    hi_i = torch.clamp(counts // 2, max=m - 1)[:, None, :, None].expand(b, v, g, 1)
    lo = rows.gather(3, perm.gather(3, lo_i))[..., 0]
    hi = rows.gather(3, perm.gather(3, hi_i))[..., 0]
    return (0.5 * (lo + hi)).transpose(0, 1).contiguous()


def _masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over ``x[b][valid[b]]`` per row b (``np.median`` on the
    compacted row): sort with invalids as +inf, average the two middles."""
    s = torch.sort(torch.where(valid, x, torch.full_like(x, float("inf"))), dim=1).values
    c = valid.sum(dim=1, keepdim=True)
    lo = s.gather(1, torch.clamp((c - 1) // 2, min=0))
    hi = s.gather(1, torch.clamp(c // 2, max=x.shape[1] - 1))
    return (0.5 * (lo + hi))[:, 0]


def fused_window_kernel(values, order, starts, counts, gkey, hb_rank, hb_seq, offsets,
                        hang_grace: float, *, n: int) -> Dict[str, torch.Tensor]:
    """Window -> (pair medians, hang scoring). ``values`` (B, 2, T): delay
    and wait; layout as for ``row_median``, with ``gkey`` int64 (B|1, G);
    heartbeats (B, H); ``offsets`` (B, n) float64. Returns dmed, wmed
    (B, G); present, seqs, deficit, hung, is_src (B, n); med (B,)."""
    b = values.shape[0]
    dev = values.device
    med = row_median(values, order, starts, counts)
    seqs = torch.full((b, n), _I64_MIN, dtype=torch.int64, device=dev).scatter_reduce(
        1, hb_rank, hb_seq, "amax", include_self=True)
    ones = torch.ones_like(hb_rank)
    present = torch.zeros((b, n), dtype=torch.int64, device=dev).scatter_add(
        1, hb_rank, ones) > 0
    seqs_f = seqs.to(torch.float64)
    hmed = _masked_median(seqs_f, present)
    deficit = hmed[:, None] - seqs_f
    hung = present & ((deficit - offsets) >= hang_grace)
    gsrc = gkey.expand(b, gkey.shape[-1]) // n
    is_src = torch.zeros((b, n), dtype=torch.int64, device=dev).scatter_add(
        1, gsrc, torch.ones_like(gsrc)) > 0
    return dict(dmed=med[0], wmed=med[1], present=present, seqs=seqs, med=hmed,
                deficit=deficit, hung=hung, is_src=is_src)


#: fold_key's shift: the signed-order key of -inf less int64-min
_FOLD_SHIFT = 0x000FFFFFFFFFFFFF
_FOLD_TOP = _FLIP - _FOLD_SHIFT + 1          # the first key of a NaN with the sign bit


def fold_key(x: torch.Tensor) -> torch.Tensor:
    """float64 -> int64 keys in the order the z fold takes its maxima
    (``csrc/slow_fold.cu``'s ``fold_key``, less 2^63): -inf is int64-min,
    the max's identity; numbers in order, -0.0 below +0.0; NaNs above +inf,
    those with the sign bit highest. A bijection (``from_fold_key``), so a
    max of keys gives back the bits of the value that won."""
    s = x.view(torch.int64)
    k = torch.where(s < 0, s ^ _FLIP, s)        # NaNs of the sign bit below -inf's key
    neg_nan = k < _I64_MIN + _FOLD_SHIFT
    low = torch.where(neg_nan, _I64_MIN + _FOLD_SHIFT, k) - _FOLD_SHIFT
    top = torch.where(neg_nan, k ^ _I64_MIN, 0) + _FOLD_TOP
    return torch.where(neg_nan, top, low)


def from_fold_key(k: torch.Tensor) -> torch.Tensor:
    """The float64 of each ``fold_key``."""
    top = k >= _FOLD_TOP
    s = torch.where(top, (torch.where(top, k, _FOLD_TOP) - _FOLD_TOP) ^ _I64_MIN,
                    torch.where(top, _I64_MIN, k) + _FOLD_SHIFT)
    return torch.where(s < 0, s ^ _FLIP, s).view(torch.float64)


def slow_fold_kernel(gkey, dmed, wmed, center_d, scale_d, center_w, scale_w,
                     mad_threshold: float, row_col_fraction: float, min_observations: int,
                     *, n: int) -> Dict[str, torch.Tensor]:
    """Delay-matrix and ring-wait folds over the grouped medians. ``gkey``
    (B|1, G); the medians and the host-made centers/scales (B, G) float64.
    Returns per-group zd, zw, point and per-rank (B, n) row/col sel, score,
    hot, obs and wait sel, score. The maxima are taken on ``fold_key``: the
    reference's max wherever it is defined, and where it depends on the
    order of the scatter (+0.0 against -0.0, two NaNs), the larger key. So
    there the scores may differ from the JAX package's in the sign of a
    zero or the bits of a NaN, whose answer there follows its scatter's order."""
    b = dmed.shape[0]
    dev = dmed.device
    gkey = gkey.expand(b, gkey.shape[-1])
    zd = (dmed - center_d) / scale_d
    zw = (wmed - center_w) / scale_w
    gsrc, gdst = gkey // n, gkey % n
    hot = zd > mad_threshold
    kd = fold_key(zd)
    neg_ranks = torch.full((b, n), _I64_MIN, dtype=torch.int64, device=dev)
    zeros = torch.zeros((b, n), dtype=torch.int64, device=dev)

    def fold(seg):
        hot_n = zeros.scatter_add(1, seg, hot.to(torch.int64))
        obs_n = zeros.scatter_add(1, seg, torch.ones_like(seg))
        sel = ((obs_n >= min_observations)
               & (hot_n >= torch.clamp_min(row_col_fraction * obs_n.to(torch.float64), 1.0))
               & (hot_n >= 2))
        score = from_fold_key(neg_ranks.scatter_reduce(1, seg, kd, "amax", include_self=True))
        return sel, score, hot_n, obs_n

    row_sel, row_score, row_hot, row_obs = fold(gsrc)
    col_sel, col_score, col_hot, col_obs = fold(gdst)
    point = hot & ~row_sel.gather(1, gsrc) & ~col_sel.gather(1, gdst)
    # ring-wait (paper Case 2): hot receiver wait over a healthy transfer
    wmask = (zw > mad_threshold) & ~hot
    wait_score = from_fold_key(neg_ranks.scatter_reduce(
        1, gsrc, torch.where(wmask, fold_key(zw), _I64_MIN), "amax", include_self=True))
    wait_sel = zeros.scatter_add(1, gsrc, wmask.to(torch.int64)) > 0
    return dict(zd=zd, zw=zw, row_sel=row_sel, row_score=row_score, row_hot=row_hot,
                row_obs=row_obs, col_sel=col_sel, col_score=col_score, col_hot=col_hot,
                col_obs=col_obs, point=point, wait_sel=wait_sel, wait_score=wait_score)


#: a NaN with its sign bit set (``fold_key`` ranks it above every other value)
NEG_NAN = float(np.array([0xFFF8000000000001], np.uint64).view(np.float64)[0])
#: the inputs of ``fold_cases``, each reaching an edge of the z fold
FOLD_CASES = ("sorted", "shuffled keys", "runs longer than a warp", "NaN and signed zeros",
              "batch, shared keys", "batch, own keys")


def fold_cases(case: str, seed: int = 1):
    """NumPy inputs of the z fold that reach its edges, for holding the
    kernel to this plain version and this plain version to NumPy: returns
    (gkey (B|1, G) int64, dmed, wmed, center_d, scale_d, center_w, scale_w
    (B, G) float64, n). In every case some ranks source no group and some
    receive none, so their folds read the identities (-inf, 0); rank 2's
    row is hot. ``case``, one of ``FOLD_CASES``: keys ascending as a window
    has them; the same keys shuffled; source 3 with 100 destinations, a run
    that crosses warps; NaN of both signs, -inf and +-0.0 among the
    medians (a rank whose largest zd is a tie of +0.0 and -0.0); three
    windows on one key array; three windows with keys of their own."""
    if case not in FOLD_CASES:
        raise ValueError(case)
    rng = np.random.default_rng(seed)
    n, g = 160, 400
    b = 3 if case.startswith("batch") else 1

    def keys():
        # sources 0..119 (120..159 source nothing), destinations 40..159
        # (0..39 receive nothing)
        run = 3 * n + 40 + np.arange(100 if case == "runs longer than a warp" else 0)
        other = rng.integers(0, 120, g) * n + rng.integers(40, n, g)
        k = np.unique(np.r_[run, other[other // n != 3]])
        while k.size < g:
            extra = rng.integers(0, 120) * n + rng.integers(40, n)
            if extra // n != 3:
                k = np.unique(np.r_[k, extra])
        return np.sort(np.r_[run, np.setdiff1d(k, run)[:g - run.size]])

    gkey = np.stack([keys() for _ in range(b if case == "batch, own keys" else 1)])
    if case == "shuffled keys":
        gkey = gkey[:, rng.permutation(g)]
    dmed, wmed = rng.normal(size=(2, b, g)) * 4
    cd, cw = rng.normal(size=(2, b, g))
    sd, sw = rng.uniform(0.5, 2, size=(2, b, g))
    src = np.broadcast_to(gkey // n, (b, g))
    dmed[src == 2] += 100.0                               # a hot row and its columns
    if case == "NaN and signed zeros":
        for x in (dmed, wmed):
            pick = rng.choice(g, 40, replace=False)
            x[0, pick[:10]] = np.nan
            x[0, pick[10:20]] = NEG_NAN
            x[0, pick[20:30]] = 0.0
            x[0, pick[30:]] = -0.0
        cd[0, dmed[0] == 0] = 0.0                       # zd = +-0.0
        cw[0, wmed[0] == 0] = 0.0
        # rank 7: zd of -0.0, +0.0 and below, in that order; rank 8: -inf alone
        at = np.flatnonzero(src[0] == 7)
        if at.size >= 3:
            dmed[0, at] = -5.0
            dmed[0, at[0]], dmed[0, at[1]] = -0.0, 0.0
            cd[0, at[:2]] = 0.0
        dmed[0, src[0] == 8] = -np.inf
    return gkey, dmed, wmed, cd, sd, cw, sw, n


def grouped_median_kernel(keys: torch.Tensor, values: torch.Tensor):
    """Per-distinct-key median from raw keys (T,), the reference's
    formulation: sort by (key, value), group extents, mean of the middles.
    Returns (group_key, group_median, group_count, valid) of length T; group
    ``g`` occupies slot ``g`` in ascending key order, trailing slots have
    count 0; valid groups have count > 0 and a key other than PAD_KEY."""
    t = keys.shape[0]
    dev = keys.device
    if t == 0:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, torch.zeros(0, dtype=torch.float64, device=dev), empty, empty > 0
    by_value = torch.sort(values, stable=True).indices
    order = by_value[torch.sort(keys[by_value], stable=True).indices]
    k, v = keys[order], values[order]
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), k[1:] != k[:-1]])
    gid = torch.cumsum(is_start.to(torch.int64), 0) - 1
    idx = torch.arange(t, device=dev)
    starts = torch.full((t,), t, dtype=torch.int64, device=dev).scatter_reduce(
        0, gid, idx, "amin", include_self=True)
    counts = torch.zeros(t, dtype=torch.int64, device=dev).scatter_add(
        0, gid, torch.ones(t, dtype=torch.int64, device=dev))
    safe = torch.where(counts > 0, starts, 0)
    lo = v[safe + torch.clamp(counts - 1, min=0) // 2]
    hi = v[torch.clamp(safe + counts // 2, max=t - 1)]
    gkey = k[safe]
    return gkey, 0.5 * (lo + hi), counts, (counts > 0) & (gkey != PAD_KEY)


#: mean-absolute-deviation -> sigma (``core/c4d/baseline.py``; copied so
#: that this module stands on its own)
MEANAD_TO_SIGMA = 1.2533


def ewma_scan_ref(values: torch.Tensor, mean0: torch.Tensor, dev0: torch.Tensor,
                  count0: torch.Tensor, alpha: float, clip_sigma: float):
    """The winsorized EWMA baseline update scanned over windows: what
    ``csrc/ewma_scan.cu`` computes. ``values`` (W, E) float64, NaN where a
    cell was not seen; ``mean0``, ``dev0`` (E) float64, ``count0`` (E) int64.
    Per window: the median of its finite values (``0.5 * (lo + hi)``), the
    mean absolute deviation about it seeding each cell's first observation,
    then the clipped step of ``AdaptiveBaseline.update``. Returns (mean, dev,
    count). Pinned by a tolerance (1e-9), as the reference's scan is."""
    mean, dev, count = mean0.clone(), dev0.clone(), count0.clone()
    for vals in values:
        finite = torch.isfinite(vals)
        nf = int(finite.sum())
        if nf == 0:
            continue
        pool = torch.sort(vals[finite]).values
        med = 0.5 * (pool[(nf - 1) // 2] + pool[nf // 2])
        seed_dev = torch.abs(pool - med).sum() / nf
        first = finite & (count == 0)
        rest = finite & (count > 0)
        lim = clip_sigma * (MEANAD_TO_SIGMA * dev
                            + 1e-12 * torch.clamp_min(torch.abs(mean), 1e-12) + 1e-30)
        delta = torch.minimum(torch.maximum(torch.where(rest, vals, mean) - mean, -lim), lim)
        dev = torch.where(first, seed_dev, torch.where(
            rest, (1.0 - alpha) * dev + alpha * torch.abs(delta), dev))
        mean = torch.where(first, vals, torch.where(rest, mean + alpha * delta, mean))
        count = count + finite.to(count.dtype)
    return mean, dev, count


# ---------------------------------------------------------------------------
# the per-kernel reference twins: a global two-key sort and the hang fold
# ---------------------------------------------------------------------------

def batched_pair_median(keys: torch.Tensor, dvals: torch.Tensor, wvals: torch.Tensor):
    """Grouped delay and wait medians by a global two-key sort, per row of a
    batch: ``keys`` (B, T) int64 (``src * n + dst``; PAD_KEY on padding),
    values (B, T) float64 (+inf on padding). Returns element-aligned arrays
    over each row's transports sorted by (key, value): (sorted key, the
    group's delay median, wait median, count, rep, valid), where ``rep``
    marks the first element of each real group, in ascending key order, and
    ``valid`` the elements that are not padding. Counterpart of the
    reference's ``pair_median_kernel`` vmapped, with no bucket padding of its
    own; values sort by ``order_key`` (the reference's bit-pattern sort for
    the non-negative values a window holds)."""
    b, t = keys.shape
    dev = keys.device
    if t == 0:
        empty = keys.new_zeros((b, 0))
        none = torch.zeros((b, 0), dtype=torch.float64, device=dev)
        return empty, none, none.clone(), empty.clone(), empty > 0, empty > 0

    def by_key_then_value(vals):
        by_value = torch.sort(order_key(vals), dim=1, stable=True).indices
        perm = by_value.gather(1, torch.sort(keys.gather(1, by_value), dim=1,
                                             stable=True).indices)
        return keys.gather(1, perm), vals.gather(1, perm)

    k, d = by_key_then_value(dvals)
    _, w = by_key_then_value(wvals)
    idx = torch.arange(t, device=dev).expand(b, t)
    brk = k[:, 1:] != k[:, :-1]
    one = torch.ones((b, 1), dtype=torch.bool, device=dev)
    is_start = torch.cat([one, brk], dim=1)
    is_end = torch.cat([brk, one], dim=1)
    start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    end = torch.cummin(torch.where(is_end, idx, t - 1).flip(1), dim=1).values.flip(1)
    cnt = end - start + 1
    lo_i, hi_i = start + (cnt - 1) // 2, start + cnt // 2
    dmed = 0.5 * (d.gather(1, lo_i) + d.gather(1, hi_i))
    wmed = 0.5 * (w.gather(1, lo_i) + w.gather(1, hi_i))
    valid = k != PAD_KEY
    return k, dmed, wmed, cnt, is_start & valid, valid


def pair_median(keys: torch.Tensor, dvals: torch.Tensor, wvals: torch.Tensor):
    """``batched_pair_median`` of one window: (T,) arrays in and out."""
    return tuple(x[0] for x in batched_pair_median(keys[None], dvals[None], wvals[None]))


def batched_hang(hb_rank, hb_seq, hb_valid, src_rank, src_valid, offsets,
                 hang_grace: float, *, n: int) -> Dict[str, torch.Tensor]:
    """Heartbeat scoring per row of a batch: ``hb_rank``, ``hb_seq`` (B, H)
    int64 with ``hb_valid`` (B, H) bool; ``src_rank`` (B, T) int64 with
    ``src_valid``; ``offsets`` (B, n) float64, the learned deficits. Returns
    present, seqs (the last seq, int64-min where none), deficit (median -
    seq), hung (deficit - offset >= hang_grace) and is_src, (B, n), and med
    (B,): the reference's ``hang_kernel`` vmapped, with the window's own n."""
    b = hb_rank.shape[0]
    dev = hb_rank.device
    seqs = torch.full((b, n), _I64_MIN, dtype=torch.int64, device=dev).scatter_reduce(
        1, hb_rank, torch.where(hb_valid, hb_seq, _I64_MIN), "amax", include_self=True)
    zeros = torch.zeros((b, n), dtype=torch.int64, device=dev)
    present = zeros.scatter_add(1, hb_rank, hb_valid.to(torch.int64)) > 0
    seqs_f = seqs.to(torch.float64)
    med = _masked_median(seqs_f, present)
    deficit = med[:, None] - seqs_f
    hung = present & ((deficit - offsets) >= hang_grace)
    is_src = zeros.scatter_add(1, src_rank, src_valid.to(torch.int64)) > 0
    return dict(present=present, seqs=seqs, med=med, deficit=deficit, hung=hung,
                is_src=is_src)


def hang(hb_rank, hb_seq, src_rank, offsets, hang_grace: float, *,
         n: int) -> Dict[str, torch.Tensor]:
    """``batched_hang`` of one window, every heartbeat and source valid:
    (H,), (T,) and (n,) in; (n,) arrays and med () out."""
    every = torch.ones_like(hb_rank[None], dtype=torch.bool)
    res = batched_hang(hb_rank[None], hb_seq[None], every, src_rank[None],
                       torch.ones_like(src_rank[None], dtype=torch.bool), offsets[None],
                       hang_grace, n=n)
    return {k: v[0] for k, v in res.items()}
