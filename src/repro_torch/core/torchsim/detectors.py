"""Host adapters: TelemetryArrays windows -> CUDA kernels -> Verdict lists.

Port of ``repro.core.jaxsim.detectors``. ``analyze_arrays`` is the torch
backend of ``C4DDetector.analyze`` — the composite's semantics (hang
analysis pre-empts slow analysis; the adaptive baseline advances only on
hang-free windows) and its Verdict objects field for field, scores bit-equal
(``tests/test_torch_detect.py``). It is the B = 1 case of
``score_windows_batched``, which the streaming master's ``ingest_batch``
uses.

Per window:

  1. host: group the transport keys (``_layout_for``: a stable
     ``np.argsort`` and run extents, cached across windows with equal keys,
     which a steady telemetry stream repeats; the cached layout also keeps
     its order and group starts on the device, so a window sends only its
     delay/wait values and heartbeats);
  2. device (``kernels.window_score``): per-group medians read through the
     layout, and the heartbeat hang scoring;
  3. host: hang pre-emption, then the per-group z centers/scales
     (``_mixed_center_scale`` — the MAD math stays NumPy so that no
     ``a*b + c`` runs on the device);
  4. device (``kernels.slow_fold``): z folds -> row/col/point/wait bits;
  5. host: the Verdict list and the NumPy ``AdaptiveBaseline`` advance.

``device`` is where steps 2 and 4 run: ``None`` is the card (raising
without one); on ``"cpu"`` the wrappers compute their plain versions.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.c4d.baseline import MEANAD_TO_SIGMA, AdaptiveBaseline
from repro_torch.core.c4d.detector import (COMM_HANG, COMM_SLOW_DST, COMM_SLOW_LINK,
                                           COMM_SLOW_SRC, DetectorConfig, NONCOMM_HANG,
                                           NONCOMM_SLOW, Verdict)
from repro_torch.core.c4d.telemetry import TelemetryArrays
from repro_torch.kernels import detect_ref as _ref
from repro_torch.kernels import slow_fold as _fold
from repro_torch.kernels import window_score as _ws

#: when a dict, the scorer adds the wall seconds of its phases to it
#: ("pack", "copy", "kernels", "host"), synchronising the device at each
#: boundary; None (the default) adds no synchronisation.
phase_seconds: Optional[Dict[str, float]] = None


def launch_counts() -> Dict[str, int]:
    """Detection kernel launches since the last reset, by kernel entry."""
    return {"window_score": _ws.launches["window_score"],
            "row_select": _ws.launches["row_select"], "slow_fold": _fold.launches}


def reset_launch_counts() -> None:
    _ws.launches["window_score"] = 0
    _ws.launches["row_select"] = 0
    _fold.launches = 0


def _phase(name: str, t0: float, dev: torch.device) -> float:
    if phase_seconds is None:
        return t0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    phase_seconds[name] = phase_seconds.get(name, 0.0) + t - t0
    return t


# ---------------------------------------------------------------------------
# window layouts: host-side group structure, cached across windows
# ---------------------------------------------------------------------------

class _WindowLayout:
    """Group structure of one key array (a window's ``src * n + dst``, or a
    prefilter's keys).

    ``order`` is the stable sort of the keys; group ``g`` is the run
    ``order[starts[g]:starts[g] + counts[g]]``, in ascending key order; the
    kernels take these shapes as they are, unpadded. Everything here depends
    only on the keys, and a steady telemetry stream emits the same keys window
    after window, so the object is cached and re-validated by comparing them.
    ``device_tensors`` keeps the arrays the kernels read on each device."""

    __slots__ = ("keys", "g", "max_count", "order", "starts", "counts", "gkey", "large",
                 "_dev")

    def __init__(self, keys: np.ndarray):
        t = keys.size
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        if t:
            starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
            counts = np.diff(np.r_[starts, t])
        else:
            starts = np.zeros(0, np.int64)
            counts = np.zeros(0, np.int64)
        self.keys = keys.copy()
        self.g = starts.size
        self.max_count = int(counts.max()) if self.g else 0
        self.order = order.astype(np.int64)
        self.starts = starts.astype(np.int64)
        self.counts = counts.astype(np.int64)
        self.gkey = sk[starts].astype(np.int64)
        self.large = np.flatnonzero(self.counts > _ws.SMALL_GROUP).astype(np.int64)
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}

    def device_tensors(self, dev: torch.device) -> Dict[str, torch.Tensor]:
        """The layout's arrays on ``dev``, each with a batch dimension of 1;
        copied once and kept while the layout is cached."""
        got = self._dev.get(str(dev))
        if got is None:
            got = {k: torch.from_numpy(getattr(self, k)).to(dev)[None]
                   for k in ("order", "starts", "counts", "gkey")}
            got["large"] = torch.from_numpy(self.large).to(dev)
            self._dev[str(dev)] = got
        return got


#: most-recent-first layout cache. Bounded two ways: entry count and total
#: cached elements (a 100k-rank layout holds ~6M int64s, so the element
#: budget keeps the cache to a couple of giant layouts instead of eight).
_LAYOUT_CACHE: List[_WindowLayout] = []
_LAYOUT_CACHE_MAX = 8
_LAYOUT_CACHE_MAX_ELEMENTS = 16_000_000
_layout_hits = 0
_layout_misses = 0


def _layout_for(keys: np.ndarray) -> _WindowLayout:
    global _layout_hits, _layout_misses
    for i, lay in enumerate(_LAYOUT_CACHE):
        if lay.keys.size == keys.size and np.array_equal(lay.keys, keys):
            _layout_hits += 1
            if i:
                _LAYOUT_CACHE.insert(0, _LAYOUT_CACHE.pop(i))
            return lay
    _layout_misses += 1
    lay = _WindowLayout(keys)
    _LAYOUT_CACHE.insert(0, lay)
    total = 0
    for i, entry in enumerate(_LAYOUT_CACHE):
        total += 2 * entry.keys.size
        if i and (i >= _LAYOUT_CACHE_MAX or total > _LAYOUT_CACHE_MAX_ELEMENTS):
            del _LAYOUT_CACHE[i:]
            break
    return lay


def layout_cache_info() -> dict:
    """Occupancy and hit rate of the layout cache."""
    return {"entries": len(_LAYOUT_CACHE),
            "max_entries": _LAYOUT_CACHE_MAX,
            "elements": int(sum(2 * e.keys.size for e in _LAYOUT_CACHE)),
            "max_elements": _LAYOUT_CACHE_MAX_ELEMENTS,
            "hits": _layout_hits, "misses": _layout_misses}


def grouped_median_torch(keys: np.ndarray, values: np.ndarray, device=None):
    """``telemetry.grouped_median``'s torch branch: (sorted unique keys,
    medians), bit-equal to the NumPy fold for any float64 values and group
    sizes."""
    keys = np.asarray(keys).astype(np.int64, copy=False)
    values = np.asarray(values, np.float64)
    if keys.size == 0:
        return keys.copy(), np.zeros(0)
    dev = resolve_device(device)
    lay = _layout_for(keys)
    lt = lay.device_tensors(dev)
    vals = torch.from_numpy(np.ascontiguousarray(values)).to(dev).view(1, 1, -1)
    med = _ws.row_select(vals, lt["order"], lt["starts"], lt["counts"], large=lt["large"],
                         max_count=lay.max_count)
    return lay.gkey.copy(), med[0, 0].cpu().numpy()


# ---------------------------------------------------------------------------
# packing (host side)
# ---------------------------------------------------------------------------

class _PackedWindow:
    """One window's kernel inputs: its layout, its delay/wait values in the
    window's own order (2, T), its heartbeats (H,) and per-rank deficit
    offsets (n,)."""

    __slots__ = ("layout", "values", "hb_rank", "hb_seq", "offsets")

    def __init__(self, window: TelemetryArrays, n: int,
                 baseline: Optional[AdaptiveBaseline]):
        t = int(window.tr_src.size)
        keys = (window.tr_src.astype(np.int64) * n + window.tr_dst if t
                else np.zeros(0, np.int64))
        self.layout = _layout_for(keys)
        self.values = np.empty((2, t))
        if t:
            self.values[0] = window.tr_transfer() / np.maximum(window.tr_bytes, 1)
            self.values[1] = window.tr_wait()
        self.hb_rank = window.hb_rank.astype(np.int64, copy=False)
        self.hb_seq = window.hb_seq.astype(np.int64, copy=False)
        self.offsets = np.zeros(n)
        if baseline is not None:
            self.offsets[:] = baseline.deficit_offset(np.arange(n))

    def bucket(self):
        """Shape signature: windows with equal group and heartbeat counts
        stack into one launch."""
        return (self.layout.g, self.hb_rank.size)


def _mixed_center_scale(values: np.ndarray, gkey: np.ndarray, n: int,
                        baseline: Optional[AdaptiveBaseline], kind: str):
    """Per-group z normalisers for ``z = (median - center) / scale``.

    Cross-sectional center/scale come from the window's own group medians
    (``detector._robust_z``'s formula verbatim); where an attached baseline
    is warm, the cell's EWMA mean and MEANAD-scaled dev take over
    (``AdaptiveBaseline.z``). All of it is NumPy on purpose — these are the
    only multiply-add chains on the exact path, which a GPU compiler would
    contract into FMAs."""
    if values.size == 0:
        return np.zeros(0), np.ones(0)
    med = np.median(values)
    mad = np.median(np.abs(values - med))
    cs = 1.4826 * mad + 1e-12 * max(abs(med), 1e-12) + 1e-30
    c = np.full(values.size, med)
    s = np.full(values.size, cs)
    if baseline is not None:
        bm, bd, bc = baseline.cell_stats(kind, gkey // n, gkey % n)
        bscale = (MEANAD_TO_SIGMA * bd
                  + 1e-12 * np.maximum(np.abs(bm), 1e-12) + 1e-30)
        use = bc >= baseline.warm_windows
        c = np.where(use, bm, c)
        s = np.where(use, bscale, s)
    return c, s


# ---------------------------------------------------------------------------
# Verdict lists
# ---------------------------------------------------------------------------

def _hang_verdict_list(hung: np.ndarray, seqs: np.ndarray, med: float,
                       is_src: np.ndarray) -> List[Verdict]:
    out = []
    for r in np.flatnonzero(hung):
        s = int(seqs[r])
        syndrome = COMM_HANG if is_src[r] else NONCOMM_HANG
        out.append(Verdict(syndrome, rank=int(r), score=float(med - s),
                           detail=f"seq {s} vs median {med:.0f}"))
    return out


def _fold_verdict_list(res: dict, gkey: np.ndarray, n: int) -> List[Verdict]:
    verdicts: List[Verdict] = []
    row_score, row_hot, row_obs = res["row_score"], res["row_hot"], res["row_obs"]
    for i in np.flatnonzero(res["row_sel"]):
        verdicts.append(Verdict(
            COMM_SLOW_SRC, rank=int(i), score=float(row_score[i]),
            detail=f"row {i}: {int(row_hot[i])}/{int(row_obs[i])} hot"))
    col_score, col_hot, col_obs = res["col_score"], res["col_hot"], res["col_obs"]
    for j in np.flatnonzero(res["col_sel"]):
        verdicts.append(Verdict(
            COMM_SLOW_DST, rank=int(j), score=float(col_score[j]),
            detail=f"col {j}: {int(col_hot[j])}/{int(col_obs[j])} hot"))
    zd = res["zd"]
    for g in np.flatnonzero(res["point"]):
        i, j = divmod(int(gkey[g]), n)
        verdicts.append(Verdict(COMM_SLOW_LINK, link=(i, j), score=float(zd[g]),
                                detail=f"point ({i},{j})"))
    wait_score = res["wait_score"]
    for i in np.flatnonzero(res["wait_sel"]):
        verdicts.append(Verdict(NONCOMM_SLOW, rank=int(i), score=float(wait_score[i]),
                                detail="receiver wait w/ healthy transfer"))
    return verdicts


def _host(res: Dict[str, torch.Tensor], b: int) -> Dict[str, np.ndarray]:
    return {k: v[b].cpu().numpy() for k, v in res.items()}


def _to(dev: torch.device, *arrays: np.ndarray) -> List[torch.Tensor]:
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


# ---------------------------------------------------------------------------
# the composite analysis (drop-in for C4DDetector.analyze on arrays windows)
# ---------------------------------------------------------------------------

def analyze_arrays(window: TelemetryArrays, cfg: DetectorConfig,
                   n_ranks: Optional[int] = None,
                   baseline: Optional[AdaptiveBaseline] = None,
                   device=None) -> List[Verdict]:
    """One window through the pipeline — the B = 1 case of
    ``score_windows_batched``."""
    return score_windows_batched([window], cfg, n_ranks=n_ranks, baseline=baseline,
                                 device=device)[0]


def _fold_window(lt: Dict[str, torch.Tensor], lay: _WindowLayout, dmed: np.ndarray,
                 wmed: np.ndarray, cfg: DetectorConfig, n: int,
                 baseline: Optional[AdaptiveBaseline], dev: torch.device, t0: float):
    """Centers/scales on the host, then the fold kernel for one window."""
    cd, sd = _mixed_center_scale(dmed, lay.gkey, n, baseline, "delay")
    cw, sw = _mixed_center_scale(wmed, lay.gkey, n, baseline, "wait")
    t0 = _phase("host", t0, dev)
    args = [a[None] for a in _to(dev, dmed, wmed, cd, sd, cw, sw)]
    t0 = _phase("copy", t0, dev)
    res = _fold.slow_fold(lt["gkey"], *args, cfg.mad_threshold, cfg.row_col_fraction,
                          cfg.min_observations, n=n)
    t0 = _phase("kernels", t0, dev)
    res = _host(res, 0)
    t0 = _phase("copy", t0, dev)
    return res, t0


def _score_single(window: TelemetryArrays, cfg: DetectorConfig, n: int,
                  baseline: Optional[AdaptiveBaseline], dev: torch.device) -> List[Verdict]:
    """One window (two kernel calls), baseline advance included — the unit
    the sequential paths share."""
    t0 = time.perf_counter()
    pw = _PackedWindow(window, n, baseline)
    lay = pw.layout
    t0 = _phase("pack", t0, dev)
    lt = lay.device_tensors(dev)
    values, hb_rank, hb_seq, offsets = (
        a[None] for a in _to(dev, pw.values, pw.hb_rank, pw.hb_seq, pw.offsets))
    t0 = _phase("copy", t0, dev)
    res = _ws.window_score(values, lt["order"], lt["starts"], lt["counts"], lt["gkey"],
                           hb_rank, hb_seq, offsets, cfg.hang_grace, n=n, large=lt["large"],
                           max_count=lay.max_count)
    t0 = _phase("kernels", t0, dev)
    hung = res["hung"][0].cpu().numpy()
    if hung.any():
        # hangs pre-empt slow analysis and freeze the baseline — identical
        # to the NumPy composite
        seqs, is_src = res["seqs"][0].cpu().numpy(), res["is_src"][0].cpu().numpy()
        med = float(res["med"][0])
        t0 = _phase("copy", t0, dev)
        out = _hang_verdict_list(hung, seqs, med, is_src)
        _phase("host", t0, dev)
        return out
    dmed, wmed = res["dmed"][0].cpu().numpy(), res["wmed"][0].cpu().numpy()
    t0 = _phase("copy", t0, dev)
    fold, t0 = _fold_window(lt, lay, dmed, wmed, cfg, n, baseline, dev, t0)
    verdicts = _fold_verdict_list(fold, lay.gkey, n)
    if baseline is not None:
        _advance_baseline(window, cfg, n, baseline, lay.gkey, dmed, wmed)
    _phase("host", t0, dev)
    return verdicts


def _stack_layouts(lays: List[_WindowLayout], dev: torch.device):
    """The layout tensors of a bucket (equal group counts): one shared
    layout (batch 1), or each window's stacked, the sort orders padded to
    the longest (no group reads past its own transports)."""
    if all(lay is lays[0] for lay in lays):
        return lays[0].device_tensors(dev), lays[0].max_count
    t = max(lay.order.size for lay in lays)
    order = np.zeros((len(lays), t), np.int64)
    for b, lay in enumerate(lays):
        order[b, :lay.order.size] = lay.order
    stacked = {k: np.stack([getattr(lay, k) for lay in lays])
               for k in ("starts", "counts", "gkey")}
    large = np.unique(np.concatenate([lay.large for lay in lays]))
    got = dict(zip(("order", "starts", "counts", "gkey", "large"),
                   _to(dev, order, *stacked.values(), large)))
    return got, max(lay.max_count for lay in lays)


def score_windows_batched(windows: Sequence[TelemetryArrays],
                          cfg: DetectorConfig,
                          n_ranks: Optional[int] = None,
                          baseline: Optional[AdaptiveBaseline] = None,
                          device=None) -> List[List[Verdict]]:
    """Score B windows end to end; returns one full Verdict list per window
    (hang pre-emption included) in input order.

    Windows sharing a bucket (equal group and heartbeat counts) are scored
    by ONE ``window_score`` call with a leading batch dimension, then the
    hang-free survivors share one ``slow_fold`` call per group count. With an
    adaptive ``baseline`` the windows are scored sequentially instead: the
    EWMA advances between windows, so window i+1 is not independent of
    window i and batching would change verdicts."""
    wins = list(windows)
    if not wins:
        return []
    n = n_ranks or wins[0].n_ranks()
    dev = resolve_device(device)
    if baseline is not None or len(wins) == 1:
        return [_score_single(w, cfg, n, baseline, dev) for w in wins]

    packs = [_PackedWindow(w, n, None) for w in wins]
    buckets: dict = {}
    for i, pw in enumerate(packs):
        buckets.setdefault(pw.bucket(), []).append(i)

    results: List[Optional[List[Verdict]]] = [None] * len(wins)
    slow: dict = {}          # group count -> [(index, dmed, wmed)]
    for idxs in buckets.values():
        lt, max_count = _stack_layouts([packs[i].layout for i in idxs], dev)
        t = max(packs[i].values.shape[1] for i in idxs)
        values = np.zeros((len(idxs), 2, t))
        for b, i in enumerate(idxs):
            values[b, :, :packs[i].values.shape[1]] = packs[i].values
        vals, hb_rank, hb_seq, offsets = _to(
            dev, values, *(np.stack([getattr(packs[i], k) for i in idxs])
                           for k in ("hb_rank", "hb_seq", "offsets")))
        res = _ws.window_score(vals, lt["order"], lt["starts"], lt["counts"], lt["gkey"],
                               hb_rank, hb_seq, offsets, cfg.hang_grace, n=n,
                               large=lt["large"], max_count=max_count)
        res = {k: v.cpu().numpy() for k, v in res.items()}
        for b, i in enumerate(idxs):
            hung = res["hung"][b]
            if hung.any():
                results[i] = _hang_verdict_list(hung, res["seqs"][b], float(res["med"][b]),
                                                res["is_src"][b])
            else:
                slow.setdefault(packs[i].layout.g, []).append(
                    (i, res["dmed"][b], res["wmed"][b]))

    for entries in slow.values():
        lays = [packs[i].layout for i, _, _ in entries]
        lt, _ = _stack_layouts(lays, dev)
        dmed = np.stack([d for _, d, _ in entries])
        wmed = np.stack([w for _, _, w in entries])
        cd, sd = np.empty_like(dmed), np.empty_like(dmed)
        cw, sw = np.empty_like(wmed), np.empty_like(wmed)
        for b, lay in enumerate(lays):
            cd[b], sd[b] = _mixed_center_scale(dmed[b], lay.gkey, n, None, "delay")
            cw[b], sw[b] = _mixed_center_scale(wmed[b], lay.gkey, n, None, "wait")
        fold = _fold.slow_fold(lt["gkey"], *_to(dev, dmed, wmed, cd, sd, cw, sw),
                               cfg.mad_threshold, cfg.row_col_fraction, cfg.min_observations,
                               n=n)
        fold = {k: v.cpu().numpy() for k, v in fold.items()}
        for b, (i, _, _) in enumerate(entries):
            results[i] = _fold_verdict_list({k: v[b] for k, v in fold.items()},
                                            lays[b].gkey, n)
    return results        # type: ignore[return-value]


def _advance_baseline(window, cfg, n, baseline, gkey, dmed, wmed):
    """Fold the hang-free window into the EWMA history — the sparse twin of
    ``C4DDetector._advance_baseline`` (same cells, same order, same
    winsorized math via ``AdaptiveBaseline.update_cells``)."""
    if gkey.size:
        rows, cols = gkey // n, gkey % n
        baseline.update_cells("delay", rows, cols, dmed)
        baseline.update_cells("wait", rows, cols, wmed)
    if window.hb_rank.size:
        ranks, inv = np.unique(window.hb_rank, return_inverse=True)
        seqs = np.full(ranks.size, np.iinfo(np.int64).min)
        np.maximum.at(seqs, inv, window.hb_seq)
        deficit = np.median(seqs) - seqs
        adj = deficit - baseline.deficit_offset(ranks)
        baseline.update_deficit(ranks, deficit.astype(float),
                                exclude=adj >= cfg.hang_grace)


# ---------------------------------------------------------------------------
# the per-kernel path, kept as the pipeline's independent reference
# ---------------------------------------------------------------------------

def analyze_arrays_reference(window: TelemetryArrays, cfg: DetectorConfig,
                             n_ranks: Optional[int] = None,
                             baseline: Optional[AdaptiveBaseline] = None,
                             device=None) -> List[Verdict]:
    """The reference's per-kernel analysis (``repro.core.jaxsim.detectors``'
    ``analyze_arrays_reference``): the hang fold, then grouped medians by a
    global two-key sort, then the z fold, each a plain torch function of
    ``kernels/detect_ref.py`` on ``device`` (``None``: the card), no CUDA
    kernel among them. A second path, independent of ``window_score`` and
    its cached layouts, that the equivalence tests hold equal to
    ``analyze_arrays`` and to the NumPy composite, baseline included."""
    n = n_ranks or window.n_ranks()
    dev = resolve_device(device)
    verdicts = _hang_verdicts(window, cfg, n, baseline, dev)
    if verdicts:
        return verdicts
    verdicts, gkey, dmed, wmed = _slow_verdicts(window, cfg, n, baseline, dev)
    if baseline is not None:
        _advance_baseline(window, cfg, n, baseline, gkey, dmed, wmed)
    return verdicts


def _hang_verdicts(window, cfg, n, baseline, dev):
    offsets = np.zeros(n)
    if baseline is not None and n:
        offsets[:] = baseline.deficit_offset(np.arange(n))
    res = _ref.hang(*_to(dev, window.hb_rank.astype(np.int64), window.hb_seq.astype(np.int64),
                         window.tr_src.astype(np.int64), offsets), cfg.hang_grace, n=n)
    hung = res["hung"].cpu().numpy()
    if not hung.any():
        return []
    return _hang_verdict_list(hung, res["seqs"].cpu().numpy(), float(res["med"]),
                              res["is_src"].cpu().numpy())


def _compact_groups(k, dmed, wmed, rep):
    """One slot per real group, in ascending key order, from the
    element-aligned medians: (gkey, dmed, wmed)."""
    idx = np.flatnonzero(rep)
    return k[idx], dmed[idx], wmed[idx]


def _slow_verdicts(window, cfg, n, baseline, dev):
    t = int(window.tr_src.size)
    keys = window.tr_src.astype(np.int64) * n + window.tr_dst
    dv = window.tr_transfer() / np.maximum(window.tr_bytes, 1) if t else np.zeros(0)
    wv = window.tr_wait() if t else np.zeros(0)
    k, dmed_e, wmed_e, _, rep, _ = _ref.pair_median(*_to(dev, keys, dv, wv))
    gkey, dmed, wmed = _compact_groups(k.cpu().numpy(), dmed_e.cpu().numpy(),
                                       wmed_e.cpu().numpy(), rep.cpu().numpy())
    cd, sd = _mixed_center_scale(dmed, gkey, n, baseline, "delay")
    cw, sw = _mixed_center_scale(wmed, gkey, n, baseline, "wait")
    res = _ref.slow_fold_kernel(*(a[None] for a in _to(dev, gkey, dmed, wmed, cd, sd, cw, sw)),
                                cfg.mad_threshold, cfg.row_col_fraction, cfg.min_observations,
                                n=n)
    return _fold_verdict_list(_host(res, 0), gkey, n), gkey, dmed, wmed
