"""Enhanced-CCL telemetry model (paper Fig. 5).

Copy of ``repro.core.c4d.telemetry`` for the port; only ``grouped_median``
(and the matrix folds that thread its ``backend``/``device``) differ: their
accelerated branch is the torch backend (``core.torchsim``).

The paper extends the bottom three layers of the collective communication
library with monitoring:

  communicator layer  -> communicator IDs, rank counts, rank assignments
  operation layer     -> op type, algorithm, dtype, element count, durations
  transport layer     -> connection specifics (QP), message counts/sizes/durations

In the reproduction these records are produced either by the cluster
simulator (full transport fidelity, from the netsim) or by the trainer's
host-side step hooks (step-level timings on real runs).  Records are plain
dataclasses; the C4a agent batches them, the C4D master analyses them.

Two window representations share one schema:

  * ``TelemetryWindow`` — lists of per-record dataclasses.  This is the
    readable scalar reference; every analysis stays pinned against it
    (tests/test_c4d_vectorized.py).
  * ``TelemetryArrays`` — the same window as a struct-of-arrays (one NumPy
    column per field over ranks/ops/transports).  This is the hot path the
    Monte Carlo fleet campaigns run at 1024-4096 simulated GPUs
    (docs/detection.md covers the layout).

``delay_matrix`` / ``wait_matrix`` accept either form and fold transports
into the paper's Fig. 6 per-pair median matrices; on ``TelemetryArrays``
the fold is a vectorized grouped median (sort by pair key, slice group
medians) that is bit-identical to the per-pair ``np.median`` of the scalar
path.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

import numpy as np


@dataclass(frozen=True)
class CommunicatorInfo:
    comm_id: int
    n_ranks: int
    ranks: Tuple[int, ...]        # global rank ids
    kind: str = "dp"              # dp | tp | pp | ep


@dataclass(frozen=True)
class OpRecord:
    """Operation layer: one collective operation on one rank."""
    iteration: int
    rank: int
    comm_id: int
    op_type: str                  # allreduce | allgather | reducescatter | ...
    algorithm: str                # ring | tree
    dtype: str
    element_count: int
    t_start: float                # seconds (simulated or host clock)
    t_end: float
    seq: int                      # per-rank monotonically increasing op counter

    @property
    def duration(self) -> float:
        return self.t_end - self.t_start


@dataclass(frozen=True)
class TransportRecord:
    """Transport layer: one message between two ranks.

    ``t_post``  - receiver posted the buffer / sender notified (schedule)
    ``t_start`` - first byte on the wire
    ``t_end``   - completion
    The receiver-driven wait (t_start - t_post) is the signal for
    *non-communication* slowness (paper Case 2); the transfer duration
    normalised by size is the signal for *communication* slowness (Case 1).
    """
    iteration: int
    src_rank: int
    dst_rank: int
    msg_bytes: int
    t_post: float
    t_start: float
    t_end: float
    qp: int = 0

    @property
    def wait(self) -> float:
        return self.t_start - self.t_post

    @property
    def transfer(self) -> float:
        return max(self.t_end - self.t_start, 1e-9)

    @property
    def per_byte_latency(self) -> float:
        return self.transfer / max(self.msg_bytes, 1)


@dataclass(frozen=True)
class Heartbeat:
    rank: int
    iteration: int
    seq: int                      # last completed op sequence number
    t: float


@dataclass(eq=False)
class TrainSignals:
    """Per-rank training-side signals for one monitoring window.

    The divergence channel (Flare, arXiv 2502.05413): anomalies that never
    touch the network — silent data corruption drifting a rank's gradient
    norm, loss spikes, a rank emitting NaN/overflow — are invisible to the
    transport-layer matrices, so the trainer's step hooks export one row
    per rank and the ``c4d.divergence`` detector analyses them next to the
    comm syndromes.  Struct-of-arrays like ``TelemetryArrays``: column ``i``
    across all four arrays is one rank's window summary.
    """
    rank: np.ndarray              # int64 global rank ids
    loss: np.ndarray              # mean per-rank microbatch loss
    grad_norm: np.ndarray         # pre-clip local gradient norm
    overflow: np.ndarray          # int64 count of overflow/NaN events

    def n_ranks(self) -> int:
        return int(self.rank.max()) + 1 if self.rank.size else 0


@dataclass
class TelemetryWindow:
    """Everything the master sees for one monitoring window."""
    window_id: int
    comms: List[CommunicatorInfo] = field(default_factory=list)
    ops: List[OpRecord] = field(default_factory=list)
    transports: List[TransportRecord] = field(default_factory=list)
    heartbeats: List[Heartbeat] = field(default_factory=list)
    t_begin: float = 0.0
    t_end: float = 0.0
    # training-side divergence channel; None = not exported (the default —
    # every pre-divergence consumer and golden is untouched)
    train: Optional[TrainSignals] = None

    def n_ranks(self) -> int:
        m = 0
        for c in self.comms:
            m = max(m, max(c.ranks) + 1)
        for t in self.transports:
            m = max(m, t.src_rank + 1, t.dst_rank + 1)
        for h in self.heartbeats:
            m = max(m, h.rank + 1)
        return m


# ---------------------------------------------------------------------------
# Struct-of-arrays window (vectorized hot path)
# ---------------------------------------------------------------------------

@dataclass(eq=False)
class TelemetryArrays:
    """One monitoring window as a struct-of-arrays (paper Fig. 5 layers).

    Column ``i`` across the ``tr_*`` arrays is one transport record, across
    the ``hb_*`` arrays one heartbeat, and across the ``op_*`` arrays one
    operation-layer record.  Holding columns instead of dataclass lists is
    what lets the detectors, the C4a prefilter, and the telemetry
    synthesiser run as whole-array NumPy expressions — the layout change
    behind the >=10x detection-pipeline speedup at 1024 ranks
    (benchmarks/bench_detection_latency.py, docs/detection.md).

    ``from_window``/``to_window`` convert to/from the scalar
    ``TelemetryWindow`` losslessly (ops carry only the fields the pipeline
    consumes), which is how the equivalence tests pin the two paths
    together.
    """
    window_id: int
    comms: List[CommunicatorInfo] = field(default_factory=list)
    # transport layer
    tr_src: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    tr_dst: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    tr_bytes: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    tr_post: np.ndarray = field(default_factory=lambda: np.empty(0))
    tr_start: np.ndarray = field(default_factory=lambda: np.empty(0))
    tr_end: np.ndarray = field(default_factory=lambda: np.empty(0))
    # heartbeats
    hb_rank: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    hb_seq: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    hb_t: np.ndarray = field(default_factory=lambda: np.empty(0))
    # operation layer (the subset the pipeline consumes)
    op_rank: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    op_seq: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    t_begin: float = 0.0
    t_end: float = 0.0
    # training-side divergence channel (shared with TelemetryWindow)
    train: Optional[TrainSignals] = None

    # -- derived columns (same semantics as TransportRecord properties) ----
    def tr_transfer(self) -> np.ndarray:
        return np.maximum(self.tr_end - self.tr_start, 1e-9)

    def tr_wait(self) -> np.ndarray:
        return self.tr_start - self.tr_post

    def n_ranks(self) -> int:
        m = 0
        for c in self.comms:
            m = max(m, max(c.ranks) + 1)
        if self.tr_src.size:
            m = max(m, int(self.tr_src.max()) + 1, int(self.tr_dst.max()) + 1)
        if self.hb_rank.size:
            m = max(m, int(self.hb_rank.max()) + 1)
        return m

    # -- conversions -------------------------------------------------------
    @classmethod
    def from_window(cls, win: TelemetryWindow) -> "TelemetryArrays":
        """Pack a scalar window's record lists into columns."""
        tr = win.transports
        hb = win.heartbeats
        return cls(
            window_id=win.window_id, comms=list(win.comms),
            tr_src=np.fromiter((t.src_rank for t in tr), np.int64, len(tr)),
            tr_dst=np.fromiter((t.dst_rank for t in tr), np.int64, len(tr)),
            tr_bytes=np.fromiter((t.msg_bytes for t in tr), np.int64, len(tr)),
            tr_post=np.fromiter((t.t_post for t in tr), float, len(tr)),
            tr_start=np.fromiter((t.t_start for t in tr), float, len(tr)),
            tr_end=np.fromiter((t.t_end for t in tr), float, len(tr)),
            hb_rank=np.fromiter((h.rank for h in hb), np.int64, len(hb)),
            hb_seq=np.fromiter((h.seq for h in hb), np.int64, len(hb)),
            hb_t=np.fromiter((h.t for h in hb), float, len(hb)),
            op_rank=np.fromiter((o.rank for o in win.ops), np.int64, len(win.ops)),
            op_seq=np.fromiter((o.seq for o in win.ops), np.int64, len(win.ops)),
            t_begin=win.t_begin, t_end=win.t_end, train=win.train)

    def to_window(self) -> TelemetryWindow:
        """Unpack into the scalar representation (equivalence tests)."""
        win = TelemetryWindow(window_id=self.window_id, comms=list(self.comms),
                              t_begin=self.t_begin, t_end=self.t_end,
                              train=self.train)
        for i in range(self.tr_src.size):
            win.transports.append(TransportRecord(
                iteration=-1, src_rank=int(self.tr_src[i]),
                dst_rank=int(self.tr_dst[i]), msg_bytes=int(self.tr_bytes[i]),
                t_post=float(self.tr_post[i]), t_start=float(self.tr_start[i]),
                t_end=float(self.tr_end[i])))
        for i in range(self.hb_rank.size):
            win.heartbeats.append(Heartbeat(
                rank=int(self.hb_rank[i]), iteration=-1,
                seq=int(self.hb_seq[i]), t=float(self.hb_t[i])))
        return win


AnyWindow = Union[TelemetryWindow, TelemetryArrays]


def grouped_median(keys: np.ndarray, values: np.ndarray,
                   return_groups: bool = False,
                   backend: Optional[str] = None,
                   device=None) -> Tuple[np.ndarray, ...]:
    """Median of ``values`` per distinct key, vectorized.

    Sorts once by (key, value) and reads each group's middle element(s);
    returns (sorted unique keys, medians).  Bit-identical to calling
    ``np.median`` per group: both reduce the same multiset, and the
    even-count mean ``0.5 * (a + b)`` equals NumPy's ``(a + b) / 2``.

    With ``return_groups`` also returns (counts per group, inverse index
    mapping each input element to its group), so callers that need
    per-group sums or element->group lookups reuse this sort instead of
    re-sorting (``agent.prefilter_arrays`` on the campaign hot path).

    ``backend="torch"`` (the port's default, see ``core.torchsim``) groups
    the keys on the host (a layout cached across calls with equal keys) and
    selects each group's middle order statistics on ``device`` (``None``:
    the card) with the row-select entry of ``kernels/csrc/window_score.cu``
    — same keys, bit-equal medians, for any float64 values (negative,
    signed zeros, infinities, NaN) and any group size.  The
    group-structure variant stays NumPy: its consumers are host-side
    prefilters.
    """
    from repro_torch.core.torchsim import effective_backend
    if (not return_groups
            and effective_backend(backend, elements=keys.size) == "torch"):
        from repro_torch.core.torchsim.detectors import grouped_median_torch
        return grouped_median_torch(keys, values, device)
    order = np.lexsort((values, keys))
    k = keys[order]
    v = values[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])
    counts = np.diff(np.r_[starts, k.size])
    lo = v[starts + (counts - 1) // 2]
    hi = v[starts + counts // 2]
    med = 0.5 * (lo + hi)
    if not return_groups:
        return k[starts], med
    inverse = np.empty(k.size, np.int64)
    inverse[order] = np.repeat(np.arange(starts.size), counts)
    return k[starts], med, counts, inverse


def _pair_matrix(arr: TelemetryArrays, values: np.ndarray, n: int,
                 backend: Optional[str] = None, device=None) -> np.ndarray:
    keys = arr.tr_src * n + arr.tr_dst
    uk, med = grouped_median(keys, values, backend=backend, device=device)
    m = np.full((n, n), np.nan)
    m[uk // n, uk % n] = med
    return m


def delay_matrix(window: AnyWindow, n_ranks: Optional[int] = None,
                 use_bandwidth: bool = False,
                 backend: Optional[str] = None, device=None) -> np.ndarray:
    """Fold transport records into the paper's Fig. 6 matrix.

    D[src, dst] = median transfer latency (normalised per byte) between the
    pair; NaN where no traffic was observed.  ``TelemetryArrays`` input
    takes the vectorized grouped-median path (``backend`` selects the
    NumPy or torch fold — bit-equal, see ``core.torchsim``); ``TelemetryWindow``
    input is the scalar reference the vectorized fold is pinned against."""
    n = n_ranks or window.n_ranks()
    if isinstance(window, TelemetryArrays):
        if window.tr_src.size == 0:
            return np.full((n, n), np.nan)
        transfer = window.tr_transfer()
        v = (window.tr_bytes / transfer if use_bandwidth
             else transfer / np.maximum(window.tr_bytes, 1))
        return _pair_matrix(window, v, n, backend=backend, device=device)
    acc: Dict[Tuple[int, int], List[float]] = {}
    for t in window.transports:
        v = (t.msg_bytes / t.transfer) if use_bandwidth else t.per_byte_latency
        acc.setdefault((t.src_rank, t.dst_rank), []).append(v)
    d = np.full((n, n), np.nan)
    for (s, r), vals in acc.items():
        d[s, r] = float(np.median(vals))
    return d


def wait_matrix(window: AnyWindow, n_ranks: Optional[int] = None,
                backend: Optional[str] = None, device=None) -> np.ndarray:
    """W[src, dst] = median receiver wait on the (src -> dst) edge."""
    n = n_ranks or window.n_ranks()
    if isinstance(window, TelemetryArrays):
        if window.tr_src.size == 0:
            return np.full((n, n), np.nan)
        return _pair_matrix(window, window.tr_wait(), n, backend=backend,
                            device=device)
    acc: Dict[Tuple[int, int], List[float]] = {}
    for t in window.transports:
        acc.setdefault((t.src_rank, t.dst_rank), []).append(t.wait)
    w = np.full((n, n), np.nan)
    for (s, r), vals in acc.items():
        w[s, r] = float(np.median(vals))
    return w
