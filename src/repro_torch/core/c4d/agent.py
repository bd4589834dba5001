"""C4a — the per-node C4 agent (paper Fig. 4).

The agent is the intermediary between the enhanced CCL (which emits raw
records on every rank of the node) and the central C4D master.  To keep the
monitoring cost low it batches records per window and *prefilters*: healthy
transport records are aggregated into per-edge summaries, while suspicious
records (robust z-score above a loose local threshold) are forwarded raw.

``prefilter_arrays`` is the vectorized fleet-scale equivalent: it runs the
per-node batching + prefiltering of *every* agent in one pass over a
struct-of-arrays window and emits the master-side merged window directly,
producing the same per-edge medians and raw suspects as ``C4Agent.collect``
+ ``reports_to_window`` (equivalence pinned in
tests/test_c4d_vectorized.py).  Copy of ``repro.core.c4d.agent`` for the
port; ``prefilter_arrays`` also takes the torch backend's ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.c4d.telemetry import (Heartbeat, TelemetryArrays,
                                      TelemetryWindow, TransportRecord,
                                      grouped_median)


@dataclass
class EdgeSummary:
    src_rank: int
    dst_rank: int
    count: int
    median_transfer: float
    median_wait: float
    max_transfer: float
    total_bytes: int


@dataclass
class AgentReport:
    node_id: int
    window_id: int
    summaries: List[EdgeSummary] = field(default_factory=list)
    raw_suspects: List[TransportRecord] = field(default_factory=list)
    heartbeats: List[Heartbeat] = field(default_factory=list)
    ops_count: int = 0


class C4Agent:
    """Per-node batching + prefiltering agent (paper §3.1, Fig. 4).

    ``suspect_z`` is the loose *local* robust-z threshold: records above it
    are forwarded raw to the master (the tight decision threshold lives in
    ``detector.DetectorConfig.mad_threshold``); everything else collapses
    into per-edge medians, keeping monitoring overhead sub-1 %."""

    def __init__(self, node_id: int, ranks: Sequence[int],
                 suspect_z: float = 3.0):
        self.node_id = node_id
        self.ranks = set(ranks)
        self.suspect_z = suspect_z

    def collect(self, window: TelemetryWindow) -> AgentReport:
        """Batch this node's records for one window."""
        mine_t = [t for t in window.transports if t.src_rank in self.ranks]
        mine_h = [h for h in window.heartbeats if h.rank in self.ranks]
        mine_o = [o for o in window.ops if o.rank in self.ranks]
        report = AgentReport(self.node_id, window.window_id,
                             heartbeats=mine_h, ops_count=len(mine_o))
        by_edge: Dict[Tuple[int, int], List[TransportRecord]] = {}
        for t in mine_t:
            by_edge.setdefault((t.src_rank, t.dst_rank), []).append(t)
        transfers = np.array([t.transfer for t in mine_t]) if mine_t else np.array([1.0])
        med = float(np.median(transfers))
        mad = float(np.median(np.abs(transfers - med))) * 1.4826 + 1e-12
        for (s, r), recs in sorted(by_edge.items()):
            ts = np.array([t.transfer for t in recs])
            ws = np.array([t.wait for t in recs])
            report.summaries.append(EdgeSummary(
                s, r, len(recs), float(np.median(ts)), float(np.median(ws)),
                float(ts.max()), int(sum(t.msg_bytes for t in recs))))
            for t in recs:
                if (t.transfer - med) / mad > self.suspect_z:
                    report.raw_suspects.append(t)
        return report


def reports_to_window(reports: Sequence[AgentReport],
                      template: TelemetryWindow) -> TelemetryWindow:
    """Master-side reassembly: summaries become representative transport
    records (median latency per edge), suspects are kept raw."""
    win = TelemetryWindow(window_id=template.window_id, comms=template.comms,
                          t_begin=template.t_begin, t_end=template.t_end,
                          train=template.train)
    for rep in reports:
        win.heartbeats.extend(rep.heartbeats)
        for s in rep.summaries:
            win.transports.append(TransportRecord(
                iteration=-1, src_rank=s.src_rank, dst_rank=s.dst_rank,
                msg_bytes=s.total_bytes // max(s.count, 1),
                t_post=0.0, t_start=s.median_wait,
                t_end=s.median_wait + s.median_transfer))
        win.transports.extend(rep.raw_suspects)
    return win


def prefilter_arrays(window: TelemetryArrays, ranks_per_node: int,
                     suspect_z: float = 3.0,
                     n_ranks: Optional[int] = None,
                     backend: Optional[str] = None,
                     device=None) -> TelemetryArrays:
    """All agents' collect + master reassembly, vectorized (paper Fig. 4).

    One pass over the struct-of-arrays window:

      1. per-node robust statistics (median / MAD of the node's transfer
         latencies) flag raw suspects above ``suspect_z``,
      2. per-edge grouped medians become the representative summary records
         (``t_start = median wait``, ``t_end = median wait + median
         transfer``, bytes = total // count — the exact reassembly
         arithmetic of ``reports_to_window``),
      3. heartbeats pass through untouched.

    Returns the merged master-side window; downstream detection on it is
    verdict-identical to the scalar agent path.  ``backend``/``device``
    select where the two plain grouped medians (node MAD, edge wait) run;
    the two that also return the group structure stay NumPy.
    """
    n = n_ranks or window.n_ranks()
    transfer = window.tr_transfer()
    wait = window.tr_wait()
    node = window.tr_src // ranks_per_node

    if transfer.size:
        # per-node median / MAD, mapped back onto each record
        _, node_med, _, idx = grouped_median(node, transfer,
                                             return_groups=True)
        absdev = np.abs(transfer - node_med[idx])
        _, node_mad = grouped_median(node, absdev, backend=backend,
                                     device=device)
        mad = node_mad * 1.4826 + 1e-12
        suspect = (transfer - node_med[idx]) / mad[idx] > suspect_z

        key = window.tr_src * n + window.tr_dst
        uk, med_t, counts, edge_of = grouped_median(key, transfer,
                                                    return_groups=True)
        _, med_w = grouped_median(key, wait, backend=backend, device=device)
        byte_sum = np.zeros(uk.size, np.int64)
        np.add.at(byte_sum, edge_of, window.tr_bytes)

        m_src = np.r_[uk // n, window.tr_src[suspect]]
        m_dst = np.r_[uk % n, window.tr_dst[suspect]]
        m_bytes = np.r_[byte_sum // np.maximum(counts, 1),
                        window.tr_bytes[suspect]]
        m_post = np.r_[np.zeros(uk.size), window.tr_post[suspect]]
        m_start = np.r_[med_w, window.tr_start[suspect]]
        m_end = np.r_[med_w + med_t, window.tr_end[suspect]]
    else:
        m_src = m_dst = np.empty(0, np.int64)
        m_bytes = np.empty(0, np.int64)
        m_post = m_start = m_end = np.empty(0)

    return TelemetryArrays(
        window_id=window.window_id, comms=list(window.comms),
        tr_src=m_src, tr_dst=m_dst, tr_bytes=m_bytes,
        tr_post=m_post, tr_start=m_start, tr_end=m_end,
        hb_rank=window.hb_rank, hb_seq=window.hb_seq, hb_t=window.hb_t,
        t_begin=window.t_begin, t_end=window.t_end,
        # train signals ride past the prefilter untouched: they are already
        # one summary row per rank, there is nothing to batch
        train=window.train)
