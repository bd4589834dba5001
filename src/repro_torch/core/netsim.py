"""Flow-level network simulator: weighted max-min fair bandwidth allocation.

Stands in for the paper's 16-node RoCE testbed.  Flows are long-lived
elephant flows (collective connections); each flow follows an explicit link
path through the ``ClosTopology``.  Rates are computed by progressive
filling (water-filling), the standard fluid model for congestion-controlled
traffic; an optional CNP-style throttle adds the sender-side rate jitter the
paper observes in Fig. 10.

``max_min_rates`` runs on the vectorized ``FlowSet`` engine (see
``repro_torch.core.flowset`` and docs/netsim.md); the original scalar loop is kept
as ``max_min_rates_reference`` — the semantic oracle the engine is tested
against.

Ring-allreduce busbw: for a bandwidth-optimal ring, busbw equals the
minimum connection bandwidth along the ring, additionally capped by the
intra-host NVLink fabric (paper: 362 Gbps ceiling).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.flowset import FlowRates, FlowSet
from repro_torch.core.topology import ClosTopology, LinkId


@dataclass
class Flow:
    """One QP / one path of a (possibly multi-QP) connection."""
    flow_id: int
    job_id: int
    conn_id: Tuple            # (job, ring_edge, nic, port) — logical connection
    links: List[LinkId]
    weight: float = 1.0       # share of the connection's traffic on this QP
    demand_gbps: float = 0.0  # projected demand committed at allocation time


@dataclass
class RateResult:
    flow_rate: Dict[int, float]          # flow_id -> Gbps
    conn_rate: Dict[Tuple, float]        # conn_id -> aggregate Gbps
    link_util: Dict[LinkId, float]


def flowset_rate_result(fs: FlowSet, fr: FlowRates) -> RateResult:
    """Convert an array-form FlowRates into the dict-based RateResult API."""
    rate = dict(zip(fs.flow_ids.tolist(), fr.flow_rate.tolist()))
    conn = dict(zip(fs.conn_keys, fr.conn_rate.tolist()))
    util = {fs.links[i]: float(fr.link_util[i])
            for i in np.nonzero(fr.link_touched)[0]}
    return RateResult(rate, conn, util)


def max_min_rates(topo: ClosTopology, flows: Sequence[Flow],
                  cnp_jitter: float = 0.0, seed: int = 0, device=None) -> RateResult:
    """Weighted progressive filling. Flows through failed links get 0.

    Vectorized: factors the flows into a ``FlowSet`` incidence matrix and
    runs array-based filling.  Matches ``max_min_rates_reference`` within
    float tolerance (callers that loop — e.g. the dynamic load balancer —
    should build the ``FlowSet`` once and call ``FlowSet.max_min``).
    ``device``: where the torch backend's filling runs (``None``: the card)."""
    fs = FlowSet(topo, flows)
    return flowset_rate_result(fs, fs.max_min(cnp_jitter=cnp_jitter, seed=seed,
                                              device=device))


def max_min_rates_reference(topo: ClosTopology, flows: Sequence[Flow],
                            cnp_jitter: float = 0.0, seed: int = 0) -> RateResult:
    """Scalar reference implementation (the original dict-and-loop filling).

    Kept as the oracle for equivalence tests; O(links * rounds) Python —
    use ``max_min_rates`` everywhere else."""
    rng = np.random.default_rng(seed)
    active = [f for f in flows if all(topo.healthy(l) for l in f.links)]
    active_ids = {f.flow_id for f in active}
    dead = [f for f in flows if f.flow_id not in active_ids]
    by_id = {f.flow_id: f for f in active}

    # collect links
    link_cap: Dict[LinkId, float] = {}
    link_flows: Dict[LinkId, List[int]] = {}
    for f in active:
        for l in f.links:
            if l not in link_cap:
                cap = topo.link_capacity(l)
                if cnp_jitter:
                    cap *= float(1.0 - cnp_jitter * rng.uniform(0.0, 1.0))
                link_cap[l] = cap
                link_flows[l] = []
            link_flows[l].append(f.flow_id)

    weight = {f.flow_id: max(f.weight, 1e-9) for f in active}
    rate: Dict[int, float] = {}
    frozen: set = set()
    remaining = dict(link_cap)

    while len(frozen) < len(active):
        # bottleneck link: min( remaining / total unfrozen weight )
        best_link, best_share = None, np.inf
        for l, fl in link_flows.items():
            w = sum(weight[i] for i in fl if i not in frozen)
            if w <= 0:
                continue
            share = remaining[l] / w
            if share < best_share:
                best_share, best_link = share, l
        if best_link is None:
            break
        for i in link_flows[best_link]:
            if i in frozen:
                continue
            r = best_share * weight[i]
            rate[i] = r
            frozen.add(i)
            for l in by_id[i].links:
                remaining[l] = max(remaining[l] - r, 0.0)
        link_flows[best_link] = []

    for f in dead:
        rate[f.flow_id] = 0.0

    # Effective connection bandwidth: each QP i carries a fixed share w_i of
    # the connection's data, so completion is gated by the slowest QP
    # relative to its share: bw = min_i r_i / w_i (w normalised per conn).
    by_conn: Dict[Tuple, List[Flow]] = {}
    for f in flows:
        by_conn.setdefault(f.conn_id, []).append(f)
    conn: Dict[Tuple, float] = {}
    for cid, fl in by_conn.items():
        wsum = sum(max(f.weight, 1e-12) for f in fl)
        eff = np.inf
        for f in fl:
            w = max(f.weight, 1e-12) / wsum
            r = rate.get(f.flow_id, 0.0)
            eff = min(eff, r / w if w > 1e-9 else np.inf)
        conn[cid] = float(0.0 if not np.isfinite(eff) else eff)
    util = {l: link_cap.get(l, 0.0) - remaining.get(l, link_cap.get(l, 0.0))
            for l in link_cap}
    return RateResult(rate, conn, util)


# ---------------------------------------------------------------------------
# Collective modelling
# ---------------------------------------------------------------------------

def ring_edges(hosts: Sequence[int]) -> List[Tuple[int, int]]:
    n = len(hosts)
    return [(hosts[i], hosts[(i + 1) % n]) for i in range(n)]


def ring_allreduce_busbw(topo: ClosTopology, conn_rates: Dict[Tuple, float],
                         job_id: int, n_hosts: int) -> float:
    """busbw (Gbps) of a hierarchical ring allreduce for one job.

    The inter-host phase is rail-parallel: GPU g of each host talks to GPU g
    of the next host over NIC g, each rail moving 1/8 of the data.  nccl's
    busbw metric reflects per-GPU NIC utilisation, so the job's busbw is the
    minimum effective connection bandwidth over all (ring edge, rail)
    pairs — the slowest rail link gates every synchronised ring step —
    additionally capped by the intra-host NVLink fabric (paper: 362 Gbps)."""
    if n_hosts <= 1:
        return topo.nvlink_busbw_gbps
    rates = [v for k, v in conn_rates.items() if k[0] == job_id]
    if not rates:
        return 0.0
    return min(min(rates), topo.nvlink_busbw_gbps)


def allreduce_time_s(size_bytes: float, busbw_gbps: float, n_ranks: int) -> float:
    """Time of one allreduce of ``size_bytes`` given measured busbw."""
    if busbw_gbps <= 0:
        return float("inf")
    alg = busbw_gbps / (2 * (n_ranks - 1) / n_ranks) if n_ranks > 1 else busbw_gbps
    return size_bytes * 8 / (alg * 1e9)
