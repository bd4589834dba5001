"""C4P static traffic engineering: per-connection path allocation.

Paper section 3.2: "On connections setup, the CCL prompts path requests to
the C4P master, which responses selected path by specifying the source
ports of RDMA connections. The master ensures traffic from the same NIC is
balanced between left and right ports by forbidding the paths from left
ports to right, and vice versa. Additionally, traffic from servers under
the same leaf switch is distributed over all available spine switches."

Implementation: greedy least-projected-load assignment with deterministic
tie-breaking, subject to
  (1) port affinity: a flow entering on the left port exits on the left
      port (bonded-port balance, Fig. 8),
  (2) spine spreading: per (src_leaf, dst_leaf) the chosen spines cycle
      through the healthy spine set ordered by current projected load,
  (3) blacklisted links are never used.

The allocator keeps *normalized* projected-load arrays for the leaf-spine
tier (load / capacity, indexed [leaf, spine] and [spine, leaf]) alongside
the public ``projected_load`` dict, so ranking candidate spines is two array
gathers instead of re-deriving and re-scanning every candidate path.  Path
link-lists themselves come from the topology's memoized ``path_links``
table.

ECMP baseline (`ecmp_allocate`) hashes (five-tuple, seed) to a random spine
and random destination port — the collision-prone behaviour C4P replaces.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.c4p.probing import LinkHealthMonitor
from repro_torch.core.netsim import Flow
from repro_torch.core.topology import ClosTopology, LinkId


@dataclass
class ConnRequest:
    """A logical connection (one ring edge on one NIC rail)."""
    job_id: int
    src_host: int
    dst_host: int
    nic: int
    edge: Tuple[int, int]        # ring edge id (src_host, dst_host)


class PathAllocator:
    """The C4P master's allocation core (paper §3.2: static traffic
    engineering at connection setup).  Tracks projected load per link so
    successive (multi-job) requests spread over the fabric — this is what
    removes the ECMP hash collisions behind Fig. 8/9."""

    def __init__(self, topo: ClosTopology, health: Optional[LinkHealthMonitor] = None):
        self.topo = topo
        self.health = health or LinkHealthMonitor(topo)
        self.projected_load: Dict[LinkId, float] = {}
        self._next_flow_id = 0
        self._inv_cap: Dict[LinkId, float] = {}
        self._ls_inv_cap = 1.0 / topo.leaf_spine_capacity()
        # normalized (load/capacity) leaf-spine tier, for vectorized ranking
        self._ls_norm = np.zeros((topo.n_leaves, topo.n_spines))
        self._sl_norm = np.zeros((topo.n_spines, topo.n_leaves))

    def _inv(self, link: LinkId) -> float:
        v = self._inv_cap.get(link)
        if v is None:
            v = self._inv_cap[link] = 1.0 / self.topo.link_capacity(link)
        return v

    def _commit(self, links: Sequence[LinkId], demand: float) -> None:
        pl = self.projected_load
        for l in links:
            pl[l] = pl.get(l, 0.0) + demand
            if l[0] == "ls":
                self._ls_norm[l[1], l[2]] += demand * self._ls_inv_cap
            elif l[0] == "sl":
                self._sl_norm[l[1], l[2]] += demand * self._ls_inv_cap

    def _uncommit(self, links: Sequence[LinkId], demand: float) -> None:
        pl = self.projected_load
        for l in links:
            cur = pl.get(l)
            if cur is None:
                continue
            dec = min(cur, demand)        # never drive below zero
            new = cur - dec
            if new <= 1e-9:
                # prune: long multi-job sweeps must not grow the dict
                del pl[l]
                new = 0.0
            else:
                pl[l] = new
            if l[0] == "ls":
                self._ls_norm[l[1], l[2]] = max(
                    self._ls_norm[l[1], l[2]] - dec * self._ls_inv_cap, 0.0)
            elif l[0] == "sl":
                self._sl_norm[l[1], l[2]] = max(
                    self._sl_norm[l[1], l[2]] - dec * self._ls_inv_cap, 0.0)

    def allocate(self, req: ConnRequest, demand_gbps: float = 200.0,
                 qps_per_port: int = 1) -> List[Flow]:
        """Allocate both bonded ports of the NIC for this connection.

        Port affinity: src left -> dst left, src right -> dst right. Each
        port's traffic may be split over ``qps_per_port`` QPs on distinct
        spines (the units the dynamic load balancer later re-weights)."""
        topo = self.topo
        flows: List[Flow] = []
        for port in (0, 1):
            src_leaf = topo.leaf_of(req.src_host, req.nic, port)
            dst_leaf = topo.leaf_of(req.dst_host, req.nic, port)
            per_qp = demand_gbps / (2 * qps_per_port)
            if src_leaf == dst_leaf:
                # same-leaf: switched directly at the leaf, no spine tier
                cand = None
            else:
                spines = self.health.usable_spines(src_leaf, dst_leaf)
                cand = np.asarray(spines, dtype=np.int64) if spines else None
            for q in range(qps_per_port):
                if cand is None:
                    s = None
                else:
                    up = ("up", req.src_host, req.nic, port)
                    down = ("down", req.dst_host, req.nic, port)
                    pl = self.projected_load
                    base = max(pl.get(up, 0.0) * self._inv(up),
                               pl.get(down, 0.0) * self._inv(down))
                    score = np.maximum(
                        np.maximum(self._ls_norm[src_leaf, cand],
                                   self._sl_norm[cand, dst_leaf]), base)
                    s = int(cand[np.lexsort((cand, score))[0]])
                links = topo.path_links(req.src_host, req.dst_host,
                                        req.nic, port, port, s)
                self._commit(links, per_qp)
                flows.append(Flow(self._next_flow_id, req.job_id,
                                  (req.job_id, req.edge, req.nic),
                                  links, weight=0.5 / qps_per_port,
                                  demand_gbps=per_qp))
                self._next_flow_id += 1
        return flows

    def release_job(self, job_id: int, flows: Sequence[Flow]) -> None:
        """Return a finished job's projected load to the pool; fully drained
        links are pruned from ``projected_load``."""
        for f in flows:
            if f.job_id != job_id:
                continue
            self._uncommit(f.links, f.demand_gbps)


def ecmp_failover(topo: ClosTopology, flows: Sequence[Flow], seed: int = 0) -> None:
    """What happens WITHOUT C4P dynamic LB when a link dies: the NIC/fabric
    re-hashes the affected QPs onto a random surviving spine (port
    unchanged), with no load awareness and no re-weighting (Fig. 11a/12a)."""
    rng = np.random.default_rng(seed)
    for f in flows:
        if all(topo.healthy(l) for l in f.links):
            continue
        up = next((l for l in f.links if l[0] == "up"), None)
        down = next((l for l in f.links if l[0] == "down"), None)
        if up is None or down is None:
            continue  # leaf-local / degenerate path: nothing to re-hash
        _, src_host, nic, src_port = up
        _, dst_host, _, dst_port = down
        src_leaf = topo.leaf_of(src_host, nic, src_port)
        dst_leaf = topo.leaf_of(dst_host, nic, dst_port)
        spines = [s for s in range(topo.n_spines)
                  if topo.healthy(("ls", src_leaf, s)) and topo.healthy(("sl", s, dst_leaf))]
        if not spines or src_leaf == dst_leaf:
            continue
        spine = int(rng.choice(spines))
        f.links = topo.path_links(src_host, dst_host, nic, src_port, dst_port, spine)


def ecmp_allocate(topo: ClosTopology, reqs: Sequence[ConnRequest],
                  seed: int = 0, qps_per_port: int = 1,
                  port_affine: bool = False) -> List[Flow]:
    """Baseline: ECMP-style random spine + random destination port per flow
    (bond hashing), ignoring load and port affinity.  ``port_affine=True``
    keeps left->left / right->right (bond drivers that hash only the spine
    path) — used to isolate spine-collision effects (Fig. 2)."""
    rng = np.random.default_rng(seed)
    flows: List[Flow] = []
    fid = 0
    for req in reqs:
        for port in (0, 1):
            for q in range(qps_per_port):
                dst_port = port if port_affine else int(rng.integers(0, 2))
                src_leaf = topo.leaf_of(req.src_host, req.nic, port)
                dst_leaf = topo.leaf_of(req.dst_host, req.nic, dst_port)
                spine = int(rng.integers(0, topo.n_spines)) if src_leaf != dst_leaf else None
                links = topo.path_links(req.src_host, req.dst_host, req.nic,
                                        port, dst_port, spine)
                flows.append(Flow(fid, req.job_id,
                                  (req.job_id, req.edge, req.nic),
                                  links, weight=0.5 / qps_per_port))
                fid += 1
    return flows
