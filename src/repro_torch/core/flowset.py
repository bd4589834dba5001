"""Vectorized flow-set engine: array-of-structs flows + incremental filling.

The scalar ``max_min_rates`` in ``netsim.py`` walks Python dicts per link
per round, which costs seconds per call at 1024-GPU scale (2048 flows on a
128-host Clos).  ``FlowSet`` factors the flow->link structure once into a
CSR/COO incidence matrix so each water-filling round is a handful of NumPy
reductions:

  * ``pair_flow``/``pair_link`` — COO (flow row, link column) incidence,
    row-major, so per-link unfrozen-weight sums and per-flow capacity
    decrements are ``np.bincount`` scatter-adds;
  * ``base_cap`` — interned per-link capacities (jitter is applied per call);
  * ``conn_idx`` — interned connection ids for the per-connection
    slowest-QP aggregation.

The structure is reusable: ``refresh()`` re-reads weights (and re-derives
incidence only for flows whose path object changed), so the dynamic load
balancer pays factorisation once for its 12 re-weighting rounds, and the
C4P master keeps one ``FlowSet`` alive across ``evaluate`` calls.

Semantics match ``max_min_rates_reference`` exactly up to float tolerance:
ties in the bottleneck share are frozen simultaneously (equal-share links
stay equal after a joint freeze, so this is the same fixed point the
one-link-at-a-time reference reaches).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.topology import ClosTopology, LinkId


@dataclass
class FlowRates:
    """Array-form allocation result, row-aligned with the owning FlowSet."""
    flow_rate: np.ndarray        # (F,) Gbps per flow row
    conn_rate: np.ndarray        # (C,) Gbps per interned connection
    link_util: np.ndarray        # (L,) Gbps per interned link
    link_touched: np.ndarray     # (L,) bool: link carried >=1 healthy flow
    flow_alive: np.ndarray       # (F,) bool: all links on the path healthy


class FlowSet:
    """CSR view of a set of ``Flow``s over one topology.

    Rows are positional (row ``i`` is ``flows[i]``); ``flow_links`` stores
    *references* to each flow's path list so a path swap (``f.links = new``)
    is detected by identity in ``refresh()`` and triggers a re-factor of
    only the incidence arrays.
    """

    def __init__(self, topo: ClosTopology, flows: Sequence):
        self.topo = topo
        flows = list(flows)
        n = len(flows)
        self.n_flows = n
        self.flow_ids = np.fromiter((f.flow_id for f in flows),
                                    dtype=np.int64, count=n)
        self.job_ids = np.fromiter((f.job_id for f in flows),
                                   dtype=np.int64, count=n)
        self.weights = np.fromiter((f.weight for f in flows),
                                   dtype=np.float64, count=n)
        self.demands = np.fromiter((f.demand_gbps for f in flows),
                                   dtype=np.float64, count=n)
        conn_index: Dict[Tuple, int] = {}
        conn_idx = np.empty(n, dtype=np.int64)
        for i, f in enumerate(flows):
            ci = conn_index.get(f.conn_id)
            if ci is None:
                ci = conn_index[f.conn_id] = len(conn_index)
            conn_idx[i] = ci
        self.conn_keys: List[Tuple] = list(conn_index)
        self.conn_idx = conn_idx
        self.n_conns = len(self.conn_keys)

        self.flow_links: List[List[LinkId]] = [f.links for f in flows]
        self.link_index: Dict[LinkId, int] = {}
        self.links: List[LinkId] = []
        self._cap_list: List[float] = []
        self._pairs_dirty = True
        self._ensure_pairs()

    # ---- structure maintenance -------------------------------------------
    def _ensure_pairs(self) -> None:
        if not self._pairs_dirty:
            return
        intern, links, caps = self.link_index, self.links, self._cap_list
        topo = self.topo
        pf: List[int] = []
        pl: List[int] = []
        for i, path in enumerate(self.flow_links):
            for l in path:
                li = intern.get(l)
                if li is None:
                    li = intern[l] = len(links)
                    links.append(l)
                    caps.append(topo.link_capacity(l))
                pf.append(i)
                pl.append(li)
        self.pair_flow = np.asarray(pf, dtype=np.int64)
        self.pair_link = np.asarray(pl, dtype=np.int64)
        self.base_cap = np.asarray(caps, dtype=np.float64)
        self.n_links = len(links)
        self._pairs_dirty = False
        self._by_link = {}       # device -> the incidence by link and by flow, on it

    def set_links(self, row: int, links: List[LinkId]) -> None:
        """Point flow ``row`` at a new path (e.g. after a re-route)."""
        self.flow_links[row] = links
        self._pairs_dirty = True

    def set_weights(self, weights: np.ndarray) -> None:
        self.weights = np.asarray(weights, dtype=np.float64)

    def refresh(self, flows: Sequence) -> None:
        """Re-sync weights and any swapped path lists from the Flow objects
        (row order must match construction order)."""
        n = self.n_flows
        self.weights = np.fromiter((f.weight for f in flows),
                                   dtype=np.float64, count=n)
        fl = self.flow_links
        for i, f in enumerate(flows):
            if fl[i] is not f.links:
                fl[i] = f.links
                self._pairs_dirty = True

    # ---- health -----------------------------------------------------------
    def alive_mask(self) -> np.ndarray:
        """Flows whose every link is healthy on the current topology."""
        self._ensure_pairs()
        down = self.topo.down_links
        if not down:
            return np.ones(self.n_flows, dtype=bool)
        link_down = np.fromiter((l in down for l in self.links),
                                dtype=bool, count=self.n_links)
        dead_pairs = link_down[self.pair_link]
        if not dead_pairs.any():
            return np.ones(self.n_flows, dtype=bool)
        hits = np.bincount(self.pair_flow[dead_pairs], minlength=self.n_flows)
        return hits == 0

    # ---- the engine -------------------------------------------------------
    def max_min(self, cnp_jitter: float = 0.0, seed: int = 0,
                backend: Optional[str] = None, device=None) -> FlowRates:
        """Weighted progressive filling over the incidence matrix.

        Each round: per-link unfrozen weight via scatter-add, global
        bottleneck share via an array min, then every flow on a link at the
        bottleneck share freezes at ``share * weight`` and its capacity is
        returned by one more scatter-add.  Exact-tie links freeze together
        (see module docstring for why that matches the scalar reference).

        ``backend`` resolves as the detection backend does (``None``: the
        engine's ``use_backend`` scope, else the port's default ``torch``).
        At ``torch`` the filling loop runs as ``kernels/waterfill.py`` on
        ``device`` (``None``: the card, raising without one; ``"cpu"``: its
        plain version); its rates are the NumPy loop's bit for bit, so the
        drill and campaign goldens hold at either backend.  Jitter draws and
        the connection/utilisation epilogue stay in NumPy either way, and a
        ``numpy`` run never touches a device.
        """
        self._ensure_pairs()
        F, L = self.n_flows, self.n_links
        pair_flow, pair_link = self.pair_flow, self.pair_link
        cap = self.base_cap.copy()
        if cnp_jitter:
            rng = np.random.default_rng(seed)
            cap *= 1.0 - cnp_jitter * rng.uniform(0.0, 1.0, size=L)

        alive = self.alive_mask()
        w = np.maximum(self.weights, 1e-9)
        pair_w = w[pair_flow]
        alive_pairs = alive[pair_flow]
        touched = np.zeros(L, dtype=bool)
        if alive_pairs.any():
            touched[pair_link[alive_pairs]] = True

        from repro_torch.core.torchsim import effective_backend
        if effective_backend(backend, flows=F) == "torch" and F and L:
            rate, remaining = self._fill_torch(w, alive, cap, device)
            return self._finish(rate, remaining, cap, touched, alive)

        unfrozen = alive.copy()
        rate = np.zeros(F)
        remaining = cap.copy()
        share = np.empty(L)
        while unfrozen.any():
            contrib = np.where(unfrozen[pair_flow], pair_w, 0.0)
            load_w = np.bincount(pair_link, weights=contrib, minlength=L)
            eligible = load_w > 0.0
            share.fill(np.inf)
            np.divide(remaining, load_w, out=share, where=eligible)
            m = share.min()
            if not np.isfinite(m):
                break  # leftover flows traverse no capacity-bearing link
            sel = (share[pair_link] == m) & unfrozen[pair_flow]
            rows = np.unique(pair_flow[sel])
            rate[rows] = m * w[rows]
            unfrozen[rows] = False
            newly = np.zeros(F, dtype=bool)
            newly[rows] = True
            upd = newly[pair_flow]
            dec = np.bincount(pair_link[upd], weights=rate[pair_flow[upd]],
                              minlength=L)
            remaining = np.maximum(remaining - dec, 0.0)

        return self._finish(rate, remaining, cap, touched, alive)

    def _fill_torch(self, w: np.ndarray, alive: np.ndarray, cap: np.ndarray,
                    device) -> Tuple[np.ndarray, np.ndarray]:
        """The filling loop through ``kernels/waterfill.py`` on ``device``:
        one copy of the weights and capacities in, one of the rates and
        remaining capacities out; the incidence by link and by flow is kept
        on each device until the pairs change."""
        import torch

        from repro_torch import resolve_device
        from repro_torch.kernels import waterfill

        dev = resolve_device(device)
        inc = self._by_link.get(dev)
        if inc is None:
            csr = (*waterfill.link_csr(self.pair_flow, self.pair_link, self.n_links),
                   *waterfill.flow_csr(self.pair_flow, self.pair_link, self.n_flows))
            inc = self._by_link[dev] = [torch.from_numpy(a).to(dev) for a in csr]
        F = self.n_flows
        wc = torch.from_numpy(np.concatenate([w, cap])).to(dev)
        rate, remaining, _ = waterfill.waterfill(*inc[:2], wc[:F], torch.from_numpy(alive).to(dev),
                                                 wc[F:], flow_csr=inc[2:])
        out = torch.cat([rate, remaining]).cpu().numpy()
        return out[:F], out[F:]

    def _finish(self, rate: np.ndarray, remaining: np.ndarray,
                cap: np.ndarray, touched: np.ndarray,
                alive: np.ndarray) -> FlowRates:
        # slowest-QP connection aggregation: bw = min_i r_i / (w_i / sum w)
        wq = np.maximum(self.weights, 1e-12)
        wsum = np.bincount(self.conn_idx, weights=wq, minlength=self.n_conns)
        wnorm = wq / np.maximum(wsum[self.conn_idx], 1e-300)
        ratio = np.where(wnorm > 1e-9, rate / np.maximum(wnorm, 1e-300), np.inf)
        eff = np.full(self.n_conns, np.inf)
        np.minimum.at(eff, self.conn_idx, ratio)
        conn = np.where(np.isfinite(eff), eff, 0.0)

        util = np.where(touched, cap - remaining, 0.0)
        return FlowRates(rate, conn, util, touched, alive)
