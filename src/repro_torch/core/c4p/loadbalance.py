"""C4P dynamic load balancing (paper section 3.2, Figs. 11/12).

"The CCL constantly evaluates message completion times on various paths and
prioritizes the fastest for data transfer. If the optimal QP's queue is
full, the next best is chosen."

Fluid-model equivalent: each logical connection owns K QPs (distinct spine
paths).  Every round the balancer observes per-QP throughput and shifts
connection weight toward faster paths (multiplicative weights with a floor),
re-routing QPs whose path died onto the healthiest remaining spine.
Convergence: weights ~ path rates => per-QP completion times equalise, which
is the max-min optimum for the connection.

The balancer runs on the vectorized ``FlowSet`` engine and factors the
flow->link structure ONCE per ``balance`` call: across the 12 re-weighting
rounds only the weight vector changes (paths change only on re-route, which
marks the incidence arrays dirty), so each round costs a few bincounts
instead of a full dict rebuild.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.c4p.probing import LinkHealthMonitor
from repro_torch.core.flowset import FlowSet
from repro_torch.core.netsim import Flow, RateResult, flowset_rate_result
from repro_torch.core.topology import ClosTopology


@dataclass
class LBConfig:
    rounds: int = 12
    step: float = 0.6            # weight shift aggressiveness
    min_weight: float = 0.02
    reroute_dead: bool = True


class DynamicLoadBalancer:
    """Completion-time-driven QP re-weighting (paper §3.2, Fig. 11b/12b).

    Multiplicative-weights update toward observed per-path rates; dead QPs
    re-route to the healthiest usable spine (blacklist- and health-aware).
    Converges to the per-connection max-min optimum — the near-7/8-ideal
    recovery after a leaf-spine failure in Fig. 11b.  ``device`` is where
    the torch backend's water-filling runs (``None``: the card)."""

    def __init__(self, topo: ClosTopology, health: Optional[LinkHealthMonitor] = None,
                 cfg: LBConfig = LBConfig(), device=None):
        self.topo = topo
        self.health = health or LinkHealthMonitor(topo)
        self.cfg = cfg
        self.device = device

    def _reroute(self, flow: Flow) -> bool:
        """Move a dead-path QP onto the least-loaded healthy spine of the
        same (port-affine) leaf pair.  Leaf-local flows (no spine tier on
        the path) have nowhere to re-route and are left untouched."""
        up = next((l for l in flow.links if l[0] == "up"), None)
        down = next((l for l in flow.links if l[0] == "down"), None)
        if up is None or down is None:
            return False
        _, src_host, nic, src_port = up
        _, dst_host, _, dst_port = down
        src_leaf = self.topo.leaf_of(src_host, nic, src_port)
        dst_leaf = self.topo.leaf_of(dst_host, nic, dst_port)
        if src_leaf == dst_leaf:
            return False
        spines = self.health.usable_spines(src_leaf, dst_leaf)
        if not spines:
            return False
        spine = spines[0]
        flow.links = self.topo.path_links(src_host, dst_host, nic,
                                          src_port, dst_port, spine)
        return True

    def balance(self, flows: Sequence[Flow], seed: int = 0,
                cnp_jitter: float = 0.0,
                trace: Optional[List[RateResult]] = None,
                flow_set: Optional[FlowSet] = None) -> RateResult:
        """Iteratively re-weight QPs until completion times equalise.

        ``flow_set`` lets a caller (the C4P master) pass a pre-factored
        ``FlowSet`` for these exact flows (same order); it is refreshed from
        the Flow objects, so stale weights/paths are picked up."""
        flows = list(flows)
        cfg = self.cfg
        if flow_set is not None and flow_set.n_flows == len(flows):
            fs = flow_set
            fs.refresh(flows)
        else:
            fs = FlowSet(self.topo, flows)

        cidx, C = fs.conn_idx, fs.n_conns
        conn_size = np.bincount(cidx, minlength=C)
        multi_conn = conn_size >= 2

        fr = fs.max_min(cnp_jitter=cnp_jitter, seed=seed, device=self.device)
        for rnd in range(cfg.rounds):
            rates = fr.flow_rate
            changed = False
            if cfg.reroute_dead:
                for i in np.nonzero(rates <= 1e-9)[0]:
                    f = flows[i]
                    if not all(self.topo.healthy(l) for l in f.links):
                        # a dead path always counts as "changed", even if no
                        # healthy spine exists yet — it may next round
                        changed = True
                        if self._reroute(f):
                            fs.set_links(int(i), f.links)

            w = fs.weights
            total = np.bincount(cidx, weights=rates, minlength=C)
            wsum = np.bincount(cidx, weights=w, minlength=C)
            upd = (multi_conn & (total > 1e-9))[cidx]
            w_norm = w / np.maximum(wsum[cidx], 1e-300)
            # target weights proportional to observed per-path rate
            target = rates / np.maximum(total[cidx], 1e-300)
            new_w = (1 - cfg.step) * w_norm + cfg.step * target
            new_w = np.maximum(new_w, cfg.min_weight)
            nsum = np.bincount(cidx, weights=np.where(upd, new_w, 0.0),
                               minlength=C)
            new_w = new_w / np.maximum(nsum[cidx], 1e-300)
            if np.any(upd & (np.abs(new_w - w_norm) > 1e-3)):
                changed = True
            new_w = np.where(upd, new_w, w)
            fs.set_weights(new_w)
            for i, f in enumerate(flows):
                f.weight = float(new_w[i])

            fr = fs.max_min(cnp_jitter=cnp_jitter, seed=seed + rnd + 1, device=self.device)
            if trace is not None:
                trace.append(flowset_rate_result(fs, fr))
            if not changed:
                break
        return flowset_rate_result(fs, fr)
