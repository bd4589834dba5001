"""Live fabric state for scenario drills: one topology, many jobs, two modes.

``FabricState`` wraps a ``ClosTopology`` plus either the full C4P control
plane (probing -> blacklist -> path allocation -> dynamic LB; paper §3.2)
or the ECMP baseline (random spine/port hashing).  It is the single place
the campaign engine — and, as thin consumers, the fig9/fig11/fig13
benchmarks — touch the flow simulator, so A/B comparisons are guaranteed to
exercise identical topology, job mix, and seeds.

ECMP mode reproduces the historical benchmark behaviour exactly: per-job
allocation seeds are ``seed + job_id`` and flow ids are renumbered globally
in insertion order (the fig9 regression pins this).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.c4p.master import C4PMaster, job_ring_requests
from repro_torch.core.c4p.pathalloc import ecmp_allocate
from repro_torch.core.netsim import (Flow, RateResult, max_min_rates,
                               ring_allreduce_busbw)
from repro_torch.core.topology import ClosTopology, LinkId, paper_testbed

ECMP = "ecmp"
C4P = "c4p"


class FabricState:
    """A live Clos fabric carrying the scenario's job mix.  ``device`` is
    where the torch backend's water-filling runs (``None``: the card)."""

    def __init__(self, topo: Optional[ClosTopology] = None, mode: str = C4P,
                 qps_per_port: int = 1, seed: int = 0,
                 oversubscription: float = 1.0, device=None):
        if mode not in (ECMP, C4P):
            raise ValueError(f"unknown fabric mode {mode!r}")
        self.topo = topo or paper_testbed(oversubscription)
        self.mode = mode
        self.seed = seed
        self.qps_per_port = qps_per_port
        self.device = device
        self.job_hosts: Dict[int, List[int]] = {}
        # hosts the streaming detector marked *suspect* (graceful
        # degradation, docs/runtime.md): kept in the job mix but flagged
        # for planning; populated/cleared by FabricService
        self.suspect_hosts: set = set()
        if mode == C4P:
            self.master = C4PMaster(self.topo, qps_per_port=qps_per_port,
                                    device=device)
            self.master.startup_probe()
            self._ecmp_flows: Dict[int, List[Flow]] = {}
        else:
            self.master = None
            self._ecmp_flows = {}

    # ---- job mix -----------------------------------------------------------
    def add_job(self, job_id: int, hosts: Sequence[int]) -> None:
        self.job_hosts[job_id] = list(hosts)
        if self.master is not None:
            self.master.register_job(job_id, hosts)
            return
        reqs = job_ring_requests(job_id, list(hosts), self.topo.nics_per_host)
        self._ecmp_flows[job_id] = ecmp_allocate(
            self.topo, reqs, seed=self.seed + job_id,
            qps_per_port=self.qps_per_port)
        self._renumber()

    def remove_job(self, job_id: int) -> None:
        self.job_hosts.pop(job_id, None)
        if self.master is not None:
            self.master.deregister_job(job_id)
        else:
            self._ecmp_flows.pop(job_id, None)
            self._renumber()

    def _renumber(self) -> None:
        for i, f in enumerate(self.all_flows()):
            f.flow_id = i

    def all_flows(self) -> List[Flow]:
        if self.master is not None:
            return self.master.all_flows()
        out: List[Flow] = []
        for j in self._ecmp_flows:
            out.extend(self._ecmp_flows[j])
        return out

    # ---- health ------------------------------------------------------------
    def fail_link(self, link: LinkId) -> None:
        self.topo.fail_link(tuple(link))

    def restore_link(self, link: LinkId) -> None:
        self.topo.restore_link(tuple(link))

    def probe_refresh(self) -> Optional["object"]:
        """Run a full-mesh probe sweep and fold it into the health monitor
        (paper §3.2: re-planning is driven by ``PathProber`` reports, not by
        out-of-band knowledge of the topology).  Faulty links are marked
        down for allocation; links a sweep proves healthy again are marked
        back up.  Returns the ``ProbeReport`` (None under ECMP, which has no
        control plane to inform)."""
        if self.master is None:
            return None
        report = self.master.prober.probe()
        self.master.health.update_from_probe(report)
        return report

    def deprioritize_host(self, host: int) -> bool:
        """Mark a host suspect for traffic planning (C4D precision state
        machine).  The host stays in the job mix — this is the graceful
        stage before isolation: the caller follows up with a probe sweep
        and re-plan so a genuinely degrading NIC is steered around, while
        a false positive costs nothing but the re-plan.  Returns True when
        the host is newly suspect (i.e. a re-plan is warranted)."""
        if host in self.suspect_hosts:
            return False
        self.suspect_hosts.add(host)
        return True

    def reprioritize_host(self, host: int) -> bool:
        """A suspect host recovered; restore it for planning."""
        if host not in self.suspect_hosts:
            return False
        self.suspect_hosts.discard(host)
        return True

    def blacklist_link(self, link: LinkId) -> None:
        """C4D verdict -> C4P link blacklist (the detect->avoid composition);
        a no-op under ECMP, which has no control plane to inform."""
        if self.master is not None:
            self.master.health.report_transport_error(tuple(link))

    # ---- evaluation --------------------------------------------------------
    def evaluate(self, dynamic_lb: Optional[bool] = None,
                 cnp_jitter: float = 0.0, seed: Optional[int] = None,
                 static_failover: bool = True) -> RateResult:
        """Max-min rates over the current flows.

        C4P: delegates to the master (dynamic LB re-weights QPs unless
        disabled).  ECMP: plain water-filling; with ``static_failover`` the
        NIC/fabric re-hashes dead-path QPs onto surviving spines (Fig. 11a
        behaviour), with no load awareness.  The re-hash is sticky — RoCE
        QPs are long-lived, so a flow stays on its new spine even after the
        failed link is restored (only newly allocated jobs benefit); this
        is the behaviour C4P's restore-aware re-planning is compared
        against."""
        seed = self.seed if seed is None else seed
        if self.master is not None:
            dyn = True if dynamic_lb is None else dynamic_lb
            return self.master.evaluate(dynamic_lb=dyn, cnp_jitter=cnp_jitter,
                                        seed=seed, static_failover=static_failover)
        flows = self.all_flows()
        if static_failover and self.topo.down_links:
            from repro_torch.core.c4p.pathalloc import ecmp_failover
            ecmp_failover(self.topo, flows, seed=seed)
        return max_min_rates(self.topo, flows, cnp_jitter=cnp_jitter, seed=seed,
                             device=self.device)

    def job_busbw(self, res: RateResult, job_id: int) -> float:
        hosts = self.job_hosts[job_id]
        return ring_allreduce_busbw(self.topo, res.conn_rate, job_id, len(hosts))

    def all_busbw(self, res: RateResult) -> Dict[int, float]:
        return {j: self.job_busbw(res, j) for j in self.job_hosts}

    def leaf_uplink_utilisation(self, res: RateResult,
                                leaf: int) -> Dict[LinkId, float]:
        """Fig. 12: EFFECTIVE per-port uplink utilisation at one leaf.  A
        connection is gated by its slowest QP, which throttles its
        healthy-port flows too, so each flow contributes
        ``weight_share * conn_effective_rate``."""
        flows = self.all_flows()
        conn_wsum: Dict[Tuple, float] = {}
        for f in flows:
            conn_wsum[f.conn_id] = conn_wsum.get(f.conn_id, 0.0) + f.weight
        util: Dict[LinkId, float] = {}
        for f in flows:
            eff = (f.weight / conn_wsum[f.conn_id]) * res.conn_rate.get(f.conn_id, 0.0)
            for l in f.links:
                if l[0] == "ls" and l[1] == leaf:
                    util[l] = util.get(l, 0.0) + eff
        return util
