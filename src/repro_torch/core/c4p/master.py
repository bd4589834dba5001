"""C4P master: the system-wide (multi-job, multi-tenant) control plane.

"The C4P master acts as a control center for multiple jobs or tenants ...
C4P's CCL can request path allocations for communicating workers ... C4P's
master allocates communication paths."  Deployment-wise it is global (one
per cluster) in contrast to the per-job C4D master.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.c4p.loadbalance import DynamicLoadBalancer, LBConfig
from repro_torch.core.c4p.pathalloc import ConnRequest, PathAllocator
from repro_torch.core.c4p.probing import LinkHealthMonitor, PathProber
from repro_torch.core.flowset import FlowSet
from repro_torch.core.netsim import (Flow, RateResult, flowset_rate_result,
                               ring_allreduce_busbw)
from repro_torch.core.topology import ClosTopology


def job_ring_requests(job_id: int, hosts: Sequence[int], nics: int) -> List[ConnRequest]:
    """Connection set of a rail-parallel ring allreduce over ``hosts``."""
    reqs = []
    n = len(hosts)
    for i in range(n):
        src, dst = hosts[i], hosts[(i + 1) % n]
        if src == dst:
            continue
        for nic in range(nics):
            reqs.append(ConnRequest(job_id, src, dst, nic, (src, dst)))
    return reqs


@dataclass
class JobState:
    job_id: int
    hosts: List[int]
    flows: List[Flow] = field(default_factory=list)


class C4PMaster:
    """Global traffic-engineering master (paper §3.2).

    Lifecycle per the paper: probe -> blacklist faulty links -> serve path
    requests at connection setup (static TE, Fig. 8/9) -> continuously
    re-balance QP weights from observed completion times (dynamic LB,
    Fig. 11b/12b).  Composition layers (the scenario campaign engine and
    the fig9/fig11/fig13 benchmarks) drive it through
    ``repro_torch.scenarios.fabric.FabricState`` rather than directly, so ECMP/C4P
    A/B arms always see identical topology and job mixes."""

    def __init__(self, topo: ClosTopology, qps_per_port: int = 2,
                 lb_cfg: LBConfig = LBConfig()):
        self.topo = topo
        self.health = LinkHealthMonitor(topo)
        self.prober = PathProber(topo)
        self.allocator = PathAllocator(topo, self.health)
        self.balancer = DynamicLoadBalancer(topo, self.health, lb_cfg)
        self.qps_per_port = qps_per_port
        self.jobs: Dict[int, JobState] = {}
        self._flowset: Optional[FlowSet] = None  # factored incidence cache

    # ---- control plane -----------------------------------------------------
    def startup_probe(self) -> None:
        self.health.update_from_probe(self.prober.probe())

    def register_job(self, job_id: int, hosts: Sequence[int]) -> JobState:
        reqs = job_ring_requests(job_id, hosts, self.topo.nics_per_host)
        flows: List[Flow] = []
        for r in reqs:
            flows.extend(self.allocator.allocate(r, qps_per_port=self.qps_per_port))
        st = JobState(job_id, list(hosts), flows)
        self.jobs[job_id] = st
        self._flowset = None
        return st

    def deregister_job(self, job_id: int) -> None:
        st = self.jobs.pop(job_id, None)
        if st:
            self.allocator.release_job(job_id, st.flows)
            self._flowset = None

    # ---- data plane evaluation ----------------------------------------------
    def all_flows(self) -> List[Flow]:
        out: List[Flow] = []
        for st in self.jobs.values():
            out.extend(st.flows)
        return out

    def flow_set(self) -> FlowSet:
        """Factored FlowSet over all registered flows, kept across evaluate
        calls (rebuilt when the job set changes; weights/paths are refreshed
        from the Flow objects before each use)."""
        if self._flowset is None:
            self._flowset = FlowSet(self.topo, self.all_flows())
        return self._flowset

    def evaluate(self, dynamic_lb: bool = True, cnp_jitter: float = 0.0,
                 seed: int = 0, static_failover: bool = True) -> RateResult:
        flows = self.all_flows()
        if dynamic_lb:
            return self.balancer.balance(flows, seed=seed, cnp_jitter=cnp_jitter,
                                         flow_set=self.flow_set())
        if static_failover:
            # without dynamic LB, dead paths are ECMP re-hashed (Fig. 11a)
            from repro_torch.core.c4p.pathalloc import ecmp_failover
            ecmp_failover(self.topo, flows, seed=seed)
        fs = self.flow_set()
        fs.refresh(flows)
        return flowset_rate_result(fs, fs.max_min(cnp_jitter=cnp_jitter, seed=seed))

    def job_busbw(self, res: RateResult, job_id: int) -> float:
        st = self.jobs[job_id]
        return ring_allreduce_busbw(self.topo, res.conn_rate, job_id, len(st.hosts))
