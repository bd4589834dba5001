"""Simulated production cluster: nodes, backup pool, steering service.

Paper section 3.1: "we've allocated 64 backup GPUs across 8 servers for
every 1024 GPUs on 128 servers, ensuring identical communication and
performance for parallel training on any 128 servers from this 136-server
pool."  The steering service executes the isolate -> swap -> restart loop
that the C4D master requests.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

HEALTHY = "healthy"
ISOLATED = "isolated"
ACTIVE = "active"
BACKUP = "backup"


@dataclass
class Node:
    node_id: int
    gpus: int = 8
    role: str = BACKUP            # active | backup
    state: str = HEALTHY          # healthy | isolated
    fault_count: int = 0


@dataclass
class SwapEvent:
    t: float
    out_node: int
    in_node: int
    reason: str


class SimCluster:
    """A pool of nodes with the paper's 128-active + 8-backup ratio."""

    def __init__(self, n_active: int = 128, n_backup: int = 8, gpus_per_node: int = 8):
        self.nodes: Dict[int, Node] = {}
        for i in range(n_active + n_backup):
            role = ACTIVE if i < n_active else BACKUP
            self.nodes[i] = Node(i, gpus_per_node, role=role)
        self.history: List[SwapEvent] = []

    @property
    def active_nodes(self) -> List[int]:
        return [n.node_id for n in self.nodes.values()
                if n.role == ACTIVE and n.state == HEALTHY]

    @property
    def backup_pool(self) -> List[int]:
        return [n.node_id for n in self.nodes.values()
                if n.role == BACKUP and n.state == HEALTHY]

    def isolate_and_replace(self, node_id: int, t: float = 0.0,
                            reason: str = "") -> Optional[int]:
        """Isolate a faulty node; promote a backup. Returns the replacement
        node id (None if the pool is exhausted — job must shrink or wait)."""
        node = self.nodes[node_id]
        node.state = ISOLATED
        node.fault_count += 1
        pool = self.backup_pool
        if not pool:
            return None
        repl = pool[0]
        self.nodes[repl].role = ACTIVE
        node.role = BACKUP  # goes back to the pool once repaired
        self.history.append(SwapEvent(t, node_id, repl, reason))
        return repl

    def repair(self, node_id: int) -> None:
        self.nodes[node_id].state = HEALTHY


@dataclass
class SteeringCosts:
    """Orchestration latencies (seconds)."""
    isolate_s: float = 60.0
    schedule_backup_s: float = 120.0
    restart_job_s: float = 180.0


class SteeringService:
    """Executes C4D master actions against the cluster, accounting time."""

    def __init__(self, cluster: SimCluster, costs: SteeringCosts = SteeringCosts()):
        self.cluster = cluster
        self.costs = costs

    def execute(self, node_id: int, t: float, reason: str = "") -> (Optional[int], float):
        repl = self.cluster.isolate_and_replace(node_id, t, reason)
        dt = self.costs.isolate_s + self.costs.schedule_backup_s
        return repl, dt

    def restart_cost_s(self) -> float:
        return self.costs.restart_job_s
