"""C4P path probing and link-health monitoring (paper section 3.2).

"C4P first isolates and discards malfunctioning links between leaf and
spine switches, creating a healthy-link network. The C4P master performs
full-mesh path probing via randomly selected servers per leaf switch,
identifying and cataloging reliable paths."
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Set, Tuple

import numpy as np

from repro_torch.core.topology import ClosTopology, LinkId


@dataclass
class ProbeReport:
    healthy_paths: Set[Tuple[int, int, int]]     # (src_leaf, spine, dst_leaf)
    faulty_links: Set[LinkId]
    latencies_us: Dict[Tuple[int, int, int], float]


class PathProber:
    """Full-mesh leaf->spine->leaf probing. One representative endpoint per
    leaf; a path is healthy iff both constituent links are healthy."""

    def __init__(self, topo: ClosTopology, base_latency_us: float = 4.0,
                 seed: int = 0):
        self.topo = topo
        self.base_latency_us = base_latency_us
        self.rng = np.random.default_rng(seed)

    def probe(self) -> ProbeReport:
        topo = self.topo
        healthy: Set[Tuple[int, int, int]] = set()
        faulty: Set[LinkId] = set()
        lat: Dict[Tuple[int, int, int], float] = {}
        for src_leaf in range(topo.n_leaves):
            for dst_leaf in range(topo.n_leaves):
                if src_leaf == dst_leaf:
                    continue
                for spine in range(topo.n_spines):
                    up, down = ("ls", src_leaf, spine), ("sl", spine, dst_leaf)
                    if topo.healthy(up) and topo.healthy(down):
                        healthy.add((src_leaf, spine, dst_leaf))
                        lat[(src_leaf, spine, dst_leaf)] = float(
                            self.base_latency_us * (1 + 0.05 * self.rng.random()))
                    else:
                        for l in (up, down):
                            if not topo.healthy(l):
                                faulty.add(l)
        return ProbeReport(healthy, faulty, lat)


class LinkHealthMonitor:
    """Continuously folds probe results / transport errors into a blacklist,
    'allowing it to identify and exclude faulty links from being considered
    in future path allocations'.

    Two blacklist populations with different lifecycles:

      * **probe-derived** — replaced wholesale by every probe sweep, so a
        link is marked *down* when a probe finds it faulty and marked *up*
        again as soon as a later sweep sees it healthy (the paper's
        continuous full-mesh probing re-admits repaired links);
      * **transport-error-derived** — reported by the CCL / C4D verdicts
        and *sticky*: a link that corrupted live traffic stays cataloged
        until operators repair it out of band, even if probes pass.

    ``blacklist`` is the union the allocator and load balancer consult.

    ``usable_spines`` is memoized per (src_leaf, dst_leaf) and invalidated
    by version counters (blacklist edits here, fail/restore on the topology)
    — the allocator calls it once per connection port, which at 1024-GPU
    scale is tens of thousands of calls against a rarely-changing set."""

    def __init__(self, topo: ClosTopology):
        self.topo = topo
        self._probe_down: Set[LinkId] = set()
        self._error_down: Set[LinkId] = set()
        self._version = 0
        self._spine_cache: Dict[Tuple[int, int], Tuple[Tuple[int, int], List[int]]] = {}

    @property
    def blacklist(self) -> Set[LinkId]:
        """Every link currently excluded from path allocation."""
        return self._probe_down | self._error_down

    def update_from_probe(self, report: ProbeReport) -> None:
        """Fold one probe sweep in: mark-down newly faulty links AND
        mark-up links the sweep proved healthy again."""
        new = set(report.faulty_links)
        if new != self._probe_down:
            self._probe_down = new
            self._version += 1

    def report_transport_error(self, link: LinkId) -> None:
        if link not in self._error_down:
            self._error_down.add(link)
            self._version += 1

    def usable_spines(self, src_leaf: int, dst_leaf: int) -> List[int]:
        ver = (self._version, self.topo._health_version)
        hit = self._spine_cache.get((src_leaf, dst_leaf))
        if hit is not None and hit[0] == ver:
            return hit[1]
        out = []
        probe_down, error_down = self._probe_down, self._error_down
        for s in range(self.topo.n_spines):
            up, down = ("ls", src_leaf, s), ("sl", s, dst_leaf)
            if up in probe_down or up in error_down:
                continue
            if down in probe_down or down in error_down:
                continue
            if not (self.topo.healthy(up) and self.topo.healthy(down)):
                continue
            out.append(s)
        self._spine_cache[(src_leaf, dst_leaf)] = (ver, out)
        return out
