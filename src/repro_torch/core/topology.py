"""Clos / fat-tree fabric model with dual-port NICs (paper section 4.1).

Mirrors the paper's testbed by default: 16 hosts x 8 NICs, each NIC two
200 Gbps ports bonded, ports of one NIC landing on two *distinct* leaf
switches (a left/right leaf pair), leaves fully meshed to spines at a
configurable oversubscription rate.  NVLink is the tier-0 fabric inside a
host (``nvlink_busbw_gbps`` caps achievable allreduce busbw, matching the
362 Gbps ceiling the paper reports).

Link identifiers are hashable tuples:
  ("up",   host, nic, port)            host/NIC port -> leaf   (200 Gbps)
  ("down", host, nic, port)            leaf -> host/NIC port   (200 Gbps)
  ("ls",   leaf, spine)                leaf -> spine uplink
  ("sl",   spine, leaf)                spine -> leaf downlink
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

LinkId = Tuple
PathId = Tuple  # (src_port_side, spine or None, dst_port_side)

LEFT, RIGHT = 0, 1


@dataclass
class ClosTopology:
    n_hosts: int = 16
    nics_per_host: int = 8
    n_leaf_pairs: int = 4              # 8 leaves; NIC i maps to pair i % n_leaf_pairs
    n_spines: int = 8
    port_gbps: float = 200.0
    oversubscription: float = 1.0      # 1.0 = 1:1, 2.0 = 2:1
    nvlink_busbw_gbps: float = 362.0
    down_links: set = field(default_factory=set)  # failed LinkIds

    n_host_groups: int = 2             # hosts are split into leaf-pair groups

    # memoized path table (paths don't depend on health) + a health version
    # counter so health-derived caches (e.g. usable-spine sets) can
    # invalidate cheaply without hashing the whole down_links set
    _path_cache: dict = field(default_factory=dict, repr=False, compare=False)
    _health_version: int = field(default=0, repr=False, compare=False)

    # ---- static structure -------------------------------------------------
    @property
    def n_leaves(self) -> int:
        return 2 * self.n_leaf_pairs

    @property
    def hosts_per_group(self) -> int:
        return max(1, self.n_hosts // self.n_host_groups)

    @property
    def pairs_per_group(self) -> int:
        return max(1, self.n_leaf_pairs // self.n_host_groups)

    def leaf_of(self, host: int, nic: int, port: int) -> int:
        """Leaf switch of a (host, NIC, port) uplink.

        Hosts are split into groups; within a group the NICs stripe over the
        group's leaf pairs (rail-style), and the two bonded ports of a NIC
        land on the two distinct leaves of a pair (paper: 'each port
        connecting to a distinct leaf switch').  A single leaf therefore
        serves one NIC-rail of *every* host in its group — which is why one
        leaf-spine link failure degrades every concurrent job (Fig. 11)."""
        group = (host // self.hosts_per_group) % self.n_host_groups
        pair = group * self.pairs_per_group + (nic % self.pairs_per_group)
        return 2 * pair + port

    def leaf_spine_capacity(self) -> float:
        """Per (leaf,spine) link capacity under the oversubscription rate."""
        nics_per_leaf = self.nics_per_host / self.pairs_per_group
        down = self.hosts_per_group * nics_per_leaf * self.port_gbps  # per leaf
        return down / (self.n_spines * self.oversubscription)

    def link_capacity(self, link: LinkId) -> float:
        if link[0] in ("up", "down"):
            return self.port_gbps
        return self.leaf_spine_capacity()

    # ---- health -----------------------------------------------------------
    def fail_link(self, link: LinkId) -> None:
        self.down_links.add(link)
        self._health_version += 1

    def restore_link(self, link: LinkId) -> None:
        self.down_links.discard(link)
        self._health_version += 1

    def healthy(self, link: LinkId) -> bool:
        return link not in self.down_links

    # ---- path construction -------------------------------------------------
    def path_links(self, src_host: int, dst_host: int, nic: int,
                   src_port: int, dst_port: int, spine: Optional[int]) -> List[LinkId]:
        """Ordered links for one flow. Same-leaf flows skip the spine tier.

        Results are memoized (paths are pure topology, independent of link
        health); callers must treat the returned list as immutable — swap
        ``flow.links`` wholesale instead of mutating in place."""
        key = (src_host, dst_host, nic, src_port, dst_port, spine)
        hit = self._path_cache.get(key)
        if hit is None:
            hit = self._path_cache[key] = self._build_path(*key)
        return hit

    def _build_path(self, src_host: int, dst_host: int, nic: int,
                    src_port: int, dst_port: int, spine: Optional[int]) -> List[LinkId]:
        src_leaf = self.leaf_of(src_host, nic, src_port)
        dst_leaf = self.leaf_of(dst_host, nic, dst_port)
        links: List[LinkId] = [("up", src_host, nic, src_port)]
        if src_leaf != dst_leaf:
            assert spine is not None, "cross-leaf flow needs a spine"
            links += [("ls", src_leaf, spine), ("sl", spine, dst_leaf)]
        elif spine is not None:
            # hair-pin through a spine even on same leaf (ECMP may do this);
            # modelled as leaf->spine->leaf
            links += [("ls", src_leaf, spine), ("sl", spine, dst_leaf)]
        links.append(("down", dst_host, nic, dst_port))
        return links

    def spine_paths(self, src_leaf: int, dst_leaf: int) -> List[Tuple[LinkId, LinkId]]:
        return [(("ls", src_leaf, s), ("sl", s, dst_leaf)) for s in range(self.n_spines)]

    def all_leaf_spine_links(self) -> List[LinkId]:
        out = []
        for l in range(self.n_leaves):
            for s in range(self.n_spines):
                out += [("ls", l, s), ("sl", s, l)]
        return out


def paper_testbed(oversubscription: float = 1.0) -> ClosTopology:
    """The 16-node / 128-GPU / 8-leaf testbed from the paper's section 4.1."""
    return ClosTopology(oversubscription=oversubscription)
