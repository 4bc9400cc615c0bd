"""Intersection (conflict) rules between directed edges — the paper's G_I.

Conflicts are *resource based*: a transfer on edge e occupies a set of
resources; two edges intersect iff they share a resource. Resources per duplex
model:

  FULL_DUPLEX (paper §2.6 example LP):
      ("send", i)  — one-port send:    i sends to at most one peer at a time
      ("recv", j)  — one-port receive: j receives from at most one peer
      physical links from ``topology.links(e)`` — the pair constraint
      O_ij + O_ji <= 1 comes from the shared cable resource; hierarchical NIC
      links make all of a node's sends AND receives conflict (=> C = B/2).

  HALF_DUPLEX:
      ("node", i), ("node", j) — a node engaged in any transfer is busy
      + physical links.

  ALL_PORT (TPU ICI):
      physical links only — a chip drives all its links simultaneously; each
      direction of each ICI link is a dedicated channel.

An *intersecting edge group* (paper Def. 8) is the set of edges sharing one
resource; the LP sums occupancies over each group, and schedulers/simulator
enforce at most one active edge per resource at any instant.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.routing import CompiledTopology
from repro_torch.core.topology import Edge, Topology

FULL_DUPLEX = "full_duplex"
HALF_DUPLEX = "half_duplex"
ALL_PORT = "all_port"

Resource = Tuple


@dataclasses.dataclass(frozen=True)
class ConflictModel:
    """Resource-based G_I over a topology.

    Resources have integer *capacities* (concurrent transfer slots): ports,
    NICs and plain cables serve one transfer at a time; router trunks carry
    floor(trunk_bw / nic_bw) concurrent transfers — the discrete counterpart
    of SimGrid's bandwidth sharing and of the LP's B_e/B_r weighting.
    """

    topo: Topology
    mode: str = FULL_DUPLEX

    def compiled(self) -> CompiledTopology:
        """The compiled routing/resource layer for this model, built once on
        first use (dense resource ids, per-edge id tuples and Hockney
        constants, next-hop routing — see ``repro.core.routing``)."""
        ct = self.__dict__.get("_compiled")
        if ct is None:
            ct = CompiledTopology(self)
            object.__setattr__(self, "_compiled", ct)
        return ct

    def __getstate__(self):
        """Pickle without the compiled layer; it rebuilds deterministically
        on first use after load (plan artifacts stay small)."""
        state = dict(self.__dict__)
        state.pop("_compiled", None)
        return state

    def resources(self, e: Edge,
                  links: Optional[Sequence[str]] = None) -> Tuple[Resource, ...]:
        """Resources occupied by a transfer on edge e. ``links`` overrides the
        topology's natural physical route (pinned routes on relabeled plans —
        see ``repro.core.symmetry``); port/node resources are unaffected."""
        i, j = e
        if links is None:
            links = self.topo.links(e)
        links = tuple(("link", l) for l in links)
        if self.mode == FULL_DUPLEX:
            return (("send", i), ("recv", j)) + links
        if self.mode == HALF_DUPLEX:
            return (("node", i), ("node", j)) + links
        if self.mode == ALL_PORT:
            return links
        raise ValueError(f"unknown mode {self.mode}")

    def capacity(self, r: Resource) -> int:
        if r[0] != "link":
            return 1
        name = r[1]
        tb = getattr(self.topo, "_trunk_bw", None)
        if tb and name in tb:
            nb = getattr(self.topo, "_nic_bw", None)
            return max(1, int(tb[name] / nb))
        return 1

    def conflict(self, e1: Edge, e2: Edge) -> bool:
        if e1 == e2:
            return True
        ct = self.compiled()
        return not ct.edge_unit_ids(e1).isdisjoint(ct.edge_unit_ids(e2))

    def compatible(self, edges: Sequence[Edge],
                   routes: Optional[Dict[Edge, Tuple]] = None) -> bool:
        """True iff all edges can be active simultaneously (a valid round).
        ``routes`` maps edges to pinned (links, latency, bandwidth) overrides
        (``Pipeline.routes``); overridden edges count their pinned links."""
        ct = self.compiled()
        caps = ct.caps
        count: Dict[int, int] = {}
        for e in edges:
            rt = routes.get(e) if routes else None
            if rt is None:
                rids = ct.edge_ids(e)
            else:
                rids = tuple(ct.intern(r)
                             for r in self.resources(e, links=rt[0]))
            for rid in rids:
                c = count.get(rid, 0) + 1
                if c > caps[rid]:
                    return False
                count[rid] = c
        return True

    def groups(self, edges: Iterable[Edge]) -> List[Tuple[Edge, ...]]:
        """Intersecting edge groups restricted to `edges` (cliques of G_I that
        generate all pairwise conflicts under the resource model)."""
        ct = self.compiled()
        by_res: Dict[Resource, List[Edge]] = {}
        for e in edges:
            for r in ct.resources(e):
                by_res.setdefault(r, []).append(e)
        out, seen = [], set()
        for r, es in sorted(by_res.items(), key=lambda kv: str(kv[0])):
            g = tuple(sorted(set(es)))
            if len(g) >= 2 and g not in seen:
                seen.add(g)
                out.append(g)
        return out

    def degree_bound(self, trees_edges: Sequence[Sequence[Edge]]) -> int:
        """d of Theorem 3 generalized: max over resources of the number of tree
        edges (with multiplicity across trees) using that resource. A schedule
        shorter than d rounds is impossible; coloring achieves exactly d for
        the bipartite one-port structure."""
        ct = self.compiled()
        caps = ct.caps
        count: Dict[int, int] = {}
        for te in trees_edges:
            for e in te:
                for rid in ct.edge_ids(e):
                    count[rid] = count.get(rid, 0) + 1
        if not count:
            return 0
        return max(-(-c // caps[rid]) for rid, c in count.items())
