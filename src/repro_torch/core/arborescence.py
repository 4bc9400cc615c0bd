"""Arborescence (spanning-tree) packing guided by the saturation LP (§2.5).

Given LP edge rates R_e, we extract K spanning arborescences T_1..T_K rooted at
the broadcast root with weights lambda_k (relative packet sizes), such that the
per-edge load sum_{k: e in T_k} lambda_k stays within the LP occupancy budget.
Greedy residual packing: repeatedly grow a spanning arborescence inside the
support of the residual rates, preferring high-residual shallow edges, then
charge the tree by the bottleneck residual (Plotkin-Shmoys-Tardos flavor of
fractional packing; exact optimality is NP-hard per §2.5, the LP value is the
upper bound we report against).

Special-case constructors (used by BBS when assumptions permit, §2.6):
  * chain/boustrophedon Hamiltonian arborescence — optimal for one-port
    full-duplex flat topologies (achieves C = B);
  * binomial arborescence — the shallow single tree for the small-message
    regime (depth ceil(log2 n));
  * complementary double chain — the K=2 pair the paper highlights for
    Dragonfly/Fat-tree (each node alternates receive/forward so every NIC is
    saturated; asymptotically C = B/2).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.lp import SaturationSolution
from repro_torch.core.topology import Edge, Topology


@dataclasses.dataclass
class Arborescence:
    root: int
    parent: Dict[int, int]                      # node -> parent (root absent)
    weight: float = 1.0                         # lambda_k (relative packet size)

    @property
    def edges(self) -> List[Edge]:
        return [(p, v) for v, p in sorted(self.parent.items())]

    def depth(self) -> int:
        d = {self.root: 0}

        def rec(v: int) -> int:
            if v in d:
                return d[v]
            d[v] = rec(self.parent[v]) + 1
            return d[v]

        return max((rec(v) for v in self.parent), default=0)

    def depths(self) -> Dict[int, int]:
        d = {self.root: 0}
        for v in self.parent:
            chain = []
            while v not in d:
                chain.append(v)
                v = self.parent[v]
            base = d[v]
            for w in reversed(chain):
                base += 1
                d[w] = base
        return d

    def out_degree(self) -> Dict[int, int]:
        deg: Dict[int, int] = {}
        for v, p in self.parent.items():
            deg[p] = deg.get(p, 0) + 1
        return deg

    def validate(self, topo: Topology) -> None:
        assert set(self.parent) == set(topo.compute_nodes) - {self.root}, \
            "arborescence must span all non-root nodes"
        for v, p in self.parent.items():
            assert topo.connected((p, v)), f"edge {(p, v)} not connectable"
        # acyclicity is implied by every node reaching the root
        for v in self.parent:
            seen = set()
            while v != self.root:
                assert v not in seen, "cycle detected"
                seen.add(v)
                v = self.parent[v]


# ---------------------------------------------------------------------------
# Special-case constructors
# ---------------------------------------------------------------------------

def chain_arborescence(topo: Topology, root: int,
                       order: Optional[Sequence[int]] = None) -> Arborescence:
    """Hamiltonian-ish chain through all nodes. If `order` is not given, a
    greedy nearest-neighbor walk over candidate edges is used, falling back to
    routed hops where the walk gets stuck (flat fabrics route multi-hop)."""
    if order is None:
        order = _greedy_hamiltonian(topo, root)
    parent = {}
    for a, b in zip(order, order[1:]):
        parent[b] = a
    return Arborescence(root=root, parent=parent)


def _greedy_hamiltonian(topo: Topology, root: int) -> List[int]:
    if topo.hierarchical:
        return _hierarchical_chain_order(topo, root)
    n = topo.num_nodes
    adj: Dict[int, List[int]] = {i: [] for i in range(n)}
    for (a, b) in topo.candidate_edges:
        adj[a].append(b)
    for i in adj:
        adj[i].sort()
    visited = {root}
    order = [root]
    cur = root
    while len(order) < n:
        # prefer unvisited neighbor with fewest unvisited neighbors (Warnsdorff)
        cands = [w for w in adj[cur] if w not in visited]
        if cands:
            nxt = min(cands, key=lambda w: (sum(1 for x in adj[w]
                                                if x not in visited), w))
        else:
            # stuck: jump to the nearest unvisited node (routed edge)
            rest = [w for w in range(n) if w not in visited]
            nxt = min(rest, key=lambda w: (topo.latency((cur, w)), w))
        visited.add(nxt)
        order.append(nxt)
        cur = nxt
    return order


def _hierarchical_chain_order(topo: Topology, root: int) -> List[int]:
    """Locality-first chain order for NIC+trunk fabrics: exhaust the root's
    router, then sibling routers in its group, then group by group — each
    trunk is crossed once, so the chain's steady state is NIC-bound (B/2),
    never trunk-bound."""
    node_router = topo.node_router  # type: ignore[attr-defined]
    routers: Dict[str, List[int]] = {}
    for v in topo.compute_nodes:
        routers.setdefault(node_router[v], []).append(v)

    def group_of(r: str) -> str:
        return r.split("r")[0] if r.startswith("g") and "r" in r else "all"

    groups: Dict[str, List[str]] = {}
    for r in sorted(routers):
        groups.setdefault(group_of(r), []).append(r)
    my_r = node_router[root]
    my_g = group_of(my_r)
    order = [root]
    glist = [my_g] + [g for g in sorted(groups) if g != my_g]
    for g in glist:
        rlist = groups[g]
        if g == my_g:
            rlist = [my_r] + [r for r in rlist if r != my_r]
        for r in rlist:
            order.extend(v for v in sorted(routers[r]) if v != root)
    return order


def boustrophedon_order(rows: int, cols: int, root: int = 0) -> List[int]:
    """Snake order over a rows x cols grid starting at the root's position."""
    snake = []
    for r in range(rows):
        cs = range(cols) if r % 2 == 0 else range(cols - 1, -1, -1)
        snake.extend(r * cols + c for c in cs)
    if root in snake and snake[0] != root:
        i = snake.index(root)
        # rotate-ish: walk from root to the nearer end, then snake the rest
        snake = snake[i:] + snake[:i][::-1]
    return snake


def binomial_arborescence(topo: Topology, root: int) -> Arborescence:
    """Binomial tree over node ids (virtual ranks relative to root)."""
    n = topo.num_nodes
    parent = {}
    for v in range(1, n):
        # clearing the highest set bit of the virtual rank gives the parent
        parent_rank = v - (1 << (v.bit_length() - 1))
        parent[(root + v) % n] = (root + parent_rank) % n
    return Arborescence(root=root, parent=parent)


def two_tree(topo: Topology, root: int) -> List[Arborescence]:
    """Sanders-Speck-Träff two-tree broadcast trees (Parallel Computing 2009).

    Two mirrored balanced binary trees over virtual ranks 1..n-1: T2's labels
    are T1's shifted by one (cyclically), so T1's leaves are T2's interior
    nodes and vice versa. Every node has total out-degree <= 2 across both
    trees and the root sends one packet per tree per cycle => steady-state
    rate B (one-port) with only O(log n) fill depth — the "highly
    complementary spanning tree pair" the paper observes BBS finds on
    Dragonfly/Fat-tree (where NIC sharing caps the rate at B/2)."""
    n = topo.num_nodes
    if n == 1:
        return []
    if n == 2:
        t = Arborescence(root=root, parent={(root + 1) % n: root}, weight=1.0)
        return [t]

    # balanced BST over labels 1..n-1; in-order position == label
    edges1: List[Tuple[int, int]] = []   # (parent_label, child_label)

    def build(lo: int, hi: int, parent_lbl: Optional[int]) -> Optional[int]:
        if lo > hi:
            return None
        mid = (lo + hi + 1) // 2
        if parent_lbl is not None:
            edges1.append((parent_lbl, mid))
        build(lo, mid - 1, mid)
        build(mid + 1, hi, mid)
        return mid

    top = build(1, n - 1, None)

    def shift(v: int) -> int:
        return (v % (n - 1)) + 1

    # locality-aware rank mapping on hierarchical fabrics: virtual rank r sits
    # at the r-th node of the hierarchical walk, so BST subtrees are contiguous
    # localities (pods/routers) and cross-trunk edges stay rare. Flat fabrics
    # keep plain rank order (row-major neighbors are usually adjacent).
    if topo.hierarchical:
        walk = _hierarchical_chain_order(topo, root)

        def to_node(rank: int) -> int:
            return walk[rank]
    else:
        def to_node(rank: int) -> int:
            return (root + rank) % n

    parent1 = {to_node(c): to_node(p) for (p, c) in edges1}
    parent1[to_node(top)] = root
    parent2 = {to_node(shift(c)): to_node(shift(p)) for (p, c) in edges1}
    parent2[to_node(shift(top))] = root
    t1 = Arborescence(root=root, parent=parent1, weight=0.5)
    t2 = Arborescence(root=root, parent=parent2, weight=0.5)
    t1.validate(topo)
    t2.validate(topo)
    return [t1, t2]


def edge_disjoint_bfs_trees(topo: Topology, root: int,
                            K: int) -> List[Arborescence]:
    """K spanning arborescences claiming disjoint directed candidate edges,
    grown breadth-first in round-robin (tree k starts from the root's k-th
    out-edge). On an all-port 2D torus with K = 4 this saturates all four
    root links => aggregate rate K*B (the LP optimum C = degree*B); trees
    that cannot expand disjointly fall back to already-used edges (the
    coloring then absorbs the conflict)."""
    n = topo.num_nodes
    out_edges: Dict[int, List[Edge]] = {i: [] for i in range(n)}
    for e in topo.candidate_edges:
        out_edges[e[0]].append(e)
    for i in out_edges:
        out_edges[i].sort()
    used: set = set()
    roots_out = out_edges[root]
    K = min(K, len(roots_out))
    parents: List[Dict[int, int]] = [dict() for _ in range(K)]
    reached: List[set] = [{root} for _ in range(K)]
    frontiers: List[List[int]] = [[] for _ in range(K)]
    for k in range(K):
        e = roots_out[k % len(roots_out)]
        parents[k][e[1]] = root
        reached[k].add(e[1])
        frontiers[k] = [e[1], root]
        used.add(e)
    # round-robin BFS expansion preferring unused edges
    progress = True
    while progress:
        progress = False
        for k in range(K):
            if len(reached[k]) == n:
                continue
            new_frontier: List[int] = []
            for v in frontiers[k]:
                for e in out_edges[v]:
                    w = e[1]
                    if w in reached[k] or e in used:
                        continue
                    used.add(e)
                    parents[k][w] = v
                    reached[k].add(w)
                    new_frontier.append(w)
            if new_frontier:
                progress = True
                frontiers[k] = new_frontier + frontiers[k]
    trees = []
    for k in range(K):
        # complete any stragglers with (possibly shared) BFS edges
        while len(reached[k]) < n:
            grown = False
            for v in list(reached[k]):
                for e in out_edges[v]:
                    if e[1] not in reached[k]:
                        parents[k][e[1]] = v
                        reached[k].add(e[1])
                        grown = True
            assert grown, "graph disconnected?"
        t = Arborescence(root=root, parent=parents[k], weight=1.0 / K)
        t.validate(topo)
        trees.append(t)
    return trees


def double_chain(topo: Topology, root: int) -> List[Arborescence]:
    """K=2 complementary chains (paper §3.2, Dragonfly/Fat-tree): both trees
    are Hamiltonian chains over opposite traversal orders, so each node's NIC
    alternates receive(T1)/send(T1)/receive(T2)/send(T2) — balanced
    saturation of every NIC at rate B/2 in steady state."""
    order = _greedy_hamiltonian(topo, root)
    rev = [root] + order[1:][::-1]
    return [chain_arborescence(topo, root, order),
            chain_arborescence(topo, root, rev)]


# ---------------------------------------------------------------------------
# LP-guided greedy packing
# ---------------------------------------------------------------------------

def pack_arborescences(topo: Topology, sol: SaturationSolution, K: int,
                       min_weight_frac: float = 0.02,
                       style: str = "dfs") -> List[Arborescence]:
    """Extract up to K weighted arborescences approximating the LP rates.

    Residual greedy: each tree is grown by a Prim/Dijkstra-like expansion that
    always attaches the frontier node reachable through the highest-residual
    edge (ties toward shallow depth). The tree weight is the bottleneck
    residual along its edges, capped so no single tree exhausts the budget
    needed by the remaining trees.
    """
    root = sol.root
    n = topo.num_nodes
    residual: Dict[Edge, float] = {e: r for e, r in sol.rate.items() if r > 0}
    total = sol.C if sol.C > 0 else 1.0
    trees: List[Arborescence] = []
    packed = 0.0
    for k in range(K):
        tree = _grow_tree(topo, root, residual, style=style)
        if tree is None:
            break
        # bottleneck residual along the tree
        bottleneck = min(residual.get(e, 0.0) for e in tree.edges)
        remaining = total - packed
        cap = remaining if k == K - 1 else max(remaining / (K - k),
                                               min_weight_frac * total)
        w = min(max(bottleneck, min_weight_frac * total), cap, remaining)
        if w <= 0:
            break
        tree.weight = w
        for e in tree.edges:
            residual[e] = residual.get(e, 0.0) - w
        trees.append(tree)
        packed += w
        if packed >= total * (1 - 1e-9):
            break
    if not trees:
        trees = [_grow_tree(topo, root, {e: 1.0 for e in topo.candidate_edges})]
        trees[0].weight = 1.0
    # normalize weights to fractions lambda_k
    s = sum(t.weight for t in trees)
    for t in trees:
        t.weight /= s
    return trees


def _grow_tree(topo: Topology, root: int, residual: Dict[Edge, float],
               style: str = "dfs") -> Optional[Arborescence]:
    """Grow a spanning arborescence inside the residual support.

    style="dfs": depth-first walk following the highest-residual unvisited
    edge, backtracking when stuck. On grids/tori this produces long chains
    with minimal branching — low out-degree is what lets the edge-coloring
    schedule hit d = K rounds (full rate); branching inflates d and halves
    throughput (observed: Prim-style growth yields d=2K on meshes).

    style="prim": max-residual-first frontier expansion (shallower, branchier
    — better for the latency-bound regimes).
    """
    n = topo.num_nodes
    out_edges: Dict[int, List[Edge]] = {i: [] for i in range(n)}
    for e in topo.candidate_edges:
        out_edges[e[0]].append(e)
    parent: Dict[int, int] = {}
    reached = {root}

    def res(e: Edge) -> float:
        return residual.get(e, 0.0)

    if style == "dfs":
        stack = [root]
        while len(reached) < n:
            if not stack:
                return None
            v = stack[-1]
            cands = [e for e in out_edges[v] if e[1] not in reached]
            if not cands:
                stack.pop()
                continue
            e = max(cands, key=lambda e: (res(e), -e[1]))
            parent[e[1]] = v
            reached.add(e[1])
            stack.append(e[1])
    else:
        depth = {root: 0}
        heap: List[Tuple[float, int, Edge]] = []

        def expand(v: int) -> None:
            for e in out_edges[v]:
                if e[1] not in reached:
                    heapq.heappush(heap, (-res(e), depth[v] + 1, e))

        expand(root)
        while len(reached) < n:
            while heap:
                negr, d, e = heapq.heappop(heap)
                if e[1] not in reached:
                    break
            else:
                return None
            parent[e[1]] = e[0]
            depth[e[1]] = d
            reached.add(e[1])
            expand(e[1])
    arb = Arborescence(root=root, parent=parent)
    arb.validate(topo)
    return arb


def packing_quality(trees: Sequence[Arborescence], sol: SaturationSolution,
                    topo: Topology) -> Dict[str, float]:
    """Diagnostics: achieved rate vs LP C (paper's C - O((d-1)/(K+d-1)) gap)."""
    # steady-state rate of the packed trees = C_LP * sum(lambda) if each tree
    # moves lambda_k of every packet group per period; bottleneck is the most
    # congested resource (estimated by the schedule length elsewhere).
    used: Dict[Edge, float] = {}
    for t in trees:
        for e in t.edges:
            used[e] = used.get(e, 0.0) + t.weight
    over = 0.0
    for e, u in used.items():
        budget = sol.rate.get(e, 0.0) / max(sol.C, 1e-12)
        over = max(over, u - budget)
    return dict(num_trees=len(trees),
                max_depth=max(t.depth() for t in trees),
                overuse=over)
