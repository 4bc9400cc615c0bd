"""Network topologies as directed graphs with Hockney edge costs.

A topology provides:
  * ``num_nodes`` compute endpoints (0..n-1),
  * ``candidate_edges`` — the directed endpoint->endpoint edges offered to the
    LP / tree builders (pruned for hierarchical fabrics where any pair can
    physically communicate but the LP would otherwise see O(n^2) variables),
  * per-edge cost functions ``latency(e)``/``bandwidth(e)`` (Hockney:
    t(n) = L + n/B) valid for *any* endpoint pair — the simulator may cost
    transfers outside the candidate set (baselines like binomial trees use
    arbitrary pairs on hierarchical fabrics),
  * ``links(e)`` — the physical resource ids a transfer occupies (NIC links,
    cables, router trunks); contention is resource-based, see
    ``repro.core.intersection``.

Link presets follow the paper §3.1; ``tpu_ici`` models TPU v5e inter-chip links.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.routing import NextHopTable

Edge = Tuple[int, int]

LINK_PRESETS = {
    "ndr400": dict(bandwidth=50e9, latency=100e-9),        # 2D mesh (IB NDR400)
    "edr": dict(bandwidth=12.5e9, latency=100e-9),         # butterfly, fat-tree
    "aries": dict(bandwidth=5.25e9, latency=100e-9),       # dragonfly node links
    "tpu_ici": dict(bandwidth=50e9, latency=1e-6),         # TPU v5e ICI per link
}


class Topology:
    """Base class. Flat topologies enumerate explicit cables; hierarchical ones
    route through NICs + trunks and synthesize edges on demand."""

    name: str
    num_nodes: int
    hierarchical: bool = False

    # -- interface -----------------------------------------------------------
    @property
    def candidate_edges(self) -> Tuple[Edge, ...]:
        raise NotImplementedError

    def latency(self, e: Edge) -> float:
        raise NotImplementedError

    def bandwidth(self, e: Edge) -> float:
        raise NotImplementedError

    def links(self, e: Edge) -> Tuple[str, ...]:
        """Physical resources occupied by a transfer on edge e."""
        raise NotImplementedError

    def connected(self, e: Edge) -> bool:
        """Whether endpoints may communicate directly (any pair, if routed)."""
        raise NotImplementedError

    # -- helpers -------------------------------------------------------------
    @property
    def compute_nodes(self) -> range:
        return range(self.num_nodes)

    def _adjacency(self) -> Tuple[Dict[int, List[Edge]], Dict[int, List[Edge]],
                                  Dict[int, List[int]]]:
        """(out-edges, in-edges, sorted neighbor ids) per node, built once from
        ``candidate_edges`` (which is fixed after construction)."""
        adj = self.__dict__.get("_adj_maps")
        if adj is None:
            out: Dict[int, List[Edge]] = {i: [] for i in self.compute_nodes}
            inn: Dict[int, List[Edge]] = {i: [] for i in self.compute_nodes}
            for e in self.candidate_edges:
                out[e[0]].append(e)
                inn[e[1]].append(e)
            neigh = {i: sorted({j for (_, j) in out[i]})
                     for i in self.compute_nodes}
            adj = self._adj_maps = (out, inn, neigh)
        return adj

    def out_edges(self, i: int) -> List[Edge]:
        return list(self._adjacency()[0][i])

    def in_edges(self, i: int) -> List[Edge]:
        return list(self._adjacency()[1][i])

    def neighbors(self, i: int) -> List[int]:
        return list(self._adjacency()[2][i])

    def uniform(self) -> bool:
        es = self.candidate_edges
        return (len({self.latency(e) for e in es}) == 1
                and len({self.bandwidth(e) for e in es}) == 1)

    def cost(self, e: Edge, nbytes: float) -> float:
        return self.latency(e) + nbytes / self.bandwidth(e)

    def max_latency_bandwidth_product(self) -> float:
        """D = max_(i,j) L_ij * B_ij (paper §2.3)."""
        return max(self.latency(e) * self.bandwidth(e)
                   for e in self.candidate_edges)

    def validate(self) -> None:
        for e in self.candidate_edges:
            assert 0 <= e[0] < self.num_nodes and 0 <= e[1] < self.num_nodes
            assert e[0] != e[1]
            assert self.bandwidth(e) > 0 and self.latency(e) >= 0
            assert len(self.links(e)) >= 1
        adj: Dict[int, set] = {i: set() for i in self.compute_nodes}
        for (a, b) in self.candidate_edges:
            adj[a].add(b)
            adj[b].add(a)
        seen, stack = {0}, [0]
        while stack:
            v = stack.pop()
            for w in adj[v]:
                if w not in seen:
                    seen.add(w)
                    stack.append(w)
        assert len(seen) == self.num_nodes, f"{self.name}: must be connected"

    def automorphisms(self):
        """The fabric's validated vertex-automorphism generators plus orbit
        decomposition (``repro.core.symmetry.Automorphisms``). Constructors
        record a generating set (validated against the edge/cost structure at
        construction); fabrics without recorded symmetry return a trivial
        (empty-generator) object, under which every vertex is its own orbit.
        """
        from repro_torch.core.symmetry import Automorphisms
        a = self.__dict__.get("_automorphisms")
        if a is None:
            a = self._automorphisms = Automorphisms(
                self.num_nodes, getattr(self, "_aut_gens", ()))
        return a

    def __getstate__(self):
        """Pickle without derived caches (adjacency maps, next-hop tables);
        they rebuild lazily on first use after load. Keeps plan artifacts
        small and immune to cache-layout drift."""
        state = dict(self.__dict__)
        for k in ("_adj_maps", "_next_hop_table", "_automorphisms"):
            state.pop(k, None)
        return state


# ---------------------------------------------------------------------------
# Flat topologies (explicit cables)
# ---------------------------------------------------------------------------

class FlatTopology(Topology):
    """Non-hierarchical topology built from undirected cable pairs.

    shared_cable=True: both directions of a cable share one physical resource —
    the paper's pair constraint O_ij + O_ji <= 1. TPU ICI links have dedicated
    per-direction channels (shared_cable=False).

    Transfers between non-adjacent nodes are routed along BFS shortest paths
    from the precompiled all-pairs ``NextHopTable`` (one BFS per source, built
    once on first routed transfer), occupying every cable on the route —
    mirroring SimGrid's network model, which baselines like
    binomial-over-virtual-ranks rely on.
    """

    def __init__(self, name: str, n: int, pairs: Sequence[Edge], preset: str,
                 shared_cable: bool = True,
                 candidate_subset: Optional[Sequence[Edge]] = None):
        self.name = name
        self.num_nodes = n
        self._preset = preset
        self._lat = LINK_PRESETS[preset]["latency"]
        self._bw = LINK_PRESETS[preset]["bandwidth"]
        self._shared = shared_cable
        edges = []
        for (a, b) in pairs:
            edges.append((a, b))
            edges.append((b, a))
        self._edges = tuple(sorted(set(edges)))
        self._edge_set = frozenset(self._edges)
        if candidate_subset is not None:
            cand = set()
            for (a, b) in candidate_subset:
                assert (a, b) in self._edge_set
                cand.add((a, b))
                cand.add((b, a))
            self._candidates = tuple(sorted(cand))
        else:
            self._candidates = self._edges
        self._adj: Dict[int, List[int]] = {i: [] for i in range(n)}
        for (a, b) in self._edges:
            self._adj[a].append(b)
        for i in self._adj:
            self._adj[i].sort()
        self.validate()

    @property
    def candidate_edges(self) -> Tuple[Edge, ...]:
        return self._candidates

    def next_hop_table(self) -> NextHopTable:
        """The all-pairs next-hop routing table, compiled on first use (one
        BFS per source; the per-pair BFS + lru_cache this replaces had the
        same deterministic tie-break, so paths are unchanged)."""
        table = self.__dict__.get("_next_hop_table")
        if table is None:
            table = self._next_hop_table = NextHopTable(self.num_nodes,
                                                        self._adj)
        return table

    def path(self, i: int, j: int) -> Tuple[int, ...]:
        """Routed node path i -> j (table lookup, O(path length))."""
        if (i, j) in self._edge_set:
            return (i, j)
        return self.next_hop_table().path(i, j)

    def _cable(self, a: int, b: int) -> str:
        if self._shared:
            lo, hi = min(a, b), max(a, b)
            return f"cable:{lo}-{hi}"
        return f"cable:{a}->{b}"

    def latency(self, e: Edge) -> float:
        if e in self._edge_set:
            return self._lat
        return self._lat * self.next_hop_table().hops(*e)

    def bandwidth(self, e: Edge) -> float:
        return self._bw

    def links(self, e: Edge) -> Tuple[str, ...]:
        if e in self._edge_set:
            return (self._cable(*e),)
        p = self.path(*e)
        return tuple(self._cable(a, b) for a, b in zip(p, p[1:]))

    def connected(self, e: Edge) -> bool:
        return e[0] != e[1]

    def is_cable(self, e: Edge) -> bool:
        return e in self._edge_set


def _record_automorphisms(topo: Topology, gens, strict: bool = True) -> None:
    from repro_torch.core import symmetry
    symmetry.record_generators(topo, gens, strict=strict)


def _grid_perm(rows: int, cols: int, f) -> Tuple[int, ...]:
    """Vertex permutation of an rows x cols grid from a cell map (r,c)->(r,c)."""
    perm = [0] * (rows * cols)
    for r in range(rows):
        for c in range(cols):
            nr, nc = f(r, c)
            perm[r * cols + c] = nr * cols + nc
    return tuple(perm)


def mesh2d(rows: int, cols: int, preset: str = "ndr400") -> FlatTopology:
    """2D (non-wrapped) mesh; paper dims 8x16, 16x16, 16x32(8x32*), 32x32."""
    pairs = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                pairs.append((v, v + 1))
            if r + 1 < rows:
                pairs.append((v, v + cols))
    topo = FlatTopology(f"mesh2d_{rows}x{cols}", rows * cols, pairs, preset)
    # non-wrapped grid: Aut = reflections (+ transpose when square), D4/D2
    gens = [_grid_perm(rows, cols, lambda r, c: (rows - 1 - r, c)),
            _grid_perm(rows, cols, lambda r, c: (r, cols - 1 - c))]
    if rows == cols:
        gens.append(_grid_perm(rows, cols, lambda r, c: (c, r)))
    _record_automorphisms(topo, gens)
    return topo


def torus2d(rows: int, cols: int, preset: str = "tpu_ici") -> FlatTopology:
    """Wrapped 2D torus — TPU ICI (v5e pod = 16x16). Per-direction channels."""
    pairs = set()
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            pairs.add(tuple(sorted((v, r * cols + (c + 1) % cols))))
            pairs.add(tuple(sorted((v, ((r + 1) % rows) * cols + c))))
    topo = FlatTopology(f"torus2d_{rows}x{cols}", rows * cols, sorted(pairs),
                        preset, shared_cable=False)
    # wrapping adds the translations: the torus is vertex-transitive
    gens = [_grid_perm(rows, cols, lambda r, c: ((r + 1) % rows, c)),
            _grid_perm(rows, cols, lambda r, c: (r, (c + 1) % cols)),
            _grid_perm(rows, cols, lambda r, c: (rows - 1 - r, c)),
            _grid_perm(rows, cols, lambda r, c: (r, cols - 1 - c))]
    if rows == cols:
        gens.append(_grid_perm(rows, cols, lambda r, c: (c, r)))
    _record_automorphisms(topo, gens)
    return topo


def ring(n: int, preset: str = "tpu_ici") -> FlatTopology:
    pairs = sorted({tuple(sorted((i, (i + 1) % n))) for i in range(n)})
    topo = FlatTopology(f"ring_{n}", n, pairs, preset, shared_cable=False)
    _record_automorphisms(topo, [tuple((i + 1) % n for i in range(n)),
                                 tuple((n - i) % n for i in range(n))])
    return topo


def hypercube(dim: int, preset: str = "edr") -> FlatTopology:
    n = 1 << dim
    pairs = [(v, v ^ (1 << d)) for v in range(n) for d in range(dim)
             if (v ^ (1 << d)) > v]
    topo = FlatTopology(f"hypercube_{dim}", n, pairs, preset)
    # XOR translations generate a transitive subgroup of Aut(Q_d)
    _record_automorphisms(
        topo, [tuple(v ^ (1 << d) for v in range(n)) for d in range(dim)])
    return topo


def butterfly(n: int, preset: str = "edr") -> FlatTopology:
    """Flattened butterfly (Kim/Dally 2007): nodes in a rows x cols grid with
    all-to-all links within each row and each column. Candidate edges offered
    to the LP/tree builders are pruned to power-of-2 strides per dimension
    (the classic butterfly wiring) to keep the LP O(n log n); all cables remain
    available for routing/simulation."""
    rows = 1 << (int(math.log2(n)) // 2)
    cols = n // rows
    assert rows * cols == n, f"butterfly needs 2^k nodes, got {n}"
    pairs = set()
    for r in range(rows):
        row = [r * cols + c for c in range(cols)]
        pairs.update(itertools.combinations(row, 2))
    for c in range(cols):
        col = [r * cols + c for r in range(rows)]
        pairs.update(itertools.combinations(col, 2))
    cand = set()
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            s = 1
            while s < cols:
                cand.add(tuple(sorted((v, r * cols + (c + s) % cols))))
                s *= 2
            s = 1
            while s < rows:
                cand.add(tuple(sorted((v, ((r + s) % rows) * cols + c))))
                s *= 2
    topo = FlatTopology(f"butterfly_{n}", n, sorted(pairs), preset,
                        candidate_subset=sorted(cand))
    # row/column rotations: all-to-all cables are closed under any row/col
    # permutation, and the power-of-2 stride candidate pairs are cyclic in
    # each dimension — the flattened butterfly is vertex-transitive
    _record_automorphisms(
        topo, [_grid_perm(rows, cols, lambda r, c: ((r + 1) % rows, c)),
               _grid_perm(rows, cols, lambda r, c: (r, (c + 1) % cols))])
    return topo


# ---------------------------------------------------------------------------
# Hierarchical topologies (NIC + router trunks; edges routed on demand)
# ---------------------------------------------------------------------------

class HierTopology(Topology):
    """Endpoints hang off routers by a single NIC link; routers joined by
    trunks. Any endpoint pair is connected; the candidate set offered to tree
    builders is pruned (intra-router complete + representative remote peers).

    The defining contention property (paper §3.2): every transfer in or out of
    node i occupies ``nic:i``, so a node cannot send and receive at full rate
    simultaneously => C saturates at B/2.
    """

    hierarchical = True

    def __init__(self, name: str, n: int, node_router: Dict[int, str],
                 route: Callable[[str, str], Tuple[str, ...]],
                 trunk_latency: Dict[str, float],
                 trunk_bandwidth: Dict[str, float],
                 nic_preset: str):
        self.name = name
        self.num_nodes = n
        self.node_router = node_router
        self._route = route
        self._trunk_lat = trunk_latency
        self._trunk_bw = trunk_bandwidth
        self._nic_lat = LINK_PRESETS[nic_preset]["latency"]
        self._nic_bw = LINK_PRESETS[nic_preset]["bandwidth"]
        self._router_nodes: Dict[str, List[int]] = {}
        for i in range(n):
            self._router_nodes.setdefault(node_router[i], []).append(i)
        self._candidates = self._build_candidates()
        self.validate()

    def _build_candidates(self) -> Tuple[Edge, ...]:
        """Pruned candidate set: complete graph within each router (capped by
        power-of-2 strides for large routers) + one representative endpoint in
        each remote router at power-of-2 stride distances. Keeps the LP size
        O(n log n) while preserving log diameter and even trunk spread; the
        simulator can still cost arbitrary pairs for baselines."""
        edges = set()
        routers = sorted(self._router_nodes)
        nr = len(routers)
        ridx = {r: k for k, r in enumerate(routers)}
        strides = []
        s = 1
        while s < nr:
            strides.append(s)
            s *= 2
        for i in range(self.num_nodes):
            local = self._router_nodes[self.node_router[i]]
            li = local.index(i)
            nl = len(local)
            ls, s = [], 1
            while s <= max(1, nl // 2):
                ls.append(s)
                s *= 2
            for st in ls:
                j = local[(li + st) % nl]
                if i != j:
                    edges.add((i, j))
                    edges.add((j, i))
            my_r = ridx[self.node_router[i]]
            for st in strides:
                r = routers[(my_r + st) % nr]
                peers = self._router_nodes[r]
                # local-index-preserving peer choice: node li of a router
                # talks to node li of the remote router, so router-level
                # symmetries (pod/group rotations) map candidates onto
                # candidates — the precondition for orbit-shared plans
                j = peers[li % len(peers)]
                edges.add((i, j))
                edges.add((j, i))
        return tuple(sorted(edges))

    @property
    def candidate_edges(self) -> Tuple[Edge, ...]:
        return self._candidates

    def connected(self, e: Edge) -> bool:
        return e[0] != e[1] and 0 <= e[0] < self.num_nodes \
            and 0 <= e[1] < self.num_nodes

    def links(self, e: Edge) -> Tuple[str, ...]:
        i, j = e
        ri, rj = self.node_router[i], self.node_router[j]
        path: Tuple[str, ...] = (f"nic:{i}",)
        if ri != rj:
            path = path + self._route(ri, rj)
        return path + (f"nic:{j}",)

    def latency(self, e: Edge) -> float:
        i, j = e
        ri, rj = self.node_router[i], self.node_router[j]
        lat = 2 * self._nic_lat
        if ri != rj:
            for t in self._route(ri, rj):
                lat += self._trunk_lat[t]
        return lat

    def bandwidth(self, e: Edge) -> float:
        i, j = e
        ri, rj = self.node_router[i], self.node_router[j]
        bw = self._nic_bw
        if ri != rj:
            for t in self._route(ri, rj):
                bw = min(bw, self._trunk_bw[t])
        return bw


class FatTreeRoute:
    """Leaf -> core -> leaf route (module-level so plans pickle)."""

    def __call__(self, ra: str, rb: str) -> Tuple[str, ...]:
        return (f"trunk:{ra}", f"trunk:{rb}")


def fat_tree(n: int, radix: int = 16, preset: str = "edr") -> HierTopology:
    """Two-level full-bisection fat-tree: pods of `radix` endpoints, leaf
    switches joined through a core. EDR on all links (paper §3.1)."""
    node_router = {i: f"leaf{i // radix}" for i in range(n)}
    num_pods = (n + radix - 1) // radix
    lat = LINK_PRESETS[preset]["latency"]
    bw = LINK_PRESETS[preset]["bandwidth"]
    trunk_latency, trunk_bandwidth = {}, {}
    for p in range(num_pods):
        t = f"trunk:leaf{p}"
        trunk_latency[t] = lat
        trunk_bandwidth[t] = bw * radix   # full bisection

    topo = HierTopology(f"fattree_{n}", n, node_router, FatTreeRoute(),
                        trunk_latency, trunk_bandwidth, preset)
    if n % radix == 0 and num_pods > 1:
        # full pods: pod rotation/reflection + a synchronized local rotation
        # make the fat-tree vertex-transitive (validated: trunk costs are
        # uniform and the candidate rule is local-index-preserving)
        def pod_map(f):
            return tuple(f(i // radix, i % radix) for i in range(n))
        _record_automorphisms(topo, [
            pod_map(lambda p, l: ((p + 1) % num_pods) * radix + l),
            pod_map(lambda p, l: (num_pods - 1 - p) * radix + l),
            pod_map(lambda p, l: p * radix + (l + 1) % radix),
        ])
    return topo


class DragonflyRoute:
    """Minimal dragonfly route: one local or one global trunk per hop.

    Trunk entries materialize in the shared latency/bandwidth dicts on first
    use (the same dict objects the owning ``HierTopology`` holds, so pickling
    a topology preserves the sharing). Module-level so plans pickle.
    """

    def __init__(self, trunk_bw: float,
                 trunk_latency: Dict[str, float],
                 trunk_bandwidth: Dict[str, float]):
        self.trunk_bw = trunk_bw
        self.trunk_latency = trunk_latency
        self.trunk_bandwidth = trunk_bandwidth

    def __call__(self, ra: str, rb: str) -> Tuple[str, ...]:
        ga, gb = ra.split("r")[0], rb.split("r")[0]
        if ga == gb:
            lo, hi = sorted((ra, rb))
            t = f"local:{lo}-{hi}"
            if t not in self.trunk_latency:
                self.trunk_latency[t] = 200e-9
                self.trunk_bandwidth[t] = self.trunk_bw
            return (t,)
        lo, hi = sorted((ga, gb))
        t = f"global:{lo}-{hi}"
        if t not in self.trunk_latency:
            self.trunk_latency[t] = 400e-9
            self.trunk_bandwidth[t] = self.trunk_bw
        return (t,)


def dragonfly(n: int, nodes_per_router: int = 4,
              routers_per_group: int = 8) -> HierTopology:
    """Dragonfly (Kim et al. 2008). Aries links: 100ns node-router, 200ns
    intra-group router-router, 400ns inter-group (paper §3.1)."""
    per_group = nodes_per_router * routers_per_group
    node_router = {}
    for i in range(n):
        g = i // per_group
        r = (i % per_group) // nodes_per_router
        node_router[i] = f"g{g}r{r}"
    aries_b = LINK_PRESETS["aries"]["bandwidth"]
    trunk_latency: Dict[str, float] = {}
    trunk_bandwidth: Dict[str, float] = {}
    route = DragonflyRoute(aries_b * nodes_per_router,
                           trunk_latency, trunk_bandwidth)
    topo = HierTopology(f"dragonfly_{n}", n, node_router, route,
                        trunk_latency, trunk_bandwidth, "aries")
    gens = []
    if n % per_group == 0 and n // per_group > 1:
        # group rotation: only valid while the lexicographic router order
        # (g0r0, g0r1, ...) agrees with the numeric group order, hence
        # strict=False below — it is dropped by validation past 9 groups
        gens.append(tuple((i + per_group) % n for i in range(n)))
    # synchronized rotation of the node slots within every router
    gens.append(tuple(i - i % nodes_per_router
                      + (i + 1) % nodes_per_router for i in range(n)))
    _record_automorphisms(topo, gens, strict=False)
    return topo


def by_name(name: str, n: int) -> Topology:
    """Factory used by benchmarks: the paper's four topologies + TPU torus."""
    if name == "mesh2d":
        shapes = {128: (8, 16), 256: (16, 16), 512: (16, 32), 1024: (32, 32)}
        r, c = shapes.get(n) or (int(math.sqrt(n)), n // int(math.sqrt(n)))
        return mesh2d(r, c)
    if name == "butterfly":
        return butterfly(n)
    if name == "dragonfly":
        return dragonfly(n)
    if name == "fattree":
        return fat_tree(n)
    if name == "torus2d":
        k = int(round(math.sqrt(n)))
        assert k * k == n
        return torus2d(k, k)
    if name == "ring":
        return ring(n)
    raise ValueError(f"unknown topology {name}")


PAPER_TOPOLOGIES = ("mesh2d", "butterfly", "dragonfly", "fattree")
PAPER_SIZES = (128, 256, 512, 1024)
PAPER_MESSAGE_SIZES = tuple(int(s) for s in
                            (64e3, 256e3, 1e6, 4e6, 16e6, 64e6, 128e6))
