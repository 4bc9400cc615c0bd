"""Vertex-symmetry layer: validated automorphism generators, orbit
decomposition, and exact plan relabeling.

The paper's evaluation fabrics are highly symmetric: a vertex automorphism
``g`` of the cost-annotated topology maps any valid BBS plan rooted at ``r``
onto an equally valid plan rooted at ``g(r)`` with the *identical* event
schedule up to renaming. Fabric constructors record a generating set of
automorphisms (``topology.py``); this module

  * validates each generator against the physical graph — cable/candidate
    closure and per-resource cost/capacity invariance, so a recorded
    generator provably preserves the conflict model (``validate_generator``),
  * decomposes the vertex set into orbits with one canonical representative
    per orbit and lazily-composed permutation *witnesses* mapping the
    representative onto any member (``OrbitMap``),
  * relabels a built plan by a permutation (``relabel_plan``) — pure, O(plan
    size), and bit-identical in T(m) and per-node finish times to simulating
    the original plan (proven in tests/test_symmetry.py and the engine
    matrix).

Routed paths are the one subtlety: ``FlatTopology.links`` resolves
non-cable edges along BFS shortest paths whose tie-breaks are *not*
equivariant (a ring's two antipodal routes, say). The image of a shortest
path under an automorphism is still a shortest path with identical Hockney
cost over real cables, so ``relabel_plan`` pins per-edge route *overrides*
(links, latency, bandwidth) wherever the relabeled fabric would naturally
route differently — the schedule keeps the exact conflict structure of the
original instead of silently re-routing. Hierarchical fabrics never need
overrides: their link sets are structural (``nic:i`` + trunks between
routers), and generator validation proves the induced router map preserves
trunk costs and capacities.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Perm = Tuple[int, ...]
# route override: (physical links, latency, bandwidth) pinned for one edge
Route = Tuple[Tuple[str, ...], float, float]


# ---------------------------------------------------------------------------
# Permutation algebra
# ---------------------------------------------------------------------------

def identity(n: int) -> Perm:
    return tuple(range(n))


def compose(p: Sequence[int], q: Sequence[int]) -> Perm:
    """(p o q)[v] = p[q[v]] — apply q first, then p."""
    return tuple(p[x] for x in q)


def invert(p: Sequence[int]) -> Perm:
    inv = [0] * len(p)
    for i, x in enumerate(p):
        inv[x] = i
    return tuple(inv)


def is_permutation(p: Sequence[int], n: int) -> bool:
    return len(p) == n and sorted(p) == list(range(n))


# ---------------------------------------------------------------------------
# Generator validation
# ---------------------------------------------------------------------------

def validate_generator(topo, perm: Sequence[int]) -> None:
    """Prove ``perm`` is an automorphism of the cost-annotated fabric.

    Flat topologies: the full cable set and the candidate edge set must be
    closed under the permutation (cable costs are preset-uniform, so closure
    implies cost invariance). Hierarchical topologies: the permutation must
    induce a well-defined router bijection, the candidate set must be closed,
    and the trunk sequence of every router-pair route must map onto the image
    route position-by-position with equal latency and bandwidth (capacity
    invariance for the conflict model's trunk sharing).

    Raises ``ValueError`` with a counterexample on failure.
    """
    n = topo.num_nodes
    if not is_permutation(perm, n):
        raise ValueError(f"{topo.name}: not a permutation of 0..{n - 1}")
    if getattr(topo, "hierarchical", False):
        _validate_hier(topo, perm)
    else:
        _validate_flat(topo, perm)


def _validate_flat(topo, perm: Sequence[int]) -> None:
    edge_set = topo._edge_set
    for (a, b) in topo._edges:
        if (perm[a], perm[b]) not in edge_set:
            raise ValueError(
                f"{topo.name}: cable {(a, b)} maps to non-cable "
                f"{(perm[a], perm[b])}")
    if topo._candidates is not topo._edges:
        cand = frozenset(topo._candidates)
        for (a, b) in topo._candidates:
            if (perm[a], perm[b]) not in cand:
                raise ValueError(
                    f"{topo.name}: candidate {(a, b)} maps outside the "
                    f"candidate set")


def _validate_hier(topo, perm: Sequence[int]) -> None:
    router_map: Dict[str, str] = {}
    for i in range(topo.num_nodes):
        ri, gi = topo.node_router[i], topo.node_router[perm[i]]
        prev = router_map.setdefault(ri, gi)
        if prev != gi:
            raise ValueError(
                f"{topo.name}: nodes of router {ri} map to both {prev} "
                f"and {gi} — no induced router map")
    if len(set(router_map.values())) != len(router_map):
        raise ValueError(f"{topo.name}: induced router map not a bijection")
    cand = frozenset(topo.candidate_edges)
    for (a, b) in topo.candidate_edges:
        if (perm[a], perm[b]) not in cand:
            raise ValueError(
                f"{topo.name}: candidate {(a, b)} maps outside the "
                f"candidate set")
    # trunk invariance: the image route must carry the same per-position
    # latency/bandwidth (bandwidth equality == capacity equality in the
    # conflict model), and the per-trunk name mapping must be consistent
    # across every router pair that uses the trunk.
    trunk_map: Dict[str, str] = {}
    routers = sorted(topo._router_nodes)
    for ra, rb in itertools.permutations(routers, 2):
        orig = topo._route(ra, rb)
        img = topo._route(router_map[ra], router_map[rb])
        if len(orig) != len(img):
            raise ValueError(
                f"{topo.name}: route {ra}->{rb} has {len(orig)} trunks but "
                f"its image has {len(img)}")
        for t, ti in zip(orig, img):
            prev = trunk_map.setdefault(t, ti)
            if prev != ti:
                raise ValueError(
                    f"{topo.name}: trunk {t} maps inconsistently "
                    f"({prev} vs {ti})")
            if topo._trunk_lat[t] != topo._trunk_lat[ti] or \
                    topo._trunk_bw[t] != topo._trunk_bw[ti]:
                raise ValueError(
                    f"{topo.name}: trunk {t} -> {ti} changes cost")


def record_generators(topo, proposals: Sequence[Sequence[int]],
                      strict: bool = True) -> None:
    """Validate ``proposals`` and record the survivors on the topology as
    ``_aut_gens``. With ``strict`` (the default) an invalid proposal raises;
    ``strict=False`` silently drops proposals that fail validation — used
    where a symmetry only exists for some constructor parameters (e.g. the
    dragonfly group rotation needs the lexicographic router order to agree
    with the numeric one)."""
    kept: List[Perm] = []
    for p in proposals:
        perm = tuple(p)
        if perm == identity(topo.num_nodes):
            continue
        try:
            validate_generator(topo, perm)
        except ValueError:
            if strict:
                raise
            continue
        kept.append(perm)
    topo._aut_gens = tuple(kept)


# ---------------------------------------------------------------------------
# Orbits + witnesses
# ---------------------------------------------------------------------------

class OrbitMap:
    """Orbit decomposition of 0..n-1 under a generator set, with permutation
    witnesses. ``rep_of[v]`` is the canonical (minimum-id) representative of
    v's orbit; ``witness(v)`` is a full permutation ``w`` in the generated
    group with ``w[rep_of[v]] == v``, composed lazily along the BFS parent
    chain and memoized."""

    def __init__(self, n: int, generators: Sequence[Perm]):
        self.n = n
        self.generators = tuple(generators)
        gens: List[Perm] = []
        for g in self.generators:
            gens.append(g)
            gi = invert(g)
            if gi != g:
                gens.append(gi)
        self._gens_closed = gens
        rep_of = [-1] * n
        parent: List[Optional[Tuple[int, int]]] = [None] * n   # (prev, gen ix)
        reps: List[int] = []
        for v0 in range(n):
            if rep_of[v0] >= 0:
                continue
            reps.append(v0)
            rep_of[v0] = v0
            frontier = [v0]
            while frontier:
                nxt = []
                for u in frontier:
                    for gi, g in enumerate(gens):
                        v = g[u]
                        if rep_of[v] < 0:
                            rep_of[v] = v0
                            parent[v] = (u, gi)
                            nxt.append(v)
                frontier = nxt
        self.reps: Tuple[int, ...] = tuple(reps)
        self.rep_of: List[int] = rep_of
        self._parent = parent
        self._witness: Dict[int, Perm] = {r: identity(n) for r in reps}
        members: Dict[int, List[int]] = {r: [] for r in reps}
        for v in range(n):
            members[rep_of[v]].append(v)
        self.members: Dict[int, List[int]] = members

    @property
    def num_orbits(self) -> int:
        return len(self.reps)

    def orbit(self, v: int) -> List[int]:
        return list(self.members[self.rep_of[v]])

    def witness(self, v: int) -> Perm:
        """A group element ``w`` with ``w[rep_of[v]] == v``."""
        w = self._witness.get(v)
        if w is None:
            u, gi = self._parent[v]
            w = self._witness[v] = compose(self._gens_closed[gi],
                                           self.witness(u))
        return w


class Automorphisms:
    """The validated generator set of a topology plus its (lazily built)
    orbit decomposition. Obtained via ``Topology.automorphisms()``."""

    def __init__(self, n: int, generators: Sequence[Perm]):
        self.n = n
        self.generators: Tuple[Perm, ...] = tuple(generators)
        self._orbits: Optional[OrbitMap] = None

    @property
    def trivial(self) -> bool:
        return not self.generators

    def orbits(self) -> OrbitMap:
        if self._orbits is None:
            self._orbits = OrbitMap(self.n, self.generators)
        return self._orbits

    def canonical_root(self, v: int) -> int:
        return self.orbits().rep_of[v]

    def witness(self, v: int) -> Perm:
        return self.orbits().witness(v)


# ---------------------------------------------------------------------------
# Plan relabeling
# ---------------------------------------------------------------------------

def plan_routes(topo, perm: Sequence[int],
                edges: Sequence[Tuple[int, int]]) -> Optional[Dict]:
    """Route overrides for the relabeled plan: for every routed (non-cable)
    plan edge whose natural image route differs from the permuted original
    route, pin the permuted route with the original Hockney cost. Returns
    None when no overrides are needed (hierarchical fabrics, or every image
    route already coincides)."""
    if getattr(topo, "hierarchical", False):
        return None
    routes: Dict[Tuple[int, int], Route] = {}
    edge_set = topo._edge_set
    for e in set(edges):
        if e in edge_set:
            continue
        p = topo.path(*e)
        mapped = tuple(topo._cable(perm[a], perm[b])
                       for a, b in zip(p, p[1:]))
        img = (perm[e[0]], perm[e[1]])
        if topo.links(img) != mapped:
            routes[img] = (mapped, topo.latency(e), topo.bandwidth(e))
    return routes or None


def relabel_plan(plan, perm: Sequence[int]):
    """The image of a built ``BBSPlan`` under a vertex automorphism.

    Pure and O(plan size): every tree, round, LP vector and measured ratio is
    carried over by renaming; occupancy-cycle hints transfer verbatim (they
    are template-index based and the template order is preserved). The
    returned plan simulates bit-identically to the original — same T(m), and
    ``node_finish[perm[v]] == original node_finish[v]`` — on both engines.
    """
    from repro_torch.core.arborescence import Arborescence
    from repro_torch.core.bbs import BBSPlan, Candidate
    from repro_torch.core.lp import SaturationSolution
    from repro_torch.core.schedule import Pipeline, Task

    topo = plan.topo
    g = list(perm)
    if not is_permutation(g, topo.num_nodes):
        raise ValueError("relabel_plan: perm is not a vertex permutation")

    def ge(e):
        return (g[e[0]], g[e[1]])

    candidates = []
    for c in plan.candidates:
        pipe = c.pipeline
        trees = [Arborescence(root=g[t.root],
                              parent={g[v]: g[p] for v, p in t.parent.items()},
                              weight=t.weight)
                 for t in pipe.trees]
        rounds = [[Task(tree=t.tree, edge=ge(t.edge), depth=t.depth)
                   for t in rnd] for rnd in pipe.rounds]
        plan_edges = [t.edge for rnd in pipe.rounds for t in rnd]
        routes = plan_routes(topo, g, plan_edges)
        new_pipe = Pipeline(trees=trees, rounds=rounds, cm=pipe.cm,
                            routes=routes)
        candidates.append(Candidate(name=c.name, pipeline=new_pipe,
                                    a_hat=c.a_hat, b_hat=c.b_hat,
                                    cycle=c.cycle))
    lp = plan.lp
    new_lp = SaturationSolution(
        C=lp.C,
        occupancy={ge(e): o for e, o in lp.occupancy.items()},
        rate={ge(e): r for e, r in lp.rate.items()},
        root=g[lp.root], status=lp.status)
    return BBSPlan(topo=topo, cm=plan.cm, root=g[plan.root], lp=new_lp,
                   candidates=candidates, L=plan.L, B=plan.B)
