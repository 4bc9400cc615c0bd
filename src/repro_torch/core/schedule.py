"""Pipeline schedule assembly (paper Def. 7 + Thm 3).

A ``Pipeline`` is an ordered list of conflict-free edge-set rounds
``(E_1..E_d)``; cycling through the rounds ships one *group* of packets (one
packet per tree). Tasks are (tree_k, edge) pairs; colors from
``repro.core.coloring`` become rounds. Rounds are ordered by the minimum tree
depth of their tasks so the pipeline fill follows data availability.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.arborescence import Arborescence
from repro_torch.core.coloring import greedy_resource_coloring, konig_edge_coloring
from repro_torch.core.intersection import ALL_PORT, FULL_DUPLEX, ConflictModel
from repro_torch.core.topology import Edge, Topology


@dataclasses.dataclass
class Task:
    tree: int
    edge: Edge
    depth: int       # depth of edge head within its tree (1 = root child)


@dataclasses.dataclass
class FlatTasks:
    """Flat per-task lists for one pipeline group (see Pipeline.flat_tasks)."""

    tree: List[int]
    src: List[int]
    dst: List[int]
    depth: List[int]
    round_ix: List[int]
    dep: List[int]     # template index of the in-group dependency, -1 if none
    # per-task route override (links, latency, bandwidth) or None; the list
    # itself is None for the common case of a pipeline without overrides
    route: Optional[List[Optional[Tuple[Tuple[str, ...], float, float]]]] = None

    def __len__(self) -> int:
        return len(self.src)


@dataclasses.dataclass
class Pipeline:
    """Cyclic broadcast schedule: rounds of simultaneous (tree, edge) sends.

    ``routes`` optionally pins per-edge physical routes (links, latency,
    bandwidth) that differ from the topology's natural resolution. Symmetry
    relabeling uses this (``repro.core.symmetry``): the image of a BFS-routed
    path under a fabric automorphism is an equal-cost physical route, but not
    necessarily the one the router's tie-breaks would pick — pinning it keeps
    the relabeled schedule bit-identical to the original."""

    trees: List[Arborescence]
    rounds: List[List[Task]]                 # d rounds
    cm: ConflictModel
    routes: Optional[Dict[Edge, Tuple[Tuple[str, ...], float, float]]] = None

    @property
    def d(self) -> int:
        return len(self.rounds)

    def flat_tasks(self) -> "FlatTasks":
        """One-group task template as parallel flat lists, built once.

        Enumeration order matches ``simulator.pipeline_tasks`` (round-major,
        round order within a round) so the fast engine replays the identical
        event schedule. ``dep[i]`` is the template index of the task that
        delivers packet ``tree[i]`` to ``src[i]`` (-1 at the tree root); a dep
        index larger than ``i`` is the cyclic slide to the next period.
        """
        ft = self.__dict__.get("_flat_tasks")
        if ft is None:
            tree_ix: List[int] = []
            srcs: List[int] = []
            dsts: List[int] = []
            depths: List[int] = []
            round_ix: List[int] = []
            deliver: Dict[Tuple[int, int], int] = {}   # (node, tree) -> idx
            for ri, rnd in enumerate(self.rounds):
                for t in rnd:
                    idx = len(srcs)
                    tree_ix.append(t.tree)
                    srcs.append(t.edge[0])
                    dsts.append(t.edge[1])
                    depths.append(t.depth)
                    round_ix.append(ri)
                    deliver[(t.edge[1], t.tree)] = idx
            deps: List[int] = []
            for i, u in enumerate(srcs):
                k = tree_ix[i]
                if u == self.trees[k].root:
                    deps.append(-1)
                else:
                    dep = deliver.get((u, k))
                    assert dep is not None and dep != i, \
                        f"no delivery of tree {k} to node {u}"
                    deps.append(dep)
            routes = getattr(self, "routes", None)
            route = None
            if routes:
                route = [routes.get((u, v)) for u, v in zip(srcs, dsts)]
            ft = self._flat_tasks = FlatTasks(
                tree=tree_ix, src=srcs, dst=dsts, depth=depths,
                round_ix=round_ix, dep=deps, route=route)
        return ft

    def compiled_template(self):
        """The one-group template lowered onto the compiled resource layer
        (``repro.core.routing.CompiledTemplate``): per-task resource-id CSR,
        dependency CSR, admission ranks and Hockney constant vectors. Built
        once per pipeline and cached in-process; plan artifacts persist only
        ``flat_tasks()`` and re-lower lazily after load (O(T), cheaper than
        shipping the numpy arrays — see ``repro.core.planstore``)."""
        tpl = self.__dict__.get("_compiled_template")
        if tpl is None:
            tpl = self._compiled_template = \
                self.cm.compiled().lower_template(self.flat_tasks())
        return tpl

    def validate(self) -> None:
        seen: Dict[Tuple[int, Edge], bool] = {}
        routes = getattr(self, "routes", None)
        for r in self.rounds:
            assert self.cm.compatible([t.edge for t in r], routes=routes), \
                "round contains conflicting edges"
            for t in r:
                key = (t.tree, t.edge)
                assert key not in seen, f"task {key} scheduled twice"
                seen[key] = True
        for k, tree in enumerate(self.trees):
            for e in tree.edges:
                assert (k, e) in seen, f"tree {k} edge {e} unscheduled"


def build_pipeline(topo: Topology, trees: Sequence[Arborescence],
                   cm: ConflictModel) -> Pipeline:
    """Color all tree-edge tasks into conflict-free rounds.

    One-port models use Konig bipartite coloring on (sender, receiver) — this
    achieves the optimal d of Theorem 3 when no physical resource is shared
    beyond the ports (flat full-duplex). If the resulting classes violate
    extra physical resources (NIC/trunk/cable sharing), we fall back to greedy
    resource coloring, which handles every conflict model and stays within
    d*+1 on the paper's topologies (checked in tests).
    """
    tasks: List[Task] = []
    for k, tree in enumerate(trees):
        depths = tree.depths()
        for e in tree.edges:
            tasks.append(Task(tree=k, edge=e, depth=depths[e[1]]))

    rounds: Optional[List[List[Task]]] = None
    if cm.mode == FULL_DUPLEX:
        colors, d = konig_edge_coloring([t.edge for t in tasks])
        trial = _group(tasks, colors, d)
        if all(cm.compatible([t.edge for t in r]) for r in trial):
            rounds = trial
    if rounds is None:
        colors, d = greedy_resource_coloring(
            [t.edge for t in tasks], cm, priority=[t.depth for t in tasks])
        rounds = _group(tasks, colors, d)

    # order rounds so earlier rounds carry shallower (closer-to-root) tasks
    rounds.sort(key=lambda r: (min(t.depth for t in r), -len(r)))
    p = Pipeline(trees=list(trees), rounds=rounds, cm=cm)
    p.validate()
    return p


def _group(tasks: Sequence[Task], colors: Sequence[int], d: int,
           ) -> List[List[Task]]:
    rounds: List[List[Task]] = [[] for _ in range(d)]
    for t, c in zip(tasks, colors):
        rounds[c].append(t)
    return [r for r in rounds if r]


def degree_lower_bound(trees: Sequence[Arborescence], cm: ConflictModel) -> int:
    """d of Theorem 3 (max total out-degree across trees) generalized to the
    resource model: no schedule can be shorter."""
    return cm.degree_bound([t.edges for t in trees])
