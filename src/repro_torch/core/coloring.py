"""Edge coloring of the task multigraph -> conflict-free pipeline rounds.

Theorem 3 (paper): for K directed trees under one-port full-duplex uniform
assumptions, build the bipartite multigraph G* (senders x receivers, one edge
per tree edge) and color it with exactly d = max degree colors (Gabow-Kariv /
Konig). Each color class is a matching => a conflict-free round.

We implement the constructive Konig argument: insert edges one at a time; if no
color is free at both endpoints, flip a two-color alternating path. For
resource models beyond one-port bipartite (NIC sharing, trunks, half duplex)
the bipartite guarantee does not apply, so ``schedule_rounds`` colors greedily
over *resources* and then verifies each round with the ConflictModel — with the
Goldberg-Seymour d*+1 bound as the quality target (asserted in tests for the
paper's cases).
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from repro_torch.core.intersection import ConflictModel
from repro_torch.core.topology import Edge


def konig_edge_coloring(edges: Sequence[Tuple[Hashable, Hashable]],
                        ) -> Tuple[List[int], int]:
    """Color a bipartite multigraph with exactly max-degree colors.

    `edges` are (left, right) pairs; returns (color per edge, num_colors).
    Left and right vertex namespaces are disjoint by construction (senders vs
    receivers), so the graph is bipartite even when the same node id appears on
    both sides.
    """
    deg: Dict[Tuple[str, Hashable], int] = {}
    for (u, v) in edges:
        deg[("L", u)] = deg.get(("L", u), 0) + 1
        deg[("R", v)] = deg.get(("R", v), 0) + 1
    d = max(deg.values()) if deg else 0
    # free[vertex] = set of colors not used at vertex; col[vertex][color]=edge idx
    used: Dict[Tuple[str, Hashable], Dict[int, int]] = {}
    color: List[Optional[int]] = [None] * len(edges)

    def vfree(v: Tuple[str, Hashable]) -> int:
        u = used.setdefault(v, {})
        for c in range(d):
            if c not in u:
                return c
        raise AssertionError("no free color; degree bound broken")

    for ei, (u, v) in enumerate(edges):
        L, R = ("L", u), ("R", v)
        cu, cv = vfree(L), vfree(R)
        if cu != cv:
            # make cu free at R: flip the (cu, cv)-alternating path from R.
            # Collect the path first, then recolor (in-place walking corrupts
            # the `used` maps of interior vertices).
            path: List[int] = []           # edge indices along the path
            at, want = R, cu
            while True:
                e2 = used.get(at, {}).get(want)
                if e2 is None:
                    break
                path.append(e2)
                eu, ev = edges[e2]
                at = ("R", ev) if at == ("L", eu) else ("L", eu)
                want = cv if want == cu else cu
            # bipartiteness guarantees the path never reaches L (odd cycle
            # otherwise), so flipping keeps cu free at L.
            for e2 in path:
                eu, ev = edges[e2]
                for vv in (("L", eu), ("R", ev)):
                    if used[vv].get(color[e2]) == e2:
                        del used[vv][color[e2]]
            for e2 in path:
                newc = cv if color[e2] == cu else cu
                color[e2] = newc
                eu, ev = edges[e2]
                used.setdefault(("L", eu), {})[newc] = e2
                used.setdefault(("R", ev), {})[newc] = e2
        used.setdefault(L, {})[cu] = ei
        used.setdefault(R, {})[cu] = ei
        color[ei] = cu

    assert all(c is not None for c in color)
    return [int(c) for c in color], d


def greedy_resource_coloring(tasks: Sequence[Edge], cm: ConflictModel,
                             priority: Optional[Sequence[int]] = None,
                             ) -> Tuple[List[int], int]:
    """Color arbitrary task edges so no two same-colored tasks share a
    resource. Greedy smallest-free-color over resource occupancy; with
    priorities (e.g. tree depth) earlier tasks get earlier rounds, which
    shortens the pipeline fill. Bound: <= d* + gap; verified per round."""
    order = sorted(range(len(tasks)),
                   key=lambda i: (priority[i] if priority is not None else 0, i))
    ct = cm.compiled()
    caps = ct.caps                 # dense capacities, grown by interning
    res_used: Dict[int, Dict[int, int]] = {}
    color = [0] * len(tasks)
    ncolors = 0
    for i in order:
        rs = ct.edge_ids(tasks[i])
        c = 0
        while any(res_used.setdefault(r, {}).get(c, 0) >= caps[r] for r in rs):
            c += 1
        color[i] = c
        ncolors = max(ncolors, c + 1)
        for r in rs:
            res_used[r][c] = res_used[r].get(c, 0) + 1
    return color, ncolors
