"""The saturation LP of BBS (paper §2.5 / §2.6).

Variables: occupancy O_e in [0,1] per candidate directed edge e, plus the
balanced incoming rate C. Writing R_e = O_e * B_e for the data rate of edge e:

  maximize  C
  s.t.      O_{i,root} = 0                                (graph constraints)
            0 <= O_e <= 1
            sum_{e in group(r)} O_e * (B_e / B_r) <= 1    (intersecting groups:
                one-port send/recv ports, shared cables, NIC links, trunks —
                exactly the paper's send/receive + pair constraints, with the
                capacity weighting reducing to sum O_e <= 1 in the uniform case)
            R_e - C <= 0                 for e=(i,j), i != root  (forwarding:
                with the equal-incoming-flow equality, "out-rate <= total
                in-rate of the sender" is exactly R_e <= C)
            R_e - sum_k R_{root,k} <= 0                   (root forwarding)
            sum_{e into j} R_e = C       for all j != root (incoming flow)

Solved with scipy's HiGHS on sparse matrices. A tiny L1 penalty on occupancies
breaks ties toward sparse solutions (helps the tree packer). The known analytic
optima (C = B for one-port full-duplex flat topologies with a Hamiltonian path,
C = B/2 for hierarchical single-NIC fabrics) are used as cross-checks in tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.optimize import linprog

from repro_torch.core.intersection import ConflictModel
from repro_torch.core.topology import Edge, Topology


@dataclasses.dataclass
class SaturationSolution:
    """LP result: balanced per-node incoming rate C (bytes/s) and per-edge
    occupancies / rates."""

    C: float
    occupancy: Dict[Edge, float]          # O_e in [0,1]
    rate: Dict[Edge, float]               # R_e = O_e * B_e (bytes/s)
    root: int
    status: str

    def support(self, tol: float = 1e-9) -> List[Edge]:
        return [e for e, r in self.rate.items() if r > tol]


def _resource_capacity(cm: ConflictModel, res) -> float:
    """Capacity (bytes/s) of a resource: physical links carry their bandwidth;
    port/node resources are pure time-sharing (capacity folded into weights)."""
    kind = res[0]
    if kind == "link":
        return None  # looked up per-link below
    return None


def solve_saturation_lp(topo: Topology, cm: ConflictModel, root: int,
                        l1: float = 1e-7) -> SaturationSolution:
    edges = [e for e in topo.candidate_edges if e[1] != root]
    idx = {e: k for k, e in enumerate(edges)}
    ne = len(edges)
    nv = ne + 1          # last var = C
    # normalize bandwidths to O(1) (HiGHS scaling): C is solved in Bmax units
    Braw = np.array([topo.bandwidth(e) for e in edges])
    Bscale = float(Braw.max())
    B = Braw / Bscale
    Bmax = 1.0

    rows_ub: List[Tuple[List[int], List[float], float]] = []

    # --- intersecting-group constraints --------------------------------------
    # group edges by resource; weight = B_e / B_r for links, 1 for ports.
    by_res: Dict[Tuple, List[int]] = {}
    for e in edges:
        for r in cm.resources(e):
            by_res.setdefault(r, []).append(idx[e])
    # link capacities: trunk capacity from the HierTopology tables when
    # available; NIC links at the NIC rate; plain cables at edge bandwidth.
    link_bw: Dict[Tuple, float] = {}
    for r, eidxs in by_res.items():
        if r[0] != "link":
            continue
        name = r[1]
        cap = None
        tb = getattr(topo, "_trunk_bw", None)
        if tb and name in tb:
            cap = tb[name] / Bscale
        nb = getattr(topo, "_nic_bw", None)
        if cap is None and nb and name.startswith("nic:"):
            cap = nb / Bscale
        if cap is None:
            cap = max(B[k] for k in eidxs)
        link_bw[r] = cap

    for r, eidxs in sorted(by_res.items(), key=lambda kv: str(kv[0])):
        if len(eidxs) < 2:
            # single-edge groups are dominated by 0 <= O_e <= 1
            continue
        if r[0] == "link":
            w = [float(B[k] / link_bw[r]) for k in eidxs]
        else:
            w = [1.0] * len(eidxs)
        rows_ub.append((list(eidxs), w, 1.0))

    # --- forwarding: R_e <= C for senders that are not the root --------------
    for e in edges:
        if e[0] != root:
            rows_ub.append(([idx[e], ne], [float(B[idx[e]]), -1.0], 0.0))
    # --- root forwarding: R_e <= sum_k R_{root,k} -----------------------------
    root_out = [idx[e] for e in edges if e[0] == root]
    for e in edges:
        if e[0] == root:
            continue
        cols = [idx[e]] + root_out
        vals = [float(B[idx[e]])] + [-float(B[k]) for k in root_out]
        rows_ub.append((cols, vals, 0.0))

    # --- equality: incoming flow = C per non-root node ------------------------
    rows_eq: List[Tuple[List[int], List[float], float]] = []
    for j in topo.compute_nodes:
        if j == root:
            continue
        cols = [idx[e] for e in edges if e[1] == j]
        vals = [float(B[k]) for k in cols]
        rows_eq.append((cols + [ne], vals + [-1.0], 0.0))

    def assemble(rows):
        data, ri, ci, rhs = [], [], [], []
        for rr, (cols, vals, b) in enumerate(rows):
            for c, v in zip(cols, vals):
                ri.append(rr)
                ci.append(c)
                data.append(v)
            rhs.append(b)
        mat = sp.csr_matrix((data, (ri, ci)), shape=(len(rows), nv))
        return mat, np.array(rhs)

    A_ub, b_ub = assemble(rows_ub)
    A_eq, b_eq = assemble(rows_eq)

    # objective: maximize C, tie-break toward low total occupancy
    c = np.full(nv, l1 * Bmax / max(ne, 1))
    c[ne] = -1.0
    bounds = [(0.0, 1.0)] * ne + [(0.0, None)]

    res = linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                  bounds=bounds, method="highs")
    if not res.success:
        raise RuntimeError(f"saturation LP failed on {topo.name}: {res.message}")
    occ = {e: float(np.clip(res.x[idx[e]], 0.0, 1.0)) for e in edges}
    # edges into the root exist in the topology but carry nothing
    for e in topo.candidate_edges:
        if e[1] == root:
            occ[e] = 0.0
    rate = {e: occ[e] * topo.bandwidth(e) for e in occ}
    return SaturationSolution(C=float(res.x[ne]) * Bscale, occupancy=occ,
                              rate=rate, root=root, status="optimal")


def verify_solution(topo: Topology, cm: ConflictModel, sol: SaturationSolution,
                    tol: float = 1e-6) -> None:
    """Assert every paper constraint class holds (used by property tests)."""
    root = sol.root
    by_res: Dict[Tuple, float] = {}
    for e, o in sol.occupancy.items():
        assert -tol <= o <= 1 + tol, f"occupancy bound violated on {e}"
        if e[1] == root:
            assert o <= tol, "edge into root must be idle"
        for r in cm.resources(e):
            if r[0] == "link":
                tb = getattr(topo, "_trunk_bw", None)
                nb = getattr(topo, "_nic_bw", None)
                cap = (tb or {}).get(r[1])
                if cap is None and nb and r[1].startswith("nic:"):
                    cap = nb
                if cap is None:
                    cap = topo.bandwidth(e)
                by_res[r] = by_res.get(r, 0.0) + o * topo.bandwidth(e) / cap
            else:
                by_res[r] = by_res.get(r, 0.0) + o
    for r, tot in by_res.items():
        assert tot <= 1 + 1e-4, f"resource {r} oversubscribed: {tot}"
    root_out = sum(sol.rate[e] for e in sol.rate if e[0] == root)
    for j in topo.compute_nodes:
        if j == root:
            continue
        inflow = sum(sol.rate[e] for e in sol.rate if e[1] == j)
        assert abs(inflow - sol.C) <= tol * max(1.0, sol.C), \
            f"incoming flow mismatch at {j}: {inflow} vs C={sol.C}"
    for e, r in sol.rate.items():
        if e[0] != root:
            assert r <= sol.C + tol * max(1.0, sol.C), f"forwarding violated on {e}"
        assert r <= root_out + tol * max(1.0, root_out), \
            f"root forwarding violated on {e}"
