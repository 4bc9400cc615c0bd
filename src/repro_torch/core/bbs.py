"""Broadcast by Balanced Saturation — the composed solver (paper §2.6).

Layers: saturation LP -> arborescence generation -> pipeline schedule ->
profile-driven selection:

1.  The LP (§2.5) bounds the achievable balanced incoming rate C and guides
    tree packing.
2.  Several candidate tree-sets are generated (LP-guided DFS packing at
    several K, Hamiltonian chain, complementary double chain, binomial, BFS)
    and each is compiled into a conflict-free cyclic pipeline (Thm 3 coloring).
3.  Each candidate's dimensionless time-profile ratios (a_hat, b_hat) are
    *measured once* from prefix simulations (Thm 2: T(m) = a + Δ·m; §2.3:
    a/τ and Δ/τ are packet-size-independent for packets >> D).
4.  Per message size, BBS selects the candidate minimizing the closed-form
    optimum T_opt = a_hat·L + b_hat·M/B + 2·sqrt(a_hat·b_hat·L·M/B) (Eq. 4)
    and splits the message into m_opt = sqrt(a_hat·M/(b_hat·L·B)) groups
    (Eq. 3). Small messages fall out naturally (m = 1, shallow tree wins);
    large messages select the saturating packing — the paper's three regimes
    emerge from the same formula.

Plans are deterministic, built once per (topology, root, mode), cheap to
store, and reusable for any message size — the paper's "low storage / build
offline" property. ``repro.collectives`` executes the same pipeline artifact
with jax.lax.ppermute on real device meshes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import arborescence as arb
from repro_torch.core.fastsim import CompiledSim, CycleInfo
from repro_torch.core.intersection import ALL_PORT, FULL_DUPLEX, ConflictModel
from repro_torch.core.lp import SaturationSolution, solve_saturation_lp
from repro_torch.core.schedule import Pipeline, build_pipeline
from repro_torch.core.simconfig import SimConfig, UNSET, resolve_config
from repro_torch.core.simulator import (DEFAULT_ENGINE, EventSimulator,
                                  simulate_pipeline)
from repro_torch.core.timeprofile import optimal_group_count, optimal_time
from repro_torch.core.topology import Edge, Topology


@dataclasses.dataclass
class Candidate:
    name: str
    pipeline: Pipeline
    a_hat: float
    b_hat: float
    # occupancy-cycle scan hint recorded at build time (probe packet sizes):
    # lets simulate_pipeline skip the cycle scan and go straight to
    # verification; None when the bounded scan found no recurrence
    cycle: Optional[CycleInfo] = None

    @property
    def min_lambda(self) -> float:
        return min(t.weight for t in self.pipeline.trees)

    def t_opt(self, message_bytes: float, L: float, B: float) -> float:
        # (a_hat, b_hat) are in units of tau = L + P/B with P the *minimum
        # packet* of a group (= lambda_min * group bytes), so Eq. 4 applies to
        # the per-packet byte stream M * lambda_min
        return optimal_time(self.a_hat, self.b_hat,
                            message_bytes * self.min_lambda, L, B)

    def m_opt(self, message_bytes: float, L: float, B: float) -> int:
        return optimal_group_count(self.a_hat, self.b_hat,
                                   message_bytes * self.min_lambda, L, B)


@dataclasses.dataclass
class BBSPlan:
    """Built-once broadcast plan for one (topology, root, mode)."""

    topo: Topology
    cm: ConflictModel
    root: int
    lp: SaturationSolution
    candidates: List[Candidate]
    L: float                       # minimal latency (paper's L)
    B: float                       # maximal bandwidth (paper's B)

    def select(self, message_bytes: float, top: int = 3,
               ) -> List[Tuple[Candidate, int]]:
        """Top candidates by the Eq.4 closed form, with their Eq.3 m_opt.
        The caller simulates them and keeps the winner (the closed form uses
        measured ratios, so a short simulation arbitrates its ties)."""
        ranked = sorted(self.candidates,
                        key=lambda c: c.t_opt(message_bytes, self.L, self.B))
        out = []
        for c in ranked[:top]:
            m = max(1, c.m_opt(message_bytes, self.L, self.B))
            K = len(c.pipeline.trees)
            # packets must stay >= a few bytes
            m = min(m, max(1, int(message_bytes / (64 * K)) or 1))
            out.append((c, m))
        return out

    def relabel(self, perm: Sequence[int]) -> "BBSPlan":
        """The image of this plan under a vertex automorphism: same measured
        ratios and cycle hints, trees/rounds/LP renamed, routed paths pinned
        so the relabeled schedule replays bit-identically (same T(m),
        ``node_finish[perm[v]] == node_finish[v]``) — see
        ``repro.core.symmetry.relabel_plan``. O(plan size), no rebuild."""
        from repro_torch.core.symmetry import relabel_plan
        return relabel_plan(self, perm)


def _candidate_trees(topo: Topology, sol: SaturationSolution, root: int,
                     mode: str = FULL_DUPLEX,
                     ) -> Dict[str, List[arb.Arborescence]]:
    cands: Dict[str, List[arb.Arborescence]] = {}
    cands["chain"] = [arb.chain_arborescence(topo, root)]
    dc = arb.double_chain(topo, root)
    for t in dc:
        t.weight = 0.5
    cands["double_chain"] = dc
    root_deg = len({e for e in sol.support(1e-3) if e[0] == root})
    for K in sorted({2, max(2, root_deg), max(2, min(8, root_deg * 2))}):
        try:
            cands[f"lp_pack_K{K}"] = arb.pack_arborescences(topo, sol, K=K)
        except AssertionError:
            pass
    cands["binomial"] = [arb.binomial_arborescence(topo, root)]
    cands["bfs"] = [_bfs_tree(topo, root)]
    if topo.num_nodes >= 3:
        cands["two_tree"] = arb.two_tree(topo, root)
    if mode == ALL_PORT:
        # multi-port roots can drive several disjoint trees at full rate
        out_deg = min(6, len({e for e in topo.candidate_edges
                              if e[0] == root}))
        if out_deg >= 2:
            cands[f"disjoint_bfs_K{out_deg}"] = \
                arb.edge_disjoint_bfs_trees(topo, root, out_deg)
    return cands


def build_plan(topo: Topology, root: int = 0, mode: str = FULL_DUPLEX,
               lp_solution: Optional[SaturationSolution] = None,
               probe_groups: int = 4, engine=UNSET,
               cycle_scan: int = 64,
               cm: Optional[ConflictModel] = None, *,
               config: Optional[SimConfig] = None) -> BBSPlan:
    """Build the once-per-(topology, root, mode) BBS plan.

    The probe-simulation engine comes from ``config=SimConfig(...)``; the
    legacy ``engine=`` kwarg still works through the deprecation shim
    (``repro.core.simconfig.resolve_config``, one warning per process).

    Each candidate pipeline is probed with a ``probe_groups``-group
    simulation: Δ comes from the last two group finishes. The m=1 fill time
    T(1) comes from an *isolated group-0 replay* on the compiled template —
    one extra T-task event-loop pass on an empty fabric, bit-identical to a
    separate m=1 simulation, so ``a_hat`` is exact even for jittery
    multi-tree schedules (whose group-0 prefix inside the probe run absorbs
    steady-state contention; that earlier shortcut drifted plans by ~6% and is
    gone). Both probe simulations are complete runs, so plans are
    bit-identical across engines (regression-tested).

    With the fast engine, each candidate's template is additionally scanned
    (bounded by ``cycle_scan`` groups, tapered by template size; 0 disables)
    for an occupancy-cycle recurrence at the probe packet sizes; the hint is
    recorded on the ``Candidate`` so later ``broadcast_time`` calls skip the
    scan and go straight to cycle verification.

    ``cm`` lets multi-root builders (``PlanStore.get_or_build_packed``) share
    one ``ConflictModel`` — and with it the compiled routing layer and the
    pickle object graph — across every root's plan.
    """
    engine = resolve_config(config, engine=engine).engine
    if cm is None:
        cm = ConflictModel(topo, mode)
    elif cm.topo is not topo or cm.mode != mode:
        raise ValueError(
            f"shared ConflictModel is for ({cm.topo.name!r}, {cm.mode!r}), "
            f"not ({topo.name!r}, {mode!r})")
    sol = lp_solution or solve_saturation_lp(topo, cm, root)
    D = topo.max_latency_bandwidth_product()
    L = min(topo.latency(e) for e in topo.candidate_edges)
    B = max(topo.bandwidth(e) for e in topo.candidate_edges)

    candidates: List[Candidate] = []
    for name, trees in _candidate_trees(topo, sol, root, mode).items():
        pipe = build_pipeline(topo, trees, cm)
        K = len(trees)
        min_lambda = min(t.weight for t in trees)
        # probe with packets far above D (paper's asymptotic assumption)
        group_bytes = 256.0 * D * K
        msg = group_bytes * probe_groups
        t_m, res, delta = simulate_pipeline(
            topo, cm, pipe, msg, probe_groups, root,
            config=SimConfig(engine=engine, max_sim_groups=probe_groups))
        # exact T(1): an isolated one-group run, replayed straight from the
        # compiled template under the fast engine
        t1, _, _ = simulate_pipeline(topo, cm, pipe, group_bytes, 1, root,
                                     config=SimConfig(engine=engine))
        cyc = None
        gf = res.group_finish
        probe_steady = len(gf) >= 3 and \
            abs((gf[-1] - gf[-2]) - (gf[-2] - gf[-3])) <= 1e-9 * abs(gf[-1])
        if engine == "fast" and cycle_scan > 0 and not probe_steady:
            # scan only jittery candidates: pattern-periodic ones (the chain
            # family) take the prefix-steady path at run time and never
            # consult the hint
            T = len(pipe.flat_tasks())
            budget = min(cycle_scan,
                         max(3 * probe_groups, 4000 // max(T, 1)))
            packet_bytes = [group_bytes * t.weight for t in pipe.trees]
            cyc = CompiledSim(topo, cm, root).scan_cycle(
                pipe, packet_bytes, budget)
        tau = L + group_bytes * min_lambda / B
        delta = max(delta, 1e-15)
        a = max(t1 - delta, 0.0)
        candidates.append(Candidate(name=name, pipeline=pipe,
                                    a_hat=a / tau, b_hat=delta / tau,
                                    cycle=cyc))
    return BBSPlan(topo=topo, cm=cm, root=root, lp=sol,
                   candidates=candidates, L=L, B=B)


def _bfs_tree(topo: Topology, root: int) -> arb.Arborescence:
    parent: Dict[int, int] = {}
    seen = {root}
    frontier = [root]
    while frontier:
        nxt = []
        for v in frontier:
            for w in topo.neighbors(v):
                if w not in seen:
                    seen.add(w)
                    parent[w] = v
                    nxt.append(w)
        frontier = nxt
    t = arb.Arborescence(root=root, parent=parent)
    t.validate(topo)
    return t


def broadcast_time(plan: BBSPlan, message_bytes: float,
                   num_groups: Optional[int] = None,
                   max_sim_groups=UNSET,
                   engine=UNSET,
                   faults=UNSET, *,
                   config: Optional[SimConfig] = None) -> Tuple[float, Dict]:
    """Simulated BBS broadcast time: Eq.3/Eq.4 rank the candidates and pick
    m_opt; a short prefix simulation arbitrates among the top few (the
    closed form uses measured ratios and can tie within noise).

    Simulation options come from ``config=SimConfig(...)``; the legacy
    ``max_sim_groups=`` / ``engine=`` / ``faults=`` kwargs still work
    through the deprecation shim (bit-identical, one warning per process).

    With a non-empty fault schedule the candidate is still selected on
    the fault-free runs (the planner commits to a schedule before the fabric
    breaks), then the winner is re-run under the schedule; the returned time
    is the faulty one and ``info`` gains ``t_fault_free``, ``fault_overhead``,
    ``repair_latency``, ``retries`` and the full ``fault_report``."""
    cfg = resolve_config(config, max_sim_groups=max_sim_groups,
                         engine=engine, faults=faults)
    engine, faults = cfg.engine, cfg.faults
    max_sim_groups = cfg.max_sim_groups
    results = []
    for cand, m in plan.select(message_bytes):
        if num_groups is not None:
            m = num_groups
        total, res, delta = simulate_pipeline(
            plan.topo, plan.cm, cand.pipeline, message_bytes, m, plan.root,
            config=SimConfig(max_sim_groups=max_sim_groups, engine=engine,
                             cycle_hint=getattr(cand, "cycle", None)))
        results.append((total, cand, m, delta))
    total, cand, m, delta = min(results, key=lambda r: r[0])
    info = dict(num_groups=m, strategy=cand.name,
                K=len(cand.pipeline.trees), rounds=cand.pipeline.d,
                delta=delta, lp_C=plan.lp.C, a_hat=cand.a_hat,
                b_hat=cand.b_hat,
                t_opt=cand.t_opt(message_bytes, plan.L, plan.B))
    if faults:
        tf, resf, df = simulate_pipeline(
            plan.topo, plan.cm, cand.pipeline, message_bytes, m, plan.root,
            config=SimConfig(max_sim_groups=max_sim_groups, engine=engine,
                             faults=faults))
        info.update(t_fault_free=total, fault_overhead=tf - total,
                    repair_latency=resf.faults.repair_latency,
                    retries=resf.faults.retries,
                    fault_report=resf.faults)
        return tf, info
    return total, info
