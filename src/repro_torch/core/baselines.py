"""Baseline broadcast algorithms (paper §3.1) as dependent-task generators for
the event simulator.

  * binomial      — classic MPI binomial tree (whole message per hop).
  * flat          — root sends to everyone sequentially.
  * pipeline      — chain pipeline: Hamiltonian-ish chain, message split into
                    fixed segments streaming down the chain (MPICH pipeline).
  * srda          — scatter + recursive-doubling allgather (MPICH large-message
                    bcast; Thakur/Rabenseifner/Gropp 2005).
  * glf           — Global-Links-First (Dorier et al. 2016 / Xiang-Liu 2015):
                    coarse-to-fine hierarchical broadcast; BFS virtual ranks +
                    binomial on flat topologies.
  * bine          — binomial pattern over sign-alternating +/-2^s hops (an
                    approximation kept for backward compatibility).
  * bine_tree     — genuine Bine negabinary tree (De Sensi et al., arxiv
                    2508.17311): parent clears the most significant
                    negabinary digit, hops are exactly (-2)^j.
  * mpi_bcast     — MPICH-style dispatcher: binomial below 512 KiB, SRDA above.

All generators return SendTask lists (explicit deps; block ranges for partial
messages); the shared simulator engine (fast by default, the EventSimulator
oracle via ``engine="reference"``) charges identical network costs as BBS.
On the fast path the list is *lowered once* onto the compiled resource layer
(``lower_baseline`` -> ``repro.core.routing.CompiledTaskList``, memoized per
(algorithm, root, nbytes) and optionally persisted through the plan store),
so repeated simulations of one baseline pay only the event loop, not the
per-call task interning.

Routed sends — srda's recursive-doubling exchanges, glf/bine's virtual-rank
strides, the rank-order chain — address arbitrary endpoint pairs; on flat
fabrics their latency and cable sets come from the precompiled all-pairs
next-hop tables (``repro.core.routing``), an O(path-length) lookup per send
instead of a per-pair BFS.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import arborescence as arb
from repro_torch.core.intersection import ConflictModel
from repro_torch.core.routing import CompiledTaskList
from repro_torch.core.simconfig import SimConfig, UNSET, resolve_config
from repro_torch.core.simulator import (DEFAULT_ENGINE, EventSimulator, SendTask,
                                  SimResult, make_engine)
from repro_torch.core.topology import Edge, Topology


def _whole_message_tree(edges_in_send_order: Sequence[Tuple[int, int, Tuple]],
                        root: int, nbytes: float) -> List[SendTask]:
    """Tasks for a tree where each hop forwards the whole message once.
    `edges_in_send_order` items are (src, dst, priority)."""
    tasks: List[SendTask] = []
    deliver: Dict[int, int] = {}
    for (u, v, prio) in edges_in_send_order:
        deps = (deliver[u],) if u in deliver else ()
        assert u not in deliver or deliver[u] < len(tasks)
        if u != root and u not in deliver:
            raise AssertionError(f"sender {u} never receives the message")
        deliver[v] = len(tasks)
        tasks.append(SendTask(priority=prio, src=u, dst=v, nbytes=nbytes,
                              deps=deps, blk=(0, 1)))
    return tasks


def _binomial_sends(n: int) -> List[Tuple[int, int, int]]:
    """(virtual src, virtual dst, level) for a binomial tree over ranks 0..n-1
    in send order (root first, high strides first)."""
    out = []
    for v in range(1, n):
        p = v - (1 << (v.bit_length() - 1))
        out.append((p, v, v.bit_length()))
    out.sort(key=lambda x: (x[2], x[0]))
    return out


def binomial_tasks(topo: Topology, root: int, nbytes: float) -> List[SendTask]:
    n = topo.num_nodes
    sends = [((root + u) % n, (root + v) % n, (lvl, u))
             for (u, v, lvl) in _binomial_sends(n)]
    return _whole_message_tree(sends, root, nbytes)


def flat_tasks(topo: Topology, root: int, nbytes: float) -> List[SendTask]:
    return [SendTask(priority=(0, i), src=root, dst=v, nbytes=nbytes,
                     deps=(), blk=(0, 1))
            for i, v in enumerate(topo.compute_nodes) if v != root]


def chain_pipeline_tasks(topo: Topology, root: int, nbytes: float,
                         packets: Optional[int] = None,
                         max_packets: int = 384) -> List[SendTask]:
    """Pipelined chain broadcast (MPICH "pipeline"), 64 KiB segments.

    Topology-oblivious, as in the paper: the chain follows *rank order*
    (root, root+1, ..., root+n-1 mod n); non-adjacent hops get routed by the
    fabric and contend with other chain segments."""
    if packets is None:
        packets = max(1, int(math.ceil(nbytes / (64 * 1024))))
        packets = min(packets, max_packets)
    n = topo.num_nodes
    order = [(root + i) % n for i in range(n)]
    tree = arb.chain_arborescence(topo, root, order=order)
    depths = tree.depths()
    seg = nbytes / packets
    tasks: List[SendTask] = []
    deliver: Dict[Tuple[int, int], int] = {}
    edges = sorted(tree.edges, key=lambda e: depths[e[1]])
    for p in range(packets):
        for (u, v) in edges:
            deps = (deliver[(u, p)],) if (u, p) in deliver else ()
            deliver[(v, p)] = len(tasks)
            tasks.append(SendTask(priority=(p, depths[v]), src=u, dst=v,
                                  nbytes=seg, deps=deps, blk=(p, p + 1),
                                  group=p))
    return tasks


def srda_tasks(topo: Topology, root: int, nbytes: float) -> List[SendTask]:
    """Scatter (binomial) + allgather (recursive doubling when n is a power of
    two, ring otherwise). Blocks stay aligned ranges throughout."""
    n = topo.num_nodes
    block = nbytes / n

    def vr(r: int) -> int:
        return (root + r) % n

    tasks: List[SendTask] = []
    # (rank, blk_lo) -> idx of task delivering rank's current range; root holds all
    recv_of: Dict[int, Optional[int]] = {0: None}

    def scatter(lo: int, hi: int, depth: int) -> None:
        if hi - lo <= 1:
            return
        mid = (lo + hi + 1) // 2
        dep = recv_of[lo]
        idx = len(tasks)
        tasks.append(SendTask(priority=(0, depth, lo), src=vr(lo), dst=vr(mid),
                              nbytes=(hi - mid) * block,
                              deps=(dep,) if dep is not None else (),
                              blk=(mid, hi)))
        recv_of[mid] = idx
        scatter(lo, mid, depth + 1)
        scatter(mid, hi, depth + 1)

    scatter(0, n, 0)
    last_recv: Dict[int, Optional[int]] = dict(recv_of)

    if n & (n - 1) == 0:
        # recursive doubling: step s, rank r exchanges its aligned 2^s-range
        # with r ^ 2^s
        steps = int(math.log2(n))
        for s in range(steps):
            stride = 1 << s
            new_last: Dict[int, Optional[int]] = {}
            sends: Dict[int, int] = {}
            for r in range(n):
                lo = (r >> s) << s
                peer = r ^ stride
                dep = last_recv.get(r)
                idx = len(tasks)
                tasks.append(SendTask(priority=(1 + s, r), src=vr(r),
                                      dst=vr(peer), nbytes=stride * block,
                                      deps=(dep,) if dep is not None else (),
                                      blk=(lo, lo + stride)))
                sends[peer] = idx
            for r in range(n):
                new_last[r] = sends[r]
            last_recv = new_last
    else:
        # ring allgather: n-1 steps, pass your newest range to the right
        for t in range(n - 1):
            new_last: Dict[int, Optional[int]] = {}
            for r in range(n):
                b = (r - t) % n
                dep = last_recv.get(r)
                idx = len(tasks)
                tasks.append(SendTask(priority=(1 + t, r), src=vr(r),
                                      dst=vr((r + 1) % n), nbytes=block,
                                      deps=(dep,) if dep is not None else (),
                                      blk=(b, b + 1)))
                new_last[(r + 1) % n] = idx
            last_recv = new_last
    return tasks


def glf_tasks(topo: Topology, root: int, nbytes: float) -> List[SendTask]:
    """Global-Links-First: coarse-to-fine hierarchical broadcast; BFS virtual
    ranks + binomial on flat fabrics."""
    if not topo.hierarchical:
        order = _bfs_order(topo, root)
        sends = [(order[u], order[v], (lvl, u))
                 for (u, v, lvl) in _binomial_sends(topo.num_nodes)]
        return _whole_message_tree(sends, root, nbytes)

    node_router = topo.node_router  # type: ignore[attr-defined]
    routers: Dict[str, List[int]] = {}
    for v in topo.compute_nodes:
        routers.setdefault(node_router[v], []).append(v)

    def group_of(r: str) -> str:
        return r.split("r")[0] if "r" in r and r.startswith("g") else "all"

    groups: Dict[str, List[str]] = {}
    for r in sorted(routers):
        groups.setdefault(group_of(r), []).append(r)

    rtr_rep = {r: min(vs) for r, vs in routers.items()}
    grp_rep = {g: min(rtr_rep[r] for r in rs) for g, rs in groups.items()}
    my_r, my_g = node_router[root], group_of(node_router[root])
    rtr_rep[my_r] = root
    grp_rep[my_g] = root

    sends: List[Tuple[int, int, Tuple]] = []

    def binomial_over(nodes: List[int], src: int, level: int) -> None:
        ns = [src] + sorted(v for v in set(nodes) if v != src)
        for (u, v, lvl) in _binomial_sends(len(ns)):
            sends.append((ns[u], ns[v], (level, lvl, u)))

    binomial_over(list(grp_rep.values()), root, 0)          # global links first
    for g, rs in groups.items():
        binomial_over([rtr_rep[r] for r in rs], grp_rep[g], 1)
    for r, vs in routers.items():
        binomial_over(vs, rtr_rep[r], 2)
    return _whole_message_tree(sends, root, nbytes)


def bine_tasks(topo: Topology, root: int, nbytes: float) -> List[SendTask]:
    """Binomial negabinary (Bine) broadcast: binomial pattern with +/-2^s hops
    (sign alternating per step), improving distance locality. Falls back to
    direct binomial strides for ranks missed by wrap collisions (only possible
    for non-power-of-two n)."""
    n = topo.num_nodes
    sends: List[Tuple[int, int, Tuple]] = []
    steps = max(1, int(math.ceil(math.log2(max(n, 2)))))
    holders = [0]
    have = {0}
    for s in reversed(range(steps)):
        stride = 1 << s
        sign = 1 if ((steps - 1 - s) % 2 == 0) else -1
        for r in list(holders):
            dst = (r + sign * stride) % n
            if dst not in have:
                sends.append((r, dst, (steps - s, r)))
                have.add(dst)
                holders.append(dst)
    missing = [r for r in range(n) if r not in have]
    for i, r in enumerate(missing):
        src = holders[i % len(holders)]
        sends.append((src, r, (steps + 1, i)))
    vsends = [((root + u) % n, (root + v) % n, p) for (u, v, p) in sends]
    return _whole_message_tree(vsends, root, nbytes)


def _negabinary_digits(r: int, k: int) -> List[int]:
    """The unique d in {0,1}^k with r == sum d_i * (-2)^i  (mod 2^k).

    The map d -> sum d_i (-2)^i mod 2^k is a bijection: (-2)^i has 2^i as
    its lowest set bit, so the system is triangular mod 2 — digit i is
    forced by bit i of the residue after the lower digits are subtracted."""
    digits = []
    x = r % (1 << k)
    for i in range(k):
        d = (x >> i) & 1
        digits.append(d)
        if d:
            x = (x - (-2) ** i) % (1 << k)
    return digits


def bine_tree_tasks(topo: Topology, root: int,
                    nbytes: float) -> List[SendTask]:
    """Genuine Bine (binomial negabinary) broadcast tree (De Sensi et al.,
    arxiv 2508.17311).

    Every virtual rank r in [1, 2^k) has a unique negabinary digit vector
    (:func:`_negabinary_digits`); its parent clears the most significant
    digit, so the hop distance is exactly (-2)^j — strides alternate sign
    with the digit position, which splits traffic between both ring
    directions (classic binomial walks one way only) and halves the worst
    hop distance on rings/tori with per-direction channels. Same send
    count and depth as binomial: k steps, one new rank per holder per step.

    Non-power-of-two n: the negabinary tree covers the largest 2^k <= n;
    each remaining rank r in [n2, n) receives from r - n2 in one extra
    step (the standard binomial-family remainder fold)."""
    n = topo.num_nodes
    n2 = 1 << (n.bit_length() - 1)      # largest power of two <= n
    k = n2.bit_length() - 1
    sends: List[Tuple[int, int, Tuple]] = []
    for r in range(1, n2):
        digits = _negabinary_digits(r, k)
        j = max(i for i, d in enumerate(digits) if d)
        parent = (r - (-2) ** j) % n2
        sends.append((parent, r, (j + 1, parent)))
    for r in range(n2, n):
        sends.append((r - n2, r, (k + 1, r - n2)))
    # parents always carry a strictly smaller most-significant digit, so
    # level order is causal: a rank is delivered before it sends
    sends.sort(key=lambda x: x[2])
    vsends = [((root + u) % n, (root + v) % n, p) for (u, v, p) in sends]
    return _whole_message_tree(vsends, root, nbytes)


def mpi_bcast_tasks(topo: Topology, root: int, nbytes: float) -> List[SendTask]:
    """MPICH dispatch: binomial below 512 KiB, scatter-allgather above."""
    if nbytes < 512 * 1024:
        return binomial_tasks(topo, root, nbytes)
    return srda_tasks(topo, root, nbytes)


def _bfs_order(topo: Topology, root: int) -> List[int]:
    seen = {root}
    order = [root]
    frontier = [root]
    while frontier:
        nxt = []
        for v in frontier:
            for w in topo.neighbors(v):
                if w not in seen:
                    seen.add(w)
                    order.append(w)
                    nxt.append(w)
        frontier = nxt
    assert len(order) == topo.num_nodes
    return order


BASELINES = {
    "binomial": binomial_tasks,
    "flat": flat_tasks,
    "pipeline": chain_pipeline_tasks,
    "srda": srda_tasks,
    "glf": glf_tasks,
    "bine": bine_tasks,
    "bine_tree": bine_tree_tasks,
    "mpi_bcast": mpi_bcast_tasks,
}


def lower_baseline(topo: Topology, cm: ConflictModel, name: str, root: int,
                   nbytes: float, store=None) -> CompiledTaskList:
    """The lowered task list for baseline ``name`` at ``(root, nbytes)``,
    memoized per compiled model.

    First call generates the ``SendTask`` list and lowers it
    (``repro.core.routing.CompiledTaskList``); repeats hit the in-process
    memo on ``cm.compiled()``. With ``store`` (a
    ``repro_torch.core.planstore.PlanStore``) the structural lowering also
    round-trips through a content-addressed on-disk artifact keyed by
    (topology fingerprint, mode, algorithm, root, nbytes), so other
    processes skip both generation and lowering (dense resource ids rebind
    per process — see ``CompiledTaskList.bind``)."""
    ct = cm.compiled()
    key = (name, root, float(nbytes))
    ctl = ct.lowered_cache.get(key)
    if store is not None:
        # always consult the store so the artifact lands on disk even when
        # this process already lowered the list (the memoized lowering is
        # handed over as the build shortcut)
        ctl = store.get_or_lower_baseline(topo, cm, name, root, nbytes,
                                          lowered=ctl)
    elif ctl is None:
        ctl = ct.lower_tasks(BASELINES[name](topo, root, nbytes))
    ctl.bind(ct)
    ct.lowered_cache[key] = ctl
    return ctl


def simulate_baseline(topo: Topology, cm: ConflictModel, name: str, root: int,
                      nbytes: float, engine=UNSET,
                      store=None,
                      max_sim_segments=UNSET,
                      faults=UNSET, *,
                      config: Optional[SimConfig] = None) -> SimResult:
    """Simulate baseline ``name`` broadcasting ``nbytes`` from ``root``.

    Simulation options come from ``config=SimConfig(...)``; the legacy
    ``engine=`` / ``max_sim_segments=`` / ``faults=`` kwargs still work
    through the deprecation shim (bit-identical, one warning per process).

    The engine selects the execution path: ``"fast"`` (default) runs the
    lowered task list through ``CompiledSim.run_lowered`` — the lowering is
    memoized per (algorithm, root, nbytes) on the compiled model (and
    optionally persisted via ``store``), so repeated calls pay only the
    event loop; ``"kernel"`` runs the same lowered list through the event
    core (``repro_torch.core.kernelsim``) on the config's device
    (``config.device.device``, cuda when the config has no device block;
    cuda on a host without a GPU raises); ``"reference"`` runs the
    ``EventSimulator`` oracle on a freshly generated task list. All produce
    bit-identical results (asserted in tests/test_engine_equiv.py and
    tests/test_torch_kernelsim.py).

    ``max_sim_segments`` (fast engine only) enables the segment-analytic
    path of ``CompiledSim.run_task_list`` for fold-eligible lists: exact
    verified-cycle results or a complete simulation, never an estimate.

    A non-empty ``faults`` schedule (``repro.core.faults.FaultSchedule``)
    bypasses the lowered/folded artifacts — they bake in a static fabric —
    and runs the raw task list through the engine's fault loop; the result
    carries degradation metrics in ``SimResult.faults``.
    """
    cfg = resolve_config(config, engine=engine,
                         max_sim_segments=max_sim_segments, faults=faults)
    engine, faults = cfg.engine, cfg.faults
    max_sim_segments = cfg.max_sim_segments
    sim = make_engine(topo, cm, root, engine=engine,
                      device=cfg.device.device if cfg.device else "cuda")
    if faults:
        tasks = BASELINES[name](topo, root, nbytes)
        return sim.run(tasks, total_blocks=max(t.blk[1] for t in tasks),
                       faults=faults)
    if engine in ("fast", "kernel"):
        ctl = lower_baseline(topo, cm, name, root, nbytes, store=store)
        if max_sim_segments is not None:
            return sim.run_task_list(lowered=ctl,
                                     max_sim_segments=max_sim_segments).res
        return sim.run_lowered(ctl)
    tasks = BASELINES[name](topo, root, nbytes)
    return sim.run(tasks, total_blocks=max(t.blk[1] for t in tasks))
