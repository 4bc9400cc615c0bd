"""Compiled-topology routing layer: one-shot precomputation per fabric.

The paper's "low storage / build offline" property (§2.6) treats topology
structure as a deterministic, cheap-to-store artifact. This module is where
that structure gets compiled — once per topology — instead of being recomputed
all over the stack:

  * ``NextHopTable`` — all-pairs next-hop routing for flat fabrics. One BFS
    per source builds a dense predecessor matrix; ``path(i, j)`` is then an
    O(path-length) parent walk with *exactly* the tie-breaking of the previous
    per-pair BFS (sorted adjacency, first-discovery wins), so routed transfers
    keep bit-identical costs and link sets. This replaces the
    ``FlatTopology._path`` 200k-entry ``lru_cache`` hot spot.
  * ``CompiledTopology`` — the per-(topology, conflict-mode) compiled view
    consumed by both simulator engines, the routed baselines and the
    scheduling/coloring layers: dense integer interning of every conflict
    resource (capacities in a flat list), per-edge resource-id tuples, and
    per-edge Hockney constants (latency, bandwidth). Candidate edges are
    compiled eagerly in one shot; routed non-candidate pairs (baselines use
    arbitrary endpoint pairs) are interned on first use through the same
    tables. This absorbs the former ``repro.core.intersection.ResourceIndex``.
  * ``CompiledTemplate`` — one pipeline group's task template
    (``Pipeline.flat_tasks()``) lowered once onto the compiled resource layer:
    per-task resource-id CSR, intra-group dependency CSR (children lists),
    admission ranks, and the per-task Hockney constants as numpy vectors so
    per-packet durations are one vectorized expression. The flat-array engine
    (``repro.core.fastsim``) replays any number of pipeline groups straight
    from this template — task ``g*T + t`` is template task ``t`` of group
    ``g`` — without materializing per-group Python task objects.
  * ``CompiledTaskList`` — an *arbitrary* ``SendTask`` list (the routed
    baselines: srda/glf/bine/binomial/chain) lowered once the same way:
    admission ranks from the priority sort, per-task resource-id CSR,
    dependency/children CSR, precomputed Hockney durations, and — for lists
    whose tail repeats a per-segment pattern (chain pipeline packets, srda's
    ring-allgather rounds) — a detected ``SegmentInfo`` that, when the fold
    eligibility rules hold, lets the engine execute the list as ``q``
    instances of one segment template exactly like pipeline groups. The
    lowering is reusable across runs and (stripped of its process-local dense
    resource ids) picklable as a plan-store artifact.
  * ``topology_fingerprint`` — a stable content hash of the fabric (nodes,
    cables/candidate edges, per-edge Hockney constants, router attachment).
    ``repro.core.planstore`` keys plan artifacts by it so a plan can never be
    silently replayed against a drifted topology.

Build cost is one BFS sweep + one pass over candidate edges; everything else
is table lookups.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import (TYPE_CHECKING, Dict, FrozenSet, List, Optional, Sequence,
                    Tuple)

import numpy as np

if TYPE_CHECKING:   # import cycle: topology/intersection import this module
    from repro_torch.core.intersection import ConflictModel
    from repro_torch.core.schedule import FlatTasks
    from repro_torch.core.simulator import SendTask
    from repro_torch.core.topology import Edge, Topology

Resource = Tuple


class Unreachable(Exception):
    """Routing was asked for a pair the (possibly degraded) graph does not
    connect. Raised by ``NextHopTable.path``/``next_hop``/``hops`` instead of
    leaking the raw ``-1`` matrix sentinels — load-bearing once fault
    injection (``repro.core.faults``) can partition a fabric mid-run."""

    def __init__(self, src: int, dst: int):
        super().__init__(f"no route {src} -> {dst}")
        self.src = src
        self.dst = dst


class NextHopTable:
    """All-pairs shortest-path routing table for a flat fabric.

    Built with one full BFS per source over the (sorted) adjacency lists.
    ``parent[i, w]`` is the predecessor of ``w`` on the BFS tree rooted at
    ``i``; ``dist[i, w]`` the hop count. Because a full BFS assigns the same
    predecessors as an early-stopping BFS for every node it discovers, the
    reconstructed ``path(i, j)`` is identical to the historical per-pair BFS
    (deterministic first-discovery tie-break over sorted neighbors).
    """

    __slots__ = ("n", "parent", "dist")

    def __init__(self, n: int, adj: Dict[int, List[int]]):
        self.n = n
        parent = np.full((n, n), -1, dtype=np.int32)
        dist = np.full((n, n), -1, dtype=np.int32)
        for i in range(n):
            prev = parent[i]
            dd = dist[i]
            dd[i] = 0
            seen = bytearray(n)
            seen[i] = 1
            frontier = [i]
            d = 0
            while frontier:
                d += 1
                nxt = []
                for v in frontier:
                    for w in adj[v]:
                        if not seen[w]:
                            seen[w] = 1
                            prev[w] = v
                            dd[w] = d
                            nxt.append(w)
                frontier = nxt
        self.parent = parent
        self.dist = dist

    def hops(self, i: int, j: int) -> int:
        """Shortest hop count i -> j (0 for i == j).

        Raises ``Unreachable`` on a disconnected pair; the raw ``dist``
        matrix keeps ``-1`` there for vectorized consumers (the fault-repair
        planner scans it directly)."""
        d = int(self.dist[i, j])
        if d < 0:
            raise Unreachable(i, j)
        return d

    def reachable(self, i: int, j: int) -> bool:
        """Whether a path i -> j exists (always true for i == j)."""
        return bool(self.dist[i, j] >= 0)

    def next_hop(self, i: int, j: int) -> int:
        """First node after ``i`` on the shortest path i -> j.

        Raises ``Unreachable`` on a disconnected pair."""
        path = self.path(i, j)
        return path[1] if len(path) > 1 else j

    def path(self, i: int, j: int) -> Tuple[int, ...]:
        """Node path i -> j, reconstructed by an O(length) parent walk.

        Raises ``Unreachable`` on a disconnected pair."""
        if i == j:
            return (i,)
        prev = self.parent[i]
        out = [j]
        v = j
        while v != i:
            v = int(prev[v])
            if v < 0:
                raise Unreachable(i, j)
            out.append(v)
        return tuple(reversed(out))


def topology_fingerprint(topo: "Topology") -> str:
    """Stable content hash of a fabric's structure and Hockney constants.

    Covers: class, name, node count, the full cable set (flat fabrics — it
    governs routing of non-candidate pairs), router attachment (hierarchical
    fabrics), and per-candidate-edge (latency, bandwidth, link set). Plan
    artifacts keyed by this hash are invalidated by any topology change that
    could alter schedules or costs; pure code changes are covered separately
    by the plan-store schema version.
    """
    h = hashlib.sha256()

    def put(obj) -> None:
        h.update(repr(obj).encode())
        h.update(b"\x00")

    put((type(topo).__name__, topo.name, topo.num_nodes, topo.hierarchical))
    cables = getattr(topo, "_edges", None)
    if cables is not None:
        put(tuple(cables))
        put(bool(getattr(topo, "_shared", True)))
    node_router = getattr(topo, "node_router", None)
    if node_router is not None:
        put(tuple(sorted(node_router.items())))
    for e in topo.candidate_edges:
        put((e, topo.latency(e), topo.bandwidth(e), topo.links(e)))
    return h.hexdigest()[:32]


class CompiledTopology:
    """Compiled per-(topology, mode) routing + resource layer.

    One-shot precomputation shared by every consumer of a
    ``ConflictModel`` — the reference and flat-array simulator engines, the
    coloring/scheduling layer, ``delta_star`` and the routed baselines:

      * every conflict resource interned to a dense integer id (capacities in
        ``caps``, a flat list indexed by id);
      * per-edge resource tuples / id tuples / capacity-1 id sets;
      * per-edge Hockney constants via ``edge_cost``.

    Candidate edges are compiled eagerly; arbitrary routed pairs (baselines
    may send between any endpoints) fall into the same tables on first use.
    Obtain instances via ``ConflictModel.compiled()`` (cached per model).
    """

    __slots__ = ("cm", "topo", "mode", "caps", "_ids", "_edge_res",
                 "_edge_ids", "_edge_unit_ids", "_edge_cost", "_fingerprint",
                 "lowered_cache")

    def __init__(self, cm: "ConflictModel"):
        self.cm = cm
        self.topo = cm.topo
        self.mode = cm.mode
        self.caps: List[int] = []                       # capacity by id
        self._ids: Dict[Resource, int] = {}
        self._edge_res: Dict["Edge", Tuple[Resource, ...]] = {}
        self._edge_ids: Dict["Edge", Tuple[int, ...]] = {}
        self._edge_unit_ids: Dict["Edge", FrozenSet[int]] = {}
        self._edge_cost: Dict["Edge", Tuple[float, float]] = {}
        self._fingerprint: Optional[str] = None
        # process-local memo for lowered task lists (baselines key it by
        # (algorithm, root, nbytes) — see repro.core.baselines.lower_baseline)
        self.lowered_cache: Dict = {}
        for e in self.topo.candidate_edges:             # one-shot compile
            self.edge_ids(e)
            self.edge_cost(e)

    # -- routing -------------------------------------------------------------

    def path(self, i: int, j: int) -> Tuple[int, ...]:
        """Routed node path i -> j. Flat fabrics: next-hop table walk;
        hierarchical fabrics route through the NIC/trunk layer, so the
        endpoint-level path is the direct pair."""
        table = getattr(self.topo, "next_hop_table", None)
        if table is not None:
            return table().path(i, j)
        return (i, j)

    def hops(self, i: int, j: int) -> int:
        table = getattr(self.topo, "next_hop_table", None)
        if table is not None:
            return table().hops(i, j)
        return 0 if i == j else 1

    def links(self, e: "Edge") -> Tuple[str, ...]:
        return self.topo.links(e)

    def fingerprint(self) -> str:
        """Topology content hash (mode-independent; see PlanKey for mode)."""
        fp = self._fingerprint
        if fp is None:
            fp = self._fingerprint = topology_fingerprint(self.topo)
        return fp

    # -- resource interning ----------------------------------------------------

    def intern(self, r: Resource) -> int:
        rid = self._ids.get(r)
        if rid is None:
            rid = self._ids[r] = len(self._ids)
            self.caps.append(self.cm.capacity(r))
        return rid

    def num_resources(self) -> int:
        return len(self.caps)

    def resources(self, e: "Edge") -> Tuple[Resource, ...]:
        rs = self._edge_res.get(e)
        if rs is None:
            rs = self._edge_res[e] = self.cm.resources(e)
        return rs

    def edge_ids(self, e: "Edge") -> Tuple[int, ...]:
        ids = self._edge_ids.get(e)
        if ids is None:
            ids = self._edge_ids[e] = tuple(
                self.intern(r) for r in self.resources(e))
        return ids

    def edge_unit_ids(self, e: "Edge") -> FrozenSet[int]:
        """Ids of e's capacity-1 resources (the ones that can pairwise
        conflict; capacity > 1 trunks admit concurrent transfers)."""
        ids = self._edge_unit_ids.get(e)
        if ids is None:
            ids = self._edge_unit_ids[e] = frozenset(
                rid for rid in self.edge_ids(e) if self.caps[rid] == 1)
        return ids

    # -- Hockney constants -----------------------------------------------------

    def edge_cost(self, e: "Edge") -> Tuple[float, float]:
        """(latency, bandwidth) of e, precomputed for candidate edges and
        cached for routed pairs."""
        c = self._edge_cost.get(e)
        if c is None:
            topo = self.topo
            c = self._edge_cost[e] = (topo.latency(e), topo.bandwidth(e))
        return c

    def duration(self, e: "Edge", nbytes: float) -> float:
        lat, bw = self.edge_cost(e)
        return lat + nbytes / bw

    # -- template lowering -----------------------------------------------------

    def lower_template(self, ft: "FlatTasks") -> "CompiledTemplate":
        """Lower one pipeline group's flat-task template onto this compiled
        resource layer (see ``CompiledTemplate``). Pure tables; the result is
        reusable for any packet size and any number of groups."""
        return CompiledTemplate(self, ft)

    def lower_tasks(self, tasks: Sequence["SendTask"],
                    total_blocks: Optional[int] = None,
                    detect_segments: bool = True) -> "CompiledTaskList":
        """Lower an arbitrary ``SendTask`` list onto this compiled resource
        layer (see ``CompiledTaskList``). One-shot per list; the result is
        reusable across any number of runs and engines sharing this model.
        ``detect_segments=False`` skips the segment-periodicity scan — the
        right call for lowerings that are used once and thrown away, where
        the scan cost cannot amortize and folding never pays off."""
        return CompiledTaskList(self, tasks, total_blocks,
                                detect_segments=detect_segments)

    def occupancy(self) -> "Occupancy":
        """A fresh shared-occupancy state over this compiled resource table
        (see ``Occupancy``) — the per-run busy/wait vectors a multi-instance
        event loop charges every concurrently executing lowered task list
        through."""
        return Occupancy(self)


class Occupancy:
    """Shared resource-occupancy state for concurrent lowered executions.

    One broadcast per run, the engines keep their busy/wait vectors as loop
    locals; a multi-instance loop (``CompiledSim.run_jobs``) instead charges
    *every* concurrently executing lowered task list through one of these, so
    jobs contend per resource exactly as tasks of a single run do:

      * ``busy`` — slots in use per dense resource id;
      * ``wait`` — per-resource wake queue of blocked global task keys (None
        when empty, the engines' representation).

    ``grow()`` re-sizes both after interning added resources (fault repair
    hops route over edges no lowered list touched).
    """

    __slots__ = ("ct", "busy", "wait")

    def __init__(self, ct: CompiledTopology):
        self.ct = ct
        self.busy: List[int] = [0] * ct.num_resources()
        self.wait: List[Optional[list]] = [None] * ct.num_resources()

    def grow(self) -> None:
        extra = self.ct.num_resources() - len(self.busy)
        if extra > 0:
            self.busy.extend([0] * extra)
            self.wait.extend([None] * extra)


class CompiledTemplate:
    """One pipeline group lowered to flat arrays on a ``CompiledTopology``.

    The batched engine expands ``m`` groups of this template arithmetically —
    task ``i`` is template task ``i % T`` of group ``i // T`` — so the per-run
    setup is O(T), not O(m*T) Python object work:

      * ``res_ids`` — per-task dense resource-id tuples (scalar admission
        path) plus the same ids in CSR form (``res_indptr``/``res_flat``,
        numpy) for vectorized occupancy counting over a whole frontier;
      * ``dep``/``children``/``dep_n`` — the intra-group dependency CSR
        (``pipeline_tasks`` never links across groups: later groups couple
        only through resources);
      * ``rank`` — the admission priority of each template task inside its
        group (global rank of task ``g*T + t`` is ``g*T + rank[t]``),
        matching the reference engine's (group, round, depth) sort exactly;
      * ``lat``/``bw`` — per-task Hockney constants, so
        ``durations(packet_bytes)`` is one vectorized expression with the
        exact IEEE semantics of the scalar reference (``lat + nbytes / bw``).

    Holds no reference back to the ``CompiledTopology`` it was lowered on:
    resource interning is deterministic (candidate edges one-shot, then
    first-use order), so a template pickled inside a plan artifact stays
    valid against the compiled layer rebuilt after load.

    __slots__ + plain arrays keep it compact and picklable.
    """

    __slots__ = ("T", "src", "dst", "tree", "rank", "order",
                 "res_ids", "res_indptr", "res_flat", "dep", "dep_n",
                 "children", "lat", "bw")

    def __init__(self, ct: CompiledTopology, ft: "FlatTasks"):
        T = self.T = len(ft)
        self.src = list(ft.src)
        self.dst = list(ft.dst)
        self.tree = list(ft.tree)
        # reference admission order: (round, depth) stable sort == the
        # (group, round, depth) priority of simulator.pipeline_tasks per group
        order = sorted(range(T), key=lambda i: (ft.round_ix[i], ft.depth[i]))
        self.order = order
        rank = [0] * T
        for pos, t in enumerate(order):
            rank[t] = pos
        self.rank = rank
        routes = getattr(ft, "route", None)
        if routes is None:
            self.res_ids = [ct.edge_ids((u, v))
                            for u, v in zip(ft.src, ft.dst)]
        else:
            # pinned per-task routes (relabeled plans): resolve resources
            # from the override links; interning stays on the shared tables
            # but the Edge-keyed caches are left untouched
            self.res_ids = [
                ct.edge_ids((u, v)) if rt is None else
                tuple(ct.intern(r)
                      for r in ct.cm.resources((u, v), links=rt[0]))
                for u, v, rt in zip(ft.src, ft.dst, routes)]
        indptr = np.zeros(T + 1, dtype=np.int64)
        for i, ids in enumerate(self.res_ids):
            indptr[i + 1] = indptr[i] + len(ids)
        self.res_indptr = indptr
        self.res_flat = np.fromiter(
            (r for ids in self.res_ids for r in ids), dtype=np.int64,
            count=int(indptr[-1]))
        self.dep = list(ft.dep)
        dep_n = [0] * T
        children: List[List[int]] = [[] for _ in range(T)]
        for i, d in enumerate(self.dep):
            if d >= 0:
                dep_n[i] = 1
                children[d].append(i)
        self.dep_n = dep_n
        self.children = [tuple(c) for c in children]
        lat = np.empty(T)
        bw = np.empty(T)
        for i, (u, v) in enumerate(zip(ft.src, ft.dst)):
            rt = routes[i] if routes is not None else None
            if rt is None:
                lat[i], bw[i] = ct.edge_cost((u, v))
            else:
                lat[i], bw[i] = rt[1], rt[2]
        self.lat = lat
        self.bw = bw

    def __len__(self) -> int:
        return self.T

    def durations(self, packet_bytes) -> List[float]:
        """Per-task Hockney durations for one group at the given per-tree
        packet sizes (same IEEE expression as the reference engine:
        ``lat + nbytes / bw``)."""
        nbytes = np.asarray([packet_bytes[k] for k in self.tree])
        return (self.lat + nbytes / self.bw).tolist()

    def nbytes(self, packet_bytes) -> List[float]:
        return [packet_bytes[k] for k in self.tree]


@dataclasses.dataclass(frozen=True)
class SegmentInfo:
    """Detected segment periodicity of a lowered task list.

    The trailing ``q`` runs of ``seg_len`` tasks each repeat one structural
    pattern (same src/dst/nbytes/block-span per position, dependencies at the
    same relative offsets); ``prefix`` tasks precede them. ``foldable`` marks
    lists the engine may execute through the folded instance core — one live
    instance per segment-template position plus the prefix tasks as scalar
    participants. It requires, beyond periodicity: prefix dependencies
    confined to the prefix, at most one dependency per segment position,
    dependencies reaching back at most one segment (intra-segment or
    prev-segment — srda's ring allgather chains each step to the previous
    one), and segment-major admission ranks
    (``rank[prefix+T:] == rank[prefix:n-T] + T``, so instance ``s+1`` of a
    position always ranks after instance ``s``). ``pure`` marks the strict
    subclass the segment-template fold and the occupancy-cycle analytics
    accept: additionally no prefix, intra-segment dependencies only,
    per-segment group tags, and deliveries that are globally fresh — every
    (node, block) pair delivered at most once, each task carrying >= 1
    block. ``cover_bad`` lists nodes whose deliveries do not span all blocks
    (the pure template fold is valid only when the broadcast root is the
    sole such node); ``reason`` names the first failed fold rule for
    diagnostics.
    """

    prefix: int
    seg_len: int
    q: int
    foldable: bool
    pure: bool = False
    cover_bad: FrozenSet[int] = frozenset()
    reason: str = ""


class CompiledTaskList:
    """An arbitrary ``SendTask`` list lowered to flat arrays on a
    ``CompiledTopology``.

    The generic engine path (``repro.core.fastsim.CompiledSim.run``) used to
    re-derive all of this per call — priority sort, resource interning,
    Hockney durations, dependency fan-out — which left the routed baselines
    setup-bound. Lowering happens once per list:

      * ``rank`` — the admission priority permutation (stable sort
        over ``SendTask.priority``, exactly the reference engine's order);
      * ``res_ids`` + CSR (``res_indptr``/``res_flat``) — per-task dense
        resource ids for scalar admission and vectorized whole-frontier
        occupancy counting;
      * ``durs``/``nbytes`` — per-task Hockney durations with the scalar
        reference's IEEE expression (``lat + nbytes / bw``);
      * ``dep_n``/``children`` — the dependency CSR;
      * ``blks``/``grps``/``total_blocks`` — block coverage and pipeline
        group tags;
      * ``seg`` — segment periodicity (``SegmentInfo``) detected from the
        leading priority component; fold-eligible lists execute through a
        folded instance core — the pure subclass (no prefix, intra-segment
        deps, fresh deliveries) through the same template core as pipeline
        groups, the extended class (prefix region, prev-segment dependency
        chains — srda's ring allgather) through the folded-list loop.

    Dense resource ids are *process-local* (routed non-candidate pairs intern
    in first-use order), so pickling strips them (``__getstate__``) and
    ``bind()`` re-derives them against the current compiled layer — the
    stable structural work (sorting, dependency fan-out, durations, segment
    detection) is what an artifact saves.
    """

    __slots__ = ("n", "total_blocks", "num_nodes", "rank", "src",
                 "dst", "nbytes", "durs", "blks", "spans", "all_fresh",
                 "cover_bad", "grps", "has_groups", "deps", "dep_n",
                 "children", "seg", "routes", "res_ids", "res_indptr",
                 "res_flat", "_tpl")

    def __init__(self, ct: CompiledTopology, tasks: Sequence["SendTask"],
                 total_blocks: Optional[int] = None,
                 detect_segments: bool = True):
        self.num_nodes = ct.topo.num_nodes
        n = self.n = len(tasks)
        order = sorted(range(n), key=lambda i: tasks[i].priority)
        rank = [0] * n
        for pos, i in enumerate(order):
            rank[i] = pos
        self.rank = rank
        if total_blocks is None:
            total_blocks = max((t.blk[1] for t in tasks), default=1)
        self.total_blocks = total_blocks

        src: List[int] = []
        dst: List[int] = []
        nbytes: List[float] = []
        durs: List[float] = []
        blks: List[Tuple[int, int]] = []
        grps: List[Optional[int]] = []
        deps: List[Tuple[int, ...]] = []
        routes: List = []
        ecache: Dict["Edge", Tuple[float, float]] = {}
        for t in tasks:
            e = (t.src, t.dst)
            rt = getattr(t, "route", None)
            if rt is not None:
                lat, bw = rt[1], rt[2]
            else:
                ent = ecache.get(e)
                if ent is None:
                    ent = ecache[e] = ct.edge_cost(e)
                lat, bw = ent
            src.append(t.src)
            dst.append(t.dst)
            nbytes.append(t.nbytes)
            durs.append(lat + t.nbytes / bw)
            blks.append(t.blk)
            grps.append(t.group)
            deps.append(tuple(t.deps))
            routes.append(rt)
        # structural per-task route overrides (None for the common case);
        # persisted with the lowering so bind() re-derives matching ids
        self.routes = routes if any(r is not None for r in routes) else None
        self.src = src
        self.dst = dst
        self.nbytes = nbytes
        self.durs = durs
        self.blks = blks
        self.grps = grps
        self.has_groups = n > 0 and all(g is not None for g in grps)
        self.deps = deps
        self.dep_n = [len(d) for d in deps]
        children: List[Optional[List[int]]] = [None] * n
        for i, ds in enumerate(deps):
            for d in ds:
                c = children[d]
                if c is None:
                    children[d] = [i]
                else:
                    c.append(i)
        self.children = [tuple(c) if c is not None else None
                         for c in children]

        self.spans = [hi - lo for lo, hi in blks]
        self._analyze_freshness()
        self.res_ids: Optional[List[Tuple[int, ...]]] = None
        self.res_indptr = None
        self.res_flat = None
        self._tpl = None
        self.bind(ct)
        self.seg = self._detect_segments(tasks) if detect_segments else None

    def _analyze_freshness(self) -> None:
        """Prove (or refute) once that every delivery is globally fresh:
        each (node, block) pair delivered at most once, every task carrying
        >= 1 block. When it holds (the whole-message trees, the chain
        family and the pipeline expansion — but *not* srda, whose allgather
        re-delivers ranges that intermediate scatter hops already hold),
        per-node block coverage degenerates to a pure countdown — the
        bitmap path in the engine is never needed — and a node's finish
        time is exactly the completion of its last delivery. ``cover_bad``
        collects nodes whose deliveries do not span all blocks (sound lists
        leave at most the broadcast root there)."""
        tb = self.total_blocks
        if self.n and all(s == 1 for s in self.spans) \
                and all(0 <= b[0] < tb for b in self.blks):
            # the common single-block shape, vectorized
            d = np.asarray(self.dst, dtype=np.int64)
            keys = d * tb + np.asarray([b[0] for b in self.blks],
                                       dtype=np.int64)
            fresh = int(np.unique(keys).size) == self.n
            if fresh:
                counts = np.bincount(d, minlength=self.num_nodes)
                self.all_fresh = True
                self.cover_bad = frozenset(
                    int(v) for v in np.nonzero(counts != tb)[0])
                return
            self.all_fresh = False
            self.cover_bad = frozenset(range(self.num_nodes))
            return
        seen: set = set()
        node_blocks: Dict[int, int] = {}
        fresh = True
        for i, (lo, hi) in enumerate(self.blks):
            if hi - lo < 1:
                fresh = False
                break
            d = self.dst[i]
            for b in range(lo, hi):
                if (d, b) in seen:
                    fresh = False
                    break
                seen.add((d, b))
            else:
                node_blocks[d] = node_blocks.get(d, 0) + (hi - lo)
                continue
            break
        self.all_fresh = fresh
        self.cover_bad = frozenset(
            v for v in range(self.num_nodes)
            if node_blocks.get(v, 0) != self.total_blocks) if fresh \
            else frozenset(range(self.num_nodes))

    def __len__(self) -> int:
        return self.n

    # -- process-local resource binding ---------------------------------------

    def bind(self, ct: CompiledTopology) -> None:
        """(Re-)derive the dense resource ids against ``ct``. A no-op when
        already bound; called after unpickling, where the ids were stripped
        (interning order is process-local for routed non-candidate pairs)."""
        if self.res_ids is not None:
            return
        edge_ids = ct.edge_ids
        if self.routes is None:
            res_ids = [edge_ids(e) for e in zip(self.src, self.dst)]
        else:
            res_ids = [
                edge_ids(e) if rt is None else
                tuple(ct.intern(r) for r in ct.cm.resources(e, links=rt[0]))
                for e, rt in zip(zip(self.src, self.dst), self.routes)]
        lens = np.asarray([len(ids) for ids in res_ids], dtype=np.int64)
        indptr = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        self.res_ids = res_ids
        self.res_indptr = indptr
        self.res_flat = np.asarray(
            [r for ids in res_ids for r in ids], dtype=np.int64)

    def __getstate__(self):
        state = {s: getattr(self, s) for s in self.__slots__}
        # dense ids depend on this process's interning history; the folded
        # template embeds them too — both rebuild deterministically via bind()
        state["res_ids"] = state["res_indptr"] = state["res_flat"] = None
        state["_tpl"] = None
        return state

    def __setstate__(self, state) -> None:
        for s in self.__slots__:
            setattr(self, s, state[s])

    # -- segment periodicity --------------------------------------------------

    def _detect_segments(self, tasks: Sequence["SendTask"],
                         ) -> Optional[SegmentInfo]:
        """Detect a periodic tail of equal-length segments.

        Candidate segmentation comes from the *leading priority component*
        (the segmented generators — chain packets, srda allgather steps —
        all advance it once per segment): trailing runs of equal length are
        candidate segments. Structural shift-invariance is then verified
        per boundary (src/dst/nbytes/block span equal, dependencies at the
        same relative offsets), shrinking the segment count while leading
        boundaries disagree (srda's first allgather step depends on the
        scatter prefix, so its boundary never matches). Returns None when no
        two trailing segments agree."""
        n = self.n
        if n < 4:
            return None
        prios = [t.priority for t in tasks]
        if not all(isinstance(p, tuple) and len(p) >= 1 for p in prios):
            return None
        runs: List[Tuple[int, int]] = []           # (start, length)
        s = 0
        for i in range(1, n):
            if prios[i][0] != prios[s][0]:
                runs.append((s, i - s))
                s = i
        runs.append((s, n - s))
        if len(runs) < 2:
            return None
        T = runs[-1][1]
        q = 1
        for start, length in reversed(runs[:-1]):
            if length != T:
                break
            q += 1
        if q < 2 or T < 1:
            return None
        prefix = n - q * T

        # structural key per task, dependencies in shift-invariant relative
        # form (dep - index): segment s equals segment s-1 iff the key
        # slices match — one C-level list compare per boundary
        rel = [tuple(d - i for d in ds) for i, ds in enumerate(self.deps)]
        key = list(zip(self.src, self.dst, self.nbytes, self.spans, rel))
        while q >= 2 and key[prefix + T:prefix + 2 * T] \
                != key[prefix:prefix + T]:
            prefix += T
            q -= 1
        if q < 2:
            return None
        if key[prefix + T:] != key[prefix:n - T]:
            return None                # irregular interior — be conservative
        return self._fold_rules(prefix, T, q)

    def _fold_rules(self, prefix: int, T: int, q: int) -> SegmentInfo:
        """Apply the fold eligibility rules to a detected segmentation (see
        ``SegmentInfo``); every rule guards an invariant a folded execution
        path relies on for bit-identical replay. The extended rules admit a
        prefix region and prev-segment dependency chains (the folded-list
        loop); the ``pure`` subclass keeps the stricter segment-template-fold
        contract that the occupancy-cycle analytics require."""

        def no(reason: str) -> SegmentInfo:
            return SegmentInfo(prefix=prefix, seg_len=T, q=q, foldable=False,
                               reason=reason)

        # -- extended rules: what the folded-list loop relies on ------------
        for i in range(prefix):
            if any(not 0 <= d < prefix for d in self.deps[i]):
                return no("prefix tasks depend on segment tasks")
        for t in range(prefix, prefix + T):
            ds = self.deps[t]
            if len(ds) > 1:
                return no("multi-dependency segment tasks")
            if ds and ds[0] < prefix - T:
                return no("dependencies reach back more than one segment")
        rank = np.asarray(self.rank)
        if not bool((rank[prefix + T:] == rank[prefix:self.n - T] + T).all()):
            return no("admission ranks are not segment-major")

        # -- pure subclass: the segment-template fold + cycle analytics ---
        pure = (prefix == 0 and self.all_fresh
                and all(not ds or 0 <= ds[0] < T for ds in self.deps[:T]))
        if pure:
            if self.has_groups:
                grps = np.asarray(self.grps)
                pure = bool((grps == np.arange(self.n) // T).all())
            else:
                pure = not any(g is not None for g in self.grps)
        return SegmentInfo(prefix=prefix, seg_len=T, q=q, foldable=True,
                           pure=pure, cover_bad=self.cover_bad)

    # -- folded template ------------------------------------------------------

    def fold_template(self, ct: CompiledTopology):
        """The one-segment template of a *pure*-foldable list, lowered like
        a pipeline group (``CompiledTemplate``), plus its fixed per-task
        durations and byte counts. The engine then executes the list as
        ``seg.q`` template instances — task ``s*T + t`` is template task
        ``t`` of segment ``s`` — through the identical folded event core
        that runs pipelines."""
        assert self.seg is not None and self.seg.pure
        tpl = self._tpl
        if tpl is None:
            from repro_torch.core.schedule import FlatTasks
            T = self.seg.seg_len
            ft = FlatTasks(
                tree=list(range(T)), src=self.src[:T], dst=self.dst[:T],
                depth=[0] * T, round_ix=self.rank[:T],
                dep=[ds[0] if ds else -1 for ds in self.deps[:T]])
            tpl = self._tpl = ct.lower_template(ft)
        return tpl, self.durs[:self.seg.seg_len], \
            self.nbytes[:self.seg.seg_len]

    def fold_layout(self) -> Tuple[List[int], List[int]]:
        """Per-position dependency classification of a foldable list, for
        the folded-list executors (``CompiledSim._run_folded_list`` and the
        kernel engine).

        Returns ``(dep_kind, dep_src)`` over the ``seg_len`` template
        positions. ``dep_kind[t]`` is 0 (no dependency), 1 (intra-segment:
        instance ``(s, t)`` depends on ``(s, dep_src[t])``) or 2
        (prev-segment: instance ``(s, t)`` depends on ``(s-1, dep_src[t])``;
        for ``s == 0`` the dependency is the individual prefix task
        ``prefix + dep_src[t] - seg_len``). ``dep_src`` holds template
        positions in ``[0, seg_len)``."""
        seg = self.seg
        assert seg is not None and seg.foldable
        P, T = seg.prefix, seg.seg_len
        dep_kind: List[int] = []
        dep_src: List[int] = []
        for t in range(T):
            ds = self.deps[P + t]
            if not ds:
                dep_kind.append(0)
                dep_src.append(0)
            elif ds[0] >= P:
                dep_kind.append(1)
                dep_src.append(ds[0] - P)
            else:
                dep_kind.append(2)
                dep_src.append(ds[0] - P + T)
        return dep_kind, dep_src
