"""Deterministic fault injection, next-hop tree repair and delivery checking.

The paper's BBS schedules assume a frozen fabric; this module is the
robustness layer that lets both simulator engines run them over a fabric that
breaks mid-broadcast (ROADMAP's dynamic-traffic/resilience item):

  * ``FaultSchedule`` — a seedable, fully deterministic list of fault events:
    ``LinkFault`` (kill a physical link resource at time *t*, optionally heal
    at a later time) and ``NodeFault`` (kill an endpoint permanently, which
    also kills every link incident to it). ``in_flight`` picks the semantics
    for sends caught on a dying link: ``"retry"`` (the transfer dies on the
    wire, its resources free immediately and the send re-enters admission
    after ``retry_timeout``) or ``"complete"`` (the bits already left — the
    transfer lands normally unless the *destination* died).
  * ``FaultState`` — the shared aliveness bookkeeping both engines consult:
    which links/nodes are currently dead, which are dead *forever* (a finite
    heal time only delays traffic; an infinite one rewires it), and the
    degraded candidate-edge adjacency used for repair routing.
  * ``plan_repair`` — the orphan detector + repair planner. Pure and
    deterministic: given identical pending-task/coverage state it returns the
    identical plan, which is how ``EventSimulator`` and ``CompiledSim`` stay
    bit-identical under churn (asserted in tests/test_faults.py). Pending
    tasks whose endpoints died or whose route lost a never-healing link are
    cancelled; each cancelled *delivery* is re-grafted from its nearest
    surviving holder along ``NextHopTable`` detours over the degraded
    candidate graph — one ordinary ``SendTask``-shaped hop per edge, charged
    through the same compiled Hockney resource layer as every other send, so
    repair traffic contends honestly. Deliveries with no surviving reachable
    holder are recorded as *lost* and their dependents cancelled in cascade.
  * ``verify_delivery`` — the post-run guarantee: every surviving node still
    reachable from the root over never-killed candidate edges must hold the
    complete message. Transiently dead links never make a node lost (repair
    hops simply suspend until the heal), so ``lost`` is always a subset of
    the finally-unreachable set and the check cannot false-fail.
  * ``FaultReport`` — per-run degradation metrics (events applied, aborted /
    retried sends, cancelled + repair task counts, repair latency, lost
    blocks) attached to ``SimResult.faults`` and surfaced through
    ``simulate_pipeline`` / ``simulate_baseline`` / ``broadcast_time``.

Repair holders are nodes that already *hold* the needed blocks (the root
always qualifies) or earlier hops of the same planning pass — never merely
pending deliveries, so a later cascade cancellation can never strand a
repair chain. Hierarchical fabrics route repairs over their pruned candidate
graph (the same graph ``Topology.validate`` proves connected), which may
declare a pair unreachable that raw hardware could still join — conservative,
and exactly the graph the verifier uses, so planner and verifier agree.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
import random as _random
from collections import deque
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.routing import NextHopTable

INF = math.inf

# in-flight-send semantics
RETRY = "retry"          # the send dies on the wire and is retried later
COMPLETE = "complete"    # the bits already left: land unless the dst died

# task state codes shared by both fault-aware engine loops (supersets of the
# fault-free codes: 0..4 match simulator/fastsim, 5..7 are fault-only)
WAITING, READY, BLOCKED, RUNNING, DONE, CANCELLED, SUSPENDED, ABORTED = \
    range(8)
PENDING_STATES = frozenset((WAITING, READY, BLOCKED, SUSPENDED, ABORTED))


@dataclasses.dataclass(frozen=True)
class LinkFault:
    """Kill physical link ``link`` at ``time``; heal at ``heal_time`` (the
    default ``inf`` never heals — traffic over it must be rewired)."""

    time: float
    link: str
    heal_time: float = INF


@dataclasses.dataclass(frozen=True)
class NodeFault:
    """Kill endpoint ``node`` at ``time`` — permanently, links included."""

    time: float
    node: int


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A deterministic fault script: events + in-flight-send semantics.

    An empty schedule is falsy and both engines treat it exactly like no
    schedule at all (the fault layer is zero-cost when inactive). Kills of
    the same link must not overlap in time; the last kill wins.
    """

    events: Tuple = ()
    in_flight: str = RETRY
    retry_timeout: float = 1e-6

    def __post_init__(self):
        assert self.in_flight in (RETRY, COMPLETE), \
            f"in_flight must be {RETRY!r} or {COMPLETE!r}"
        assert self.retry_timeout >= 0.0
        for ev in self.events:
            assert ev.time >= 0.0, f"fault before t=0: {ev}"
            if isinstance(ev, LinkFault):
                assert ev.heal_time > ev.time, f"heal before kill: {ev}"

    def __bool__(self) -> bool:
        return bool(self.events)

    # -- convenience constructors -------------------------------------------

    @classmethod
    def kill_link(cls, link: str, time: float, heal_time: float = INF,
                  **kw) -> "FaultSchedule":
        return cls(events=(LinkFault(time=time, link=link,
                                     heal_time=heal_time),), **kw)

    @classmethod
    def kill_edge(cls, topo, u: int, v: int, time: float,
                  heal_time: float = INF, **kw) -> "FaultSchedule":
        """Kill the links specific to endpoint pair (u, v): the cable(s) on a
        flat fabric, the trunk(s) on a hierarchical one (NICs are spared —
        killing them would sever the *nodes*, which is ``kill_node``'s job).
        """
        links = topo.links((u, v))
        trunks = tuple(l for l in links if not l.startswith("nic:")) or links
        return cls(events=tuple(LinkFault(time=time, link=l,
                                          heal_time=heal_time)
                                for l in trunks), **kw)

    @classmethod
    def kill_node(cls, node: int, time: float, **kw) -> "FaultSchedule":
        return cls(events=(NodeFault(time=time, node=node),), **kw)

    @classmethod
    def random(cls, topo, seed: int, *, link_faults: int = 1,
               node_faults: int = 0, window: Tuple[float, float] = (0.0, 1.0),
               heal_after: Optional[float] = None,
               avoid_nodes: Sequence[int] = (0,), **kw) -> "FaultSchedule":
        """A seeded random schedule: ``link_faults`` link kills (healing
        ``heal_after`` seconds later when given, else permanent) and
        ``node_faults`` node kills, at uniform times in ``window``.
        ``avoid_nodes`` (default: the conventional root 0) are never killed.
        Same (topo, seed, knobs) -> same schedule, on any platform."""
        rng = _random.Random(seed)
        links = fabric_links(topo)
        nodes = [v for v in topo.compute_nodes if v not in set(avoid_nodes)]
        events = []
        for _ in range(link_faults):
            t = rng.uniform(*window)
            heal = t + heal_after if heal_after is not None else INF
            events.append(LinkFault(time=t, link=rng.choice(links),
                                    heal_time=heal))
        for _ in range(node_faults):
            events.append(NodeFault(time=rng.uniform(*window),
                                    node=rng.choice(nodes)))
        return cls(events=tuple(events), **kw)


def fabric_links(topo) -> List[str]:
    """Every physical link name of a fabric, sorted (for seeded sampling)."""
    adj = getattr(topo, "_adj", None)
    if adj is not None:       # flat: all cables
        return sorted({topo._cable(a, b) for a in adj for b in adj[a]})
    out: Set[str] = set()
    for e in topo.candidate_edges:
        out.update(topo.links(e))
    return sorted(out)


def _incident_links(topo, v: int) -> List[str]:
    """The links a node kill takes down with it."""
    adj = getattr(topo, "_adj", None)
    if adj is not None:       # flat: every cable at v (v can't forward)
        return [topo._cable(v, w) for w in adj[v]]
    return [f"nic:{v}"]       # hierarchical: the node's NIC


def control_heap(sched: FaultSchedule) -> Tuple[list, int]:
    """The initial control-event heap shared by both engines: entries
    ``(time, seq, (kind, arg, aux))`` with kinds ``kill_link`` / ``heal_link``
    / ``kill_node``; engines push ``("retry", task, 0.0)`` wakes with later
    seqs. Returns (heap, next_seq)."""
    heap: list = []
    seq = 0
    for ev in sched.events:
        if isinstance(ev, NodeFault):
            heap.append((ev.time, seq, ("kill_node", ev.node, 0.0)))
            seq += 1
        else:
            heap.append((ev.time, seq, ("kill_link", ev.link, ev.heal_time)))
            seq += 1
            if ev.heal_time < INF:
                heap.append((ev.heal_time, seq, ("heal_link", ev.link, 0.0)))
                seq += 1
    heapq.heapify(heap)
    return heap, seq


class FaultState:
    """Current fabric damage, shared semantics for both engines.

    ``dead_links`` maps link name -> heal time (``inf`` = never). A node kill
    marks the node dead and pins every incident link dead forever; a heal
    event for a link that was since upgraded to permanent is ignored.
    """

    __slots__ = ("topo", "dead_links", "dead_nodes", "_links_memo")

    def __init__(self, topo):
        self.topo = topo
        self.dead_links: Dict[str, float] = {}
        self.dead_nodes: Set[int] = set()
        self._links_memo: Dict[Tuple[int, int], Tuple[str, ...]] = {}

    def links(self, u: int, v: int) -> Tuple[str, ...]:
        e = (u, v)
        ls = self._links_memo.get(e)
        if ls is None:
            ls = self._links_memo[e] = self.topo.links(e)
        return ls

    def kill_link(self, link: str, heal_time: float = INF) -> None:
        self.dead_links[link] = heal_time

    def heal_link(self, link: str) -> None:
        if self.dead_links.get(link) != INF:   # permanent kills don't heal
            self.dead_links.pop(link, None)

    def kill_node(self, v: int) -> None:
        self.dead_nodes.add(v)
        for l in _incident_links(self.topo, v):
            self.dead_links[l] = INF

    def edge_alive(self, u: int, v: int) -> bool:
        """Whether a send u -> v can run *right now*."""
        if u in self.dead_nodes or v in self.dead_nodes:
            return False
        dl = self.dead_links
        if not dl:
            return True
        return not any(l in dl for l in self.links(u, v))

    def edge_dead_forever(self, u: int, v: int) -> bool:
        """Whether a send u -> v can never run again (a transiently dead
        route only delays; it needs no repair)."""
        if u in self.dead_nodes or v in self.dead_nodes:
            return True
        dl = self.dead_links
        if not dl:
            return False
        return any(dl.get(l) == INF for l in self.links(u, v))

    def usable_adj(self) -> Dict[int, List[int]]:
        """Candidate-edge adjacency minus everything dead forever — the graph
        repair detours and the delivery verifier both route over.
        Transiently dead edges stay usable: a repair hop over one simply
        suspends until the heal."""
        adj: Dict[int, List[int]] = {u: [] for u in self.topo.compute_nodes}
        for (u, v) in self.topo.candidate_edges:
            if not self.edge_dead_forever(u, v):
                adj[u].append(v)
        for u in adj:
            adj[u].sort()
        return adj


class TaskTable:
    """Parallel per-task metadata both fault loops maintain (and grow with
    repair tasks); the lists are aliased with the owning engine's arrays."""

    __slots__ = ("src", "dst", "nbytes", "blks", "grps", "prio", "deps")

    def __init__(self, src, dst, nbytes, blks, grps, prio, deps):
        self.src = src
        self.dst = dst
        self.nbytes = nbytes
        self.blks = blks
        self.grps = grps
        self.prio = prio
        self.deps = deps

    def append(self, rt: "RepairTask") -> int:
        i = len(self.src)
        self.src.append(rt.src)
        self.dst.append(rt.dst)
        self.nbytes.append(rt.nbytes)
        self.blks.append(rt.blk)
        self.grps.append(rt.group)
        self.prio.append(rt.priority)
        self.deps.append(rt.deps)
        return i


@dataclasses.dataclass(frozen=True)
class RepairTask:
    """One hop of a planned repair detour (``SendTask``-shaped, engine
    agnostic — each engine lowers it onto its own resource representation)."""

    src: int
    dst: int
    nbytes: float
    blk: Tuple[int, int]
    group: Optional[int]
    priority: Tuple
    deps: Tuple[int, ...]


@dataclasses.dataclass
class RepairPlan:
    cancelled: List[int]                 # task ids to cancel, ascending
    new_tasks: List[RepairTask]          # ids follow the current table length
    rewires: Dict[int, Tuple[int, ...]]  # kept task id -> full new dep tuple
    lost: List[Tuple[int, int]]          # (node, block) with no repair route
    repaired: int                        # cancelled deliveries re-grafted


_LOST = (-1,)   # replacement sentinel: the delivery is unrecoverable


def plan_repair(fs: FaultState, tt: TaskTable, pending: Sequence[int],
                covered: Dict[int, set], root: int) -> Optional[RepairPlan]:
    """The orphan detector + repair planner (pure; both engines call it with
    identical state and apply the identical plan).

    A pending task is *dead* when an endpoint died or its route holds a
    never-healing link. Each dead task is cancelled; its delivery
    ``(dst, blocks)`` — unless already ensured by coverage or an earlier
    repair — is re-grafted from the nearest surviving holder via the
    degraded next-hop table, one repair hop per candidate edge, priorities
    slotted directly after the cancelled task's. Unreachable deliveries are
    lost and their dependents cancelled in cascade; surviving dependents of
    a cancelled task are rewired onto whatever now delivers their input.
    """
    dn = fs.dead_nodes
    dead_now = [i for i in pending
                if tt.src[i] in dn or tt.dst[i] in dn
                or fs.edge_dead_forever(tt.src[i], tt.dst[i])]
    if not dead_now:
        return None

    topo = fs.topo
    nn = topo.num_nodes
    router = NextHopTable(nn, fs.usable_adj())
    dist = router.dist
    pending_set = set(pending)
    cancelled = set(dead_now)
    dep_index: Dict[int, List[int]] = {}
    for j in pending:
        for d in tt.deps[j]:
            dep_index.setdefault(d, []).append(j)

    n0 = len(tt.src)
    planned: Dict[Tuple[int, int], int] = {}   # (node, block) -> repair id
    replacement: Dict[int, Tuple[int, ...]] = {}
    new_tasks: List[RepairTask] = []
    lost: List[Tuple[int, int]] = []
    repaired = 0

    queue = deque(sorted(dead_now))
    while queue:
        d = queue.popleft()
        v = tt.dst[d]
        if v in dn:
            replacement[d] = ()          # nobody left to deliver to
            continue
        lo, hi = tt.blks[d]
        rng = range(lo, hi)
        cv = covered[v]
        if all(b in cv or (v, b) in planned for b in rng):
            # delivery already ensured: dependents wait on the repair hops
            # (if any) that land the uncovered blocks at v
            replacement[d] = tuple(sorted(
                {planned[(v, b)] for b in rng if b not in cv}))
            continue
        # nearest holder of the full range: already-covered nodes (the root
        # always qualifies) or targets of repair hops planned this pass —
        # never merely-pending deliveries, which a later cascade could cancel
        best = None
        for w in range(nn):
            if w == v or w in dn:
                continue
            dw = int(dist[w, v])
            if dw < 0 or (best is not None and (dw, w) >= best):
                continue
            cw = covered[w]
            if all(b in cw or (w, b) in planned for b in rng):
                best = (dw, w)
        if best is None:
            newly = [(v, b) for b in rng if b not in cv]
            lost.extend(newly)
            replacement[d] = _LOST
            for j in dep_index.get(d, ()):
                if j in pending_set and j not in cancelled:
                    cancelled.add(j)
                    queue.append(j)
            continue
        w = best[1]
        path = router.path(w, v)
        cw = covered[w]
        first_deps = tuple(sorted(
            {planned[(w, b)] for b in rng if b not in cw}))
        prev: Optional[int] = None
        base_prio = tuple(tt.prio[d])
        for hop, (a, b2) in enumerate(zip(path, path[1:])):
            gid = n0 + len(new_tasks)
            new_tasks.append(RepairTask(
                src=a, dst=b2, nbytes=tt.nbytes[d], blk=(lo, hi),
                group=tt.grps[d], priority=base_prio + (1, hop),
                deps=(prev,) if prev is not None else first_deps))
            for b in rng:
                planned[(b2, b)] = gid
            prev = gid
        replacement[d] = (prev,)
        repaired += 1

    rewires: Dict[int, Tuple[int, ...]] = {}
    for j in sorted(pending_set - cancelled):
        ds = tt.deps[j]
        if not any(d in cancelled for d in ds):
            continue
        nd: List[int] = []
        for d in ds:
            if d in cancelled:
                nd.extend(replacement[d])   # never _LOST: j would be cancelled
            else:
                nd.append(d)
        rewires[j] = tuple(sorted(set(nd)))
    return RepairPlan(cancelled=sorted(cancelled), new_tasks=new_tasks,
                      rewires=rewires, lost=lost, repaired=repaired)


@dataclasses.dataclass
class FaultReport:
    """Per-run degradation metrics (``SimResult.faults``)."""

    events_applied: int                  # kill events that actually fired
    aborted: int                         # in-flight sends killed on the wire
    retries: int                         # aborted sends re-admitted
    cancelled: int                       # pending tasks cancelled by repair
    repair_tasks: int                    # repair hops injected
    repaired: int                        # cancelled deliveries re-grafted
    dead_nodes: Tuple[int, ...]
    lost: Tuple[Tuple[int, int], ...]    # (node, block) never deliverable
    incomplete: Tuple[int, ...]          # surviving nodes missing blocks
    repair_latency: float                # first repair-triggering kill ->
                                         # last repair-hop completion

    def summary(self) -> str:
        return (f"events={self.events_applied} aborted={self.aborted} "
                f"retries={self.retries} cancelled={self.cancelled} "
                f"repair_tasks={self.repair_tasks} lost={len(self.lost)} "
                f"repair_latency={self.repair_latency:.3e}s")

    def to_dict(self) -> dict:
        """A stable JSON-safe form; ``from_dict(to_dict())`` round-trips to
        an equal report, including through ``json.dumps``/``loads`` (the
        tuple fields serialize as lists and are re-tupled on the way in)."""
        return {
            "events_applied": self.events_applied,
            "aborted": self.aborted,
            "retries": self.retries,
            "cancelled": self.cancelled,
            "repair_tasks": self.repair_tasks,
            "repaired": self.repaired,
            "dead_nodes": list(self.dead_nodes),
            "lost": [[v, b] for v, b in self.lost],
            "incomplete": list(self.incomplete),
            "repair_latency": self.repair_latency,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FaultReport":
        return cls(
            events_applied=d["events_applied"], aborted=d["aborted"],
            retries=d["retries"], cancelled=d["cancelled"],
            repair_tasks=d["repair_tasks"], repaired=d["repaired"],
            dead_nodes=tuple(d["dead_nodes"]),
            lost=tuple((v, b) for v, b in d["lost"]),
            incomplete=tuple(d["incomplete"]),
            repair_latency=d["repair_latency"],
        )


@dataclasses.dataclass
class DeliveryCheck:
    """Result of ``verify_delivery``."""

    ok: bool
    required: Tuple[int, ...]        # surviving nodes reachable from root
    missing: Tuple[int, ...]         # required nodes that never finished
    unreachable: Tuple[int, ...]     # surviving nodes cut off from the root


def verify_delivery(topo, sched: FaultSchedule, result, root: int,
                    ) -> DeliveryCheck:
    """The delivery guarantee: every surviving node reachable from the root
    over never-killed candidate edges holds the complete message.

    Uses only the *final* permanent damage (node kills + never-healing link
    kills); transient faults delay but cannot exempt a node. The usable
    graph only shrinks over time, so any node counted reachable here was
    reachable at every repair-planning instant — the planner can never have
    lost a delivery this check requires."""
    fs = FaultState(topo)
    for ev in sched.events:
        if isinstance(ev, NodeFault):
            fs.kill_node(ev.node)
        elif ev.heal_time == INF:
            fs.kill_link(ev.link, INF)
    adj = fs.usable_adj()
    alive = [v for v in topo.compute_nodes if v not in fs.dead_nodes]
    reach: Set[int] = set()
    if root not in fs.dead_nodes:
        reach.add(root)
        stack = [root]
        while stack:
            u = stack.pop()
            for w in adj[u]:
                if w not in reach:
                    reach.add(w)
                    stack.append(w)
    required = tuple(v for v in alive if v in reach)
    finished = result.node_finish
    missing = tuple(v for v in required if v not in finished)
    unreachable = tuple(v for v in alive if v not in reach)
    return DeliveryCheck(ok=not missing, required=required, missing=missing,
                         unreachable=unreachable)
