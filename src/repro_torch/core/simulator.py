"""Discrete-event broadcast simulator (our SimGrid replacement).

Semantics match the paper's assumptions:
  * Hockney cost per transfer: t = L_e + nbytes / B_e (non-preemptive — a
    packet in flight cannot be interrupted, Def. 3).
  * A transfer occupies the resources from the ConflictModel for its whole
    duration; a resource serves one transfer at a time.
  * A node may forward data only after fully receiving it — encoded as
    explicit task dependencies (``deps``: indices of tasks that must complete
    before this one starts).

Each task carries a *block range* [blk_lo, blk_hi): the slice of the message
it moves. A node is finished when its received ranges cover all blocks; the
broadcast finish time is the max over nodes (paper's T(M)).

Blocked tasks wait on per-resource queues (woken when the resource frees) or
on dependency counters (woken on completion), so per-event work tracks local
contention, not total task count.

For pipelined schedules the paper's Theorem 2 (T(m groups) = T(1) + (m-1)·Δ)
lets us simulate a prefix of groups and extrapolate the steady state; this is
validated against full simulation in tests and used for the huge cells. The
estimate semantics shared by both engines live here (``thm2_delta_floor`` /
``thm2_extrapolate``): the measured Δ is floored by the paper's Δ* resource
bound (Def. 8) because a still-filling prefix under-estimates the steady
period.

Two engines implement these semantics:

  * ``EventSimulator`` (here) — the pure-Python reference oracle, kept simple
    and close to the paper's definitions;
  * ``repro.core.fastsim.CompiledSim`` — the round-batched flat-array engine
    (template-lowered pipelines, one-shot task-list lowering
    (``repro.core.routing.CompiledTaskList``) with segment folding for the
    routed baselines, vectorized frontier admission, counter-based
    coverage, and two steady-state paths: the shared Thm-2 estimate plus a
    verified occupancy-cycle detector that is *exact* on truly cyclic
    schedules — and applies to fold-eligible task lists too). Full
    simulations replay the identical event schedule, so they match the
    oracle bit for bit; the estimate path shares the reference
    extrapolation semantics. See docs/engines.md.

``make_engine``/``simulate_pipeline`` select via ``engine="fast"|"reference"``
(fast is the default everywhere; tests compare the two).
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

from repro_torch.core import faults as _faults
from repro_torch.core.faults import FaultReport, FaultSchedule
from repro_torch.core.intersection import ConflictModel
from repro_torch.core.schedule import Pipeline
from repro_torch.core.simconfig import DEFAULT_ENGINE, SimConfig, UNSET, \
    resolve_config
from repro_torch.core.topology import Edge, Topology


@dataclasses.dataclass
class SendTask:
    priority: Tuple
    src: int
    dst: int
    nbytes: float
    deps: Tuple[int, ...] = ()
    blk: Tuple[int, int] = (0, 1)     # [lo, hi) message blocks carried
    group: Optional[int] = None       # pipeline group tag (for Δ measurement)
    # pinned physical route (links, latency, bandwidth) overriding the
    # topology's natural resolution — set by relabeled plans whose routed
    # paths must keep the original conflict structure (repro.core.symmetry)
    route: Optional[Tuple[Tuple[str, ...], float, float]] = None


@dataclasses.dataclass
class SimResult:
    finish_time: float
    node_finish: Dict[int, float]          # node -> time it held everything
    deliveries: List[Tuple[float, float]]  # (time, nbytes) per completed send
    group_finish: List[float]              # finish per pipeline group
    started: int
    completed: int
    faults: Optional[FaultReport] = None   # degradation metrics (churn runs)

    def rate_timeline(self, bins: int = 100) -> List[Tuple[float, float]]:
        """Aggregated receive rate over time (bytes/s per bin) — Fig. 2."""
        if not self.deliveries:
            return []
        t_end = max(t for t, _ in self.deliveries)
        if t_end <= 0:
            return []
        w = t_end / bins
        acc = [0.0] * bins
        for t, nb in self.deliveries:
            acc[min(bins - 1, int(t / w))] += nb
        return [((i + 0.5) * w, acc[i] / w) for i in range(bins)]

    def to_dict(self) -> dict:
        """A stable JSON-safe form: ``SimResult.from_dict(r.to_dict()) == r``
        and ``json.loads(json.dumps(r.to_dict()))`` round-trips losslessly
        (node ids are ints, times floats — both JSON-native). Consumed by
        the simbench workload cell and ``check_regression`` instead of
        ad-hoc field picking."""
        return {
            "finish_time": self.finish_time,
            "node_finish": [[v, t] for v, t in sorted(
                self.node_finish.items())],
            "deliveries": [[t, nb] for t, nb in self.deliveries],
            "group_finish": list(self.group_finish),
            "started": self.started,
            "completed": self.completed,
            "faults": self.faults.to_dict() if self.faults else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SimResult":
        faults = d.get("faults")
        return cls(
            finish_time=d["finish_time"],
            node_finish={v: t for v, t in d["node_finish"]},
            deliveries=[(t, nb) for t, nb in d["deliveries"]],
            group_finish=list(d["group_finish"]),
            started=d["started"],
            completed=d["completed"],
            faults=FaultReport.from_dict(faults) if faults else None,
        )


_WAITING, _READY, _BLOCKED, _RUNNING, _DONE = range(5)


def make_engine(topo: Topology, cm: ConflictModel, root: int,
                engine: str = DEFAULT_ENGINE, device="cuda"):
    """Simulator factory: the reference oracle, the flat-array engine, or
    the kernelized engine (``"kernel"`` -- the event core over the lowered
    arrays on ``device``, a hand-written CUDA kernel on cuda and its plain
    PyTorch version on the CPU; see ``repro_torch.core.kernelsim``).
    ``device`` is read by the kernel engine alone."""
    if engine == "reference":
        return EventSimulator(topo, cm, root)
    if engine == "fast":
        from repro_torch.core.fastsim import CompiledSim
        return CompiledSim(topo, cm, root)
    if engine == "kernel":
        from repro_torch.core.kernelsim import KernelSim
        return KernelSim(topo, cm, root, device=device)
    raise ValueError(f"unknown engine {engine!r}")


class EventSimulator:
    """Resource-constrained priority simulation of dependent send tasks."""

    def __init__(self, topo: Topology, cm: ConflictModel, root: int):
        self.topo = topo
        self.cm = cm
        self.root = root
        self.ct = cm.compiled()   # shared routing / resource / Hockney tables

    def run(self, tasks: Sequence[SendTask],
            total_blocks: Optional[int] = None,
            faults: Optional[FaultSchedule] = None) -> SimResult:
        if faults:
            return self._run_faulty(tasks, total_blocks, faults)
        topo, cm, root, ct = self.topo, self.cm, self.root, self.ct
        n_tasks = len(tasks)
        order = sorted(range(n_tasks), key=lambda i: tasks[i].priority)
        rank = [0] * n_tasks
        for pos, i in enumerate(order):
            rank[i] = pos

        if total_blocks is None:
            total_blocks = max((t.blk[1] for t in tasks), default=1)
        block_bytes: Dict[int, float] = {}
        for t in tasks:
            span = t.blk[1] - t.blk[0]
            if span > 0:
                per = t.nbytes / span
                for b in range(*t.blk):
                    block_bytes[b] = per
        full_message = sum(block_bytes.get(b, 0.0) for b in range(total_blocks))

        dep_left = [len(t.deps) for t in tasks]
        children: Dict[int, List[int]] = {}
        for i, t in enumerate(tasks):
            for d in t.deps:
                children.setdefault(d, []).append(i)

        state = [_WAITING] * n_tasks
        busy: Dict[Hashable, int] = {}       # resource -> slots in use
        caps: Dict[Hashable, int] = {}
        res_wait: Dict[Hashable, List[int]] = {}
        ready: List[Tuple[int, int]] = []
        resources = [cm.resources((t.src, t.dst), links=t.route[0])
                     if t.route is not None
                     else ct.resources((t.src, t.dst)) for t in tasks]
        for rs in resources:
            for r in rs:
                if r not in caps:
                    caps[r] = cm.capacity(r)

        for i in range(n_tasks):
            if dep_left[i] == 0:
                state[i] = _READY
                heapq.heappush(ready, (rank[i], i))

        events: List[Tuple[float, int, int]] = []
        seq = 0
        now = 0.0
        covered: Dict[int, set] = {v: set() for v in topo.compute_nodes}
        covered[root] = set(range(total_blocks))
        node_bytes: Dict[int, float] = {v: 0.0 for v in topo.compute_nodes}
        node_bytes[root] = full_message
        node_finish: Dict[int, float] = {root: 0.0}
        deliveries: List[Tuple[float, float]] = []
        group_last: Dict[int, float] = {}
        started = completed = 0

        def process_ready() -> None:
            nonlocal seq, started
            while ready:
                rk, i = heapq.heappop(ready)
                if state[i] != _READY:
                    continue
                t = tasks[i]
                blocked_on = [r for r in resources[i]
                              if busy.get(r, 0) >= caps[r]]
                if blocked_on:
                    state[i] = _BLOCKED
                    for r in blocked_on:
                        res_wait.setdefault(r, []).append(i)
                    continue
                for r in resources[i]:
                    busy[r] = busy.get(r, 0) + 1
                if t.route is not None:
                    lat, bw = t.route[1], t.route[2]
                else:
                    lat, bw = ct.edge_cost((t.src, t.dst))
                dur = lat + t.nbytes / bw
                heapq.heappush(events, (now + dur, seq, i))
                seq += 1
                started += 1
                state[i] = _RUNNING

        process_ready()
        while events:
            now, _, i = heapq.heappop(events)
            t = tasks[i]
            state[i] = _DONE
            completed += 1
            for r in resources[i]:
                busy[r] -= 1
            fresh = [b for b in range(*t.blk) if b not in covered[t.dst]]
            covered[t.dst].update(fresh)
            node_bytes[t.dst] += sum(block_bytes.get(b, 0.0) for b in fresh)
            if t.dst not in node_finish and \
                    len(covered[t.dst]) >= total_blocks:
                node_finish[t.dst] = now
            deliveries.append((now, t.nbytes))
            if t.group is not None:
                group_last[t.group] = max(group_last.get(t.group, 0.0), now)
            for j in children.get(i, ()):
                dep_left[j] -= 1
                if dep_left[j] == 0 and state[j] == _WAITING:
                    state[j] = _READY
                    heapq.heappush(ready, (rank[j], j))
            for r in resources[i]:
                for j in res_wait.pop(r, []):
                    if state[j] == _BLOCKED:
                        state[j] = _READY
                        heapq.heappush(ready, (rank[j], j))
            process_ready()

        undone = [i for i in range(n_tasks) if state[i] != _DONE]
        assert not undone, (
            f"{len(undone)} tasks never ran (first: "
            f"{[tasks[i] for i in undone[:3]]}) — dependency cycle")
        missing = [v for v in topo.compute_nodes
                   if len(covered[v]) < total_blocks]
        assert not missing, f"nodes {missing[:5]} never got the full message"
        finish = max(node_finish.values())
        gf = [group_last[g] for g in sorted(group_last)] if group_last else []
        return SimResult(finish_time=finish, node_finish=node_finish,
                         deliveries=deliveries, group_finish=gf,
                         started=started, completed=completed)

    def _run_faulty(self, tasks: Sequence[SendTask],
                    total_blocks: Optional[int],
                    faults: FaultSchedule) -> SimResult:
        """The fault-aware oracle loop (``run`` with a live FaultSchedule).

        Same admission discipline as the fault-free loop, with the ready heap
        keyed by ``(priority, task index)`` — identical order for the
        original tasks (the fault-free rank is the stable priority sort) and
        well-defined for repair tasks injected mid-run, whose priorities
        extend a cancelled task's tuple. Control events (kill / heal / retry
        wake, one shared heap) apply strictly before task completions at
        equal times. Transiently dead routes suspend at admission and wake on
        heal; permanently dead pending work is cancelled and re-grafted by
        ``repro.core.faults.plan_repair`` — the repair hops are ordinary
        tasks charged through the same resources. See docs/faults.md."""
        F = _faults
        topo, cm, root, ct = self.topo, self.cm, self.root, self.ct
        if total_blocks is None:
            total_blocks = max((t.blk[1] for t in tasks), default=1)

        src = [t.src for t in tasks]
        dst = [t.dst for t in tasks]
        nbytes = [t.nbytes for t in tasks]
        blks = [t.blk for t in tasks]
        grps = [t.group for t in tasks]
        prio = [tuple(t.priority) for t in tasks]
        deps = [tuple(t.deps) for t in tasks]
        tt = F.TaskTable(src, dst, nbytes, blks, grps, prio, deps)

        fs = F.FaultState(topo)
        ctrl, ctrl_seq = F.control_heap(faults)
        retry_mode = faults.in_flight == F.RETRY

        routes = [getattr(t, "route", None) for t in tasks]
        resources = [cm.resources((t.src, t.dst), links=rt[0])
                     if rt is not None
                     else ct.resources((t.src, t.dst))
                     for t, rt in zip(tasks, routes)]
        caps: Dict[Hashable, int] = {}
        for rs in resources:
            for r in rs:
                if r not in caps:
                    caps[r] = cm.capacity(r)
        busy: Dict[Hashable, int] = {}
        res_wait: Dict[Hashable, List[int]] = {}

        dep_left = [len(ds) for ds in deps]
        children: Dict[int, List[int]] = {}
        for i, ds in enumerate(deps):
            for d in ds:
                children.setdefault(d, []).append(i)

        state = [F.WAITING] * len(tasks)
        ready: List[Tuple[Tuple, int]] = []
        for i in range(len(tasks)):
            if dep_left[i] == 0:
                state[i] = F.READY
                heapq.heappush(ready, (prio[i], i))

        suspended: List[int] = []
        repair_ids: set = set()
        events: List[Tuple[float, int, int]] = []
        seq = 0
        now = 0.0
        covered: Dict[int, set] = {v: set() for v in topo.compute_nodes}
        covered[root] = set(range(total_blocks))
        node_finish: Dict[int, float] = {root: 0.0}
        deliveries: List[Tuple[float, float]] = []
        group_last: Dict[int, float] = {}
        lost_all: List[Tuple[int, int]] = []
        started = completed = 0
        applied = aborted = retried = cancelled_n = repaired_n = 0
        repair_t0: Optional[float] = None
        repair_done = 0.0

        def admit() -> None:
            nonlocal seq, started
            while ready:
                _, i = heapq.heappop(ready)
                if state[i] != F.READY:
                    continue
                if not fs.edge_alive(src[i], dst[i]):
                    # transiently dead route: park until a heal re-admits it
                    # (dead-forever routes never get here — the planner
                    # cancels them at the kill event)
                    state[i] = F.SUSPENDED
                    suspended.append(i)
                    continue
                blocked_on = [r for r in resources[i]
                              if busy.get(r, 0) >= caps[r]]
                if blocked_on:
                    state[i] = F.BLOCKED
                    for r in blocked_on:
                        res_wait.setdefault(r, []).append(i)
                    continue
                for r in resources[i]:
                    busy[r] = busy.get(r, 0) + 1
                rt = routes[i] if i < len(routes) else None
                if rt is not None:
                    lat, bw = rt[1], rt[2]
                else:
                    lat, bw = ct.edge_cost((src[i], dst[i]))
                dur = lat + nbytes[i] / bw
                heapq.heappush(events, (now + dur, seq, i))
                seq += 1
                started += 1
                state[i] = F.RUNNING

        def apply_control(op) -> None:
            nonlocal ctrl_seq, applied, aborted, cancelled_n, repaired_n, \
                retried, repair_t0
            kind = op[0]
            if kind == "retry":
                i = op[1]
                if state[i] == F.ABORTED:
                    state[i] = F.READY
                    retried += 1
                    heapq.heappush(ready, (prio[i], i))
                return
            if kind == "heal_link":
                fs.heal_link(op[1])
                wake = sorted(suspended)
                suspended.clear()
                for i in wake:
                    if state[i] == F.SUSPENDED:
                        state[i] = F.READY
                        heapq.heappush(ready, (prio[i], i))
                return
            if kind == "kill_link":
                fs.kill_link(op[1], op[2])
            else:
                fs.kill_node(op[1])
            applied += 1
            for i in range(len(state)):
                if state[i] != F.RUNNING:
                    continue
                if fs.edge_alive(src[i], dst[i]):
                    continue
                if not retry_mode and dst[i] not in fs.dead_nodes:
                    continue        # completes-then-dies: let it land
                state[i] = F.ABORTED    # the in-flight send died on the wire
                aborted += 1
                for r in resources[i]:
                    busy[r] -= 1
                for r in resources[i]:
                    for j in res_wait.pop(r, []):
                        if state[j] == F.BLOCKED:
                            state[j] = F.READY
                            heapq.heappush(ready, (prio[j], j))
                heapq.heappush(ctrl, (now + faults.retry_timeout, ctrl_seq,
                                      ("retry", i, 0.0)))
                ctrl_seq += 1
            pending = [i for i in range(len(state))
                       if state[i] in F.PENDING_STATES]
            plan = F.plan_repair(fs, tt, pending, covered, root)
            if plan is None:
                return
            if repair_t0 is None:
                repair_t0 = now
            for i in plan.cancelled:
                state[i] = F.CANCELLED
            cancelled_n += len(plan.cancelled)
            repaired_n += plan.repaired
            lost_all.extend(plan.lost)
            for rt in plan.new_tasks:
                i = tt.append(rt)
                resources.append(ct.resources((rt.src, rt.dst)))
                for r in resources[i]:
                    if r not in caps:
                        caps[r] = cm.capacity(r)
                dl = sum(1 for d in rt.deps if state[d] != F.DONE)
                dep_left.append(dl)
                for d in rt.deps:
                    children.setdefault(d, []).append(i)
                repair_ids.add(i)
                state.append(F.READY if dl == 0 else F.WAITING)
                if dl == 0:
                    heapq.heappush(ready, (prio[i], i))
            for j in sorted(plan.rewires):
                nd = plan.rewires[j]
                old = set(deps[j])
                deps[j] = nd
                for d in nd:
                    if d not in old:
                        children.setdefault(d, []).append(j)
                dep_left[j] = sum(1 for d in nd if state[d] != F.DONE)
                if dep_left[j] == 0 and state[j] == F.WAITING:
                    state[j] = F.READY
                    heapq.heappush(ready, (prio[j], j))

        admit()
        while True:
            next_t = events[0][0] if events else math.inf
            while ctrl and ctrl[0][0] <= next_t:
                t_c, _, op = heapq.heappop(ctrl)
                if t_c > now:
                    now = t_c
                apply_control(op)
                admit()
                next_t = events[0][0] if events else math.inf
            if not events:
                if ctrl:
                    continue
                break
            now, _, i = heapq.heappop(events)
            if state[i] != F.RUNNING:
                continue               # aborted/cancelled mid-flight
            state[i] = F.DONE
            completed += 1
            for r in resources[i]:
                busy[r] -= 1
            d = dst[i]
            fresh = [b for b in range(*blks[i]) if b not in covered[d]]
            covered[d].update(fresh)
            if d not in node_finish and len(covered[d]) >= total_blocks:
                node_finish[d] = now
            deliveries.append((now, nbytes[i]))
            g = grps[i]
            if g is not None:
                group_last[g] = max(group_last.get(g, 0.0), now)
            if i in repair_ids and now > repair_done:
                repair_done = now
            for j in children.get(i, ()):
                dep_left[j] -= 1
                if dep_left[j] == 0 and state[j] == F.WAITING:
                    state[j] = F.READY
                    heapq.heappush(ready, (prio[j], j))
            for r in resources[i]:
                for j in res_wait.pop(r, []):
                    if state[j] == F.BLOCKED:
                        state[j] = F.READY
                        heapq.heappush(ready, (prio[j], j))
            admit()

        stranded = [i for i in range(len(state))
                    if state[i] not in (F.DONE, F.CANCELLED)]
        assert not stranded, \
            f"{len(stranded)} tasks stranded under faults: {stranded[:5]}"
        report = FaultReport(
            events_applied=applied, aborted=aborted, retries=retried,
            cancelled=cancelled_n, repair_tasks=len(repair_ids),
            repaired=repaired_n, dead_nodes=tuple(sorted(fs.dead_nodes)),
            lost=tuple(sorted(set(lost_all))),
            incomplete=tuple(sorted(v for v in topo.compute_nodes
                                    if v not in fs.dead_nodes
                                    and v not in node_finish)),
            repair_latency=(repair_done - repair_t0)
            if repair_t0 is not None and repair_done > 0.0 else 0.0)
        gf = [group_last[g] for g in sorted(group_last)] if group_last else []
        return SimResult(finish_time=max(node_finish.values()),
                         node_finish=node_finish, deliveries=deliveries,
                         group_finish=gf, started=started,
                         completed=completed, faults=report)


def pipeline_tasks(pipe: Pipeline, packet_bytes: Sequence[float],
                   num_groups: int) -> List[SendTask]:
    """Expand a cyclic pipeline into dependent send tasks for m groups.

    Block id of packet (g, k) = g * K + k. Each tree edge (u, v) for packet
    (g, k) depends on the task that delivered (g, k) to u (absent for root).
    Priority = (group, round index) keeps the cyclic round order whenever
    resources allow.
    """
    K = len(pipe.trees)
    routes = getattr(pipe, "routes", None)
    tasks: List[SendTask] = []
    deliver: Dict[Tuple[int, int, int], int] = {}   # (node, g, k) -> task idx
    for g in range(num_groups):
        for ri, rnd in enumerate(pipe.rounds):
            for task in rnd:
                u, v = task.edge
                deps = []
                key = (u, g, task.tree)
                if key in deliver:
                    deps.append(deliver[key])
                elif u != pipe.trees[task.tree].root:
                    deps.append(-1)  # resolved below (sender task comes later)
                idx = len(tasks)
                blk = g * K + task.tree
                tasks.append(SendTask(priority=(g, ri, task.depth),
                                      src=u, dst=v,
                                      nbytes=packet_bytes[task.tree],
                                      deps=tuple(deps), blk=(blk, blk + 1),
                                      group=g,
                                      route=routes.get(task.edge)
                                      if routes else None))
                deliver[(v, g, task.tree)] = idx
    # second pass: resolve deps recorded as -1 (sender's delivery scheduled in
    # a *later* round index than the forward — legal in cyclic schedules, the
    # forward just slides to the next cycle)
    fixed: List[SendTask] = []
    for i, t in enumerate(tasks):
        if t.deps == (-1,):
            g = t.group
            k = t.blk[0] - g * K
            dep = deliver.get((t.src, g, k))
            assert dep is not None and dep != i, \
                f"no delivery of packet ({g},{k}) to node {t.src}"
            t = dataclasses.replace(t, deps=(dep,))
        fixed.append(t)
    return fixed


def thm2_delta_floor(d_measured: float, d_star: float) -> float:
    """The steady-state period used for Theorem-2 extrapolation: the measured
    Δ (last two group finishes of a simulated prefix) floored by the Δ*
    resource bound. A prefix that is still filling the pipeline measures a Δ
    below the steady state; Δ* (Def. 8) is a hard lower bound on the true
    period, so flooring can only improve the estimate. Both engines apply
    exactly this rule (asserted equal in tests)."""
    return max(d_measured, d_star)


def thm2_extrapolate(prefix_finish: float, m0: int, num_groups: int,
                     delta: float) -> float:
    """Theorem 2: T(m) = T(m0) + (m - m0) · Δ for the groups beyond the
    simulated prefix."""
    return prefix_finish + (num_groups - m0) * delta


def delta_star(topo: Topology, cm: ConflictModel, pipe: Pipeline,
               packet_bytes: Sequence[float]) -> float:
    """The paper's Δ* lower bound (Def. 8): allow all tree tasks active at
    once, then the steady-state period is at least the busiest intersecting
    group's total service time: max over resources r of
    sum_{tasks using r} (L_e + P_tree/B_e) / capacity(r)."""
    ct = cm.compiled()
    routes = getattr(pipe, "routes", None)
    load: Dict[Hashable, float] = {}
    caps: Dict[Hashable, int] = {}
    for rnd in pipe.rounds:
        for task in rnd:
            e = task.edge
            rt = routes.get(e) if routes else None
            if rt is not None:
                lat, bw = rt[1], rt[2]
                rs = cm.resources(e, links=rt[0])
            else:
                lat, bw = ct.edge_cost(e)
                rs = ct.resources(e)
            dur = lat + packet_bytes[task.tree] / bw
            for r in rs:
                load[r] = load.get(r, 0.0) + dur
                if r not in caps:
                    caps[r] = cm.capacity(r)
    return max((l / caps[r] for r, l in load.items()), default=0.0)


def simulate_pipeline(topo: Topology, cm: ConflictModel, pipe: Pipeline,
                      message_bytes: float, num_groups: int, root: int,
                      max_sim_groups=UNSET, engine=UNSET,
                      cycle_detect=UNSET,
                      cycle_scan_groups=UNSET,
                      cycle_hint=UNSET,
                      faults=UNSET,
                      *, config: Optional[SimConfig] = None,
                      ) -> Tuple[float, SimResult, float]:
    """Simulate a pipelined broadcast of `message_bytes` split into
    `num_groups` groups (each group split across trees by tree weights).

    Simulation options come from ``config=SimConfig(...)``; the individual
    keywords (``engine=``, ``faults=``, the cycle options, defaults
    unchanged) remain as a deprecated compatibility shim resolved through
    ``repro.core.simconfig.resolve_config`` — bit-identical results, one
    ``DeprecationWarning`` per process.

    Returns (total_time, sim_result, delta). When num_groups exceeds
    `max_sim_groups`, a prefix is simulated and Theorem 2 extrapolates:
    T(m) = T(m0) + (m - m0) * Δ with Δ floored by Δ* (``thm2_delta_floor``).
    Both engines apply the same estimate; the fast engine additionally

      * covers all groups analytically when its prefix was exactly periodic
        (extrapolated node finishes — exact for truly periodic schedules), and
      * returns the *exact* result for jittery schedules whose occupancy
        state provably cycles (``cycle_detect``; see
        ``repro.core.fastsim.CompiledSim.run_pipeline`` for the scan budget
        and the ``cycle_hint`` fast path). Schedules with no verified cycle
        fall back to exactly the reference estimate.

    With a non-empty ``faults`` schedule every analytic path is disabled
    (churn breaks the periodicity they rely on — see docs/engines.md): all
    ``num_groups`` groups are expanded and run through the chosen engine's
    fault-aware loop; the returned result carries ``SimResult.faults``.
    """
    cfg = resolve_config(config, max_sim_groups=max_sim_groups,
                         engine=engine, cycle_detect=cycle_detect,
                         cycle_scan_groups=cycle_scan_groups,
                         cycle_hint=cycle_hint, faults=faults)
    engine, faults = cfg.engine, cfg.faults
    max_sim_groups = cfg.max_sim_groups

    weights = [t.weight for t in pipe.trees]
    group_bytes = message_bytes / num_groups
    packet_bytes = [group_bytes * w for w in weights]

    if faults:
        sim = make_engine(topo, cm, root, engine)
        res = sim.run(pipeline_tasks(pipe, packet_bytes, num_groups),
                      total_blocks=num_groups * len(pipe.trees),
                      faults=faults)
        gf = res.group_finish
        d_meas = gf[-1] - gf[-2] if len(gf) >= 2 else 0.0
        return res.finish_time, res, d_meas

    if engine in ("fast", "kernel"):
        # the kernel engine has no pipeline path of its own: pipelines run
        # through the cycle-analytic machinery, which is (and stays) the
        # numpy engine — "kernel" here means the fast path, bit-identical
        from repro_torch.core.fastsim import CompiledSim
        run = CompiledSim(topo, cm, root).run_pipeline(
            pipe, packet_bytes, num_groups, max_sim_groups=max_sim_groups,
            cycle_detect=cfg.cycle_detect,
            cycle_scan_groups=cfg.cycle_scan_groups,
            cycle_hint=cfg.cycle_hint)
        if run.complete:
            return run.res.finish_time, run.res, run.delta
        delta = thm2_delta_floor(run.delta,
                                 delta_star(topo, cm, pipe, packet_bytes))
        total = thm2_extrapolate(run.res.finish_time, run.sim_groups,
                                 num_groups, delta)
        return total, run.res, delta
    if engine != "reference":
        raise ValueError(f"unknown engine {engine!r}")

    m0 = min(num_groups, max_sim_groups)
    sim = EventSimulator(topo, cm, root)
    res = sim.run(pipeline_tasks(pipe, packet_bytes, m0),
                  total_blocks=m0 * len(pipe.trees))
    d_meas = (res.group_finish[-1] - res.group_finish[-2]) if m0 >= 2 else 0.0
    if num_groups <= m0:
        return res.finish_time, res, d_meas
    delta = thm2_delta_floor(d_meas, delta_star(topo, cm, pipe, packet_bytes))
    total = thm2_extrapolate(res.finish_time, m0, num_groups, delta)
    return total, res, delta
