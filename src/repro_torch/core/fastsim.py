"""Round-batched flat-array engine for the discrete-event broadcast simulator.

``CompiledSim`` is a drop-in replacement for ``EventSimulator`` built around
the compiled routing layer (``repro.core.routing``):

  * generic task lists (``run`` = ``lower`` + ``run_lowered``) execute on a
    one-shot lowering (``repro.core.routing.CompiledTaskList``: admission
    ranks, dense resource-id CSR, precomputed Hockney durations, dependency
    fan-out) — re-runnable without re-paying the setup, which is what used
    to dominate the routed baselines; lists whose tail is a repeated
    per-segment pattern (the chain-pipeline family) fold into the same
    one-live-instance-per-template-task core that pipeline groups use, and
    ``run_task_list`` can extend the verified occupancy-cycle analytics to
    them (exact or full-sim fallback — never an estimate);
  * cyclic pipelines (``run_pipeline``) execute straight from the lowered
    one-group template (``Pipeline.compiled_template()`` ->
    ``repro.core.routing.CompiledTemplate``): task ``g*T + t`` is template
    task ``t`` of group ``g``, so per-run setup is O(T) arithmetic instead of
    O(m*T) Python object work (dependency/children CSR, admission ranks and
    durations all come from the template);
  * at every event time the admission pass first tries to admit the *entire*
    ready frontier at once: occupancy over the frontier's resource-id CSR is
    counted vectorized (``np.bincount`` on the dense resource vector) and, if
    every resource fits within capacity, all tasks start in rank order in one
    batch — bit-identical to the scalar greedy (every rank prefix of a
    feasible set is feasible), which remains the fallback under contention.

``run``/``run_pipeline`` replay the exact event schedule of the reference
engine — same priority ranks, same tie-breaking, same IEEE double
arithmetic — so full simulations are bit-identical (asserted in
tests/test_engine_equiv.py).

Beyond full simulation, ``run_pipeline`` has two steady-state paths:

  * **prefix pattern periodicity** (Theorem 2 estimate): once the per-group
    completion pattern of the simulated prefix repeats exactly, the total
    time, node finishes and Δ for the remaining groups follow analytically,
    with Δ floored by the paper's Δ* resource bound. Prefix periodicity is
    necessary but not sufficient for global periodicity (later groups can
    perturb earlier ones through resource contention), so this path carries
    the same approximation quality as the reference prefix-plus-Δ estimate;
    it is exact for genuinely periodic schedules such as chain pipelines.
  * **verified occupancy cycle** (exact): when the prefix never becomes
    pattern-periodic (branchy ``two_tree``/``lp_pack`` schedules), a scan run
    captures, at every group boundary, a signature of the engine state — the
    dense resource-occupancy vector, the in-flight task phases (template
    index, group offset, remaining time) in start order, and the blocked
    tasks by wait queue, all relative to the boundary group. A recurrence of
    this state at boundaries g1 < g2 makes periodicity *sufficient* in
    principle — the event loop is deterministic, so the future replays with
    period p = g2 - g1 — but pending far-future groups are summarized as
    "more of the same", and a regime that eats into them faster than one
    group per period (a root streaming ahead of the steady rate) dies when
    they run out. Candidates are therefore *verified* by three full base
    runs aligned to num_groups modulo p: adjacent runs of m_b and m_b + p
    groups must shift rigidly by Δp (total, per-node finishes, group-finish
    head and tail), and a far-anchor run E periods out must land exactly on
    the same line — which exposes the offset jump pseudo-cycles leave
    between their transient plateau and the true asymptote. Only then is
    the full result derived analytically (rel err at float-noise level,
    asserted against full reference runs in tests/test_cycle_detect.py);
    everything else falls back to the reference Δ*-floored estimate, never
    a silently different number.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from bisect import insort
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.intersection import ConflictModel
from repro_torch.core.routing import CompiledTaskList, CompiledTemplate
from repro_torch.core.schedule import Pipeline
from repro_torch.core.simulator import (SendTask, SimResult, delta_star,
                                  thm2_delta_floor)
from repro_torch.core.topology import Topology

# relative tolerance for "the pipeline period repeats exactly": generous vs
# float accumulation noise (~1e-16/op), far below real scheduling jitter (%)
_STEADY_RTOL = 1e-9

# verified-cycle tolerance: a true occupancy cycle reproduces shifted results
# to float noise (measured exactly 0.0 on the cyclic schedules in tests);
# pseudo-cycles miss by orders of magnitude more
_CYCLE_RTOL = 1e-12

# boundary-signature tolerance on in-flight remaining times, relative to the
# longest task duration: true recurrences agree to accumulation noise
# (~1e-16); the slowly-converging transients of branchy schedules still
# drift orders of magnitude faster per period and must not match
_SIG_RTOL = 1e-13

# cap on synthesized delivery records for extrapolated groups (memory guard;
# finish times and Δ stay exact, only rate_timeline falls back to the prefix)
_MAX_SYNTH_DELIVERIES = 500_000

# frontier size from which batched (vectorized) admission is attempted
_BATCH_MIN_READY = 24

# blocked-task horizon of the boundary signature, in groups: tasks blocked
# further ahead than this are summarized as "more of the same pending" (all
# groups' dep-free tasks enter the resource queues at t=0, so the far tail
# is uniform; only its presence, not its length, can matter before drain)
_SIG_HORIZON = 16


def _auto_scan_groups(T: int, m0: int) -> int:
    """Default occupancy-cycle scan budget in groups: generous on small
    templates (branchy test/bench fabrics settle within ~100 groups), tapered
    by template size so big fabrics never scan more than a few times the
    normal prefix cost."""
    return max(4 * m0, min(128, 16 + 12000 // max(T, 1)))


@dataclasses.dataclass
class CycleInfo:
    """A detected occupancy-state cycle of a cyclic pipeline.

    The engine state (resource occupancy + in-flight task phases) at group
    boundary ``start`` recurred ``period`` groups later, ``delta`` seconds
    apart (per-group steady Δ = delta / period). ``verified`` marks whether
    the exact shift check over two full base runs passed (only then is the
    analytic result exact); unverified instances are scan-only hints, e.g.
    recorded in plan artifacts to skip the scan on replay.
    """

    period: int
    delta: float
    start: int
    verified: bool = False


@dataclasses.dataclass
class TaskListRun:
    """Result of ``CompiledSim.run_task_list``.

    ``res`` always covers the whole list: fully simulated (the default — and
    the only option for lists with no foldable segment structure), or, when
    a segment budget was given and a verified occupancy cycle was found,
    derived analytically from base runs of the segment template
    (``cycle.verified``; exact — the same machinery, and the same exactness
    guarantee, as the pipeline cycle path: finish time, node finishes and
    group finishes are exact; the synthesized per-send delivery records are
    capped at ``_MAX_SYNTH_DELIVERIES`` like the pipeline paths, beyond
    which ``rate_timeline`` degrades to the base run's shape). There is no
    estimate path for task lists: the reference engine has no extrapolation
    semantics for them, so anything short of a verified cycle falls back to
    the complete simulation, never a silently different number.
    """

    res: SimResult
    sim_segments: int
    delta: float = 0.0
    cycle: Optional[CycleInfo] = None


@dataclasses.dataclass
class PipelineRun:
    """Result of ``CompiledSim.run_pipeline``.

    ``complete`` — ``res`` covers all requested groups: fully simulated,
    derived from a *verified* occupancy cycle (``cycle.verified``, exact), or
    (when ``steady`` is set) extrapolated from a prefix whose per-group
    completion pattern repeated exactly, with Δ floored by Δ* — the same
    Theorem-2 estimate the reference path computes, exact only when the
    schedule is genuinely periodic. Otherwise ``res`` is a
    ``sim_groups``-group prefix and the caller extrapolates.
    """

    res: SimResult
    sim_groups: int
    delta: float
    complete: bool
    steady: bool = False
    cycle: Optional[CycleInfo] = None


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One job of a multi-root workload run (``CompiledSim.run_jobs``): at
    ``arrival`` (simulated seconds) a broadcast of the lowered list ``ctl``
    rooted at ``root`` enters the fabric. The same ``ctl`` object may back
    several jobs — the engine keeps all mutable state per job."""

    arrival: float
    root: int
    ctl: CompiledTaskList
    job_id: int = 0


@dataclasses.dataclass
class JobRun:
    """Per-job outcome of ``CompiledSim.run_jobs``.

    ``start`` is the admission time of the job's first send (queueing delay
    = ``start - arrival``); ``finish`` the time its last node held the full
    message (the job's broadcast completion; degenerately ``arrival`` for a
    job with nothing to deliver). ``node_finish`` follows the single-run
    ``SimResult`` semantics with the job's root pinned at ``arrival``."""

    job_id: int
    arrival: float
    start: float
    finish: float
    node_finish: Dict[int, float]
    started: int
    completed: int

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    @property
    def queue_delay(self) -> float:
        return self.start - self.arrival


@dataclasses.dataclass
class MultiJobRun:
    """Result of ``CompiledSim.run_jobs``: per-job outcomes in arrival order
    plus fabric-wide totals (and one aggregated ``FaultReport`` when a churn
    schedule was injected)."""

    jobs: List["JobRun"]
    makespan: float          # last job finish - first job arrival
    started: int
    completed: int
    faults: Optional["FaultReport"] = None


class CompiledSim:
    """Resource-constrained simulation of dependent sends on flat arrays."""

    engine = "fast"

    def __init__(self, topo: Topology, cm: ConflictModel, root: int):
        self.topo = topo
        self.cm = cm
        self.root = root
        self.idx = cm.compiled()

    # -- generic task lists (drop-in for EventSimulator.run) -----------------

    def lower(self, tasks: Sequence[SendTask],
              total_blocks: Optional[int] = None,
              detect_segments: bool = True) -> CompiledTaskList:
        """One-shot lowering of ``tasks`` onto the compiled resource layer
        (``repro.core.routing.CompiledTaskList``): admission ranks, resource
        CSR, durations, dependency fan-out, segment detection. The result is
        reusable across runs — cache it (or let
        ``repro.core.baselines.lower_baseline`` do so) to stop paying the
        per-call setup that dominates short task-list simulations."""
        return self.idx.lower_tasks(tasks, total_blocks,
                                    detect_segments=detect_segments)

    def run(self, tasks: Sequence[SendTask],
            total_blocks: Optional[int] = None,
            faults=None) -> SimResult:
        """Same semantics (and event order) as ``EventSimulator.run``.

        One-shot: the lowering is built, used once and dropped, so the
        segment-periodicity scan (whose fold only pays off for lowerings
        that are kept) is skipped. Callers that re-run a list should
        ``lower()`` once and ``run_lowered`` it instead.

        A non-empty ``faults`` schedule (``repro.core.faults.FaultSchedule``)
        de-folds the whole run onto the contended scalar fault loop
        (``_run_faulty``) — folding, batch admission and both analytic
        steady-state paths assume the static fabric that churn breaks. An
        empty/None schedule changes nothing (bit-identical to before)."""
        if faults:
            return self._run_faulty(tasks, total_blocks, faults)
        return self.run_lowered(self.lower(tasks, total_blocks,
                                           detect_segments=False))

    def run_lowered(self, ctl: CompiledTaskList) -> SimResult:
        """Run a lowered task list (no per-call setup; ``ctl`` is not
        mutated and may be shared across engines of the same model).

        Fold-eligible segmented lists (``ctl.seg.foldable``) execute through
        a folded instance core: the *pure* subclass (the chain pipeline
        family) through the template core — one live instance per
        segment-template task, vectorized whole-frontier admission, the
        identical event schedule as the generic loop (the template folding
        argument verbatim — instances of one template task share resources
        and durations and are admitted strictly in segment order) — and the
        extended class (prefix region + prev-segment dependency chains,
        srda's ring allgather) through the folded-list loop
        (``_run_folded_list``), same argument with the prefix tasks as
        scalar participants. Everything else takes the generic flat-array
        loop."""
        ctl.bind(self.idx)
        seg = ctl.seg
        if seg is not None and seg.foldable:
            if seg.pure and seg.cover_bad <= {self.root}:
                tpl, durs, nb = ctl.fold_template(self.idx)
                res, _, _ = self._run_template(tpl, durs, nb, seg.q)
                if not ctl.has_groups:
                    res = dataclasses.replace(res, group_finish=[])
                return res
            return self._run_folded_list(ctl)
        return self._run_generic(ctl)

    def run_task_list(self, tasks: Optional[Sequence[SendTask]] = None, *,
                      lowered: Optional[CompiledTaskList] = None,
                      total_blocks: Optional[int] = None,
                      max_sim_segments: Optional[int] = None,
                      cycle_scan_segments: Optional[int] = None,
                      ) -> TaskListRun:
        """Run a task list with the segment-analytic machinery enabled.

        When the list folds into ``q`` segment-template instances and ``q``
        exceeds ``max_sim_segments``, the verified occupancy-cycle detector
        (the exact pipeline path of ``run_pipeline``, applied to the segment
        template) may derive the result analytically from base runs aligned
        to ``q`` modulo the cycle period; a list whose cycle never verifies
        is simulated completely — the honest fallback, since no reference
        estimate semantics exist for task lists. ``max_sim_segments=None``
        (the default, and what ``simulate_baseline`` uses unless asked)
        always simulates completely."""
        ctl = lowered if lowered is not None else self.lower(tasks,
                                                             total_blocks)
        ctl.bind(self.idx)
        seg = ctl.seg
        # only the pure fold subclass is analytics-eligible: the segment
        # template alone replays an extended (prefix-region) list's schedule
        # incorrectly — prefix tasks contend with the early segments — so
        # those lists always simulate completely (through the folded loop)
        pure = seg is not None and seg.pure and seg.cover_bad <= {self.root}
        if not pure or max_sim_segments is None \
                or seg.q <= max(2, max_sim_segments):
            res = self.run_lowered(ctl)
            gf = res.group_finish
            folded = seg is not None and seg.foldable
            return TaskListRun(res=res, sim_segments=seg.q if folded else 0,
                               delta=gf[-1] - gf[-2] if len(gf) >= 2 else 0.0)
        tpl, durs, nb = ctl.fold_template(self.idx)
        run = self._cycle_exact(tpl, durs, nb, seg.q,
                                max(2, max_sim_segments),
                                cycle_scan_segments, None)
        if run is None:
            res, _, _ = self._run_template(tpl, durs, nb, seg.q)
            gf = res.group_finish
            run = PipelineRun(res=res, sim_groups=seg.q, complete=True,
                              delta=gf[-1] - gf[-2] if seg.q >= 2 else 0.0)
        res = run.res
        if not ctl.has_groups:
            res = dataclasses.replace(res, group_finish=[])
        return TaskListRun(res=res, sim_segments=run.sim_groups,
                           delta=run.delta, cycle=run.cycle)

    def _run_generic(self, ctl: CompiledTaskList) -> SimResult:
        """The generic flat-array event loop over a lowered list — the exact
        reference event schedule (same ranks, ties, IEEE arithmetic), with
        batched whole-frontier admission on wide frontiers.

        Contended-path contract (stated once here; the folded-list and
        fault loops follow it too): a task that finds any resource at
        capacity parks on the *first* busy resource only. While that
        resource stays busy, every wake the reference performs — on the
        other busy resources' frees — fails admission right back here, so
        the admitted set at every event, and hence the entire schedule, is
        unchanged; what is saved is re-blocking long wait queues across k
        resources per task. (``_run_template`` is the deliberate exception:
        its fold keeps wait queues at one live instance per template task,
        so it parks on every busy resource like the reference — see its
        docstring.)"""
        idx = self.idx
        n = ctl.n
        total_blocks = ctl.total_blocks
        rank = ctl.rank
        res_ids = ctl.res_ids
        durs = ctl.durs
        nbytes = ctl.nbytes
        dsts = ctl.dst
        blks = ctl.blks
        grps = ctl.grps
        children = ctl.children
        dep_left = list(ctl.dep_n)
        # all-fresh lists (proven at lowering: every (node, block) delivered
        # at most once) take a pure per-node countdown; the bitmap path
        # remains for lists with duplicate deliveries
        spans = ctl.spans if ctl.all_fresh else None

        # state codes: 0 waiting, 1 ready, 2 blocked, 3 running, 4 done
        state = bytearray(n)
        ready: List[Tuple[int, int]] = []
        for i in range(n):
            if not dep_left[i]:
                state[i] = 1
                ready.append((rank[i], i))
        heapq.heapify(ready)

        caps = idx.caps
        busy = [0] * idx.num_resources()
        res_wait: List[Optional[List[int]]] = [None] * len(busy)
        nn = self.topo.num_nodes
        root = self.root
        remaining = [total_blocks] * nn
        remaining[root] = 0
        seen: List[Optional[bytearray]] = [None] * nn
        node_finish: Dict[int, float] = {root: 0.0}
        deliveries: List[Tuple[float, float]] = []
        group_last: Dict[int, float] = {}
        events: List[Tuple[float, int, int]] = []
        seq = 0
        now = 0.0
        started = 0
        push = heapq.heappush
        pop = heapq.heappop
        deliver = deliveries.append

        csr: List[Optional[_ResourceCSR]] = [None]   # built on first batch

        def admit() -> None:
            nonlocal seq, started, busy
            if len(ready) >= _BATCH_MIN_READY:
                if csr[0] is None:
                    csr[0] = _ResourceCSR.from_arrays(
                        ctl.res_indptr, ctl.res_flat, caps)
                batch = csr[0].feasible([i for _, i in ready], busy)
                if batch is not None:
                    busy = batch
                    for _, i in sorted(ready):
                        push(events, (now + durs[i], seq, i))
                        seq += 1
                        state[i] = 3
                    started += len(ready)
                    ready.clear()
                    return
            while ready:
                _, i = pop(ready)
                if state[i] != 1:
                    continue
                rs = res_ids[i]
                blocked = -1
                for r in rs:
                    if busy[r] >= caps[r]:
                        blocked = r
                        break
                if blocked >= 0:
                    # the contended-path contract (docstring above): park on
                    # the first busy resource only
                    state[i] = 2
                    w = res_wait[blocked]
                    if w is None:
                        res_wait[blocked] = [i]
                    else:
                        w.append(i)
                    continue
                for r in rs:
                    busy[r] += 1
                push(events, (now + durs[i], seq, i))
                seq += 1
                started += 1
                state[i] = 3

        admit()
        completed = 0
        while events:
            now, _, i = pop(events)
            state[i] = 4
            completed += 1
            rs = res_ids[i]
            for r in rs:
                busy[r] -= 1
            d = dsts[i]
            rem = remaining[d]
            if rem > 0:
                if spans is not None:
                    rem -= spans[i]
                    remaining[d] = rem
                    if rem <= 0 and d not in node_finish:
                        node_finish[d] = now
                else:
                    sb = seen[d]
                    if sb is None:
                        sb = seen[d] = bytearray(total_blocks)
                    fresh = 0
                    for b in range(*blks[i]):
                        if not sb[b]:
                            sb[b] = 1
                            fresh += 1
                    if fresh:
                        rem -= fresh
                        remaining[d] = rem
                        if rem <= 0 and d not in node_finish:
                            node_finish[d] = now
            deliver((now, nbytes[i]))
            g = grps[i]
            if g is not None:
                prev = group_last.get(g)
                if prev is None or now > prev:
                    group_last[g] = now
            ch = children[i]
            if ch is not None:
                for j in ch:
                    dl = dep_left[j] - 1
                    dep_left[j] = dl
                    if not dl and state[j] == 0:
                        state[j] = 1
                        push(ready, (rank[j], j))
            for r in rs:
                w = res_wait[r]
                if w is not None:
                    res_wait[r] = None
                    for j in w:
                        if state[j] == 2:
                            state[j] = 1
                            push(ready, (rank[j], j))
            admit()

        assert completed == n, \
            f"{n - completed} tasks never ran — dependency cycle"
        missing = [v for v in range(nn) if remaining[v] > 0]
        assert not missing, f"nodes {missing[:5]} never got the full message"
        gf = [group_last[g] for g in sorted(group_last)] if group_last else []
        return SimResult(finish_time=max(node_finish.values()),
                         node_finish=node_finish, deliveries=deliveries,
                         group_finish=gf, started=started,
                         completed=completed)

    def _run_folded_list(self, ctl: CompiledTaskList) -> SimResult:
        """Folded execution of an extended fold-eligible list: a prefix
        region plus ``q`` instances of one ``seg_len``-task segment, with
        dependency chains into the previous segment (srda's ring allgather
        is the canonical shape). The scheduling state is one live instance
        per segment-template position plus the prefix tasks as scalar
        participants — O(prefix + seg_len) instead of O(n).

        Event order is the generic loop's verbatim: same admission ranks,
        same park-on-first-busy-resource semantics, same (time, seq)
        completion ties. The fold is sound because instances of one
        position share resources and durations and their admission ranks
        are segment-major (rank of instance s+1 = rank of instance s +
        seg_len, proven at lowering), so instance s+1 can never be admitted
        before instance s: materializing it only when instance s starts
        preserves the admitted set — and hence the whole schedule — at
        every event (bit-identity asserted in tests/test_engine_equiv.py).
        """
        idx = self.idx
        seg = ctl.seg
        P, T, q = seg.prefix, seg.seg_len, seg.q
        n = ctl.n
        total_blocks = ctl.total_blocks
        rank = ctl.rank
        res_ids = ctl.res_ids
        durs = ctl.durs
        nbytes = ctl.nbytes
        dsts = ctl.dst
        blks = ctl.blks
        grps = ctl.grps
        children = ctl.children
        dep_kind, dep_src = ctl.fold_layout()
        spans = ctl.spans if ctl.all_fresh else None

        # template positions that wake when an instance of position t (or
        # the prefix task feeding position t's first instance) completes
        intra_children: List[List[int]] = [[] for _ in range(T)]
        prev_children: List[List[int]] = [[] for _ in range(T)]
        for t in range(T):
            if dep_kind[t] == 1:
                intra_children[dep_src[t]].append(t)
            elif dep_kind[t] == 2:
                prev_children[dep_src[t]].append(t)

        # prefix tasks: individual state (codes as in the generic loop)
        pstate = bytearray(P)
        dep_left = list(ctl.dep_n[:P])
        pdone = bytearray(P)
        # template positions: cur[t] = the live (not yet started) instance,
        # done_cnt[t] = completed instances (completions of one position are
        # in segment order: equal durations + segment-major admission);
        # tstate[t] codes the live instance: 0 waiting, 1 ready, 2 parked
        cur = [0] * T
        done_cnt = [0] * T
        tstate = bytearray(T)

        def dep_ok(t: int, s: int) -> bool:
            k = dep_kind[t]
            if k == 0:
                return True
            if k == 1:
                return done_cnt[dep_src[t]] >= s + 1
            if s == 0:
                return pdone[P + dep_src[t] - T] == 1
            return done_cnt[dep_src[t]] >= s

        ready: List[Tuple[int, int]] = []
        for i in range(P):
            if not dep_left[i]:
                pstate[i] = 1
                ready.append((rank[i], i))
        for t in range(T):
            if dep_ok(t, 0):
                tstate[t] = 1
                ready.append((rank[P + t], P + t))
        heapq.heapify(ready)

        caps = idx.caps
        busy = [0] * idx.num_resources()
        res_wait: List[Optional[List[int]]] = [None] * len(busy)
        nn = self.topo.num_nodes
        root = self.root
        remaining = [total_blocks] * nn
        remaining[root] = 0
        seen: List[Optional[bytearray]] = [None] * nn
        node_finish: Dict[int, float] = {root: 0.0}
        deliveries: List[Tuple[float, float]] = []
        group_last: Dict[int, float] = {}
        events: List[Tuple[float, int, int]] = []
        seq = 0
        now = 0.0
        started = 0
        push = heapq.heappush
        pop = heapq.heappop
        deliver = deliveries.append

        def live(i: int) -> int:
            """Decode a heap/wait entry: -1 for a stale one, else the
            template position (or the prefix index, < P, as-is)."""
            if i < P:
                return i
            t = (i - P) % T
            return t if cur[t] * T + t == i - P else -1

        def admit() -> None:
            nonlocal seq, started
            while ready:
                _, i = pop(ready)
                if i < P:
                    if pstate[i] != 1:
                        continue
                    rs = res_ids[i]
                else:
                    t = live(i)
                    if t < 0 or tstate[t] != 1:
                        continue
                    rs = res_ids[P + t]   # every instance shares them
                blocked = -1
                for r in rs:
                    if busy[r] >= caps[r]:
                        blocked = r
                        break
                if blocked >= 0:
                    # the contended-path contract (see _run_generic): park
                    # on the first busy resource only
                    if i < P:
                        pstate[i] = 2
                    else:
                        tstate[t] = 2
                    w = res_wait[blocked]
                    if w is None:
                        res_wait[blocked] = [i]
                    else:
                        w.append(i)
                    continue
                for r in rs:
                    busy[r] += 1
                push(events, (now + durs[i], seq, i))
                seq += 1
                started += 1
                if i < P:
                    pstate[i] = 3
                else:
                    # the position's next instance materializes now: it
                    # ranks seg_len above this one, so the heap still pops
                    # this admission pass in exact global rank order
                    s = cur[t] = cur[t] + 1
                    if s < q:
                        if dep_ok(t, s):
                            tstate[t] = 1
                            push(ready, (rank[i + T], i + T))
                        else:
                            tstate[t] = 0
                    else:
                        tstate[t] = 0

        admit()
        completed = 0
        while events:
            now, _, i = pop(events)
            completed += 1
            rs = res_ids[i] if i < P else res_ids[P + (i - P) % T]
            for r in rs:
                busy[r] -= 1
            d = dsts[i]
            rem = remaining[d]
            if rem > 0:
                if spans is not None:
                    rem -= spans[i]
                    remaining[d] = rem
                    if rem <= 0 and d not in node_finish:
                        node_finish[d] = now
                else:
                    sb = seen[d]
                    if sb is None:
                        sb = seen[d] = bytearray(total_blocks)
                    fresh = 0
                    for b in range(*blks[i]):
                        if not sb[b]:
                            sb[b] = 1
                            fresh += 1
                    if fresh:
                        rem -= fresh
                        remaining[d] = rem
                        if rem <= 0 and d not in node_finish:
                            node_finish[d] = now
            deliver((now, nbytes[i]))
            g = grps[i]
            if g is not None:
                prev = group_last.get(g)
                if prev is None or now > prev:
                    group_last[g] = now
            if i < P:
                pstate[i] = 4
                pdone[i] = 1
                ch = children[i]
                if ch is not None:
                    for j in ch:
                        if j < P:
                            dl = dep_left[j] - 1
                            dep_left[j] = dl
                            if not dl and pstate[j] == 0:
                                pstate[j] = 1
                                push(ready, (rank[j], j))
                        else:
                            # the first instance of a position whose
                            # prev-segment chain starts at this prefix task
                            t = j - P
                            if cur[t] == 0 and tstate[t] == 0:
                                tstate[t] = 1
                                push(ready, (rank[j], j))
            else:
                tc = (i - P) % T
                done_cnt[tc] += 1
                for t in intra_children[tc]:
                    s = cur[t]
                    if s < q and tstate[t] == 0 and dep_ok(t, s):
                        tstate[t] = 1
                        push(ready, (rank[P + s * T + t], P + s * T + t))
                for t in prev_children[tc]:
                    s = cur[t]
                    if s < q and tstate[t] == 0 and dep_ok(t, s):
                        tstate[t] = 1
                        push(ready, (rank[P + s * T + t], P + s * T + t))
            for r in rs:
                w = res_wait[r]
                if w is not None:
                    res_wait[r] = None
                    for j in w:
                        if j < P:
                            if pstate[j] == 2:
                                pstate[j] = 1
                                push(ready, (rank[j], j))
                        else:
                            t = live(j)
                            if t >= 0 and tstate[t] == 2:
                                tstate[t] = 1
                                push(ready, (rank[j], j))
            admit()

        assert completed == n, \
            f"{n - completed} tasks never ran — dependency cycle"
        missing = [v for v in range(nn) if remaining[v] > 0]
        assert not missing, f"nodes {missing[:5]} never got the full message"
        gf = [group_last[g] for g in sorted(group_last)] if group_last else []
        return SimResult(finish_time=max(node_finish.values()),
                         node_finish=node_finish, deliveries=deliveries,
                         group_finish=gf, started=started,
                         completed=completed)

    # -- fault-aware runs ----------------------------------------------------

    def _run_faulty(self, tasks: Sequence[SendTask],
                    total_blocks: Optional[int], faults) -> SimResult:
        """The de-folded scalar fault loop — ``EventSimulator._run_faulty``
        on flat arrays and dense resource ids.

        Identical admission order (ready heap keyed ``(priority, index)``),
        identical control-event handling (shared ``repro.core.faults`` heap
        and ``plan_repair``), first-busy-resource blocking only (the
        contended-path contract stated in ``_run_generic``; fault-driven
        in-flight aborts wake blocked tasks the same way completions do,
        and fail admission the same way while the parked resource is busy).
        Folding, batch admission and countdown coverage stay off: fault
        events invalidate the static preconditions they were proven under.
        Bit-identity with the oracle is asserted in tests/test_faults.py."""
        from repro_torch.core import faults as F
        idx = self.idx
        topo = self.topo
        root = self.root
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

        res_ids: List[Tuple[int, ...]] = []
        durs: List[float] = []
        for t in tasks:
            e = (t.src, t.dst)
            rt = getattr(t, "route", None)
            if rt is not None:
                # pinned route (relabeled plans): resolve resources/cost from
                # the override, matching the reference loop bit for bit
                res_ids.append(tuple(
                    idx.intern(r) for r in idx.cm.resources(e, links=rt[0])))
                lat, bw = rt[1], rt[2]
            else:
                res_ids.append(idx.edge_ids(e))
                lat, bw = idx.edge_cost(e)
            durs.append(lat + t.nbytes / bw)
        caps = idx.caps
        busy = [0] * len(caps)
        res_wait: List[Optional[List[int]]] = [None] * len(caps)

        dep_left = [len(ds) for ds in deps]
        children: Dict[int, List[int]] = {}
        for i, ds in enumerate(deps):
            for d in ds:
                children.setdefault(d, []).append(i)

        state = bytearray(len(tasks))
        ready: List[Tuple[Tuple, int]] = []
        for i in range(len(tasks)):
            if dep_left[i] == 0:
                state[i] = F.READY
                ready.append((prio[i], i))
        heapq.heapify(ready)

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
        push = heapq.heappush
        pop = heapq.heappop

        def admit() -> None:
            nonlocal seq, started
            while ready:
                _, i = pop(ready)
                if state[i] != F.READY:
                    continue
                if not fs.edge_alive(src[i], dst[i]):
                    state[i] = F.SUSPENDED
                    suspended.append(i)
                    continue
                rs = res_ids[i]
                blocked = -1
                for r in rs:
                    if busy[r] >= caps[r]:
                        blocked = r
                        break
                if blocked >= 0:
                    state[i] = F.BLOCKED
                    w = res_wait[blocked]
                    if w is None:
                        res_wait[blocked] = [i]
                    else:
                        w.append(i)
                    continue
                for r in rs:
                    busy[r] += 1
                push(events, (now + durs[i], seq, i))
                seq += 1
                started += 1
                state[i] = F.RUNNING

        def free_and_wake(rs: Tuple[int, ...]) -> None:
            for r in rs:
                busy[r] -= 1
            for r in rs:
                w = res_wait[r]
                if w is not None:
                    res_wait[r] = None
                    for j in w:
                        if state[j] == F.BLOCKED:
                            state[j] = F.READY
                            push(ready, (prio[j], j))

        def apply_control(op) -> None:
            nonlocal ctrl_seq, applied, aborted, cancelled_n, repaired_n, \
                retried, repair_t0, busy, res_wait
            kind = op[0]
            if kind == "retry":
                i = op[1]
                if state[i] == F.ABORTED:
                    state[i] = F.READY
                    retried += 1
                    push(ready, (prio[i], i))
                return
            if kind == "heal_link":
                fs.heal_link(op[1])
                wake = sorted(suspended)
                suspended.clear()
                for i in wake:
                    if state[i] == F.SUSPENDED:
                        state[i] = F.READY
                        push(ready, (prio[i], i))
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
                state[i] = F.ABORTED
                aborted += 1
                free_and_wake(res_ids[i])
                push(ctrl, (now + faults.retry_timeout, ctrl_seq,
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
                e = (rt.src, rt.dst)
                res_ids.append(idx.edge_ids(e))     # may intern new resources
                lat, bw = idx.edge_cost(e)
                durs.append(lat + rt.nbytes / bw)
                extra = len(caps) - len(busy)
                if extra > 0:
                    busy.extend([0] * extra)
                    res_wait.extend([None] * extra)
                dl = sum(1 for d in rt.deps if state[d] != F.DONE)
                dep_left.append(dl)
                for d in rt.deps:
                    children.setdefault(d, []).append(i)
                repair_ids.add(i)
                state.append(F.READY if dl == 0 else F.WAITING)
                if dl == 0:
                    push(ready, (prio[i], i))
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
                    push(ready, (prio[j], j))

        admit()
        while True:
            next_t = events[0][0] if events else math.inf
            while ctrl and ctrl[0][0] <= next_t:
                t_c, _, op = pop(ctrl)
                if t_c > now:
                    now = t_c
                apply_control(op)
                admit()
                next_t = events[0][0] if events else math.inf
            if not events:
                if ctrl:
                    continue
                break
            now, _, i = pop(events)
            if state[i] != F.RUNNING:
                continue               # aborted/cancelled mid-flight
            state[i] = F.DONE
            completed += 1
            rs = res_ids[i]
            for r in rs:
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
                    push(ready, (prio[j], j))
            for r in rs:
                w = res_wait[r]
                if w is not None:
                    res_wait[r] = None
                    for j in w:
                        if state[j] == F.BLOCKED:
                            state[j] = F.READY
                            push(ready, (prio[j], j))
            admit()

        stranded = [i for i in range(len(state))
                    if state[i] not in (F.DONE, F.CANCELLED)]
        assert not stranded, \
            f"{len(stranded)} tasks stranded under faults: {stranded[:5]}"
        from repro_torch.core.faults import FaultReport
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

    # -- concurrent multi-job workloads --------------------------------------

    def run_jobs(self, specs: Sequence[JobSpec], faults=None) -> MultiJobRun:
        """Execute several broadcast jobs concurrently on one shared
        compiled resource layer.

        Jobs arrive online — arrival events ride the shared
        ``repro.core.faults`` control heap and apply strictly before task
        completions at equal times, exactly like kill/heal events — and
        contend per resource through one shared
        ``repro.core.routing.Occupancy``: the admission discipline that
        arbitrates tasks of a single run arbitrates tasks of different jobs
        unchanged. The scheduling policy is FCFS across jobs, admission rank
        within a job: the ready heap is keyed ``(job, rank, task)`` with
        jobs ordered by ``(arrival, job_id)``, so an earlier job's ready
        tasks get first pick of free resources at every admission pass and a
        later job's fill whatever remains — work-conserving, no reservation.

        A run with a single job arriving at t=0 replays the exact event
        schedule of ``run_lowered``'s generic loop (scalar greedy admission
        throughout — the batched path is bit-identical to it anyway), hence
        of ``EventSimulator.run`` — asserted in tests/test_workload.py.

        A non-empty ``faults`` schedule merges kill/heal events into the
        same control heap and runs the de-folded fault discipline of
        ``_run_faulty`` per job: in-flight aborts and retry wakes,
        suspension on transiently dead routes, per-job
        ``repro.core.faults.plan_repair`` re-grafting at every kill — and at
        job arrival, so a job entering an already-damaged fabric is grafted
        around the permanent damage at admission time. Ready keys use
        per-job admission ranks as priorities; repair hops slot in at
        ``(rank, 1, hop)`` directly after the task they replace. The
        aggregated ``FaultReport`` sums counters over jobs and concatenates
        per-job ``lost`` (node, block) pairs (the same pair may appear once
        per affected job); ``incomplete`` is the union over jobs.
        """
        from repro_torch.core import faults as F
        idx = self.idx
        topo = self.topo
        nn = topo.num_nodes
        specs = sorted(specs, key=lambda s: (s.arrival, s.job_id))
        nj = len(specs)
        for sp in specs:
            sp.ctl.bind(idx)
        occ = idx.occupancy()
        busy = occ.busy
        res_wait = occ.wait
        caps = idx.caps

        faulty = bool(faults)
        if faulty:
            fs = F.FaultState(topo)
            ctrl, ctrl_seq = F.control_heap(faults)
            retry_mode = faults.in_flight == F.RETRY
        else:
            fs = None
            ctrl, ctrl_seq = [], 0
        for j, sp in enumerate(specs):
            ctrl.append((sp.arrival, ctrl_seq, ("job", j, 0.0)))
            ctrl_seq += 1
        heapq.heapify(ctrl)

        # per-job task arrays: views of the lowered lists (clean mode) or
        # mutable copies the repair planner may grow (fault mode, filled at
        # activation). State codes share the fault module's WAITING..DONE =
        # 0..4 prefix, so both modes read the same numerics.
        active = [False] * nj
        jn = [sp.ctl.n for sp in specs]
        jtb = [sp.ctl.total_blocks for sp in specs]
        jsrc: List[Optional[list]] = [None] * nj
        jdst = [sp.ctl.dst for sp in specs]
        jnb = [sp.ctl.nbytes for sp in specs]
        jblks = [sp.ctl.blks for sp in specs]
        jdurs = [sp.ctl.durs for sp in specs]
        jres = [sp.ctl.res_ids for sp in specs]
        jrank = [sp.ctl.rank for sp in specs]
        jspans = [sp.ctl.spans if sp.ctl.all_fresh else None for sp in specs]
        jdep: List[Optional[list]] = [None] * nj
        jchild: List = [None] * nj
        jstate = [bytearray(n) for n in jn]
        jprio: List[Optional[list]] = [None] * nj      # fault mode only
        jtt: List = [None] * nj                        # fault mode only
        jcov: List = [None] * nj                       # fault: node -> set
        jrem: List[Optional[list]] = [None] * nj       # clean countdown
        jseen: List = [None] * nj                      # clean bitmap path
        jnf: List[Dict[int, float]] = [dict() for _ in specs]
        jstart: List[Optional[float]] = [None] * nj
        jstarted = [0] * nj
        jcomp = [0] * nj
        jlost: List[set] = [set() for _ in specs]

        ready: list = []            # (job, key, task) — FCFS across jobs
        events: list = []           # (time, seq, job, task)
        suspended: List[Tuple[int, int]] = []
        repair_ids: set = set()
        seq = 0
        now = 0.0
        applied = aborted = retried = cancelled_n = repaired_n = 0
        damage = False
        repair_t0: Optional[float] = None
        repair_done = 0.0
        push = heapq.heappush
        pop = heapq.heappop

        if faulty:
            def rkey(j: int, i: int):
                return (j, jprio[j][i], i)
        else:
            def rkey(j: int, i: int):
                return (j, jrank[j][i], i)

        def admit() -> None:
            nonlocal seq
            while ready:
                j, _, i = pop(ready)
                state = jstate[j]
                if state[i] != 1:
                    continue
                if faulty and not fs.edge_alive(jsrc[j][i], jdst[j][i]):
                    state[i] = F.SUSPENDED
                    suspended.append((j, i))
                    continue
                rs = jres[j][i]
                blocked = -1
                for r in rs:
                    if busy[r] >= caps[r]:
                        blocked = r
                        break
                if blocked >= 0:
                    state[i] = 2
                    w = res_wait[blocked]
                    if w is None:
                        res_wait[blocked] = [(j, i)]
                    else:
                        w.append((j, i))
                    continue
                for r in rs:
                    busy[r] += 1
                push(events, (now + jdurs[j][i], seq, j, i))
                seq += 1
                jstarted[j] += 1
                if jstart[j] is None:
                    jstart[j] = now
                state[i] = 3

        def free_and_wake(rs) -> None:
            for r in rs:
                busy[r] -= 1
            for r in rs:
                w = res_wait[r]
                if w is not None:
                    res_wait[r] = None
                    for j2, i2 in w:
                        if jstate[j2][i2] == 2:
                            jstate[j2][i2] = 1
                            push(ready, rkey(j2, i2))

        def repair_job(j: int) -> None:
            nonlocal cancelled_n, repaired_n, repair_t0
            state = jstate[j]
            pending = [i for i in range(len(state))
                       if state[i] in F.PENDING_STATES]
            plan = F.plan_repair(fs, jtt[j], pending, jcov[j], specs[j].root)
            if plan is None:
                return
            if repair_t0 is None:
                repair_t0 = now
            for i in plan.cancelled:
                state[i] = F.CANCELLED
            cancelled_n += len(plan.cancelled)
            repaired_n += plan.repaired
            jlost[j].update(plan.lost)
            tt = jtt[j]
            res = jres[j]
            durs = jdurs[j]
            dep_left = jdep[j]
            children = jchild[j]
            for rt in plan.new_tasks:
                i = tt.append(rt)
                e = (rt.src, rt.dst)
                res.append(idx.edge_ids(e))     # may intern new resources
                lat, bw = idx.edge_cost(e)
                durs.append(lat + rt.nbytes / bw)
                occ.grow()
                dl = sum(1 for d in rt.deps if state[d] != 4)
                dep_left.append(dl)
                for d in rt.deps:
                    children.setdefault(d, []).append(i)
                repair_ids.add((j, i))
                state.append(1 if dl == 0 else 0)
                if dl == 0:
                    push(ready, rkey(j, i))
            deps = tt.deps
            for i2 in sorted(plan.rewires):
                nd = plan.rewires[i2]
                old = set(deps[i2])
                deps[i2] = nd
                for d in nd:
                    if d not in old:
                        children.setdefault(d, []).append(i2)
                dep_left[i2] = sum(1 for d in nd if state[d] != 4)
                if dep_left[i2] == 0 and state[i2] == 0:
                    state[i2] = 1
                    push(ready, rkey(j, i2))

        def activate(j: int) -> None:
            sp = specs[j]
            ctl = sp.ctl
            root = sp.root
            active[j] = True
            jnf[j][root] = sp.arrival
            if faulty:
                src = jsrc[j] = list(ctl.src)
                dst = jdst[j] = list(ctl.dst)
                nb = jnb[j] = list(ctl.nbytes)
                blks = jblks[j] = list(ctl.blks)
                jdurs[j] = list(ctl.durs)
                jres[j] = list(ctl.res_ids)
                prio = jprio[j] = [(r,) for r in ctl.rank]
                deps = [tuple(ds) for ds in ctl.deps]
                jtt[j] = F.TaskTable(src, dst, nb, blks, list(ctl.grps),
                                     prio, deps)
                cov = jcov[j] = {v: set() for v in topo.compute_nodes}
                cov[root] = set(range(jtb[j]))
                children: Dict[int, List[int]] = {}
                for i, ds in enumerate(deps):
                    for d in ds:
                        children.setdefault(d, []).append(i)
                jchild[j] = children
            else:
                jsrc[j] = ctl.src
                rem = [jtb[j]] * nn
                rem[root] = 0
                jrem[j] = rem
                jchild[j] = ctl.children
            jdep[j] = list(ctl.dep_n)
            state = jstate[j]
            for i in range(jn[j]):
                if not jdep[j][i]:
                    state[i] = 1
                    push(ready, rkey(j, i))
            if faulty and damage:
                # the fabric broke before this job arrived: graft its plan
                # around the permanent damage at admission time
                repair_job(j)

        def apply_control(op) -> None:
            nonlocal ctrl_seq, applied, aborted, retried, damage
            kind = op[0]
            if kind == "job":
                activate(op[1])
                return
            if kind == "retry":
                j, i = op[1]
                if jstate[j][i] == F.ABORTED:
                    jstate[j][i] = 1
                    retried += 1
                    push(ready, rkey(j, i))
                return
            if kind == "heal_link":
                fs.heal_link(op[1])
                wake = sorted(suspended)
                suspended.clear()
                for j, i in wake:
                    if jstate[j][i] == F.SUSPENDED:
                        jstate[j][i] = 1
                        push(ready, rkey(j, i))
                return
            if kind == "kill_link":
                fs.kill_link(op[1], op[2])
            else:
                fs.kill_node(op[1])
            applied += 1
            damage = True
            for j in range(nj):
                if not active[j]:
                    continue
                state = jstate[j]
                src = jsrc[j]
                dst = jdst[j]
                for i in range(len(state)):
                    if state[i] != 3:
                        continue
                    if fs.edge_alive(src[i], dst[i]):
                        continue
                    if not retry_mode and dst[i] not in fs.dead_nodes:
                        continue        # completes-then-dies: let it land
                    state[i] = F.ABORTED
                    aborted += 1
                    free_and_wake(jres[j][i])
                    push(ctrl, (now + faults.retry_timeout, ctrl_seq,
                                ("retry", (j, i), 0.0)))
                    ctrl_seq += 1
            for j in range(nj):
                if active[j]:
                    repair_job(j)

        while True:
            next_t = events[0][0] if events else math.inf
            while ctrl and ctrl[0][0] <= next_t:
                t_c, _, op = pop(ctrl)
                if t_c > now:
                    now = t_c
                apply_control(op)
                admit()
                next_t = events[0][0] if events else math.inf
            if not events:
                if ctrl:
                    continue
                break
            now, _, j, i = pop(events)
            state = jstate[j]
            if state[i] != 3:
                continue               # aborted/cancelled mid-flight
            state[i] = 4
            jcomp[j] += 1
            rs = jres[j][i]
            for r in rs:
                busy[r] -= 1
            d = jdst[j][i]
            if faulty:
                cd = jcov[j][d]
                cd.update(b for b in range(*jblks[j][i]) if b not in cd)
                nf = jnf[j]
                if d not in nf and len(cd) >= jtb[j]:
                    nf[d] = now
                if (j, i) in repair_ids and now > repair_done:
                    repair_done = now
            else:
                rem_l = jrem[j]
                rem = rem_l[d]
                if rem > 0:
                    spans = jspans[j]
                    if spans is not None:
                        rem -= spans[i]
                        rem_l[d] = rem
                        if rem <= 0 and d not in jnf[j]:
                            jnf[j][d] = now
                    else:
                        sb_l = jseen[j]
                        if sb_l is None:
                            sb_l = jseen[j] = [None] * nn
                        sb = sb_l[d]
                        if sb is None:
                            sb = sb_l[d] = bytearray(jtb[j])
                        fresh = 0
                        for b in range(*jblks[j][i]):
                            if not sb[b]:
                                sb[b] = 1
                                fresh += 1
                        if fresh:
                            rem -= fresh
                            rem_l[d] = rem
                            if rem <= 0 and d not in jnf[j]:
                                jnf[j][d] = now
            chs = jchild[j].get(i, ()) if faulty else (jchild[j][i] or ())
            dep_left = jdep[j]
            for c in chs:
                dl = dep_left[c] - 1
                dep_left[c] = dl
                if not dl and state[c] == 0:
                    state[c] = 1
                    push(ready, rkey(j, c))
            for r in rs:
                w = res_wait[r]
                if w is not None:
                    res_wait[r] = None
                    for j2, i2 in w:
                        if jstate[j2][i2] == 2:
                            jstate[j2][i2] = 1
                            push(ready, rkey(j2, i2))
            admit()

        if faulty:
            stranded = [(j, i) for j in range(nj)
                        for i in range(len(jstate[j]))
                        if jstate[j][i] not in (4, F.CANCELLED)]
            assert not stranded, \
                f"{len(stranded)} tasks stranded under faults: {stranded[:5]}"
        else:
            for j in range(nj):
                assert jcomp[j] == jn[j], \
                    f"job {specs[j].job_id}: {jn[j] - jcomp[j]} tasks " \
                    f"never ran — dependency cycle"
                bad = [v for v in range(nn) if jrem[j][v] > 0]
                assert not bad, \
                    f"job {specs[j].job_id}: nodes {bad[:5]} never got " \
                    f"the full message"

        runs = []
        for j, sp in enumerate(specs):
            nf = jnf[j]
            runs.append(JobRun(
                job_id=sp.job_id, arrival=sp.arrival,
                start=jstart[j] if jstart[j] is not None else sp.arrival,
                finish=max(nf.values()) if nf else sp.arrival,
                node_finish=nf, started=jstarted[j], completed=jcomp[j]))
        report = None
        if faulty:
            lost: List[Tuple[int, int]] = []
            for j in range(nj):
                lost.extend(sorted(jlost[j]))
            report = F.FaultReport(
                events_applied=applied, aborted=aborted, retries=retried,
                cancelled=cancelled_n, repair_tasks=len(repair_ids),
                repaired=repaired_n,
                dead_nodes=tuple(sorted(fs.dead_nodes)),
                lost=tuple(lost),
                incomplete=tuple(sorted(
                    {v for j in range(nj) for v in topo.compute_nodes
                     if v not in fs.dead_nodes and v not in jnf[j]})),
                repair_latency=(repair_done - repair_t0)
                if repair_t0 is not None and repair_done > 0.0 else 0.0)
        first = min((sp.arrival for sp in specs), default=0.0)
        last = max((r.finish for r in runs), default=first)
        return MultiJobRun(jobs=runs, makespan=last - first,
                           started=sum(jstarted), completed=sum(jcomp),
                           faults=report)

    # -- cyclic pipelines ----------------------------------------------------

    def run_pipeline(self, pipe: Pipeline, packet_bytes: Sequence[float],
                     num_groups: int, max_sim_groups: Optional[int] = None,
                     steady_detect: bool = True, cycle_detect: bool = True,
                     cycle_scan_groups: Optional[int] = None,
                     cycle_hint: Optional[CycleInfo] = None) -> PipelineRun:
        """Simulate a pipelined broadcast of ``num_groups`` groups.

        At most ``max_sim_groups`` groups are expanded (all of them when
        None). When more groups are requested than simulated, the analytic
        paths take over in order:

          1. exact prefix pattern periodicity -> Theorem-2 estimate with Δ
             floored by Δ* (reference extrapolation semantics; exact for
             truly periodic schedules);
          2. verified occupancy-state cycle (``cycle_detect``) -> exact
             analytic result for jittery schedules, found by a bounded scan
             of at most ``cycle_scan_groups`` groups (auto-budgeted by
             template size when None; ``cycle_hint`` — e.g. recorded in a
             plan artifact — skips the scan);
          3. otherwise the ``sim_groups``-group prefix is returned and the
             caller extrapolates (``complete`` False).
        """
        tpl = pipe.compiled_template()
        T = tpl.T
        durs = tpl.durations(packet_bytes)
        nb = tpl.nbytes(packet_bytes)
        m0 = num_groups if max_sim_groups is None \
            else min(num_groups, max_sim_groups)

        res, comp, _ = self._run_template(tpl, durs, nb, m0)
        gf = res.group_finish
        d_meas = (gf[-1] - gf[-2]) if m0 >= 2 else 0.0
        if m0 == num_groups:
            return PipelineRun(res=res, sim_groups=m0, delta=d_meas,
                               complete=True)

        steady = False
        if steady_detect and m0 >= 3 and d_meas > 0:
            tol = _STEADY_RTOL * max(abs(gf[-1]), 1e-300)
            if abs((gf[-2] - gf[-3]) - d_meas) <= tol:
                b1, b2, b3 = (m0 - 1) * T, (m0 - 2) * T, (m0 - 3) * T
                steady = all(
                    abs(comp[b1 + t] - comp[b2 + t] - d_meas) <= tol
                    and abs(comp[b2 + t] - comp[b3 + t] - d_meas) <= tol
                    for t in range(T))
        if steady:
            return self._steady_extrapolate(pipe, packet_bytes, tpl, nb, res,
                                            comp, m0, num_groups, d_meas)

        if cycle_detect:
            run = self._cycle_exact(tpl, durs, nb, num_groups, m0,
                                    cycle_scan_groups, cycle_hint)
            if run is not None:
                return run

        return PipelineRun(res=res, sim_groups=m0, delta=d_meas,
                           complete=False)

    def scan_cycle(self, pipe: Pipeline, packet_bytes: Sequence[float],
                   scan_groups: int) -> Optional[CycleInfo]:
        """Bounded occupancy-cycle scan, hint only (no verification run).

        Used at plan-build time to record a candidate cycle signature on the
        plan artifact; ``run_pipeline(cycle_hint=...)`` then skips the scan
        and goes straight to verification.
        """
        tpl = pipe.compiled_template()
        durs = tpl.durations(packet_bytes)
        nb = tpl.nbytes(packet_bytes)
        _, _, cands = self._run_template(tpl, durs, nb, scan_groups,
                                         scan=True)
        if not cands:
            return None
        g1, g2, t1, t2 = cands[0]
        return CycleInfo(period=g2 - g1, delta=t2 - t1, start=g1,
                         verified=False)

    # -- steady-state paths --------------------------------------------------

    def _steady_extrapolate(self, pipe: Pipeline,
                            packet_bytes: Sequence[float],
                            tpl: CompiledTemplate, nb: List[float],
                            res: SimResult, comp: List[float], m0: int,
                            num_groups: int, d_meas: float) -> PipelineRun:
        """Prefix pattern repeated exactly: extrapolate the tail shifted by Δ
        per group. Δ is floored by Δ* (Def. 8) because prefix periodicity can
        be transient — later groups may perturb earlier ones through
        contention — making this the Thm-2 estimate, exact only for truly
        periodic schedules."""
        T = tpl.T
        gf = res.group_finish
        delta = thm2_delta_floor(
            d_meas, delta_star(self.topo, self.cm, pipe, packet_bytes))
        extra = num_groups - m0
        shift = extra * delta
        b1 = (m0 - 1) * T
        node_last: Dict[int, float] = {}
        dst = tpl.dst
        for t in range(T):
            v = dst[t]
            c = comp[b1 + t]
            if c > node_last.get(v, -1.0):
                node_last[v] = c
        node_finish = {v: c + shift for v, c in node_last.items()}
        node_finish[self.root] = 0.0
        gf_ext = list(gf) + [gf[-1] + k * delta for k in range(1, extra + 1)]
        deliveries = list(res.deliveries)
        if extra * T <= _MAX_SYNTH_DELIVERIES:
            last = [(comp[b1 + t], nb[t]) for t in range(T)]
            for k in range(1, extra + 1):
                dk = k * delta
                deliveries.extend((c + dk, b) for c, b in last)
        res_ext = SimResult(finish_time=max(node_finish.values()),
                            node_finish=node_finish, deliveries=deliveries,
                            group_finish=gf_ext, started=num_groups * T,
                            completed=num_groups * T)
        return PipelineRun(res=res_ext, sim_groups=m0, delta=delta,
                           complete=True, steady=True)

    def _cycle_exact(self, tpl: CompiledTemplate, durs: List[float],
                     nb: List[float], num_groups: int, m0: int,
                     cycle_scan_groups: Optional[int],
                     cycle_hint: Optional[CycleInfo]) -> Optional[PipelineRun]:
        """Occupancy-cycle detection + exact shift verification.

        Scan (or take the hinted) boundary-state recurrence (g1, g2), then
        verify with three full base runs aligned to ``num_groups`` modulo the
        period p: adjacent runs of m_b and m_b + p groups establish the
        per-period shift Δp and its rigidity (total, per-node finishes,
        group-finish head and tail), and a third *far-anchor* run of
        m_c = m_b + E·p groups must land exactly on the same line
        (fin(m_c) = fin(m_b) + E·Δp, rigid again). The far anchor is what
        rejects pseudo-cycles that shift rigidly along a transient plateau:
        a regime fed by a root streaming ahead of the steady rate dies when
        pending groups run out, leaving an offset jump between the plateau
        and the true asymptote that the E-period gap exposes. Returns None
        when no candidate survives — the caller falls back to the estimate.
        """
        T = tpl.T
        scan = cycle_scan_groups if cycle_scan_groups is not None \
            else _auto_scan_groups(T, m0)
        scan = min(num_groups, max(scan, m0 + 1))
        if scan >= num_groups:
            # every requested group fits inside the scan budget: a complete
            # simulation is exact and no cheaper path exists — don't scan,
            # don't verify, just run it
            res, _, _ = self._run_template(tpl, durs, nb, num_groups)
            gf = res.group_finish
            d = gf[-1] - gf[-2] if num_groups >= 2 else 0.0
            return PipelineRun(res=res, sim_groups=num_groups, delta=d,
                               complete=True)
        if cycle_hint is not None and cycle_hint.period > 0:
            # recorded at plan-build time (probe packet sizes): verify first
            # — when it holds, the whole scan is skipped; when it does not
            # (other packet sizes can cycle differently), scan as usual
            run = self._verify_cycle(tpl, durs, nb, num_groups,
                                     cycle_hint.start,
                                     cycle_hint.start + cycle_hint.period)
            if run is not None:
                return run
        _, _, cands = self._run_template(tpl, durs, nb, scan, scan=True)
        if not cands:
            return None
        # earlier anchors can sit on transient plateaus (rejected by the far
        # anchor below); later candidates from the same scan may still be
        # the sustainable cycle, so try a few
        for g1, g2, _, _ in cands[:3]:
            if cycle_hint is not None \
                    and g1 == cycle_hint.start \
                    and g2 == g1 + cycle_hint.period:
                continue   # already tried as the hint
            run = self._verify_cycle(tpl, durs, nb, num_groups, g1, g2)
            if run is not None:
                return run
        return None

    def _verify_cycle(self, tpl: CompiledTemplate, durs: List[float],
                      nb: List[float], num_groups: int, g1: int, g2: int,
                      ) -> Optional[PipelineRun]:
        """Verify one candidate cycle and build the exact extended result
        (see ``_cycle_exact``); None when the candidate fails."""
        T = tpl.T
        p = g2 - g1

        # base runs aligned to num_groups modulo the period; the far anchor
        # sits E periods out (more groups for small p, bounded overall)
        m_b = g2 + 1 + ((num_groups - (g2 + 1)) % p)
        E = min(max(8, 128 // p), (num_groups - m_b) // p)
        if num_groups <= m_b + p or E < 4:
            # cheaper to simulate everything than to verify and shift
            res, _, _ = self._run_template(tpl, durs, nb, num_groups)
            gf = res.group_finish
            d = gf[-1] - gf[-2] if num_groups >= 2 else 0.0
            return PipelineRun(res=res, sim_groups=num_groups, delta=d,
                               complete=True)
        m_c = m_b + E * p
        r1, _, _ = self._run_template(tpl, durs, nb, m_b)
        r2, _, _ = self._run_template(tpl, durs, nb, m_b + p)
        rc, _, _ = self._run_template(tpl, durs, nb, m_c)
        dp = r2.finish_time - r1.finish_time
        tol = _CYCLE_RTOL * max(rc.finish_time, 1e-300)
        if dp <= 0:
            return None
        root = self.root
        for ra, rb, base, steps in ((r1, r2, m_b, 1), (r2, rc, m_b + p,
                                                       E - 1)):
            shift_ab = steps * dp
            if abs((rb.finish_time - ra.finish_time) - shift_ab) > tol:
                return None
            nfa, nfb = ra.node_finish, rb.node_finish
            if set(nfa) != set(nfb):
                return None
            for v, tb in nfb.items():
                if v != root and abs((tb - nfa[v]) - shift_ab) > tol:
                    return None
            gfa, gfb = ra.group_finish, rb.group_finish
            # pre-cycle region must be m-independent ...
            if any(abs(a - b) > tol for a, b in zip(gfa[:g1], gfb[:g1])):
                return None
            # ... and the post-cycle tail must shift rigidly
            for j in range(base - g1):
                if abs((gfb[len(gfb) - 1 - j] - gfa[base - 1 - j])
                       - shift_ab) > tol:
                    return None

        k = (num_groups - m_c) // p
        shift = k * dp
        node_finish = {v: (0.0 if v == root else t + shift)
                       for v, t in rc.node_finish.items()}
        gfc = rc.group_finish
        tail_len = m_c - g1
        cut = num_groups - tail_len
        gf_full = list(gfc[:g1])
        # middle groups: per-period shift at matching phase (exact when the
        # base run is itself p-periodic past g1; for rotating-phase schedules
        # whose results shift rigidly at a finer p than their internal phase
        # structure this is approximate — head, tail, totals and node
        # finishes stay exact)
        gf_full.extend(gfc[g1 + ((g - g1) % p)] + ((g - g1) // p) * dp
                       for g in range(g1, cut))
        gf_full.extend(gfc[g - k * p] + shift for g in range(cut, num_groups))
        deliveries = self._cycle_deliveries(rc, gfc[g1], dp, k)
        res = SimResult(finish_time=rc.finish_time + shift,
                        node_finish=node_finish, deliveries=deliveries,
                        group_finish=gf_full, started=num_groups * T,
                        completed=num_groups * T)
        return PipelineRun(res=res, sim_groups=m_c, delta=dp / p,
                           complete=True,
                           cycle=CycleInfo(period=p, delta=dp, start=g1,
                                           verified=True))

    @staticmethod
    def _cycle_deliveries(r2: SimResult, t0: float, dp: float, k: int,
                          ) -> List[Tuple[float, float]]:
        """Delivery records for the cycle-extended run: the base run's
        pre-cycle head, k replicated cycle windows, and the base run's tail
        shifted — capped like the steady path (rate_timeline degrades to the
        base run's shape beyond the cap, finish times stay exact)."""
        head = [d for d in r2.deliveries if d[0] <= t0]
        tail = [d for d in r2.deliveries if d[0] > t0]
        window = [d for d in tail if d[0] <= t0 + dp]
        out = head
        if k * len(window) <= _MAX_SYNTH_DELIVERIES:
            for j in range(k):
                jd = j * dp
                out.extend((t + jd, b) for t, b in window)
        ks = k * dp
        out.extend((t + ks, b) for t, b in tail)
        return out

    # -- the template event loop ---------------------------------------------

    def _run_template(self, tpl: CompiledTemplate, durs: List[float],
                      nb: List[float], m: int, scan: bool = False,
                      ) -> Tuple[Optional[SimResult], List[float],
                                 Optional[List[Tuple[int, int, float,
                                                     float]]]]:
        """Run ``m`` groups of the lowered template.

        Same semantics (and event order) as ``EventSimulator.run`` on the
        ``pipeline_tasks`` expansion: task ``g*T + t`` is template task ``t``
        of group ``g``, rank ``g*T + tpl.rank[t]``, dependencies intra-group.
        Cyclic pipelines deliver each (node, group, tree) packet exactly
        once, so block coverage is a plain per-node countdown.

        Same-template instances are *folded*: instances of one template task
        share identical resources, so greedy admission among the ready ones
        is strictly group-ordered — only the lowest-group ready instance per
        template is kept live in the ready/blocked structures; the rest stay
        dormant (dep-free instances behind a successor counter, dep-ready
        ones in a per-template heap) and are activated exactly at the
        admission pass where the live predecessor starts. Without the fold
        the engine would wake and re-block whole m-instance backlogs on
        every resource free; with it, wait queues hold at most one live
        instance per template task — which is also why this loop still
        parks blocked instances on *every* busy resource like the
        reference, instead of the first-busy-only contract of
        ``_run_generic``: the queues it re-blocks are O(T), so there is
        nothing to save. Either way the admission sequence is identical: a
        dormant instance can never be admitted while a lower-group instance
        of the same template is blocked on the same resources.

        With ``scan``, a boundary signature is captured at every group
        boundary: the dense resource-occupancy vector, the in-flight task
        phases (template index, group offset, remaining time) in start
        order, and the blocked tasks by wait queue (queue membership decides
        which resource free wakes whom). Together with the (empty after
        admission) ready heap and the implicit waiting tail, this is the
        engine's forward state expressed relative to the boundary group,
        with far-pending groups summarized as "more of the same". The scan
        confirms a candidate only after the same anchor state recurred
        twice with equal spacing, collects up to three ``(g1, g2, t1, t2)``
        candidates (stopping early at three; ``res`` is None then). The
        summarized tail makes these *candidates*, not proofs — a regime fed
        by a root streaming ahead of the steady rate can recur here yet die
        when pending groups run out; the caller's far-anchor verification
        is what rejects those.
        """
        T = tpl.T
        n = m * T
        res_ids = tpl.res_ids
        children = tpl.children
        tpl_rank = tpl.rank
        idx = self.idx
        caps = idx.caps
        busy = [0] * idx.num_resources()
        res_wait: List[Optional[List[int]]] = [None] * len(busy)
        dep_left = tpl.dep_n * m
        dep_free = [not d for d in tpl.dep_n]
        state = bytearray(n)
        roots = [t for t in range(T) if dep_free[t]]
        # folded instances: per template one live (lowest) group; dep-ready
        # arrivals beyond it wait in a dormant heap
        live: List[List[int]] = [[] for _ in range(T)]
        dormant: List[List[int]] = [[] for _ in range(T)]
        ready: List[Tuple[int, int]] = [(tpl_rank[t], t) for t in roots]
        for e in ready:
            state[e[1]] = 1
        heapq.heapify(ready)
        hpush = heapq.heappush
        hpop = heapq.heappop

        nn = self.topo.num_nodes
        root = self.root
        per_node = [0] * nn
        for v in tpl.dst:
            per_node[v] += 1
        remaining = [c * m for c in per_node]
        remaining[root] = 0
        node_finish = [-1.0] * nn
        node_finish[root] = 0.0
        grp_left = [T] * m
        gf = [0.0] * m
        comp = [0.0] * n
        deliveries: List[Tuple[float, float]] = []
        events: List[Tuple[float, int, int]] = []
        seq = 0
        now = 0.0
        push = heapq.heappush
        pop = heapq.heappop
        deliver = deliveries.append

        # signature store: discrete key -> anchor entries [g, t, remaining
        # (np), last matching boundary, its time, spacing]; an anchor whose
        # state recurs twice at equal spacing confirms one candidate cycle
        sigs: Dict[tuple, List[list]] = {}
        confirmed: List[Tuple[int, int, float, float]] = []
        sig_tol = _SIG_RTOL * max(durs) if durs else 0.0

        csr = _ResourceCSR.from_template(tpl, caps)

        def admit() -> None:
            nonlocal seq, busy
            if len(ready) >= _BATCH_MIN_READY \
                    and not any(dep_free[i % T] or dormant[i % T]
                                for _, i in ready):
                # whole-frontier batch: counts occupancy vectorized; safe
                # only without folded successors (those must interleave into
                # this pass in rank order)
                batch = csr.feasible([i % T for _, i in ready], busy)
                if batch is not None:
                    busy = batch
                    for _, i in sorted(ready):
                        t = i % T
                        push(events, (now + durs[t], seq, i))
                        seq += 1
                        state[i] = 3
                        lv = live[t]
                        if lv:
                            del lv[0]
                    ready.clear()
                    return
            while ready:
                _, i = pop(ready)
                if state[i] != 1:
                    continue
                t = i % T
                rs = res_ids[t]
                blocked = None
                for r in rs:
                    if busy[r] >= caps[r]:
                        if blocked is None:
                            blocked = [r]
                        else:
                            blocked.append(r)
                if blocked is not None:
                    state[i] = 2
                    for r in blocked:
                        w = res_wait[r]
                        if w is None:
                            res_wait[r] = [i]
                        else:
                            w.append(i)
                    continue
                for r in rs:
                    busy[r] += 1
                push(events, (now + durs[t], seq, i))
                seq += 1
                state[i] = 3
                if dep_free[t]:
                    j = i + T          # unfold the next dormant instance
                    if j < n:
                        state[j] = 1
                        push(ready, ((j // T) * T + tpl_rank[t], j))
                else:
                    lv = live[t]
                    del lv[0]          # the admitted instance is the min
                    dm = dormant[t]
                    if dm:
                        while dm and (not lv or dm[0] < lv[0]):
                            gd = hpop(dm)
                            j = gd * T + t
                            state[j] = 1
                            insort(lv, gd)
                            push(ready, (gd * T + tpl_rank[t], j))

        admit()
        completed = 0
        dst_t = tpl.dst
        while events:
            now, _, i = pop(events)
            completed += 1
            comp[i] = now
            t = i % T
            g = i // T
            rs = res_ids[t]
            for r in rs:
                busy[r] -= 1
            d = dst_t[t]
            rem = remaining[d]
            if rem > 0:
                rem -= 1
                remaining[d] = rem
                if not rem:
                    node_finish[d] = now
            deliver((now, nb[t]))
            gl = grp_left[g] - 1
            grp_left[g] = gl
            boundary = not gl
            if boundary:
                gf[g] = now
            off = g * T
            for c in children[t]:
                j = off + c
                dl = dep_left[j] - 1
                dep_left[j] = dl
                if not dl and state[j] == 0:
                    lv = live[c]
                    if lv and g > lv[0]:
                        hpush(dormant[c], g)   # fold behind the live one
                    else:
                        state[j] = 1
                        if lv:
                            insort(lv, g)      # rare out-of-order arrival
                        else:
                            lv.append(g)
                        push(ready, (off + tpl_rank[c], j))
            for r in rs:
                w = res_wait[r]
                if w is not None:
                    res_wait[r] = None
                    for j in w:
                        if state[j] == 2:
                            state[j] = 1
                            jt = j % T
                            push(ready, (j - jt + tpl_rank[jt], j))
            # admission, inlined (the closure call costs ~15% of the loop);
            # big frontiers take the vectorized batch path inside admit()
            if len(ready) >= _BATCH_MIN_READY:
                admit()
            else:
                while ready:
                    rk2, j2 = pop(ready)
                    if state[j2] != 1:
                        continue
                    t2 = j2 % T
                    rs2 = res_ids[t2]
                    blocked = None
                    for r in rs2:
                        if busy[r] >= caps[r]:
                            if blocked is None:
                                blocked = [r]
                            else:
                                blocked.append(r)
                    if blocked is not None:
                        state[j2] = 2
                        for r in blocked:
                            w = res_wait[r]
                            if w is None:
                                res_wait[r] = [j2]
                            else:
                                w.append(j2)
                        continue
                    for r in rs2:
                        busy[r] += 1
                    push(events, (now + durs[t2], seq, j2))
                    seq += 1
                    state[j2] = 3
                    if dep_free[t2]:
                        j3 = j2 + T    # unfold the next dormant instance
                        if j3 < n:
                            state[j3] = 1
                            push(ready, (rk2 + T, j3))
                    else:
                        lv = live[t2]
                        del lv[0]      # the admitted instance is the min
                        dm = dormant[t2]
                        if dm:
                            while dm and (not lv or dm[0] < lv[0]):
                                gd = hpop(dm)
                                j3 = gd * T + t2
                                state[j3] = 1
                                insort(lv, gd)
                                push(ready, (gd * T + tpl_rank[t2], j3))
            if scan and boundary:
                flight = sorted(events, key=lambda ev: ev[1])
                # blocked tasks by per-resource wait queue: membership decides
                # which resource free wakes whom, so it is part of the state
                near = []
                far = set()
                for r, w in enumerate(res_wait):
                    if w is None:
                        continue
                    for j in w:
                        if state[j] == 2:
                            off = j // T - g
                            if off <= _SIG_HORIZON:
                                near.append((r, j % T, off))
                            else:
                                far.add((r, j % T))
                # folded dep-ready backlogs are forward state too
                near_d = []
                far_d = set()
                for t2 in range(T):
                    for gd in dormant[t2]:
                        off = gd - g
                        if off <= _SIG_HORIZON:
                            near_d.append((t2, off))
                        else:
                            far_d.add(t2)
                key = (tuple(busy),
                       tuple((iv % T, iv // T - g) for _, _, iv in flight),
                       tuple(sorted(near)), tuple(sorted(far)),
                       tuple(sorted(near_d)), tuple(sorted(far_d)))
                rem_v = np.array([tv - now for tv, _, _ in flight])
                hits = sigs.get(key)
                if hits is None:
                    sigs[key] = [[g, now, rem_v, -1, 0.0, 0]]
                else:
                    hit = None
                    for h in hits:
                        d = h[2] - rem_v
                        if not d.size or abs(d.max()) <= sig_tol \
                                and abs(d.min()) <= sig_tol:
                            hit = h
                            break
                    if hit is None:
                        hits.append([g, now, rem_v, -1, 0.0, 0])
                    else:
                        g_prev, t_prev, spacing = hit[3], hit[4], hit[5]
                        if g_prev >= 0 and g - g_prev == spacing:
                            # second equal-spaced recurrence of this anchor:
                            # confirm the latest period as a candidate
                            confirmed.append((g_prev, g, t_prev, now))
                            hit[3] = -2   # one candidate per anchor
                            if len(confirmed) >= 3:
                                break
                        elif g_prev != -2:
                            # chain on the *last* gap, not the distance from
                            # the anchor, so an irregular early recurrence
                            # doesn't poison a following true cycle
                            hit[5] = g - (g_prev if g_prev >= 0 else hit[0])
                            hit[3], hit[4] = g, now

        if scan and completed < n:
            # early stop with enough candidates: partial run, no result
            return None, comp, confirmed
        assert completed == n, \
            f"{n - completed} tasks never ran — dependency cycle"
        missing = [v for v in range(nn) if remaining[v] > 0]
        assert not missing, f"nodes {missing[:5]} never got the full message"
        nf = {v: tv for v, tv in enumerate(node_finish) if tv >= 0.0}
        res = SimResult(finish_time=max(nf.values()), node_finish=nf,
                        deliveries=deliveries, group_finish=gf,
                        started=n, completed=n)
        return res, comp, confirmed if scan else None


class _ResourceCSR:
    """Per-task resource ids in CSR form for vectorized occupancy counting.

    ``feasible(tasks, busy)`` counts the frontier's total demand per resource
    with one ``np.bincount`` over the gathered CSR rows and, if every
    resource stays within capacity, returns the updated occupancy list (the
    whole frontier admitted at once); None means the frontier does not fit
    and the caller falls back to scalar greedy admission.
    """

    __slots__ = ("indptr", "flat", "caps")

    def __init__(self, res_ids: Sequence[Tuple[int, ...]], num_res: int,
                 caps: List[int]):
        indptr = np.zeros(len(res_ids) + 1, dtype=np.int64)
        for i, ids in enumerate(res_ids):
            indptr[i + 1] = indptr[i] + len(ids)
        self.indptr = indptr
        self.flat = np.fromiter((r for ids in res_ids for r in ids),
                                dtype=np.int64, count=int(indptr[-1]))
        self.caps = np.asarray(caps, dtype=np.int64)

    @classmethod
    def from_template(cls, tpl: CompiledTemplate, caps: List[int],
                      ) -> "_ResourceCSR":
        """Reuse the CSR arrays already lowered on the template."""
        return cls.from_arrays(tpl.res_indptr, tpl.res_flat, caps)

    @classmethod
    def from_arrays(cls, indptr, flat, caps: List[int]) -> "_ResourceCSR":
        """Wrap prelowered CSR arrays (template or task-list lowering); only
        the capacity snapshot is taken per run (interning may have grown the
        resource table since the lowering)."""
        self = cls.__new__(cls)
        self.indptr = indptr
        self.flat = flat
        self.caps = np.asarray(caps, dtype=np.int64)
        return self

    def feasible(self, tasks: List[int], busy: List[int],
                 ) -> Optional[List[int]]:
        rows = np.asarray(tasks, dtype=np.int64)
        starts = self.indptr[rows]
        lens = self.indptr[rows + 1] - starts
        total = int(lens.sum())
        if not total:
            return list(busy)
        gather = np.repeat(starts - np.cumsum(lens) + lens, lens) \
            + np.arange(total)
        counts = np.bincount(self.flat[gather], minlength=len(self.caps))
        busy_v = np.asarray(busy, dtype=np.int64)
        new = busy_v + counts
        if np.any(new > self.caps):
            return None
        return new.tolist()
