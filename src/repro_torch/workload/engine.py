"""The multi-root workload scheduler loop + its metrics reduction.

``run_workload`` is the paper's serving-tier counterpart to a single
``broadcast_time`` query: a stream of broadcast jobs (root, nbytes,
arrival) admitted online against ONE shared compiled fabric. Per job it

  1. fetches the root's BBS plan — through the model's ``PlanServer``
     when attached (every root of an automorphism orbit shares one
     canonical build; the whole stream is ``prefetch_jobs``-warmed up
     front so plan-build latency never pollutes queueing delay),
  2. selects the candidate pipeline + group count for the job's message
     size (Eq. 3/4 closed form, exactly like ``broadcast_time``),
  3. lowers the expanded pipeline onto the shared
     ``CompiledTopology`` — memoized per (root, nbytes), so a workload
     hammering a few job shapes pays each lowering once —

and hands the whole stream to ``CompiledSim.run_jobs``: FCFS across
jobs, admission-rank order within a job, per-resource contention through
one shared occupancy, optional fabric churn via
``repro_torch.core.faults.FaultSchedule``. The reduction to a
``WorkloadReport`` gives sustained jobs/s and tasks/s over the makespan,
per-job latency and queueing-delay percentiles, deadline misses, and —
via ``offered_load_sweep`` — the measured saturation point of the fabric
under increasing offered load. Everything is deterministic given the
workload (see ``repro_torch.workload.arrivals``): same jobs, same report.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.fastsim import CompiledSim, JobSpec
from repro_torch.core.simconfig import SimConfig
from repro_torch.core.simulator import pipeline_tasks
from repro_torch.workload.arrivals import BroadcastJob, poisson_jobs


def _percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) of a non-empty sequence."""
    s = sorted(xs)
    return s[min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))]


@dataclasses.dataclass
class JobStats:
    """Per-job outcome row of a ``WorkloadReport``."""

    job_id: int
    root: int
    nbytes: float
    arrival: float
    start: float
    finish: float
    deadline: Optional[float] = None

    @property
    def latency(self) -> float:
        return self.finish - self.arrival

    @property
    def queue_delay(self) -> float:
        return self.start - self.arrival

    @property
    def missed(self) -> bool:
        return self.deadline is not None and self.latency > self.deadline


@dataclasses.dataclass
class WorkloadReport:
    """Reduced outcome of one ``run_workload`` call.

    ``offered_rate`` is the workload's own arrival rate (jobs/s over the
    arrival span); ``jobs_per_s`` and ``tasks_per_s`` are *sustained*
    rates over the makespan (first arrival to last finish). A fabric at
    or past saturation shows ``jobs_per_s`` plateauing below
    ``offered_rate`` while ``latency_p99`` grows with queue depth."""

    jobs: List[JobStats]
    makespan: float
    started: int
    completed: int
    offered_rate: float
    jobs_per_s: float
    tasks_per_s: float
    latency_p50: float
    latency_p99: float
    queue_p50: float
    queue_p99: float
    deadline_misses: int
    faults: Optional[object] = None          # FaultReport on churn runs

    @property
    def saturated(self) -> bool:
        """Sustained throughput visibly below offered load (10% slack)."""
        return (math.isfinite(self.offered_rate)
                and self.jobs_per_s < 0.9 * self.offered_rate)

    def to_dict(self) -> dict:
        return {
            "jobs": [[j.job_id, j.root, j.nbytes, j.arrival, j.start,
                      j.finish, j.deadline] for j in self.jobs],
            "makespan": self.makespan,
            "started": self.started,
            "completed": self.completed,
            "offered_rate": self.offered_rate,
            "jobs_per_s": self.jobs_per_s,
            "tasks_per_s": self.tasks_per_s,
            "latency_p50": self.latency_p50,
            "latency_p99": self.latency_p99,
            "queue_p50": self.queue_p50,
            "queue_p99": self.queue_p99,
            "deadline_misses": self.deadline_misses,
            "faults": self.faults.to_dict() if self.faults else None,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadReport":
        from repro_torch.core.faults import FaultReport
        f = d.get("faults")
        return cls(
            jobs=[JobStats(job_id=int(r[0]), root=int(r[1]),
                           nbytes=float(r[2]), arrival=float(r[3]),
                           start=float(r[4]), finish=float(r[5]),
                           deadline=r[6]) for r in d["jobs"]],
            makespan=d["makespan"], started=d["started"],
            completed=d["completed"], offered_rate=d["offered_rate"],
            jobs_per_s=d["jobs_per_s"], tasks_per_s=d["tasks_per_s"],
            latency_p50=d["latency_p50"], latency_p99=d["latency_p99"],
            queue_p50=d["queue_p50"], queue_p99=d["queue_p99"],
            deadline_misses=d["deadline_misses"],
            faults=FaultReport.from_dict(f) if f else None)


def _lower_job_shape(model, sim: CompiledSim, root: int, nbytes: float,
                     max_groups: Optional[int], cache: Dict):
    """Plan + select + lower one (root, nbytes) job shape (memoized)."""
    key = (root, float(nbytes))
    hit = cache.get(key)
    if hit is not None:
        return hit
    plan = model.plan(root)
    cand, m = plan.select(nbytes, top=1)[0]
    if max_groups is not None:
        m = max(1, min(m, max_groups))
    k = len(cand.pipeline.trees)
    group_bytes = nbytes / m
    pkts = [group_bytes * t.weight for t in cand.pipeline.trees]
    ctl = sim.idx.lower_tasks(pipeline_tasks(cand.pipeline, pkts, m),
                              total_blocks=m * k, detect_segments=False)
    cache[key] = ctl
    return ctl


def run_workload(model, jobs: Sequence[BroadcastJob], faults=None, *,
                 config: Optional[SimConfig] = None,
                 max_groups: Optional[int] = None) -> WorkloadReport:
    """Execute a broadcast workload on ``model`` (a
    ``repro_torch.api.CompiledModel``); see the module docstring.

    A single job arriving at t=0 replays the plain
    ``simulate_pipeline(..., max_sim_groups=m)`` full simulation
    bit-for-bit (asserted in tests/test_workload.py). ``max_groups``
    clamps each job's selected group count (smaller pipelines, same full
    message) — ``config.max_sim_groups`` is deliberately NOT applied
    here: workload jobs always deliver their whole message, never a
    Theorem-2-extrapolated prefix."""
    jobs = sorted(jobs, key=lambda j: (j.arrival, j.job_id))
    if config is not None and config.faults is not None and faults is None:
        faults = config.faults
    sim = CompiledSim(model.topo, model.cm, 0)
    if model.server is not None and jobs:
        for fut in model.server.prefetch_jobs(model.topo, jobs).values():
            fut.result()        # warm every orbit before admission starts
    cache: Dict[Tuple[int, float], object] = {}
    specs = [JobSpec(arrival=j.arrival, root=j.root, job_id=j.job_id,
                     ctl=_lower_job_shape(model, sim, j.root, j.nbytes,
                                          max_groups, cache))
             for j in jobs]
    mr = sim.run_jobs(specs, faults=faults)

    by_id = {j.job_id: j for j in jobs}
    stats = []
    for r in mr.jobs:
        j = by_id[r.job_id]
        stats.append(JobStats(job_id=r.job_id, root=j.root,
                              nbytes=j.nbytes, arrival=r.arrival,
                              start=r.start, finish=r.finish,
                              deadline=j.deadline))
    lats = [s.latency for s in stats] or [0.0]
    qs = [s.queue_delay for s in stats] or [0.0]
    span = (jobs[-1].arrival - jobs[0].arrival) if len(jobs) > 1 else 0.0
    offered = (len(jobs) - 1) / span if span > 0 else math.inf
    mk = mr.makespan
    return WorkloadReport(
        jobs=stats, makespan=mk, started=mr.started,
        completed=mr.completed, offered_rate=offered,
        jobs_per_s=len(stats) / mk if mk > 0 else math.inf,
        tasks_per_s=mr.completed / mk if mk > 0 else math.inf,
        latency_p50=_percentile(lats, 0.50),
        latency_p99=_percentile(lats, 0.99),
        queue_p50=_percentile(qs, 0.50),
        queue_p99=_percentile(qs, 0.99),
        deadline_misses=sum(1 for s in stats if s.missed),
        faults=mr.faults)


def offered_load_sweep(model, rates: Sequence[float], num_jobs: int,
                       roots: Sequence[int], nbytes: float, seed: int = 0,
                       faults=None, max_groups: Optional[int] = None,
                       ) -> List[WorkloadReport]:
    """One ``run_workload`` per offered rate (same seed for every point,
    so the sweep is a deterministic function of its arguments): the
    saturation curve of the fabric under increasing multi-root load."""
    return [run_workload(model,
                         poisson_jobs(r, num_jobs, roots, nbytes, seed=seed),
                         faults=faults, max_groups=max_groups)
            for r in rates]


def saturation_point(reports: Sequence[WorkloadReport],
                     frac: float = 0.9) -> Optional[float]:
    """The highest offered rate the fabric still sustains (measured
    jobs/s >= ``frac`` x offered), or None if even the lowest point is
    past saturation."""
    best = None
    for rep in reports:
        if math.isfinite(rep.offered_rate) \
                and rep.jobs_per_s >= frac * rep.offered_rate:
            if best is None or rep.offered_rate > best:
                best = rep.offered_rate
    return best
