"""Seedable arrival processes for broadcast workloads.

A workload is just a list of ``BroadcastJob``s — (arrival time, root,
message size, optional deadline). ``poisson_jobs`` draws one from a
seeded Poisson process (i.i.d. exponential gaps at ``rate`` jobs/s,
roots and sizes cycling or drawn uniformly per job); ``trace_jobs``
adapts a recorded trace. Both are pure functions of their arguments —
the same seed always yields the same workload, which is what makes
``run_workload`` results reproducible and benchmarkable.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence, Union


@dataclasses.dataclass(frozen=True)
class BroadcastJob:
    """One job of a broadcast workload: at ``arrival`` (simulated
    seconds), broadcast ``nbytes`` from ``root``; ``deadline`` is an
    optional latency budget in seconds (reported, never enforced)."""

    arrival: float
    root: int
    nbytes: float
    deadline: Optional[float] = None
    job_id: int = 0


def poisson_jobs(rate: float, num_jobs: int, roots: Sequence[int],
                 nbytes: Union[float, Sequence[float]], seed: int = 0,
                 deadline: Optional[float] = None,
                 uniform_roots: bool = False) -> List[BroadcastJob]:
    """A seeded Poisson arrival stream: ``num_jobs`` jobs at ``rate``
    jobs/s (exponential inter-arrival gaps), rooted at ``roots`` —
    cycled deterministically, or drawn uniformly per job with
    ``uniform_roots=True`` — each broadcasting ``nbytes`` (a scalar, or
    a sequence cycled per job)."""
    assert rate > 0 and num_jobs >= 0 and roots
    rng = random.Random(seed)
    sizes = (nbytes,) if isinstance(nbytes, (int, float)) else tuple(nbytes)
    jobs = []
    t = 0.0
    for j in range(num_jobs):
        t += rng.expovariate(rate)
        root = rng.choice(roots) if uniform_roots else roots[j % len(roots)]
        jobs.append(BroadcastJob(arrival=t, root=root,
                                 nbytes=float(sizes[j % len(sizes)]),
                                 deadline=deadline, job_id=j))
    return jobs


def trace_jobs(trace: Sequence, deadline: Optional[float] = None,
               ) -> List[BroadcastJob]:
    """Adapt a recorded trace — an iterable of ``(arrival, root,
    nbytes)`` rows (or rows with a trailing per-job deadline) — into a
    workload. Rows are sorted by arrival and numbered in that order."""
    rows = sorted(tuple(r) for r in trace)
    jobs = []
    for j, row in enumerate(rows):
        t, root, nb = row[0], row[1], row[2]
        dl = row[3] if len(row) > 3 else deadline
        jobs.append(BroadcastJob(arrival=float(t), root=int(root),
                                 nbytes=float(nb), deadline=dl, job_id=j))
    return jobs
