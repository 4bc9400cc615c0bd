"""Stochastic multi-root broadcast workloads on one shared fabric.

``arrivals`` turns a seedable arrival process (Poisson or a recorded
trace) into a list of ``BroadcastJob``s; ``engine`` admits them online
against the compiled resource layer (``CompiledSim.run_jobs``), with
plans fetched through the model's orbit-canonical ``PlanServer`` caches,
and reduces the per-job outcomes to a ``WorkloadReport`` (sustained
jobs/s and tasks/s, latency and queueing percentiles, saturation sweep).
See docs/workloads.md.
"""

from repro_torch.workload.arrivals import (BroadcastJob, poisson_jobs,  # noqa: F401
                                     trace_jobs)
from repro_torch.workload.engine import (JobStats, WorkloadReport,  # noqa: F401
                                   offered_load_sweep, run_workload,
                                   saturation_point)
