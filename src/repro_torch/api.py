"""One-call facade over the port's broadcast stack.

The counterpart of ``repro.api``: build a ``Topology``, wrap it in a
``ConflictModel`` whose compiled routing layer every call shares, maybe
stand up a ``PlanServer`` for orbit-canonical plan reuse, and hand back a
``CompiledModel`` whose methods delegate to the module functions::

    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.planstore import PlanStore

    model = api.compile(T.mesh2d(16, 16), server=True, store=PlanStore(d))
    t, info = model.broadcast_time(root=0, nbytes=16e6)
    res = model.simulate_baseline("binomial", root=0, nbytes=16e6)
    report = model.workload(jobs)          # concurrent multi-root load
    ex = model.executable(root=0, nbytes=16 << 20)   # runs on cuda
    cost = ex.calibrate()                  # Hockney alpha/beta, on cuda
    cost = ex.calibrate(group=g)           # ... across a torch.distributed
    t = ex.measure(group=g)                # group, one GPU a rank

``server=True`` (or a ``store``) attaches a
``repro_torch.launch.planserver.PlanServer``: ``plan(root)`` is then served
from its caches, a root of an already-built orbit by relabeling; ``store``
(a ``repro_torch.core.planstore.PlanStore``) keeps the canonical builds on
disk across processes. Simulation options ride one
``config=SimConfig(...)``; ``SimConfig(engine="kernel")`` runs the
simulator's event core on the device of its ``device`` block (cuda by
default; ``repro_torch.core.kernelsim``).

The facade adds no policy of its own: every method delegates to the
underlying module function, so results equal those of calling the
functions directly with the same shared ``ConflictModel``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.core.intersection import FULL_DUPLEX, ConflictModel
from repro_torch.core.routing import topology_fingerprint
from repro_torch.core.simconfig import SimConfig
from repro_torch.core.topology import Topology


def compile(topo: Topology, mode: str = FULL_DUPLEX, *,
            server: bool = False, store=None,
            plan_capacity: int = 256) -> "CompiledModel":
    """Compile ``topo`` once: the ``ConflictModel`` and through it the
    shared ``CompiledTopology`` resource layer; with ``server=True`` or a
    ``store``, a ``PlanServer`` whose orbit-canonical caches back
    ``plan``/``broadcast_time``/``workload``/``executable``."""
    model = CompiledModel(topo=topo, cm=ConflictModel(topo, mode), mode=mode)
    if server or store is not None:
        model.ensure_server(store=store, plan_capacity=plan_capacity)
    return model


@dataclasses.dataclass
class CompiledModel:
    """A topology compiled for simulation and device execution: shared
    ``ConflictModel`` + routing layer, optional warm ``PlanServer``."""

    topo: Topology
    cm: ConflictModel
    mode: str = FULL_DUPLEX
    server: Optional[object] = None    # repro_torch.launch.planserver

    @property
    def compiled(self):
        """The shared ``repro_torch.core.routing.CompiledTopology``."""
        return self.cm.compiled()

    @property
    def fingerprint(self) -> str:
        return topology_fingerprint(self.topo)

    def ensure_server(self, store=None, plan_capacity: int = 256):
        """Attach (or return) the model's ``PlanServer``: plan queries then
        share one orbit-canonicalizing cache across roots."""
        if self.server is None:
            from repro_torch.launch.planserver import PlanServer
            self.server = PlanServer(store=store,
                                     plan_capacity=plan_capacity,
                                     mode=self.mode)
            self.server.register(self.topo)
        return self.server

    # -- plans ---------------------------------------------------------------

    def plan(self, root: int = 0):
        """The BBS plan for ``root``: served (and cached, with orbit
        relabeling) by the attached ``PlanServer`` when there is one, else
        built directly on the shared ``ConflictModel``."""
        if self.server is not None:
            return self.server.plan(self.topo, root)
        from repro_torch.core.bbs import build_plan
        return build_plan(self.topo, root=root, mode=self.mode, cm=self.cm)

    def broadcast_time(self, root: int, nbytes: float, *,
                       config: Optional[SimConfig] = None,
                       ) -> Tuple[float, dict]:
        """Predicted broadcast time + selection info for ``nbytes`` from
        ``root``."""
        from repro_torch.core.bbs import broadcast_time
        return broadcast_time(self.plan(root), nbytes, config=config)

    # -- single-run simulation ------------------------------------------------

    def simulate_pipeline(self, pipe, message_bytes: float,
                          num_groups: int, root: int, *,
                          config: Optional[SimConfig] = None):
        from repro_torch.core.simulator import simulate_pipeline
        return simulate_pipeline(self.topo, self.cm, pipe, message_bytes,
                                 num_groups, root, config=config)

    def simulate_baseline(self, name: str, root: int, nbytes: float, *,
                          store=None, config: Optional[SimConfig] = None):
        from repro_torch.core.baselines import simulate_baseline
        return simulate_baseline(self.topo, self.cm, name, root, nbytes,
                                 store=store, config=config)

    # -- device execution -----------------------------------------------------

    def executable(self, root: int, nbytes: float, *, algo: str = "bbs",
                   config: Optional[SimConfig] = None):
        """Compile ``(root, nbytes)`` for the virtual-mesh runner: a
        ``repro_torch.device.ExecutablePlan`` on ``config.device`` (cuda by
        default), with ``calibrate()`` for the Hockney fit. ``algo="bbs"``
        executes the best device-executable candidate of ``plan(root)``
        (PlanServer-relabeled plans, pinned route overrides included, flow
        through unchanged); a baseline name (``"binomial"``,
        ``"bine_tree"``, ...) lowers that baseline's whole-message tree
        through the same ``build_pipeline`` -> ``DeviceSchedule`` path
        (``"pipeline"`` with its packets as the pipeline's groups). Each
        runs, verifies, measures and calibrates on one card, or across the
        ranks of a ``torch.distributed`` group (``group=``), and
        ``repro_torch.device.prediction_report(..., group=)`` reports it
        there."""
        from repro_torch.device.executable import build_executable
        plan = self.plan(root) if algo == "bbs" else None
        return build_executable(self.topo, self.cm, root, nbytes,
                                algo=algo, plan=plan, config=config)

    # -- concurrent workloads -------------------------------------------------

    def workload(self, jobs: Sequence, faults=None, *,
                 config: Optional[SimConfig] = None):
        """Run a multi-root broadcast workload (``repro_torch.workload``)
        on this model's shared resource layer; returns a
        ``WorkloadReport``."""
        from repro_torch.workload import run_workload
        return run_workload(self, jobs, faults=faults, config=config)
