"""One-call facade over the port's broadcast stack.

The counterpart of ``repro.api``: build a ``Topology``, wrap it in a
``ConflictModel`` whose compiled routing layer every call shares, and hand
back a ``CompiledModel`` whose methods delegate to the module functions::

    from repro_torch import api
    from repro_torch.core import topology as T

    model = api.compile(T.mesh2d(16, 16))
    t, info = model.broadcast_time(root=0, nbytes=16e6)
    res = model.simulate_baseline("binomial", root=0, nbytes=16e6)
    ex = model.executable(root=0, nbytes=16 << 20)   # runs on cuda

The plan server (``server=True``) and the on-disk plan store (``store=``)
are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.intersection import FULL_DUPLEX, ConflictModel
from repro_torch.core.simconfig import SimConfig
from repro_torch.core.topology import Topology


def compile(topo: Topology, mode: str = FULL_DUPLEX, *,
            server: bool = False, store=None) -> "CompiledModel":
    """Compile ``topo`` once: the ``ConflictModel`` and through it the
    shared ``CompiledTopology`` resource layer."""
    if server or store is not None:
        raise NotImplementedError(
            "the PlanServer / PlanStore (compile(server=True) or store=) are "
            "not ported yet; see ROADMAP.md queue 1")
    return CompiledModel(topo=topo, cm=ConflictModel(topo, mode), mode=mode)


@dataclasses.dataclass
class CompiledModel:
    """A topology compiled for simulation and device execution."""

    topo: Topology
    cm: ConflictModel
    mode: str = FULL_DUPLEX

    def plan(self, root: int = 0):
        """The BBS plan for ``root``, built on the shared ``ConflictModel``."""
        from repro_torch.core.bbs import build_plan
        return build_plan(self.topo, root=root, mode=self.mode, cm=self.cm)

    def broadcast_time(self, root: int, nbytes: float, *,
                       config: Optional[SimConfig] = None,
                       ) -> Tuple[float, dict]:
        """Predicted broadcast time + selection info for ``nbytes`` from
        ``root``."""
        from repro_torch.core.bbs import broadcast_time
        return broadcast_time(self.plan(root), nbytes, config=config)

    def simulate_baseline(self, name: str, root: int, nbytes: float, *,
                          config: Optional[SimConfig] = None):
        from repro_torch.core.baselines import simulate_baseline
        return simulate_baseline(self.topo, self.cm, name, root, nbytes,
                                 config=config)

    def executable(self, root: int, nbytes: float, *, algo: str = "bbs",
                   config: Optional[SimConfig] = None):
        """Compile ``(root, nbytes)`` for the virtual-mesh runner: a
        ``repro_torch.device.ExecutablePlan`` on ``config.device`` (cuda by
        default). ``algo="bbs"`` executes the best device-executable
        candidate of ``plan(root)``; a baseline name (``"binomial"``,
        ``"bine_tree"``, ...) lowers that baseline's whole-message tree
        through the same ``build_pipeline`` -> ``DeviceSchedule`` path."""
        from repro_torch.device.executable import build_executable
        plan = self.plan(root) if algo == "bbs" else None
        return build_executable(self.topo, self.cm, root, nbytes,
                                algo=algo, plan=plan, config=config)
