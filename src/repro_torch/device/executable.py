"""``ExecutablePlan``: a BBS plan compiled for the virtual-mesh runner.

``repro_torch.api.compile(topo).executable(root, nbytes)`` is the one entry
point: it selects the best device-executable candidate from the BBS plan
(or lowers a named baseline through the same path), compiles the static
``DeviceSchedule`` tables, and hands back an object that runs, verifies and
times the broadcast on n virtual devices of one card::

    model = api.compile(T.mesh2d(16, 16))
    ex = model.executable(root=0, nbytes=16 << 20)
    out = ex.run(x)          # (n,) + x.shape, one copy per virtual device
    chk = ex.verify(x)       # bit-exact delivery on every device
    mine = ex.run(x, group=g)   # across a torch.distributed group, per rank
    t = ex.measure()         # seconds per broadcast
    cost = ex.calibrate()    # Hockney alpha/beta of the virtual mesh

The device comes from ``SimConfig.device`` (``DeviceConfig(device=...)``):
``"cuda"`` by default, which raises on a host without a GPU; ``"cpu"`` runs
the plain PyTorch round step. Baselines lower through the identical
machinery: the whole-message task list is folded back into its
arborescence, colored into conflict-free rounds
(``repro_torch.core.schedule.build_pipeline``) and compiled into the same
tables, multi-hop virtual edges becoming relay chains inside the cycle.

``verify`` enforces the no-fault delivery contract: every node is reachable
from the root, so every node's buffer must be bit-identical to the payload,
compared on raw bytes on the device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import torch

from repro_torch.core.intersection import ConflictModel
from repro_torch.core.simconfig import DeviceConfig, SimConfig
from repro_torch.core.topology import Topology
from repro_torch.device import runner
from repro_torch.device.schedule import (DeviceSchedule, NotDeviceExecutable,
                                         make_device_schedule)


@dataclasses.dataclass
class DeviceDelivery:
    """Bit-exact delivery check: with no faults every node is required;
    ``missing`` lists devices whose buffer differs from the payload."""

    ok: bool
    required: Tuple[int, ...]
    missing: Tuple[int, ...]


@dataclasses.dataclass
class ExecutablePlan:
    """Schedule tables + virtual-mesh runner for one (plan, root, nbytes).
    Build through ``repro_torch.api`` ``executable()`` or
    :func:`build_executable`."""

    topo: Topology
    cm: ConflictModel
    root: int
    nbytes: float
    algo: str                     # "bbs" or a baseline name
    candidate: str                # winning candidate (bbs) / algo name
    schedule: DeviceSchedule
    num_groups: int
    predicted_time: float         # simulator prediction for this selection
    info: dict
    device: DeviceConfig
    pipeline: object = None       # the compiled Pipeline

    @property
    def torch_device(self) -> torch.device:
        return runner.resolve_device(self.device.device)

    @property
    def num_subrounds(self) -> int:
        """Sub-rounds per broadcast: ``d`` per cycle."""
        return self.schedule.d * self.schedule.num_cycles(self.num_groups)

    @property
    def num_launches(self) -> int:
        """Kernel launches per broadcast on a GPU: one ``permute_rounds``
        for all sub-rounds (none when there are none)."""
        return int(self.num_subrounds > 0)

    def tables(self) -> torch.Tensor:
        """The run's int32 ``[cycles, d, 5, n]`` tables on the device,
        uploaded on first use and reused by every run."""
        tabs = self.__dict__.get("_tables")
        if tabs is None:
            tabs = self._tables = runner.build_tables(
                self.schedule, self.num_groups, self.torch_device)
        return tabs

    def moves(self) -> "runner.Moves":
        """The run's compacted moves (``runner.build_moves``) on the device,
        built on first use and reused by every run."""
        mv = self.__dict__.get("_moves")
        if mv is None:
            mv = self._moves = runner.build_moves(
                self.schedule, self.num_groups, self.torch_device)
        return mv

    def _program(self) -> dict:
        """What ``run_cycles`` needs on the plan's device: the moves on a
        GPU, the tables on the CPU."""
        if self.torch_device.type == "cuda":
            return dict(moves=self.moves())
        return dict(tabs=self.tables())

    def run(self, x: torch.Tensor, group=None) -> torch.Tensor:
        """Execute the broadcast; returns the per-device copies stacked on a
        leading axis (shape ``(n,) + x.shape``) on the plan's device.
        ``x`` is only read.

        With a ``torch.distributed`` process group of n ranks, every rank
        calls it and each runs its own device
        (``repro_torch.device.distributed.bbs_broadcast``: NCCL and
        ``cuda:<local rank>`` on the default device, gloo on ``"cpu"``);
        each rank gets back its own copy, shape ``x.shape``."""
        if group is not None:
            from repro_torch.device import distributed
            return distributed.bbs_broadcast(
                x, self.schedule, self.num_groups, group,
                device=self.device.device)
        prog = self._program()
        return runner.bbs_broadcast(x, self.schedule, self.num_groups,
                                    self.torch_device,
                                    tables=prog.get("tabs"),
                                    moves=prog.get("moves"))

    def verify(self, x: torch.Tensor, group=None) -> DeviceDelivery:
        """Run and compare every device's bytes with the payload's, on the
        device (no copy of the stacked result to the host). With a process
        group, every rank runs and checks its own copy, and every rank gets
        the whole group's result."""
        required = tuple(range(self.schedule.num_devices))
        if group is not None:
            from repro_torch.device import distributed
            missing = tuple(distributed.delivered(
                self.run(x, group=group), x, len(required), group))
            return DeviceDelivery(ok=not missing, required=required,
                                  missing=missing)
        dev = self.torch_device
        ref = x.to(dev).contiguous().reshape(-1).view(torch.uint8)
        out = self.run(x)
        outb = out.reshape(out.shape[0], -1).view(torch.uint8)
        missing = tuple(v for v in required if not torch.equal(outb[v], ref))
        return DeviceDelivery(ok=not missing, required=required,
                              missing=missing)

    def default_payload(self, seed: int = 0) -> torch.Tensor:
        """``nbytes`` of random bytes from ``seed``, as ``device.dtype``."""
        dtype = getattr(torch, self.device.dtype)
        esz = torch.empty((), dtype=dtype).element_size()
        n = max(1, int(self.nbytes) // esz)
        g = torch.Generator(device="cpu").manual_seed(seed)
        return torch.randint(0, 256, (n * esz,), dtype=torch.uint8,
                             generator=g).view(dtype)

    def measure(self, x: Optional[torch.Tensor] = None,
                reps: int = 5) -> float:
        """Seconds per broadcast: the minimum over ``reps`` timed runs of the
        cycle loop (on a GPU one ``permute_rounds`` launch), after one
        untimed warm-up run. Each run starts from freshly packed buffers,
        made outside the timed window. Timed with ``torch.cuda.Event`` on a
        GPU and ``perf_counter`` on the CPU."""
        dev = self.torch_device
        x = (self.default_payload() if x is None else x).to(dev)
        lay = runner.packet_layout(x, self.schedule, self.num_groups)
        prog = self._program()
        best = float("inf")
        for i in range(reps + 1):
            buf = runner.pack(x, lay, self.root, dev)
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize(dev)
                start.record()
                runner.run_cycles(buf, **prog)
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                runner.run_cycles(buf, **prog)
                t = time.perf_counter() - t0
            del buf
            if i:                                   # run 0 is the warm-up
                best = min(best, t)
        return best

    def calibrate(self, **kw):
        """Fit Hockney alpha/beta from ring rounds on this plan's n virtual
        devices and device -- see ``repro_torch.device.calibrate``."""
        from repro_torch.device.calibrate import calibrate
        return calibrate(self.topo, self.schedule.num_devices,
                         device=self.device.device, **kw)


def build_executable(topo: Topology, cm: ConflictModel, root: int,
                     nbytes: float, *, algo: str = "bbs",
                     plan=None, config: Optional[SimConfig] = None,
                     ) -> ExecutablePlan:
    """Compile ``(root, nbytes)`` into an :class:`ExecutablePlan`.

    ``algo="bbs"`` walks the plan's Eq.-4 candidate ranking and takes the
    best candidate whose pipeline compiles to matchings
    (``NotDeviceExecutable`` candidates are skipped); a baseline name takes
    that baseline's whole-message tree through ``build_pipeline``. ``plan``
    short-circuits the BBS plan build. Raises at once when the configured
    device is ``cuda`` and the host has no GPU."""
    cfg = config or SimConfig()
    dev = cfg.device or DeviceConfig()
    runner.resolve_device(dev.device)
    n = topo.num_nodes
    compiled = cm.compiled()

    if algo == "bbs":
        if plan is None:
            from repro_torch.core.bbs import build_plan
            plan = build_plan(topo, root=root, mode=cm.mode, cm=cm)
        errors: List[str] = []
        for cand, m in plan.select(nbytes, top=len(plan.candidates)):
            try:
                sched = make_device_schedule(cand.pipeline, n,
                                             compiled=compiled)
            except NotDeviceExecutable as e:
                errors.append(f"{cand.name}: {e}")
                continue
            t = cand.t_opt(nbytes, plan.L, plan.B)
            return ExecutablePlan(
                topo=topo, cm=cm, root=root, nbytes=float(nbytes),
                algo="bbs", candidate=cand.name, schedule=sched,
                num_groups=m, predicted_time=t,
                info={"m_opt": m, "candidates_skipped": errors},
                device=dev, pipeline=cand.pipeline)
        raise NotDeviceExecutable(
            f"no BBS candidate for root {root} compiles to a device "
            f"schedule: {errors}")

    # baseline path: rebuild the whole-message arborescence from the task
    # list and lower it through the standard pipeline coloring
    from repro_torch.core import baselines as B
    from repro_torch.core.arborescence import Arborescence
    from repro_torch.core.schedule import build_pipeline
    tasks = B.BASELINES[algo](topo, root, nbytes)
    parent = {}
    for t in tasks:
        if t.blk != (0, 1):
            raise NotDeviceExecutable(
                f"baseline {algo!r} is not a whole-message tree (task blocks "
                f"{t.blk}); only tree baselines execute on device")
        if t.dst in parent:
            raise NotDeviceExecutable(
                f"baseline {algo!r} delivers node {t.dst} twice; not a tree")
        parent[t.dst] = t.src
    tree = Arborescence(root=root, parent=parent)
    pipe = build_pipeline(topo, [tree], cm)
    sched = make_device_schedule(pipe, n, compiled=compiled)
    res = B.simulate_baseline(topo, cm, algo, root, nbytes,
                              config=SimConfig(engine=cfg.engine, device=dev))
    return ExecutablePlan(
        topo=topo, cm=cm, root=root, nbytes=float(nbytes), algo=algo,
        candidate=algo, schedule=sched, num_groups=1,
        predicted_time=res.finish_time, info={"baseline": algo},
        device=dev, pipeline=pipe)
