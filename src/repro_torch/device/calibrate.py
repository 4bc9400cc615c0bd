"""Hockney calibration on the virtual mesh: fit alpha/beta from timed rounds.

The port's counterpart of ``repro.device.calibrate``. The simulator
charges every send ``alpha + nbytes / beta`` per link
(``repro_torch.core.topology.LINK_PRESETS`` hardcodes the constants per
fabric preset). ``calibrate`` closes the loop backwards: it times the
round primitive the executor runs -- one full ring matching, every device
sending one packet row to its successor -- across a ladder of row sizes
and least-squares fits ``t(s) = alpha + s / beta``. The result is a
:class:`CalibratedCost` artifact (the reference's JSON layout, so either
package reads what the other wrote) that

  * the simulator consumes via :func:`apply_calibration` (a copy of the
    fabric with the fitted constants -- new fingerprint, so PlanStore
    artifacts built against hardcoded constants are never silently reused);
  * ``repro_torch.core.planstore.PlanStore.store_calibration`` persists;
  * :func:`prediction_report` checks against reality: predicted vs measured
    per-cycle time of an :class:`ExecutablePlan`.

Virtual-mesh caveat: the n devices are n slices of one card's memory
(``repro_torch.device.runner``), so a round is ``iters`` sub-rounds of one
``permute_rounds`` launch (``round_step``, the hand-written CUDA kernel).
The fitted alpha is the kernel's grid barrier plus one dependent load, and
beta the card's memory (or L2) rate shared by all n "links": the fit is a
self-consistency check of the cost model on one card (``emulated`` is
True), not the constants of a fabric.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.topology import Topology
from repro_torch.device.round_step import (Moves, compact_moves,
                                           permute_rounds)
from repro_torch.device.runner import resolve_device

_MAGIC = "bbs-calibration"
_VERSION = 1


@dataclasses.dataclass
class CalibratedCost:
    """Fitted Hockney constants per link class.

    ``classes`` maps a link-class name (the fabric preset the plan charges,
    e.g. ``"tpu_ici"``, or ``"host"`` for a fabric without one) to
    ``(alpha_seconds, beta_bytes_per_second)``. ``meta`` records the
    measurement environment (backend, device count, sample ladder, fit
    residual) so a consumer can judge the fit."""

    classes: Dict[str, Tuple[float, float]]
    meta: dict = dataclasses.field(default_factory=dict)

    def alpha(self, cls: str) -> float:
        return self.classes[cls][0]

    def beta(self, cls: str) -> float:
        return self.classes[cls][1]

    def round_time(self, cls: str, nbytes: float) -> float:
        a, b = self.classes[cls]
        return a + nbytes / b

    # -- JSON artifact (read by both packages) -------------------------------

    def to_dict(self) -> dict:
        return {"magic": _MAGIC, "version": _VERSION,
                "classes": {k: {"alpha": a, "beta": b}
                            for k, (a, b) in self.classes.items()},
                "meta": self.meta}

    @classmethod
    def from_dict(cls, d: dict) -> "CalibratedCost":
        if d.get("magic") != _MAGIC:
            raise ValueError(f"not a {_MAGIC} artifact: {d.get('magic')!r}")
        return cls(classes={k: (float(v["alpha"]), float(v["beta"]))
                            for k, v in d["classes"].items()},
                   meta=d.get("meta", {}))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "CalibratedCost":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def _fit_hockney(sizes: Sequence[float], times: Sequence[float],
                 ) -> Tuple[float, float, float]:
    """Least-squares t = alpha + s/beta; returns (alpha, beta, resid).
    alpha is clamped non-negative and beta positive (a noisy timing ladder
    can produce a slightly negative intercept or slope)."""
    s = np.asarray(sizes, dtype=float)
    t = np.asarray(times, dtype=float)
    A = np.stack([np.ones_like(s), s], axis=1)
    (a, inv_b), res, _, _ = np.linalg.lstsq(A, t, rcond=None)
    a = max(float(a), 0.0)
    inv_b = max(float(inv_b), 1e-18)
    resid = float(np.sqrt(res[0] / len(t))) if len(res) else 0.0
    return a, 1.0 / inv_b, resid


def ring_row_bytes(nbytes: int) -> int:
    """The packet row ``measure_round`` moves for ``nbytes`` per link: the
    reference's float32 row (``max(1, nbytes // 4)`` elements) rounded up
    to the 16-byte chunks the round-step kernels move."""
    used = max(1, int(nbytes) // 4) * 4
    return -(-used // 16) * 16


def ring_round(n: int, nbytes: int, device="cuda",
               iters: int = 32) -> Tuple[torch.Tensor, Moves]:
    """The buffer and moves of ``measure_round``: ``[n, 2, row]`` uint8
    packet buffers on ``device`` (row 0 random bytes from seed 0, row 1
    zero) and ``iters`` sub-rounds of the full ring matching ``v - 1 -> v``,
    each writing row 1 of every device from row 0 of its predecessor (the
    reference's ``round_step(buf, rec, 1, True, 0, True)`` after a
    ``ppermute`` over ``(i, i + 1)``). After any of them, row 1 of device v
    equals row 0 of device v - 1."""
    dev = resolve_device(device)
    row = ring_row_bytes(nbytes)
    g = torch.Generator(device=dev).manual_seed(0)
    buf = torch.zeros((n, 2, row), dtype=torch.uint8, device=dev)
    buf[:, 0] = torch.randint(0, 256, (n, row), dtype=torch.uint8,
                              device=dev, generator=g)
    v = np.arange(n)
    tab = np.stack([(v - 1) % n, np.zeros(n), np.ones(n), np.ones(n),
                    np.ones(n)]).astype(np.int32)
    moves = compact_moves(np.broadcast_to(tab, (iters, 5, n)), 2)
    return buf, moves.to(dev)


def ring_delivered(buf: torch.Tensor) -> bool:
    """Row 1 of every device equals row 0 of its ring predecessor."""
    return torch.equal(buf[:, 1], torch.roll(buf[:, 0], 1, dims=0))


def measure_round(n: int, nbytes: int, *, device="cuda", iters: int = 32,
                  reps: int = 5) -> float:
    """Measured seconds for one executor round at ``nbytes`` per link on
    ``n`` virtual devices: a full ring matching (every device sends -- the
    all-links-busy case the Hockney per-link charge models), ``iters`` of
    them in one ``permute_rounds`` launch (``ring_round``); the minimum of
    ``reps`` timed launches after a warm-up, divided by ``iters``. Timed
    with ``torch.cuda.Event`` on a GPU and ``perf_counter`` on the CPU
    (the plain round step); any other device raises. Raises
    ``RuntimeError`` if the rounds did not deliver (``ring_delivered``)."""
    dev = resolve_device(device)
    buf, moves = ring_round(n, nbytes, dev, iters)
    best = float("inf")
    for i in range(reps + 1):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            permute_rounds(buf, moves, 0, iters)
            end.record()
            end.synchronize()
            t = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            permute_rounds(buf, moves, 0, iters)
            t = time.perf_counter() - t0
        if i:                                   # launch 0 is the warm-up
            best = min(best, t)
    if not ring_delivered(buf):
        raise RuntimeError(f"the ring rounds on {n} devices at {nbytes} B "
                           f"did not deliver row 0 to the successor")
    return best / iters


def calibrate(topo: Optional[Topology], n: Optional[int] = None, *,
              device="cuda", sizes: Optional[Sequence[int]] = None,
              iters: int = 32, reps: int = 5, cls: Optional[str] = None,
              emulated: Optional[bool] = None) -> CalibratedCost:
    """Fit Hockney alpha/beta for the fabric's link class on ``n`` virtual
    devices (``topo.num_nodes`` by default) of ``device``.

    The class name defaults to the fabric's link preset (what the plan's
    simulator charge is keyed by) so :func:`apply_calibration` finds it;
    homogeneous fabrics have one class, which is all a flat mesh can
    measure. ``emulated`` defaults to True: the virtual mesh's links are
    the card's memory, not a fabric."""
    dev = resolve_device(device)
    if n is None:
        n = topo.num_nodes
    if sizes is None:
        sizes = (1 << 10, 8 << 10, 64 << 10, 256 << 10, 1 << 20)
    times = [measure_round(n, s, device=dev, iters=iters, reps=reps)
             for s in sizes]
    a, b, resid = _fit_hockney(sizes, times)
    if cls is None:
        cls = getattr(topo, "_preset", None) or "host"
    meta = {"backend": dev.type, "num_devices": int(n),
            "emulated": True if emulated is None else bool(emulated),
            "axis": None,                       # the virtual mesh has none
            "sizes": [int(s) for s in sizes], "round_seconds": times,
            "fit_residual_seconds": resid, "iters": iters, "reps": reps,
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
            "row_bytes": [ring_row_bytes(s) for s in sizes]}
    return CalibratedCost(classes={cls: (a, b)}, meta=meta)


def apply_calibration(topo: Topology, cost: CalibratedCost,
                      cls: Optional[str] = None) -> Topology:
    """A copy of the fabric whose link constants are the fitted ones.

    The copy gets a new name and (through the changed constants) a new
    ``topology_fingerprint``, so plans built against hardcoded presets are
    rebuilt rather than silently reused. Flat fabrics only -- hierarchical
    link classes (nic/trunk) need per-class measurement a flat mesh cannot
    provide."""
    if getattr(topo, "hierarchical", False):
        raise ValueError("apply_calibration supports flat fabrics only")
    if cls is None:
        cls = getattr(topo, "_preset", None)
        if cls not in cost.classes:
            cls = next(iter(cost.classes))
    a, b = cost.classes[cls]
    t = copy.copy(topo)
    t.name = f"{topo.name}@{cls}"
    t._lat = a
    t._bw = b
    return t


@dataclasses.dataclass
class PredictionRow:
    """One (topology, message size) line of the calibration report."""

    topo: str
    candidate: str
    nbytes: float
    num_cycles: int
    predicted_cycle_s: float
    measured_cycle_s: float

    @property
    def rel_err(self) -> float:
        m = self.measured_cycle_s
        return abs(self.predicted_cycle_s - m) / m if m > 0 else 0.0


def predict_cycle_time(ex, cost: CalibratedCost,
                       cls: Optional[str] = None) -> float:
    """Fitted-model prediction of one pipeline cycle: the d sub-round
    matchings serialize, each shipping one packet row per device (the
    reference's row: float32 elements, not the 16-byte padded row the
    runner moves)."""
    if cls is None:
        cls = getattr(ex.topo, "_preset", None)
        if cls not in cost.classes:
            cls = next(iter(cost.classes))
    sched = ex.schedule
    elems = max(1, int(ex.nbytes) // 4)
    rows = sched.K * ex.num_groups
    row_bytes = (-(-elems // rows)) * 4
    return sched.d * cost.round_time(cls, row_bytes)


def prediction_report(executables: Sequence, cost: CalibratedCost,
                      reps: int = 5) -> List[PredictionRow]:
    """Predicted-vs-measured per-cycle time for each executable: its
    ``measure()`` (one ``permute_rounds`` launch a broadcast on a GPU)
    over its cycle count, beside :func:`predict_cycle_time`."""
    rows = []
    for ex in executables:
        cycles = ex.schedule.num_cycles(ex.num_groups)
        measured = ex.measure(reps=reps) / cycles
        rows.append(PredictionRow(
            topo=ex.topo.name, candidate=ex.candidate, nbytes=ex.nbytes,
            num_cycles=cycles, predicted_cycle_s=predict_cycle_time(ex, cost),
            measured_cycle_s=measured))
    return rows
