"""What every run shares: the set-up clock, the record the metric readers
read, the sample of outputs kept for the check, and the result line.

A run's stdout ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with a trace its
per-layer ones), ``device``, with a trace ``breakdown``, and last
``checks``: every number compared, as ``[value, limit]``, each passing
when the value is at most its limit. The same checks are the last lines
of stderr.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from bcastbench import traffic

# top-level module names no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class SetupClock:
    """Seconds from the process's start (``t0``, on ``perf_counter``),
    split into named phases; the first phase counts from ``t0``."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter() if self.phases else self.t0
        self.phases.setdefault(name, 0.0)
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + \
                time.perf_counter() - start

    def total(self) -> float:
        return time.perf_counter() - self.t0


@dataclasses.dataclass
class Served:
    """One request of the window: what was asked, its times on the host
    clock (``t0`` the call, ``t1`` once its output is ready), the
    sub-rounds its plan runs, and whether it raised."""

    root: int
    nbytes: int
    t0: float
    t1: float
    subrounds: int
    ok: bool = True

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class RunRecord:
    """What the metric readers (``metrics/<name>.py``) read."""

    cell: str
    n: int
    setup_s: float
    setup_phases: Dict[str, float]
    served: List[Served]
    window_s: float
    k1: Dict[str, int] = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None             # devtrace.DeviceTrace

    @property
    def done(self) -> List[Served]:
        return [s for s in self.served if s.ok]


def percentile(values: List[float], q: float) -> Optional[float]:
    """The ``q``-th percentile, interpolated between the closest ranks
    (numpy's default); None for no values."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Keeper:
    """The window's answers that the check compares once it has closed: the
    first answer of each shape in ``first``, and the window's last answer.

    A first answer is copied, after its request's span, into its shape's
    block of ``spare`` (``spare_blocks``) and the card waits for the copy,
    so the program's own blocks are free again before the next request and
    the window allocates nothing. The last answer is kept as it is: no
    request follows it."""

    def __init__(self, first, spare: Optional[Dict[tuple, torch.Tensor]]
                 = None):
        self.todo = set(first)
        self.spare = spare or {}
        self.kept: List[tuple] = []

    def offer(self, req: traffic.Request, out: Optional[torch.Tensor],
              last: bool = False) -> None:
        shape = (req.root, req.nbytes)
        if out is None or not (last or shape in self.todo):
            return
        self.todo.discard(shape)
        block = None if last else self.spare.pop(shape, None)
        if block is not None:
            block.copy_(out.reshape(-1).view(torch.uint8))
            if block.is_cuda:
                torch.cuda.synchronize(block.device)
            out = block.view(out.dtype).view(out.shape)
        self.kept.append((req, out))


def window_keeps(shapes: List[tuple], out_bytes, budget: float
                 ) -> List[tuple]:
    """The shapes whose first answer in the window the check keeps: the
    smallest outputs first, as far as ``budget`` bytes reach."""
    keep, used = [], 0
    for shape in sorted(shapes, key=lambda s: (out_bytes(s[1]), s)):
        if used + out_bytes(shape[1]) > budget:
            break
        keep.append(shape)
        used += out_bytes(shape[1])
    return keep


def check_slots(seed: int, shapes: List[tuple], pool: int
                ) -> Dict[tuple, int]:
    """The payload slot of each shape's check request after the window,
    drawn from the seed."""
    g = traffic.rng(seed, 6)
    return {shape: int(g.integers(pool)) for shape in shapes}


def memory(device: torch.device) -> str:
    if device.type != "cuda":
        return "cpu"
    g = 1e9
    return (f"allocated {torch.cuda.memory_allocated(device) / g:.2f} GB, "
            f"reserved {torch.cuda.memory_reserved(device) / g:.2f} GB, "
            f"peak {torch.cuda.max_memory_allocated(device) / g:.2f} GB")


def spare_blocks(device: torch.device, shapes: List[tuple], out_bytes
                 ) -> Dict[tuple, torch.Tensor]:
    """One block of device memory for each shape whose first answer the
    check keeps (``Keeper``), exactly an output's size, taken before the
    warm-up makes the program's blocks."""
    if device.type != "cuda":
        return {}
    torch.cuda.empty_cache()
    return {s: torch.empty(out_bytes(s[1]), dtype=torch.uint8, device=device)
            for s in shapes}


def segments(device: torch.device) -> int:
    """How many times the caching allocator has asked the card for memory
    so far."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get(
        "segment.all.allocated", 0))


def store_bytes(path: Path) -> int:
    return sum(p.stat().st_size for p in path.rglob("*") if p.is_file()) \
        if path.exists() else 0


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"
    return out.stdout.strip().replace("\n", "; ") or "unknown"


def read_metrics(cell, rec: RunRecord, trace: bool) -> Dict[str, dict]:
    """Each of the cell's metrics by its reader; a reader that finds
    nothing to read returns None and its metric is left out."""
    out = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} &
                  set(FORBIDDEN))


def finish(result: dict, checks: Dict[str, list]) -> int:
    """Print the checks (stderr, last) and the result line (stdout, last),
    unless the process holds a forbidden module: then name it and fail
    without a result."""
    bad = forbidden_modules()
    if bad:
        log(f"[modules] this process holds {bad}, which the benchmark may "
            f"not load; no result")
        return 3
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, (value, limit) in checks.items():
        log(f"[check] {name} {value} limit {limit}")
    return 0


def checks_pass(checks: Dict[str, list]) -> bool:
    return all(v <= lim for v, lim in checks.values())
