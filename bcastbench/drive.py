"""One run of a cell, after the look for its card: ``virtual`` runs it,
then the result line's fields and the checks. ``run.py`` calls it on CUDA;
the tests call it on the CPU with faults planted underneath."""

from __future__ import annotations

from typing import Tuple

from bcastbench import devtrace, harness, virtual
from bcastbench.harness import log


def drive(cell, seed: int, seconds: float, trace: bool, t_start: float,
          device: str = "cuda") -> Tuple[dict, dict]:
    """Run ``cell`` once; returns the result line (without its checks)
    and the checks."""
    out = virtual.run(cell, seed, seconds, trace, t_start, device)
    rec = out["rec"]
    card = harness.power_limit() if device == "cuda" else device
    log(f"[device] {card}; {len(rec.served)} requests "
        f"in {rec.window_s:.3f} s")
    result = {"correct": harness.checks_pass(out["checks"]),
              "attempted": len(rec.served),
              "failed": len(rec.served) - len(rec.done),
              "metrics": harness.read_metrics(cell, rec, trace),
              "device": out["device"]}
    if trace and rec.trace is not None:
        result["device"]["busy_s"] = rec.trace.busy_s
        result["device"]["window_s"] = rec.trace.window_s
        result["breakdown"] = devtrace.breakdown(rec.trace, out["label"])
    elif trace and device == "cuda":
        log("[trace] the profiler gave no device events")
    return result, out["checks"]
