"""The fault-tolerant training supervisor, the port of
``repro.runtime.supervisor``.

  * periodic atomic checkpoints (keep-last-k) and resume from a newer one;
  * step retry: an exception in a step (an injected fault, a non-finite
    loss) rolls back to the newest checkpoint and continues; the data
    pipeline is keyed by step, so replayed batches are identical;
  * stragglers: a step slower than ``straggler_factor`` times the median of
    the last 64 (once 8 are in) is logged and counted.

A step's wall time ends when ``float(metrics["loss"])`` has read the loss,
which waits for the device's work, as in the reference. Unlike the
reference's functional step, the port's updates the state in place, so a
rollback copies the checkpoint into the live tensors; a step that fails
after its update with no checkpoint yet is retried from the state it left
(a non-finite loss then repeats until the retries run out and it raises,
as the reference's deterministic retry does). On a mesh the state is
DTensors, and the checkpoints gather and re-place them
(``checkpoint.store``). ``remesh(state, new_shardings)`` is the elastic
rescale: every tensor re-placed on the new mesh from its whole value
(``runtime.steps.place``), as the reference re-places with ``device_put``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import statistics
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint.store import CheckpointManager
from repro_torch.runtime.steps import place

log = logging.getLogger("repro_torch.supervisor")


@dataclasses.dataclass
class StepStats:
    times: List[float] = dataclasses.field(default_factory=list)
    stragglers: int = 0
    retries: int = 0
    restores: int = 0

    def record(self, dt: float, factor: float = 2.0) -> bool:
        self.times.append(dt)
        window = self.times[-64:]
        if len(window) >= 8:
            med = statistics.median(window)
            if dt > factor * med:
                self.stragglers += 1
                return True
        return False


class TrainSupervisor:
    """Wraps a step function with checkpoint/restart and straggler
    accounting."""

    def __init__(self, step_fn: Callable, batch_fn: Callable[[int], Any],
                 ckpt: CheckpointManager, ckpt_every: int = 50,
                 max_retries: int = 3, straggler_factor: float = 2.0,
                 fault_hook: Optional[Callable[[int], None]] = None):
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.straggler_factor = straggler_factor
        self.fault_hook = fault_hook       # tests inject failures here
        self.stats = StepStats()

    def run(self, state: Dict, start_step: int, num_steps: int,
            log_every: int = 10) -> Dict:
        """state: dict(params=..., opt=...). Returns the final state, with
        the losses of the steps it ran under ``history``."""
        step = start_step
        # resume if a newer checkpoint exists
        latest = self.ckpt.latest()
        if latest is not None and latest > step:
            state, _ = self._restore(state, latest)
            step = latest
            log.info("resumed from checkpoint step %d", step)

        history = []
        while step < num_steps:
            batch = self.batch_fn(step)
            for attempt in range(self.max_retries + 1):
                try:
                    if self.fault_hook is not None:
                        self.fault_hook(step)
                    t0 = time.perf_counter()
                    state2, metrics = self._apply(state, batch)
                    loss = float(metrics["loss"])
                    if not math.isfinite(loss):
                        raise FloatingPointError(f"loss={loss} at {step}")
                    dt = time.perf_counter() - t0
                    if self.stats.record(dt, self.straggler_factor):
                        log.warning("straggler step %d: %.3fs", step, dt)
                    state = state2
                    history.append(loss)
                    break
                except Exception as e:   # noqa: BLE001 -- the FT boundary
                    self.stats.retries += 1
                    log.warning("step %d failed (%s); attempt %d", step, e,
                                attempt + 1)
                    latest = self.ckpt.latest()
                    if latest is not None:
                        state, _ = self._restore(state, latest)
                        self.stats.restores += 1
                        step = latest
                        batch = self.batch_fn(step)
                    if attempt == self.max_retries:
                        raise
            step += 1
            if step % self.ckpt_every == 0 or step == num_steps:
                self.ckpt.save(step, state, extra=dict(
                    loss=history[-1] if history else None))
            if log_every and step % log_every == 0 and history:
                log.info("step %d loss %.4f", step, history[-1])
        state["history"] = history
        return state

    def _apply(self, state, batch):
        params, opt, metrics = self.step_fn(state["params"], state["opt"],
                                            batch)
        return dict(params=params, opt=opt), metrics

    def _restore(self, like_state, step):
        like = dict(params=like_state["params"], opt=like_state["opt"])
        return self.ckpt.restore(like, step=step)


def remesh(state: Dict, new_shardings: Dict) -> Dict:
    """Elastic rescale: re-place every tensor with the new mesh's shardings
    (the caller built ``new_shardings`` from the surviving ranks)."""
    return place(state, new_shardings)
