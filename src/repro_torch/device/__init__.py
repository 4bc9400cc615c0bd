"""Device execution of BBS plans on n virtual devices of one card.

``repro_torch.api.compile(topo).executable(root, nbytes)`` compiles a plan
into an :class:`ExecutablePlan`: static per-sub-round tables
(``schedule``), the cycle loop (``runner``) and its round step
(``round_step``): on a GPU one launch of a hand-written persistent CUDA
kernel for every sub-round of a broadcast (``permute_rounds``), beside the
one-sub-round kernel ``permute_step``. ``calibrate`` fits Hockney
constants from timed ring rounds of that kernel and reports the
simulator's prediction against the measured broadcast. ``carry`` imports
schedules the JAX package compiled. ``distributed`` runs a plan across the
ranks of a ``torch.distributed`` group instead, one device a rank
(``ExecutablePlan.run(x, group=...)``).
"""

from repro_torch.device.calibrate import (CalibratedCost, PredictionRow,
                                          apply_calibration, calibrate,
                                          measure_round, predict_cycle_time,
                                          prediction_report)
from repro_torch.device.carry import import_schedule
from repro_torch.device.executable import (DeviceDelivery, ExecutablePlan,
                                           build_executable)
from repro_torch.device.round_step import (Moves, compact_moves,
                                           permute_rounds, permute_rounds_ref,
                                           permute_step, permute_step_ref)
from repro_torch.device.runner import (bbs_broadcast, binomial_broadcast,
                                       build_moves, build_tables,
                                       chain_broadcast)
from repro_torch.device.schedule import (DeviceSchedule, NotDeviceExecutable,
                                         make_device_schedule)

__all__ = [
    "CalibratedCost", "PredictionRow", "apply_calibration", "calibrate",
    "measure_round", "predict_cycle_time", "prediction_report",
    "import_schedule", "DeviceDelivery", "ExecutablePlan", "build_executable",
    "Moves", "compact_moves", "permute_rounds", "permute_rounds_ref",
    "permute_step", "permute_step_ref", "bbs_broadcast", "binomial_broadcast",
    "build_moves", "build_tables", "chain_broadcast", "DeviceSchedule",
    "NotDeviceExecutable", "make_device_schedule",
]
