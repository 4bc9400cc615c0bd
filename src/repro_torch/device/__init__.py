"""Device execution of BBS plans on n virtual devices of one card.

``repro_torch.api.compile(topo).executable(root, nbytes)`` compiles a plan
into an :class:`ExecutablePlan`: static per-sub-round tables
(``schedule``), the cycle loop (``runner``) and its round step
(``round_step``): on a GPU one launch of a hand-written persistent CUDA
kernel for every sub-round of a broadcast (``permute_rounds``), beside the
one-sub-round kernel ``permute_step``. ``carry`` imports schedules the JAX
package compiled.
"""

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
    "import_schedule", "DeviceDelivery", "ExecutablePlan", "build_executable",
    "Moves", "compact_moves", "permute_rounds", "permute_rounds_ref",
    "permute_step", "permute_step_ref", "bbs_broadcast", "binomial_broadcast",
    "build_moves", "build_tables", "chain_broadcast", "DeviceSchedule",
    "NotDeviceExecutable", "make_device_schedule",
]
