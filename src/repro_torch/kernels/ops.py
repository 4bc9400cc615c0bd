"""Public entry points of the port's kernels.

``ssd`` takes the hand-written kernel K3 (``ssd_scan``) for every CUDA
tensor. For a CPU tensor it dispatches as the reference's XLA path does:
the chunked plain version when ``seq > 16``, the sequential scan otherwise.
There is no flag that picks a path: the device of the tensor does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ssd_scan import ssd_scan


def ssd(x, dt, A, B, C) -> torch.Tensor:
    if x.device.type != "cpu":
        return ssd_scan(x, dt, A, B, C)
    if x.shape[1] > 16:
        return ref.ssd_chunked(x, dt, A, B, C)
    return ref.ssd_ref(x, dt, A, B, C)


def rmsnorm(x, w):
    return ref.rmsnorm_ref(x, w)
