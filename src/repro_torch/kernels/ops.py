"""Public entry points of the port's kernels.

``attention`` takes the hand-written kernel K2 (``flash_attention``) and
``ssd`` the kernel K3 (``ssd_scan``) for every CUDA tensor. For a CPU
tensor each dispatches as the reference's XLA path does: attention in one
product (``attention_ref``) unless ``S * T > 1024 * 2048``, then over kv
blocks (``attention_blockwise``); the chunked SSD when ``seq > 16``, the
sequential scan otherwise. There is no flag that picks a path: the device
of the tensor does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_scan


def attention(q, k, v, causal: bool = True) -> torch.Tensor:
    if q.device.type != "cpu":
        return flash_attention(q, k, v, causal=causal)
    if q.shape[2] * k.shape[2] > 1024 * 2048:
        return ref.attention_blockwise(q, k, v, causal=causal)
    return ref.attention_ref(q, k, v, causal=causal)


def ssd(x, dt, A, B, C) -> torch.Tensor:
    if x.device.type != "cpu":
        return ssd_scan(x, dt, A, B, C)
    if x.shape[1] > 16:
        return ref.ssd_chunked(x, dt, A, B, C)
    return ref.ssd_ref(x, dt, A, B, C)


def rmsnorm(x, w):
    return ref.rmsnorm_ref(x, w)
