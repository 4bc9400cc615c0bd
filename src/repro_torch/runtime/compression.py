"""Gradient compression for the data-parallel all-reduce, the port of
``repro.runtime.compression``.

int8 quantization with error feedback (EF-SGD): each worker quantizes its
local gradient to int8 with a per-tensor scale, all-reduces the int8
payload widened to int32, dequantizes, and carries the quantization
residual into the next step. The arithmetic is the reference's: the scale
is ``max|g| / 127 + 1e-12`` in ``g``'s dtype, the rounding half to even
(``torch.round``, as ``jnp.round``), the clip to [-127, 127]; error
feedback adds the residual in float32.

``psum_compressed(q, scales, group)`` sums the int32 payloads over a
``torch.distributed`` group and averages the scales, as the reference's
``psum`` over a mesh axis does. That is exact only where the workers'
scales agree: each worker quantized with its own scale, and the sum of
their integers is then multiplied by the mean scale (ROADMAP reference
fault 10). The port keeps the arithmetic. As in the reference, no step
calls it.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_grads(grads: Mapping[str, torch.Tensor],
                      residual: Mapping[str, torch.Tensor]):
    """Apply error feedback, then quantize: ``(q, scales, new_residual)``,
    each a dict with the keys of ``grads``."""
    qs, ss, rs = {}, {}, {}
    for k, g in grads.items():
        gf = g.to(torch.float32) + residual[k]
        qs[k], ss[k] = quantize_int8(gf)
        rs[k] = gf - dequantize_int8(qs[k], ss[k])
    return qs, ss, rs


def psum_compressed(q_tree: Mapping[str, torch.Tensor],
                    scale_tree: Mapping[str, torch.Tensor],
                    group=None) -> Dict[str, torch.Tensor]:
    """All-reduce int8 payloads over ``group``: widen to int32 for the sum
    (no saturation), average the scales (module docstring)."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    out = {}
    for k, q in q_tree.items():
        summed = q.to(torch.int32)
        dist.all_reduce(summed, group=group)
        scale = scale_tree[k].clone()
        dist.all_reduce(scale, group=group)
        out[k] = (summed.to(torch.float32) / n) * (scale / n)
    return out


def init_residual(params: Mapping[str, torch.Tensor]) -> Dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
