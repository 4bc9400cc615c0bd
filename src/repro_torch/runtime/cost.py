"""Per-device cost of a traced step, the counterpart of
``repro.runtime.hlo_cost``.

The reference parses the optimized HLO after SPMD partitioning, where
shapes are per device, and sums matmul FLOPs, matmul bytes and collective
bytes. The port has no HLO: ``CostMode`` is a dispatch mode that watches
the local ops of one rank while a step runs on DTensors (under
``FakeTensorMode`` in the dry-run, so nothing is allocated), and counts

  * matmul FLOPs, ``2 * prod(result dims) * contraction`` per ``mm``,
    ``bmm``, ``addmm`` or ``baddbmm`` (einsum and matmul reach these);
  * matmul bytes (``dot_bytes``): operand and result bytes per matmul;
  * collective result bytes and counts per kind: ``all_gather_into_tensor``
    (all-gather), ``all_reduce`` (all-reduce), ``reduce_scatter_tensor``
    (reduce-scatter) and ``all_to_all_single`` (all-to-all) of
    ``torch.distributed._functional_collectives``; DTensor issues no
    permute, so ``collective-permute`` stays 0.

A DTensor-level op is passed on (``NotImplemented``) so that DTensor
desugars it into the local ops counted here. DTensor also runs each new
op once on fake tensors of the global shapes to infer its output's shape,
under the active fake mode when there is one; while a ``CostMode`` is
active that inference runs with every dispatch mode set aside, so neither
this mode nor a ``MemTracker`` beside it sees global shapes
(``ShardingPropagator._propagate_tensor_meta_non_cached`` is wrapped for
the duration). The reference's counts are per device on post-SPMD shapes;
so are these, on the local shards.

K2 and K3 appear as ``repro_torch::attention_shape`` and ``ssd_shape``
(``kernels.ops``) on fake tensors, and are counted by formula: the matmuls
their plain versions run (``attention_ref``'s two products;
``ssd_chunked``'s four, or the sequential scan's two a step at 16 steps or
fewer), which is what the reference's XLA path counts, its models never
reaching Pallas. Their backward is the plain version itself
(``kernels.grad``), whose matmuls are counted as they run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    dot_bytes: float = 0.0
    collective_bytes: Dict[str, float] = None
    collective_counts: Dict[str, float] = None

    def __post_init__(self):
        if self.collective_bytes is None:
            self.collective_bytes = {k: 0.0 for k in COLLECTIVES}
        if self.collective_counts is None:
            self.collective_counts = {k: 0.0 for k in COLLECTIVES}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _f32(*shape) -> int:
    return 4 * math.prod(shape)


def attention_cost(q, k):
    """(FLOPs, matmul bytes) of ``attention_ref`` on q (B, Hq, S, D) and k
    (B, Hkv, T, D): the float32 logits product and the probabilities times
    v; the mask does not change a dense product's work."""
    b, hq, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    flops = 2.0 * b * hq * s * t * d * 2
    logits = _f32(b, hq, s, t)
    qb, kb, ob = _f32(b, hq, s, d), _f32(b, hkv, t, d), _f32(b, hq, s, d)
    return flops, float(qb + kb + logits + logits + kb + ob)


def ssd_cost(x, B):
    """(FLOPs, matmul bytes) of the plain SSD on x (B, S, H, dh) and B
    (B, S, H, ds): ``ssd_chunked``'s four products (C.B within a chunk, its
    weights times x, the chunk-end states, the carried states' output)
    when S > 16, else the sequential scan's outer product and read-out a
    step."""
    b, s, h, dh = x.shape
    ds = B.shape[-1]
    if s <= 16:
        flops = 2.0 * b * s * h * ds * dh * 2
        return flops, float(s * (_f32(b, h, ds) + _f32(b, h, dh) +
                                 2 * _f32(b, h, ds, dh) + _f32(b, h, ds) +
                                 _f32(b, h, dh)))
    lc = min(128, s)
    nc = -(-s // lc)
    flops = 2.0 * b * nc * lc * h * (lc * ds + lc * dh + ds * dh + ds * dh)
    xb, bb = _f32(b, nc, lc, h, dh), _f32(b, nc, lc, h, ds)
    cb = _f32(b, nc, lc, lc, h)
    st = _f32(b, nc, h, ds, dh)
    return flops, float((bb + bb + cb) + (cb + xb + xb) + (bb + xb + st) +
                        (bb + st + xb))


_MATMULS = {"aten.mm.default": 0, "aten.addmm.default": 1,
            "aten.bmm.default": 0, "aten.baddbmm.default": 1}
_COLL = {"_c10d_functional.all_gather_into_tensor.default": "all-gather",
         "_c10d_functional.all_reduce.default": "all-reduce",
         "_c10d_functional.reduce_scatter_tensor.default": "reduce-scatter",
         "_c10d_functional.all_to_all_single.default": "all-to-all"}


class CostMode(TorchDispatchMode):
    """Counts one rank's local matmuls and collectives into ``self.cost``
    (module docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = HloCost()

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        from torch.utils._python_dispatch import _disable_current_modes

        self._infer = ShardingPropagator._propagate_tensor_meta_non_cached
        infer = self._infer

        def unseen(prop, op_schema):
            with _disable_current_modes():
                return infer(prop, op_schema)

        ShardingPropagator._propagate_tensor_meta_non_cached = unseen
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator

        ShardingPropagator._propagate_tensor_meta_non_cached = self._infer
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self._count(str(func), args, out)
        return out

    def _count(self, name: str, args, out) -> None:
        c = self.cost
        if name in _MATMULS:
            a, b = args[_MATMULS[name]], args[_MATMULS[name] + 1]
            c.flops += 2.0 * out.numel() * a.shape[-1]
            c.dot_bytes += float(_nbytes(a) + _nbytes(b) + _nbytes(out))
        elif name == "repro_torch.attention_shape.default":
            f, b = attention_cost(args[0], args[1])
            c.flops += f
            c.dot_bytes += b
        elif name == "repro_torch.ssd_shape.default":
            f, b = ssd_cost(args[0], args[3])
            c.flops += f
            c.dot_bytes += b
        elif name in _COLL:
            kind = _COLL[name]
            c.collective_bytes[kind] += float(sum(
                _nbytes(t) for t in tree_leaves(out)
                if isinstance(t, torch.Tensor)))
            c.collective_counts[kind] += 1
