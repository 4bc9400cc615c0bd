"""Public entry points of the port's kernels.

``attention`` takes the hand-written kernel K2 (``flash_attention``) and
``ssd`` the kernel K3 (``ssd_scan``) for every CUDA tensor. For a CPU
tensor each dispatches as the reference's XLA path does: attention in one
product (``attention_ref``) unless ``S * T > 1024 * 2048``, then over kv
blocks (``attention_blockwise``); the chunked SSD when ``seq > 16``, the
sequential scan otherwise. There is no flag that picks a path: the tensor
does.

On a mesh (DTensor inputs) ``attention`` runs on the local shards through
``local_map``, placed by the sharding rules: batch on the data axes (the
``batch`` rule), heads on ``model`` (``kv_heads``, judged on the kv head
count so that every q head stays with its kv head), the rest whole. Where
the rule falls back to replicated (kv heads that the model axis does not
divide), every rank of the model axis sees all the heads of its batch
shard and computes the same result. The local call is this module's own,
so a CUDA shard launches the kernel. ``ssd`` is reached on local shards
already: the Mamba-2 block runs its whole SSD part in one ``local_map``
(``models.mamba2``).

A fake tensor (the dry-run, ``runtime.cost``) takes
``torch.ops.repro_torch.attention_shape`` / ``ssd_shape``: custom ops
whose only implementation gives the output's shape and dtype (for fake
and meta tensors), and whose FLOPs ``runtime.cost`` counts by formula.
For a tensor with data, CPU or CUDA, they raise, and ``ops`` never routes
one there; a ``meta`` tensor given to ``attention`` or ``ssd`` still
raises in the kernel's wrapper, as for any device without the kernel.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.grad import kernel_with_grad
from repro_torch.kernels.ssd_scan import ssd_scan


def _abstract(t: torch.Tensor) -> bool:
    """A fake tensor (``FakeTensorMode``): shapes with no data."""
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)


@torch.library.custom_op("repro_torch::attention_shape", mutates_args=())
def attention_shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool) -> torch.Tensor:
    raise RuntimeError("attention_shape has no implementation for a tensor "
                       "with data: it stands in for K2 on fake and meta "
                       "tensors only")


@attention_shape.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::ssd_shape", mutates_args=())
def ssd_shape(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    raise RuntimeError("ssd_shape has no implementation for a tensor with "
                       "data: it stands in for K3 on fake and meta tensors "
                       "only")


@ssd_shape.register_fake
def _(x, dt, A, B, C):
    return torch.empty_like(x)


_ATTN = ("batch", "kv_heads", None, None)


def attention(q, k, v, causal: bool = True) -> torch.Tensor:
    if isinstance(q, DTensor):
        # heads are judged on k (the kv count); q splits the same way
        from repro_torch.runtime import sharding as shd
        axis = dict(zip(_ATTN, shd.spec_for(k.device_mesh, _ATTN, k.shape)))
        return shd.on_shards(lambda *a: attention(*a, causal=causal),
                             (q, k, v), (_ATTN,) * 3, (_ATTN,), axis)
    if _abstract(q):
        return kernel_with_grad(
            lambda q, k, v: attention_shape(q, k, v, causal),
            lambda q, k, v: ref.attention_ref(q, k, v, causal=causal),
            q, k, v)
    if q.device.type != "cpu":
        return flash_attention(q, k, v, causal=causal)
    if q.shape[2] * k.shape[2] > 1024 * 2048:
        return ref.attention_blockwise(q, k, v, causal=causal)
    return ref.attention_ref(q, k, v, causal=causal)


def ssd(x, dt, A, B, C) -> torch.Tensor:
    if _abstract(x):
        return kernel_with_grad(ssd_shape, ref.ssd_chunked, x, dt, A, B, C)
    if x.device.type != "cpu":
        return ssd_scan(x, dt, A, B, C)
    if x.shape[1] > 16:
        return ref.ssd_chunked(x, dt, A, B, C)
    return ref.ssd_ref(x, dt, A, B, C)


def rmsnorm(x, w):
    return ref.rmsnorm_ref(x, w)
