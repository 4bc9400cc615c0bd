"""Flash attention (K2): hand-written CUDA kernel and wrapper.

``flash_attention(q, k, v, causal, scale)`` computes the function of the
reference's Pallas kernel (``repro.kernels.flash_attention``): q
(B, Hq, S, D), k and v (B, Hkv, T, D) with ``Hq % Hkv == 0``, q head
``j * g + i`` reading kv head ``j``; with ``causal`` query row r sees key
columns ``c <= r + (T - S)``; scale ``1/sqrt(D)`` (float32) unless given;
float32 accumulation; a fully-masked row gives 0; the output in q's dtype.

On a CUDA tensor it launches ``csrc/flash_attention.cu`` on the current
stream and counts the launch in ``launches``. The kernel is chosen by dtype
inside the one entry point: bfloat16 runs on the tensor cores (persistent
blocks, one per SM, take (batch, q head, 128 query rows) items from a
counter this wrapper zeroes; in each, a TMA producer warpgroup and two
wgmma consumer warpgroups of 64 rows, P rounded to bfloat16 for P.V);
float32 runs exact on the FMA units (one block per (batch, q head, 64 query
rows)). Both take D in {16, 32, 64, 112, 128} (bfloat16 runs D 112 on the
D 128 kernel, TMA filling the missing columns with zeros) and read every
tensor by strides
as long as its last (d) stride is 1, so the model's (B, S, H, D)
projections viewed as (B, H, S, D) need no copy; the output has q's
strides. bfloat16 inputs also need what TMA needs: 16-byte-aligned base
addresses and strides that are multiples of 16 bytes. On a CPU tensor it
runs the plain version ``repro_torch.kernels.ref.attention_ref``; on any
other device, or on inputs the kernel does not take, it raises. It never
falls back from the kernel to the plain version, nor from one kernel to
the other. When grad is enabled and an input requires grad, the launch
goes through ``grad.KernelGrad``: the kernel's output, and a backward that
recomputes ``attention_ref`` (with the same ``causal`` and ``scale``)
under autograd; otherwise the kernel is launched directly.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.grad import kernel_with_grad

HEAD_DIMS = (16, 32, 64, 112, 128)

launches = 0               # kernel launches of flash_attention since reset
_MAP_ERROR = 10000         # the C entry's code for a tensor map it cannot build

_lib = None


def _kernel():
    """The loaded library, built at first use."""
    global _lib
    if _lib is None:
        from repro_torch.nvcc import load
        lib = load("flash_attention")
        lib.flash_attention.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_float,
                                  ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p, ctypes.c_void_p]
        lib.flash_attention.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_strides(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   ) -> Tuple[int, ...]:
    """Checks that the kernel takes these inputs (one dtype, float32 or
    bfloat16; D in ``HEAD_DIMS``; d stride 1; sizes in int32; at least one
    key; for bfloat16, TMA's 16-byte-aligned base addresses and strides)
    and returns the (batch, head, row) strides of q, k and v, in
    elements."""
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share one dtype, float32 or "
                         f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[3]} is not one the kernel takes "
                         f"{HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} must have a contiguous last (d) "
                             f"dimension; strides {t.stride()}")
        if max(t.shape) >= 2 ** 31:
            raise ValueError(f"{name} has a dimension past int32: "
                             f"{tuple(t.shape)}")
        if t.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(x * 2 % 16 for x in t.stride()[:3])):
            raise ValueError(f"{name} must have a 16-byte-aligned base "
                             f"address and strides of 16-byte multiples "
                             f"(TMA); address {t.data_ptr()}, strides "
                             f"{t.stride()}")
    if k.shape[2] == 0:
        raise ValueError("k and v have no keys (T = 0)")
    return tuple(s for t in (q, k, v) for s in t.stride()[:3])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention (module docstring): the CUDA kernel for CUDA tensors,
    ``ref.attention_ref`` for CPU tensors."""
    d = ref.attention_dims(q, k, v)[6]
    devs = {x.device for x in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"q, k and v lie on several devices: {devs}")
    scale = ref.default_scale(d) if scale is None else float(scale)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")

    def kernel(q, k, v):
        return _launch(q, k, v, causal, scale)

    def plain(q, k, v):
        return ref.attention_ref(q, k, v, causal=causal, scale=scale)

    return kernel_with_grad(kernel, plain, q, k, v)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, scale: float) -> torch.Tensor:
    """One launch of the kernel on CUDA inputs; checks what the kernel
    takes (``kernel_strides``), counts the launch."""
    global launches
    b, hq, hkv, _, s, t, d = ref.attention_dims(q, k, v)
    strides = kernel_strides(q, k, v)
    o = torch.empty_like(q)                      # q's strides, d contiguous
    if o.numel() == 0:
        return o
    lib = _kernel()
    arr = (ctypes.c_longlong * 12)(*strides, *o.stride()[:3])
    bf16 = q.dtype == torch.bfloat16
    # the bf16 kernel's work counter: persistent blocks take items from it
    counter = torch.zeros(1, dtype=torch.int32, device=q.device) if bf16 \
        else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), b, hq, hkv, s, t, d, arr,
                                 scale, int(causal), int(bf16),
                                 counter.data_ptr() if bf16 else None,
                                 stream)
    if rc >= _MAP_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled failed "
                           f"with CUresult {rc - _MAP_ERROR}")
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return o
