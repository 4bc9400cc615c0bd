"""The Mamba-2 SSD chunked scan (K3): hand-written CUDA kernel and wrapper.

``ssd_scan(x, dt, A, B, C, chunk)`` computes the function of the
reference's Pallas kernel (``repro.kernels.ssd_scan``): the sequence is cut
into chunks of ``min(chunk, max(seq, 8))`` steps; within a chunk the output
is a masked, decay-weighted product, and the state ``h (ds, dh)`` is
carried from chunk to chunk. Shapes: x (batch, seq, heads, dhead), dt
(batch, seq, heads), A (heads,), B and C (batch, seq, heads, dstate); y is
like x. Float32 inside, y in x's dtype.

On a CUDA tensor it launches ``csrc/ssd_scan.cu`` on the current stream
and counts the launch in ``launches``. The kernel is chosen by dtype inside
the one entry point, never one in place of the other:

- bfloat16 runs on the tensor cores (``ssd_tc``): one block per (batch,
  head, chunk), taken chunk-major from a ticket counter, the carried state
  handed from block to block inside the launch; the float32 operands of its
  products are split into two bf16 terms. It takes dhead in (32, 64, 128),
  dstate in (16, 32, 64, 128) and a chunk of at most 128 steps; any other
  bfloat16 shape raises ``ValueError``. Its workspace, allocated here on
  the current stream for each call: ``1 + batch * heads`` int32 zeros (the
  ticket counter and the hand-off flags) and ``2 * batch * heads * dstate
  * dhead`` float32 state slots (8 MiB at the Mamba-2 370M prefill).
- float32 runs exact on the FMA units (``ssd_fma``: one block per (batch,
  head), the chunk loop inside the block); dhead and dstate multiples of
  4, and a chunk whose shared memory fits one block, else ``ValueError``.

On a CPU tensor it runs the plain version
``repro_torch.kernels.ref.ssd_chunked``; on any other device it raises. It
never falls back from a kernel to the plain version. When grad is enabled
and an input requires grad, the launch goes through ``grad.KernelGrad``:
the kernel's output, and a backward that recomputes ``ssd_chunked`` (with
the same ``chunk``) under autograd; otherwise the kernel is launched
directly.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.grad import kernel_with_grad

DEFAULT_CHUNK = 128
# shapes the bfloat16 (tensor-core) kernel takes
TC_HEAD_DIMS = (32, 64, 128)
TC_STATE_DIMS = (16, 32, 64, 128)
TC_MAX_CHUNK = 128

launches = 0               # kernel launches of ssd_scan since the last reset

_lib = None


def chunk_of(seq: int, chunk: int = DEFAULT_CHUNK) -> int:
    """The chunk the kernel uses for a sequence of ``seq`` steps."""
    return min(chunk, max(seq, 8))


def _kernel():
    """The loaded library, built at first use: ``ssd_scan`` launches,
    ``ssd_scan_smem`` reports the shared memory a launch needs and
    ``ssd_scan_smem_limit`` what the current device allows."""
    global _lib
    if _lib is None:
        from repro_torch.nvcc import load
        lib = load("ssd_scan")
        lib.ssd_scan.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3
        lib.ssd_scan.restype = ctypes.c_int
        lib.ssd_scan_smem.argtypes = [ctypes.c_int] * 4
        lib.ssd_scan_smem.restype = ctypes.c_longlong
        lib.ssd_scan_smem_limit.argtypes = []
        lib.ssd_scan_smem_limit.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, dt, A, B, C):
    if x.dim() != 4:
        raise ValueError(f"x must be (batch, seq, heads, dhead), got "
                         f"{tuple(x.shape)}")
    bsz, seq, h, dh = x.shape
    if tuple(dt.shape) != (bsz, seq, h) or tuple(A.shape) != (h,) or \
            B.dim() != 4 or tuple(B.shape[:3]) != (bsz, seq, h) or \
            B.shape != C.shape:
        raise ValueError(f"shapes do not fit: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    devs = {t.device for t in (x, dt, A, B, C)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """The SSD scan (module docstring): the CUDA kernel for CUDA tensors,
    ``ref.ssd_chunked`` for CPU tensors."""
    _check(x, dt, A, B, C)
    if x.device.type == "cpu":
        # one chunk either way where chunk_of differs from min(chunk, seq)
        return ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, not {x.device}")

    def kernel(x, dt, A, B, C):
        return _launch(x, dt, A, B, C, chunk)

    def plain(x, dt, A, B, C):
        return ref.ssd_chunked(x, dt, A, B, C, chunk=chunk)

    return kernel_with_grad(kernel, plain, x, dt, A, B, C)


def _launch(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """One launch of the kernel on CUDA inputs; checks what the kernel
    takes, counts the launch."""
    global launches
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            B.dtype != x.dtype or C.dtype != x.dtype:
        raise ValueError(f"x, B and C must share one dtype, float32 or "
                         f"bfloat16; got {x.dtype}, {B.dtype}, {C.dtype}")
    bsz, seq, h, dh = x.shape
    ds = B.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    lc = chunk_of(seq, chunk)
    if bf16 and (dh not in TC_HEAD_DIMS or ds not in TC_STATE_DIMS or
                 lc > TC_MAX_CHUNK):
        raise ValueError(f"the bfloat16 kernel takes dhead in {TC_HEAD_DIMS}, "
                         f"dstate in {TC_STATE_DIMS} and a chunk of at most "
                         f"{TC_MAX_CHUNK} steps; got dhead {dh}, dstate {ds}, "
                         f"chunk {lc}")
    if dh % 4 or ds % 4:
        raise ValueError(f"dhead {dh} and dstate {ds} must be multiples of 4")
    dt = dt.float().contiguous()
    A = A.float().contiguous()
    for name, t in (("x", x), ("B", B), ("C", C)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _kernel()
    work = slots = None
    with torch.cuda.device(x.device):
        smem, limit = lib.ssd_scan_smem(lc, dh, ds, int(bf16)), \
            lib.ssd_scan_smem_limit()
        if smem < 0 or smem > limit:
            raise ValueError(f"chunk {lc}, dhead {dh}, dstate {ds} in "
                             f"{x.dtype} do not fit one block (shared memory "
                             f"{smem} B of {limit}; -1: too many output "
                             f"rows); use a smaller chunk")
        if bf16:
            # the ticket counter and the flags of the state hand-off (0 at
            # launch), and two float32 state slots per (batch, head)
            work = torch.zeros(1 + bsz * h, dtype=torch.int32,
                               device=x.device)
            slots = torch.empty(2 * bsz * h * ds * dh, dtype=torch.float32,
                                device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                          B.data_ptr(), C.data_ptr(), y.data_ptr(), bsz, seq,
                          h, dh, ds, lc, int(bf16),
                          work.data_ptr() if bf16 else None,
                          slots.data_ptr() if bf16 else None, stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return y
