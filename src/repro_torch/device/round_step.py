"""One sub-round of the BBS cycle loop on n virtual devices.

The n nodes of the fabric are n *virtual devices* whose packet buffers are
one ``[n, rows, row_bytes]`` uint8 tensor. One sub-round -- the reference's
``jax.lax.ppermute`` of every device's send row composed with each
device's scatter (``repro.device.pallas_step.round_step_ref``) -- becomes one
indexed row copy over all devices at once. ``tab`` is the sub-round's int32
``[5, n]`` table ``src, s_ix, s_ok, r_ix, r_ok`` (``src[v] = -1`` when v
receives from no one). For every receiver v::

    val = (src[v] >= 0 and s_ok[src[v]]) ? buf[src[v], s_ix[src[v]]] : 0
    if r_ok[v]:
        buf[v, r_ix[v]] = val

Every read sees the buffer as it was before the sub-round (the reference
gathers every send row before the permute). The update is in place; the
rows are raw bytes, so any payload dtype comes through bit-exact. Indexes
must lie in ``[0, rows)`` (``repro_torch.device.runner.build_tables``
checks them).

``permute_step`` launches the hand-written CUDA kernel
(``csrc/permute_step.cu``) on a CUDA tensor and runs the plain version
``permute_step_ref`` on a CPU tensor; on any other device it raises.
``launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

launches = 0          # kernel launches of permute_step since the last reset

_fn = None


def permute_step_ref(buf: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch sub-round (module docstring), in place on ``buf``."""
    src, s_ix, s_ok, r_ix, r_ok = tab.long().unbind(0)
    has = src >= 0
    u = src.clamp(min=0)
    ok = has & (s_ok[u] != 0)
    val = buf[u, s_ix[u]]                    # a copy: reads precede writes
    val = torch.where(ok[:, None], val, torch.zeros_like(val))
    v = torch.nonzero(r_ok != 0).squeeze(1)
    buf[v, r_ix[v]] = val[v]
    return buf


def random_table(rng: np.random.Generator, n: int, rows: int) -> np.ndarray:
    """A random int32 ``[5, n]`` sub-round table with every edge case of
    the real ones and beyond (for tests): a partial matching, receivers with
    no sender (``src = -1``) that still write (zeros), writes whose sender's
    read is masked off (``r_ok`` with ``s_ok`` false: the relay zero-write),
    both masks off, and the first and last row. It keeps the property the
    in-place kernel needs: no device sends and receives one row."""
    src = np.full(n, -1, dtype=np.int64)
    k = int(rng.integers(1, n + 1))
    src[rng.permutation(n)[:k]] = rng.permutation(n)[:k]
    s_ix = rng.integers(0, rows, n)
    r_ix = rng.integers(0, rows, n)
    s_ix[rng.random(n) < 0.1] = 0
    r_ix[rng.random(n) < 0.1] = rows - 1
    s_ok = rng.random(n) < 0.7
    r_ok = rng.random(n) < 0.8
    senders = np.zeros(n, dtype=bool)
    senders[src[src >= 0]] = True
    clash = senders & s_ok & r_ok & (s_ix == r_ix)
    if rows == 1:
        r_ok &= ~clash
    else:
        r_ix[clash] = (s_ix[clash] + 1) % rows
    return np.stack([src, s_ix, s_ok, r_ix, r_ok]).astype(np.int32)


def _kernel():
    global _fn
    if _fn is None:
        from repro_torch.nvcc import load
        fn = load("permute_step").permute_step
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(buf: torch.Tensor, tab: torch.Tensor) -> None:
    if buf.dtype != torch.uint8 or buf.dim() != 3 or not buf.is_contiguous():
        raise ValueError(f"buf must be a contiguous [n, rows, row_bytes] "
                         f"uint8 tensor, got {buf.dtype} {tuple(buf.shape)}")
    n = buf.shape[0]
    if (tab.dtype != torch.int32 or tuple(tab.shape) != (5, n)
            or not tab.is_contiguous() or tab.device != buf.device):
        raise ValueError(f"tab must be a contiguous int32 [5, {n}] tensor on "
                         f"{buf.device}, got {tab.dtype} {tuple(tab.shape)} "
                         f"on {tab.device}")


def permute_step(buf: torch.Tensor, tab: torch.Tensor) -> torch.Tensor:
    """One sub-round on all virtual devices, in place: the CUDA kernel for a
    CUDA ``buf``, ``permute_step_ref`` for a CPU ``buf``."""
    global launches
    _check(buf, tab)
    if buf.device.type == "cpu":
        return permute_step_ref(buf, tab)
    if buf.device.type != "cuda":
        raise ValueError(f"permute_step runs on cuda or cpu, not {buf.device}")
    n, rows, row_bytes = buf.shape
    if row_bytes % 16 or buf.data_ptr() % 16:
        raise ValueError(f"the kernel moves 16-byte chunks: row_bytes "
                         f"{row_bytes} and the buffer address must be "
                         f"multiples of 16")
    if n == 0 or row_bytes == 0:
        return buf
    fn = _kernel()
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    with torch.cuda.device(buf.device):
        rc = fn(buf.data_ptr(), tab.data_ptr(), n, rows, row_bytes, stream)
    if rc != 0:
        raise RuntimeError(f"permute_step kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return buf
