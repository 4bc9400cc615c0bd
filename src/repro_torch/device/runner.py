"""Execute device schedules on n virtual devices of one card.

The reference (``repro.device.runner``) runs the cycle loop as a
``lax.scan`` over a shard_map program, one ``collective-permute`` per
sub-round with the packed scatter+gather step between permutes. Here the
n devices of the fabric are *virtual*: their packet buffers are one
``[n, rows, row_bytes]`` uint8 tensor on one device, and each sub-round is
the permute, scatter and gather of all n devices at once. On a GPU the
whole cycle loop -- ``cycles x d`` sub-rounds -- is one launch of
``repro_torch.device.round_step.permute_rounds`` over the plan's compacted
moves (``build_moves``, uploaded once per plan); on the CPU it is the plain
sub-round ``permute_step`` once per (cycle, sub-round) of the tables
(``build_tables``).

Conventions kept from the reference: the payload is padded to ``m*K``
packet rows, relay rows follow them; only the root's buffer starts with
the payload, every other buffer starts at zero; the result stacks every
device's copy as ``(n,) + x.shape`` with relay rows and padding dropped.
Rows are raw bytes (padded to a multiple of 16), so every dtype comes
through bit-exact.

The copy out (``unpack``) is one launch of the hand-written CUDA kernel
``csrc/unpack_rows.cu`` on a GPU (``unpack_rows``) and the plain version
``unpack_ref`` on the CPU. ``unpack_launches`` counts the kernel's
launches and ``unpack_bytes`` the bytes they read and wrote.

While ``repro_torch.spans`` records, a broadcast opens ``runner.pack``,
``runner.cycles`` and ``runner.unpack`` (on a GPU: the one ``unpack_rows``
launch), and a lowering ``lower.moves`` around ``lower.slot_tables``,
``lower.compact_moves`` and ``lower.upload``.

``binomial_broadcast`` and ``chain_broadcast`` are the reference's two
whole-message baselines in plain torch on the same virtual mesh (the JAX
versions use no Pallas kernel either).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch import spans
from repro_torch.device.round_step import (Moves, compact_moves,
                                           permute_rounds, permute_step)
from repro_torch.device.schedule import _NOSEND, DeviceSchedule

unpack_launches = 0   # kernel launches of unpack_rows since the last reset
unpack_bytes = 0      # bytes those launches read plus wrote

_unpack_fn = None


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and the host
    has no GPU: the port never carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' (DeviceConfig(device='cpu')) to run "
            f"the plain PyTorch round step on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the virtual mesh runs on cuda or cpu, not {dev}")
    return dev


def slot_tables(sched: DeviceSchedule, num_groups: int) -> np.ndarray:
    """int32 ``[cycles, d, 5, n]``: for every (cycle, sub-round) the
    ``src, s_ix, s_ok, r_ix, r_ok`` table of ``permute_step``.

    The slot formulas are the reference's per-device ``slot(r, c)``
    (``repro.device.runner.bbs_broadcast``) evaluated for all cycles at
    once in int64; ``src`` is the sub-round's matching read backwards."""
    n, d, K = sched.num_devices, sched.d, sched.K
    total = num_groups * K
    rows = total + sched.num_relay
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} packet rows do not fit int32 tables")
    c = np.arange(sched.num_cycles(num_groups), dtype=np.int64)[:, None, None]
    s_rel, r_rel = sched.send_rel[None], sched.recv_rel[None]
    s_abs, r_abs = sched.send_abs[None], sched.recv_abs[None]
    s_pk, r_pk = c * K + s_rel, c * K + r_rel
    s_ok = (s_abs >= 0) | ((s_rel != _NOSEND) & (s_pk >= 0) & (s_pk < total))
    r_ok = (r_abs >= 0) | ((r_rel != _NOSEND) & (r_pk >= 0) & (r_pk < total))
    s_ix = np.where(s_abs >= 0, total + s_abs, np.clip(s_pk, 0, total - 1))
    r_ix = np.where(r_abs >= 0, total + r_abs, np.clip(r_pk, 0, total - 1))
    src = np.full((d, n), -1, dtype=np.int64)
    for r, pairs in enumerate(sched.perms):
        for a, b in pairs:
            src[r, b] = a
    src = np.broadcast_to(src[None], s_ix.shape)
    tab = np.stack([src, s_ix, s_ok, r_ix, r_ok], axis=2)
    for ix, ok in ((s_ix, s_ok), (r_ix, r_ok)):
        live = ix[ok]
        if live.size and (live.min() < 0 or live.max() >= rows):
            raise ValueError("schedule table indexes a row outside the "
                             f"packet buffer [0, {rows})")
    return tab.astype(np.int32)


def build_tables(sched: DeviceSchedule, num_groups: int,
                 device="cuda") -> torch.Tensor:
    """``slot_tables`` as one device-resident int32 tensor, uploaded once
    per run."""
    with spans.span("lower.moves"):
        dev = resolve_device(device)
        with spans.span("lower.slot_tables"):
            tabs = slot_tables(sched, num_groups)
        with spans.span("lower.upload"):
            return torch.as_tensor(tabs, device=dev)


def build_moves(sched: DeviceSchedule, num_groups: int,
                device="cuda") -> Moves:
    """``slot_tables`` compacted to the moves that happen
    (``round_step.compact_moves``, the relay rows after the ``m*K`` packet
    rows), on the device, for ``permute_rounds``."""
    with spans.span("lower.moves"):
        dev = resolve_device(device)
        total = num_groups * sched.K
        with spans.span("lower.slot_tables"):
            tabs = slot_tables(sched, num_groups)
        with spans.span("lower.compact_moves"):
            moves = compact_moves(tabs, total + sched.num_relay, total)
        with spans.span("lower.upload"):
            return moves.to(dev)


@dataclasses.dataclass(frozen=True)
class PacketLayout:
    """How a payload maps onto ``[n, rows, row_bytes]`` packet buffers:
    ``total = m*K`` packet rows of ``plen`` elements (``used`` bytes each,
    padded to ``row_bytes``), then ``relay`` scratch rows."""

    n: int
    total: int
    relay: int
    plen: int
    used: int
    row_bytes: int

    @property
    def rows(self) -> int:
        return self.total + self.relay

    @property
    def buffer_bytes(self) -> int:
        return self.n * self.rows * self.row_bytes


def packet_layout(x: torch.Tensor, sched: DeviceSchedule,
                  num_groups: int) -> PacketLayout:
    total = num_groups * sched.K
    plen = -(-x.numel() // total)
    used = plen * x.element_size()
    return PacketLayout(n=sched.num_devices, total=total,
                        relay=sched.num_relay, plen=plen, used=used,
                        row_bytes=-(-used // 16) * 16)


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().reshape(-1).view(torch.uint8)


def pack(x: torch.Tensor, lay: PacketLayout, root: int,
         device: torch.device) -> torch.Tensor:
    """Fresh packet buffers: the root's packet rows hold the zero-padded
    payload, everything else is zero. ``x`` is only read."""
    with spans.span("runner.pack"):
        buf = torch.zeros((lay.n, lay.rows, lay.row_bytes),
                          dtype=torch.uint8, device=device)
        xb = _as_bytes(x).to(device)
        padded = torch.zeros(lay.total * lay.used, dtype=torch.uint8,
                             device=device)
        padded[:xb.numel()] = xb
        buf[root, :lay.total, :lay.used] = padded.view(lay.total, lay.used)
        return buf


def run_cycles(buf: torch.Tensor, tabs: torch.Tensor = None,
               moves: Moves = None) -> torch.Tensor:
    """The cycle loop. On a CUDA ``buf``: one ``permute_rounds`` launch over
    every sub-round of ``moves`` (``build_moves``). Elsewhere: one
    ``permute_step`` per (cycle, sub-round) of ``tabs`` (``build_tables``).
    The reference's cycle-start gather (a round step with no write) needs
    no work: nothing is written between it and the sub-round-0 read."""
    if buf.device.type == "cuda":
        return permute_rounds(buf, moves)
    cycles, d = tabs.shape[:2]
    for c in range(cycles):
        for r in range(d):
            permute_step(buf, tabs[c, r])
    return buf


def unpack_ref(buf: torch.Tensor, lay: PacketLayout,
               nbytes: int) -> torch.Tensor:
    """The plain version of ``unpack_rows``: every device's first
    ``nbytes`` payload bytes as a fresh uint8 ``[n, nbytes]`` tensor, in
    two strided copies out of ``buf``."""
    out = torch.empty((lay.n, nbytes), dtype=torch.uint8, device=buf.device)
    full, rem = divmod(nbytes, lay.used)
    out[:, :full * lay.used].view(lay.n, full, lay.used).copy_(
        buf[:, :full, :lay.used])
    if rem:
        out[:, full * lay.used:] = buf[:, full, :rem]
    return out


def _unpack_kernel():
    global _unpack_fn
    if _unpack_fn is None:
        from repro_torch.nvcc import load
        fn = load("unpack_rows").unpack_rows
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _unpack_fn = fn
    return _unpack_fn


def unpack_rows(buf: torch.Tensor, lay: PacketLayout,
                nbytes: int) -> torch.Tensor:
    """``unpack_ref``'s result from one launch of ``csrc/unpack_rows.cu``
    on ``buf``'s GPU, on the current stream. Every check raises before the
    kernel is built or launched."""
    global unpack_launches, unpack_bytes
    if (buf.dtype != torch.uint8 or not buf.is_contiguous()
            or tuple(buf.shape) != (lay.n, lay.rows, lay.row_bytes)):
        raise ValueError(f"buf must be a contiguous uint8 [n, rows, "
                         f"row_bytes] = {(lay.n, lay.rows, lay.row_bytes)} "
                         f"tensor, got {buf.dtype} {tuple(buf.shape)}")
    if lay.row_bytes % 16 or lay.used > lay.row_bytes:
        raise ValueError(f"the kernel reads 16-byte chunks: row_bytes "
                         f"{lay.row_bytes} must be a multiple of 16 and "
                         f"hold used {lay.used}")
    if not 0 <= nbytes <= lay.total * lay.used:
        raise ValueError(f"{nbytes} bytes do not fit {lay.total} packet "
                         f"rows of {lay.used}")
    if buf.device.type != "cuda":
        raise ValueError(f"unpack_rows runs on cuda, not {buf.device}; "
                         f"unpack_ref is the plain version")
    if buf.data_ptr() % 16:
        raise ValueError("the buffer's address must be a multiple of 16")
    out = torch.empty((lay.n, nbytes), dtype=torch.uint8, device=buf.device)
    if lay.n == 0 or nbytes == 0:
        return out
    fn = _unpack_kernel()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        rc = fn(buf.data_ptr(), out.data_ptr(), lay.n, lay.rows,
                lay.row_bytes, lay.used, nbytes, stream)
    if rc != 0:
        raise RuntimeError(f"unpack_rows kernel launch failed: CUDA error "
                           f"{rc}")
    unpack_launches += 1
    unpack_bytes += 2 * lay.n * nbytes
    return out


def unpack(buf: torch.Tensor, lay: PacketLayout,
           x: torch.Tensor) -> torch.Tensor:
    """Every device's copy, stacked as ``(n,) + x.shape`` in ``x``'s dtype,
    with relay rows and padding dropped (one copy out of ``buf``): one
    ``unpack_rows`` launch for a CUDA ``buf``, ``unpack_ref`` for a CPU
    one."""
    with spans.span("runner.unpack"):
        nbytes = x.numel() * x.element_size()
        if buf.device.type == "cuda":
            out = unpack_rows(buf, lay, nbytes)
        else:
            out = unpack_ref(buf, lay, nbytes)
        return out.view(x.dtype).reshape((lay.n,) + tuple(x.shape))


def bbs_broadcast(x: torch.Tensor, sched: DeviceSchedule, num_groups: int,
                  device="cuda", tables: torch.Tensor = None,
                  moves: Moves = None) -> torch.Tensor:
    """Broadcast ``x`` from the schedule's root to all ``n`` virtual
    devices; returns the stacked copies ``(n,) + x.shape`` on ``device``.
    ``moves`` (on a GPU) or ``tables`` (on the CPU) reuses a ``build_moves``
    or ``build_tables`` upload of the same schedule."""
    dev = resolve_device(device)
    lay = packet_layout(x, sched, num_groups)
    if dev.type == "cuda":
        if moves is None:
            moves = build_moves(sched, num_groups, dev)
    elif tables is None:
        tables = build_tables(sched, num_groups, dev)
    buf = pack(x, lay, sched.root, dev)
    with spans.span("runner.cycles"):
        run_cycles(buf, tables, moves)
    return unpack(buf, lay, x)


def binomial_broadcast(x: torch.Tensor, n: int, root: int = 0,
                       device="cuda") -> torch.Tensor:
    """Whole-message binomial-tree broadcast on n virtual devices:
    log2(n) rounds, same stacked-output convention."""
    dev = resolve_device(device)
    xb = _as_bytes(x).to(dev)
    buf = torch.zeros((n, xb.numel()), dtype=torch.uint8, device=dev)
    buf[root] = xb
    vrank = (torch.arange(n, device=dev) - root) % n
    have = vrank == 0
    for s in reversed(range(max(1, (n - 1).bit_length()))):
        stride = 1 << s
        pairs = [((root + r) % n, (root + r + stride) % n)
                 for r in range(0, n, 2 * stride) if r + stride < n]
        src = torch.tensor([a for a, _ in pairs], device=dev)
        dst = torch.tensor([b for _, b in pairs], device=dev)
        rec = torch.zeros_like(buf)
        rec[dst] = torch.where(have[src, None], buf[src],
                               torch.zeros_like(buf[src]))
        is_dst = vrank % (2 * stride) == stride
        buf = torch.where(is_dst[:, None], rec, buf)
        have = have | is_dst
    return buf.view(x.dtype).reshape((n,) + tuple(x.shape))


def chain_broadcast(x: torch.Tensor, n: int, root: int = 0,
                    num_packets: int = 8, device="cuda") -> torch.Tensor:
    """Pipelined chain broadcast on n virtual devices: packets stream
    rank -> rank+1, m + n - 2 rounds (the MPICH 'pipeline' baseline)."""
    dev = resolve_device(device)
    m = num_packets
    xb = _as_bytes(x).to(dev)
    esz = x.element_size()
    plen = -(-x.numel() // m)
    used = plen * esz
    buf = torch.zeros((n, m, used), dtype=torch.uint8, device=dev)
    padded = torch.zeros(m * used, dtype=torch.uint8, device=dev)
    padded[:xb.numel()] = xb
    buf[root] = padded.view(m, used)
    vr = torch.arange(n, device=dev)
    node = (root + vr) % n                       # the device at each rank
    for s in range(m + n - 2):
        # rank r forwards packet s - r; rank r + 1 stores it as packet s - r
        p = s - vr
        ok = (p >= 0) & (p < m) & (vr < n - 1)
        val = buf[node, p.clamp(0, m - 1)]
        val = torch.where(ok[:, None], val, torch.zeros_like(val))
        rec = torch.cat([torch.zeros_like(val[:1]), val[:-1]])
        pr = s - vr + 1
        rok = (pr >= 0) & (pr < m) & (vr >= 1)
        w = torch.nonzero(rok).squeeze(1)
        buf[node[w], pr[w]] = rec[w]
    out = buf.reshape(n, m * used)[:, :xb.numel()]
    return out.contiguous().view(x.dtype).reshape((n,) + tuple(x.shape))
