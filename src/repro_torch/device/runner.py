"""Execute device schedules on n virtual devices of one card.

The reference (``repro.device.runner``) runs the cycle loop as a
``lax.scan`` over a shard_map program, one ``collective-permute`` per
sub-round with the packed scatter+gather step between permutes. Here the
n devices of the fabric are *virtual*: their packet rows live in one uint8
allocation on one device, and each sub-round is the permute, scatter and
gather of all n devices at once. On a GPU the whole cycle loop -- ``cycles
x d`` sub-rounds -- is one launch of
``repro_torch.device.round_step.permute_rounds`` (K1) over the plan's
compacted moves (``build_moves``, uploaded once per plan); on the CPU it is
the plain version of the same moves, or, where no caller asked for the
moves, the plain sub-round ``permute_step`` once per (cycle, sub-round) of
the tables (``build_tables``).

Conventions kept from the reference: the payload is padded to ``m*K``
packet rows, relay rows follow them; only the root's buffer starts with
the payload, every other buffer starts at zero; the result stacks every
device's copy as ``(n,) + x.shape`` with relay rows and padding dropped.
Rows are raw bytes (padded to a multiple of 16), so every dtype comes
through bit-exact.

``LoweredPlan`` is one (schedule, num_groups, device) lowered for the
runner: K1's moves (on a GPU always, on the CPU once a caller asks), else
the CPU's sub-round tables, and each payload shape's ``Placement``
(``place``), made once. ``broadcast`` runs a request on it in three steps,
each of which picks the kernel on a GPU and the plain version on the CPU:
``start`` the buffer, ``cycles`` (K1), ``finish`` the stacked output. Two
layouts hold the rows:

* **in place**: the stacked output is where K1 writes. One allocation
  holds the ``[n, nbytes]`` output and, after it, a small zeroed scratch
  region. Packet row p covers payload bytes ``[p * row_bytes, (p + 1) *
  row_bytes)``; a row wholly inside the payload lies in its device's
  output, the row that straddles the payload's end, rows of padding alone
  and the relay rows in scratch. The start writes the root's payload and
  tail and zeroes scratch (``fill_inplace``, plain ``fill_ref``), K1 runs
  on the rows' byte offsets, and the finish copies each straddling row
  into its device's output (``unpack_tail``, plain ``tail_ref``). On a GPU
  these are three unchecked launches (``_launch_fill``, ``launch_rounds``,
  ``_launch_tail``): ``place`` checked once what holds for every request.
  Taken for K1's moves when ``nbytes`` is a multiple of 16 and the plan
  writes every non-root packet row inside the payload before anything
  reads it (``writes_first``), so no output byte depends on what the
  allocation held.
* **staged**: the ``[n, rows, row_bytes]`` buffer, packet row p holding
  payload bytes ``[p * used, (p + 1) * used)``: zero filled (``pack``),
  run (``run_cycles``), copied out (``unpack``: one launch of
  ``csrc/unpack_rows.cu``, ``unpack_rows``, plain ``unpack_ref``). Taken
  otherwise.

``inplace_runs`` and ``staged_runs`` count the broadcasts of each;
``fill_launches`` the ``fill_inplace`` kernel's launches,
``unpack_launches`` the ``unpack_rows`` kernel's (the tail's too) and
``unpack_bytes`` the bytes they read and wrote. While
``repro_torch.spans`` records, a broadcast opens ``runner.pack``,
``runner.cycles`` and ``runner.unpack`` around its steps, the first of a
shape with K1's moves ``lower.place``, and a lowering ``lower.moves``
around ``lower.slot_tables``, ``lower.compact_moves``, on a GPU
``lower.phases``, and ``lower.upload``.

``binomial_broadcast`` and ``chain_broadcast`` are the reference's two
whole-message baselines in plain torch on the same virtual mesh (the JAX
versions use no Pallas kernel either).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.device.round_step import (Moves, RowOffsets,
                                           compact_moves, fits_launch,
                                           launch_rounds, permute_rounds,
                                           permute_step, with_phases)
from repro_torch.device.schedule import _NOSEND, DeviceSchedule

unpack_launches = 0   # kernel launches of unpack_rows since the last reset
unpack_bytes = 0      # bytes those launches read plus wrote
inplace_runs = 0      # broadcasts whose K1 wrote into the stacked output
staged_runs = 0       # broadcasts through the staging buffer
fill_launches = 0     # kernel launches of fill_inplace since the last reset

_unpack_fn = _fill_fn = None


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
                payload: torch.Tensor, device="cuda") -> Moves:
    """``slot_tables`` compacted to the moves that happen
    (``round_step.compact_moves``, the relay rows after the ``m*K`` packet
    rows), on the device, for ``permute_rounds``; on a GPU with their
    dependency phases (``round_step.with_phases``, each phase's size fitted
    to the packet rows of ``payload``, the plan's own payload: only its
    shape and dtype are read), which K1 runs."""
    with spans.span("lower.moves"):
        dev = resolve_device(device)
        total = num_groups * sched.K
        with spans.span("lower.slot_tables"):
            tabs = slot_tables(sched, num_groups)
        with spans.span("lower.compact_moves"):
            moves = compact_moves(tabs, total + sched.num_relay, total)
        if dev.type == "cuda":
            with spans.span("lower.phases"):
                moves = with_phases(moves, packet_layout(
                    payload, sched, num_groups).row_bytes)
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
    buf = torch.zeros((lay.n, lay.rows, lay.row_bytes), dtype=torch.uint8,
                      device=device)
    xb = _as_bytes(x).to(device)
    padded = torch.zeros(lay.total * lay.used, dtype=torch.uint8,
                         device=device)
    padded[:xb.numel()] = xb
    buf[root, :lay.total, :lay.used] = padded.view(lay.total, lay.used)
    return buf


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a broadcast of ``nbytes`` payload bytes on ``lay`` keeps its
    rows: in place (module docstring) when ``at`` holds their byte offsets
    in the in-place allocation (``inplace_rows``), staged when it is
    None."""

    lay: PacketLayout
    nbytes: int
    at: Optional[RowOffsets] = None

    @property
    def inplace(self) -> bool:
        return self.at is not None

    @property
    def full(self) -> int:
        """Packet rows of a device that lie wholly inside its output."""
        return self.nbytes // self.lay.row_bytes

    @property
    def scratch(self) -> int:
        """Rows of a device in scratch: the one that straddles the
        payload's end, those of padding alone, the relay rows."""
        return self.lay.rows - self.full

    @property
    def tail(self) -> int:
        """Bytes of a device's output after its full rows: the straddling
        row's share."""
        return self.nbytes - self.full * self.lay.row_bytes

    @property
    def alloc_bytes(self) -> int:
        """The in-place allocation: the output, then scratch."""
        return self.lay.n * (self.nbytes + self.scratch * self.lay.row_bytes)


def inplace_rows(lay: PacketLayout, nbytes: int) -> np.ndarray:
    """int64 ``[n * rows]``: the byte offset of every row of every device
    in the in-place allocation. Row p of device v lies at ``v * nbytes + p
    * row_bytes`` when ``(p + 1) * row_bytes <= nbytes``; its other rows lie
    in scratch after the ``n * nbytes`` output, device-major."""
    full = nbytes // lay.row_bytes
    v = np.arange(lay.n, dtype=np.int64)[:, None]
    r = np.arange(lay.rows, dtype=np.int64)[None]
    scratch = lay.n * nbytes + (v * (lay.rows - full) + r - full) \
        * lay.row_bytes
    return np.where(r < full, v * nbytes + r * lay.row_bytes,
                    scratch).reshape(-1)


def writes_first(moves: Moves, root: int, full: int) -> bool:
    """Whether K1's ``moves`` write each packet row ``p < full`` of every
    device but ``root`` in an earlier sub-round than any that reads it, so
    that what such a row held before K1 reaches no byte of any row after
    it (a sub-round's reads precede its writes). A row never written
    fails. Computed on the moves' device, one sync."""
    dev, count, rows = moves.device, moves.num_subrounds, moves.n * moves.rows
    dst, src = moves.pairs.unbind(1)
    sub = torch.repeat_interleave(torch.arange(count, device=dev),
                                  moves.offs.diff(), output_size=len(dst))
    never = torch.full((rows + 1,), count, dtype=torch.int64, device=dev)
    first_w = never.clone().scatter_reduce_(0, dst, sub, "amin")
    # a zero write reads nothing: its read lands on the spare last slot
    first_r = never.scatter_reduce_(0, torch.where(src >= 0, src, rows),
                                    sub, "amin")
    ok = (first_w < first_r)[:rows].view(moves.n, moves.rows)[:, :full]
    ok[root] = True                  # the root's rows start as the payload
    return bool(ok.all())


def place(moves: Moves, lay: PacketLayout, nbytes: int,
          root: int) -> Placement:
    """The layout of a broadcast of ``nbytes`` bytes on ``lay`` by K1's
    ``moves`` from ``root``: in place when ``nbytes`` is a positive
    multiple of 16, every sub-round fits one launch (``fits_launch``) and
    ``writes_first`` holds, else staged. ``LoweredPlan.placement`` makes
    each shape's once."""
    if (moves.n, moves.rows) != (lay.n, lay.rows):
        raise ValueError(f"the moves index [{moves.n}, {moves.rows}] "
                         f"rows, the layout has [{lay.n}, {lay.rows}]")
    with spans.span("lower.place"):
        if nbytes > 0 and nbytes % 16 == 0 and fits_launch(
                moves, lay.row_bytes) and writes_first(
                moves, root, nbytes // lay.row_bytes):
            return Placement(lay, nbytes, moves.offsets(
                lay.row_bytes, inplace_rows(lay, nbytes)))
        return Placement(lay, nbytes)


def fill_ref(alloc: torch.Tensor, xb: torch.Tensor, plc: Placement,
             root: int) -> None:
    """The plain version of ``fill_inplace`` on the payload's bytes ``xb``:
    a zero fill of scratch and two copies."""
    lay, nb = plc.lay, plc.nbytes
    end = lay.n * nb
    alloc[end:].zero_()
    alloc[root * nb:(root + 1) * nb] = xb
    if plc.tail:
        at = end + root * plc.scratch * lay.row_bytes
        alloc[at:at + plc.tail] = xb[nb - plc.tail:]


def _fill_kernel():
    global _fill_fn
    if _fill_fn is None:
        from repro_torch.nvcc import load
        fn = load("unpack_rows").fill_inplace
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int] + [ctypes.c_longlong] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fill_fn = fn
    return _fill_fn


def fill_inplace(alloc: torch.Tensor, x: torch.Tensor, plc: Placement,
                 root: int) -> None:
    """Start the in-place allocation ``alloc`` as K1 needs it, whatever it
    held: the root's output holds the payload, and scratch is zero but for
    the root's straddling row, which holds the payload's tail. Nothing else
    is written: K1 writes every other row inside the payload before
    anything reads it (``writes_first``). ``_fill`` after its checks, on
    the current stream (every check raises before the kernel is built or
    launched). ``x`` is only read."""
    lay, nb = plc.lay, plc.nbytes
    xb = _as_bytes(x).to(alloc.device)
    if (alloc.dtype != torch.uint8 or alloc.dim() != 1
            or not alloc.is_contiguous() or alloc.numel() != plc.alloc_bytes
            or xb.numel() != nb):
        raise ValueError(f"alloc must be a contiguous uint8 tensor of "
                         f"{plc.alloc_bytes} bytes and x {nb} bytes, got "
                         f"{alloc.dtype} {tuple(alloc.shape)} and "
                         f"{xb.numel()} bytes")
    if alloc.device.type != "cuda":
        _fill(alloc, xb, plc, root, None)
        return
    if nb % 16 or lay.row_bytes % 16 or alloc.data_ptr() % 16:
        raise ValueError("the kernel copies 16-byte chunks: nbytes, "
                         "row_bytes and the address must be multiples of 16")
    with torch.cuda.device(alloc.device):
        _fill(alloc, xb, plc, root,
              torch.cuda.current_stream(alloc.device).cuda_stream)


def _fill(alloc: torch.Tensor, xb: torch.Tensor, plc: Placement, root: int,
          stream) -> None:
    """``fill_inplace``'s step, unchecked, on the payload's bytes ``xb``: on
    a GPU one ``_launch_fill`` on the raw ``stream`` of the current device
    (``xb`` copied onto the 16-byte grid where it is off it), on the CPU
    ``fill_ref``."""
    if alloc.device.type != "cuda":
        fill_ref(alloc, xb, plc, root)
        return
    if xb.data_ptr() % 16:
        xb = xb.clone()
    _launch_fill(alloc, xb, plc, root, stream)


def _launch_fill(alloc: torch.Tensor, xb: torch.Tensor, plc: Placement,
                 root: int, stream: int) -> None:
    """One ``fill_inplace`` launch on the raw ``stream`` of the current
    device, unchecked (the payload's bytes ``xb`` on the 16-byte grid);
    counts it."""
    global fill_launches
    lay = plc.lay
    rc = _fill_kernel()(xb.data_ptr(), alloc.data_ptr(), lay.n, root,
                        plc.nbytes, plc.scratch * lay.row_bytes, plc.tail,
                        stream)
    if rc != 0:
        raise RuntimeError(f"fill_inplace kernel launch failed: CUDA error "
                           f"{rc}")
    fill_launches += 1


def run_cycles(buf: torch.Tensor, tabs: torch.Tensor = None,
               moves: Moves = None) -> torch.Tensor:
    """The staged cycle loop on the ``[n, rows, row_bytes]`` buffer. With
    ``moves`` (``build_moves``; on a GPU always): ``permute_rounds`` over
    every sub-round of them, on a CUDA ``buf`` one launch. Otherwise: one
    ``permute_step`` per (cycle, sub-round) of ``tabs`` (``build_tables``).
    The reference's cycle-start gather (a round step with no write) needs
    no work: nothing is written between it and the sub-round-0 read."""
    if moves is not None:
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
            [ctypes.c_longlong] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _unpack_fn = fn
    return _unpack_fn


def unpack_rows(buf: torch.Tensor, lay: PacketLayout,
                nbytes: int) -> torch.Tensor:
    """``unpack_ref``'s result from one launch of ``csrc/unpack_rows.cu``
    on ``buf``'s GPU, on the current stream. Every check raises before the
    kernel is built or launched."""
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
    if lay.n and nbytes:
        with torch.cuda.device(buf.device):
            _launch_unpack(buf.data_ptr(), out.data_ptr(), lay.n, lay.rows,
                           lay.row_bytes, lay.used, nbytes, nbytes, 0,
                           torch.cuda.current_stream(buf.device).cuda_stream)
    return out


def _launch_unpack(src: int, dst: int, n: int, rows: int, row_bytes: int,
                   used: int, nbytes: int, pitch: int, off: int,
                   stream: int) -> None:
    """One ``unpack_rows`` launch on the raw ``stream`` of the current
    device (the C entry's arguments, addresses as ints), unchecked; counts
    it and its bytes."""
    global unpack_launches, unpack_bytes
    rc = _unpack_kernel()(src, dst, n, rows, row_bytes, used, nbytes, pitch,
                          off, stream)
    if rc != 0:
        raise RuntimeError(f"unpack_rows kernel launch failed: CUDA error "
                           f"{rc}")
    unpack_launches += 1
    unpack_bytes += 2 * n * nbytes


def unpack(buf: torch.Tensor, lay: PacketLayout,
           x: torch.Tensor) -> torch.Tensor:
    """Every device's copy, stacked as ``(n,) + x.shape`` in ``x``'s dtype,
    with relay rows and padding dropped (one copy out of ``buf``): one
    ``unpack_rows`` launch for a CUDA ``buf``, ``unpack_ref`` for a CPU
    one."""
    nbytes = x.numel() * x.element_size()
    if buf.device.type == "cuda":
        out = unpack_rows(buf, lay, nbytes)
    else:
        out = unpack_ref(buf, lay, nbytes)
    return out.view(x.dtype).reshape((lay.n,) + tuple(x.shape))


def tail_ref(alloc: torch.Tensor, plc: Placement) -> None:
    """The plain version of ``unpack_tail``: every device's straddling
    row's share into its output's last ``plc.tail`` bytes, in place in the
    in-place allocation, in one strided copy."""
    lay, nb = plc.lay, plc.nbytes
    end = lay.n * nb
    scratch = alloc[end:].view(lay.n, plc.scratch, lay.row_bytes)
    alloc[:end].view(lay.n, nb)[:, nb - plc.tail:] = \
        scratch[:, 0, :plc.tail]


def unpack_tail(alloc: torch.Tensor, plc: Placement) -> None:
    """``tail_ref`` in one launch of ``csrc/unpack_rows.cu`` on the
    allocation's GPU, on the current stream: scratch as ``[n, scratch,
    row_bytes]`` rows, each device's first one's ``tail`` bytes into its
    output at ``full * row_bytes``, the output's pitch ``nbytes``. Every
    check raises before the kernel is built or launched."""
    lay, nb, tail = plc.lay, plc.nbytes, plc.tail
    if (alloc.dtype != torch.uint8 or not alloc.is_contiguous()
            or alloc.numel() != plc.alloc_bytes):
        raise ValueError(f"alloc must be a contiguous uint8 tensor of "
                         f"{plc.alloc_bytes} bytes, got {alloc.dtype} "
                         f"{tuple(alloc.shape)}")
    if nb % 16 or lay.row_bytes % 16 or alloc.data_ptr() % 16:
        raise ValueError("the kernel copies 16-byte chunks: nbytes, "
                         "row_bytes and the address must be multiples of 16")
    if alloc.device.type != "cuda":
        raise ValueError(f"unpack_tail runs on cuda, not {alloc.device}; "
                         f"tail_ref is the plain version")
    if lay.n and tail:
        with torch.cuda.device(alloc.device):
            _launch_tail(alloc, plc,
                         torch.cuda.current_stream(alloc.device).cuda_stream)


def _launch_tail(alloc: torch.Tensor, plc: Placement, stream: int) -> None:
    """``unpack_tail``'s launch on the raw ``stream`` of the current
    device, unchecked."""
    lay, nb, tail = plc.lay, plc.nbytes, plc.tail
    base = alloc.data_ptr()
    _launch_unpack(base + lay.n * nb, base, lay.n, plc.scratch,
                   lay.row_bytes, tail, tail, nb, nb - tail, stream)


class LoweredPlan:
    """A schedule's broadcast of ``num_groups`` groups lowered for the
    runner on ``device`` (module docstring); ``placements`` holds each
    payload shape's ``Placement`` by ``(x.shape, x.dtype)``. ``broadcast``
    runs its requests; ``start``, ``cycles`` and ``finish`` are its steps,
    each given the raw CUDA stream of ``launching`` (None on the CPU).
    ``payload`` is the payload the plan is for (only its shape and dtype
    are kept): its packet rows, ``row_bytes``, size K1's phases
    (``build_moves``)."""

    def __init__(self, sched: DeviceSchedule, num_groups: int,
                 payload: torch.Tensor, device="cuda"):
        self.sched, self.num_groups, self.root = sched, num_groups, sched.root
        self.payload = payload.to("meta")
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        self.placements: dict = {}
        self._moves: Optional[Moves] = None
        self._tables: Optional[torch.Tensor] = None

    def moves(self) -> Moves:
        """K1's compacted moves on the device (``build_moves``), built on
        first use. From then on every new shape is placed with them: the
        placements made before, staged for the tables, are dropped."""
        if self._moves is None:
            self._moves = build_moves(self.sched, self.num_groups,
                                      self.payload, self.device)
            self.placements.clear()
        return self._moves

    @property
    def row_bytes(self) -> int:
        """The packet row of the plan's own payload."""
        return packet_layout(self.payload, self.sched,
                             self.num_groups).row_bytes

    def tables(self) -> torch.Tensor:
        """The int32 ``[cycles, d, 5, n]`` sub-round tables on the device
        (``build_tables``), built on first use."""
        if self._tables is None:
            self._tables = build_tables(self.sched, self.num_groups,
                                        self.device)
        return self._tables

    def placement(self, x: torch.Tensor) -> Placement:
        """Where a broadcast of ``x`` keeps its rows: made on the first
        request of its shape and dtype, with the moves on a GPU or once
        asked for, else with the tables; looked up after."""
        plc = self.placements.get((x.shape, x.dtype))
        if plc is None:
            lay = packet_layout(x, self.sched, self.num_groups)
            nbytes = x.numel() * x.element_size()
            if self.cuda or self._moves is not None:
                plc = place(self.moves(), lay, nbytes, self.root)
            else:
                self.tables()
                plc = Placement(lay, nbytes)
            self.placements[(x.shape, x.dtype)] = plc
        return plc

    @contextlib.contextmanager
    def launching(self):
        """The plan's GPU made current, yielding its raw stream (None)."""
        if not self.cuda:
            yield None
            return
        with torch.cuda.device(self.device):
            yield torch.cuda.current_stream(self.device).cuda_stream

    def start(self, x: torch.Tensor, plc: Placement,
              stream) -> torch.Tensor:
        """A fresh buffer started as K1 needs it: in place, the allocation
        with the root's payload and tail and scratch zeroed (``_fill``: one
        ``fill_inplace`` launch on a GPU, ``fill_ref`` on the CPU); staged,
        ``pack``. ``x`` is only read."""
        if not plc.inplace:
            return pack(x, plc.lay, self.root, self.device)
        alloc = torch.empty(plc.alloc_bytes, dtype=torch.uint8,
                            device=self.device)
        _fill(alloc, _as_bytes(x).to(self.device), plc, self.root, stream)
        return alloc

    def cycles(self, buf: torch.Tensor, plc: Placement, stream) -> None:
        """The cycle loop on a started buffer: in place, K1 at the
        placement's offsets (one launch on a GPU, its plain version on the
        CPU); staged, ``run_cycles`` over the moves or the tables."""
        mv = self._moves
        if not plc.inplace:
            run_cycles(buf, self._tables if mv is None else None, mv)
        elif not self.cuda:
            permute_rounds(buf, mv, at=plc.at)
        elif mv.num_subrounds:
            launch_rounds(buf, mv, 0, mv.num_subrounds, plc.at, stream)

    def finish(self, buf: torch.Tensor, plc: Placement, x: torch.Tensor,
               stream) -> torch.Tensor:
        """Every device's copy, stacked as ``(n,) + x.shape`` in ``x``'s
        dtype. In place: the allocation's first ``n * nbytes`` bytes, once
        each device's straddling row is in its output's tail (one
        ``unpack_rows`` launch on a GPU, ``tail_ref`` on the CPU),
        contiguous, scratch still allocated behind it. Staged:
        ``unpack``."""
        if not plc.inplace:
            return unpack(buf, plc.lay, x)
        if plc.tail:
            if self.cuda:
                _launch_tail(buf, plc, stream)
            else:
                tail_ref(buf, plc)
        n, nb = plc.lay.n, plc.nbytes
        return buf[:n * nb].view(n, nb).view(x.dtype).reshape(
            (n,) + tuple(x.shape))


def broadcast(low: LoweredPlan, x: torch.Tensor) -> torch.Tensor:
    """Broadcast ``x`` from the plan's root to all ``n`` virtual devices;
    returns the stacked copies ``(n,) + x.shape`` on the plan's device.
    The one composition of a request, in either layout on either device:
    its placement looked up, then ``start``, ``cycles`` and ``finish`` in
    the spans ``runner.pack``, ``runner.cycles`` and ``runner.unpack``.
    ``x`` is only read."""
    global inplace_runs, staged_runs
    plc = low.placement(x)
    with low.launching() as stream:
        with spans.span("runner.pack"):
            buf = low.start(x, plc, stream)
        with spans.span("runner.cycles"):
            low.cycles(buf, plc, stream)
        with spans.span("runner.unpack"):
            out = low.finish(buf, plc, x, stream)
    if plc.inplace:
        inplace_runs += 1
    else:
        staged_runs += 1
    return out


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
