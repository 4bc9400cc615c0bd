"""Run device schedules across the ranks of a ``torch.distributed`` group.

The reference runs a plan across real devices: ``repro.device.runner``'s
``shard_map`` program, whose sub-rounds are each one ``lax.ppermute``
followed by the per-device round step (K1). Here each device is one rank
of a process group, and each rank holds only its own packet buffer: a
``[rows + 1, row_bytes]`` uint8 tensor, the packet and relay rows of
``repro_torch.device.runner`` plus one staging row. Every rank of the group
calls the same function with the same plan, in the same order.

One cycle follows the reference's body. For each sub-round of the cycle,
the pairs of its matching exchange one row each in a single
``dist.batch_isend_irecv``: a sender sends its row ``s_ix``, zeros where
``s_ok`` is false (as ``ppermute`` sends them), and the receiver receives
into its staging row. Then the rank writes the staging row at ``r_ix`` if
``r_ok`` (zeros when no one sent to it): K1's work, so it runs K1 -- one
``round_step.permute_step`` on the ``[1, rows + 1, row_bytes]`` view, with
the table ``src = 0, s_ix = rows, s_ok = received, r_ix, r_ok``, which
launches the CUDA kernel on a CUDA rank and runs the plain version on a CPU
rank. The next sub-round's send row is read after that write, as the
reference gathers it. The per-rank tables are the rank's columns of
``runner.slot_tables``, built once on the host.

Each rank's part is a :class:`RankProgram`: ``prepare_bbs`` builds it
(the tables, K1's tables of the writes, the buffer with the root's packed
payload, the peers) and ``run`` runs its sub-rounds, so a timed window
(``measure``: a barrier, the run, a synchronize, the slowest rank's
time) holds no set-up; ``bbs_broadcast`` is the two in turn.
``ring_round_group`` is the calibration's ring through the same ``run``
(``repro_torch.device.calibrate.measure_round(..., group=...)``).

``binomial_broadcast`` and ``chain_broadcast`` are the reference's two
whole-message baselines per rank (plain sends and receives; the reference
uses no kernel for them either).

Devices and backends: by default (``device="cuda"``) rank r's buffer lives
on ``cuda:<local rank>`` (``LOCAL_RANK``, else the rank modulo the GPU
count) and the group is NCCL's; ``device="cpu"`` runs on gloo, which has no
CUDA send and receive. A CUDA buffer in a gloo group raises, so does a group
whose size is not the plan's device count, and so does cuda asked for on a
host without a GPU. Each rank gets back its own copy of the payload, bit for
bit: rows are raw bytes.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import round_step
from repro_torch.device.runner import (PacketLayout, _as_bytes,
                                       packet_layout, resolve_device,
                                       slot_tables)
from repro_torch.device.schedule import DeviceSchedule


def rank_device(group=None, device="cuda") -> torch.device:
    """The device of this rank's buffer in ``group``: ``cuda:<local rank>``
    for ``"cuda"`` (an explicit ``"cuda:i"`` is kept), made the current
    CUDA device as NCCL's point-to-point calls ask; else ``device``.
    Raises for a CUDA device in a gloo group and for cuda on a host without
    a GPU."""
    dev = torch.device(device)
    backend = dist.get_backend(group)
    if dev.type == "cuda" and backend == "gloo":
        raise ValueError("a CUDA buffer in a gloo group: gloo has no CUDA "
                         "send and receive; use an NCCL group, or "
                         "device='cpu'")
    dev = resolve_device(dev)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        rank = dist.get_rank(group)
        dev = torch.device("cuda", int(local) if local is not None
                           else rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def _group_ranks(group, n: int) -> List[int]:
    """The global ranks of ``group``'s ranks 0..n-1; raises unless the group
    has exactly ``n`` ranks."""
    size = dist.get_world_size(group)
    if size != n:
        raise ValueError(f"the plan runs on {n} devices, the group has "
                         f"{size} ranks")
    if group is None or group is dist.group.WORLD:
        return list(range(n))
    return [dist.get_global_rank(group, r) for r in range(n)]


def _exchange(ops: list) -> None:
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()


def _start(group, dev: torch.device) -> None:
    # every rank of the group joins once before the first send, which NCCL's
    # batched point-to-point calls ask for
    dist.all_reduce(torch.zeros(1, device=dev), group=group)


@dataclasses.dataclass
class RankProgram:
    """One rank's part of a schedule, ready to run: built once (the tables,
    the buffer, the payload; ``prepare_bbs``, ``ring_round_group``) and
    run any number of times (``run``), so that a timed run holds no
    set-up.

    ``steps``: each sub-round's ``(src, s_ix, s_ok, r_ix, r_ok, to)`` for
    this rank (its column of ``runner.slot_tables``, and the group rank it
    sends to, -1 for none); ``local`` int32 ``[S, 5, 1]`` on the device:
    K1's table of each sub-round's write; ``buf`` uint8 ``[1, rows + 1,
    row_bytes]``: the packet and relay rows, then the staging row;
    ``zero``: the row sent where ``s_ok`` is false; ``payload``: the rows
    ``pack`` writes at ``buf[0, :total, :used]`` (the root's packed
    message, or the ring's row 0), None for none; ``lay``: the broadcast's
    ``runner.PacketLayout``, None for the ring."""

    group: object
    peers: List[int]
    steps: List[Tuple[int, ...]]
    local: torch.Tensor
    buf: torch.Tensor
    zero: torch.Tensor
    payload: Optional[torch.Tensor] = None
    lay: Optional[PacketLayout] = None

    def pack(self) -> None:
        """Reset the buffer to its state before the first sub-round."""
        self.buf.zero_()
        if self.payload is not None:
            total, used = self.payload.shape
            self.buf[0, :total, :used] = self.payload


def local_writes(tabs: np.ndarray, rows: int) -> np.ndarray:
    """K1's int32 ``[S, 5, 1]`` table of each sub-round's local write, from
    this rank's ``[S, 5]`` tables: the staging row (row ``rows``; zeros
    when no one sends here) written at ``r_ix`` if ``r_ok``."""
    local = np.zeros((tabs.shape[0], 5, 1), dtype=np.int32)
    local[:, 1, 0] = rows
    local[:, 2, 0] = tabs[:, 0] >= 0
    local[:, 3, 0] = tabs[:, 3]
    local[:, 4, 0] = tabs[:, 4]
    return local


def bbs_tables(sched: DeviceSchedule, num_groups: int,
               me: int) -> Tuple[np.ndarray, np.ndarray]:
    """Group rank ``me``'s ``[S, 5]`` tables of the broadcast (its column of
    ``runner.slot_tables``, every cycle's sub-rounds in turn) and the rank
    it sends to in each sub-round, -1 for none."""
    n, d = sched.num_devices, sched.d
    tabs = slot_tables(sched, num_groups)[..., me]       # [cycles, d, 5]
    dst = np.full((d, n), -1, dtype=np.int64)
    for r, pairs in enumerate(sched.perms):
        for a, b in pairs:
            dst[r, a] = b
    return tabs.reshape(-1, 5), np.tile(dst[:, me], tabs.shape[0])


def ring_tables(me: int, n: int, iters: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Group rank ``me``'s ``[iters, 5]`` tables of the calibration's ring
    (receive rank ``me - 1``'s row 0, write it at row 1) and the rank it
    sends to, ``me + 1``."""
    tabs = np.tile(np.array([[(me - 1) % n, 0, 1, 1, 1]]), (iters, 1))
    return tabs, np.full(iters, (me + 1) % n)


def _program(group, peers: List[int], dev: torch.device, tabs: np.ndarray,
             send_to: np.ndarray, rows: int, row_bytes: int,
             payload: Optional[torch.Tensor],
             lay: Optional[PacketLayout] = None) -> RankProgram:
    steps = [tuple(int(v) for v in t) + (int(to),)
             for t, to in zip(tabs, send_to)]
    prog = RankProgram(
        group=group, peers=peers, steps=steps,
        local=torch.from_numpy(local_writes(tabs, rows)).to(dev),
        buf=torch.zeros((1, rows + 1, row_bytes), dtype=torch.uint8,
                        device=dev),
        zero=torch.zeros(row_bytes, dtype=torch.uint8, device=dev),
        payload=payload, lay=lay)
    prog.pack()
    _start(group, dev)
    return prog


def prepare_bbs(x: torch.Tensor, sched: DeviceSchedule, num_groups: int,
                group=None, device="cuda") -> RankProgram:
    """This rank's program of the broadcast of ``x`` from the schedule's
    root: its tables, K1's tables of its writes, its buffer with the root's
    packed payload (only the root's ``x`` is read) and the peer list."""
    peers = _group_ranks(group, sched.num_devices)
    dev = rank_device(group, device)
    me = dist.get_rank(group)
    tabs, send_to = bbs_tables(sched, num_groups, me)
    lay = packet_layout(x, sched, num_groups)
    payload = None
    if me == sched.root:
        xb = _as_bytes(x).to(dev)
        padded = torch.zeros(lay.total * lay.used, dtype=torch.uint8,
                             device=dev)
        padded[:xb.numel()] = xb
        payload = padded.view(lay.total, lay.used)
    return _program(group, peers, dev, tabs, send_to, lay.rows,
                    lay.row_bytes, payload, lay)


def run(prog: RankProgram) -> None:
    """Run the program's sub-rounds on this rank, in place: for each, one
    ``batch_isend_irecv`` (the send row, or zeros where ``s_ok`` is false,
    to ``to``; the row from ``src`` into staging), then K1's
    ``permute_step`` of the write if ``r_ok``."""
    buf, group, peers = prog.buf, prog.group, prog.peers
    stage = buf[0, buf.shape[1] - 1]
    for k, (src, s_ix, s_ok, _, r_ok, to) in enumerate(prog.steps):
        ops = []
        if to >= 0:
            row = buf[0, s_ix] if s_ok else prog.zero
            ops.append(dist.P2POp(dist.isend, row, peers[to], group))
        if src >= 0:
            ops.append(dist.P2POp(dist.irecv, stage, peers[src], group))
        _exchange(ops)
        if r_ok:
            round_step.permute_step(buf, prog.local[k])


def bbs_broadcast(x: torch.Tensor, sched: DeviceSchedule, num_groups: int,
                  group=None, device="cuda") -> torch.Tensor:
    """Broadcast ``x`` from the schedule's root across ``group`` (one rank a
    device); returns this rank's copy, ``x.shape`` and dtype, on its device.
    Only the root's ``x`` is read. ``prepare_bbs``, then ``run``."""
    prog = prepare_bbs(x, sched, num_groups, group, device)
    run(prog)
    lay = prog.lay
    nbytes = x.numel() * x.element_size()
    out = prog.buf[0, :lay.total, :lay.used].reshape(-1)[:nbytes]
    return out.contiguous().view(x.dtype).reshape(x.shape)


def _ring_row(seed: int, row_bytes: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (1, row_bytes), dtype=torch.uint8,
                         generator=g)


def ring_round_group(nbytes: int, group=None, device="cuda",
                     iters: int = 32) -> RankProgram:
    """The calibration's ring rounds across ``group``, one rank a device:
    this rank's ``[1, 2 + 1, row]`` buffer (row 0 random bytes from the
    seed of its group rank, row 1 zero, then the staging row; the row is
    ``calibrate.ring_row_bytes(nbytes)``) and ``iters`` sub-rounds, each
    sending row 0 to rank ``r + 1`` and receiving rank ``r - 1``'s into
    staging, then writing staging at row 1 with K1's ``permute_step`` --
    the reference's ``ppermute`` over ``(i, i + 1)`` then
    ``round_step(buf, rec, 1, True, 0, True)``, through the executor's
    path."""
    from repro_torch.device.calibrate import ring_row_bytes
    n = dist.get_world_size(group)
    peers = _group_ranks(group, n)
    dev = rank_device(group, device)
    me = dist.get_rank(group)
    row = ring_row_bytes(nbytes)
    tabs, send_to = ring_tables(me, n, iters)
    return _program(group, peers, dev, tabs, send_to, 2, row,
                    _ring_row(me, row).to(dev))


def ring_delivered_group(prog: RankProgram) -> bool:
    """Every rank's whole buffer is what the ring leaves: row 0 its own
    seed's row, row 1 and the staging row its ring predecessor's row 0,
    rebuilt from that rank's seed; the AND over the group, known to every
    rank."""
    group, buf = prog.group, prog.buf
    n, me = dist.get_world_size(group), dist.get_rank(group)
    row = buf.shape[2]
    want = torch.cat([_ring_row(me, row)] + [_ring_row((me - 1) % n, row)] * 2
                     ).to(buf.device)
    flag = torch.tensor([int(torch.equal(buf[0], want))],
                        dtype=torch.int32, device=buf.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
    return bool(flag.item())


def measure(prog: RankProgram, reps: int) -> float:
    """Seconds of ``run(prog)`` on the slowest rank: the least of ``reps``
    windows after a warm-up one (which also pays NCCL's set-up of each
    peer pair), each from a freshly packed buffer (``pack``, outside the
    window). A window is a barrier, the run and a synchronize of this
    rank's device, on the host clock; its time is the maximum over the
    ranks by an all-reduce, so every rank returns the same float."""
    group, dev = prog.group, prog.buf.device
    best = float("inf")
    for i in range(reps + 1):
        prog.pack()
        if dev.type == "cuda":
            dist.barrier(group=group, device_ids=[dev.index])
        else:
            dist.barrier(group=group)
        t0 = time.perf_counter()
        run(prog)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                         device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        if i:                                   # window 0 is the warm-up
            best = min(best, float(t.item()))
    return best


def binomial_broadcast(x: torch.Tensor, n: int, root: int = 0, group=None,
                       device="cuda") -> torch.Tensor:
    """Whole-message binomial-tree broadcast across ``group``: log2(n)
    rounds; returns this rank's copy."""
    peers = _group_ranks(group, n)
    dev = rank_device(group, device)
    me = dist.get_rank(group)
    vrank = (me - root) % n
    buf = _as_bytes(x).to(dev).clone()
    if vrank:
        buf.zero_()
    have = vrank == 0
    _start(group, dev)
    for s in reversed(range(max(1, (n - 1).bit_length()))):
        stride = 1 << s
        ops = []
        if vrank % (2 * stride) == 0 and vrank + stride < n:
            ops.append(dist.P2POp(
                dist.isend, buf if have else torch.zeros_like(buf),
                peers[(root + vrank + stride) % n], group))
        if vrank % (2 * stride) == stride:
            ops.append(dist.P2POp(dist.irecv, buf,
                                  peers[(root + vrank - stride) % n], group))
            have = True
        _exchange(ops)
    return buf.view(x.dtype).reshape(x.shape)


def chain_broadcast(x: torch.Tensor, n: int, root: int = 0,
                    num_packets: int = 8, group=None,
                    device="cuda") -> torch.Tensor:
    """Pipelined chain broadcast across ``group``: packets stream rank ->
    rank+1, m + n - 2 rounds (the MPICH 'pipeline' baseline); returns this
    rank's copy."""
    peers = _group_ranks(group, n)
    dev = rank_device(group, device)
    me = dist.get_rank(group)
    m = num_packets
    vr = (me - root) % n
    xb = _as_bytes(x).to(dev)
    used = -(-x.numel() // m) * x.element_size()
    buf = torch.zeros((m, used), dtype=torch.uint8, device=dev)
    if vr == 0:
        buf.view(-1)[:xb.numel()] = xb
    _start(group, dev)
    for s in range(m + n - 2):
        # rank vr forwards packet s - vr; rank vr + 1 stores it as packet
        # s - vr (a pair exchanges exactly when both ends are in range)
        ops = []
        p = s - vr
        if 0 <= p < m and vr < n - 1:
            ops.append(dist.P2POp(dist.isend, buf[p],
                                  peers[(root + vr + 1) % n], group))
        if 0 <= p + 1 < m and vr >= 1:
            ops.append(dist.P2POp(dist.irecv, buf[p + 1],
                                  peers[(root + vr - 1) % n], group))
        _exchange(ops)
    out = buf.view(-1)[:xb.numel()]
    return out.contiguous().view(x.dtype).reshape(x.shape)


def delivered(mine: torch.Tensor, x: torch.Tensor, n: int,
              group=None) -> List[int]:
    """The group ranks whose copy differs from ``x`` in any byte, known to
    every rank (one all-reduce of a flag per rank)."""
    me = dist.get_rank(group)
    ok = torch.equal(_as_bytes(mine), _as_bytes(x).to(mine.device))
    flags = torch.zeros(n, dtype=torch.int32, device=mine.device)
    flags[me] = 0 if ok else 1
    dist.all_reduce(flags, group=group)
    return [int(v) for v in torch.nonzero(flags).flatten().tolist()]
