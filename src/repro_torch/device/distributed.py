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

import os
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import round_step
from repro_torch.device.runner import (_as_bytes, packet_layout,
                                       resolve_device, slot_tables)
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


def bbs_broadcast(x: torch.Tensor, sched: DeviceSchedule, num_groups: int,
                  group=None, device="cuda") -> torch.Tensor:
    """Broadcast ``x`` from the schedule's root across ``group`` (one rank a
    device); returns this rank's copy, ``x.shape`` and dtype, on its device.
    Only the root's ``x`` is read."""
    n, d = sched.num_devices, sched.d
    peers = _group_ranks(group, n)
    dev = rank_device(group, device)
    me = dist.get_rank(group)
    tabs = slot_tables(sched, num_groups)[..., me]       # [cycles, d, 5]
    dst = np.full((d, n), -1, dtype=np.int64)
    for r, pairs in enumerate(sched.perms):
        for a, b in pairs:
            dst[r, a] = b
    send_to = dst[:, me]
    lay = packet_layout(x, sched, num_groups)
    rows = lay.rows
    # the local write of each (cycle, sub-round): the staging row (or zeros
    # when no one sends here) at r_ix if r_ok
    local = np.zeros(tabs.shape[:2] + (5, 1), dtype=np.int32)
    local[..., 1, 0] = rows
    local[..., 2, 0] = tabs[..., 0] >= 0
    local[..., 3, 0] = tabs[..., 3]
    local[..., 4, 0] = tabs[..., 4]
    local_t = torch.from_numpy(local).to(dev)

    buf = torch.zeros((1, rows + 1, lay.row_bytes), dtype=torch.uint8,
                      device=dev)
    if me == sched.root:
        xb = _as_bytes(x).to(dev)
        padded = torch.zeros(lay.total * lay.used, dtype=torch.uint8,
                             device=dev)
        padded[:xb.numel()] = xb
        buf[0, :lay.total, :lay.used] = padded.view(lay.total, lay.used)
    zero = torch.zeros(lay.row_bytes, dtype=torch.uint8, device=dev)
    stage = buf[0, rows]
    _start(group, dev)
    for c in range(tabs.shape[0]):
        for r in range(d):
            src, s_ix, s_ok, r_ix, r_ok = (int(v) for v in tabs[c, r])
            ops = []
            if send_to[r] >= 0:
                row = buf[0, s_ix] if s_ok else zero
                ops.append(dist.P2POp(dist.isend, row, peers[send_to[r]],
                                      group))
            if src >= 0:
                ops.append(dist.P2POp(dist.irecv, stage, peers[src], group))
            _exchange(ops)
            if r_ok:
                round_step.permute_step(buf, local_t[c, r])
    nbytes = x.numel() * x.element_size()
    out = buf[0, :lay.total, :lay.used].reshape(-1)[:nbytes]
    return out.contiguous().view(x.dtype).reshape(x.shape)


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
