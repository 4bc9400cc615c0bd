"""Compile a ``Pipeline`` into static per-round ppermute tables.

The offline plan (repro.core.bbs) gives a cyclic pipeline: d conflict-free
rounds per cycle, one packet group (K packets, one per tree) shipped per
cycle. ``lax.ppermute`` moves one value per (src, dst) pair, so each pipeline
round is split into matchings (sub-rounds); a static table says which packet
index every device sends/receives in each sub-round, shifted by ``cycle * K``
as the pipeline advances. Causality is guaranteed by construction — a device
only ever forwards packets it already holds.

Two things a plain matching compiler would not do:

  * **Route overrides are honored.** Orbit-relabeled plans
    (``repro.core.symmetry.relabel_plan``) pin the permuted physical route of
    every routed plan edge in ``Pipeline.routes``; the schedule follows the
    pinned node path instead of re-routing the image edge through the
    router's tie-breaks, so a relabeled plan compiles to exactly the
    permuted representative schedule (asserted in tests/test_device.py).
  * **Multi-hop plan edges execute.** A routed edge (u, v) becomes a chain
    of single-hop forwards within the cycle: intermediate nodes carry the
    packet through per-task *relay slots* — scratch rows appended after the
    ``m*K`` packet rows, written and re-read once per cycle at a static
    index (no ``cycle*K`` shift) — so topology-oblivious trees (Bine,
    binomial-over-ranks) run on sparse fabrics through the same tables.
    Every hop is validated to be a physical cable.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.routing import CompiledTopology
from repro_torch.core.schedule import Pipeline

_NOSEND = -(10 ** 6)


@dataclasses.dataclass
class DeviceSchedule:
    """Static per-sub-round ppermute tables for one pipeline.

    For sub-round r:
      perms[r]          : list of (src, dst) device pairs (a matching)
      send_rel[r][dev]  : relative packet index sent by dev (k - K*arr) or big
                          negative when dev is not a sender this round
      recv_rel[r][dev]  : relative packet index received, same convention
      send_abs[r][dev]  : relay-slot index sent (>= 0), -1 when the send (if
                          any) is a packet row; likewise recv_abs.
    Packet index at cycle c = c*K + rel, masked outside [0, m*K); relay
    indexes are absolute: m*K + abs, live for one cycle only.
    """

    num_devices: int
    K: int
    d: int
    max_arrival: int
    perms: List[List[Tuple[int, int]]]
    send_rel: np.ndarray        # (d, num_devices) int64
    recv_rel: np.ndarray        # (d, num_devices) int64
    send_abs: np.ndarray        # (d, num_devices) int64, -1 = not a relay read
    recv_abs: np.ndarray        # (d, num_devices) int64, -1 = not a relay write
    num_relay: int
    root: int

    def num_cycles(self, num_groups: int) -> int:
        return num_groups + self.max_arrival


class NotDeviceExecutable(ValueError):
    """The pipeline cannot be rendered as ppermute matchings on this fabric
    (e.g. a pinned route crossing a non-existent cable)."""


def _decode_route(u: int, v: int, links: Sequence[str]) -> Tuple[int, ...]:
    """Node path u -> v recovered from a pinned physical route.

    Flat-topology cable names encode their endpoints (``cable:a->b`` for
    per-direction channels, ``cable:lo-hi`` shared); the pinned route lists
    them in path order, so the walk is deterministic."""
    path = [u]
    cur = u
    for name in links:
        body = name.split(":", 1)[1] if ":" in name else name
        if "->" in body:
            a, b = body.split("->")
            a, b = int(a), int(b)
            if a != cur:
                raise NotDeviceExecutable(
                    f"pinned route for ({u}, {v}) breaks at {name}: "
                    f"expected a hop leaving {cur}")
            nxt = b
        elif "-" in body:
            a, b = body.split("-")
            ends = {int(a), int(b)}
            if cur not in ends:
                raise NotDeviceExecutable(
                    f"pinned route for ({u}, {v}) breaks at {name}: "
                    f"{cur} is not an endpoint")
            (nxt,) = ends - {cur} if len(ends) == 2 else (cur,)
        else:
            raise NotDeviceExecutable(
                f"pinned route link {name!r} is not a flat-fabric cable; "
                f"device schedules need endpoint-addressed links")
        path.append(nxt)
        cur = nxt
    if cur != v:
        raise NotDeviceExecutable(
            f"pinned route for ({u}, {v}) ends at {cur}, not {v}")
    return tuple(path)


def _task_paths(pipe: Pipeline, compiled: Optional[CompiledTopology],
                ) -> List[Tuple[int, ...]]:
    """Physical node path per flat task: the pinned override route when the
    plan carries one (relabeled plans), the routed path otherwise."""
    ft = pipe.flat_tasks()
    paths: List[Tuple[int, ...]] = []
    for i, (u, v) in enumerate(zip(ft.src, ft.dst)):
        rt = ft.route[i] if ft.route is not None else None
        if rt is not None:
            path = _decode_route(u, v, rt[0])
        elif compiled is not None:
            path = compiled.path(u, v)
        else:
            path = (u, v)
        if compiled is not None:
            for a, b in zip(path, path[1:]):
                if compiled.hops(a, b) != 1:
                    raise NotDeviceExecutable(
                        f"pipeline edge ({u}, {v}) routes over ({a}, {b}) "
                        f"which is not a physical link "
                        f"(hops={compiled.hops(a, b)})")
        elif len(path) > 2:
            raise NotDeviceExecutable(
                f"pipeline edge ({u}, {v}) is multi-hop; pass the fabric's "
                f"CompiledTopology so the schedule can validate relay hops")
        paths.append(path)
    return paths


def make_device_schedule(pipe: Pipeline, num_devices: int,
                         compiled: Optional[CompiledTopology] = None,
                         ) -> DeviceSchedule:
    """Compile a Pipeline into static ppermute tables.

    arrival(v, k) = cycle (0-based) at which v receives tree k's group-0
    packet: arr(child) = arr(parent) + (first-hop sub-round <= parent's
    receive sub-round). Arrivals are computed from the pipeline's compiled
    steady-state template (``Pipeline.flat_tasks()`` — the same artifact the
    fast engine replays and the PlanStore persists) in one depth-ordered
    pass: a task's sender received its packet at a strictly smaller tree
    depth, so every parent arrival is resolved before its children.

    Multi-hop tasks chain through relay slots (module docstring); their hops
    occupy consecutive sub-rounds of the task's pipeline round, so the whole
    chain completes within the cycle. With ``compiled`` every hop is checked
    to be a single physical link.
    """
    K = len(pipe.trees)
    root = pipe.trees[0].root
    ft = pipe.flat_tasks()
    paths = _task_paths(pipe, compiled)

    # assign every hop of every task to a sub-round: pipeline rounds keep
    # their order, each round expands into as many matchings as its tasks and
    # relay chains need. Placement uses set membership only, so the result is
    # equivariant under vertex relabeling (the symmetry round-trip contract).
    n_tasks = len(ft)
    first_slot = [0] * n_tasks
    last_slot = [0] * n_tasks
    hop_slots: List[List[Tuple[int, int, int]]] = []   # slot -> [(task, a, b)]
    senders: List[set] = []
    receivers: List[set] = []
    base = 0
    current_round = -1
    for i in range(n_tasks):
        if ft.round_ix[i] != current_round:
            current_round = ft.round_ix[i]
            base = len(hop_slots)
        prev = -1                          # slot of the previous hop, global
        for a, b in zip(paths[i], paths[i][1:]):
            s = max(base, prev + 1)
            while s < len(hop_slots) and (a in senders[s] or b in receivers[s]):
                s += 1
            while s >= len(hop_slots):
                hop_slots.append([])
                senders.append(set())
                receivers.append(set())
            hop_slots[s].append((i, a, b))
            senders[s].add(a)
            receivers[s].add(b)
            if prev == -1:
                first_slot[i] = s
            last_slot[i] = s
            prev = s

    # arrival pass on sub-round granularity (depth order resolves parents
    # before children; a forward chained within the cycle keeps bump = 0)
    arr: Dict[Tuple[int, int], int] = {}       # (tree, node) -> arrival cycle
    in_sub: Dict[Tuple[int, int], int] = {}    # (tree, node) -> recv sub-round
    for k in range(K):
        arr[(k, root)] = 0
        in_sub[(k, root)] = -1                 # root holds packets pre-round-0
    for i in sorted(range(n_tasks), key=lambda i: ft.depth[i]):
        k, u, v = ft.tree[i], ft.src[i], ft.dst[i]
        bump = 1 if first_slot[i] <= in_sub[(k, u)] else 0
        arr[(k, v)] = arr[(k, u)] + bump
        in_sub[(k, v)] = last_slot[i]

    d_exec = len(hop_slots)
    perms: List[List[Tuple[int, int]]] = [[] for _ in range(d_exec)]
    send_rel = np.full((d_exec, num_devices), _NOSEND, dtype=np.int64)
    recv_rel = np.full((d_exec, num_devices), _NOSEND, dtype=np.int64)
    send_abs = np.full((d_exec, num_devices), -1, dtype=np.int64)
    recv_abs = np.full((d_exec, num_devices), -1, dtype=np.int64)
    relay_of: Dict[Tuple[int, int], int] = {}  # (task, hop_ix) -> relay slot
    num_relay = 0
    for s, hops in enumerate(hop_slots):
        for (i, a, b) in hops:
            k, v = ft.tree[i], ft.dst[i]
            rel = k - K * arr[(k, v)]
            path = paths[i]
            # (a, b) identifies the hop uniquely within the task's path
            hop_ix = next(h for h, (pa, pb) in
                          enumerate(zip(path, path[1:])) if (pa, pb) == (a, b))
            perms[s].append((int(a), int(b)))
            if hop_ix == 0:
                send_rel[s][a] = rel           # read the sender's packet row
            else:
                send_abs[s][a] = relay_of[(i, hop_ix - 1)]
            if hop_ix == len(path) - 2:
                recv_rel[s][b] = rel           # final delivery: packet row
            else:
                slot = relay_of.get((i, hop_ix))
                if slot is None:
                    slot = relay_of[(i, hop_ix)] = num_relay
                    num_relay += 1
                recv_abs[s][b] = slot
    max_arrival = max(arr.values())
    _check_no_send_recv_overlap(send_rel, recv_rel, send_abs, recv_abs)
    return DeviceSchedule(num_devices=num_devices, K=K, d=d_exec,
                          max_arrival=max_arrival, perms=perms,
                          send_rel=send_rel, recv_rel=recv_rel,
                          send_abs=send_abs, recv_abs=recv_abs,
                          num_relay=num_relay, root=root)


def _check_no_send_recv_overlap(send_rel: np.ndarray, recv_rel: np.ndarray,
                                send_abs: np.ndarray, recv_abs: np.ndarray,
                                ) -> None:
    """No device sends and receives the same row in one sub-round.

    The virtual-mesh runner (``repro_torch.device.round_step``) applies a
    whole sub-round -- every sender's read and every receiver's write -- in
    one in-place launch over all devices, which is race-free only under this
    property. It is cycle-independent: a packet read and a packet write of
    one device hit the same row (``c*K + rel``) exactly when their ``rel``
    agree, a relay read and a relay write exactly when their slots agree,
    and packet rows never alias relay rows (out-of-range packet indexes are
    masked, never clipped into a live access)."""
    sends = (send_rel != _NOSEND) | (send_abs >= 0)
    recvs = (recv_rel != _NOSEND) | (recv_abs >= 0)
    both = sends & recvs
    packet = both & (send_abs < 0) & (recv_abs < 0) & (send_rel == recv_rel)
    relay = both & (send_abs >= 0) & (send_abs == recv_abs)
    bad = np.argwhere(packet | relay)
    if len(bad):
        r, v = (int(i) for i in bad[0])
        raise NotDeviceExecutable(
            f"device {v} sends and receives the same row in sub-round {r} "
            f"({len(bad)} such (sub-round, device) pairs); the fused "
            f"virtual-mesh round step needs disjoint rows")
