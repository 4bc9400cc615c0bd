"""The BBS cycle loop's round step on n virtual devices.

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

``permute_step`` runs one sub-round: it launches the hand-written CUDA
kernel ``csrc/permute_step.cu`` on a CUDA tensor and runs the plain version
``permute_step_ref`` on a CPU tensor; on any other device it raises.
``launches`` counts the kernel's launches.

``permute_rounds`` runs a whole sequence of sub-rounds in one launch of
``csrc/permute_rounds.cu`` (a persistent grid with a grid-wide barrier
between steps), from the compacted moves of ``compact_moves``: for each
sub-round only the ``(dst_row, src_row)`` pairs of its writing receivers,
as row indexes into the ``[n * rows, row_bytes]`` view of the buffer. The
kernel reads them as byte offsets (``RowOffsets``, from
``Moves.offsets``): by default those of that buffer, ``row * row_bytes``,
or those of any placement of the rows in one flat allocation (the runner's
in-place layout puts most of them straight into the stacked output).

A launch over all of a plan's sub-rounds runs its moves by dependency
phase when the moves carry their phase table (``with_phases``: taken in
sub-round order, each move goes to the first phase after those its rows'
read-after-write, write-after-write and write-after-read hazards ask
that has room, a phase holding at most ``phase_cap`` moves; the host pass
``phase_table`` in the kernel's library, plain version
``phase_table_ref``), with one barrier between phases; any other range,
and moves without the table, runs a step a sub-round. The bytes are the
same either way. The plain version ``permute_rounds_ref`` applies the
moves sub-round by sub-round, always.

``rounds_launches`` counts the kernel's launches, ``subrounds`` the
sub-rounds they ran and ``phases`` the steps they ran them in;
``moved_bytes`` counts the HBM bytes of rows that every ``permute_rounds``
call, on the card or the plain path, reads and writes
(``Moves.moved_bytes``), and ``relay_bytes`` the part of them moved by
moves that read or write a relay row (``Moves.relay_bytes``).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

launches = 0          # kernel launches of permute_step since the last reset
rounds_launches = 0   # kernel launches of permute_rounds since the last reset
subrounds = 0         # sub-rounds those permute_rounds launches ran
phases = 0            # steps they ran them in: phases, or sub-rounds
moved_bytes = 0       # row bytes permute_rounds calls read and wrote
relay_bytes = 0       # the part of them moved by moves touching a relay row

_fn = None
_rounds_lib = None
# permute_rounds' barrier word, zeroed once, per (device, stream)
_workspaces: Dict[Tuple[int, int], torch.Tensor] = {}


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


@dataclasses.dataclass(frozen=True)
class Moves:
    """A sequence of sub-rounds compacted to the moves that happen.

    ``pairs`` int64 ``[M, 2]``: ``(dst_row, src_row)`` of every receiver
    with ``r_ok``, as row indexes ``v * rows + r_ix[v]`` into the
    ``[n * rows, row_bytes]`` view of the buffer; ``src_row`` is -1 for a
    zero write. ``offs`` int64 ``[S + 1]``: sub-round s's pairs are
    ``pairs[offs[s]:offs[s + 1]]``. ``counts`` is the host copy of each
    sub-round's number of pairs, and ``n, rows`` the buffer they index.
    ``moves_cum`` and ``zeros_cum`` (int64 ``[S + 1]``, on the host) are
    prefix sums of the pairs and of the zero writes by sub-round;
    ``relay_cum`` and ``relay_zeros_cum`` the same of the pairs that read
    or write a relay row (``compact_moves``' ``packets`` and on).
    ``phases``: the dependency phases a launch over every sub-round runs
    the pairs in (``with_phases``), or None: a step a sub-round."""

    pairs: torch.Tensor
    offs: torch.Tensor
    counts: np.ndarray
    n: int
    rows: int
    moves_cum: np.ndarray
    zeros_cum: np.ndarray
    relay_cum: np.ndarray
    relay_zeros_cum: np.ndarray
    phases: Optional["Phases"] = None
    _staged: Dict[int, "RowOffsets"] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def num_subrounds(self) -> int:
        return len(self.counts)

    @property
    def device(self) -> torch.device:
        return self.pairs.device

    def to(self, device) -> "Moves":
        ph = self.phases
        if ph is not None:
            ph = dataclasses.replace(ph, order=ph.order.to(device))
        return dataclasses.replace(self, pairs=self.pairs.to(device),
                                   offs=self.offs.to(device), phases=ph)

    def offsets(self, row_bytes: int,
                row_at: Optional[np.ndarray] = None) -> "RowOffsets":
        """The moves' rows as byte offsets into one flat allocation, on the
        moves' device: row ``i`` of the ``[n * rows]`` rows at
        ``row_at[i]`` (int64, each a multiple of 16), or by default at
        ``i * row_bytes``, the ``[n, rows, row_bytes]`` buffer's rows (made
        once per ``row_bytes`` and kept). The rows must not overlap; that
        is the caller's to keep. With ``phases`` they come in phase order
        too, each phase cut to at most 2**30 chunks of 16 bytes."""
        if row_bytes <= 0 or row_bytes % 16:
            raise ValueError(f"K1 moves 16-byte chunks: row_bytes "
                             f"{row_bytes} must be a positive multiple of "
                             f"16")
        if row_at is None:
            at = self._staged.get(row_bytes)
            if at is None:
                pairs = torch.where(self.pairs >= 0, self.pairs * row_bytes,
                                    -1)
                at = self._staged[row_bytes] = self._row_offsets(
                    pairs, row_bytes, self.n * self.rows * row_bytes)
            return at
        row_at = np.asarray(row_at, dtype=np.int64)
        if row_at.shape != (self.n * self.rows,):
            raise ValueError(f"row_at must give the {self.n * self.rows} "
                             f"rows' offsets, got shape {row_at.shape}")
        if row_at.size and (row_at.min() < 0 or (row_at % 16).any()):
            raise ValueError("row offsets must be non-negative multiples "
                             "of 16")
        table = torch.from_numpy(row_at).to(self.device)
        pairs = torch.where(self.pairs >= 0,
                            table[self.pairs.clamp(min=0)], -1)
        span = int(row_at.max()) + row_bytes if row_at.size else 0
        return self._row_offsets(pairs, row_bytes, span)

    def _row_offsets(self, pairs: torch.Tensor, row_bytes: int,
                     span: int) -> "RowOffsets":
        ph = self.phases
        if ph is None:
            return RowOffsets(pairs, row_bytes, span)
        offs = split_phases(ph.offs, 2 ** 30 // (row_bytes // 16))
        return RowOffsets(pairs, row_bytes, span, pairs[ph.order],
                          torch.from_numpy(offs).to(self.device))

    def idle(self) -> "Moves":
        """The same sub-rounds with no move in any: ``permute_rounds`` on
        them runs K1's grid barriers alone."""
        zero = np.zeros_like(self.moves_cum)
        return dataclasses.replace(
            self, pairs=self.pairs[:0], offs=torch.zeros_like(self.offs),
            counts=np.zeros_like(self.counts), moves_cum=zero,
            zeros_cum=zero, relay_cum=zero, relay_zeros_cum=zero,
            phases=None)

    def moved_bytes(self, s0: int, s1: int, row_bytes: int) -> int:
        """HBM bytes of rows that sub-rounds ``[s0, s1)`` read and write on
        rows of ``row_bytes``: every move writes a row, and every move but a
        zero write reads one."""
        moves = int(self.moves_cum[s1] - self.moves_cum[s0])
        zeros = int(self.zeros_cum[s1] - self.zeros_cum[s0])
        return (2 * moves - zeros) * row_bytes

    def relay_bytes(self, s0: int, s1: int, row_bytes: int) -> int:
        """The part of ``moved_bytes(s0, s1, row_bytes)`` moved by the moves
        that read or write a relay row: both rows of such a move, or the
        row it writes if it is a zero write."""
        moves = int(self.relay_cum[s1] - self.relay_cum[s0])
        zeros = int(self.relay_zeros_cum[s1] - self.relay_zeros_cum[s0])
        return (2 * moves - zeros) * row_bytes


@dataclasses.dataclass(frozen=True)
class RowOffsets:
    """Where the rows a ``Moves`` names lie in one flat uint8 allocation
    (``Moves.offsets``): ``pairs`` int64 ``[M, 2]``, the moves'
    ``(dst, src)`` as byte offsets, multiples of 16 (``src`` -1: a zero
    write), on the moves' device; every row ``row_bytes`` long and inside
    the allocation's first ``span`` bytes. For moves with phases,
    ``phase_pairs`` holds the same offsets in phase order and
    ``phase_offs`` (int64, on the device) each phase's range of them, a
    phase of more than 2**30 chunks cut into pieces."""

    pairs: torch.Tensor
    row_bytes: int
    span: int
    phase_pairs: Optional[torch.Tensor] = None
    phase_offs: Optional[torch.Tensor] = None

    @property
    def num_phases(self) -> int:
        return 0 if self.phase_offs is None else len(self.phase_offs) - 1


@dataclasses.dataclass(frozen=True)
class Phases:
    """The dependency phases of a ``Moves``' pairs (``phase_table``):
    ``order`` int64 ``[M]`` on the moves' device, the pairs' indexes in
    phase order (a permutation; a phase's pairs in sub-round order), and
    ``offs`` int64 ``[D + 1]`` on the host, phase p's at
    ``order[offs[p]:offs[p + 1]]``."""

    order: torch.Tensor
    offs: np.ndarray

    @property
    def count(self) -> int:
        return len(self.offs) - 1


def split_phases(offs: np.ndarray, cap: int) -> np.ndarray:
    """Phase offsets ``offs`` with every phase of more than ``cap`` moves
    cut into consecutive pieces of at most ``cap`` (at least 1): legal, as
    a part of a phase reads no row that the phase writes."""
    cap = max(1, cap)
    counts = np.diff(offs)
    pieces = np.maximum(1, -(-counts // cap))
    if (pieces == 1).all():
        return offs
    nth = np.arange(int(pieces.sum())) - np.repeat(np.cumsum(pieces) - pieces,
                                                   pieces)
    return np.append(np.repeat(offs[:-1], pieces) + nth * cap, offs[-1])


def _prefix(per_subround: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(per_subround)]).astype(np.int64)


def compact_moves(tabs: np.ndarray, rows: int,
                  packets: Optional[int] = None) -> Moves:
    """The moves of a sequence of sub-round tables (int ``[..., 5, n]``, the
    leading dimensions flattened in order) on a buffer of ``rows`` rows per
    device, on the CPU; rows ``[packets, rows)`` of each device are relay
    rows (none by default). Raises if a live index lies outside
    ``[0, rows)``."""
    tabs = np.asarray(tabs)
    n = tabs.shape[-1]
    t = tabs.reshape(-1, 5, n).astype(np.int64)
    src, s_ix, s_ok, r_ix, r_ok = (t[:, i] for i in range(5))
    u = np.clip(src, 0, None)
    live = (src >= 0) & (np.take_along_axis(s_ok, u, axis=1) != 0)
    s_row = np.take_along_axis(s_ix, u, axis=1)
    write = r_ok != 0
    for ix, ok in ((s_row, live & write), (r_ix, write)):
        bad = ok & ((ix < 0) | (ix >= rows))
        if bad.any():
            raise ValueError(f"a sub-round table indexes a row outside "
                             f"[0, {rows})")
    packets = rows if packets is None else packets
    v = np.arange(n, dtype=np.int64)[None]
    src_row = np.where(live, u * rows + s_row, -1)
    pairs = np.stack([(v * rows + r_ix)[write], src_row[write]], axis=1)
    counts = write.sum(axis=1).astype(np.int64)
    offs = _prefix(counts)
    zero = write & ~live
    relay = write & ((r_ix >= packets) | (live & (s_row >= packets)))
    return Moves(pairs=torch.from_numpy(np.ascontiguousarray(pairs)),
                 offs=torch.from_numpy(offs), counts=counts, n=n, rows=rows,
                 moves_cum=offs, zeros_cum=_prefix(zero.sum(axis=1)),
                 relay_cum=_prefix(relay.sum(axis=1)),
                 relay_zeros_cum=_prefix((relay & zero).sum(axis=1)))


# a phase's moves: enough rows to write PHASE_BYTES, so that the next phase
# finds most of what it reads in the card's 50 MB L2, and at least
# PHASE_ROWS rows, below which one more barrier costs more than that saves
# (both measured on an H100 over the cells' plans, PERF.md)
PHASE_BYTES = 16 << 20
PHASE_ROWS = 320


def phase_cap(row_bytes: int) -> int:
    """The moves a phase may hold on rows of ``row_bytes``."""
    return max(-(-PHASE_BYTES // row_bytes), PHASE_ROWS)


def phase_table_ref(moves: Moves, cap: int = 0) -> Phases:
    """The plain version of ``phase_table``, one move at a time in sub-round
    order: a move goes to the first phase after the last that wrote its
    source row, wrote its destination row or read its destination row,
    that holds fewer than ``cap`` moves (any, for ``cap`` 0); the pairs
    ordered by phase, stably."""
    pairs = moves.pairs.cpu().numpy()
    rows = moves.n * moves.rows
    if len(pairs) and (pairs[:, 0].min() < 0 or pairs.max() >= rows
                       or pairs[:, 1].min() < -1):
        raise ValueError(f"a move names a row outside [0, {rows})")
    wrote, read = [-1] * rows, [-1] * rows
    wrote_in, read_in = [-1] * rows, [-1] * rows
    count = []
    phase = np.zeros(len(pairs), dtype=np.int64)
    for s in range(moves.num_subrounds):
        for i in range(moves.moves_cum[s], moves.moves_cum[s + 1]):
            d, r = int(pairs[i, 0]), int(pairs[i, 1])
            if s in (wrote_in[d], read_in[d]) or \
                    (r >= 0 and wrote_in[r] == s):
                raise ValueError(f"sub-round {s} reads a row that it writes "
                                 f"or writes a row twice")
            p = max(wrote[d], read[d], wrote[r] if r >= 0 else -1) + 1
            while cap > 0 and p < len(count) and count[p] >= cap:
                p += 1
            if p == len(count):
                count.append(0)
            count[p] += 1
            phase[i] = p
            wrote[d], wrote_in[d] = p, s
            if r >= 0:
                read[r], read_in[r] = max(read[r], p), s
    order = np.argsort(phase, kind="stable")
    return Phases(order=torch.from_numpy(order).to(moves.device),
                  offs=_prefix(np.array(count, dtype=np.int64)))


def phase_table(moves: Moves, cap: int = 0) -> Phases:
    """``phase_table_ref``'s result from the host pass
    ``permute_rounds_phases`` in the kernel's library
    (``csrc/permute_rounds.cu``, built on first use), which also orders the
    pairs by phase. Raises ``ValueError`` when a sub-round reads a row that
    it writes or writes a row twice, which K1 needs never happens."""
    pairs = np.ascontiguousarray(moves.pairs.cpu().numpy(), dtype=np.int64)
    sub = np.ascontiguousarray(moves.moves_cum, dtype=np.int64)
    rows = moves.n * moves.rows
    order = np.empty(len(pairs), dtype=np.int64)
    offs = np.empty(len(pairs) + 1, dtype=np.int64)
    count = _rounds_kernel().permute_rounds_phases(
        pairs.ctypes.data, len(pairs), sub.ctypes.data, moves.num_subrounds,
        rows, cap, order.ctypes.data, offs.ctypes.data)
    if count == -2:
        raise ValueError(f"a move names a row outside [0, {rows})")
    if count < 0:
        raise ValueError("a sub-round reads a row that it writes or writes "
                         "a row twice")
    return Phases(order=torch.from_numpy(order).to(moves.device),
                  offs=offs[:count + 1].copy())


def with_phases(moves: Moves, row_bytes: int) -> Moves:
    """``moves`` with their dependency phases (``phase_table``, capped for
    rows of ``row_bytes`` by ``phase_cap``), which a launch over all of
    their sub-rounds runs; moves with no pair come back as they are (a step
    a sub-round: the barriers alone)."""
    if not len(moves.pairs):
        return moves
    return dataclasses.replace(
        moves, phases=phase_table(moves, phase_cap(row_bytes)))


def _span(moves: Moves, s0: int, s1: Optional[int]) -> Tuple[int, int]:
    s1 = moves.num_subrounds if s1 is None else s1
    if not 0 <= s0 <= s1 <= moves.num_subrounds:
        raise ValueError(f"sub-rounds [{s0}, {s1}) are not a range of the "
                         f"{moves.num_subrounds} moves hold")
    return s0, s1


def _check_rounds(buf: torch.Tensor, moves: Moves,
                  at: Optional[RowOffsets]) -> int:
    """Raises unless ``buf`` is what ``moves`` (and ``at``) address;
    returns the rows' bytes."""
    if at is None:
        if buf.dtype != torch.uint8 or buf.dim() != 3 or \
                not buf.is_contiguous():
            raise ValueError(f"buf must be a contiguous [n, rows, "
                             f"row_bytes] uint8 tensor, got {buf.dtype} "
                             f"{tuple(buf.shape)}")
        if tuple(buf.shape[:2]) != (moves.n, moves.rows):
            raise ValueError(f"the moves index a [{moves.n}, {moves.rows}] "
                             f"buffer, got {tuple(buf.shape)}")
        row_bytes = buf.shape[2]
    else:
        if buf.dtype != torch.uint8 or not buf.is_contiguous() or \
                buf.numel() < at.span:
            raise ValueError(f"buf must be a contiguous uint8 tensor of at "
                             f"least {at.span} bytes, got {buf.dtype} "
                             f"{tuple(buf.shape)}")
        if tuple(at.pairs.shape) != tuple(moves.pairs.shape) or \
                at.pairs.device != buf.device or \
                (moves.phases is not None and at.phase_pairs is None):
            raise ValueError("the row offsets are not the moves' or lie on "
                             "another device than the buffer")
        row_bytes = at.row_bytes
    if moves.device != buf.device or moves.offs.device != buf.device:
        raise ValueError(f"the moves lie on {moves.device}, the buffer on "
                         f"{buf.device}")
    return row_bytes


def permute_rounds_ref(buf: torch.Tensor, moves: Moves, s0: int = 0,
                       s1: Optional[int] = None,
                       at: Optional[RowOffsets] = None) -> torch.Tensor:
    """The plain PyTorch version of ``permute_rounds``: sub-rounds
    ``[s0, s1)`` of ``moves`` one after another, in place on ``buf``; every
    read of a sub-round precedes its writes. With ``at`` the rows lie in
    the flat ``buf`` at its byte offsets."""
    row_bytes = _check_rounds(buf, moves, at)
    s0, s1 = _span(moves, s0, s1)
    if at is None:
        flat, pairs = buf.view(moves.n * moves.rows, row_bytes), moves.pairs
        cols = None
    else:
        flat, pairs = buf.view(-1), at.pairs
        cols = torch.arange(row_bytes, device=buf.device)
    offs = np.concatenate([[0], np.cumsum(moves.counts)]).tolist()
    for s in range(s0, s1):
        if offs[s] == offs[s + 1]:
            continue
        dst, src = pairs[offs[s]:offs[s + 1]].unbind(1)
        zero = src < 0
        src = src.clamp(min=0)
        if cols is not None:
            dst, src = dst[:, None] + cols, src[:, None] + cols
        val = flat[src]                           # a copy: reads first
        val[zero] = 0
        flat[dst] = val
    return buf


def _rounds_kernel():
    global _rounds_lib
    if _rounds_lib is None:
        from repro_torch.nvcc import load
        lib = load("permute_rounds")
        lib.permute_rounds.argtypes = [ctypes.c_void_p] * 3 + \
            [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        lib.permute_rounds.restype = ctypes.c_int
        lib.permute_rounds_blocks.argtypes = []
        lib.permute_rounds_blocks.restype = ctypes.c_int
        lib.permute_rounds_phases.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.permute_rounds_phases.restype = ctypes.c_longlong
        _rounds_lib = lib
    return _rounds_lib


def rounds_grid(device=None) -> Tuple[int, int]:
    """(blocks, threads per block) of ``permute_rounds``' cooperative grid
    on a CUDA device (the current one by default)."""
    lib = _rounds_kernel()
    with torch.cuda.device(device):
        blocks = lib.permute_rounds_blocks()
    if blocks <= 0:
        why = f"CUDA error {-blocks}" if blocks else "no block fits an SM"
        raise RuntimeError(f"permute_rounds cannot size its cooperative "
                           f"grid: {why}")
    return blocks, ctypes.c_int.in_dll(lib, "permute_rounds_threads").value


def _workspace(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None:
        ws = _workspaces[key] = torch.zeros(1, dtype=torch.int32,
                                            device=device)
    return ws


def permute_rounds(buf: torch.Tensor, moves: Moves, s0: int = 0,
                   s1: Optional[int] = None,
                   at: Optional[RowOffsets] = None) -> torch.Tensor:
    """Sub-rounds ``[s0, s1)`` of ``moves`` (all by default) on all virtual
    devices, in place: one launch of the persistent CUDA kernel for a CUDA
    ``buf`` (``launch_rounds``, after every check), ``permute_rounds_ref``
    for a CPU ``buf``. ``buf`` is the ``[n, rows, row_bytes]`` buffer, or
    with ``at`` (``Moves.offsets``) a flat uint8 allocation that holds the
    rows at those byte offsets. The whole range of moves with phases runs
    by phase, any other a step a sub-round (module docstring). A refused
    launch raises; nothing falls back to one launch per sub-round. Either
    way ``moved_bytes`` and ``relay_bytes`` grow by the bytes the
    sub-rounds move."""
    row_bytes = _check_rounds(buf, moves, at)
    s0, s1 = _span(moves, s0, s1)
    if buf.device.type == "cpu":
        permute_rounds_ref(buf, moves, s0, s1, at)
        _count_bytes(moves, s0, s1, row_bytes)
        return buf
    if buf.device.type != "cuda":
        raise ValueError(f"permute_rounds runs on cuda or cpu, not "
                         f"{buf.device}")
    if row_bytes % 16 or buf.data_ptr() % 16:
        raise ValueError(f"the kernel moves 16-byte chunks: row_bytes "
                         f"{row_bytes} and the buffer address must be "
                         f"multiples of 16")
    if s0 == s1 or moves.n == 0 or row_bytes == 0:
        return buf
    if not fits_launch(moves, row_bytes, s0, s1):
        raise ValueError(f"a step moves more than 2**30 chunks of 16 bytes "
                         f"({int(moves.counts[s0:s1].max())} rows of "
                         f"{row_bytes // 16} in a sub-round)")
    if at is None:
        at = moves.offsets(row_bytes)
    with torch.cuda.device(buf.device):
        launch_rounds(buf, moves, s0, s1, at,
                      torch.cuda.current_stream(buf.device).cuda_stream)
    return buf


def fits_launch(moves: Moves, row_bytes: int, s0: int = 0,
                s1: Optional[int] = None) -> bool:
    """Whether every step of a launch over ``[s0, s1)`` moves at most 2**30
    chunks of 16 bytes, as the kernel needs: every sub-round, or by phase
    every row (``Moves.offsets`` cuts a larger phase)."""
    s1 = moves.num_subrounds if s1 is None else s1
    chunks = row_bytes // 16
    if s0 == s1:
        return True
    if _by_phase(moves, s0, s1):
        return chunks <= 2 ** 30
    return int(moves.counts[s0:s1].max()) * chunks <= 2 ** 30


def _by_phase(moves: Moves, s0: int, s1: int) -> bool:
    """Whether a launch over sub-rounds ``[s0, s1)`` runs by phase."""
    return moves.phases is not None and (s0, s1) == (0, moves.num_subrounds)


def launch_rounds(buf: torch.Tensor, moves: Moves, s0: int, s1: int,
                  at: RowOffsets, stream: int) -> None:
    """One launch of the kernel over sub-rounds ``[s0, s1)`` (``s0 < s1``)
    on the raw CUDA ``stream`` of the current device, with no check of its
    arguments: ``permute_rounds`` makes them, and a caller that launches
    straight holds them for every call (the runner's in-place path: once a
    placement, ``runner.place``). By phase over the whole range of moves
    with phases, else a step a sub-round. Counts the launch, its
    sub-rounds, its steps and its bytes."""
    global rounds_launches, subrounds, phases
    if _by_phase(moves, s0, s1):
        pairs, offs, p0, p1 = at.phase_pairs, at.phase_offs, 0, at.num_phases
    else:
        pairs, offs, p0, p1 = at.pairs, moves.offs, s0, s1
    rc = _rounds_kernel().permute_rounds(
        buf.data_ptr(), pairs.data_ptr(), offs.data_ptr(), p0, p1,
        at.row_bytes // 16, _workspace(buf.device, stream).data_ptr(),
        stream)
    if rc != 0:
        raise RuntimeError(f"permute_rounds cooperative launch failed: CUDA "
                           f"error {rc}")
    rounds_launches += 1
    subrounds += s1 - s0
    phases += p1 - p0
    _count_bytes(moves, s0, s1, at.row_bytes)


def _count_bytes(moves: Moves, s0: int, s1: int, row_bytes: int) -> None:
    global moved_bytes, relay_bytes
    moved_bytes += moves.moved_bytes(s0, s1, row_bytes)
    relay_bytes += moves.relay_bytes(s0, s1, row_bytes)
