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
between sub-rounds), from the compacted moves of ``compact_moves``: for
each sub-round only the ``(dst_row, src_row)`` pairs of its writing
receivers, as row indexes into the ``[n * rows, row_bytes]`` view of the
buffer. The kernel reads them as byte offsets (``RowOffsets``, from
``Moves.offsets``): by default those of that buffer, ``row *
row_bytes``, or those of any placement of the rows in one flat allocation
(the runner's in-place layout puts most of them straight into the stacked
output). Its plain version ``permute_rounds_ref`` applies them sub-round by
sub-round. ``rounds_launches`` counts its launches and ``subrounds`` the
sub-rounds they ran; ``moved_bytes`` counts the HBM bytes of rows that
every ``permute_rounds`` call, on the card or the plain path, reads and
writes (``Moves.moved_bytes``), and ``relay_bytes`` the part of them moved
by moves that read or write a relay row (``Moves.relay_bytes``).
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
    or write a relay row (``compact_moves``' ``packets`` and on)."""

    pairs: torch.Tensor
    offs: torch.Tensor
    counts: np.ndarray
    n: int
    rows: int
    moves_cum: np.ndarray
    zeros_cum: np.ndarray
    relay_cum: np.ndarray
    relay_zeros_cum: np.ndarray
    _staged: Dict[int, "RowOffsets"] = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False)

    @property
    def num_subrounds(self) -> int:
        return len(self.counts)

    @property
    def device(self) -> torch.device:
        return self.pairs.device

    def to(self, device) -> "Moves":
        return dataclasses.replace(self, pairs=self.pairs.to(device),
                                   offs=self.offs.to(device))

    def offsets(self, row_bytes: int,
                row_at: Optional[np.ndarray] = None) -> "RowOffsets":
        """The moves' rows as byte offsets into one flat allocation, on the
        moves' device: row ``i`` of the ``[n * rows]`` rows at
        ``row_at[i]`` (int64, each a multiple of 16), or by default at
        ``i * row_bytes``, the ``[n, rows, row_bytes]`` buffer's rows (made
        once per ``row_bytes`` and kept). The rows must not overlap; that
        is the caller's to keep."""
        if row_bytes <= 0 or row_bytes % 16:
            raise ValueError(f"K1 moves 16-byte chunks: row_bytes "
                             f"{row_bytes} must be a positive multiple of "
                             f"16")
        if row_at is None:
            at = self._staged.get(row_bytes)
            if at is None:
                pairs = torch.where(self.pairs >= 0, self.pairs * row_bytes,
                                    -1)
                at = self._staged[row_bytes] = RowOffsets(
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
        return RowOffsets(pairs, row_bytes, span)

    def idle(self) -> "Moves":
        """The same sub-rounds with no move in any: ``permute_rounds`` on
        them runs K1's grid barriers alone."""
        zero = np.zeros_like(self.moves_cum)
        return dataclasses.replace(
            self, pairs=self.pairs[:0], offs=torch.zeros_like(self.offs),
            counts=np.zeros_like(self.counts), moves_cum=zero,
            zeros_cum=zero, relay_cum=zero, relay_zeros_cum=zero)

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
    the allocation's first ``span`` bytes."""

    pairs: torch.Tensor
    row_bytes: int
    span: int


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
                at.pairs.device != buf.device:
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
    rows at those byte offsets. A refused launch raises; nothing falls back
    to one launch per sub-round. Either way ``moved_bytes`` and
    ``relay_bytes`` grow by the bytes the sub-rounds move."""
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
        raise ValueError(f"a sub-round moves more than 2**30 chunks of 16 "
                         f"bytes ({int(moves.counts[s0:s1].max())} rows of "
                         f"{row_bytes // 16})")
    if at is None:
        at = moves.offsets(row_bytes)
    with torch.cuda.device(buf.device):
        launch_rounds(buf, moves, s0, s1, at,
                      torch.cuda.current_stream(buf.device).cuda_stream)
    return buf


def fits_launch(moves: Moves, row_bytes: int, s0: int = 0,
                s1: Optional[int] = None) -> bool:
    """Whether every sub-round of ``[s0, s1)`` moves at most 2**30 chunks of
    16 bytes, as one launch of the kernel needs."""
    s1 = moves.num_subrounds if s1 is None else s1
    return s0 == s1 or \
        int(moves.counts[s0:s1].max()) * (row_bytes // 16) <= 2 ** 30


def launch_rounds(buf: torch.Tensor, moves: Moves, s0: int, s1: int,
                  at: RowOffsets, stream: int) -> None:
    """One launch of the kernel over sub-rounds ``[s0, s1)`` (``s0 < s1``)
    on the raw CUDA ``stream`` of the current device, with no check of its
    arguments: ``permute_rounds`` makes them, and a caller that launches
    straight holds them for every call (the runner's in-place path: once a
    placement, ``runner.place``). Counts the launch and its bytes."""
    global rounds_launches, subrounds
    rc = _rounds_kernel().permute_rounds(
        buf.data_ptr(), at.pairs.data_ptr(), moves.offs.data_ptr(), s0, s1,
        at.row_bytes // 16, _workspace(buf.device, stream).data_ptr(),
        stream)
    if rc != 0:
        raise RuntimeError(f"permute_rounds cooperative launch failed: CUDA "
                           f"error {rc}")
    rounds_launches += 1
    subrounds += s1 - s0
    _count_bytes(moves, s0, s1, at.row_bytes)


def _count_bytes(moves: Moves, s0: int, s1: int, row_bytes: int) -> None:
    global moved_bytes, relay_bytes
    moved_bytes += moves.moved_bytes(s0, s1, row_bytes)
    relay_bytes += moves.relay_bytes(s0, s1, row_bytes)
