"""The port's round step against the reference's Pallas kernel.

One sub-round of the virtual mesh (``permute_step_ref``) must equal, bit for
bit, the reference's per-device rendering: every device gathers its send
row (``round_step`` with no write), a numpy permute carries it to the
receiver (zeros where no one sends), and every device scatters the
received row (``round_step`` with no read) -- each step through the Pallas
kernel in interpret mode (``use_pallas=True, interpret=True``). Random
float32, int32 and bfloat16 payloads from a numpy seed, random tables, and
the edge cases by hand. Tolerance: exact.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.device.pallas_step import round_step
from repro_torch.device.round_step import (permute_step, permute_step_ref,
                                           random_table)

DTYPES = {"float32": np.float32, "int32": np.int32,
          "bfloat16": ml_dtypes.bfloat16}


def _payload(rng, dtype, shape):
    f = rng.standard_normal(shape).astype(np.float32)
    if dtype == "int32":
        return (f * 1e6).astype(np.int32)
    return f.astype(DTYPES[dtype])


def _reference_subround(bufs, tab):
    """Per-device Pallas steps around a numpy permute (module docstring)."""
    src, s_ix, s_ok, r_ix, r_ok = (tab[i].tolist() for i in range(5))
    n = len(bufs)
    vals = []
    for v in range(n):
        _, val = round_step(jnp.asarray(bufs[v]), jnp.zeros_like(bufs[v][0]),
                            0, False, s_ix[v], bool(s_ok[v]),
                            use_pallas=True, interpret=True)
        vals.append(np.asarray(val))
    out = []
    for v in range(n):
        rec = vals[src[v]] if src[v] >= 0 else np.zeros_like(bufs[v][0])
        b, _ = round_step(jnp.asarray(bufs[v]), jnp.asarray(rec), r_ix[v],
                          bool(r_ok[v]), 0, False, use_pallas=True,
                          interpret=True)
        out.append(np.asarray(b))
    return out


def _to_port(bufs):
    """Per-device ``[rows, plen]`` arrays -> one ``[n, rows, row_bytes]``
    uint8 tensor, rows padded to 16 bytes."""
    raw = np.stack(bufs).view(np.uint8)
    n, rows, used = raw.shape
    out = np.zeros((n, rows, -(-used // 16) * 16), dtype=np.uint8)
    out[:, :, :used] = raw
    return torch.from_numpy(out), used


def _edge_table(n, rows):
    """n=5: 0 -> 1 a plain move from the last row into the first; 1 -> 2 a
    write whose read is masked off (the relay zero-write), so device 1
    sends and receives, on different rows; 3 receives from no one but
    writes (zeros); 3 -> 4 has both masks off."""
    assert n == 5
    src = [-1, 0, 1, -1, 3]
    s_ix = [rows - 1, 2, 0, 0, 1]
    s_ok = [1, 0, 1, 0, 0]
    r_ix = [0, 0, rows - 1, 1, 2]
    r_ok = [0, 1, 1, 1, 0]
    return np.array([src, s_ix, s_ok, r_ix, r_ok], dtype=np.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_permute_step_matches_pallas_reference(dtype):
    rng = np.random.default_rng({"float32": 0, "int32": 1,
                                 "bfloat16": 2}[dtype])
    n, rows, plen = 5, 4, 7
    bufs = list(_payload(rng, dtype, (n, rows, plen)))
    port, used = _to_port(bufs)
    tables = [_edge_table(n, rows)] + \
        [random_table(rng, n, rows) for _ in range(3)]
    for tab in tables:
        bufs = _reference_subround(bufs, tab)
        permute_step_ref(port, torch.from_numpy(tab))
        want, _ = _to_port(bufs)
        assert torch.equal(port, want), tab
    # the CPU wrapper takes the plain path and agrees
    again, _ = _to_port(bufs)
    tab = torch.from_numpy(random_table(rng, n, rows))
    assert torch.equal(permute_step(again.clone(), tab),
                       permute_step_ref(again.clone(), tab))


@pytest.mark.parametrize("seed", range(6))
def test_random_tables_keep_the_in_place_property(seed):
    """``random_table`` draws real edge cases and never a device that sends
    and receives one row, the property the in-place kernel needs."""
    rng = np.random.default_rng(seed)
    n, rows = 64, 1 + seed
    for _ in range(20):
        src, s_ix, s_ok, r_ix, r_ok = random_table(rng, n, rows)
        live = src[src >= 0]
        assert len(set(live.tolist())) == len(live)          # a matching
        assert ((0 <= s_ix) & (s_ix < rows)).all()
        assert ((0 <= r_ix) & (r_ix < rows)).all()
        senders = np.zeros(n, dtype=bool)
        senders[live] = True
        assert not (senders & (s_ok != 0) & (r_ok != 0)
                    & (s_ix == r_ix)).any()


def test_plain_step_reads_before_it_writes():
    """Every read sees the buffer from before the sub-round: device 1 sends
    its row 0 to device 2 while it receives device 0's row 0 into row 1."""
    buf = torch.arange(3 * 2 * 16, dtype=torch.uint8).reshape(3, 2, 16)
    orig = buf.clone()
    # 0 -> 1 (row 0 into row 1), 1 -> 2 (row 0 into row 1), all live
    tab = torch.tensor([[-1, 0, 1], [0, 0, 0], [1, 1, 0],
                        [0, 1, 1], [0, 1, 1]], dtype=torch.int32)
    permute_step_ref(buf, tab)
    assert torch.equal(buf[1, 1], orig[0, 0])
    assert torch.equal(buf[2, 1], orig[1, 0])
    assert torch.equal(buf[0], orig[0])


# -- every sub-round in one launch: the compacted moves ---------------------

from repro_torch.device import round_step as rs  # noqa: E402


def _chain(buf, tabs):
    for t in tabs:
        permute_step_ref(buf, torch.from_numpy(np.ascontiguousarray(t)))
    return buf


@pytest.mark.parametrize("n,rows,count,seed",
                         [(1, 3, 7, 0), (3, 1, 9, 1), (5, 4, 12, 2),
                          (64, 7, 30, 3), (64, 1, 5, 4), (17, 33, 64, 5)])
def test_compacted_rounds_equal_chain_of_steps(n, rows, count, seed):
    """``compact_moves`` then ``permute_rounds_ref`` equals a chain of
    ``permute_step_ref`` bit for bit, on ``random_table`` sequences with
    every edge case, sub-rounds with no writer among them (count 0); the
    CPU wrapper ``permute_rounds`` takes the plain path and counts
    nothing."""
    rng = np.random.default_rng(seed)
    tabs = np.stack([random_table(rng, n, rows) for _ in range(count)])
    tabs[2::3, 4] = 0
    buf = torch.from_numpy(rng.integers(0, 256, (n, rows, 32),
                                        dtype=np.uint8))
    want = _chain(buf.clone(), tabs)
    moves = rs.compact_moves(tabs, rows)
    assert moves.num_subrounds == count and moves.counts[2::3].sum() == 0
    assert torch.equal(rs.permute_rounds_ref(buf.clone(), moves), want)
    before = (rs.launches, rs.rounds_launches, rs.subrounds)
    assert torch.equal(rs.permute_rounds(buf.clone(), moves), want)
    assert (rs.launches, rs.rounds_launches, rs.subrounds) == before


def test_compacted_moves_keep_only_writes():
    """One (dst_row, src_row) pair per receiver with r_ok, as rows of the
    [n * rows] view; src_row -1 where the sender's read is masked off or
    there is no sender (the edge table, module docstring of the test)."""
    rows = 4
    moves = rs.compact_moves(_edge_table(5, rows)[None], rows)
    assert moves.counts.tolist() == [3]
    assert moves.offs.tolist() == [0, 3]
    # 0 -> 1: row 3 of device 0 into row 0 of device 1; 1 -> 2 masked read
    # (zeros into row 3 of device 2); 3 writes zeros into its row 1
    assert moves.pairs.tolist() == [[1 * rows + 0, 0 * rows + 3],
                                    [2 * rows + 3, -1],
                                    [3 * rows + 1, -1]]


def test_compacted_moves_reject_rows_outside_the_buffer():
    tab = _edge_table(5, 4)
    bad = tab.copy()
    bad[3, 1] = 4                          # device 1 writes row 4 of 4
    with pytest.raises(ValueError, match="outside"):
        rs.compact_moves(bad[None], 4)
    bad = tab.copy()
    bad[1, 0] = -1                         # device 0's live read of row -1
    with pytest.raises(ValueError, match="outside"):
        rs.compact_moves(bad[None], 4)
    bad[4, 1] = 0                          # no one writes it: not checked
    rs.compact_moves(bad[None], 4)


def test_rounds_span_equals_chain_of_its_steps():
    rng = np.random.default_rng(7)
    n, rows = 9, 5
    tabs = np.stack([random_table(rng, n, rows) for _ in range(20)])
    buf = torch.from_numpy(rng.integers(0, 256, (n, rows, 16),
                                        dtype=np.uint8))
    moves = rs.compact_moves(tabs, rows)
    got = rs.permute_rounds(buf.clone(), moves, 4, 13)
    assert torch.equal(got, _chain(buf.clone(), tabs[4:13]))
    assert torch.equal(rs.permute_rounds(buf.clone(), moves, 6, 6), buf)
    for s0, s1 in ((-1, 3), (5, 4), (0, 21)):
        with pytest.raises(ValueError, match="range"):
            rs.permute_rounds(buf.clone(), moves, s0, s1)
    with pytest.raises(ValueError):        # a buffer of other rows
        rs.permute_rounds(buf[:, :4].contiguous(), moves)


@pytest.mark.parametrize("fabric", ["ring8", "hypercube3", "mesh2d_4x4"])
def test_compacted_rounds_on_real_plans(fabric):
    """The real tables of BBS and baseline plans: the cycle loop as one
    ``permute_rounds_ref`` over the plan's moves equals the chain of
    ``permute_step_ref`` over its tables, bit for bit, relay rows
    included."""
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig
    from repro_torch.device import runner

    topo = {"ring8": lambda: T.ring(8), "hypercube3": lambda: T.hypercube(3),
            "mesh2d_4x4": lambda: T.mesh2d(4, 4)}[fabric]()
    cpu = SimConfig(device=DeviceConfig(device="cpu"))
    model = api.compile(topo)
    for algo, nbytes in (("bbs", 1 << 16), ("bbs", 1 << 12),
                         ("bine_tree", 1 << 12)):
        ex = model.executable(root=1, nbytes=nbytes, algo=algo, config=cpu)
        tabs = ex.tables()
        moves = ex.moves()
        assert moves.num_subrounds == ex.num_subrounds == \
            tabs.shape[0] * tabs.shape[1]
        assert ex.num_launches == 1
        x = ex.default_payload(seed=3)
        lay = ex.lowered.placement(x).lay
        buf = runner.pack(x, lay, ex.root, torch.device("cpu"))
        want = runner.run_cycles(buf.clone(), tabs)
        got = rs.permute_rounds_ref(buf.clone(), moves)
        assert torch.equal(got, want), (fabric, algo, nbytes)
        # random bytes: compare raw bytes (NaN payloads included)
        out = runner.unpack(got, lay, x).view(torch.uint8)
        xb = x.view(torch.uint8)
        assert all(torch.equal(out[v], xb) for v in range(topo.num_nodes))


# -- K1 by dependency phase: the phase table -------------------------------

import dataclasses  # noqa: E402


def _by_phase(buf, moves, ph, rng):
    """The moves of ``ph`` applied phase by phase on the CPU, each phase's
    moves one at a time in a random order: equal to the sub-rounds' bytes
    only if no move of a phase depends on another of it. Checks that no
    phase reads a row that one of its moves writes or writes a row
    twice."""
    flat = buf.view(moves.n * moves.rows, -1)
    pairs = moves.pairs[ph.order].numpy()
    for p in range(ph.count):
        step = pairs[ph.offs[p]:ph.offs[p + 1]]
        dst, src = step[:, 0], step[:, 1]
        assert len(step) and len(set(dst.tolist())) == len(dst)
        assert not set(dst.tolist()) & set(src[src >= 0].tolist())
        for i in rng.permutation(len(step)):
            flat[dst[i]] = flat[src[i]] if src[i] >= 0 else 0
    return buf


def _check_table(moves, ph, cap=0):
    """``ph`` is a phase table of ``moves``: a permutation in phase order,
    a phase's moves in sub-round order, no phase empty; with no cap at most
    a phase a sub-round, else at most ``cap`` moves a phase."""
    order = ph.order.numpy()
    assert sorted(order.tolist()) == list(range(len(moves.pairs)))
    assert ph.offs[0] == 0 and ph.offs[-1] == len(order)
    assert (np.diff(ph.offs) > 0).all()
    if cap:
        assert (np.diff(ph.offs) <= cap).all()
    else:
        assert ph.count <= moves.num_subrounds
    for p in range(ph.count):
        assert (np.diff(order[ph.offs[p]:ph.offs[p + 1]]) > 0).all()


def _random_moves(seed):
    """Random sub-rounds with reused rows, zero writes, masked reads, relay
    rows (the last two of each device's) and sub-rounds with no writer."""
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(1, 48))
    rows = int(rng.integers(1, 10))
    count = int(rng.integers(1, 60))
    tabs = np.stack([random_table(rng, n, rows) for _ in range(count)])
    tabs[rng.random(count) < 0.15, 4] = 0
    return rng, rs.compact_moves(tabs, rows, max(rows - 2, 0))


@pytest.mark.parametrize("seed", range(56))
def test_phases_give_the_bytes_of_subround_order(seed):
    """Applying a sequence's moves phase by phase (``phase_table_ref``, with
    no cap on a phase's moves and with caps of 1, 2 and 7) gives the bytes
    of ``permute_rounds_ref`` in sub-round order, on random sequences of
    ``random_table`` sub-rounds: rows reused (WAR, WAW), zero writes,
    masked reads, relay rows, idle sub-rounds."""
    rng, moves = _random_moves(seed)
    if not len(moves.pairs):
        assert rs.with_phases(moves, 16) is moves
        return
    buf = torch.from_numpy(rng.integers(0, 256, (moves.n, moves.rows, 16),
                                        dtype=np.uint8))
    want = rs.permute_rounds_ref(buf.clone(), moves)
    counts = []
    for cap in (0, 7, 2, 1):
        ph = rs.phase_table_ref(moves, cap)
        _check_table(moves, ph, cap)
        assert torch.equal(_by_phase(buf.clone(), moves, ph, rng), want)
        counts.append(ph.count)
    assert counts == sorted(counts) and counts[-1] == len(moves.pairs)


def _plan_moves(fabric, root, nbytes=64e3):
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch.core.simconfig import DeviceConfig, SimConfig

    topo = {"ring8": lambda: T.ring(8), "mesh2d_8x8": lambda: T.mesh2d(8, 8),
            "dragonfly64": lambda: T.dragonfly(64),
            "butterfly32": lambda: T.butterfly(32)}[fabric]()
    cpu = SimConfig(device=DeviceConfig(device="cpu"))
    ex = api.compile(topo).executable(root=root, nbytes=nbytes, config=cpu)
    return ex, ex.moves()


@pytest.mark.parametrize("root", [0, 5])
@pytest.mark.parametrize("fabric", ["ring8", "mesh2d_8x8", "dragonfly64",
                                    "butterfly32"])
def test_phases_on_real_plans(fabric, root):
    """A plan's moves phase by phase give the bytes of the sub-rounds, and
    the payload on every device; the CPU's lowering keeps sub-round order
    (no phase table), and ``writes_first`` holds in phase order."""
    from repro_torch.device import runner

    ex, moves = _plan_moves(fabric, root)
    assert moves.phases is None
    x = ex.default_payload(seed=root)
    lay = ex.lowered.placement(x).lay
    assert ex.lowered.row_bytes == lay.row_bytes
    buf = runner.pack(x, lay, ex.root, torch.device("cpu"))
    want = rs.permute_rounds_ref(buf.clone(), moves)
    # the plan's cap, and one that cuts its phases
    for cap in (rs.phase_cap(lay.row_bytes), 9):
        ph = rs.phase_table_ref(moves, cap)
        _check_table(moves, ph, cap)
        got = _by_phase(buf.clone(), moves, ph, np.random.default_rng(root))
        assert torch.equal(got, want)
    out = runner.unpack(got, lay, x).view(torch.uint8)
    assert all(torch.equal(out[v], x.view(torch.uint8))
               for v in range(moves.n))
    ph = rs.phase_table_ref(moves)
    assert ph.count < moves.num_subrounds
    # every non-root packet row is written in an earlier phase than any
    # phase that reads it
    phase = np.empty(len(moves.pairs), dtype=np.int64)
    phase[ph.order.numpy()] = np.repeat(np.arange(ph.count), np.diff(ph.offs))
    dst, src = moves.pairs.numpy().T
    first_w = np.full(moves.n * moves.rows, ph.count)
    np.minimum.at(first_w, dst, phase)
    first_r = np.full(moves.n * moves.rows, ph.count)
    np.minimum.at(first_r, src[src >= 0], phase[src >= 0])
    rows = np.arange(moves.n * moves.rows)
    packet = (rows % moves.rows < lay.total) & (rows // moves.rows != root)
    read = first_r < ph.count
    assert (first_w[packet & read] < first_r[packet & read]).all()


@pytest.mark.parametrize("n,iters", [(8, 32), (64, 7)])
def test_calibration_ring_has_a_phase_a_subround(n, iters):
    """The calibration's ring rounds repeat one table, so every sub-round
    writes the rows the one before wrote (WAW): a phase a sub-round."""
    import importlib
    cal = importlib.import_module("repro_torch.device.calibrate")
    _, moves = cal.ring_round(n, 4096, "cpu", iters)
    ph = rs.phase_table_ref(moves)
    assert ph.count == moves.num_subrounds == iters
    assert ph.offs.tolist() == moves.moves_cum.tolist()
    assert ph.order.tolist() == list(range(len(moves.pairs)))


def test_phase_cap_fits_the_row():
    """A phase holds the rows that write ``PHASE_BYTES``, and never fewer
    than ``PHASE_ROWS``."""
    assert rs.phase_cap(16) == rs.PHASE_BYTES // 16
    assert rs.phase_cap(4448) == -(-rs.PHASE_BYTES // 4448) > rs.PHASE_ROWS
    assert rs.phase_cap(107024) == rs.PHASE_ROWS
    assert rs.phase_cap(rs.PHASE_BYTES) == rs.PHASE_ROWS


def test_phase_table_rejects_a_row_read_and_written_in_a_subround():
    moves = rs.compact_moves(_edge_table(5, 4)[None], 4)
    pairs = moves.pairs.clone()
    pairs[1] = torch.tensor([0 * 4 + 3, -1])   # writes the row 0 -> 1 reads
    with pytest.raises(ValueError, match="reads a row that it writes"):
        rs.phase_table_ref(dataclasses.replace(moves, pairs=pairs))
    pairs[1] = torch.tensor([1 * 4 + 0, -1])   # writes row 0 of 1 twice
    with pytest.raises(ValueError, match="twice"):
        rs.phase_table_ref(dataclasses.replace(moves, pairs=pairs))


@pytest.mark.parametrize("cap", [1, 2, 3, 7, 100])
def test_split_phases_cuts_only_large_phases(cap):
    offs = np.array([0, 1, 9, 10, 30, 31], dtype=np.int64)
    got = rs.split_phases(offs, cap)
    assert got[0] == 0 and got[-1] == 31 and (np.diff(got) > 0).all()
    assert (np.diff(got) <= cap).all()
    assert set(offs.tolist()) <= set(got.tolist())
    want = len(offs) - 1 + int(np.maximum(
        0, -(-np.diff(offs) // cap) - 1).sum())
    assert len(got) - 1 == want


def test_offsets_carry_the_phase_order_and_cut_a_large_phase():
    """With phases, ``Moves.offsets`` gives the byte offsets in phase order
    too, and phases cut to at most 2**30 chunks; ``fits_launch`` then
    checks a row, not a sub-round, for the whole range."""
    rng, moves = _random_moves(3)
    moves = dataclasses.replace(moves, phases=rs.phase_table_ref(moves))
    at = moves.offsets(64)
    assert torch.equal(at.phase_pairs, at.pairs[moves.phases.order])
    assert at.phase_offs.tolist() == moves.phases.offs.tolist()
    assert at.num_phases == moves.phases.count
    row_at = 16 + 64 * rng.permutation(moves.n * moves.rows)
    at = moves.offsets(64, row_at)
    assert torch.equal(at.phase_pairs, at.pairs[moves.phases.order])
    big = 16 * 2 ** 28                        # 2**28 chunks: 4 moves a step
    most = int(moves.counts.max())
    assert most > 4 and int(np.diff(moves.phases.offs).max()) > 4
    at = moves.offsets(big)
    assert (np.diff(at.phase_offs.numpy()) <= 4).all()
    assert at.num_phases > moves.phases.count
    assert not rs.fits_launch(moves, big, 0, moves.num_subrounds - 1)
    assert rs.fits_launch(moves, big)
    assert not rs.fits_launch(dataclasses.replace(moves, phases=None), big)
    assert not rs.fits_launch(moves, 16 * (2 ** 30 + 1))


class _FakeK1:
    """``permute_rounds``' library on the CPU: its launch applies steps
    ``[s0, s1)`` of the byte-offset pairs it is handed to the flat buffer,
    each step's moves one at a time in a random order, and records its
    arguments. Tensors are found by their address."""

    def __init__(self, tensors, rng):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.rng = rng
        self.calls = []

    def permute_rounds(self, buf, pairs, offs, s0, s1, chunks, bar, stream):
        flat = self.by_ptr[buf]
        pairs, offs = self.by_ptr[pairs].numpy(), self.by_ptr[offs].numpy()
        row = chunks * 16
        self.calls.append((pairs, offs, s0, s1))
        for s in range(s0, s1):
            step = pairs[offs[s]:offs[s + 1]]
            for i in self.rng.permutation(len(step)):
                d, r = step[i]
                flat[d:d + row] = flat[r:r + row] if r >= 0 else 0
        return 0


@pytest.mark.parametrize("span", ["all", "part", "no_phases", "idle"])
def test_launch_counts_subrounds_and_phases(span):
    """``launch_rounds`` hands the kernel the phase order over a whole
    range of moves with phases and the sub-rounds otherwise: the bytes are
    the sub-rounds' either way, ``subrounds`` grows by ``s1 - s0`` and
    ``phases`` by the steps the launch ran."""
    rng, moves = _random_moves(11)
    moves = dataclasses.replace(moves, phases=rs.phase_table_ref(moves))
    count = moves.num_subrounds
    s0, s1 = (2, count - 3) if span == "part" else (0, count)
    if span == "no_phases":
        moves = dataclasses.replace(moves, phases=None)
    if span == "idle":
        moves = moves.idle()
    row = 48
    buf = torch.from_numpy(rng.integers(0, 256, moves.n * moves.rows * row,
                                        dtype=np.uint8))
    at = moves.offsets(row)
    want = rs.permute_rounds_ref(buf.clone(), moves, s0, s1, at=at)
    got = buf.clone()
    fake = _FakeK1([got, at.pairs, moves.offs] + (
        [at.phase_pairs, at.phase_offs] if moves.phases else []), rng)
    saved = rs._rounds_lib
    rs._rounds_lib = fake
    try:
        before = (rs.rounds_launches, rs.subrounds, rs.phases)
        rs.launch_rounds(got, moves, s0, s1, at, 0)
    finally:
        rs._rounds_lib = saved
    steps = moves.phases.count if span == "all" else s1 - s0
    assert (rs.rounds_launches - before[0], rs.subrounds - before[1],
            rs.phases - before[2]) == (1, s1 - s0, steps)
    (pairs, offs, p0, p1), = fake.calls
    assert (p0, p1) == ((0, steps) if span == "all" else (s0, s1))
    assert len(offs) == (steps + 1 if span == "all" else count + 1)
    assert torch.equal(got, want)
