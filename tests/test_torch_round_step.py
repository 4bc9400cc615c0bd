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
