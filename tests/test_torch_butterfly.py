"""The flattened butterfly (``core.topology.butterfly``) on the port's
normal path, and K1's relay-byte counter (``round_step.relay_bytes``), on
the CPU at smoke size.

BBS plans a butterfly's broadcast as two trees whose multi-hop edges
become relay chains: scratch rows after the packet rows, written in one
sub-round and read in a later one. A broadcast through
``api.compile(...).executable(...)`` delivers every node's copy bit for
bit, on the plain sub-round path and on the compacted moves that the card
runs; the counter equals a count taken from the moves' pairs (that a
mesh's plans add nothing to it is held in ``test_torch_spans.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import topology as T
from repro_torch.core.simconfig import DeviceConfig, SimConfig
from repro_torch.device import round_step as rs
from repro_torch.device import runner

CPU = SimConfig(device=DeviceConfig(device="cpu"))
CPU_DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def models():
    """A served model a fabric size, so that a root other than 0 is root
    0's plan relabelled, as in the benchmark's cells."""
    return {n: api.compile(T.butterfly(n), server=True) for n in (16, 32)}


def _payload(nbytes, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(int(nbytes) // 4, generator=g)


def _relay_count(moves, total, s0, s1, row_bytes):
    """The relay bytes by hand: every pair whose destination or live
    source row is a relay row moves its rows, one if it writes zeros."""
    dst, src = moves.pairs[moves.moves_cum[s0]:moves.moves_cum[s1]].T.numpy()
    live = src >= 0
    relay = (dst % moves.rows >= total) | (live & (src % moves.rows >= total))
    return int(relay.sum() + (relay & live).sum()) * row_bytes


@pytest.mark.parametrize("root", [0, 5])
@pytest.mark.parametrize("nbytes", [64e3, 1e6])
@pytest.mark.parametrize("n", [16, 32])
def test_two_tree_broadcast_with_relay_rows_is_bit_exact(models, n, nbytes,
                                                         root):
    """The plan takes the two-tree candidate with 9 relay slots; the CPU's
    sub-round path and the card's compacted moves (run by their plain
    version) both deliver the payload to every node, and midway the relay
    rows hold packets (the last cycles write zeros into them)."""
    ex = models[n].executable(root, nbytes, config=CPU)
    sched = ex.schedule
    assert ex.candidate == "two_tree"
    assert sched.num_relay == 9 and sched.root == root
    x = _payload(nbytes, seed=n + root)
    raw = x.view(torch.uint8)
    out = ex.run(x)
    assert out.shape == (n,) + tuple(x.shape)
    assert all(torch.equal(out[v].view(torch.uint8), raw) for v in range(n))

    lay = runner.packet_layout(x, sched, ex.num_groups)
    moves = runner.build_moves(sched, ex.num_groups, x, CPU_DEV)
    assert moves.relay_cum[-1] > 0 and lay.relay == 9
    buf = runner.pack(x, lay, root, CPU_DEV)
    half = moves.num_subrounds // 2
    rs.permute_rounds(buf, moves, 0, half)
    assert buf[:, lay.total:].any()      # relay rows carry packets midway
    rs.permute_rounds(buf, moves, half)
    got = runner.unpack(buf, lay, x)
    assert torch.equal(got.view(torch.uint8), out.view(torch.uint8))


@pytest.mark.parametrize("s0,s1", [(0, None), (0, 40), (37, 91), (90, 90)])
def test_relay_bytes_after_permute_rounds(models, s0, s1):
    """The counter grows by what the pairs that touch a relay row move,
    over the whole plan and over parts of it; the relay rows' share of
    K1's bytes is a part of ``moved_bytes``."""
    ex = models[32].executable(0, 64e3, config=CPU)
    x = _payload(64e3, seed=1)
    lay = runner.packet_layout(x, ex.schedule, ex.num_groups)
    moves = runner.build_moves(ex.schedule, ex.num_groups, x, CPU_DEV)
    end = moves.num_subrounds if s1 is None else s1
    want = _relay_count(moves, lay.total, s0, end, lay.row_bytes)
    buf = runner.pack(x, lay, 0, CPU_DEV)
    before = (rs.relay_bytes, rs.moved_bytes)
    rs.permute_rounds(buf, moves, s0, s1)
    got = (rs.relay_bytes - before[0], rs.moved_bytes - before[1])
    assert got[0] == want == moves.relay_bytes(s0, end, lay.row_bytes)
    assert got[0] <= got[1] == moves.moved_bytes(s0, end, lay.row_bytes)
    if s1 is None:
        assert 0 < got[0] < got[1]
    if s0 == end:
        assert got == (0, 0)


def test_idle_moves_run_the_barriers_alone(models):
    """``Moves.idle`` keeps a plan's sub-rounds and drops every move, relay
    moves too: the buffer stays as it was and no byte is counted."""
    ex = models[32].executable(0, 64e3, config=CPU)
    x = _payload(64e3, seed=2)
    lay = runner.packet_layout(x, ex.schedule, ex.num_groups)
    moves = runner.build_moves(ex.schedule, ex.num_groups, x, CPU_DEV)
    idle = moves.idle()
    assert (idle.num_subrounds, idle.n, idle.rows) == (
        moves.num_subrounds, moves.n, moves.rows)
    assert len(idle.pairs) == 0 and not idle.counts.any()
    assert not idle.offs.any() and idle.offs.shape == moves.offs.shape
    assert moves.relay_cum[-1] > 0 and idle.relay_cum[-1] == 0
    buf = runner.pack(x, lay, 0, CPU_DEV)
    want = buf.clone()
    before = (rs.moved_bytes, rs.relay_bytes)
    rs.permute_rounds(buf, idle)
    assert torch.equal(buf, want)
    assert (rs.moved_bytes, rs.relay_bytes) == before


def test_relay_zero_writes_count_one_row():
    """A relay row written with zeros (its packet outside the message, as
    in a pipeline's first and last cycles) counts the row it writes; a
    relay row read into a packet row counts both."""
    n, rows, packets = 3, 4, 2
    tab = np.zeros((2, 5, n), dtype=np.int32)
    # sub-round 0: 0 -> 1 into relay row 2, with 0's read masked off
    tab[0] = [[-1, 0, -1], [0, 0, 0], [0, 0, 0], [0, 2, 0], [0, 1, 0]]
    # sub-round 1: 1's relay row 2 -> 2's packet row 1
    tab[1] = [[-1, -1, 1], [0, 2, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1]]
    moves = rs.compact_moves(tab, rows, packets)
    assert moves.relay_cum.tolist() == [0, 1, 2]
    assert moves.relay_zeros_cum.tolist() == [0, 1, 1]
    assert moves.relay_bytes(0, 1, 16) == 16
    assert moves.relay_bytes(1, 2, 16) == 32
    assert moves.moved_bytes(0, 2, 16) == 48
    plain = rs.compact_moves(tab, rows)          # no relay rows by default
    assert plain.relay_cum.tolist() == [0, 0, 0]
    assert plain.moves_cum.tolist() == moves.moves_cum.tolist()
