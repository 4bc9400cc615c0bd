"""The port's span recorder (``repro_torch.spans``) and K1's byte counter
(``round_step.moved_bytes``), on the CPU at smoke size.

Recording off records nothing and costs one shared object; nested spans
get their parents and one request id a ``bcast.run``; a broadcast and a
lowering on a 4 x 4 mesh open the spans the module lists, in order; the
timeline names the innermost span at a time and splits device seconds by
the span that launched them; and the counter after ``permute_rounds``
equals a count taken from the moves' pairs.
"""

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.core import topology as T
from repro_torch.core.simconfig import DeviceConfig, SimConfig
from repro_torch.device import round_step as rs

CPU = SimConfig(device=DeviceConfig(device="cpu"))


@pytest.fixture
def record():
    """Recording on for the test; the spans are left in ``spans`` off."""
    spans.start()
    try:
        yield
    finally:
        spans.stop()


def test_off_records_nothing_and_shares_one_object():
    a, b = spans.span("x"), spans.span("y", request=True)
    assert a is b
    with a, b:
        with spans.span("z"):
            pass
    assert spans.stop() == []
    spans.start()
    assert spans.stop() == []


def test_nesting_parents_and_requests(record):
    with spans.span("lower.executable"):
        with spans.span("lower.schedule"):
            pass
    for _ in range(2):
        with spans.span("bcast.run", request=True):
            with spans.span("runner.pack"):
                pass
            with spans.span("bcast.run", request=True):   # inside a request
                pass
    got = spans.stop()
    assert spans.span("after") is spans.span("stop")
    assert [s.name for s in got] == [
        "lower.executable", "lower.schedule",
        "bcast.run", "runner.pack", "bcast.run",
        "bcast.run", "runner.pack", "bcast.run"]
    ids = [s.id for s in got]
    assert ids == sorted(ids) and len(set(ids)) == len(ids)
    low, sched, r1, p1, in1, r2, p2, in2 = got
    assert (low.parent, sched.parent) == (0, low.id)
    assert low.request == sched.request == 0
    assert r1.parent == r2.parent == 0
    assert p1.parent == in1.parent == r1.id
    assert p2.parent == in2.parent == r2.id
    assert r1.request and r2.request and r1.request != r2.request
    assert p1.request == in1.request == r1.request
    assert p2.request == in2.request == r2.request
    for s in got:
        assert s.t1 >= s.t0
    assert low.t0 <= sched.t0 <= sched.t1 <= low.t1


def test_start_clears_the_record(record):
    with spans.span("a"):
        pass
    spans.start()
    with spans.span("b"):
        pass
    assert [s.name for s in spans.stop()] == ["b"]


def _mesh_exe(nbytes=4096, root=5):
    from repro_torch import api
    return api.compile(T.mesh2d(4, 4)).executable(root, nbytes, config=CPU)


def test_a_broadcast_opens_its_spans_in_order():
    ex = _mesh_exe()
    ex.lowered.tables()
    x = ex.default_payload(seed=3)
    spans.start()
    try:
        out = ex.run(x)
    finally:
        got = spans.stop()
    assert out.shape == (16,) + tuple(x.shape)
    raw = x.view(torch.uint8)
    assert all(torch.equal(out[v].view(torch.uint8), raw) for v in range(16))
    assert [s.name for s in got] == ["bcast.run", "runner.pack",
                                     "runner.cycles", "runner.unpack"]
    run = got[0]
    assert run.request and run.parent == 0
    for s in got[1:]:
        assert s.parent == run.id and s.request == run.request
        assert run.t0 <= s.t0 <= s.t1 <= run.t1
    assert got[1].t1 <= got[2].t0 and got[2].t1 <= got[3].t0


def test_a_first_run_lowers_inside_its_request():
    """The tables a first run builds nest their lowering under its
    ``bcast.run``."""
    ex = _mesh_exe()
    spans.start()
    try:
        ex.run(ex.default_payload())
    finally:
        got = spans.stop()
    names = [s.name for s in got]
    assert names[:2] == ["bcast.run", "lower.moves"]
    assert got[1].parent == got[0].id
    assert names.count("bcast.run") == 1


def test_the_lowering_opens_its_tree(record):
    ex = _mesh_exe(nbytes=64000, root=0)
    ex.moves()
    got = spans.stop()
    names = [s.name for s in got]
    assert names[0] == "lower.executable" and "lower.schedule" in names
    assert names[-4:] == ["lower.moves", "lower.slot_tables",
                          "lower.compact_moves", "lower.upload"]
    by = {s.id: s for s in got}
    low = got[0]
    for s in got:
        if s.name == "lower.schedule":
            assert s.parent == low.id
    mv = got[-4]
    assert mv.parent == 0 and mv.t0 >= low.t1
    for s in got[-3:]:
        assert by[s.parent] is mv
    assert all(s.request == 0 for s in got)


def test_the_baseline_lowering_opens_its_tree(record):
    from repro_torch import api
    api.compile(T.mesh2d(4, 4)).executable(0, 4096, algo="binomial",
                                           config=CPU)
    got = spans.stop()
    assert [s.name for s in got] == ["lower.executable", "lower.schedule"]
    assert got[1].parent == got[0].id


# -- the timeline and the split of device time ------------------------------

def _span(name, t0, t1, sid, parent=0, request=0):
    return spans.Span(name, t0, t1, sid, parent, request)


RUN = _span("bcast.run", 1.0, 5.0, 1, 0, 1)
PACK = _span("runner.pack", 1.5, 2.0, 2, 1, 1)
CYC = _span("runner.cycles", 2.0, 2.5, 3, 1, 1)
UNPACK = _span("runner.unpack", 2.5, 3.0, 4, 1, 1)
LATER = _span("bcast.run", 6.0, 7.0, 5, 0, 2)
TIMELINE = [RUN, PACK, CYC, UNPACK, LATER]


def test_timeline_names_the_innermost_span():
    tl = spans.Timeline(TIMELINE)
    assert tl.at(0.5) is None
    assert tl.at(1.2) is RUN
    assert tl.at(1.5) is PACK and tl.at(1.99) is PACK
    assert tl.at(2.0) is CYC                 # one closes as the next opens
    assert tl.at(2.7) is UNPACK
    assert tl.at(3.0) is RUN and tl.at(4.99) is RUN
    assert tl.at(5.0) is None and tl.at(5.5) is None
    assert tl.at(6.5) is LATER and tl.at(7.5) is None


def test_timeline_splits_an_interval_by_overlap():
    tl = spans.Timeline(TIMELINE)
    got = [(s.name if s else None, pytest.approx(d))
           for s, d in tl.overlap(0.5, 6.5)]
    assert got == [(None, 0.5), ("bcast.run", 0.5), ("runner.pack", 0.5),
                   ("runner.cycles", 0.5), ("runner.unpack", 0.5),
                   ("bcast.run", 2.0), (None, 1.0), ("bcast.run", 0.5)]
    assert tl.overlap(1.6, 1.7) == [(PACK, pytest.approx(0.1))]
    assert tl.overlap(8.0, 9.0) == [(None, 1.0)]
    assert spans.Timeline([]).overlap(0.0, 1.0) == [(None, 1.0)]


def test_timeline_takes_a_span_that_closes_out_of_turn():
    a = _span("a", 0.0, 2.0, 1)
    b = _span("b", 1.0, 3.0, 2)              # overlaps a, not inside it
    tl = spans.Timeline([a, b, _span("empty", 4.0, 4.0, 3)])
    assert tl.at(0.5) is a and tl.at(1.5) is b and tl.at(2.5) is b
    assert tl.at(3.5) is None and tl.at(4.0) is None


def test_attribute_by_launch_and_the_unclaimed():
    """Each device operation goes to the innermost span holding its launch;
    one launched outside every span and one whose launch is unknown are
    claimed by none."""
    tl = spans.Timeline(TIMELINE)
    launches = [(1.6, 0.004), (1.7, 0.001),      # pack's fill and copy
                (2.1, 0.010),                    # K1
                (2.6, 0.030),                    # unpack's copy
                (3.5, 0.002),                    # in the request, no child
                (5.5, 0.007),                    # between requests
                (None, 0.003)]                   # no runtime call matched
    by, none = spans.attribute(tl, launches)
    assert by == pytest.approx({PACK.id: 0.005, CYC.id: 0.010,
                                UNPACK.id: 0.030, RUN.id: 0.002})
    assert none == pytest.approx(0.010)


# -- K1's byte counter ------------------------------------------------------

def _moves(seed=7, n=12, rows=5, count=20):
    rng = np.random.default_rng(seed)
    tabs = np.stack([rs.random_table(rng, n, rows) for _ in range(count)])
    tabs[3::5, 4] = 0                          # sub-rounds with no writer
    return rs.compact_moves(tabs, rows), rng


def _count(moves, s0, s1, row_bytes):
    """The bytes by hand: a row written a pair, a row read a pair that
    reads one."""
    offs = np.concatenate([[0], np.cumsum(moves.counts)])
    src = moves.pairs[offs[s0]:offs[s1], 1].numpy()
    return int(len(src) + (src >= 0).sum()) * row_bytes


@pytest.mark.parametrize("s0,s1", [(0, None), (4, 13), (6, 6), (19, 20)])
def test_moved_bytes_after_permute_rounds(s0, s1):
    moves, rng = _moves()
    assert (moves.zeros_cum[-1] > 0) and (moves.zeros_cum[-1] <
                                           moves.moves_cum[-1])
    buf = torch.from_numpy(rng.integers(0, 256, (moves.n, moves.rows, 48),
                                        dtype=np.uint8))
    end = moves.num_subrounds if s1 is None else s1
    before = rs.moved_bytes
    rs.permute_rounds(buf, moves, s0, s1)
    assert rs.moved_bytes - before == _count(moves, s0, end, 48)
    assert moves.moved_bytes(s0, end, 48) == _count(moves, s0, end, 48)


def test_prefix_sums_come_through_to():
    """The host prefix sums ride along when the moves go to a device, and
    equal the counts and the zero writes of the pairs."""
    moves, _ = _moves(seed=11)
    moved = moves.to("cpu")
    assert moved.moves_cum is moves.moves_cum
    assert moved.zeros_cum is moves.zeros_cum
    assert moved.relay_cum is moves.relay_cum
    assert moved.relay_zeros_cum is moves.relay_zeros_cum
    assert np.array_equal(moves.moves_cum, moves.offs.numpy())
    zero = (moves.pairs[:, 1] < 0).numpy()
    assert [int(zero[moves.moves_cum[s]:moves.moves_cum[s + 1]].sum())
            for s in range(moves.num_subrounds)] == \
        np.diff(moves.zeros_cum).tolist()


def test_moved_bytes_of_an_executable_broadcast():
    """On a real plan's moves, the counter reads what the pairs ask, and
    at least the least bytes of the broadcast (every copy written, the
    payload read); a mesh's plan has no relay rows, so the relay counter
    stays where it was."""
    ex = _mesh_exe(nbytes=64000, root=0)
    moves = ex.moves()
    x = ex.default_payload()
    from repro_torch.device import runner
    lay = ex.lowered.placement(x).lay
    buf = runner.pack(x, lay, ex.root, torch.device("cpu"))
    before = (rs.moved_bytes, rs.relay_bytes)
    rs.permute_rounds(buf, moves)
    got = rs.moved_bytes - before[0]
    assert got == _count(moves, 0, moves.num_subrounds, lay.row_bytes)
    assert got >= 16 * 64000
    assert ex.schedule.num_relay == 0 and rs.relay_bytes == before[1]
