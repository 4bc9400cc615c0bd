"""``bcast_shape_p50_ms``, the median of the shape medians, on made-up
requests: 8 shapes in equal numbers with a gap between the 4th and 5th
shape classes, where the p50 over all requests is an order statistic at
the edge of two classes and the shape medians' median is not."""

import dataclasses

import pytest

from bcastbench import manifest
from bcastbench.harness import RunRecord, Served, percentile
from conftest import ROOT

READER = manifest.load_module(ROOT / "bcastbench" / "metrics" /
                              "bcast_shape_p50_ms.py")
# (root, nbytes) -> base latency, s: four fast shapes, a gap, four slow
SHAPES = {(0, 4_000_000): 0.002, (17, 4_000_000): 0.0025,
          (0, 16_000_000): 0.004, (17, 16_000_000): 0.0045,
          (0, 64_000_000): 0.012, (17, 64_000_000): 0.0125,
          (0, 128_000_000): 0.022, (17, 128_000_000): 0.0225}
PER_SHAPE = 61


def _record(stall=None):
    """``PER_SHAPE`` requests of each shape, spaced 1 µs apart around their
    shape's base; ``stall`` adds 1 ms to the slowest request of that
    shape."""
    served, t = [], 0.0
    for (root, nbytes), base in SHAPES.items():
        for i in range(PER_SHAPE):
            d = base + (i - PER_SHAPE // 2) * 1e-6
            if stall == (root, nbytes) and i == PER_SHAPE - 1:
                d += 1e-3
            served.append(Served(root=root, nbytes=nbytes, t0=t, t1=t + d,
                                 subrounds=1))
            t += d
    return RunRecord(cell="test", n=256, setup_s=1.0, setup_phases={},
                     served=served, window_s=t)


def _p50_all_ms(rec):
    return percentile([s.seconds for s in rec.done], 50) * 1e3


def test_it_is_the_mean_of_the_4th_and_5th_shape_medians():
    medians = sorted(SHAPES.values())
    assert READER.read(_record()) == pytest.approx(
        (medians[3] + medians[4]) / 2 * 1e3, rel=1e-12)


def test_one_stalled_request_moves_the_p50_of_all_and_not_this():
    fourth = sorted(SHAPES, key=SHAPES.get)[3]
    sound, stalled = _record(), _record(stall=fourth)
    # the p50 of all requests is the mean of the 4th class's slowest and
    # the 5th's fastest request: the stall moves it half a millisecond
    assert _p50_all_ms(stalled) - _p50_all_ms(sound) == pytest.approx(
        0.5, rel=1e-9)
    assert READER.read(stalled) == READER.read(sound)


def test_failed_requests_are_left_out_and_none_done_reads_nothing():
    rec = _record()
    slow = Served(root=0, nbytes=4_000_000, t0=0.0, t1=10.0, subrounds=1,
                  ok=False)
    failed = dataclasses.replace(rec, served=rec.served + [slow] * 200)
    assert READER.read(failed) == READER.read(rec)
    assert READER.read(dataclasses.replace(rec, served=[])) is None
    assert READER.read(dataclasses.replace(
        rec, served=[dataclasses.replace(s, ok=False)
                     for s in rec.served])) is None
