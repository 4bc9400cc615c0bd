"""The reading of a device trace: busy time, idle gaps named by what the
host did, and the breakdown, on made-up events."""

import pytest

from bcastbench import devtrace
from bcastbench.devtrace import DeviceTrace


def _trace():
    events = [("permute_rounds_kernel", 1.0, 2.0),
              ("copy", 2.5, 1.0),            # overlaps the kernel
              ("fill", 5.0, 1.0),
              ("fill", 9.5, 1.0)]            # runs past the window's end
    merged = devtrace._merged(events, 0.0, 10.0)
    busy = sum(e - s for s, e in merged)
    return DeviceTrace(events=events, start=0.0, end=10.0, busy_s=busy)


def test_busy_and_gaps():
    tr = _trace()
    assert tr.busy_s == pytest.approx(3.5 + 0.5)
    assert tr.gaps() == [(0.0, 1.0), (3.5, 5.0), (6.0, 9.5)]
    assert tr.window_s == 10.0
    assert tr.seconds(lambda n: "permute_rounds" in n) == 2.0
    assert tr.seconds(lambda n: True, [(0.5, 3.0), (9.0, 9.6)]) == 4.0
    assert tr.seconds(lambda n: n == "fill", [(4.0, 6.0)]) == 1.0
    assert tr.by_name()["fill"] == 2.0


def test_breakdown_names_the_gaps_by_the_host():
    out = devtrace.breakdown(_trace(), lambda t: "lower" if t < 4 else "run")
    assert out["device_ops"][0] == ["permute_rounds_kernel", 2.0]
    assert dict(out["idle_gaps"]) == pytest.approx({"lower": 1.0,
                                                    "run": 5.0})
    assert len(out["device_ops"]) <= 10 and len(out["idle_gaps"]) <= 10


def test_short_names():
    assert devtrace.short_name("void f(int)") == "f(int)"
    long = "void " + "x" * 300
    assert len(devtrace.short_name(long)) == 120
